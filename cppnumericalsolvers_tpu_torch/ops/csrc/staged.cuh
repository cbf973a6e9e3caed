// Device code of the kernels redesigned for Hopper with a lane per warp or
// block (flat_trip.cu, lbfgs_prologue.cu, push_two_loop.cu, two_loop.cu and,
// without the history rows, mt_trip.cu and lbfgs_epilogue.cu): a lane group
// (one warp or one whole block per lane), its reductions, the history rows
// on chip, the history push and the two-loop recursion over them, and
// 16-byte loads and stores.  lbfgs_prologue_t.cu, whose lanes are split over
// thread-block clusters, compiles from common.cuh alone.
//
// Lanes to threads.  The wrapper picks the mapping
// (ops/_kernel.py::lane_mapping) and passes it in: at small n a lane is one
// warp and a block holds several lanes, whose reductions are warp shuffles
// with no barrier; at larger n a lane is a whole block of 64 to 512 threads,
// whose reductions take one barrier each (double-buffered scratch).  Within a
// group thread t owns elements t, t + nt, ... of every vector and history row,
// so a thread reads back only what it wrote and no staging step needs a
// barrier.
//
// History rows (ROWS_*).  STAGED: at the boundary every thread copies its
// elements of the rows in use into shared memory with cp.async, all issued
// before the first reduction, and both passes of the two-loop read shared
// memory only.  STREAM: the two-loop streams the rows from device memory
// through two shared-memory row buffers, the next row's copy in flight while
// the current row is reduced.  DIRECT: the rows are read from device memory
// in place.  With a warp per lane (n <= 64, where a row is one or two cache
// lines) each thread loads its elements of the next row into registers
// before the current row's reduction.  With a block per lane the two-loop's
// loops read them as they read the streamed rows (q, the per-row scalars
// and the reduction scratch are its only shared memory), taken where the
// stream's row buffers do not fit: up to n = 28,760 in float64 and 57,816
// in float32 at m = 10.  DEVICE_Q, beyond that: a block per lane reads the
// rows in place as DIRECT does and keeps q in device memory too, in the
// lane's row of the kernel's direction output; its shared memory is the
// per-row scalars and the reduction scratch alone, so it reaches any n.  A
// row is addressed by its age k (0 the oldest) at physical row
// (head + k) mod m.
//
// Every thread of a group computes the scalar logic from identical inputs and
// gets the same bits from every reduction, so per-row scalars are written to
// shared memory by every thread with the same value and read back with no
// barrier.

#pragma once

#include <cstdint>

#include "common.cuh"

namespace cppns {

constexpr int LANE_MAX_THREADS = 512;
constexpr int LANE_MAX_WARPS = LANE_MAX_THREADS / 32;
// Launch bounds.  A warp-per-lane block holds at most 8 lanes (256
// threads).  A block-per-lane kernel is built twice: narrow (up to 256
// threads, two blocks per SM: up to 128 registers a thread) and wide (up to
// 512 threads, two blocks per SM: 64 registers, spilling in flat_trip).  With
// no minimum of blocks ptxas capped 512-thread builds at 64 registers anyway;
// one block per SM at 128 registers was slower on the card than two at 64
// (PERF.md).
constexpr int WARP_BLOCK_THREADS = 256;
constexpr int NARROW_THREADS = 256;
__host__ __device__ constexpr int bound_threads(bool warp, bool wide) {
  return warp ? WARP_BLOCK_THREADS : (wide ? LANE_MAX_THREADS : NARROW_THREADS);
}

// One lane's threads: a warp (WARP) or the whole block.
template <typename T, bool WARP> struct Group {
  int tid, nt, buf;
  T *red;  // block mode: 2 * RED_SLOTS * LANE_MAX_WARPS values

  __device__ void sync() const {
    if (WARP)
      __syncwarp();
    else
      __syncthreads();
  }

  // Sums (or NaN-propagating maxima) of K values over the group; every
  // thread gets the same bits: within a warp by xor butterfly (commutative
  // pairs); in block mode each warp then loads the warps' partials into its
  // lanes (padded with the identity) and runs the same butterfly on them.
  // One barrier per reduction: the scratch is double-buffered, and a thread
  // that writes one half again has passed the barrier that every reader of
  // its last use reached after reading it.
  template <int K, bool MAX> __device__ static void butterfly(T (&v)[K]) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const T o = __shfl_xor_sync(0xffffffffu, v[k], off);
        v[k] = MAX ? nmax(v[k], o) : v[k] + o;
      }
  }
  template <int K, bool MAX> __device__ void reduce(T (&v)[K]) {
    butterfly<K, MAX>(v);
    if (WARP) return;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    T *r = red + buf * (RED_SLOTS * LANE_MAX_WARPS);
    buf ^= 1;
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < K; ++k) r[k * LANE_MAX_WARPS + warp] = v[k];
    __syncthreads();
    const T pad = MAX ? T(-INFINITY) : T(0);
#pragma unroll
    for (int k = 0; k < K; ++k)
      v[k] = lane < nw ? r[k * LANE_MAX_WARPS + lane] : pad;
    butterfly<K, MAX>(v);
  }
  template <int K> __device__ void sum(T (&v)[K]) { reduce<K, false>(v); }
  template <int K> __device__ void max(T (&v)[K]) { reduce<K, true>(v); }
};

// Where the two-loop reads the history rows: copied on chip at the boundary
// (STAGED), streamed from device memory through two row buffers in shared
// memory (STREAM), or read from device memory in place (DIRECT; DEVICE_Q,
// a block per lane only, with q in device memory as well).  3 and 4 are
// push_two_loop.cu's and two_loop.cu's own modes.
constexpr int ROWS_STREAM = 0, ROWS_STAGED = 1, ROWS_DIRECT = 2,
              ROWS_DEVICE_Q = 5;
// Elements of a row one thread of a warp per lane holds in ROWS_DIRECT
// (n <= 64).
constexpr int DIRECT_ELEMENTS = 2;

// Shared memory of one lane, in T values: alpha, rho, s.y and the usable
// flag per row, q (but in ROWS_DEVICE_Q), then the staged rows (2 m n) or
// the stream's two row buffers of s and y (4 n).  Block mode adds the
// reduction scratch once.  ops/_kernel.py::lane_smem_bytes mirrors this.
__host__ __device__ inline int lane_values(int m, int n, int rows) {
  return 4 * m + (rows == ROWS_DEVICE_Q ? 0 : n) +
         (rows == ROWS_STAGED ? 2 * m * n : rows == ROWS_STREAM ? 4 * n : 0);
}
constexpr int GROUP_RED_VALUES = 2 * RED_SLOTS * LANE_MAX_WARPS;

// A lane's shared memory; ``q_device`` (ROWS_DEVICE_Q) puts q in device
// memory instead.  A kernel passes it under a template flag, so that the
// mode is a build of its own: where q may lie in either memory every access
// to it is a generic one, which made two_loop's ring 10% slower on the card
// (PERF.md).
template <typename T> struct LaneMem {
  T *alphas, *rhos, *sy, *usable, *q, *rows;
  __device__ LaneMem(T *base, int m, int n, T *q_device = nullptr) {
    alphas = base;
    rhos = alphas + m;
    sy = rhos + m;
    usable = sy + m;
    q = q_device ? q_device : usable + m;
    rows = usable + m + (q_device ? 0 : n);
  }
};

template <typename T>
__device__ __forceinline__ void cp_async(T *smem, const T *gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the copies of this thread's elements of the history rows at ages
// 0 .. count-1 (physical (head + k) mod m) into the same physical rows of
// ``stage`` (s rows, then y rows at stage + m n).  Returns at once; wait with
// cp_wait<0>() before reading.
template <typename T>
__device__ void stage_rows(const T *hs, const T *hy, T *stage, int count,
                           int head, int m, int n, int tid, int nt) {
  for (int k = 0; k < count; ++k) {
    const int p = head + k >= m ? head + k - m : head + k;
    const size_t o = (size_t)p * n;
    for (int j = tid; j < n; j += nt) {
      cp_async(stage + o + j, hs + o + j);
      cp_async(stage + (size_t)m * n + o + j, hy + o + j);
    }
  }
  cp_commit();
}

// The two-loop recursion (lbfgs.h:141-196) over the rows at ages
// 0 .. count-1, newest to oldest and back, with the same arithmetic per row
// in every mode.  On entry ``lm.q`` holds the gradient (each thread its
// own elements); on return the direction H*g.  ``rows``: ROWS_STAGED, the
// rows are in ``lm.rows`` (physical layout, m rows of s then m of y) and
// their copies have landed; ROWS_STREAM, they are streamed from ``hs``/``hy``
// through the two buffers at ``lm.rows``, the next row's copy in flight while
// the current row is reduced; ROWS_DIRECT and ROWS_DEVICE_Q, they are read
// from ``hs``/``hy`` in place (a warp per lane loads the next row into
// registers ahead of the current row's reduction).  Every mode adds a
// thread's products in order of j, and each thread reads back only the
// elements of q it wrote, wherever q lies.
template <typename T, bool WARP>
__device__ void two_loop_rows(Group<T, WARP> &g, const LaneMem<T> &lm,
                              const T *hs, const T *hy, int rows, int count,
                              int head, int m, int n, T gamma) {
  const T eps = Eps<T>::v;
  const int tid = g.tid, nt = g.nt;
  const bool staged = rows == ROWS_STAGED, stream = rows == ROWS_STREAM;
  // A block per lane reads ROWS_DIRECT rows in the loops below the warp's
  // register path (row_s/row_y point into device memory).
  const bool direct = WARP && rows == ROWS_DIRECT;
  T *q = lm.q;
  auto phys = [&](int k) {
    const int p = head + k;
    return p >= m ? p - m : p;
  };
  // Stream buffers: b in {0, 1}, s at rows + 2 b n, y after it.
  auto issue = [&](int k, int b) {
    const size_t o = (size_t)phys(k) * n;
    T *bs = lm.rows + (size_t)2 * b * n;
    for (int j = tid; j < n; j += nt) {
      cp_async(bs + j, hs + o + j);
      cp_async(bs + n + j, hy + o + j);
    }
    cp_commit();
  };
  auto row_s = [&](int k, int idx) -> const T * {
    return staged   ? lm.rows + (size_t)phys(k) * n
           : stream ? lm.rows + (size_t)2 * (idx & 1) * n
                    : hs + (size_t)phys(k) * n;
  };
  auto row_y = [&](int k, int idx) -> const T * {
    return staged   ? lm.rows + (size_t)(m + phys(k)) * n
           : stream ? lm.rows + (size_t)(2 * (idx & 1) + 1) * n
                    : hy + (size_t)phys(k) * n;
  };

  if (staged) {
    // s_k . y_k of every row in use, eight rows per reduction: they do not
    // depend on q.
    for (int k0 = 0; k0 < count; k0 += RED_SLOTS) {
      T v[RED_SLOTS];
#pragma unroll
      for (int c = 0; c < RED_SLOTS; ++c) {
        v[c] = T(0);
        if (k0 + c < count) {
          const T *s_r = row_s(k0 + c, 0), *y_r = row_y(k0 + c, 0);
          for (int j = tid; j < n; j += nt) v[c] += s_r[j] * y_r[j];
        }
      }
      g.template sum<RED_SLOTS>(v);
#pragma unroll
      for (int c = 0; c < RED_SLOTS; ++c)
        if (k0 + c < count) lm.sy[k0 + c] = v[c];
    }
  } else if (stream && count > 0) {
    issue(count - 1, 0);
  }

  // ROWS_DIRECT with a warp per lane (n <= 2 * threads): each thread holds
  // its elements of the current row in registers and loads the next row's
  // before the current reduction, so a row's load latency overlaps the
  // previous row's work.
  T cs[DIRECT_ELEMENTS], cy[DIRECT_ELEMENTS];
  auto load = [&](int k, T (&ds)[DIRECT_ELEMENTS], T (&dy)[DIRECT_ELEMENTS]) {
    const size_t o = (size_t)phys(k) * n;
#pragma unroll
    for (int e = 0; e < DIRECT_ELEMENTS; ++e) {
      const int j = tid + e * nt;
      ds[e] = j < n ? hs[o + j] : T(0);
      dy[e] = j < n ? hy[o + j] : T(0);
    }
  };
  if (direct && count > 0) load(count - 1, cs, cy);

  for (int idx = 0; idx < count; ++idx) {
    const int k = count - 1 - idx;
    if (stream) {
      if (idx + 1 < count) {
        issue(k - 1, (idx + 1) & 1);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
    }
    T d[2] = {T(0), T(0)};
    if (direct) {
      T ns[DIRECT_ELEMENTS], ny[DIRECT_ELEMENTS];
      if (idx + 1 < count) load(k - 1, ns, ny);
#pragma unroll
      for (int e = 0; e < DIRECT_ELEMENTS; ++e) {
        const int j = tid + e * nt;
        if (j < n) {
          d[0] += cs[e] * cy[e];
          d[1] += cs[e] * q[j];
        }
      }
      g.template sum<2>(d);
      const bool usable = fabs(d[0]) >= eps;
      const T rho = usable ? T(1) / d[0] : T(0);
      const T alpha = rho * d[1];
      if (usable)
#pragma unroll
        for (int e = 0; e < DIRECT_ELEMENTS; ++e) {
          const int j = tid + e * nt;
          if (j < n) q[j] = q[j] - alpha * cy[e];
        }
      lm.alphas[k] = alpha;
      lm.rhos[k] = rho;
      lm.usable[k] = usable ? T(1) : T(0);
#pragma unroll
      for (int e = 0; e < DIRECT_ELEMENTS; ++e) {
        cs[e] = ns[e];
        cy[e] = ny[e];
      }
      continue;
    }
    const T *s_r = row_s(k, idx), *y_r = row_y(k, idx);
    if (staged) {
      T one[1] = {T(0)};
      for (int j = tid; j < n; j += nt) one[0] += s_r[j] * q[j];
      g.template sum<1>(one);
      d[0] = lm.sy[k];
      d[1] = one[0];
    } else {
      for (int j = tid; j < n; j += nt) {
        d[0] += s_r[j] * y_r[j];
        d[1] += s_r[j] * q[j];
      }
      g.template sum<2>(d);
    }
    const bool usable = fabs(d[0]) >= eps;
    const T rho = usable ? T(1) / d[0] : T(0);
    const T alpha = rho * d[1];
    if (usable)
      for (int j = tid; j < n; j += nt) q[j] = q[j] - alpha * y_r[j];
    lm.alphas[k] = alpha;
    lm.rhos[k] = rho;
    lm.usable[k] = usable ? T(1) : T(0);
  }
  for (int j = tid; j < n; j += nt) q[j] = q[j] * gamma;

  if (stream && count > 0) issue(0, 0);
  if (direct && count > 0) load(0, cs, cy);
  for (int k = 0; k < count; ++k) {
    if (stream) {
      if (k + 1 < count) {
        issue(k + 1, (k + 1) & 1);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
    }
    if (direct) {
      T ns[DIRECT_ELEMENTS], ny[DIRECT_ELEMENTS];
      if (k + 1 < count) load(k + 1, ns, ny);
      if (lm.usable[k] != T(0)) {
        T d[1] = {T(0)};
#pragma unroll
        for (int e = 0; e < DIRECT_ELEMENTS; ++e) {
          const int j = tid + e * nt;
          if (j < n) d[0] += cy[e] * q[j];
        }
        g.template sum<1>(d);
        const T beta = lm.rhos[k] * d[0];
        const T coef = lm.alphas[k] - beta;
#pragma unroll
        for (int e = 0; e < DIRECT_ELEMENTS; ++e) {
          const int j = tid + e * nt;
          if (j < n) q[j] = q[j] + cs[e] * coef;
        }
      }
#pragma unroll
      for (int e = 0; e < DIRECT_ELEMENTS; ++e) {
        cs[e] = ns[e];
        cy[e] = ny[e];
      }
      continue;
    }
    if (lm.usable[k] == T(0)) continue;
    const T *s_r = row_s(k, k), *y_r = row_y(k, k);
    T d[1] = {T(0)};
    for (int j = tid; j < n; j += nt) d[0] += y_r[j] * q[j];
    g.template sum<1>(d);
    const T beta = lm.rhos[k] * d[0];
    const T coef = lm.alphas[k] - beta;
    for (int j = tid; j < n; j += nt) q[j] = q[j] + s_r[j] * coef;
  }
}

// Rows a full history's shift moves per batch of loads (not staged).
constexpr int SHIFT_BATCH = 4;

// The curvature-gated push of the pair (s_new, y_new) into the
// chronological history (Push p from push_gate), then the two-loop
// recursion on the updated history: on return lm.q holds H * g.  A full
// history's shift is written from the staged rows where they are on chip
// (ROWS_STAGED, the copies of stage_rows issued by the caller before its
// reductions: it is then writes only, and on chip the rows become a ring
// whose oldest row, physical 0, holds the new pair); otherwise each thread
// loads SHIFT_BATCH rows of its elements before storing them.  A pair that
// is not accepted writes nothing.
template <typename T, bool WARP>
__device__ void push_two_loop_rows(Group<T, WARP> &grp, const LaneMem<T> &lm,
                                   const Push<T> &p, T *hs, T *hy,
                                   const T *s_new, const T *y_new, const T *g,
                                   int rows, int m, int n) {
  const int tid = grp.tid, nt = grp.nt;
  const bool staged = rows == ROWS_STAGED;
  const int head = (p.accept && p.full && staged) ? 1 : 0;
  if (staged) cp_wait<0>();
  T *st_s = lm.rows + (size_t)p.slot * n;
  T *st_y = lm.rows + (size_t)(m + p.slot) * n;
  if (p.accept && p.full && staged) {
    st_s = lm.rows;
    st_y = lm.rows + (size_t)m * n;
  }
  for (int j = tid; j < n; j += nt) {
    const T sv = s_new[j], yv = y_new[j];
    if (p.accept) {
      if (p.full && staged) {
        for (int r = 0; r < m - 1; ++r) {
          const size_t o = (size_t)r * n + j, o1 = o + n;
          hs[o] = lm.rows[o1];
          hy[o] = lm.rows[(size_t)m * n + o1];
        }
      } else if (p.full) {
        // Rows r+1 .. r+SHIFT_BATCH are loaded before any is stored, so
        // their loads are in flight together.
        for (int r0 = 0; r0 < m - 1; r0 += SHIFT_BATCH) {
          T bs[SHIFT_BATCH], by[SHIFT_BATCH];
#pragma unroll
          for (int c = 0; c < SHIFT_BATCH; ++c) {
            const size_t o1 = (size_t)(r0 + c + 1) * n + j;
            bs[c] = r0 + c < m - 1 ? hs[o1] : T(0);
            by[c] = r0 + c < m - 1 ? hy[o1] : T(0);
          }
#pragma unroll
          for (int c = 0; c < SHIFT_BATCH; ++c)
            if (r0 + c < m - 1) {
              hs[(size_t)(r0 + c) * n + j] = bs[c];
              hy[(size_t)(r0 + c) * n + j] = by[c];
            }
        }
      }
      hs[(size_t)p.slot * n + j] = sv;
      hy[(size_t)p.slot * n + j] = yv;
      if (staged) {
        st_s[j] = sv;
        st_y[j] = yv;
      }
    }
    lm.q[j] = g[j];
  }
  two_loop_rows(grp, lm, hs, hy, rows, p.new_count, head, m, n, p.new_gamma);
}

// The two-loop recursion of a warp per lane that holds every row in use in
// registers (ROWS_REGISTERS of push_two_loop.cu and two_loop.cu): rows S[k]
// and Y[k] for k < count, thread t owning j = t + 32 e of each, q updated
// in place, the per-row scalars in shared memory.  Each thread adds its
// products in order of j and the warp reduces by xor butterfly: the order
// and the arithmetic of two_loop_rows' ROWS_DIRECT, so the two give the
// same bits.  Inlined, so the rows stay in the caller's registers.
template <typename T, int R, int E>
__device__ __forceinline__ void regs_two_loop(Group<T, true> &grp,
                                              const LaneMem<T> &lm,
                                              T (&q)[E], const T (&S)[R][E],
                                              const T (&Y)[R][E], int count,
                                              int n, T gamma) {
  const int tid = grp.tid;
  const T eps = Eps<T>::v;
#pragma unroll
  for (int k = R - 1; k >= 0; --k) {
    if (k >= count) continue;
    T d[2] = {T(0), T(0)};
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (tid + 32 * e < n) {
        d[0] += S[k][e] * Y[k][e];
        d[1] += S[k][e] * q[e];
      }
    grp.template sum<2>(d);
    const bool usable = fabs(d[0]) >= eps;
    const T rho = usable ? T(1) / d[0] : T(0);
    const T alpha = rho * d[1];
    if (usable)
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (tid + 32 * e < n) q[e] = q[e] - alpha * Y[k][e];
    lm.alphas[k] = alpha;
    lm.rhos[k] = rho;
    lm.usable[k] = usable ? T(1) : T(0);
  }
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (tid + 32 * e < n) q[e] = q[e] * gamma;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (k >= count || lm.usable[k] == T(0)) continue;
    T d[1] = {T(0)};
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (tid + 32 * e < n) d[0] += Y[k][e] * q[e];
    grp.template sum<1>(d);
    const T beta = lm.rhos[k] * d[0];
    const T coef = lm.alphas[k] - beta;
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (tid + 32 * e < n) q[e] = q[e] + S[k][e] * coef;
  }
}

// VW neighbouring values, loaded or stored as one 16-byte access where
// VW * sizeof(T) == 16.
template <typename T, int VW> struct Unit {
  T v[VW];
};
template <typename T, int VW>
__device__ __forceinline__ Unit<T, VW> load_unit(const T *p) {
  Unit<T, VW> u;
  if constexpr (VW == 1) {
    u.v[0] = *p;
  } else if constexpr (sizeof(T) == 4) {
    static_assert(VW == 4, "float units are 1 or 4 values");
    const float4 t = *reinterpret_cast<const float4 *>(p);
    u.v[0] = t.x; u.v[1] = t.y; u.v[2] = t.z; u.v[3] = t.w;
  } else {
    static_assert(VW == 2, "double units are 1 or 2 values");
    const double2 t = *reinterpret_cast<const double2 *>(p);
    u.v[0] = t.x; u.v[1] = t.y;
  }
  return u;
}
template <typename T, int VW>
__device__ __forceinline__ void store_unit(T *p, const Unit<T, VW> &u) {
  if constexpr (VW == 1) {
    *p = u.v[0];
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4 *>(p) = make_float4(u.v[0], u.v[1], u.v[2],
                                                 u.v[3]);
  } else {
    *reinterpret_cast<double2 *>(p) = make_double2(u.v[0], u.v[1]);
  }
}

inline bool aligned16(const void *p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// Launch geometry from the wrapper's mapping: ``tpl`` threads per lane
// (32: a warp per lane, ``lpb`` lanes per block; else one lane per block).
struct Mapping {
  int lpb, tpl, rows;
};

inline size_t mapping_smem(const Mapping &mp, int m, int n, size_t w) {
  const size_t lane = (size_t)lane_values(m, n, mp.rows) * w;
  return mp.tpl == 32 ? lane * mp.lpb
                      : lane + (size_t)GROUP_RED_VALUES * w;
}

}  // namespace cppns
