// The bare L-BFGS two-loop recursion H*g for every lane of a batch, for
// Hopper.
//
// Replaces cppnumericalsolvers_tpu/ops/two_loop.py::_two_loop_kernel (the
// Pallas TPU kernel).  It computes what the plain PyTorch version
// cppnumericalsolvers_tpu_torch/ops/two_loop.py::two_loop_direction_reference
// computes: the backward and forward pass over the history rows below the
// lane's count, a row with |s.y| < eps skipped, the centre scaled by gamma.
// The history is read only.  A lane reads only the rows below its count,
// where the TPU kernel ran all m rows masked.
//
// Design (redesigned for Hopper; staged.cuh sets out the lane groups and
// the row modes).  It is push_two_loop.cu without the push, on the mapping
// rules of ops/_kernel.py::lane_mapping("two_loop", ...): a warp per lane at
// n <= 64, several lanes a block, every row in use held in registers (at
// m <= 10; else read in place with the next row's load ahead); else one
// block of 64 to 512 threads per lane, each thread owning 8 elements of a
// row, which streams the rows through a ring of four row pairs in shared
// memory (ROWS_RING, this kernel's own mode: a row's copy is issued three
// rows ahead of its use) where the ring fits a block, through staged.cuh's
// two row buffers where only those fit, and reads them in place otherwise.
// The history is read only, so it is never staged whole: there is no
// write-back to save.  The other row modes can be forced for a sweep and
// give the same bits.
//
// Sum order.  Every mapping adds a thread's products in the order of j and
// reduces by the lane group's butterfly, as push_two_loop.cu does under the
// same mapping, so on the same history this kernel and push_two_loop with
// valid = 0 give the same bits (chip_smoke.py checks it).  The register path
// runs staged.cuh's regs_two_loop, as push_two_loop_regs_kernel does.
//
// What bounds it on an H100: device-memory bytes.  A lane reads g and the
// rows in use (each row counted once) and writes the direction.
//
// Numerics and build flags: see common.cuh (--fmad=false; ops/_build.py).

#include "staged.cuh"

namespace {

using namespace cppns;

// Blocks per SM the warp-per-lane build is bounded for (launch bounds).
constexpr int WARP_MIN_BLOCKS = 2;
// A warp per lane holds the whole history in registers (ROWS_REGISTERS,
// ops/_kernel.py) where m <= REG_ROWS.  A block per lane streams the rows
// through a ring of RING_DEPTH row pairs (ROWS_RING).
constexpr int ROWS_REGISTERS = 3, REG_ROWS = 10, ROWS_RING = 4,
              RING_DEPTH = 4;

template <typename T> struct Args {
  const T *g, *s, *y;
  const int *count;
  const T *gamma;
  T *d;
  int b, n, m, rows;
};

// The lane's count, clamped to [0, m] (the op takes any int32).
__device__ __forceinline__ int lane_count(const int *count, size_t lane,
                                          int m) {
  const int c = count[lane];
  return c < 0 ? 0 : (c > m ? m : c);
}

// ROWS_RING, a block per lane: the rows in use stream through a ring of
// RING_DEPTH row pairs in shared memory in the order the two passes read
// them (count - 1 .. 0, then 0 .. count - 1), each row's cp.async issued
// RING_DEPTH - 1 rows ahead of its use.  ROWS_STREAM's two buffers put a
// row's load latency on every one of a lane's 2 count dependent
// reductions; the ring overlaps it with the rows before.  The arithmetic
// and its order are staged.cuh's two_loop_rows', so the bits are too.  A
// thread copies and reads only its own elements, so reusing a slot needs
// no barrier.
template <typename T>
__device__ void ring_two_loop(Group<T, false> &g, const LaneMem<T> &lm,
                              const T *hs, const T *hy, int count, int n,
                              T gamma) {
  const T eps = Eps<T>::v;
  const int tid = g.tid, nt = g.nt;
  T *q = lm.q;
  const int steps = 2 * count;
  auto slot = [&](int t) {
    return lm.rows + (size_t)2 * (t % RING_DEPTH) * n;
  };
  // Step t reads row count - 1 - t (backward pass), then t - count.  Past
  // the last step an empty group keeps the count of groups in flight.
  auto issue = [&](int t) {
    if (t < steps) {
      const int k = t < count ? count - 1 - t : t - count;
      const size_t o = (size_t)k * n;
      T *bs = slot(t);
      for (int j = tid; j < n; j += nt) {
        cp_async(bs + j, hs + o + j);
        cp_async(bs + n + j, hy + o + j);
      }
    }
    cp_commit();
  };
  for (int t = 0; t < RING_DEPTH - 1; ++t) issue(t);
  for (int t = 0; t < count; ++t) {
    issue(t + RING_DEPTH - 1);
    cp_wait<RING_DEPTH - 1>();
    const int k = count - 1 - t;
    const T *s_r = slot(t), *y_r = s_r + n;
    T d[2] = {T(0), T(0)};
    for (int j = tid; j < n; j += nt) {
      d[0] += s_r[j] * y_r[j];
      d[1] += s_r[j] * q[j];
    }
    g.template sum<2>(d);
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
  for (int t = count; t < steps; ++t) {
    issue(t + RING_DEPTH - 1);
    cp_wait<RING_DEPTH - 1>();
    const int k = t - count;
    if (lm.usable[k] == T(0)) continue;
    const T *s_r = slot(t), *y_r = s_r + n;
    T d[1] = {T(0)};
    for (int j = tid; j < n; j += nt) d[0] += y_r[j] * q[j];
    g.template sum<1>(d);
    const T beta = lm.rhos[k] * d[0];
    const T coef = lm.alphas[k] - beta;
    for (int j = tid; j < n; j += nt) q[j] = q[j] + s_r[j] * coef;
  }
  cp_wait<0>();  // the empty groups
}

// Shared memory of one block under mapping ``mp``: staged.cuh's
// mapping_smem, and the ring's RING_DEPTH row pairs for ROWS_RING.
// ops/_kernel.py::lane_smem_bytes mirrors it.
inline size_t two_loop_smem(const Mapping &mp, int m, int n, size_t w) {
  if (mp.rows != ROWS_RING) return mapping_smem(mp, m, n, w);
  return ((size_t)lane_values(m, n, ROWS_DIRECT) +
          (size_t)2 * RING_DEPTH * n + GROUP_RED_VALUES) * w;
}

template <typename T, bool WARP, bool WIDE, bool DQ>
__global__ void __launch_bounds__(bound_threads(WARP, WIDE),
                                  WARP ? WARP_MIN_BLOCKS : 2)
    two_loop_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, m = a.m;
  T *base = reinterpret_cast<T *>(smem_raw);
  Group<T, WARP> grp;
  grp.buf = 0;
  size_t lane;
  if (WARP) {
    const int slot = threadIdx.x >> 5;
    lane = (size_t)blockIdx.x * (blockDim.x >> 5) + slot;
    if (lane >= (size_t)a.b) return;  // ragged last block
    grp.tid = threadIdx.x & 31;
    grp.nt = 32;
    grp.red = nullptr;
    base += (size_t)slot * lane_values(m, n, a.rows);
  } else {
    lane = blockIdx.x;
    grp.tid = threadIdx.x;
    grp.nt = blockDim.x;
    grp.red = base;
    base += GROUP_RED_VALUES;
  }
  T *d = a.d + lane * n;
  // ROWS_DEVICE_Q: q is the lane's direction row itself.
  const LaneMem<T> lm(base, m, n, DQ ? d : nullptr);
  const int tid = grp.tid, nt = grp.nt;
  const T *g = a.g + lane * n;
  const T *hs = a.s + lane * m * n;
  const T *hy = a.y + lane * m * n;
  const int count = lane_count(a.count, lane, m);

  // Each thread reads back only its own elements: no barrier.
  for (int j = tid; j < n; j += nt) lm.q[j] = g[j];
  bool ring = false;
  if constexpr (!WARP) {
    ring = a.rows == ROWS_RING;
    if (ring) ring_two_loop(grp, lm, hs, hy, count, n, a.gamma[lane]);
  }
  if (!ring)
    two_loop_rows(grp, lm, hs, hy, a.rows, count, 0, m, n, a.gamma[lane]);

  if (!DQ)
    for (int j = tid; j < n; j += nt) d[j] = lm.q[j];
}

// A warp per lane (n <= 64, m <= REG_ROWS) with every row in use held in
// registers, loaded with the gradient before the first reduction, so the
// 2 count reductions of the recursion (staged.cuh's regs_two_loop, as in
// push_two_loop_regs_kernel) wait on no load.
template <typename T>
__global__ void __launch_bounds__(WARP_BLOCK_THREADS, WARP_MIN_BLOCKS)
    two_loop_regs_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int E = DIRECT_ELEMENTS;
  const int n = a.n, m = a.m;
  const int slot_w = threadIdx.x >> 5;
  const size_t lane = (size_t)blockIdx.x * (blockDim.x >> 5) + slot_w;
  if (lane >= (size_t)a.b) return;  // ragged last block
  Group<T, true> grp;
  grp.tid = threadIdx.x & 31;
  grp.nt = 32;
  grp.red = nullptr;
  grp.buf = 0;
  const LaneMem<T> lm(reinterpret_cast<T *>(smem_raw) +
                          (size_t)slot_w * lane_values(m, n, ROWS_DIRECT),
                      m, n);
  const int tid = grp.tid;
  const T *g = a.g + lane * n;
  const T *hs = a.s + lane * m * n;
  const T *hy = a.y + lane * m * n;
  const int count = lane_count(a.count, lane, m);

  // Every load of the lane, issued together.
  T q[E], S[REG_ROWS][E], Y[REG_ROWS][E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = tid + 32 * e;
    q[e] = j < n ? g[j] : T(0);
#pragma unroll
    for (int r = 0; r < REG_ROWS; ++r) {
      const bool in = r < count && j < n;
      S[r][e] = in ? hs[(size_t)r * n + j] : T(0);
      Y[r][e] = in ? hy[(size_t)r * n + j] : T(0);
    }
  }
  regs_two_loop(grp, lm, q, S, Y, count, n, a.gamma[lane]);

  T *d = a.d + lane * n;
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (tid + 32 * e < n) d[tid + 32 * e] = q[e];
}

template <typename T>
int launch_regs(const Args<T> &a, const Mapping &mp, cudaStream_t stream) {
  const size_t smem = mapping_smem(Mapping{mp.lpb, 32, ROWS_DIRECT}, a.m, a.n,
                                   sizeof(T));
  if (int err = allow_smem(two_loop_regs_kernel<T>, smem)) return err;
  two_loop_regs_kernel<T>
      <<<(a.b + mp.lpb - 1) / mp.lpb, 32 * mp.lpb, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool WARP, bool WIDE, bool DQ>
int launch_as(const Args<T> &a, const Mapping &mp, cudaStream_t stream) {
  const size_t smem = two_loop_smem(mp, a.m, a.n, sizeof(T));
  if (int err = allow_smem(two_loop_kernel<T, WARP, WIDE, DQ>, smem))
    return err;
  const int blocks = WARP ? (a.b + mp.lpb - 1) / mp.lpb : a.b;
  const int threads = WARP ? 32 * mp.lpb : mp.tpl;
  two_loop_kernel<T, WARP, WIDE, DQ><<<blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args<T> &a, const Mapping &mp, cudaStream_t stream) {
  if (a.b <= 0) return 0;
  if (mp.tpl < 32 || mp.tpl > LANE_MAX_THREADS || mp.tpl % 32 ||
      mp.lpb < 1 || (mp.tpl != 32 && mp.lpb != 1) || mp.rows < 0 ||
      (mp.rows > ROWS_RING && mp.rows != ROWS_DEVICE_Q) ||
      mp.rows == ROWS_STAGED || (mp.rows == ROWS_DEVICE_Q && mp.tpl == 32) ||
      32 * mp.lpb > WARP_BLOCK_THREADS ||
      (mp.tpl == 32 && a.n > 32 * DIRECT_ELEMENTS) ||
      (mp.rows == ROWS_REGISTERS && (mp.tpl != 32 || a.m > REG_ROWS)) ||
      (mp.rows == ROWS_RING && mp.tpl == 32))
    return (int)cudaErrorInvalidValue;
  if (mp.rows == ROWS_REGISTERS) return launch_regs<T>(a, mp, stream);
  if (mp.tpl == 32) return launch_as<T, true, false, false>(a, mp, stream);
  if (mp.rows == ROWS_DEVICE_Q)  // a build of its own (staged.cuh LaneMem)
    return mp.tpl > NARROW_THREADS
               ? launch_as<T, false, true, true>(a, mp, stream)
               : launch_as<T, false, false, true>(a, mp, stream);
  return mp.tpl > NARROW_THREADS
             ? launch_as<T, false, true, false>(a, mp, stream)
             : launch_as<T, false, false, false>(a, mp, stream);
}

}  // namespace

#define CPPNS_TWO_LOOP(NAME, T)                                              \
  extern "C" int NAME(const void *g, const void *s, const void *y,          \
                      const void *count, const void *gamma, void *d, int b, \
                      int n, int m, int lanes_per_block,                    \
                      int threads_per_lane, int rows, void *stream) {       \
    Args<T> a{(const T *)g, (const T *)s, (const T *)y, (const int *)count, \
              (const T *)gamma, (T *)d, b, n, m, rows};                     \
    return launch<T>(a, Mapping{lanes_per_block, threads_per_lane, rows},   \
                     (cudaStream_t)stream);                                 \
  }

CPPNS_TWO_LOOP(cppns_two_loop_f32, float)
CPPNS_TWO_LOOP(cppns_two_loop_f64, double)
