// The first half of one batched L-BFGS iteration on the batch-minor
// ("transposed") history, for Hopper.
//
// Replaces cppnumericalsolvers_tpu/ops/fused_step_t.py::_prologue_t_kernel
// (the Pallas TPU kernel).  It computes what the plain PyTorch version
// cppnumericalsolvers_tpu_torch/ops/fused_step_t.py::lbfgs_prologue_t_reference
// computes: the curvature-gated push of the pending pair with the gamma
// update, the two-loop recursion on the updated history, the invalid-descent
// fallback to steepest descent with a history reset, and the line search's
// set-up (alpha_init, dginit).  It writes the search direction.
//
// Layout.  The history is (m * n, B): element j of physical row p of lane i
// at [(p * n + j) * B + i].  It is a ring per lane: the row of age k (0 the
// oldest) is physical row (head + k) mod m.  An accepted pair writes one row
// (physical (head + count) mod m, or, into a full history, the oldest row,
// after which head moves on by one); nothing shifts.  The iteration vectors
// (x, g, the pending pair, the direction) are (B, n) and are read and
// written where they are.
//
// Design (ops/fused_step_t.py::prologue_t_launch_plan picks the numbers).
// The kernel adds every dot product in the order of the batch-major kernel
// (lbfgs_prologue.cu, staged.cuh) at the same n, so the two layouts give the
// same bits and the batch-minor loop walks the batch-major loop's way.  That
// kernel gives a lane TPL threads (ops/_kernel.py::lane_threads: one warp at
// n <= 64, else 64 to 512), thread t owning j = t, t + TPL, ...; each adds
// its products in order of j, a warp adds its 32 sums by xor butterfly
// (offsets 16, 8, 4, 2, 1), and the TPL / 32 warps' sums are added by the
// same butterfly over 32 slots padded with zeros.  Here those TPL "virtual"
// threads of a lane are spread over a lane tile of 8 neighbouring lanes: a
// real warp holds 8 lanes x 4 virtual threads per lane (virtual lanes l0,
// l0 + 8, l0 + 16, l0 + 24 of one virtual warp), so its history loads are
// runs of 8 lanes (whole 32-byte sectors) and its butterfly with offsets 16
// and 8 is the first two levels of the virtual warp's.  The 8 * TPL / 32
// real warps of a tile sit in a cluster of C thread blocks (1 to 8,
// cudaLaunchAttributeClusterDimension); each posts its partial into every
// block of the cluster (distributed shared memory) and arrives at the
// cluster barrier; after the wait every thread reads its lane's partials
// and finishes both trees (levels 4, 2, 1 over l0, then the padded tree
// over the virtual warps) in the batch-major order.  One cluster barrier per
// reduction, no block barrier; the partials are double-buffered, so a
// buffer is written again only after the barrier that follows its readers.
// q lives in registers with the current and the next history row (EPT, a
// template argument, is the elements per virtual thread), and row k - 1's
// loads are issued between the two halves of row k's reduction, so they are
// in flight while the cluster waits.  The grid is sized by B x n: at least
// 2 x 132 blocks at the routing shapes.
//
// Numerics.  Every other operation is the batch-major kernel's expression
// (common.cuh's push gate and descent check, staged.cuh's recursion), so in
// both dtypes the outputs equal the batch-major kernel's bit for bit on the
// same inputs, and the plain version's to rounding: float32 directions to
// DIRECTION_RTOL (1e-4 of the largest entry), float64 to 1e-9; integer
// outputs are equal.
//
// Lanes of one tile differ in count and in being done, and barriers are
// tile-wide, so the row loops run to the tile's largest count with per-lane
// masks (the count is the same in every block of the cluster, since every
// block computes it from the same sums); a masked thread skips its loads.
// A done lane touches none of history, count, gamma, head and emits the zero
// direction with dginit = 0; lanes past B are inert.  Block rank 0's first
// real warp writes the scalars.  g is read again for the descent check
// rather than held in registers through the loops.
//
// What bounds it on an H100: device-memory bytes.  A live lane reads x, g and
// the pending pair, reads the history rows in use (the two passes read them
// twice), writes one row pair when it accepts and the direction.  A lane's
// rows are one sector per element only while the lanes of a tile share their
// head; a tile whose heads differ reads up to 8 rows per element.  On the
// card the chain of 2m + 2 reductions, each waiting on a cluster barrier,
// sets the time as much as the bytes do (PERF.md).
//
// Numerics and build flags: see common.cuh (--fmad=false; ops/_build.py).

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

using namespace cppns;
namespace cg = cooperative_groups;

constexpr int SUMS = 5;   // values the widest reduction carries
constexpr int LB = 8;     // lanes per tile
constexpr int CLUSTER_MAX = 8;

template <typename T> struct Args {
  const T *x, *g, *s_new, *y_new;
  const unsigned char *valid, *done;
  T *s, *y;
  int *count, *head;
  T *gamma, *ls_dir, *alpha, *dginit;
  int b, n, m, tpl, warps, cl;
};

// Cluster barrier halves: arrive (release: this thread's earlier stores,
// remote ones included, are visible to every thread that waits) and wait
// (acquire).  Loads issued between the two stay in flight across it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

constexpr int NVW_MAX = 16;  // virtual warps of a lane (512 threads)

// Row stride of a tile's partials: the 8 * nvw slots padded by 16 bytes, so
// the 8 lanes' 16-byte reads fall on distinct banks.
template <typename T> __host__ __device__ int slot_stride(int nvw) {
  return 8 * nvw + 16 / (int)sizeof(T);
}

// Partials of a tile's real warps: [2 buffers][SUMS][LB lanes][stride],
// slot g of a lane's row being real warp g of the tile (virtual warp g / 8,
// virtual lanes g % 8 + {0, 8, 16, 24}).  NV bounds the virtual warps of a
// lane at compile time (1, 8 or 16).
template <typename T, int NV> struct Tile {
  T *cred;
  int slot, ll, buf, nvw, stride;

  // Levels 16 and 8 of the virtual warp's butterfly: the 4 threads of a
  // lane in this warp.
  template <int K> __device__ static void butterfly(T (&v)[K]) {
#pragma unroll
    for (int off = 16; off >= LB; off >>= 1)
#pragma unroll
      for (int k = 0; k < K; ++k)
        v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  }
  template <int K> __device__ void post(const T (&v0)[K],
                                        cg::cluster_group &cluster, int cl) {
    T v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = v0[k];
    butterfly<K>(v);
    T *cr = cred + (size_t)buf * SUMS * LB * stride;
    if ((threadIdx.x & 31) < LB)
      for (int r = 0; r < cl; ++r) {
        T *dst = cluster.map_shared_rank(cr, r);
#pragma unroll
        for (int k = 0; k < K; ++k) dst[(k * LB + ll) * stride + slot] = v[k];
      }
    cluster_arrive();
  }
  template <int K> __device__ void collect(T (&v)[K]) {
    cluster_wait();
    const T *cr = cred + (size_t)buf * SUMS * LB * stride;
    buf ^= 1;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T *row = cr + (k * LB + ll) * stride;
      // Every index below is a compile-time constant (the loops unroll), so
      // the arrays stay in registers.
      T ws[NV];
#pragma unroll
      for (int w = 0; w < NV; ++w) {
        ws[w] = T(0);
        if (w < nvw) {  // uniform across the block
          T p[8];
          load8(row + 8 * w, p);
          // Levels 4, 2, 1 of the virtual warp's butterfly.
#pragma unroll
          for (int len = 4; len > 0; len >>= 1)
#pragma unroll
            for (int i = 0; i < len; ++i) p[i] = p[i] + p[i + len];
          ws[w] = p[0];
        }
      }
      if (NV == 1) {
        v[k] = ws[0];  // a warp per lane: no second butterfly
      } else {
        // The block-per-lane kernel's second butterfly over 32 slots, the
        // warps' sums first and zeros after: its levels 16 (and 8, where
        // NV = 8) add a zero to each slot below.
#pragma unroll
        for (int i = 0; i < NV; ++i) ws[i] = ws[i] + T(0);
        if (NV == 8)
#pragma unroll
          for (int i = 0; i < NV; ++i) ws[i] = ws[i] + T(0);
#pragma unroll
        for (int len = NV / 2; len > 0; len >>= 1)
#pragma unroll
          for (int i = 0; i < len; ++i) ws[i] = ws[i] + ws[i + len];
        v[k] = ws[0];
      }
    }
  }
  __device__ static void load8(const T *src, T (&p)[8]) {
    if constexpr (sizeof(T) == 4) {
      const float4 a = reinterpret_cast<const float4 *>(src)[0];
      const float4 b = reinterpret_cast<const float4 *>(src)[1];
      p[0] = a.x; p[1] = a.y; p[2] = a.z; p[3] = a.w;
      p[4] = b.x; p[5] = b.y; p[6] = b.z; p[7] = b.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const double2 a = reinterpret_cast<const double2 *>(src)[i];
        p[2 * i] = a.x;
        p[2 * i + 1] = a.y;
      }
    }
  }
};

// Launch bounds: blocks of up to 512 threads (NV = 16: more than 8 warps,
// where a lane has more than 8 virtual warps) one per SM; else 256 threads,
// two blocks per SM (128 registers a thread) while q and two rows of s and
// y (5 EPT values) take fewer than 80 registers, else one.  Tighter bounds
// spilled on the card.
template <int NV> constexpr int bound_threads() {
  return NV == 16 ? 512 : 256;
}
template <typename T, int EPT, int NV> constexpr int min_blocks() {
  return NV == 16 ? 1 : (5 * EPT * (int)sizeof(T) / 4 < 80 ? 2 : 1);
}

template <typename T, int EPT, int NV>
__global__ void __launch_bounds__(bound_threads<NV>(),
                                  (min_blocks<T, EPT, NV>()))
    prologue_t_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  // Every block of the cluster must be running before any stores into its
  // shared memory: this arrival is waited for before the first post().
  cluster_arrive();
  const int n = a.n, m = a.m, CL = a.cl, TPL = a.tpl;
  const int rank = (int)cluster.block_rank();
  const int wl = threadIdx.x & 31;
  Tile<T, NV> tile;
  tile.cred = reinterpret_cast<T *>(smem_raw);
  tile.ll = wl % LB;
  tile.slot = rank * a.warps + (int)(threadIdx.x >> 5);
  tile.buf = 0;
  tile.nvw = TPL / 32;
  tile.stride = slot_stride<T>(tile.nvw);
  T *alphas = tile.cred + 2 * SUMS * LB * tile.stride;
  T *rhos = alphas + m * LB;
  T *usables = rhos + m * LB;

  const int ll = tile.ll, tq = wl / LB;
  const size_t lane = (size_t)(blockIdx.x / CL) * LB + ll;
  const size_t B = (size_t)a.b;
  const bool in_batch = lane < B;
  const bool live = in_batch && a.done[lane] == 0;
  const T eps = Eps<T>::v;
  // This thread is the batch-major kernel's thread t of the lane and owns
  // j = t + e * TPL for e < EPT, below n.
  const int vw = tile.slot / 8, l0 = tile.slot % 8;
  const int t = 32 * vw + l0 + 8 * (tq & 1) + 16 * (tq >> 1);
  auto jof = [&](int e) { return t + e * TPL; };
  const size_t vrow = lane * (size_t)n;

  const int count = live ? a.count[lane] : 0;
  const int head = live ? a.head[lane] : 0;
  const T gamma = live ? a.gamma[lane] : T(1);
  const bool valid = live && a.valid[lane] != 0;

  // q starts as g; the pending pair stays in registers until it is pushed.
  T q[EPT], sn[EPT], yn[EPT];
  T sm[SUMS] = {T(0), T(0), T(0), T(0), T(0)};  // s.y, s.s, y.y, x.x, g.g
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const bool on = live && jof(e) < n;
    const size_t o = vrow + jof(e);
    sn[e] = on ? a.s_new[o] : T(0);
    yn[e] = on ? a.y_new[o] : T(0);
    q[e] = on ? a.g[o] : T(0);
    if (on) {
      const T xv = a.x[o];
      sm[0] += sn[e] * yn[e];
      sm[1] += sn[e] * sn[e];
      sm[2] += yn[e] * yn[e];
      sm[3] += xv * xv;
      sm[4] += q[e] * q[e];
    }
  }
  cluster_wait();
  // The barriers of the reductions also order every block's reads of
  // count, head and gamma above before rank 0's writes at the end.
  tile.template post<SUMS>(sm, cluster, CL);
  tile.template collect<SUMS>(sm);

  const Push<T> p = push_gate(valid, sm[0], sm[1], sm[2], count, m, gamma);
  const int new_count = live ? p.new_count : 0;
  int new_head = head;
  T *hs = a.s + lane, *hy = a.y + lane;
  if (live && p.accept) {
    int slot = head;
    if (p.full) {
      new_head = head + 1 == m ? 0 : head + 1;
    } else {
      slot = head + count;
      if (slot >= m) slot -= m;
    }
#pragma unroll
    for (int e = 0; e < EPT; ++e)
      if (jof(e) < n) {
        const size_t o = ((size_t)slot * n + jof(e)) * B;
        hs[o] = sn[e];
        hy[o] = yn[e];
      }
  }

  // The tile's largest count: every warp holds all LB lanes.
  int rows = new_count;
  for (int off = LB / 2; off > 0; off >>= 1) {
    const int o = __shfl_xor_sync(0xffffffffu, rows, off);
    rows = o > rows ? o : rows;
  }
  // This thread's elements of the row of age k, or zeros where ``on`` is
  // false.
  auto load_row = [&](int k, bool on, T (&sr)[EPT], T (&yr)[EPT]) {
    int r = new_head + k;
    if (r >= m) r -= m;
    const size_t base = (size_t)r * n;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const bool in = on && jof(e) < n;
      sr[e] = in ? hs[(base + jof(e)) * B] : T(0);
      yr[e] = in ? hy[(base + jof(e)) * B] : T(0);
    }
  };

  // First loop, newest to oldest; row k - 1's loads are issued between the
  // halves of row k's reduction.
  T sr[EPT], yr[EPT], ns[EPT], ny[EPT];
  if (rows > 0) load_row(rows - 1, rows - 1 < new_count, sr, yr);
  for (int k = rows - 1; k >= 0; --k) {
    const bool active = k < new_count;
    T d[2] = {T(0), T(0)};
#pragma unroll
    for (int e = 0; e < EPT; ++e)
      if (active && jof(e) < n) {
        d[0] += sr[e] * yr[e];
        d[1] += sr[e] * q[e];
      }
    tile.template post<2>(d, cluster, CL);
    if (k > 0) load_row(k - 1, k - 1 < new_count, ns, ny);
    tile.template collect<2>(d);
    const bool usable = active && fabs(d[0]) >= eps;
    const T rho = usable ? T(1) / d[0] : T(0);
    const T alpha = rho * d[1];
    if (usable)
#pragma unroll
      for (int e = 0; e < EPT; ++e) q[e] = q[e] - alpha * yr[e];
    // Every thread of the lane writes the same values and reads them back.
    alphas[k * LB + ll] = alpha;
    rhos[k * LB + ll] = rho;
    usables[k * LB + ll] = usable ? T(1) : T(0);
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      sr[e] = ns[e];
      yr[e] = ny[e];
    }
  }
#pragma unroll
  for (int e = 0; e < EPT; ++e) q[e] = q[e] * p.new_gamma;

  // Second loop, oldest to newest, skipping rows that no lane of the tile
  // uses (the same in every warp and block of the cluster).
  auto used = [&](int k) {
    return k < new_count && usables[k * LB + ll] != T(0);
  };
  int k = 0;
  while (k < rows && !__any_sync(0xffffffffu, used(k))) ++k;
  if (k < rows) load_row(k, used(k), sr, yr);
  while (k < rows) {
    const bool usable = used(k);
    int next = k + 1;
    while (next < rows && !__any_sync(0xffffffffu, used(next))) ++next;
    T d[1] = {T(0)};
#pragma unroll
    for (int e = 0; e < EPT; ++e)
      if (usable && jof(e) < n) d[0] += yr[e] * q[e];
    tile.template post<1>(d, cluster, CL);
    if (next < rows) load_row(next, used(next), ns, ny);
    tile.template collect<1>(d);
    if (usable) {
      const T beta = rhos[k * LB + ll] * d[0];
      const T coef = alphas[k * LB + ll] - beta;
#pragma unroll
      for (int e = 0; e < EPT; ++e) q[e] = q[e] + sr[e] * coef;
    }
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      sr[e] = ns[e];
      yr[e] = ny[e];
    }
    k = next;
  }

  // g is read again here rather than held in registers through the loops.
  T gv[EPT], dq[2] = {T(0), T(0)};  // g.q, q.q
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const bool on = live && jof(e) < n;
    gv[e] = on ? a.g[vrow + jof(e)] : T(0);
    if (on) {
      dq[0] += gv[e] * q[e];
      dq[1] += q[e] * q[e];
    }
  }
  tile.template post<2>(dq, cluster, CL);
  tile.template collect<2>(dq);
  // No block touches another's shared memory after the last cluster wait,
  // so blocks may return from here on.
  if (!in_batch) return;
  T *ls_dir = a.ls_dir + vrow;
  const bool writer = rank == 0 && threadIdx.x < LB;
  if (!live) {
#pragma unroll
    for (int e = 0; e < EPT; ++e)
      if (jof(e) < n) ls_dir[jof(e)] = T(0);
    if (writer) {
      a.alpha[lane] = T(1);
      a.dginit[lane] = T(0);
    }
    return;
  }
  const Descent<T> ds = descent_check(dq[0], dq[1], sm[4], sm[3], new_count);
#pragma unroll
  for (int e = 0; e < EPT; ++e)
    if (jof(e) < n) ls_dir[jof(e)] = -(ds.invalid ? gv[e] : q[e]);
  if (writer) {
    a.alpha[lane] = ds.alpha0;
    a.dginit[lane] = ds.dginit;
    a.count[lane] = ds.invalid ? 0 : new_count;
    a.gamma[lane] = p.new_gamma;
    a.head[lane] = new_head;
  }
}

// Shared memory of one block, in bytes; fused_step_t.py::_plan_smem mirrors
// it.
template <typename T> size_t plan_smem(int nvw, int m) {
  return (size_t)(2 * SUMS * LB * slot_stride<T>(nvw) + 3 * m * LB) *
         sizeof(T);
}

template <typename T, int EPT, int NV>
int launch_as(const Args<T> &a, cudaStream_t stream) {
  auto kernel = prologue_t_kernel<T, EPT, NV>;
  const size_t smem = plan_smem<T>(a.tpl / 32, a.m);
  if (int err = allow_smem(kernel, smem)) return err;
  const int tiles = (a.b + LB - 1) / LB;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * a.cl), 1, 1);
  cfg.blockDim = dim3((unsigned)(32 * a.warps), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args<T> &a, cudaStream_t stream) {
  if (a.b <= 0) return 0;
  const int nvw = a.tpl / 32;
  // The batch-major kernel's threads per lane, split over the cluster.
  if (a.tpl % 32 || nvw < 1 || nvw > NVW_MAX || a.warps < 1 || a.cl < 1 ||
      a.cl > CLUSTER_MAX || a.warps * a.cl != 8 * nvw ||
      a.warps > (nvw > 8 ? NVW_MAX : 8) || a.m < 1 || a.n < 1 ||
      (nvw == 1) != (a.n <= 64))
    return (int)cudaErrorInvalidValue;
  const int ept = (a.n + a.tpl - 1) / a.tpl;
  if (nvw == 1)  // n <= 64: at most 2 elements a thread
    return ept <= 1 ? launch_as<T, 1, 1>(a, stream)
                    : launch_as<T, 2, 1>(a, stream);
  if (nvw > 8)
    return ept <= 8    ? launch_as<T, 8, 16>(a, stream)
           : ept <= 16 ? launch_as<T, 16, 16>(a, stream)
                       : (int)cudaErrorInvalidValue;
  return ept <= 2   ? launch_as<T, 2, 8>(a, stream)
         : ept <= 4 ? launch_as<T, 4, 8>(a, stream)
         : ept <= 8 ? launch_as<T, 8, 8>(a, stream)
                    : (int)cudaErrorInvalidValue;
}

}  // namespace

#define CPPNS_PROLOGUE_T(NAME, T)                                            \
  extern "C" int NAME(const void *x, const void *g, const void *s_new,      \
                      const void *y_new, const void *valid,                 \
                      const void *done, void *s, void *y, void *count,      \
                      void *head, void *gamma, void *ls_dir, void *alpha,   \
                      void *dginit, int b, int n, int m,                    \
                      int threads_per_lane, int warps_per_block,            \
                      int cluster, void *stream) {                          \
    Args<T> a{(const T *)x, (const T *)g, (const T *)s_new,                 \
              (const T *)y_new, (const unsigned char *)valid,               \
              (const unsigned char *)done, (T *)s, (T *)y, (int *)count,    \
              (int *)head, (T *)gamma, (T *)ls_dir, (T *)alpha,             \
              (T *)dginit, b, n, m, threads_per_lane, warps_per_block,      \
              cluster};                                                     \
    return launch<T>(a, (cudaStream_t)stream);                              \
  }

CPPNS_PROLOGUE_T(cppns_lbfgs_prologue_t_f32, float)
CPPNS_PROLOGUE_T(cppns_lbfgs_prologue_t_f64, double)
