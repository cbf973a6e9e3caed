// The second half of one batched L-BFGS iteration, for Hopper.
//
// Replaces cppnumericalsolvers_tpu/ops/fused_step.py::_epilogue_kernel (the
// Pallas TPU kernel).  It computes what the plain PyTorch version
// cppnumericalsolvers_tpu_torch/ops/fused_step.py::lbfgs_epilogue_reference
// computes after a line search: the non-finite guard on the search's result,
// the new pending pair s = x1 - x0, y = g1 - g0, the stall reset of the
// history count, and the whole Progress::Update ladder with its violation
// counters and plateau ring.
//
// Design (redesigned for Hopper; staged.cuh's lane groups).  The wrapper
// maps lanes with ops/_kernel.py::lane_mapping("lbfgs_epilogue", ...): a
// warp per lane at n <= 64 (several lanes a block, thread t owning j = t and
// t + 32); else a block of 64 to 512 threads per lane, each thread owning 8
// elements, and where the batch has fewer lanes than the card has SMs
// (B < 132) the lane is split over a thread-block cluster of 2 or 4 blocks,
// each taking a slice of j.  A thread issues every load of its elements
// (x0, g0 and, for a finite search result, its x and g) before it computes
// or stores, with 16-byte accesses in a block per lane where n and the
// rows' alignment allow; elements beyond the registers (n > 8 x 512 x
// cluster) are handled in a loop after them.  The three maxima of the
// ladder are reduced in the group (shuffles, and one barrier in a block); a
// cluster's blocks then post theirs into its first block's shared memory
// (distributed shared memory, one cluster barrier), whose thread 0 finishes
// them.  Only maxima are reduced, and a maximum takes the same bits in any
// order, so every mapping gives the bits of the kernel this one replaced.
// One thread per lane runs the ladder and writes the scalars.  The iterate,
// the pending pair, the count and the progress record are updated in place,
// so a done lane returns at once and writes nothing: every field keeps its
// bits; the Hessian-condition figure is not touched (it passes through).
//
// What bounds it on an H100: device-memory bytes.  A live lane reads x0, g0
// and the search's x and g once and writes x, g and the pending pair once:
// 8 passes of n values, plus some 30 scalars.
//
// Numerics and build flags: see common.cuh (--fmad=false; ops/_build.py).

#include <cooperative_groups.h>

#include "staged.cuh"

namespace {

using namespace cppns;
namespace cg = cooperative_groups;

constexpr int CLUSTER_MAX = 4;
// Elements a thread holds in registers: a warp per lane (n <= 64) and a
// block per lane.
constexpr int WARP_ELEMENTS = 2, BLOCK_ELEMENTS = 8;
// Blocks per SM the launch bounds ask for: float64 takes half as many, so
// that its registers (32 held values a thread) do not spill.
template <typename T, bool WARP> constexpr int min_blocks() {
  return (WARP ? 4 : 2) / (sizeof(T) == 8 ? 2 : 1);
}

template <typename T> struct Args {
  // Iterate (in place) and the line search's result.
  T *x, *value, *g;
  int *nfev;
  const T *x_ls, *f_ls, *g_ls;
  const int *ls_nfev;
  // L-BFGS internals (in place).
  int *count;
  T *s_pend, *y_pend;
  unsigned char *pvalid;
  const unsigned char *done;
  // Progress record (in place).
  int *num_it;
  T *x_delta;
  int *x_viol;
  T *f_delta;
  int *f_viol;
  T *gnorm;
  int *status;
  T *ring;
  int *past_pos;
  int b, n;
  Crit crit;
};

// Cluster barrier halves: arrive (release: this thread's earlier stores,
// remote ones included, are visible to every thread that waits) and wait
// (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <typename T, bool WARP, bool WIDE, int VW, int CL>
__global__ void __launch_bounds__(bound_threads(WARP, WIDE),
                                  (min_blocks<T, WARP>()))
    epilogue_kernel(Args<T> a) {
  __shared__ T red[WARP ? 1 : GROUP_RED_VALUES];
  // The first block's: every block's three maxima.
  __shared__ T part[3 * CL];
  constexpr int E = WARP ? WARP_ELEMENTS : BLOCK_ELEMENTS;
  constexpr int R = E / VW > 0 ? E / VW : 1;  // units held in registers

  Group<T, WARP> grp;
  grp.buf = 0;
  size_t lane;
  int rank = 0;
  if (WARP) {
    lane = (size_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (lane >= (size_t)a.b) return;  // ragged last block
    grp.tid = threadIdx.x & 31;
    grp.nt = 32;
    grp.red = nullptr;
  } else {
    lane = blockIdx.x / CL;
    rank = (int)(blockIdx.x % CL);  // the block's rank in its cluster
    grp.tid = threadIdx.x;
    grp.nt = blockDim.x;
    grp.red = red;
  }
  // Frozen: the lane keeps its bits.  Every block of a cluster serves the
  // same lane, so all of them return here or none does.
  if (a.done[lane]) return;
  // Every block of the cluster must be running before the first block's
  // shared memory is written: this arrival is waited for before the post.
  if (CL > 1) cluster_arrive();

  const int tid = grp.tid, nt = grp.nt, n = a.n;
  const size_t row = lane * (size_t)n;
  T *x = a.x + row, *g = a.g + row;
  const T *x_ls = a.x_ls + row, *g_ls = a.g_ls + row;
  T *s_pend = a.s_pend + row, *y_pend = a.y_pend + row;
  // The search's point is taken only where its value is finite.
  const bool finite = isfinite(a.f_ls[lane]);
  const int units = n / VW;
  const int per = (units + CL - 1) / CL;  // units of one block's slice
  const int u0 = rank * per;
  const int u1 = units < u0 + per ? units : u0 + per;

  T mx[3] = {T(0), T(0), T(0)};  // |s|, |g1|, |x1| maxima
  auto finish = [&](int u, const Unit<T, VW> &x0, const Unit<T, VW> &g0,
                    const Unit<T, VW> &xl, const Unit<T, VW> &gl) {
    Unit<T, VW> x1, g1, sv, yv;
#pragma unroll
    for (int c = 0; c < VW; ++c) {
      x1.v[c] = finite ? xl.v[c] : x0.v[c];
      g1.v[c] = finite ? gl.v[c] : g0.v[c];
      sv.v[c] = x1.v[c] - x0.v[c];
      yv.v[c] = g1.v[c] - g0.v[c];
      mx[0] = nmax(mx[0], fabs(sv.v[c]));
      mx[1] = nmax(mx[1], fabs(g1.v[c]));
      mx[2] = nmax(mx[2], fabs(x1.v[c]));
    }
    const size_t o = (size_t)u * VW;
    store_unit<T, VW>(x + o, x1);
    store_unit<T, VW>(g + o, g1);
    store_unit<T, VW>(s_pend + o, sv);
    store_unit<T, VW>(y_pend + o, yv);
  };

  // Every load of the thread's first R units is issued before any store.
  Unit<T, VW> xr[R], gr[R], xl[R], gl[R];
#pragma unroll
  for (int v = 0; v < R; ++v) {
    const size_t o = (size_t)(u0 + tid + v * nt) * VW;
    if (u0 + tid + v * nt < u1) {
      xr[v] = load_unit<T, VW>(x + o);
      gr[v] = load_unit<T, VW>(g + o);
      if (finite) {
        xl[v] = load_unit<T, VW>(x_ls + o);
        gl[v] = load_unit<T, VW>(g_ls + o);
      } else {
        xl[v] = xr[v];
        gl[v] = gr[v];
      }
    }
  }
#pragma unroll
  for (int v = 0; v < R; ++v)
    if (u0 + tid + v * nt < u1) finish(u0 + tid + v * nt, xr[v], gr[v], xl[v],
                                       gl[v]);
  for (int u = u0 + tid + R * nt; u < u1; u += nt) {
    const size_t o = (size_t)u * VW;
    const Unit<T, VW> x0 = load_unit<T, VW>(x + o);
    const Unit<T, VW> g0 = load_unit<T, VW>(g + o);
    finish(u, x0, g0, finite ? load_unit<T, VW>(x_ls + o) : x0,
           finite ? load_unit<T, VW>(g_ls + o) : g0);
  }
  grp.template max<3>(mx);

  if (CL > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster_wait();
    if (tid == 0) {
      T *dst = cluster.map_shared_rank(part, 0);
#pragma unroll
      for (int k = 0; k < 3; ++k) dst[3 * rank + k] = mx[k];
    }
    cluster_arrive();
    cluster_wait();
    if (rank != 0 || tid != 0) return;
#pragma unroll
    for (int r = 0; r < CL; ++r)
#pragma unroll
      for (int k = 0; k < 3; ++k) mx[k] = nmax(mx[k], part[3 * r + k]);
  }
  if (tid != 0) return;

  // The lane's scalars: read and written by this one thread.
  T *ringp = a.ring + lane * RING;
  T ring[RING];
#pragma unroll
  for (int k = 0; k < RING; ++k) ring[k] = ringp[k];
  const T f0 = a.value[lane];
  const T f1 = finite ? a.f_ls[lane] : f0;
  const T x_delta = mx[0], grad_norm = mx[1], xmax = mx[2];
  const T f_delta = fabs(f1 - f0);
  const Ladder l = progress_ladder(a.crit, a.num_it[lane], a.x_viol[lane],
                                   a.f_viol[lane], a.past_pos[lane], ring,
                                   x_delta, f_delta, f1, f0, grad_norm, xmax);
  a.value[lane] = f1;
  a.nfev[lane] = a.nfev[lane] + a.ls_nfev[lane];
  if (x_delta <= T(0)) a.count[lane] = 0;  // stall reset
  a.pvalid[lane] = finite ? 1 : 0;
  a.num_it[lane] = l.num_it;
  a.x_delta[lane] = x_delta;
  a.x_viol[lane] = l.x_viol;
  a.f_delta[lane] = f_delta;
  a.f_viol[lane] = l.f_viol;
  a.gnorm[lane] = grad_norm;
  a.status[lane] = l.status;
  a.past_pos[lane] = l.past_pos;
#pragma unroll
  for (int k = 0; k < RING; ++k) ringp[k] = ring[k];
}

template <typename T, bool WARP, bool WIDE, int VW, int CL>
int launch_as(const Args<T> &a, int lpb, int block_threads,
              cudaStream_t stream) {
  auto kernel = epilogue_kernel<T, WARP, WIDE, VW, CL>;
  const int blocks = WARP ? (a.b + lpb - 1) / lpb : a.b * CL;
  if (CL == 1) {
    kernel<<<blocks, block_threads, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3((unsigned)block_threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, bool WIDE, int VW>
int launch_block(const Args<T> &a, int cl, int bt, cudaStream_t stream) {
  return cl == 1   ? launch_as<T, false, WIDE, VW, 1>(a, 1, bt, stream)
         : cl == 2 ? launch_as<T, false, WIDE, VW, 2>(a, 1, bt, stream)
                   : launch_as<T, false, WIDE, VW, 4>(a, 1, bt, stream);
}

template <typename T>
int launch(const Args<T> &a, int lpb, int tpl, int cl, cudaStream_t stream) {
  if (a.b <= 0) return 0;
  const bool warp = tpl == 32 && cl == 1;
  const int bt = cl >= 1 ? tpl / cl : 0;  // threads of one block
  if (cl < 1 || cl > CLUSTER_MAX || (cl & (cl - 1)) || tpl % cl ||
      bt < 32 || bt > LANE_MAX_THREADS || bt % 32 || lpb < 1 ||
      (warp ? 32 * lpb > WARP_BLOCK_THREADS || a.n > 32 * WARP_ELEMENTS
            : lpb != 1))
    return (int)cudaErrorInvalidValue;
  if (warp) return launch_as<T, true, false, 1, 1>(a, lpb, 32 * lpb, stream);
  constexpr int VW = 16 / sizeof(T);
  const bool vec = a.n % VW == 0 && aligned16(a.x) && aligned16(a.g) &&
                   aligned16(a.x_ls) && aligned16(a.g_ls) &&
                   aligned16(a.s_pend) && aligned16(a.y_pend);
  if (bt > NARROW_THREADS)
    return vec ? launch_block<T, true, VW>(a, cl, bt, stream)
               : launch_block<T, true, 1>(a, cl, bt, stream);
  return vec ? launch_block<T, false, VW>(a, cl, bt, stream)
             : launch_block<T, false, 1>(a, cl, bt, stream);
}

}  // namespace

#define CPPNS_EPILOGUE(NAME, T)                                              \
  extern "C" int NAME(                                                      \
      void *x, void *value, void *g, void *nfev, const void *x_ls,          \
      const void *f_ls, const void *g_ls, const void *ls_nfev, void *count, \
      void *s_pend, void *y_pend, void *pvalid, const void *done,           \
      void *num_it, void *x_delta, void *x_viol, void *f_delta,             \
      void *f_viol, void *gnorm, void *status, void *ring, void *past_pos,  \
      int b, int n, int lanes_per_block, int threads_per_lane,              \
      int cluster, double c_x_delta, double c_f_delta,                      \
      double c_past_delta, double c_gradient_norm, int max_iterations,      \
      int x_delta_violations, int f_delta_violations, int past,             \
      int f_delta_relative, int gradient_norm_relative, void *stream) {     \
    Crit crit{c_x_delta,        c_f_delta,         c_past_delta,           \
              c_gradient_norm,  max_iterations,    x_delta_violations,     \
              f_delta_violations, past,            f_delta_relative,       \
              gradient_norm_relative};                                      \
    Args<T> a{(T *)x, (T *)value, (T *)g, (int *)nfev, (const T *)x_ls,     \
              (const T *)f_ls, (const T *)g_ls, (const int *)ls_nfev,       \
              (int *)count, (T *)s_pend, (T *)y_pend,                       \
              (unsigned char *)pvalid, (const unsigned char *)done,         \
              (int *)num_it, (T *)x_delta, (int *)x_viol, (T *)f_delta,     \
              (int *)f_viol, (T *)gnorm, (int *)status, (T *)ring,          \
              (int *)past_pos, b, n, crit};                                 \
    return launch<T>(a, lanes_per_block, threads_per_lane, cluster,         \
                     (cudaStream_t)stream);                                 \
  }

CPPNS_EPILOGUE(cppns_lbfgs_epilogue_f32, float)
CPPNS_EPILOGUE(cppns_lbfgs_epilogue_f64, double)
