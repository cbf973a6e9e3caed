// One post-evaluation trip of the batched More-Thuente line search, for
// Hopper.
//
// Replaces cppnumericalsolvers_tpu/ops/fused_linesearch.py::_mt_kernel (the
// Pallas TPU kernel).  It computes what the plain PyTorch version
// cppnumericalsolvers_tpu_torch/ops/fused_linesearch.py::mt_trip_reference
// computes, for every lane whose search is still running (info == 0): the
// directional derivative dg = g_t . s, the MINPACK termination ladder, the
// stage-1 frame, cstep, forced bisection and widths, the accepted-gradient
// select and the next trial point x0 + stp * s.
//
// Design (redesigned for Hopper; staged.cuh's lane groups).  The wrapper
// maps lanes to threads with ops/_kernel.py::lane_mapping("mt_trip", ...):
// one warp per lane for n <= 64 (several lanes a block, reductions by
// shuffles alone, thread t owning j = t and t + 32), else one block of 64
// to 512 threads per lane, each thread owning about 8 elements (reductions
// by shuffles and one barrier).  A thread loads its elements of g_t, s and
// x0 into registers before the reduction, so x0's loads are in flight
// during the reduction and the scalar step, and g_t and s are read from
// device memory once: the write pass takes them from registers.  In a
// block per lane, where n is a multiple of 16 bytes' worth of values and
// the rows are 16-byte aligned, each load and store moves 16 bytes (a
// thread owns runs of 4 floats or 2 doubles).  Elements beyond the
// registers (n > 8 x 512) are read again in the write pass.  The carry is
// updated in place, so a lane whose search is over (info != 0, which
// includes the lanes that aborted before their first evaluation) returns at
// once and writes nothing: its trial point, accepted gradient and scalars
// keep their bits.  mt_step (common.cuh) is unchanged; infoc is carried as
// MINPACK carries it.
//
// Sum order of dg.  A warp per lane keeps the order of the kernel this one
// replaced: the first 32 products by xor butterfly, the next 32 likewise,
// and the two sums added.  With a 16-byte, 4-products-a-thread order the
// float32 Hessian-condition solves of chip_smoke.py (path B, n = 32) ended
// on the plain version's status on 86% of lanes against 100% before, a
// criterion that flips on the last bit of dg; the old order kept them.  A
// block per lane: each thread adds its products in order of its units (runs
// of 1, 2 or 4 values) and within a unit in order of j; the block then adds
// the threads by xor butterfly and its warps by a second butterfly
// (staged.cuh Group::reduce).  Either agrees with the plain version's
// torch.sum to RTOL (1e-9 in float64, 1e-5 in float32, of the scalar).
//
// What bounds it on an H100: device-memory bytes.  A searching lane reads
// g_t, s and x0 and writes gacc and x_trial: 3 reads and 2 writes of n
// values plus 20 scalars.  The operations (about 4n) are far below that at
// the card's float32 rate.
//
// Numerics and build flags: see common.cuh (--fmad=false; ops/_build.py).

#include "staged.cuh"

namespace {

using namespace cppns;

// Packed scalar rows (ops/fused_linesearch.py).
constexpr int F_FINIT = 0, F_DGINIT = 1, F_DGTEST = 2, F_FACC = 3, F_STP = 4,
              F_STMIN = 5, F_STMAX = 6, F_STX = 7, F_FX = 8, F_DGX = 9,
              F_STY = 10, F_FY = 11, F_DGY = 12, F_WIDTH = 13, F_WIDTH1 = 14,
              NF = 15;
constexpr int I_BRACKT = 0, I_STAGE1 = 1, I_NFEV = 2, I_INFO = 3, I_INFOC = 4,
              NI = 5;
// Elements a thread holds in registers: a warp per lane (n <= 64) and a
// block per lane.
constexpr int WARP_ELEMENTS = 2, BLOCK_ELEMENTS = 8;
// Blocks per SM the launch bounds ask for: float64 takes half as many, so
// that its registers (the scalars and the held elements) do not spill.
template <typename T, bool WARP> constexpr int min_blocks() {
  return (WARP ? 4 : 2) / (sizeof(T) == 8 ? 2 : 1);
}

template <typename T> struct Args {
  const T *x0, *sdir, *f_t, *g_t;
  T *gacc, *x_trial, *sf;
  int *si;
  int b, n, max_fev;
};

template <typename T, bool WARP, bool WIDE, int VW>
__global__ void __launch_bounds__(bound_threads(WARP, WIDE),
                                  (min_blocks<T, WARP>()))
    mt_trip_kernel(Args<T> a) {
  __shared__ T red[WARP ? 1 : GROUP_RED_VALUES];
  constexpr int E = WARP ? WARP_ELEMENTS : BLOCK_ELEMENTS;
  constexpr int R = E / VW > 0 ? E / VW : 1;  // units held in registers

  Group<T, WARP> grp;
  grp.buf = 0;
  size_t lane;
  if (WARP) {
    lane = (size_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (lane >= (size_t)a.b) return;  // ragged last block
    grp.tid = threadIdx.x & 31;
    grp.nt = 32;
    grp.red = nullptr;
  } else {
    lane = blockIdx.x;
    grp.tid = threadIdx.x;
    grp.nt = blockDim.x;
    grp.red = red;
  }
  const int tid = grp.tid, nt = grp.nt, n = a.n;
  T *sf = a.sf + lane * NF;
  int *si = a.si + lane * NI;
  if (si[I_INFO] != 0) return;  // search over: the lane keeps its bits

  const size_t row = lane * (size_t)n;
  const T *x0 = a.x0 + row, *sdir = a.sdir + row, *g_t = a.g_t + row;
  T *gacc = a.gacc + row, *x_trial = a.x_trial + row;
  const int units = n / VW;

  // Every load of the trip is issued here, x0's included.
  Unit<T, VW> xr[R], gr[R], dr[R];
#pragma unroll
  for (int v = 0; v < R; ++v) {
    const int u = tid + v * nt;
    if (u < units) {
      gr[v] = load_unit<T, VW>(g_t + (size_t)u * VW);
      dr[v] = load_unit<T, VW>(sdir + (size_t)u * VW);
      xr[v] = load_unit<T, VW>(x0 + (size_t)u * VW);
    }
  }
  T f[NF];
  int iv[NI];
#pragma unroll
  for (int k = 0; k < NF; ++k) f[k] = sf[k];
#pragma unroll
  for (int k = 0; k < NI; ++k) iv[k] = si[k];
  const T f_t = a.f_t[lane];

  T dgv[1] = {T(0)};
  if (WARP) {
    // The order of the kernel this one replaced, a 32- or 64-thread block
    // per lane: each 32 elements summed by xor butterfly, then the second
    // 32's sum added to the first's.
    T half[2] = {T(0), T(0)};
#pragma unroll
    for (int v = 0; v < R; ++v)
      if (tid + v * nt < units) half[v] += gr[v].v[0] * dr[v].v[0];
    grp.template sum<2>(half);
    dgv[0] = n > 32 ? half[0] + half[1] : half[0];
  } else {
#pragma unroll
    for (int v = 0; v < R; ++v)
      if (tid + v * nt < units)
#pragma unroll
        for (int c = 0; c < VW; ++c) dgv[0] += gr[v].v[c] * dr[v].v[c];
    for (int u = tid + R * nt; u < units; u += nt) {
      const Unit<T, VW> gu = load_unit<T, VW>(g_t + (size_t)u * VW);
      const Unit<T, VW> du = load_unit<T, VW>(sdir + (size_t)u * VW);
#pragma unroll
      for (int c = 0; c < VW; ++c) dgv[0] += gu.v[c] * du.v[c];
    }
    grp.template sum<1>(dgv);
  }
  // Every thread has read the scalars before thread 0 writes them: in block
  // mode the reduction's barrier orders them, in warp mode the sync.
  if (WARP) grp.sync();

  Search<T> sr{f[F_STP], f[F_STMIN], f[F_STMAX], f[F_STX], f[F_FX], f[F_DGX],
               f[F_STY], f[F_FY], f[F_DGY], f[F_WIDTH], f[F_WIDTH1],
               iv[I_BRACKT], iv[I_STAGE1], iv[I_INFOC]};
  const int nfev1 = iv[I_NFEV] + 1;
  const int info = mt_step(sr, f[F_FINIT], f[F_DGINIT], f[F_DGTEST], f_t,
                           dgv[0], nfev1, a.max_fev);

  const T stp = sr.stp;
#pragma unroll
  for (int v = 0; v < R; ++v) {
    const int u = tid + v * nt;
    if (u < units) {
      Unit<T, VW> xt;
#pragma unroll
      for (int c = 0; c < VW; ++c) xt.v[c] = xr[v].v[c] + stp * dr[v].v[c];
      store_unit<T, VW>(gacc + (size_t)u * VW, gr[v]);
      store_unit<T, VW>(x_trial + (size_t)u * VW, xt);
    }
  }
  for (int u = tid + R * nt; u < units; u += nt) {
    const Unit<T, VW> gu = load_unit<T, VW>(g_t + (size_t)u * VW);
    const Unit<T, VW> du = load_unit<T, VW>(sdir + (size_t)u * VW);
    const Unit<T, VW> xu = load_unit<T, VW>(x0 + (size_t)u * VW);
    Unit<T, VW> xt;
#pragma unroll
    for (int c = 0; c < VW; ++c) xt.v[c] = xu.v[c] + stp * du.v[c];
    store_unit<T, VW>(gacc + (size_t)u * VW, gu);
    store_unit<T, VW>(x_trial + (size_t)u * VW, xt);
  }
  if (tid == 0) {
    sf[F_FACC] = f_t;
    sf[F_STP] = sr.stp; sf[F_STMIN] = sr.stmin; sf[F_STMAX] = sr.stmax;
    sf[F_STX] = sr.stx; sf[F_FX] = sr.fx; sf[F_DGX] = sr.dgx;
    sf[F_STY] = sr.sty; sf[F_FY] = sr.fy; sf[F_DGY] = sr.dgy;
    sf[F_WIDTH] = sr.width; sf[F_WIDTH1] = sr.width1;
    si[I_BRACKT] = sr.brackt; si[I_STAGE1] = sr.stage1;
    si[I_NFEV] = nfev1; si[I_INFO] = info; si[I_INFOC] = sr.infoc;
  }
}

template <typename T, bool WARP, bool WIDE, int VW>
int launch_as(const Args<T> &a, const Mapping &mp, cudaStream_t stream) {
  const int blocks = WARP ? (a.b + mp.lpb - 1) / mp.lpb : a.b;
  const int threads = WARP ? 32 * mp.lpb : mp.tpl;
  mt_trip_kernel<T, WARP, WIDE, VW><<<blocks, threads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args<T> &a, const Mapping &mp, cudaStream_t stream) {
  if (a.b <= 0) return 0;
  if (mp.tpl < 32 || mp.tpl > LANE_MAX_THREADS || mp.tpl % 32 ||
      mp.lpb < 1 || (mp.tpl != 32 && mp.lpb != 1) ||
      mp.rows != ROWS_DIRECT || 32 * mp.lpb > WARP_BLOCK_THREADS ||
      (mp.tpl == 32 && a.n > 32 * WARP_ELEMENTS))
    return (int)cudaErrorInvalidValue;
  constexpr int VW = 16 / sizeof(T);
  if (mp.tpl == 32) return launch_as<T, true, false, 1>(a, mp, stream);
  const bool vec = a.n % VW == 0 && aligned16(a.x0) && aligned16(a.sdir) &&
                   aligned16(a.g_t) && aligned16(a.gacc) &&
                   aligned16(a.x_trial);
  if (mp.tpl > NARROW_THREADS)
    return vec ? launch_as<T, false, true, VW>(a, mp, stream)
               : launch_as<T, false, true, 1>(a, mp, stream);
  return vec ? launch_as<T, false, false, VW>(a, mp, stream)
             : launch_as<T, false, false, 1>(a, mp, stream);
}

}  // namespace

#define CPPNS_MT_TRIP(NAME, T)                                               \
  extern "C" int NAME(const void *x0, const void *sdir, const void *f_t,    \
                      const void *g_t, void *gacc, void *x_trial, void *sf, \
                      void *si, int b, int n, int max_fev,                  \
                      int lanes_per_block, int threads_per_lane, int rows,  \
                      void *stream) {                                       \
    Args<T> a{(const T *)x0, (const T *)sdir, (const T *)f_t,               \
              (const T *)g_t, (T *)gacc, (T *)x_trial, (T *)sf,             \
              (int *)si, b, n, max_fev};                                    \
    return launch<T>(a, Mapping{lanes_per_block, threads_per_lane, rows},   \
                     (cudaStream_t)stream);                                 \
  }

CPPNS_MT_TRIP(cppns_mt_trip_f32, float)
CPPNS_MT_TRIP(cppns_mt_trip_f64, double)
