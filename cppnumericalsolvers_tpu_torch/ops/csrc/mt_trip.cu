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
// Design.  One thread block per lane, as common.cuh sets out; no shared
// memory beyond the reduction scratch.  The carry is updated in place, so a
// lane whose search is over (info != 0, which includes the lanes that
// aborted before their first evaluation) is a block that returns at once and
// writes nothing: its trial point, accepted gradient and scalars keep their
// bits.
//
// What bounds it on an H100: device-memory bytes.  A searching lane reads
// g_t and s for the reduction, reads x0 and s again for the trial point and
// writes gacc and x_trial: by the count of each array once, 3 reads and 2
// writes of n values plus 20 scalars.  The operations (about 4n) are far
// below that at the card's float32 rate.
//
// Numerics and build flags: see common.cuh (--fmad=false; ops/_build.py).

#include "common.cuh"

namespace {

using namespace cppns;

// Packed scalar rows (ops/fused_linesearch.py).
constexpr int F_FINIT = 0, F_DGINIT = 1, F_DGTEST = 2, F_FACC = 3, F_STP = 4,
              F_STMIN = 5, F_STMAX = 6, F_STX = 7, F_FX = 8, F_DGX = 9,
              F_STY = 10, F_FY = 11, F_DGY = 12, F_WIDTH = 13, F_WIDTH1 = 14,
              NF = 15;
constexpr int I_BRACKT = 0, I_STAGE1 = 1, I_NFEV = 2, I_INFO = 3, I_INFOC = 4,
              NI = 5;

template <typename T> struct Args {
  const T *x0, *sdir, *f_t, *g_t;
  T *gacc, *x_trial, *sf;
  int *si;
  int n, max_fev;
};

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) mt_trip_kernel(Args<T> a) {
  __shared__ T red[RED_SLOTS * MAX_WARPS];

  const int n = a.n;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t lane = blockIdx.x;
  T *sf = a.sf + lane * NF;
  int *si = a.si + lane * NI;
  if (si[I_INFO] != 0) return;  // search over: the lane keeps its bits

  const T *x0 = a.x0 + lane * n;
  const T *sdir = a.sdir + lane * n;
  const T *g_t = a.g_t + lane * n;
  T *gacc = a.gacc + lane * n;
  T *x_trial = a.x_trial + lane * n;

  T f[NF];
  int iv[NI];
#pragma unroll
  for (int k = 0; k < NF; ++k) f[k] = sf[k];
#pragma unroll
  for (int k = 0; k < NI; ++k) iv[k] = si[k];

  T dgv[1] = {T(0)};
  for (int j = tid; j < n; j += nt) dgv[0] += g_t[j] * sdir[j];
  // The barriers inside also order every thread's scalar reads above
  // before thread 0's writes below.
  block_sum<T, 1>(dgv, red);

  Search<T> sr{f[F_STP], f[F_STMIN], f[F_STMAX], f[F_STX], f[F_FX], f[F_DGX],
               f[F_STY], f[F_FY], f[F_DGY], f[F_WIDTH], f[F_WIDTH1],
               iv[I_BRACKT], iv[I_STAGE1], iv[I_INFOC]};
  const T f_t = a.f_t[lane];
  const int nfev1 = iv[I_NFEV] + 1;
  const int info = mt_step(sr, f[F_FINIT], f[F_DGINIT], f[F_DGTEST], f_t,
                           dgv[0], nfev1, a.max_fev);

  const T stp = sr.stp;
  for (int j = tid; j < n; j += nt) {
    gacc[j] = g_t[j];
    x_trial[j] = x0[j] + stp * sdir[j];
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

template <typename T>
int launch(const T *x0, const T *sdir, const T *f_t, const T *g_t, T *gacc,
           T *x_trial, T *sf, int *si, int b, int n, int max_fev,
           cudaStream_t stream) {
  if (b <= 0) return 0;
  Args<T> a{x0, sdir, f_t, g_t, gacc, x_trial, sf, si, n, max_fev};
  mt_trip_kernel<T><<<b, block_threads(n), 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

#define CPPNS_MT_TRIP(NAME, T)                                               \
  extern "C" int NAME(const void *x0, const void *sdir, const void *f_t,    \
                      const void *g_t, void *gacc, void *x_trial, void *sf, \
                      void *si, int b, int n, int max_fev, void *stream) {  \
    return launch<T>((const T *)x0, (const T *)sdir, (const T *)f_t,        \
                     (const T *)g_t, (T *)gacc, (T *)x_trial, (T *)sf,      \
                     (int *)si, b, n, max_fev, (cudaStream_t)stream);       \
  }

CPPNS_MT_TRIP(cppns_mt_trip_f32, float)
CPPNS_MT_TRIP(cppns_mt_trip_f64, double)
