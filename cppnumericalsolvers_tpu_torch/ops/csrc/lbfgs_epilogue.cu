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
// Design.  One thread block per lane, as common.cuh sets out; no shared
// memory beyond the reduction scratch.  The iterate, the pending pair, the
// count and the progress record are updated in place, so a done lane is a
// block that returns at once and writes nothing: every field keeps its bits.
//
// What bounds it on an H100: device-memory bytes.  A live lane reads x0, g0
// and the search's x and g once and writes x, g and the pending pair once:
// 8 passes of n values, plus some 30 scalars.  One loop does all of it and
// feeds the three max-reductions of the ladder.
//
// Numerics and build flags: see common.cuh (--fmad=false; ops/_build.py).

#include "common.cuh"

namespace {

using namespace cppns;

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
  int n;
  Crit crit;
};

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) epilogue_kernel(Args<T> a) {
  __shared__ T red[RED_SLOTS * MAX_WARPS];

  const int n = a.n;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t lane = blockIdx.x;
  if (a.done[lane]) return;  // frozen: the lane keeps its bits

  T *x = a.x + lane * n;
  T *g = a.g + lane * n;
  const T *x_ls = a.x_ls + lane * n;
  const T *g_ls = a.g_ls + lane * n;
  T *s_pend = a.s_pend + lane * n;
  T *y_pend = a.y_pend + lane * n;
  T *ringp = a.ring + lane * RING;

  const T f0 = a.value[lane];
  const T f_ls = a.f_ls[lane];
  const int nfev0 = a.nfev[lane], ls_nfev = a.ls_nfev[lane];
  const int count = a.count[lane];
  const int num_it0 = a.num_it[lane], x_viol0 = a.x_viol[lane];
  const int f_viol0 = a.f_viol[lane], pp = a.past_pos[lane];
  T ring[RING];
#pragma unroll
  for (int k = 0; k < RING; ++k) ring[k] = ringp[k];

  const bool finite = isfinite(f_ls);
  const T f1 = finite ? f_ls : f0;

  T mx[3] = {T(0), T(0), T(0)};  // |s|, |g1|, |x1| maxima
  for (int j = tid; j < n; j += nt) {
    const T x0j = x[j], g0j = g[j];
    const T x1 = finite ? x_ls[j] : x0j;
    const T g1 = finite ? g_ls[j] : g0j;
    const T sv = x1 - x0j, yv = g1 - g0j;
    mx[0] = nmax(mx[0], fabs(sv));
    mx[1] = nmax(mx[1], fabs(g1));
    mx[2] = nmax(mx[2], fabs(x1));
    x[j] = x1;
    g[j] = g1;
    s_pend[j] = sv;
    y_pend[j] = yv;
  }
  // The barriers inside also order every thread's scalar reads above
  // before thread 0's writes below.
  block_max<T, 3>(mx, red);
  const T x_delta = mx[0], grad_norm = mx[1], xmax = mx[2];
  const T f_delta = fabs(f1 - f0);

  const Ladder l =
      progress_ladder(a.crit, num_it0, x_viol0, f_viol0, pp, ring, x_delta,
                      f_delta, f1, f0, grad_norm, xmax);

  if (tid == 0) {
    a.value[lane] = f1;
    a.nfev[lane] = nfev0 + ls_nfev;
    a.count[lane] = x_delta <= T(0) ? 0 : count;  // stall reset
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
}

template <typename T> int launch(const Args<T> &a, int b, cudaStream_t stream) {
  if (b <= 0) return 0;
  epilogue_kernel<T><<<b, block_threads(a.n), 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

#define CPPNS_EPILOGUE(NAME, T)                                              \
  extern "C" int NAME(                                                      \
      void *x, void *value, void *g, void *nfev, const void *x_ls,          \
      const void *f_ls, const void *g_ls, const void *ls_nfev, void *count, \
      void *s_pend, void *y_pend, void *pvalid, const void *done,           \
      void *num_it, void *x_delta, void *x_viol, void *f_delta,             \
      void *f_viol, void *gnorm, void *status, void *ring, void *past_pos,  \
      int b, int n, double c_x_delta, double c_f_delta,                     \
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
              (int *)past_pos, n, crit};                                    \
    return launch<T>(a, b, (cudaStream_t)stream);                           \
  }

CPPNS_EPILOGUE(cppns_lbfgs_epilogue_f32, float)
CPPNS_EPILOGUE(cppns_lbfgs_epilogue_f64, double)
