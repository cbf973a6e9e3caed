// The first half of one batched L-BFGS iteration, for Hopper.
//
// Replaces cppnumericalsolvers_tpu/ops/fused_step.py::_prologue_kernel (the
// Pallas TPU kernel).  It computes what the plain PyTorch version
// cppnumericalsolvers_tpu_torch/ops/fused_step.py::lbfgs_prologue_reference
// computes: the curvature-gated push of the pending correction pair with the
// gamma update, the two-loop recursion on the updated history, the
// invalid-descent fallback to steepest descent with a history reset, and the
// line search's set-up (alpha_init, dginit).  It writes the search direction.
//
// Design.  One thread block per lane, as common.cuh sets out.  The history,
// its count and gamma are updated in place.  A done lane's block touches none
// of them and emits the zero direction with dginit = 0, on which the search
// aborts before its first evaluation by its own non-descent rule.  The
// two-loop's q and the per-row alpha/rho live in shared memory; the wrapper
// checks that they fit.
//
// What bounds it on an H100: device-memory bytes.  A live lane reads x, g and
// the pending pair, reads the history rows in use (the two passes of the
// recursion; each row counted once), rewrites the history when the pair is
// accepted (one row, or all m rows when a full history shifts) and writes
// the direction.  A block reads only the rows below its lane's count, where
// the TPU kernel ran all m rows masked.
//
// Numerics and build flags: see common.cuh (--fmad=false; ops/_build.py).

#include "common.cuh"

namespace {

using namespace cppns;

template <typename T> struct Args {
  const T *x, *g, *s_new, *y_new;
  const unsigned char *valid, *done;
  T *s, *y;
  int *count;
  T *gamma, *ls_dir, *alpha, *dginit;
  int n, m;
};

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) prologue_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T *red = reinterpret_cast<T *>(smem_raw);
  T *alphas = red + RED_SLOTS * MAX_WARPS;
  T *rhos = alphas + a.m;
  T *q = rhos + a.m;
  int *usables = reinterpret_cast<int *>(q + a.n);

  const int n = a.n, m = a.m;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t lane = blockIdx.x;
  T *ls_dir = a.ls_dir + lane * n;

  if (a.done[lane]) {
    for (int j = tid; j < n; j += nt) ls_dir[j] = T(0);
    if (tid == 0) {
      a.alpha[lane] = T(1);
      a.dginit[lane] = T(0);
    }
    return;
  }

  const T *x = a.x + lane * n;
  const T *g = a.g + lane * n;
  const T *s_new = a.s_new + lane * n;
  const T *y_new = a.y_new + lane * n;
  T *hs = a.s + lane * m * n;
  T *hy = a.y + lane * m * n;
  const int count = a.count[lane];
  const T gamma = a.gamma[lane];
  const bool valid = a.valid[lane] != 0;

  T sm[5] = {T(0), T(0), T(0), T(0), T(0)};  // s.y, s.s, y.y, x.x, g.g
  for (int j = tid; j < n; j += nt) {
    const T sv = s_new[j], yv = y_new[j], xv = x[j], gv = g[j];
    sm[0] += sv * yv;
    sm[1] += sv * sv;
    sm[2] += yv * yv;
    sm[3] += xv * xv;
    sm[4] += gv * gv;
  }
  // The barriers inside also order every thread's reads of count and gamma
  // above before thread 0's writes below.
  block_sum<T, 5>(sm, red);

  const Push<T> p = push_gate(valid, sm[0], sm[1], sm[2], count, m, gamma);
  for (int j = tid; j < n; j += nt) {
    push_element(p, hs, hy, m, n, j, s_new[j], y_new[j]);
    q[j] = g[j];
  }

  two_loop(hs, hy, q, p.new_count, p.new_gamma, n, alphas, rhos, usables,
           red);

  T dq[2] = {T(0), T(0)};  // g.q, q.q
  for (int j = tid; j < n; j += nt) {
    const T qj = q[j];
    dq[0] += g[j] * qj;
    dq[1] += qj * qj;
  }
  block_sum<T, 2>(dq, red);
  const Descent<T> ds =
      descent_check(dq[0], dq[1], sm[4], sm[3], p.new_count);

  for (int j = tid; j < n; j += nt) ls_dir[j] = -(ds.invalid ? g[j] : q[j]);
  if (tid == 0) {
    a.alpha[lane] = ds.alpha0;
    a.dginit[lane] = ds.dginit;
    a.count[lane] = ds.invalid ? 0 : p.new_count;
    a.gamma[lane] = p.new_gamma;
  }
}

template <typename T>
int launch(const T *x, const T *g, const T *s_new, const T *y_new,
           const unsigned char *valid, const unsigned char *done, T *s, T *y,
           int *count, T *gamma, T *ls_dir, T *alpha, T *dginit, int b, int n,
           int m, cudaStream_t stream) {
  if (b <= 0) return 0;
  const size_t smem = two_loop_smem<T>(m, n);
  if (int err = allow_smem(prologue_kernel<T>, smem)) return err;
  Args<T> a{x, g, s_new, y_new, valid, done, s, y, count, gamma, ls_dir,
            alpha, dginit, n, m};
  prologue_kernel<T><<<b, block_threads(n), smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

#define CPPNS_PROLOGUE(NAME, T)                                              \
  extern "C" int NAME(const void *x, const void *g, const void *s_new,      \
                      const void *y_new, const void *valid,                 \
                      const void *done, void *s, void *y, void *count,      \
                      void *gamma, void *ls_dir, void *alpha, void *dginit, \
                      int b, int n, int m, void *stream) {                  \
    return launch<T>((const T *)x, (const T *)g, (const T *)s_new,          \
                     (const T *)y_new, (const unsigned char *)valid,        \
                     (const unsigned char *)done, (T *)s, (T *)y,           \
                     (int *)count, (T *)gamma, (T *)ls_dir, (T *)alpha,     \
                     (T *)dginit, b, n, m, (cudaStream_t)stream);           \
  }

CPPNS_PROLOGUE(cppns_lbfgs_prologue_f32, float)
CPPNS_PROLOGUE(cppns_lbfgs_prologue_f64, double)
