// The L-BFGS direction step for every lane of a batch, for Hopper: the
// curvature-gated push of a candidate pair, the gamma update, and the
// two-loop recursion on the updated history.
//
// Replaces cppnumericalsolvers_tpu/ops/two_loop.py::_push_two_loop_kernel
// (the Pallas TPU kernel; its body is _push_two_loop_core).  It computes what
// the plain PyTorch version
// cppnumericalsolvers_tpu_torch/ops/two_loop.py::lbfgs_push_and_direction_reference
// computes.  There is no descent check and no done flag here: the caller
// gates ``valid``.
//
// Design.  One thread block per lane, as common.cuh sets out.  The history,
// its count and gamma are updated in place; a lane whose pair is not
// accepted writes none of the history, and a lane with valid = 0 writes back
// the count and gamma it read, so every bit of them stays.  q and the per-row
// alpha/rho live in shared memory; the wrapper checks that they fit.
//
// What bounds it on an H100: device-memory bytes.  A lane reads g and the
// pair, reads the history rows in use (each row counted once), rewrites the
// history when the pair is accepted (one row, or all m rows when a full
// history shifts) and writes the direction.
//
// Numerics and build flags: see common.cuh (--fmad=false; ops/_build.py).

#include "common.cuh"

namespace {

using namespace cppns;

template <typename T> struct Args {
  const T *g, *s_new, *y_new;
  const unsigned char *valid;
  T *s, *y;
  int *count;
  T *gamma, *d;
  int n, m;
};

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) push_two_loop_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T *red = reinterpret_cast<T *>(smem_raw);
  T *alphas = red + RED_SLOTS * MAX_WARPS;
  T *rhos = alphas + a.m;
  T *q = rhos + a.m;
  int *usables = reinterpret_cast<int *>(q + a.n);

  const int n = a.n, m = a.m;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t lane = blockIdx.x;
  const T *g = a.g + lane * n;
  const T *s_new = a.s_new + lane * n;
  const T *y_new = a.y_new + lane * n;
  T *hs = a.s + lane * m * n;
  T *hy = a.y + lane * m * n;
  T *d = a.d + lane * n;
  const int count = a.count[lane];
  const T gamma = a.gamma[lane];
  const bool valid = a.valid[lane] != 0;

  T sm[3] = {T(0), T(0), T(0)};  // s.y, s.s, y.y
  for (int j = tid; j < n; j += nt) {
    const T sv = s_new[j], yv = y_new[j];
    sm[0] += sv * yv;
    sm[1] += sv * sv;
    sm[2] += yv * yv;
  }
  // The barriers inside also order every thread's reads of count and gamma
  // above before thread 0's writes below.
  block_sum<T, 3>(sm, red);

  const Push<T> p = push_gate(valid, sm[0], sm[1], sm[2], count, m, gamma);
  for (int j = tid; j < n; j += nt) {
    push_element(p, hs, hy, m, n, j, s_new[j], y_new[j]);
    q[j] = g[j];
  }

  two_loop(hs, hy, q, p.new_count, p.new_gamma, n, alphas, rhos, usables,
           red);

  for (int j = tid; j < n; j += nt) d[j] = q[j];
  if (tid == 0) {
    a.count[lane] = p.new_count;
    a.gamma[lane] = p.new_gamma;
  }
}

template <typename T>
int launch(const T *g, const T *s_new, const T *y_new,
           const unsigned char *valid, T *s, T *y, int *count, T *gamma, T *d,
           int b, int n, int m, cudaStream_t stream) {
  if (b <= 0) return 0;
  const size_t smem = two_loop_smem<T>(m, n);
  if (int err = allow_smem(push_two_loop_kernel<T>, smem)) return err;
  Args<T> a{g, s_new, y_new, valid, s, y, count, gamma, d, n, m};
  push_two_loop_kernel<T><<<b, block_threads(n), smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

#define CPPNS_PUSH_TWO_LOOP(NAME, T)                                         \
  extern "C" int NAME(const void *g, const void *s_new, const void *y_new,  \
                      const void *valid, void *s, void *y, void *count,     \
                      void *gamma, void *d, int b, int n, int m,            \
                      void *stream) {                                       \
    return launch<T>((const T *)g, (const T *)s_new, (const T *)y_new,      \
                     (const unsigned char *)valid, (T *)s, (T *)y,          \
                     (int *)count, (T *)gamma, (T *)d, b, n, m,             \
                     (cudaStream_t)stream);                                 \
  }

CPPNS_PUSH_TWO_LOOP(cppns_push_two_loop_f32, float)
CPPNS_PUSH_TWO_LOOP(cppns_push_two_loop_f64, double)
