// The bare L-BFGS two-loop recursion H*g for every lane of a batch, for
// Hopper.
//
// Replaces cppnumericalsolvers_tpu/ops/two_loop.py::_two_loop_kernel (the
// Pallas TPU kernel).  It computes what the plain PyTorch version
// cppnumericalsolvers_tpu_torch/ops/two_loop.py::two_loop_direction_reference
// computes: the backward and forward pass over the history rows below the
// lane's count, a row with |s.y| < eps skipped, the centre scaled by gamma.
// The history is read only.
//
// Design.  One thread block per lane, as common.cuh sets out; q and the
// per-row alpha/rho live in shared memory, and the wrapper checks that they
// fit.  A block reads only the rows below its lane's count, where the TPU
// kernel ran all m rows masked.
//
// What bounds it on an H100: device-memory bytes.  A lane reads g and the
// rows in use (both passes read them; each row counted once) and writes the
// direction.
//
// Numerics and build flags: see common.cuh (--fmad=false; ops/_build.py).

#include "common.cuh"

namespace {

using namespace cppns;

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
two_loop_kernel(const T *g_all, const T *s_all, const T *y_all,
                const int *count_all, const T *gamma_all, T *out_all, int n,
                int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T *red = reinterpret_cast<T *>(smem_raw);
  T *alphas = red + RED_SLOTS * MAX_WARPS;
  T *rhos = alphas + m;
  T *q = rhos + m;
  int *usables = reinterpret_cast<int *>(q + n);

  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t lane = blockIdx.x;
  const T *g = g_all + lane * n;
  const T *hs = s_all + lane * m * n;
  const T *hy = y_all + lane * m * n;
  T *out = out_all + lane * n;
  int count = count_all[lane];
  count = count < 0 ? 0 : (count > m ? m : count);

  for (int j = tid; j < n; j += nt) q[j] = g[j];
  two_loop(hs, hy, q, count, gamma_all[lane], n, alphas, rhos, usables, red);
  for (int j = tid; j < n; j += nt) out[j] = q[j];
}

template <typename T>
int launch(const T *g, const T *s, const T *y, const int *count,
           const T *gamma, T *out, int b, int n, int m, cudaStream_t stream) {
  if (b <= 0) return 0;
  const size_t smem = two_loop_smem<T>(m, n);
  if (int err = allow_smem(two_loop_kernel<T>, smem)) return err;
  two_loop_kernel<T><<<b, block_threads(n), smem, stream>>>(g, s, y, count,
                                                            gamma, out, n, m);
  return (int)cudaGetLastError();
}

}  // namespace

#define CPPNS_TWO_LOOP(NAME, T)                                              \
  extern "C" int NAME(const void *g, const void *s, const void *y,          \
                      const void *count, const void *gamma, void *out,      \
                      int b, int n, int m, void *stream) {                  \
    return launch<T>((const T *)g, (const T *)s, (const T *)y,              \
                     (const int *)count, (const T *)gamma, (T *)out, b, n,  \
                     m, (cudaStream_t)stream);                              \
  }

CPPNS_TWO_LOOP(cppns_two_loop_f32, float)
CPPNS_TWO_LOOP(cppns_two_loop_f64, double)
