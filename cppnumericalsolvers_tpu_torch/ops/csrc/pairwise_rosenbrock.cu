// The batched value and gradient of MGH problem 21, the pairwise extended
// Rosenbrock, for Hopper.
//
// Replaces no Pallas kernel.  The JAX package evaluates this objective
// (models/unconstrained.py::pairwise_rosenbrock) as XLA's fusion of
// jax.vmap(jax.value_and_grad(fn)), a pass or two over the batch; the
// port's generic path, torch.func.vmap(grad_and_value(fn)), runs one eager
// kernel per operation of the forward and backward passes instead.  This
// kernel is the closed form that the port's function carries
// (cppnumericalsolvers_tpu_torch/models/unconstrained.py::PairwiseRosenbrock)
// and computes what its plain PyTorch version
// cppnumericalsolvers_tpu_torch/ops/objectives.py::
// pairwise_rosenbrock_value_and_grad_reference computes, for a (B, n) batch:
//
//   per pair i: e = x[2i], o = x[2i+1], r = o - e*e, t = 1 - e,
//   f = sum_i 100 (r*r) + t*t,
//   g[2i+1] = 100 (2 r),  g[2i] = (-g[2i+1]) (2 e) + (-(2 t)),
//
// each gradient entry then plus 0 (the slice backward scatters into zeros,
// which turns -0 into +0).  That is the order in which autograd rounds the
// gradient (ATen's pow_backward: grad * (2 * self); sub's and rsub's
// backwards negate; the two uses of e add), so with --fmad=false
// (ops/_build.py) the gradient has the bits of the vmap path's.
//
// What bounds it on an H100: device-memory bytes.  x is read once and g and
// f written once, (2 B n + B) itemsize bytes: 1.074 GB at (32768, 4096) and
// 1.091 GB at (4194304, 32) in float32, 0.321 and 0.326 ms at 3.35 TB/s.
// Its 13 operations a pair are 0.013 ms at 67 TFLOP/s.  So the design moves
// each byte once and keeps every intermediate in registers.
//
// Design.  A unit is 16 bytes of a row where n and the dtype allow: two
// pairs in a float4 (float32, n a multiple of 4) or one in a double2; a
// float2 of one pair otherwise (float32, n = 2 mod 4).  Loads and stores
// move whole units, so a warp moves 512 contiguous bytes at a time.  The
// wrapper (ops/objectives.py) picks the threads of a lane from n alone, a
// power of two at least the row's units, at most 256:
//   * small n (a row of at most 32 units): a group of that many threads a
//     lane, 256 / group lanes a block, sums by warp shuffles alone; at
//     n = 32 in float32, 8 threads a lane and 32 lanes a block;
//   * larger n: one block of 64 to 256 threads a lane, each thread striding
//     over the row by the block's width with four units' loads in flight;
//     shuffles in each warp, then the warps' sums through shared memory.
// Sum order: each thread adds its pairs' terms in order of its units (and
// within a unit in order of i), then the lane's threads by xor butterfly
// (commutative pairs, so every thread gets the same bits), then in a block
// the warps' sums by a second butterfly.  The order is fixed by n alone,
// so a lane's value has the same bits in a batch of any size; it is not
// torch.sum's, so on the card the value agrees with the vmap path to a few
// ulps of the sum, not bit for bit.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;       // a block of lanes that share a warp
constexpr int MAX_WARPS = THREADS / 32;
constexpr int UNROLL = 4;          // units a thread has in flight

// One pair: the value term and the two gradient entries.
template <typename T> struct Pair {
  T term, ge, go;
};

template <typename T> __device__ __forceinline__ Pair<T> pair(T e, T o) {
  const T r = o - e * e;
  const T t = T(1) - e;
  Pair<T> p;
  p.term = T(100) * (r * r) + t * t;
  const T go = T(100) * (T(2) * r);
  p.ge = (-go) * (T(2) * e) + (-(T(2) * t)) + T(0);
  p.go = go + T(0);
  return p;
}

// One unit of x: adds its pairs' terms to acc in order, returns its g.
__device__ __forceinline__ float4 unit(float4 u, float &acc) {
  const Pair<float> a = pair(u.x, u.y), b = pair(u.z, u.w);
  acc = acc + a.term;
  acc = acc + b.term;
  return make_float4(a.ge, a.go, b.ge, b.go);
}
__device__ __forceinline__ float2 unit(float2 u, float &acc) {
  const Pair<float> a = pair(u.x, u.y);
  acc = acc + a.term;
  return make_float2(a.ge, a.go);
}
__device__ __forceinline__ double2 unit(double2 u, double &acc) {
  const Pair<double> a = pair(u.x, u.y);
  acc = acc + a.term;
  return make_double2(a.ge, a.go);
}

// ``tpl`` threads a lane (a power of two, 1 to 256): up to 32 share a warp
// and the block of THREADS threads holds THREADS / tpl lanes; more make the
// whole block (of tpl threads) one lane.
template <typename T, typename U>
__global__ void __launch_bounds__(THREADS)
    pairwise_rosenbrock_kernel(const U *__restrict__ x, U *__restrict__ g,
                               T *__restrict__ f, int b, int units, int tpl) {
  __shared__ T warp_sums[MAX_WARPS];
  const int t = threadIdx.x & (tpl - 1);
  const long long lane =
      tpl > 32 ? (long long)blockIdx.x
               : (long long)blockIdx.x * (THREADS / tpl) + threadIdx.x / tpl;
  T acc = T(0);
  if (lane < b) {
    const U *xl = x + lane * units;
    U *gl = g + lane * units;
    for (int c0 = t; c0 < units; c0 += UNROLL * tpl) {
      U u[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int c = c0 + k * tpl;
        if (c < units) u[k] = __ldg(xl + c);
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int c = c0 + k * tpl;
        if (c < units) gl[c] = unit(u[k], acc);
      }
    }
  }
  // Every thread of the block reaches the shuffles (a ragged last block's
  // spare lanes carry 0 and write nothing).
  const int width = tpl < 32 ? tpl : 32;
  for (int off = 1; off < width; off <<= 1)
    acc = acc + __shfl_xor_sync(0xffffffffu, acc, off);
  if (tpl > 32) {
    const int warps = tpl / 32, w = threadIdx.x / 32, l = threadIdx.x & 31;
    if (l == 0) warp_sums[w] = acc;
    __syncthreads();
    if (w != 0) return;
    acc = l < warps ? warp_sums[l] : T(0);
    // Offsets below ``warps`` keep lanes 0 .. warps-1 among themselves.
    for (int off = 1; off < warps; off <<= 1)
      acc = acc + __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (t == 0 && lane < b) f[lane] = acc;
}

template <typename T, typename U>
int launch(const void *x, void *g, void *f, int b, int n, int tpl,
           cudaStream_t stream) {
  const int units = n / (int)(sizeof(U) / sizeof(T));
  if (tpl < 1 || tpl > THREADS || (tpl & (tpl - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (b <= 0 || units <= 0) return 0;
  const int lanes = tpl > 32 ? 1 : THREADS / tpl;
  const long long blocks = ((long long)b + lanes - 1) / lanes;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  pairwise_rosenbrock_kernel<T, U>
      <<<(unsigned)blocks, tpl > 32 ? tpl : THREADS, 0, stream>>>(
          (const U *)x, (U *)g, (T *)f, b, units, tpl);
  return (int)cudaGetLastError();
}

}  // namespace

// ``pairs_per_unit`` is 2 (float4 units; float32 with n a multiple of 4) or
// 1 (float2 in float32, double2 in float64); x and g are 16-byte aligned
// where it is 2, and n is even.
extern "C" int cppns_pairwise_rosenbrock_f32(const void *x, void *g, void *f,
                                             int b, int n, int pairs_per_unit,
                                             int tpl, void *stream) {
  if (n % 2 != 0 || (pairs_per_unit == 2 && n % 4 != 0))
    return (int)cudaErrorInvalidValue;
  if (pairs_per_unit == 2)
    return launch<float, float4>(x, g, f, b, n, tpl, (cudaStream_t)stream);
  if (pairs_per_unit == 1)
    return launch<float, float2>(x, g, f, b, n, tpl, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int cppns_pairwise_rosenbrock_f64(const void *x, void *g, void *f,
                                             int b, int n, int pairs_per_unit,
                                             int tpl, void *stream) {
  if (n % 2 != 0 || pairs_per_unit != 1) return (int)cudaErrorInvalidValue;
  return launch<double, double2>(x, g, f, b, n, tpl, (cudaStream_t)stream);
}
