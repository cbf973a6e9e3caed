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
// Layout.  The history is (m * n, B): element j of row r of lane i at
// [(r * n + j) * B + i].  The iteration vectors (x, g, the pending pair, the
// direction) are (B, n) and are read and written where they are.
//
// Design.  A block serves LB neighbouring lanes with TY threads each
// (blockDim.x = LB * TY; thread t has lane t % LB and slice t / LB), and the
// threads of a lane split its n elements: slice ty owns j = ty, ty + TY, ...
// of every vector and history row.  Neighbouring threads are neighbouring
// lanes, so a warp's history loads are one run of LB contiguous values per
// element: coalesced at any n.  A dot product is a serial sum in each thread
// and then a fixed-order pairwise sum of the TY partial sums of the lane
// through shared memory, so every thread of a lane holds the same bits and computes
// the lane's scalar logic redundantly; slice 0 writes the scalars.  Lanes of
// one block differ in count and in being done, and barriers are block-wide,
// so the row loops run to the block's largest count with per-lane masks; a
// masked thread skips its loads.  A thread owns the same (lane, j) in q, in
// every row and in the direction, so q needs no barrier: it lives in shared
// memory, or, where n * LB values do not fit, in a (n, B) scratch tensor
// that the wrapper passes.  The history, its count and gamma are updated in
// place.  A done lane touches none of them and emits the zero direction with
// dginit = 0; lanes past B in the last block are inert.
//
// What bounds it on an H100: device-memory bytes, as lbfgs_prologue.cu.
//
// Numerics and build flags: see common.cuh (--fmad=false; ops/_build.py).
// The sums run in another order than the batch-major kernel's and the plain
// version's, so the outputs agree with theirs to rounding.

#include "common.cuh"

namespace {

using namespace cppns;

constexpr int SUMS = 5;  // values the widest in-block reduction carries

template <typename T> struct Args {
  const T *x, *g, *s_new, *y_new;
  const unsigned char *valid, *done;
  T *s, *y;
  int *count;
  T *gamma, *ls_dir, *alpha, *dginit, *q_scratch;
  int b, n, m, lb, ty;
};

constexpr int MAX_SLICES = 32;  // TY never exceeds it (LB >= 8, 256 threads)

// Sum v[k] over the TY threads of a lane; every thread of the lane gets the
// same result.  Each thread adds the lane's TY partial sums (padded with
// zeros to 32) pairwise, in the order of a warp's xor butterfly: t with
// t + 16, then t with t + 8, ...  A pairwise sum keeps the rounding error of
// a long dot product near that of the other kernels' reductions; a serial
// sum of the partials was up to 9e-5 of the direction's largest entry from
// the plain version in float32.  red holds K * TY * LB values.
template <typename T, int K>
__device__ void lane_sum(T (&v)[K], T *red, int ll, int ty, int LB, int TY) {
#pragma unroll
  for (int k = 0; k < K; ++k) red[(k * TY + ty) * LB + ll] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    T p[MAX_SLICES];
#pragma unroll
    for (int t = 0; t < MAX_SLICES; ++t)
      p[t] = t < TY ? red[(k * TY + t) * LB + ll] : T(0);
#pragma unroll
    for (int s = MAX_SLICES / 2; s > 0; s >>= 1)
#pragma unroll
      for (int t = 0; t < s; ++t) p[t] += p[t + s];
    v[k] = p[0];
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) prologue_t_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, m = a.m, LB = a.lb, TY = a.ty;
  T *red = reinterpret_cast<T *>(smem_raw);
  T *alphas = red + SUMS * TY * LB;
  T *rhos = alphas + m * LB;
  T *q_smem = rhos + m * LB;
  const bool q_shared = a.q_scratch == nullptr;
  int *usables =
      reinterpret_cast<int *>(q_smem + (q_shared ? (size_t)n * LB : 0));
  int *counts = usables + m * LB;

  const int ll = threadIdx.x % LB, ty = threadIdx.x / LB;
  const size_t lane = (size_t)blockIdx.x * LB + ll;
  const size_t B = (size_t)a.b;
  const bool in_batch = lane < B;
  const bool live = in_batch && a.done[lane] == 0;
  const T eps = Eps<T>::v;

  // q[j] of this thread's lane is qv[j * qs]; history element (r, j) is
  // hs[(r * n + j) * B].
  T *qv = q_shared ? q_smem + ll : a.q_scratch + lane;
  const size_t qs = q_shared ? (size_t)LB : B;
  T *hs = a.s + lane, *hy = a.y + lane;
  const T *x = a.x + lane * n, *g = a.g + lane * n;
  const T *s_new = a.s_new + lane * n, *y_new = a.y_new + lane * n;
  T *ls_dir = a.ls_dir + lane * n;

  const int count = live ? a.count[lane] : 0;
  const T gamma = live ? a.gamma[lane] : T(1);
  const bool valid = live && a.valid[lane] != 0;

  T sm[5] = {T(0), T(0), T(0), T(0), T(0)};  // s.y, s.s, y.y, x.x, g.g
  if (live)
    for (int j = ty; j < n; j += TY) {
      const T sv = s_new[j], yv = y_new[j], xv = x[j], gv = g[j];
      sm[0] += sv * yv;
      sm[1] += sv * sv;
      sm[2] += yv * yv;
      sm[3] += xv * xv;
      sm[4] += gv * gv;
    }
  // The barriers inside also order every thread's reads of count and gamma
  // above before slice 0's writes at the end.
  lane_sum<T, 5>(sm, red, ll, ty, LB, TY);

  const Push<T> p = push_gate(valid, sm[0], sm[1], sm[2], count, m, gamma);
  const int new_count = live ? p.new_count : 0;
  if (live)
    for (int j = ty; j < n; j += TY) {
      if (p.accept) {
        if (p.full)
          for (int r = 0; r < m - 1; ++r) {
            hs[((size_t)r * n + j) * B] = hs[((size_t)(r + 1) * n + j) * B];
            hy[((size_t)r * n + j) * B] = hy[((size_t)(r + 1) * n + j) * B];
          }
        hs[((size_t)p.slot * n + j) * B] = s_new[j];
        hy[((size_t)p.slot * n + j) * B] = y_new[j];
      }
      qv[j * qs] = g[j];
    }

  // The block's row loops run to its largest count.
  if (ty == 0) counts[ll] = new_count;
  __syncthreads();
  int rows = 0;
  for (int l = 0; l < LB; ++l) rows = counts[l] > rows ? counts[l] : rows;

  for (int r = rows - 1; r >= 0; --r) {
    const bool active = r < new_count;
    const T *s_r = hs + (size_t)r * n * B, *y_r = hy + (size_t)r * n * B;
    T d[2] = {T(0), T(0)};
    if (active)
      for (int j = ty; j < n; j += TY) {
        const T sv = s_r[j * B];
        d[0] += sv * y_r[j * B];
        d[1] += sv * qv[j * qs];
      }
    lane_sum<T, 2>(d, red, ll, ty, LB, TY);
    const bool usable = active && fabs(d[0]) >= eps;
    const T rho = usable ? T(1) / d[0] : T(0);
    const T alpha = rho * d[1];
    if (usable)
      for (int j = ty; j < n; j += TY)
        qv[j * qs] = qv[j * qs] - alpha * y_r[j * B];
    if (ty == 0) {
      alphas[r * LB + ll] = alpha;
      rhos[r * LB + ll] = rho;
      usables[r * LB + ll] = usable ? 1 : 0;
    }
  }
  if (live)
    for (int j = ty; j < n; j += TY) qv[j * qs] = qv[j * qs] * p.new_gamma;
  __syncthreads();  // alphas/rhos/usables from slice 0
  for (int r = 0; r < rows; ++r) {
    const bool usable = usables[r * LB + ll] != 0;
    const T *s_r = hs + (size_t)r * n * B, *y_r = hy + (size_t)r * n * B;
    T d[1] = {T(0)};
    if (usable)
      for (int j = ty; j < n; j += TY) d[0] += y_r[j * B] * qv[j * qs];
    lane_sum<T, 1>(d, red, ll, ty, LB, TY);
    if (usable) {
      const T beta = rhos[r * LB + ll] * d[0];
      const T coef = alphas[r * LB + ll] - beta;
      for (int j = ty; j < n; j += TY)
        qv[j * qs] = qv[j * qs] + s_r[j * B] * coef;
    }
  }

  T dq[2] = {T(0), T(0)};  // g.q, q.q
  if (live)
    for (int j = ty; j < n; j += TY) {
      const T qj = qv[j * qs];
      dq[0] += g[j] * qj;
      dq[1] += qj * qj;
    }
  lane_sum<T, 2>(dq, red, ll, ty, LB, TY);
  if (!in_batch) return;
  if (!live) {
    for (int j = ty; j < n; j += TY) ls_dir[j] = T(0);
    if (ty == 0) {
      a.alpha[lane] = T(1);
      a.dginit[lane] = T(0);
    }
    return;
  }
  const Descent<T> ds = descent_check(dq[0], dq[1], sm[4], sm[3], new_count);
  for (int j = ty; j < n; j += TY)
    ls_dir[j] = -(ds.invalid ? g[j] : qv[j * qs]);
  if (ty == 0) {
    a.alpha[lane] = ds.alpha0;
    a.dginit[lane] = ds.dginit;
    a.count[lane] = ds.invalid ? 0 : new_count;
    a.gamma[lane] = p.new_gamma;
  }
}

template <typename T>
int launch(Args<T> a, cudaStream_t stream) {
  if (a.b <= 0) return 0;
  if (a.lb <= 0 || a.ty <= 0 || a.ty > MAX_SLICES ||
      a.lb * a.ty > MAX_THREADS)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem =
      ((size_t)(SUMS * a.ty + 2 * a.m) * a.lb +
       (a.q_scratch == nullptr ? (size_t)a.n * a.lb : 0)) * sizeof(T) +
      (size_t)(a.m + 1) * a.lb * sizeof(int);
  if (int err = allow_smem(prologue_t_kernel<T>, smem)) return err;
  const int blocks = (a.b + a.lb - 1) / a.lb;
  prologue_t_kernel<T><<<blocks, a.lb * a.ty, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

#define CPPNS_PROLOGUE_T(NAME, T)                                            \
  extern "C" int NAME(const void *x, const void *g, const void *s_new,      \
                      const void *y_new, const void *valid,                 \
                      const void *done, void *s, void *y, void *count,      \
                      void *gamma, void *ls_dir, void *alpha, void *dginit, \
                      void *q_scratch, int b, int n, int m, int lb, int ty, \
                      void *stream) {                                       \
    Args<T> a{(const T *)x, (const T *)g, (const T *)s_new,                 \
              (const T *)y_new, (const unsigned char *)valid,               \
              (const unsigned char *)done, (T *)s, (T *)y, (int *)count,    \
              (T *)gamma, (T *)ls_dir, (T *)alpha, (T *)dginit,             \
              (T *)q_scratch, b, n, m, lb, ty};                             \
    return launch<T>(a, (cudaStream_t)stream);                              \
  }

CPPNS_PROLOGUE_T(cppns_lbfgs_prologue_t_f32, float)
CPPNS_PROLOGUE_T(cppns_lbfgs_prologue_t_f64, double)
