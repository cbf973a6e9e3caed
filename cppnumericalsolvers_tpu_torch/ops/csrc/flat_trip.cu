// One trip of the flat batched L-BFGS / More-Thuente solve, for Hopper.
//
// Replaces cppnumericalsolvers_tpu/ops/flat_solve.py::_flat_kernel (the
// Pallas TPU kernel).  It computes what the plain PyTorch version
// cppnumericalsolvers_tpu_torch/ops/flat_solve.py::flat_trip_reference
// computes: one More-Thuente trip per lane after an objective evaluation
// and, for lanes whose search ended, the iteration boundary (accept/finite
// guard, s/y, the Progress::Update ladder, the curvature-gated history push
// with gamma, the two-loop recursion, the descent fallback and the next
// search's trial 0), and it writes the next trial point.
//
// Design.  One thread block per lane (grid = B); threads stride over n, so
// each thread owns the same elements j in every vector and history row.
// Dot products and max-abs reductions are warp shuffles plus shared memory,
// summed across warps in a fixed order, so every thread gets the same bits.
// Every thread computes the per-lane scalar logic (the termination ladder,
// cstep, the trial setup, the Progress ladder) redundantly from identical
// inputs; thread 0 alone writes the scalar rows.  The two-loop's q and the
// per-row alpha/rho live in shared memory; the wrapper checks that they fit.
//
// What bounds it on an H100: device-memory bytes.  A lane mid-search reads
// g_t, sdir, x0 and writes gacc, x_trial: about 5*n*itemsize per trip.  A
// lane at the boundary also reads its history (two passes over the rows in
// use, 2*count*n*itemsize each) and, when it accepts a pair, rewrites it
// (shift of the chronological layout, up to 2*m*n*itemsize read and
// written).  The design does about it what a GPU allows and the TPU did
// not: the TPU kernel ran the boundary work masked on every trip for every
// lane; here each block branches on its own lane, so a lane mid-search never
// touches s/y, a dead lane only writes its trial point, and the two-loop
// reads only the rows below the history count.
//
// Numerics.  The kernel must agree with the plain version, which follows
// JAX's semantics: literals are rounded to T before use (T(0.66) * x, as
// JAX keeps a Python literal in the array's dtype); sign(0) = 0 and
// sign(NaN) = NaN; max/min propagate NaN (explicit compare-and-select, not
// fmax/fmin); every select is a ternary, never a multiply by a mask.  Build
// with --fmad=false: FMA contraction would change rounding against the
// plain version.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
//        --fmad=false -shared -Xcompiler -fPIC  (ops/_build.py does this).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

// Packed scalar rows (ops/flat_solve.py).
constexpr int F_F0 = 0, F_DGINIT = 1, F_DGTEST = 2, F_FACC = 3, F_STP = 4,
              F_STMIN = 5, F_STMAX = 6, F_STX = 7, F_FX = 8, F_DGX = 9,
              F_STY = 10, F_FY = 11, F_DGY = 12, F_WIDTH = 13, F_WIDTH1 = 14,
              F_GAMMA = 15, F_XDELTA = 16, F_FDELTA = 17, F_GNORM = 18,
              NF = 19;
constexpr int I_COUNT = 0, I_NFEV = 1, I_NUMIT = 2, I_XVIOL = 3, I_FVIOL = 4,
              I_STATUS = 5, I_PASTPOS = 6, I_BRACKT = 7, I_STAGE1 = 8,
              I_LSNFEV = 9, I_INFO = 10, I_INFOC = 11, NI = 12;
constexpr int RING = 8;

// MINPACK constants (more_thuente.h:142-148).
constexpr double XTOL = 1e-15, FTOL = 1e-4, GTOL = 0.9, STPMIN = 1e-15,
                 STPMAX = 1e15, XTRAPF = 4.0;

constexpr int MAX_THREADS = 256;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int RED_SLOTS = 8;  // values one block reduction can carry

template <typename T> struct Eps;
template <> struct Eps<float> {
  static constexpr float v = 1.1920928955078125e-07f;
};
template <> struct Eps<double> {
  static constexpr double v = 2.220446049250313e-16;
};

template <typename T> __device__ __forceinline__ T nmax(T a, T b) {
  return isnan(a) ? a : (isnan(b) ? b : (a > b ? a : b));
}
template <typename T> __device__ __forceinline__ T nmin(T a, T b) {
  return isnan(a) ? a : (isnan(b) ? b : (a < b ? a : b));
}
template <typename T> __device__ __forceinline__ T sgn(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : x);
}

struct Crit {
  double x_delta, f_delta, past_delta, gradient_norm;
  int max_iterations, x_delta_violations, f_delta_violations, past;
  int f_delta_relative, gradient_norm_relative;
};

template <typename T> struct Args {
  T *x0, *g0, *sdir, *gacc, *s, *y, *ring, *sf;
  int *si;
  const T *f_t, *g_t;
  T *x_trial;
  int n, m, max_fev;
  Crit crit;
};

// Block-wide sums / NaN-propagating maxima of K values.  Every thread gets
// the same result: lanes by xor butterfly (commutative pairs), warps summed
// in a fixed order.
template <typename T, int K>
__device__ void block_sum(T (&v)[K], T *red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) red[k * MAX_WARPS + warp] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    T acc = red[k * MAX_WARPS];
    for (int w = 1; w < nw; ++w) acc += red[k * MAX_WARPS + w];
    v[k] = acc;
  }
  __syncthreads();
}

template <typename T, int K>
__device__ void block_max(T (&v)[K], T *red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] = nmax(v[k], __shfl_xor_sync(0xffffffffu, v[k], off));
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) red[k * MAX_WARPS + warp] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    T acc = red[k * MAX_WARPS];
    for (int w = 1; w < nw; ++w) acc = nmax(acc, red[k * MAX_WARPS + w]);
    v[k] = acc;
  }
  __syncthreads();
}

// MINPACK cstep (more_thuente.h:261-407), branch-free as in the JAX
// package: all four cases computed, then selected.
template <typename T> struct Cstep {
  T stx, fx, dx, sty, fy, dy, stp;
  bool brackt;
  int info;
};

template <typename T>
__device__ Cstep<T> cstep(T stx, T fx, T dx, T sty, T fy, T dy, T stp, T fp,
                          T dp, bool brackt, T stpmin, T stpmax) {
  const bool input_error =
      (brackt && (stp <= nmin(stx, sty) || stp >= nmax(stx, sty))) ||
      (dx * (stp - stx) >= T(0) || stpmax < stpmin);
  const T sgnd = dp * sgn(dx);

  const T d_stp_stx = stp - stx;
  const T theta = T(3) * (fx - fp) / d_stp_stx + dx + dp;
  const T s = nmax(fabs(theta), nmax(fabs(dx), fabs(dp)));
  const T gamma_sq = (theta / s) * (theta / s) - (dx / s) * (dp / s);
  const T gamma_raw = s * sqrt(gamma_sq);
  const T gamma3 = s * sqrt(nmax(T(0), gamma_sq));

  // Case 1.
  const T g1 = stp < stx ? -gamma_raw : gamma_raw;
  const T p1 = (g1 - dx) + theta;
  const T q1 = ((g1 - dx) + g1) + dp;
  const T r1 = p1 / q1;
  const T stpc1 = stx + r1 * d_stp_stx;
  const T stpq1 = stx + ((dx / ((fx - fp) / d_stp_stx + dx)) / T(2)) * d_stp_stx;
  const T stpf1 = fabs(stpc1 - stx) < fabs(stpq1 - stx)
                      ? stpc1
                      : stpc1 + (stpq1 - stpc1) / T(2);
  // Case 2.
  const T g2 = stp > stx ? -gamma_raw : gamma_raw;
  const T p2 = (g2 - dp) + theta;
  const T q2 = ((g2 - dp) + g2) + dx;
  const T r2 = p2 / q2;
  const T stpc2 = stp + r2 * (stx - stp);
  const T stpq2 = stp + (dp / (dp - dx)) * (stx - stp);
  const T stpf2 = fabs(stpc2 - stp) > fabs(stpq2 - stp) ? stpc2 : stpq2;
  // Case 3.
  const T g3 = stp > stx ? -gamma3 : gamma3;
  const T p3 = (g3 - dp) + theta;
  const T q3 = (g3 + (dx - dp)) + g3;
  const T r3 = p3 / q3;
  const T stpc3_interior = stp + r3 * (stx - stp);
  const T stpc3 = (r3 < T(0) && g3 != T(0)) ? stpc3_interior
                                             : (stp > stx ? stpmax : stpmin);
  const T stpq3 = stp + (dp / (dp - dx)) * (stx - stp);
  const T stpf3 =
      brackt ? (fabs(stp - stpc3) < fabs(stp - stpq3) ? stpc3 : stpq3)
             : (fabs(stp - stpc3) > fabs(stp - stpq3) ? stpc3 : stpq3);
  // Case 4.
  const T d_sty_stp = sty - stp;
  const T theta4 = T(3) * (fp - fy) / d_sty_stp + dy + dp;
  const T s4 = nmax(fabs(theta4), nmax(fabs(dy), fabs(dp)));
  const T gamma4_raw =
      s4 * sqrt((theta4 / s4) * (theta4 / s4) - (dy / s4) * (dp / s4));
  const T g4 = stp > sty ? -gamma4_raw : gamma4_raw;
  const T p4 = (g4 - dp) + theta4;
  const T q4 = ((g4 - dp) + g4) + dy;
  const T r4 = p4 / q4;
  const T stpc4 = stp + r4 * d_sty_stp;
  const T stpf4 = brackt ? stpc4 : (stp > stx ? stpmax : stpmin);

  const bool case1 = fp > fx;
  const bool neg = sgnd < T(0);
  const bool smaller = fabs(dp) < fabs(dx);
  const bool case2 = !case1 && neg;
  const bool case3 = !case1 && !neg && smaller;
  const int info = case1 ? 1 : (case2 ? 2 : (case3 ? 3 : 4));
  const bool bound = case1 || case3;
  const T stpf = case1 ? stpf1 : (case2 ? stpf2 : (case3 ? stpf3 : stpf4));
  const bool new_brackt = brackt || case1 || case2;

  const bool from_p = fp > fx;
  const bool from_x = !from_p && neg;
  const T new_sty = from_p ? stp : (from_x ? stx : sty);
  const T new_fy = from_p ? fp : (from_x ? fx : fy);
  const T new_dy = from_p ? dp : (from_x ? dx : dy);
  const T new_stx = from_p ? stx : stp;
  const T new_fx = from_p ? fx : fp;
  const T new_dx = from_p ? dx : dp;

  T new_stp = nmin(nmax(stpf, stpmin), stpmax);
  const T guard = new_stx + T(0.66) * (new_sty - new_stx);
  if (new_brackt && bound)
    new_stp = new_sty > new_stx ? nmin(guard, new_stp) : nmax(guard, new_stp);

  // Input error: everything stays and info is 0.
  Cstep<T> r;
  r.stx = input_error ? stx : new_stx;
  r.fx = input_error ? fx : new_fx;
  r.dx = input_error ? dx : new_dx;
  r.sty = input_error ? sty : new_sty;
  r.fy = input_error ? fy : new_fy;
  r.dy = input_error ? dy : new_dy;
  r.stp = input_error ? stp : new_stp;
  r.brackt = input_error ? brackt : new_brackt;
  r.info = input_error ? 0 : info;
  return r;
}

// Pre-evaluation trial formation (more_thuente.h:178-195).
template <typename T>
__device__ void trial_setup(T stp, T stx, T sty, bool brackt, int nfev,
                            int infoc, int max_fev, T &stp_out, T &stmin,
                            T &stmax) {
  stmin = brackt ? nmin(stx, sty) : stx;
  stmax = brackt ? nmax(stx, sty) : stp + T(XTRAPF) * (stp - stx);
  const T stp_c = nmin(nmax(stp, T(STPMIN)), T(STPMAX));
  const bool fallback = (brackt && (stp_c <= stmin || stp_c >= stmax)) ||
                        nfev >= max_fev - 1 || infoc == 0 ||
                        (brackt && (stmax - stmin) <= T(XTOL) * stmax);
  stp_out = fallback ? stx : stp_c;
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) flat_trip_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T *red = reinterpret_cast<T *>(smem_raw);
  T *alphas = red + RED_SLOTS * MAX_WARPS;
  T *rhos = alphas + a.m;
  T *q = rhos + a.m;
  int *usables = reinterpret_cast<int *>(q + a.n);

  const T eps = Eps<T>::v;
  const int n = a.n, m = a.m, max_fev = a.max_fev;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t lane = blockIdx.x;
  T *x0 = a.x0 + lane * n;
  T *g0 = a.g0 + lane * n;
  T *sdir = a.sdir + lane * n;
  T *gacc = a.gacc + lane * n;
  T *hs = a.s + lane * m * n;
  T *hy = a.y + lane * m * n;
  T *ringp = a.ring + lane * RING;
  T *sf = a.sf + lane * NF;
  int *si = a.si + lane * NI;
  const T *g_t = a.g_t + lane * n;
  T *x_trial = a.x_trial + lane * n;

  T f[NF];
  int iv[NI];
  T ring[RING];
#pragma unroll
  for (int k = 0; k < NF; ++k) f[k] = sf[k];
#pragma unroll
  for (int k = 0; k < NI; ++k) iv[k] = si[k];
#pragma unroll
  for (int k = 0; k < RING; ++k) ring[k] = ringp[k];
  // Every thread has read the scalar rows before thread 0 rewrites them.
  __syncthreads();

  const int status = iv[I_STATUS];
  if (status != 0) {
    // Dead lane: everything stays; the trial point is the iterate.
    for (int j = tid; j < n; j += nt) x_trial[j] = x0[j] + T(0) * sdir[j];
    return;
  }
  const int info_in = iv[I_INFO];
  const bool active = info_in == 0;  // mid-search

  const T f0 = f[F_F0], dginit = f[F_DGINIT], dgtest = f[F_DGTEST];
  T stp1 = f[F_STP], stmin1 = f[F_STMIN], stmax1 = f[F_STMAX];
  T stx1 = f[F_STX], fx1 = f[F_FX], dgx1 = f[F_DGX];
  T sty1 = f[F_STY], fy1 = f[F_FY], dgy1 = f[F_DGY];
  T width_1 = f[F_WIDTH], width1_1 = f[F_WIDTH1];
  int brackt1 = iv[I_BRACKT], stage1_1 = iv[I_STAGE1];
  int infoc1 = iv[I_INFOC];
  T facc1 = f[F_FACC];
  int ls_nfev1 = iv[I_LSNFEV], info1 = info_in;

  // ---------------------------------------------------------------- trip
  if (active) {
    T dgv[1] = {T(0)};
    for (int j = tid; j < n; j += nt) dgv[0] += g_t[j] * sdir[j];
    block_sum<T, 1>(dgv, red);
    const T dg = dgv[0];
    const T f_t = a.f_t[lane];
    const T stp = f[F_STP], stmin = f[F_STMIN], stmax = f[F_STMAX];
    const T stx = f[F_STX], fx = f[F_FX], dgx = f[F_DGX];
    const T sty = f[F_STY], fy = f[F_FY], dgy = f[F_DGY];
    const T width = f[F_WIDTH], width1 = f[F_WIDTH1];
    const bool brackt = iv[I_BRACKT] != 0;
    const int stage1_i = iv[I_STAGE1];
    const int infoc = iv[I_INFOC];
    const T ftest1 = f0 + stp * dgtest;
    const int nfev1 = iv[I_LSNFEV] + 1;

    int info_new =
        ((brackt && (stp <= stmin || stp >= stmax)) || infoc == 0) ? 6 : 0;
    if (stp == T(STPMAX) && f_t <= ftest1 && dg <= dgtest) info_new = 5;
    if (stp == T(STPMIN) && (f_t > ftest1 || dg >= dgtest)) info_new = 4;
    if (nfev1 >= max_fev) info_new = 3;
    if (brackt && stmax - stmin <= T(XTOL) * stmax) info_new = 2;
    if (f_t <= ftest1 && fabs(dg) <= T(GTOL) * (-dginit)) info_new = 1;
    const bool searching = info_new == 0;

    const int stage1_new =
        (stage1_i != 0 && f_t <= ftest1 && dg >= T(FTOL) * dginit) ? 0
                                                                   : stage1_i;
    const bool use_modified = stage1_new != 0 && f_t <= fx && f_t > ftest1;
    const T fm = use_modified ? f_t - stp * dgtest : f_t;
    const T fxm = use_modified ? fx - stx * dgtest : fx;
    const T fym = use_modified ? fy - sty * dgtest : fy;
    const T dgm = use_modified ? dg - dgtest : dg;
    const T dgxm = use_modified ? dgx - dgtest : dgx;
    const T dgym = use_modified ? dgy - dgtest : dgy;

    const Cstep<T> cs =
        cstep(stx, fxm, dgxm, sty, fym, dgym, stp, fm, dgm, brackt, stmin,
              stmax);
    const T fx_c = use_modified ? cs.fx + cs.stx * dgtest : cs.fx;
    const T dgx_c = use_modified ? cs.dx + dgtest : cs.dx;
    const T fy_c = use_modified ? cs.fy + cs.sty * dgtest : cs.fy;
    const T dgy_c = use_modified ? cs.dy + dgtest : cs.dy;
    const T stp_c = (cs.brackt && fabs(cs.sty - cs.stx) >= T(0.66) * width1)
                        ? cs.stx + T(0.5) * (cs.sty - cs.stx)
                        : cs.stp;
    const T width1_c = cs.brackt ? width : width1;
    const T width_c = cs.brackt ? fabs(cs.sty - cs.stx) : width;
    T stp_t, stmin_t, stmax_t;
    trial_setup(stp_c, cs.stx, cs.sty, cs.brackt, nfev1, cs.info, max_fev,
                stp_t, stmin_t, stmax_t);

    if (searching) {
      stp1 = stp_t; stmin1 = stmin_t; stmax1 = stmax_t;
      stx1 = cs.stx; fx1 = fx_c; dgx1 = dgx_c;
      sty1 = cs.sty; fy1 = fy_c; dgy1 = dgy_c;
      width_1 = width_c; width1_1 = width1_c;
      brackt1 = cs.brackt ? 1 : 0;
      stage1_1 = stage1_new;
      infoc1 = cs.info;  // the MINPACK carry
    }
    facc1 = f_t;
    ls_nfev1 = nfev1;
    info1 = info_new;
  }

  if (info1 == 0) {
    // Still searching: keep the trip's results, form the next trial.
    for (int j = tid; j < n; j += nt) {
      gacc[j] = g_t[j];
      x_trial[j] = x0[j] + stp1 * sdir[j];
    }
    if (tid == 0) {
      sf[F_FACC] = facc1;
      sf[F_STP] = stp1; sf[F_STMIN] = stmin1; sf[F_STMAX] = stmax1;
      sf[F_STX] = stx1; sf[F_FX] = fx1; sf[F_DGX] = dgx1;
      sf[F_STY] = sty1; sf[F_FY] = fy1; sf[F_DGY] = dgy1;
      sf[F_WIDTH] = width_1; sf[F_WIDTH1] = width1_1;
      si[I_BRACKT] = brackt1; si[I_STAGE1] = stage1_1;
      si[I_LSNFEV] = ls_nfev1; si[I_INFO] = info1; si[I_INFOC] = infoc1;
    }
    return;
  }

  // ------------------------------------------------------------ boundary
  const bool evaled = ls_nfev1 > 0;
  const T f_ls = evaled ? facc1 : f0;
  const bool finite = isfinite(f_ls);
  const T f1 = finite ? f_ls : f0;
  const int nfev_st = iv[I_NFEV] + ls_nfev1;

  // Accepted point x1, g1 and the pair s = x1 - x0, y = g1 - g0, recomputed
  // identically wherever a pass needs them.
  auto point = [&](int j, T &x1, T &g1, T &sv, T &yv) {
    const T x0j = x0[j], g0j = g0[j];
    const T gaccj = active ? g_t[j] : gacc[j];
    const T xls = evaled ? x0j + stp1 * sdir[j] : x0j;
    const T gls = evaled ? gaccj : g0j;
    x1 = finite ? xls : x0j;
    g1 = finite ? gls : g0j;
    sv = x1 - x0j;
    yv = g1 - g0j;
  };

  T mx[3] = {T(0), T(0), T(0)};          // |s|, |g1|, |x1| maxima
  T sm[5] = {T(0), T(0), T(0), T(0), T(0)};  // s.y, s.s, y.y, x1.x1, g1.g1
  for (int j = tid; j < n; j += nt) {
    T x1, g1, sv, yv;
    point(j, x1, g1, sv, yv);
    mx[0] = nmax(mx[0], fabs(sv));
    mx[1] = nmax(mx[1], fabs(g1));
    mx[2] = nmax(mx[2], fabs(x1));
    sm[0] += sv * yv;
    sm[1] += sv * sv;
    sm[2] += yv * yv;
    sm[3] += x1 * x1;
    sm[4] += g1 * g1;
  }
  block_max<T, 3>(mx, red);
  block_sum<T, 5>(sm, red);
  const T x_delta = mx[0], grad_norm = mx[1], xmax = mx[2];
  const T f_delta = fabs(f1 - f0);
  const int count = x_delta <= T(0) ? 0 : iv[I_COUNT];

  // Progress::Update ladder (progress.h:153-327).
  const Crit &c = a.crit;
  const T one = T(1);
  const int num_it = iv[I_NUMIT] + 1;
  int st = 0;
  if (c.max_iterations > 0 && num_it > c.max_iterations) st = 1;
  bool reached = st == 0;
  const T xd = T(c.x_delta);
  const bool xv_cond = xd > T(0) && x_delta < xd;
  const int x_viol =
      reached ? (xv_cond ? iv[I_XVIOL] + 1 : 0) : iv[I_XVIOL];
  if (st == 0 && xv_cond && x_viol >= c.x_delta_violations) st = 2;
  reached = st == 0;
  const T f_scale = c.f_delta_relative
                        ? nmax(nmax(fabs(f1), fabs(f0)), one)
                        : one;
  const T fd = T(c.f_delta);
  const bool fv_cond = fd > T(0) && f_delta < fd * f_scale;
  const int f_viol =
      reached ? (fv_cond ? iv[I_FVIOL] + 1 : 0) : iv[I_FVIOL];
  if (st == 0 && fv_cond && f_viol >= c.f_delta_violations) st = 3;
  reached = st == 0;
  const bool past_active = c.past > 0;
  if (past_active && num_it == 1) {
#pragma unroll
    for (int k = 0; k < RING; ++k) ring[k] = f1;
  }
  const int pp = iv[I_PASTPOS];
  T past_f = T(0);
#pragma unroll
  for (int k = 0; k < RING; ++k)
    if (k == pp) past_f = ring[k];
  const T rate = fabs(past_f - f1) / nmax(one, fabs(f1));
  if (st == 0 && past_active && num_it > c.past && rate < T(c.past_delta))
    st = 3;
  const bool write_ring = past_active && st == 0 && reached;
  if (write_ring) {
#pragma unroll
    for (int k = 0; k < RING; ++k)
      if (k == pp) ring[k] = f1;
  }
  const int past_pos1 = write_ring ? (pp + 1 >= c.past ? 0 : pp + 1) : pp;
  const T g_scale = c.gradient_norm_relative ? nmax(one, xmax) : one;
  const T gn = T(c.gradient_norm);
  if (st == 0 && gn > T(0) && grad_norm < gn * g_scale) st = 4;
  const int status1 = st;

  // Curvature-gated push and gamma (lbfgs.h:253-298).  Not for lanes that
  // just converged.
  const bool push_live = status1 == 0;
  const bool valid = push_live && finite;
  const T sy = sm[0], s2 = sm[1], y2 = sm[2];
  const T threshold = eps * sqrt(s2) * sqrt(y2);
  const bool accept = valid && sy > threshold;
  const bool full = count >= m;
  const int slot = count < m - 1 ? count : m - 1;
  int new_count = (accept && !full) ? count + 1 : count;
  const T gamma = f[F_GAMMA];
  const T temp = sy / (y2 > eps ? y2 : one);
  const bool gamma_ok =
      valid && y2 > eps && isfinite(temp) && fabs(temp) <= T(1e7);
  const T new_gamma = gamma_ok ? nmax(temp, eps) : gamma;

  // Push (in place: each thread shifts its own elements, rows ascending),
  // q = g1, and the boundary lane's new iterate.
  for (int j = tid; j < n; j += nt) {
    T x1, g1, sv, yv;
    point(j, x1, g1, sv, yv);
    if (accept) {
      if (full) {
        for (int r = 0; r < m - 1; ++r) {
          hs[(size_t)r * n + j] = hs[(size_t)(r + 1) * n + j];
          hy[(size_t)r * n + j] = hy[(size_t)(r + 1) * n + j];
        }
      }
      hs[(size_t)slot * n + j] = sv;
      hy[(size_t)slot * n + j] = yv;
    }
    q[j] = g1;
    x0[j] = x1;
    g0[j] = g1;
    gacc[j] = g1;
  }
  // From here x0 holds x1 and g0 holds g1.

  // Two-loop recursion over the rows in use (lbfgs.h:141-196).
  for (int r = new_count - 1; r >= 0; --r) {
    const T *s_r = hs + (size_t)r * n;
    const T *y_r = hy + (size_t)r * n;
    T d[2] = {T(0), T(0)};
    for (int j = tid; j < n; j += nt) {
      d[0] += s_r[j] * y_r[j];
      d[1] += s_r[j] * q[j];
    }
    block_sum<T, 2>(d, red);
    const bool usable = fabs(d[0]) >= eps;
    const T rho = usable ? one / d[0] : T(0);
    const T alpha = rho * d[1];
    if (usable)
      for (int j = tid; j < n; j += nt) q[j] = q[j] - alpha * y_r[j];
    if (tid == 0) {
      alphas[r] = alpha;
      rhos[r] = rho;
      usables[r] = usable ? 1 : 0;
    }
  }
  for (int j = tid; j < n; j += nt) q[j] = q[j] * new_gamma;
  __syncthreads();  // alphas/rhos/usables from thread 0
  for (int r = 0; r < new_count; ++r) {
    if (!usables[r]) continue;
    const T *s_r = hs + (size_t)r * n;
    const T *y_r = hy + (size_t)r * n;
    T d[1] = {T(0)};
    for (int j = tid; j < n; j += nt) d[0] += y_r[j] * q[j];
    block_sum<T, 1>(d, red);
    const T beta = rhos[r] * d[0];
    const T coef = alphas[r] - beta;
    for (int j = tid; j < n; j += nt) q[j] = q[j] + s_r[j] * coef;
  }

  // Descent check, fallback and trial 0 of the next search.
  T dq[2] = {T(0), T(0)};  // g1.q, q.q
  for (int j = tid; j < n; j += nt) {
    const T qj = q[j];
    dq[0] += g0[j] * qj;
    dq[1] += qj * qj;
  }
  block_sum<T, 2>(dq, red);
  const T xnorm = sqrt(sm[3]);
  const T relative_eps = eps * nmax(one, xnorm);
  const T descent = -dq[0];
  const T dnorm = sqrt(dq[1]);
  const T gnorm_full = sqrt(sm[4]);
  T alpha0 = new_count == 0 ? (dnorm > eps ? one / dnorm : one) : one;
  const bool invalid = !isfinite(descent) || descent > -eps * relative_eps;
  if (invalid) alpha0 = gnorm_full > eps ? one / gnorm_full : one;
  if (invalid && push_live) new_count = 0;
  // g1 . (-dir): exactly -(g1.g1) or -(g1.q) in the same summation order.
  const T dginit_new = invalid ? -sm[4] : descent;
  const T dgtest_new = T(FTOL) * dginit_new;
  const bool no_descent = dginit_new >= T(0);
  T stp_t0, stmin0, stmax0;
  trial_setup(alpha0, T(0), T(0), false, 0, 1, max_fev, stp_t0, stmin0,
              stmax0);
  const T stp0 = no_descent ? alpha0 : stp_t0;
  const int info0 = no_descent ? -1 : 0;
  const T big_width = T(STPMAX - STPMIN);
  const T next_stp = status1 == 0 ? stp0 : T(0);

  for (int j = tid; j < n; j += nt) {
    const T ls = -(invalid ? g0[j] : q[j]);
    sdir[j] = ls;
    x_trial[j] = x0[j] + next_stp * ls;
  }
  if (tid == 0) {
    sf[F_F0] = f1; sf[F_DGINIT] = dginit_new; sf[F_DGTEST] = dgtest_new;
    sf[F_FACC] = f1; sf[F_STP] = stp0; sf[F_STMIN] = stmin0;
    sf[F_STMAX] = stmax0; sf[F_STX] = T(0); sf[F_FX] = f1;
    sf[F_DGX] = dginit_new; sf[F_STY] = T(0); sf[F_FY] = f1;
    sf[F_DGY] = dginit_new; sf[F_WIDTH] = big_width;
    sf[F_WIDTH1] = T(2) * big_width; sf[F_GAMMA] = new_gamma;
    sf[F_XDELTA] = x_delta; sf[F_FDELTA] = f_delta; sf[F_GNORM] = grad_norm;
    si[I_COUNT] = new_count; si[I_NFEV] = nfev_st; si[I_NUMIT] = num_it;
    si[I_XVIOL] = x_viol; si[I_FVIOL] = f_viol; si[I_STATUS] = status1;
    si[I_PASTPOS] = past_pos1; si[I_BRACKT] = 0; si[I_STAGE1] = 1;
    si[I_LSNFEV] = 0; si[I_INFO] = info0; si[I_INFOC] = 1;
#pragma unroll
    for (int k = 0; k < RING; ++k) ringp[k] = ring[k];
  }
}

inline int block_threads(int n) {
  int t = ((n + 31) / 32) * 32;
  return t < 32 ? 32 : (t > MAX_THREADS ? MAX_THREADS : t);
}

template <typename T>
int launch(T *x0, T *g0, T *sdir, T *gacc, T *s, T *y, T *ring, T *sf,
           int *si, const T *f_t, const T *g_t, T *x_trial, int b, int n,
           int m, int max_fev, Crit crit, cudaStream_t stream) {
  if (b <= 0) return 0;
  const size_t smem =
      (size_t)(RED_SLOTS * MAX_WARPS + 2 * m + n) * sizeof(T) +
      (size_t)m * sizeof(int);
  if (smem > 48 * 1024) {
    // Above 48 KB a block's dynamic shared memory has to be opted into.
    cudaError_t err = cudaFuncSetAttribute(
        flat_trip_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  Args<T> a{x0, g0, sdir, gacc, s, y, ring, sf, si, f_t, g_t, x_trial,
            n, m, max_fev, crit};
  flat_trip_kernel<T><<<b, block_threads(n), smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

#define CPPNS_FLAT_TRIP(NAME, T)                                             \
  extern "C" int NAME(void *x0, void *g0, void *sdir, void *gacc, void *s,  \
                      void *y, void *ring, void *sf, void *si,              \
                      const void *f_t, const void *g_t, void *x_trial,      \
                      int b, int n, int m, int max_fev, double x_delta,     \
                      double f_delta, double past_delta,                    \
                      double gradient_norm, int max_iterations,             \
                      int x_delta_violations, int f_delta_violations,       \
                      int past, int f_delta_relative,                       \
                      int gradient_norm_relative, void *stream) {           \
    Crit crit{x_delta,          f_delta,           past_delta,             \
              gradient_norm,    max_iterations,    x_delta_violations,     \
              f_delta_violations, past,            f_delta_relative,       \
              gradient_norm_relative};                                      \
    return launch<T>((T *)x0, (T *)g0, (T *)sdir, (T *)gacc, (T *)s,        \
                     (T *)y, (T *)ring, (T *)sf, (int *)si,                 \
                     (const T *)f_t, (const T *)g_t, (T *)x_trial, b, n, m, \
                     max_fev, crit, (cudaStream_t)stream);                  \
  }

CPPNS_FLAT_TRIP(cppns_flat_trip_f32, float)
CPPNS_FLAT_TRIP(cppns_flat_trip_f64, double)

extern "C" const char *cppns_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
