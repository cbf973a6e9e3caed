// Device code shared by the port's CUDA kernels (flat_trip.cu, mt_trip.cu,
// lbfgs_prologue.cu, lbfgs_prologue_t.cu, lbfgs_epilogue.cu,
// push_two_loop.cu, two_loop.cu): NaN-propagating min/max, the MINPACK
// More-Thuente step (cstep, trial setup, one post-evaluation trip), the
// curvature gate of a history push, the descent check and the
// Progress::Update ladder, all per-lane scalar logic.  Each kernel source
// includes this header (lbfgs_prologue_t.cu directly, the others through
// staged.cuh, which holds their lane groups, reductions and two-loop) and is
// compiled on its own into one shared library with a plain C interface.
// Every thread of a lane computes the per-lane scalar logic redundantly from
// identical inputs; one thread writes scalars.
//
// Numerics.  The kernels must agree with their plain PyTorch versions, which
// follow JAX's semantics: literals are rounded to T before use (T(0.66) * x,
// as JAX keeps a Python literal in the array's dtype); sign(0) = 0 and
// sign(NaN) = NaN; max/min propagate NaN (explicit compare-and-select, not
// fmax/fmin); every select is a ternary, never a multiply by a mask.  Build
// with --fmad=false: FMA contraction would change rounding against the plain
// version.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace cppns {

constexpr int RING = 8;  // plateau ring capacity (core/progress.py)

// MINPACK constants (more_thuente.h:142-148).
constexpr double XTOL = 1e-15, FTOL = 1e-4, GTOL = 0.9, STPMIN = 1e-15,
                 STPMAX = 1e15, XTRAPF = 4.0;

constexpr int RED_SLOTS = 8;  // values one group reduction can carry

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

// Stopping criteria, uniform across the batch.
struct Crit {
  double x_delta, f_delta, past_delta, gradient_norm;
  int max_iterations, x_delta_violations, f_delta_violations, past;
  int f_delta_relative, gradient_norm_relative;
};

// Launch helper: opt into more than 48 KB of dynamic shared memory.
template <typename K> inline int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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

// The bracketing state of one lane's More-Thuente search.
template <typename T> struct Search {
  T stp, stmin, stmax, stx, fx, dgx, sty, fy, dgy, width, width1;
  int brackt, stage1, infoc;
};

// The scalar half of one post-evaluation More-Thuente trip
// (more_thuente.h:199-252): the termination ladder at the evaluated step and,
// for a lane that goes on searching, the stage-1 frame, cstep, the forced
// bisection, the widths and the next trial.  Returns the MINPACK info code (0
// = still searching); ``sr`` is advanced only when it is 0, so a lane that
// terminates keeps the step it evaluated.  ``infoc`` is carried as MINPACK
// does.
template <typename T>
__device__ int mt_step(Search<T> &sr, T finit, T dginit, T dgtest, T f_t,
                       T dg, int nfev1, int max_fev) {
  const T stp = sr.stp, stmin = sr.stmin, stmax = sr.stmax;
  const T stx = sr.stx, fx = sr.fx, dgx = sr.dgx;
  const T sty = sr.sty, fy = sr.fy, dgy = sr.dgy;
  const T width = sr.width, width1 = sr.width1;
  const bool brackt = sr.brackt != 0;
  const int stage1_i = sr.stage1;
  const int infoc = sr.infoc;
  const T ftest1 = finit + stp * dgtest;

  int info_new =
      ((brackt && (stp <= stmin || stp >= stmax)) || infoc == 0) ? 6 : 0;
  if (stp == T(STPMAX) && f_t <= ftest1 && dg <= dgtest) info_new = 5;
  if (stp == T(STPMIN) && (f_t > ftest1 || dg >= dgtest)) info_new = 4;
  if (nfev1 >= max_fev) info_new = 3;
  if (brackt && stmax - stmin <= T(XTOL) * stmax) info_new = 2;
  if (f_t <= ftest1 && fabs(dg) <= T(GTOL) * (-dginit)) info_new = 1;

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

  if (info_new == 0) {
    sr.stp = stp_t; sr.stmin = stmin_t; sr.stmax = stmax_t;
    sr.stx = cs.stx; sr.fx = fx_c; sr.dgx = dgx_c;
    sr.sty = cs.sty; sr.fy = fy_c; sr.dgy = dgy_c;
    sr.width = width_c; sr.width1 = width1_c;
    sr.brackt = cs.brackt ? 1 : 0;
    sr.stage1 = stage1_new;
    sr.infoc = cs.info;
  }
  return info_new;
}

// Curvature gate and gamma of a candidate pair (lbfgs.h:253-298), from
// sy = s.y, s2 = s.s, y2 = y.y of the pair.
template <typename T> struct Push {
  bool accept, full;
  int slot, new_count;
  T new_gamma;
};

template <typename T>
__device__ Push<T> push_gate(bool valid, T sy, T s2, T y2, int count, int m,
                             T gamma) {
  const T eps = Eps<T>::v, one = T(1);
  Push<T> p;
  const T threshold = eps * sqrt(s2) * sqrt(y2);
  p.accept = valid && sy > threshold;
  p.full = count >= m;
  p.slot = count < m - 1 ? count : m - 1;
  p.new_count = (p.accept && !p.full) ? count + 1 : count;
  const T temp = sy / (y2 > eps ? y2 : one);
  const bool gamma_ok =
      valid && y2 > eps && isfinite(temp) && fabs(temp) <= T(1e7);
  p.new_gamma = gamma_ok ? nmax(temp, eps) : gamma;
  return p;
}

// Descent check of the two-loop direction, the steepest-descent fallback and
// the first step of the next search (lbfgs.h:199-224).  gq = g.q, qq = q.q,
// gg = g.g, xx = x.x; ``count`` is the history count after the push.
template <typename T> struct Descent {
  bool invalid;
  T alpha0, dginit;
};

template <typename T>
__device__ Descent<T> descent_check(T gq, T qq, T gg, T xx, int count) {
  const T eps = Eps<T>::v, one = T(1);
  Descent<T> d;
  const T relative_eps = eps * nmax(one, sqrt(xx));
  const T descent = -gq;
  const T dnorm = sqrt(qq);
  const T gnorm = sqrt(gg);
  d.alpha0 = count == 0 ? (dnorm > eps ? one / dnorm : one) : one;
  d.invalid = !isfinite(descent) || descent > -eps * relative_eps;
  if (d.invalid) d.alpha0 = gnorm > eps ? one / gnorm : one;
  // g . (-dir): exactly -(g.g) or -(g.q) in the same summation order.
  d.dginit = d.invalid ? -gg : descent;
  return d;
}

// Progress::Update ladder (progress.h:153-327): iteration limit, x_delta and
// f_delta with their violation counters, the plateau ring, the relative
// gradient norm.  ``ring`` is the lane's ring in registers, updated in
// place.
struct Ladder {
  int num_it, x_viol, f_viol, past_pos, status;
};

template <typename T>
__device__ Ladder progress_ladder(const Crit &c, int num_it_old,
                                  int x_viol_old, int f_viol_old, int pp,
                                  T (&ring)[RING], T x_delta, T f_delta,
                                  T f1, T f0, T grad_norm, T xmax) {
  const T one = T(1);
  Ladder l;
  l.num_it = num_it_old + 1;
  int st = 0;
  if (c.max_iterations > 0 && l.num_it > c.max_iterations) st = 1;
  bool reached = st == 0;
  const T xd = T(c.x_delta);
  const bool xv_cond = xd > T(0) && x_delta < xd;
  l.x_viol = reached ? (xv_cond ? x_viol_old + 1 : 0) : x_viol_old;
  if (st == 0 && xv_cond && l.x_viol >= c.x_delta_violations) st = 2;
  reached = st == 0;
  const T f_scale = c.f_delta_relative
                        ? nmax(nmax(fabs(f1), fabs(f0)), one)
                        : one;
  const T fd = T(c.f_delta);
  const bool fv_cond = fd > T(0) && f_delta < fd * f_scale;
  l.f_viol = reached ? (fv_cond ? f_viol_old + 1 : 0) : f_viol_old;
  if (st == 0 && fv_cond && l.f_viol >= c.f_delta_violations) st = 3;
  reached = st == 0;
  const bool past_active = c.past > 0;
  if (past_active && l.num_it == 1) {
#pragma unroll
    for (int k = 0; k < RING; ++k) ring[k] = f1;
  }
  T past_f = T(0);
#pragma unroll
  for (int k = 0; k < RING; ++k)
    if (k == pp) past_f = ring[k];
  const T rate = fabs(past_f - f1) / nmax(one, fabs(f1));
  if (st == 0 && past_active && l.num_it > c.past && rate < T(c.past_delta))
    st = 3;
  const bool write_ring = past_active && st == 0 && reached;
  if (write_ring) {
#pragma unroll
    for (int k = 0; k < RING; ++k)
      if (k == pp) ring[k] = f1;
  }
  l.past_pos = write_ring ? (pp + 1 >= c.past ? 0 : pp + 1) : pp;
  const T g_scale = c.gradient_norm_relative ? nmax(one, xmax) : one;
  const T gn = T(c.gradient_norm);
  if (st == 0 && gn > T(0) && grad_norm < gn * g_scale) st = 4;
  l.status = st;
  return l;
}

}  // namespace cppns

extern "C" const char *cppns_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
