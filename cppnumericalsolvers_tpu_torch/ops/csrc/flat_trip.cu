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
// Design (redesigned for Hopper; staged.cuh sets out the lane groups and
// the row modes).  The wrapper maps a lane to one warp (n <= 64, several
// lanes per block, rows read in place with the next row's load ahead) or to
// one block of 64 to 512 threads, each thread owning 8 elements of a row,
// which streams the rows through shared memory or, where the stream's row
// buffers do not fit a block (n > 5,752 in float64 and 11,563 in float32 at
// m = 10), reads them in place.  Small blocks with little
// shared memory keep many lanes in flight, which the trip needs: most lanes
// are mid-search and touch no history.  The history is a ring: row k in age
// order is physical row (head + k) mod m, with head in si[I_HEAD]; an
// accepted pair writes one row of s and of y and advances the head when the
// history is full, so nothing shifts.
//
// What bounds it on an H100: device-memory bytes.  A lane mid-search reads
// g_t, sdir, x0 and writes gacc, x_trial: about 5*n*itemsize per trip.  A
// lane at the boundary also reads the history rows in use (2*count*n*itemsize
// counted once; the kernel's two passes read them twice) and writes one row
// of s and y per accepted pair.  On one NVIDIA H100 80GB HBM3 at 700 W this
// design reaches 4-29% of that bound at the shapes PERF.md lists; the one
// before it (a 256-thread block per lane, the TPU kernel's chronological
// shift, two barriers per reduction) reached 5-23%.
//
// Numerics and build flags: see common.cuh (--fmad=false; ops/_build.py).

#include "staged.cuh"

namespace {

using namespace cppns;

// Blocks per SM the warp-per-lane build is bounded for (launch bounds).
constexpr int WARP_MIN_BLOCKS = 4;

// Packed scalar rows (ops/flat_solve.py).
constexpr int F_F0 = 0, F_DGINIT = 1, F_DGTEST = 2, F_FACC = 3, F_STP = 4,
              F_STMIN = 5, F_STMAX = 6, F_STX = 7, F_FX = 8, F_DGX = 9,
              F_STY = 10, F_FY = 11, F_DGY = 12, F_WIDTH = 13, F_WIDTH1 = 14,
              F_GAMMA = 15, F_XDELTA = 16, F_FDELTA = 17, F_GNORM = 18,
              NF = 19;
constexpr int I_COUNT = 0, I_NFEV = 1, I_NUMIT = 2, I_XVIOL = 3, I_FVIOL = 4,
              I_STATUS = 5, I_PASTPOS = 6, I_BRACKT = 7, I_STAGE1 = 8,
              I_LSNFEV = 9, I_INFO = 10, I_INFOC = 11, I_HEAD = 12,
              NI = 13;

template <typename T> struct Args {
  T *x0, *g0, *sdir, *gacc, *s, *y, *ring, *sf;
  int *si;
  const T *f_t, *g_t;
  T *x_trial;
  int b, n, m, max_fev, rows;
  Crit crit;
};

template <typename T, bool WARP, bool WIDE>
__global__ void __launch_bounds__(bound_threads(WARP, WIDE),
                                  WARP ? WARP_MIN_BLOCKS : 2)
    flat_trip_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, m = a.m, max_fev = a.max_fev;
  T *base = reinterpret_cast<T *>(smem_raw);
  Group<T, WARP> grp;
  grp.buf = 0;
  size_t lane;
  if (WARP) {
    const int slot = threadIdx.x >> 5;
    lane = (size_t)blockIdx.x * (blockDim.x >> 5) + slot;
    if (lane >= (size_t)a.b) return;  // ragged last block
    grp.tid = threadIdx.x & 31;
    grp.nt = 32;
    grp.red = nullptr;
    base += (size_t)slot * lane_values(m, n, a.rows);
  } else {
    lane = blockIdx.x;
    grp.tid = threadIdx.x;
    grp.nt = blockDim.x;
    grp.red = base;
    base += GROUP_RED_VALUES;
  }
  const LaneMem<T> lm(base, m, n);
  const int tid = grp.tid, nt = grp.nt;
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
  grp.sync();

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
    grp.template sum<1>(dgv);
    Search<T> sr{stp1, stmin1, stmax1, stx1, fx1, dgx1, sty1, fy1, dgy1,
                 width_1, width1_1, brackt1, stage1_1, infoc1};
    const T f_t = a.f_t[lane];
    const int nfev1 = iv[I_LSNFEV] + 1;
    info1 = mt_step(sr, f0, dginit, dgtest, f_t, dgv[0], nfev1, max_fev);
    stp1 = sr.stp; stmin1 = sr.stmin; stmax1 = sr.stmax;
    stx1 = sr.stx; fx1 = sr.fx; dgx1 = sr.dgx;
    sty1 = sr.sty; fy1 = sr.fy; dgy1 = sr.dgy;
    width_1 = sr.width; width1_1 = sr.width1;
    brackt1 = sr.brackt; stage1_1 = sr.stage1; infoc1 = sr.infoc;
    facc1 = f_t;
    ls_nfev1 = nfev1;
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
  const int head = iv[I_HEAD];

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
  grp.template max<3>(mx);
  grp.template sum<5>(sm);
  const T x_delta = mx[0], grad_norm = mx[1], xmax = mx[2];
  const T f_delta = fabs(f1 - f0);
  const int count = x_delta <= T(0) ? 0 : iv[I_COUNT];

  // Progress::Update ladder (progress.h:153-327).
  const Ladder l = progress_ladder(a.crit, iv[I_NUMIT], iv[I_XVIOL],
                                   iv[I_FVIOL], iv[I_PASTPOS], ring, x_delta,
                                   f_delta, f1, f0, grad_norm, xmax);
  const int num_it = l.num_it, x_viol = l.x_viol, f_viol = l.f_viol;
  const int past_pos1 = l.past_pos, status1 = l.status;

  // Curvature-gated push into the ring and gamma (lbfgs.h:253-298).  Not
  // for lanes that just converged.
  const bool push_live = status1 == 0;
  const Push<T> p = push_gate(push_live && finite, sm[0], sm[1], sm[2], count,
                              m, f[F_GAMMA]);
  int new_count = p.new_count;
  const T new_gamma = p.new_gamma;
  const int slot = p.full ? head : (head + count) % m;
  const int new_head = (p.accept && p.full) ? (head + 1) % m : head;

  T *srow = hs + (size_t)slot * n, *yrow = hy + (size_t)slot * n;
  for (int j = tid; j < n; j += nt) {
    T x1, g1, sv, yv;
    point(j, x1, g1, sv, yv);
    if (p.accept) {
      srow[j] = sv;
      yrow[j] = yv;
    }
    lm.q[j] = g1;
    x0[j] = x1;
    g0[j] = g1;
    gacc[j] = g1;
  }
  // From here x0 holds x1 and g0 holds g1.

  two_loop_rows(grp, lm, hs, hy, a.rows, new_count, new_head, m, n,
                new_gamma);

  // Descent check, fallback and trial 0 of the next search.
  T dq[2] = {T(0), T(0)};  // g1.q, q.q
  for (int j = tid; j < n; j += nt) {
    const T qj = lm.q[j];
    dq[0] += g0[j] * qj;
    dq[1] += qj * qj;
  }
  grp.template sum<2>(dq);
  const Descent<T> ds = descent_check(dq[0], dq[1], sm[4], sm[3], new_count);
  const bool invalid = ds.invalid;
  const T alpha0 = ds.alpha0;
  if (invalid && push_live) new_count = 0;
  const T dginit_new = ds.dginit;
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
    const T ls = -(invalid ? g0[j] : lm.q[j]);
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
    si[I_HEAD] = new_head;
#pragma unroll
    for (int k = 0; k < RING; ++k) ringp[k] = ring[k];
  }
}

template <typename T, bool WARP, bool WIDE>
int launch_as(const Args<T> &a, const Mapping &mp, cudaStream_t stream) {
  const size_t smem = mapping_smem(mp, a.m, a.n, sizeof(T));
  if (int err = allow_smem(flat_trip_kernel<T, WARP, WIDE>, smem)) return err;
  const int blocks = WARP ? (a.b + mp.lpb - 1) / mp.lpb : a.b;
  const int threads = WARP ? 32 * mp.lpb : mp.tpl;
  flat_trip_kernel<T, WARP, WIDE><<<blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args<T> &a, const Mapping &mp, cudaStream_t stream) {
  if (a.b <= 0) return 0;
  if (mp.tpl < 32 || mp.tpl > LANE_MAX_THREADS || mp.tpl % 32 ||
      mp.lpb < 1 || (mp.tpl != 32 && mp.lpb != 1) ||
      (mp.rows != ROWS_STREAM && mp.rows != ROWS_DIRECT) ||
      32 * mp.lpb > WARP_BLOCK_THREADS ||
      (mp.tpl == 32 && a.n > 32 * DIRECT_ELEMENTS))
    return (int)cudaErrorInvalidValue;
  if (mp.tpl == 32) return launch_as<T, true, false>(a, mp, stream);
  return mp.tpl > NARROW_THREADS ? launch_as<T, false, true>(a, mp, stream)
                                 : launch_as<T, false, false>(a, mp, stream);
}

}  // namespace

#define CPPNS_FLAT_TRIP(NAME, T)                                             \
  extern "C" int NAME(void *x0, void *g0, void *sdir, void *gacc, void *s,  \
                      void *y, void *ring, void *sf, void *si,              \
                      const void *f_t, const void *g_t, void *x_trial,      \
                      int b, int n, int m, int max_fev, int lanes_per_block,\
                      int threads_per_lane, int rows, double x_delta,     \
                      double f_delta, double past_delta,                    \
                      double gradient_norm, int max_iterations,             \
                      int x_delta_violations, int f_delta_violations,       \
                      int past, int f_delta_relative,                       \
                      int gradient_norm_relative, void *stream) {           \
    Crit crit{x_delta,          f_delta,           past_delta,             \
              gradient_norm,    max_iterations,    x_delta_violations,     \
              f_delta_violations, past,            f_delta_relative,       \
              gradient_norm_relative};                                      \
    Args<T> a{(T *)x0, (T *)g0, (T *)sdir, (T *)gacc, (T *)s, (T *)y,       \
              (T *)ring, (T *)sf, (int *)si, (const T *)f_t,              \
              (const T *)g_t, (T *)x_trial, b, n, m, max_fev, rows,       \
              crit};                                                        \
    return launch<T>(a, Mapping{lanes_per_block, threads_per_lane, rows},   \
                     (cudaStream_t)stream);                                 \
  }

CPPNS_FLAT_TRIP(cppns_flat_trip_f32, float)
CPPNS_FLAT_TRIP(cppns_flat_trip_f64, double)
