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
// Design (redesigned for Hopper; staged.cuh sets out the lane groups and
// the row modes).  The wrapper maps a lane to one warp (n <= 64, several
// lanes per block, rows read in place with the next row's load ahead) or to
// one block of 64 to 512 threads, each thread owning 8 elements of a row.
// The history, its count and gamma are updated in place, and the history
// stays chronological (it is LbfgsInternals, shared with resume and warm
// starts).  Where four lanes' rows fit an SM's shared memory (n = 256 at
// m = 10) they are copied there (cp.async) while the pending pair's sums
// run; a full history's shift is then written from the staged rows, as
// writes only, and the two-loop reads no device memory.  Otherwise the shift
// loads four rows before storing them and the two-loop streams the rows or,
// where the stream's row buffers do not fit a block (n > 5,752 in float64
// and 11,563 in float32 at m = 10), reads them in place.  The push and the
// two-loop are staged.cuh's push_two_loop_rows, which push_two_loop.cu runs
// too.  A done lane touches none of the history and emits the zero
// direction with dginit = 0, on which the search aborts before its first
// evaluation by its own non-descent rule.
//
// What bounds it on an H100: device-memory bytes.  A live lane reads x, g and
// the pending pair, reads the history rows in use once, writes the rows that
// changed (one, or all m when a full history shifts) and the direction.
// On one NVIDIA H100 80GB HBM3 at 700 W this design reaches 10-38% of that
// bound at the shapes PERF.md lists; the one before it (a 256-thread block
// per lane, rows read from device memory in every pass) reached 8-33%.
//
// Numerics and build flags: see common.cuh (--fmad=false; ops/_build.py).

#include "staged.cuh"

namespace {

using namespace cppns;

// Blocks per SM the warp-per-lane build is bounded for (launch bounds).
constexpr int WARP_MIN_BLOCKS = 2;

template <typename T> struct Args {
  const T *x, *g, *s_new, *y_new;
  const unsigned char *valid, *done;
  T *s, *y;
  int *count;
  T *gamma, *ls_dir, *alpha, *dginit;
  int b, n, m, rows;
};

template <typename T, bool WARP, bool WIDE>
__global__ void __launch_bounds__(bound_threads(WARP, WIDE),
                                  WARP ? WARP_MIN_BLOCKS : 2)
    prologue_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, m = a.m;
  const bool staged = a.rows == ROWS_STAGED;
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

  if (staged) stage_rows(hs, hy, lm.rows, count, 0, m, n, tid, nt);

  T sm[5] = {T(0), T(0), T(0), T(0), T(0)};  // s.y, s.s, y.y, x.x, g.g
  for (int j = tid; j < n; j += nt) {
    const T sv = s_new[j], yv = y_new[j], xv = x[j], gv = g[j];
    sm[0] += sv * yv;
    sm[1] += sv * sv;
    sm[2] += yv * yv;
    sm[3] += xv * xv;
    sm[4] += gv * gv;
  }
  // Every thread has read count and gamma before thread 0 writes them: in
  // block mode the reduction's barrier orders them, in warp mode the sync.
  grp.template sum<5>(sm);
  if (WARP) grp.sync();

  const Push<T> p = push_gate(valid, sm[0], sm[1], sm[2], count, m, gamma);
  push_two_loop_rows(grp, lm, p, hs, hy, s_new, y_new, g, a.rows, m, n);

  T dq[2] = {T(0), T(0)};  // g.q, q.q
  for (int j = tid; j < n; j += nt) {
    const T qj = lm.q[j];
    dq[0] += g[j] * qj;
    dq[1] += qj * qj;
  }
  grp.template sum<2>(dq);
  const Descent<T> ds =
      descent_check(dq[0], dq[1], sm[4], sm[3], p.new_count);

  for (int j = tid; j < n; j += nt)
    ls_dir[j] = -(ds.invalid ? g[j] : lm.q[j]);
  if (tid == 0) {
    a.alpha[lane] = ds.alpha0;
    a.dginit[lane] = ds.dginit;
    a.count[lane] = ds.invalid ? 0 : p.new_count;
    a.gamma[lane] = p.new_gamma;
  }
}

template <typename T, bool WARP, bool WIDE>
int launch_as(const Args<T> &a, const Mapping &mp, cudaStream_t stream) {
  const size_t smem = mapping_smem(mp, a.m, a.n, sizeof(T));
  if (int err = allow_smem(prologue_kernel<T, WARP, WIDE>, smem)) return err;
  const int blocks = WARP ? (a.b + mp.lpb - 1) / mp.lpb : a.b;
  const int threads = WARP ? 32 * mp.lpb : mp.tpl;
  prologue_kernel<T, WARP, WIDE><<<blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args<T> &a, const Mapping &mp, cudaStream_t stream) {
  if (a.b <= 0) return 0;
  if (mp.tpl < 32 || mp.tpl > LANE_MAX_THREADS || mp.tpl % 32 ||
      mp.lpb < 1 || (mp.tpl != 32 && mp.lpb != 1) || mp.rows < 0 ||
      mp.rows > ROWS_DIRECT || 32 * mp.lpb > WARP_BLOCK_THREADS ||
      (mp.tpl == 32 && a.n > 32 * DIRECT_ELEMENTS))
    return (int)cudaErrorInvalidValue;
  if (mp.tpl == 32) return launch_as<T, true, false>(a, mp, stream);
  return mp.tpl > NARROW_THREADS ? launch_as<T, false, true>(a, mp, stream)
                                 : launch_as<T, false, false>(a, mp, stream);
}

}  // namespace

#define CPPNS_PROLOGUE(NAME, T)                                              \
  extern "C" int NAME(const void *x, const void *g, const void *s_new,      \
                      const void *y_new, const void *valid,                 \
                      const void *done, void *s, void *y, void *count,      \
                      void *gamma, void *ls_dir, void *alpha, void *dginit, \
                      int b, int n, int m, int lanes_per_block,             \
                      int threads_per_lane, int rows, void *stream) {     \
    Args<T> a{(const T *)x, (const T *)g, (const T *)s_new,                 \
              (const T *)y_new, (const unsigned char *)valid,               \
              (const unsigned char *)done, (T *)s, (T *)y, (int *)count,    \
              (T *)gamma, (T *)ls_dir, (T *)alpha, (T *)dginit, b, n, m,    \
              rows};                                                        \
    return launch<T>(a, Mapping{lanes_per_block, threads_per_lane, rows},   \
                     (cudaStream_t)stream);                                 \
  }

CPPNS_PROLOGUE(cppns_lbfgs_prologue_f32, float)
CPPNS_PROLOGUE(cppns_lbfgs_prologue_f64, double)
