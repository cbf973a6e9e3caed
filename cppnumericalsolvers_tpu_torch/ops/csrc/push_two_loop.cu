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
// Design (redesigned for Hopper; staged.cuh sets out the lane groups and
// the row modes).  It is lbfgs_prologue.cu's body without the descent check
// and the search's set-up, on the same mapping rules
// (ops/_kernel.py::lane_mapping("push_two_loop", ...)): a warp per lane at
// n <= 64, several lanes a block, every row in use held in registers (at
// m <= 10; else read in place with the next row's load ahead, as the
// prologue does); else one block of 64 to 512 threads per lane, each thread
// owning 8 elements of a row, whose rows are copied on chip with cp.async
// (issued before the pair's sums) where four lanes' rows fit an SM, streamed
// through two row buffers where those fit, and read in place otherwise.
// With the rows on chip a full history's shift is writes only and the
// two-loop reads no device memory.  The history stays chronological (it is
// LbfgsInternals, shared with resume and warm starts); it, its count and
// gamma are updated in place.  A lane whose pair is not accepted writes none
// of the history, and a lane with valid = 0 writes back the count and gamma
// it read, so every bit of them stays.
//
// Sum order.  With n <= 32 a warp per lane adds the products in the order
// of the kernel it replaced (one element a thread, one xor butterfly), so
// the float32 Hessian-condition solves of chip_smoke.py (path B, n = 32),
// whose criterion flips on the last bit of a sum, keep their statuses.
//
// What bounds it on an H100: device-memory bytes.  A lane reads g and the
// pair, reads the history rows in use (each row counted once), rewrites the
// history when the pair is accepted (one row, or all m rows when a full
// history shifts) and writes the direction.
//
// Numerics and build flags: see common.cuh (--fmad=false; ops/_build.py).

#include "staged.cuh"

namespace {

using namespace cppns;

// Blocks per SM the warp-per-lane build is bounded for (launch bounds).
constexpr int WARP_MIN_BLOCKS = 2;
// A warp per lane holds the whole history in registers (ROWS_REGISTERS,
// ops/_kernel.py) where m <= REG_ROWS.
constexpr int ROWS_REGISTERS = 3, REG_ROWS = 10;

template <typename T> struct Args {
  const T *g, *s_new, *y_new;
  const unsigned char *valid;
  T *s, *y;
  int *count;
  T *gamma, *d;
  int b, n, m, rows;
};

template <typename T, bool WARP, bool WIDE>
__global__ void __launch_bounds__(bound_threads(WARP, WIDE),
                                  WARP ? WARP_MIN_BLOCKS : 2)
    push_two_loop_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, m = a.m;
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
  const T *g = a.g + lane * n;
  const T *s_new = a.s_new + lane * n;
  const T *y_new = a.y_new + lane * n;
  T *hs = a.s + lane * m * n;
  T *hy = a.y + lane * m * n;
  const int count = a.count[lane];
  const T gamma = a.gamma[lane];
  const bool valid = a.valid[lane] != 0;

  if (a.rows == ROWS_STAGED)
    stage_rows(hs, hy, lm.rows, count, 0, m, n, tid, nt);

  T sm[3] = {T(0), T(0), T(0)};  // s.y, s.s, y.y
  for (int j = tid; j < n; j += nt) {
    const T sv = s_new[j], yv = y_new[j];
    sm[0] += sv * yv;
    sm[1] += sv * sv;
    sm[2] += yv * yv;
  }
  // Every thread has read count and gamma before thread 0 writes them: in
  // block mode the reduction's barrier orders them, in warp mode the sync.
  grp.template sum<3>(sm);
  if (WARP) grp.sync();

  const Push<T> p = push_gate(valid, sm[0], sm[1], sm[2], count, m, gamma);
  push_two_loop_rows(grp, lm, p, hs, hy, s_new, y_new, g, a.rows, m, n);

  T *d = a.d + lane * n;
  for (int j = tid; j < n; j += nt) d[j] = lm.q[j];
  if (tid == 0) {
    a.count[lane] = p.new_count;
    a.gamma[lane] = p.new_gamma;
  }
}

// A warp per lane (n <= 64, m <= REG_ROWS) with every row in use held in
// registers: the rows are loaded with the pair and the gradient before the
// first reduction, shifted and pushed in registers (a full history's shift
// is written back as stores only), and the two-loop's 2 count reductions
// wait on no load.  Each thread owns j = t and t + 32, adds its products in
// order of j and the warp reduces by xor butterfly: the order and the
// arithmetic of staged.cuh's ROWS_DIRECT, so the two give the same bits.
template <typename T>
__global__ void __launch_bounds__(WARP_BLOCK_THREADS, WARP_MIN_BLOCKS)
    push_two_loop_regs_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int E = DIRECT_ELEMENTS;
  const int n = a.n, m = a.m;
  const int slot_w = threadIdx.x >> 5;
  const size_t lane = (size_t)blockIdx.x * (blockDim.x >> 5) + slot_w;
  if (lane >= (size_t)a.b) return;  // ragged last block
  Group<T, true> grp;
  grp.tid = threadIdx.x & 31;
  grp.nt = 32;
  grp.red = nullptr;
  grp.buf = 0;
  const LaneMem<T> lm(reinterpret_cast<T *>(smem_raw) +
                          (size_t)slot_w * lane_values(m, n, ROWS_DIRECT),
                      m, n);
  const int tid = grp.tid;
  const T *g = a.g + lane * n;
  const T *s_new = a.s_new + lane * n;
  const T *y_new = a.y_new + lane * n;
  T *hs = a.s + lane * m * n;
  T *hy = a.y + lane * m * n;
  const int count = a.count[lane];
  const T gamma = a.gamma[lane];
  const bool valid = a.valid[lane] != 0;

  // Every load of the lane, issued together.
  T sv[E], yv[E], q[E], S[REG_ROWS][E], Y[REG_ROWS][E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = tid + 32 * e;
    sv[e] = j < n ? s_new[j] : T(0);
    yv[e] = j < n ? y_new[j] : T(0);
    q[e] = j < n ? g[j] : T(0);
#pragma unroll
    for (int r = 0; r < REG_ROWS; ++r) {
      const bool in = r < count && j < n;
      S[r][e] = in ? hs[(size_t)r * n + j] : T(0);
      Y[r][e] = in ? hy[(size_t)r * n + j] : T(0);
    }
  }

  T sm[3] = {T(0), T(0), T(0)};  // s.y, s.s, y.y
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (tid + 32 * e < n) {
      sm[0] += sv[e] * yv[e];
      sm[1] += sv[e] * sv[e];
      sm[2] += yv[e] * yv[e];
    }
  grp.template sum<3>(sm);
  grp.sync();  // every thread has read count and gamma

  const Push<T> p = push_gate(valid, sm[0], sm[1], sm[2], count, m, gamma);
  if (p.accept) {
    if (p.full)
#pragma unroll
      for (int r = 0; r + 1 < REG_ROWS; ++r)
        if (r < m - 1)
#pragma unroll
          for (int e = 0; e < E; ++e) {
            S[r][e] = S[r + 1][e];
            Y[r][e] = Y[r + 1][e];
          }
#pragma unroll
    for (int r = 0; r < REG_ROWS; ++r)
      if (r == p.slot)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          S[r][e] = sv[e];
          Y[r][e] = yv[e];
        }
    // The rows that changed: all m after a shift, else the new one.
#pragma unroll
    for (int r = 0; r < REG_ROWS; ++r)
      if (r < m && (p.full || r == p.slot))
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int j = tid + 32 * e;
          if (j < n) {
            hs[(size_t)r * n + j] = S[r][e];
            hy[(size_t)r * n + j] = Y[r][e];
          }
        }
  }

  const T eps = Eps<T>::v;
  const int nc = p.new_count;
#pragma unroll
  for (int k = REG_ROWS - 1; k >= 0; --k) {
    if (k >= nc) continue;
    T d[2] = {T(0), T(0)};
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (tid + 32 * e < n) {
        d[0] += S[k][e] * Y[k][e];
        d[1] += S[k][e] * q[e];
      }
    grp.template sum<2>(d);
    const bool usable = fabs(d[0]) >= eps;
    const T rho = usable ? T(1) / d[0] : T(0);
    const T alpha = rho * d[1];
    if (usable)
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (tid + 32 * e < n) q[e] = q[e] - alpha * Y[k][e];
    lm.alphas[k] = alpha;
    lm.rhos[k] = rho;
    lm.usable[k] = usable ? T(1) : T(0);
  }
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (tid + 32 * e < n) q[e] = q[e] * p.new_gamma;
#pragma unroll
  for (int k = 0; k < REG_ROWS; ++k) {
    if (k >= nc || lm.usable[k] == T(0)) continue;
    T d[1] = {T(0)};
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (tid + 32 * e < n) d[0] += Y[k][e] * q[e];
    grp.template sum<1>(d);
    const T beta = lm.rhos[k] * d[0];
    const T coef = lm.alphas[k] - beta;
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (tid + 32 * e < n) q[e] = q[e] + S[k][e] * coef;
  }

  T *d = a.d + lane * n;
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (tid + 32 * e < n) d[tid + 32 * e] = q[e];
  if (tid == 0) {
    a.count[lane] = p.new_count;
    a.gamma[lane] = p.new_gamma;
  }
}

template <typename T>
int launch_regs(const Args<T> &a, const Mapping &mp, cudaStream_t stream) {
  const size_t smem = mapping_smem(Mapping{mp.lpb, 32, ROWS_DIRECT}, a.m, a.n,
                                   sizeof(T));
  if (int err = allow_smem(push_two_loop_regs_kernel<T>, smem)) return err;
  push_two_loop_regs_kernel<T>
      <<<(a.b + mp.lpb - 1) / mp.lpb, 32 * mp.lpb, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool WARP, bool WIDE>
int launch_as(const Args<T> &a, const Mapping &mp, cudaStream_t stream) {
  const size_t smem = mapping_smem(mp, a.m, a.n, sizeof(T));
  if (int err = allow_smem(push_two_loop_kernel<T, WARP, WIDE>, smem))
    return err;
  const int blocks = WARP ? (a.b + mp.lpb - 1) / mp.lpb : a.b;
  const int threads = WARP ? 32 * mp.lpb : mp.tpl;
  push_two_loop_kernel<T, WARP, WIDE><<<blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args<T> &a, const Mapping &mp, cudaStream_t stream) {
  if (a.b <= 0) return 0;
  if (mp.tpl < 32 || mp.tpl > LANE_MAX_THREADS || mp.tpl % 32 ||
      mp.lpb < 1 || (mp.tpl != 32 && mp.lpb != 1) || mp.rows < 0 ||
      mp.rows > ROWS_REGISTERS || 32 * mp.lpb > WARP_BLOCK_THREADS ||
      (mp.tpl == 32 && a.n > 32 * DIRECT_ELEMENTS) ||
      (mp.rows == ROWS_REGISTERS && (mp.tpl != 32 || a.m > REG_ROWS)))
    return (int)cudaErrorInvalidValue;
  if (mp.rows == ROWS_REGISTERS) return launch_regs<T>(a, mp, stream);
  if (mp.tpl == 32) return launch_as<T, true, false>(a, mp, stream);
  return mp.tpl > NARROW_THREADS ? launch_as<T, false, true>(a, mp, stream)
                                 : launch_as<T, false, false>(a, mp, stream);
}

}  // namespace

#define CPPNS_PUSH_TWO_LOOP(NAME, T)                                         \
  extern "C" int NAME(const void *g, const void *s_new, const void *y_new,  \
                      const void *valid, void *s, void *y, void *count,     \
                      void *gamma, void *d, int b, int n, int m,            \
                      int lanes_per_block, int threads_per_lane, int rows,  \
                      void *stream) {                                       \
    Args<T> a{(const T *)g, (const T *)s_new, (const T *)y_new,             \
              (const unsigned char *)valid, (T *)s, (T *)y, (int *)count,   \
              (T *)gamma, (T *)d, b, n, m, rows};                           \
    return launch<T>(a, Mapping{lanes_per_block, threads_per_lane, rows},   \
                     (cudaStream_t)stream);                                 \
  }

CPPNS_PUSH_TWO_LOOP(cppns_push_two_loop_f32, float)
CPPNS_PUSH_TWO_LOOP(cppns_push_two_loop_f64, double)
