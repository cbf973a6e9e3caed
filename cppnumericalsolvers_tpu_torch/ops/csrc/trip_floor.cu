// The trip-floor calibration kernel, for Hopper.
//
// Replaces benchmarks/roofline.py::measure_loop_trip_overhead_us's
// tiny_kernel (the Pallas TPU kernel, :560; pallas_call :567): eight
// aliased buffers, each updated in place, o = i * 0.999 + 1e-6.  It computes
// what the plain PyTorch version
// cppnumericalsolvers_tpu_torch/ops/floors.py::trip_floor_reference computes
// (buf.mul_(0.999).add_(1e-6) on every buffer).  It does no solver work: it
// stands for the one kernel launch of a trip in benchmarks_torch/roofline.py's
// trip-floor loop (evaluation, one launch, one status read), so that the
// loop's cost per trip is the floor of the port's eager flat trip.
//
// Design.  One launch takes the eight buffer pointers (eight kernel
// parameters) and updates them all: a grid of (blocks, 8), block y owning
// buffer y, one element a thread.  At the calibration's (8, 128)
// float32 buffers that is 4 x 8 blocks of 256 threads.  The launch path is
// the one every kernel of the port takes (ops/_kernel.py::launch: ctypes,
// PyTorch's current stream, cudaGetLastError), so its cost is theirs.
//
// What bounds it on an H100: the launch itself.  Its bytes (8 x 1,024
// values read and written, 64 KiB in float32) take 0.02 us at 3.35 TB/s.
//
// Numerics: multiply, then add, each rounded (--fmad=false, ops/_build.py),
// the literals rounded to T first, as the plain version's two in-place ops
// round: bit-equal to it.

#include "common.cuh"

namespace {

constexpr int NBUF = 8;
constexpr int THREADS = 256;

// The eight buffers are eight kernel parameters: an array of pointers in
// the parameters, indexed by blockIdx.y, would be copied to local memory
// (a 64-byte stack frame in ptxas's report).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    trip_floor_kernel(T *b0, T *b1, T *b2, T *b3, T *b4, T *b5, T *b6,
                      T *b7, int count) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= count) return;
  const int y = blockIdx.y;
  T *p = y == 0 ? b0 : y == 1 ? b1 : y == 2 ? b2 : y == 3 ? b3
       : y == 4 ? b4 : y == 5 ? b5 : y == 6 ? b6 : b7;
  const T scaled = p[i] * T(0.999);
  p[i] = scaled + T(1e-6);
}

template <typename T>
int launch(void *const *b, int count, cudaStream_t stream) {
  if (count <= 0) return 0;
  const dim3 grid((count + THREADS - 1) / THREADS, NBUF);
  trip_floor_kernel<T><<<grid, THREADS, 0, stream>>>(
      (T *)b[0], (T *)b[1], (T *)b[2], (T *)b[3], (T *)b[4], (T *)b[5],
      (T *)b[6], (T *)b[7], count);
  return (int)cudaGetLastError();
}

}  // namespace

#define CPPNS_TRIP_FLOOR(NAME, T)                                            \
  extern "C" int NAME(void *b0, void *b1, void *b2, void *b3, void *b4,      \
                      void *b5, void *b6, void *b7, int count,               \
                      void *stream) {                                        \
    void *ptrs[NBUF] = {b0, b1, b2, b3, b4, b5, b6, b7};                     \
    return launch<T>(ptrs, count, (cudaStream_t)stream);                     \
  }

CPPNS_TRIP_FLOOR(cppns_trip_floor_f32, float)
CPPNS_TRIP_FLOOR(cppns_trip_floor_f64, double)
