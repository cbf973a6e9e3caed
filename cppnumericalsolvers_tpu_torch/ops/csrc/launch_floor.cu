// The launch-floor calibration kernel, for Hopper.
//
// Replaces benchmarks/roofline.py::measure_launch_overhead_us's tiny_kernel
// (the Pallas TPU kernel, :640; pallas_call :644): o = x + 1 on an (8, 128)
// float32 array.  It computes what the plain PyTorch version
// cppnumericalsolvers_tpu_torch/ops/floors.py::launch_floor_reference
// computes (torch.add(x, 1.0)).  benchmarks_torch/roofline.py chains it 200
// and 1,800 times, launched from the host and captured in a CUDA graph; the
// slope of the time over the chain's length is the cost of one launch of
// the port's kernels.
//
// Design: one block of 256 threads, each adding 1 to every 256th element,
// so the kernel's own time is as small as a launch allows.  The launch path
// is the one every kernel of the port takes (ops/_kernel.py::launch), and it
// does nothing that a CUDA-graph capture forbids: no synchronise, no host
// read, no allocation.
//
// What bounds it on an H100: the launch.  Its bytes (1,024 values read and
// written, 8 KiB in float32) take 0.002 us at 3.35 TB/s.
//
// Numerics: one rounded add (--fmad=false, ops/_build.py), bit-equal to the
// plain version.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    launch_floor_kernel(const T *__restrict__ x, T *__restrict__ out,
                        int count) {
  for (int i = threadIdx.x; i < count; i += THREADS) out[i] = x[i] + T(1);
}

template <typename T>
int launch(const void *x, void *out, int count, cudaStream_t stream) {
  if (count <= 0) return 0;
  launch_floor_kernel<T><<<1, THREADS, 0, stream>>>((const T *)x, (T *)out,
                                                    count);
  return (int)cudaGetLastError();
}

}  // namespace

#define CPPNS_LAUNCH_FLOOR(NAME, T)                                          \
  extern "C" int NAME(const void *x, void *out, int count, void *stream) {   \
    return launch<T>(x, out, count, (cudaStream_t)stream);                   \
  }

CPPNS_LAUNCH_FLOOR(cppns_launch_floor_f32, float)
CPPNS_LAUNCH_FLOOR(cppns_launch_floor_f64, double)
