// An empty kernel: the launch floor of the timing harness (chip_smoke.py,
// repro_torch.launch.bench_scorer), the time a launch takes when its kernel
// does nothing. It replaces no TPU kernel and no path of the port calls it;
// it is built with the kernels so that the harness launches it through the
// same ctypes path, and a latency-bound kernel (quality_cdf at the labels'
// shape) is compared with it.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// One launch of an empty block of 256 threads on `stream`. Returns
// cudaGetLastError().
int freyja_launch_floor(void* stream) {
  empty_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
