// The card's rate for minhash.cu's inner loop, for the timing harness
// (chip_smoke.py phase 4, repro_torch.launch.bench_scorer): 16 independent
// chains a thread of x = x·a + b mod 2^32 (one IMAD each; a linear
// congruential step, which no compiler shortens), alone or each followed by
// a running min, as minhash's loop follows each hash. It replaces no TPU
// kernel and no path of the port calls it; it is built with the kernels so
// that the harness launches it through the same ctypes path.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CHAINS = 16;
constexpr int THREADS = 256;

template <bool WITH_MIN>
__global__ void __launch_bounds__(THREADS) lcg_kernel(uint32_t* __restrict__ out, int iters) {
  const uint32_t t = blockIdx.x * THREADS + threadIdx.x;
  uint32_t x[CHAINS], a[CHAINS], b[CHAINS], m[CHAINS];
#pragma unroll
  for (int i = 0; i < CHAINS; ++i) {
    x[i] = t * 2654435761u + i;
    a[i] = (t ^ (i * 0x9E3779B9u)) | 1u;
    b[i] = t + 7u * i;
    m[i] = 0xFFFFFFFFu;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < CHAINS; ++i) {
      x[i] = x[i] * a[i] + b[i];
      if (WITH_MIN) m[i] = min(m[i], x[i]);
    }
  }
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < CHAINS; ++i) r ^= x[i] ^ m[i];
  out[t] = r;
}

}  // namespace

extern "C" {

// `blocks` blocks of 256 threads, `iters` steps of 16 chains each: blocks ·
// 256 · iters · 16 multiply-adds (and as many mins if `with_min`) on
// `stream`; out holds blocks · 256 u32. Returns cudaGetLastError().
int freyja_int_rate(void* out, int with_min, int blocks, int iters, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<uint32_t*>(out);
  if (with_min)
    lcg_kernel<true><<<blocks, THREADS, 0, st>>>(o, iters);
  else
    lcg_kernel<false><<<blocks, THREADS, 0, st>>>(o, iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
