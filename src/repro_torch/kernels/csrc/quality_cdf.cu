// Continuous join quality Q(A,B,s) for Hopper (sm_90a).
//
// Replaces: repro/kernels/quality_cdf.py::quality_cdf_pallas (the Pallas
//   kernel _kernel: the product of two truncated-Gaussian CDFs, element-wise
//   over a flattened pair axis, with the paper's parameters fixed).
// Bound on the H100 at the model path's shapes (the exact metric of Q = 64
//   queries against 100k columns, 6.4M pairs; labels of 128 queries against
//   ~400 columns): bytes, as chip_smoke.py counts it. J and K are read once
//   and Q written once, 12 bytes a pair (77 MB, ~0.023 ms at 3.35 TB/s), and
//   the count takes ~32 float32 operations a CDF. The SASS says otherwise:
//   the 4-pair loop issues ~160 instructions a pair (six IEEE divisions,
//   each MUFU.RCP + FFMA refinement + FCHK, and two erff), so at 6.4M pairs
//   the kernel is bound by instruction issue (~32M warp instructions over
//   528 schedulers, ~0.031 ms at 1.98 GHz). At the labels' 50k pairs the
//   time is the launch's and one pair's dependent chain.
//
// Arithmetic. The parameters are arguments (any QualityParams and
//   strictness, where the TPU kernel fixed the defaults): mu and sigma per
//   dimension, and the standardized truncation bounds (lo - mu) / sigma and
//   (hi - mu) / sigma, which the wrapper computes in double and rounds to
//   float32 as the plain version does. Phi(x) = 0.5 * (1 + erff(x / sqrt2)),
//   and every step of the plain version's float32 arithmetic is an
//   explicitly rounded intrinsic (__fsub_rn, __fdiv_rn, ...), so nvcc
//   contracts nothing into an FMA and the divisions are IEEE: the result is
//   bit-equal to the plain version on the card. The clamp to [0, 1] is a
//   compare-select that lets NaN through, as torch.clamp does (fminf/fmaxf
//   would drop it).
//
// Data movement. Two threads of each block evaluate Phi at the four bounds
//   and the two denominators into shared memory, on the device (a host erff
//   may differ by an ulp); the earlier kernel had every thread do it (4
//   erff and 4 divisions) before its first pair. A thread then takes 4
//   pairs a step with 16-byte loads of j and k and a 16-byte store, and
//   issues the next step's loads before this step's arithmetic (a register
//   double buffer), so memory traffic overlaps the erff and divisions. The
//   earlier kernel had one 8-byte pair in flight a thread and ran at about
//   the sum of its byte and arithmetic times. Views that are not 16-byte
//   aligned take a scalar head up to the boundary, n % 4 a scalar tail; j,
//   k and out at different offsets mod 16 bytes take the scalar walk (the
//   wrapper allocates out at j's offset). Below one block of 4-pair threads
//   per SM (the labels' 50k pairs) a thread takes one pair, which spreads
//   the work over more SMs. The grid is the SM count (passed by the
//   wrapper) times the resident blocks, queried once.
//
// Measured on the H100 (700 W; PERF.md): 0.0409 ms at 6.4M pairs (the
//   earlier kernel 0.0506; the same with a clean or a warm L2, as an
//   issue-bound kernel should be) and 0.0067 ms at the labels' shape, beside
//   an empty kernel's 0.0047 ms in the same harness (launch_floor.cu;
//   earlier 0.0073). Four
//   pairs a thread at 50k pairs took 0.0069 ms; 8 blocks an SM (a
//   32-register cap) took 0.0455 ms at 6.4M pairs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr float SQRT2 = 1.4142135623730951f;

__device__ __forceinline__ float phi(float x) {
  return __fmul_rn(0.5f, __fadd_rn(1.0f, erff(__fdiv_rn(x, SQRT2))));
}

// Truncation constants of one dimension: mu, sigma, Phi(a), Phi(b) - Phi(a).
struct Trunc {
  float mu, sigma, phi_lo, den;
};

__device__ __forceinline__ float trunc_cdf(float x, const Trunc& t) {
  const float num = __fsub_rn(phi(__fdiv_rn(__fsub_rn(x, t.mu), t.sigma)), t.phi_lo);
  const float v = __fdiv_rn(num, t.den);
  return v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
}

__device__ __forceinline__ float quality(float j, float k, const Trunc& tj, const Trunc& tk) {
  return __fmul_rn(trunc_cdf(j, tj), trunc_cdf(k, tk));
}

__device__ __forceinline__ float4 quality4(float4 j, float4 k, const Trunc& tj, const Trunc& tk) {
  return make_float4(quality(j.x, k.x, tj, tk), quality(j.y, k.y, tj, tk),
                     quality(j.z, k.z, tj, tk), quality(j.w, k.w, tj, tk));
}

// Elements [0, head) and [head + 4 * n_vec, n) one a thread; the n_vec
// float4 groups from element head on, 16-byte aligned, four a thread.
__global__ void __launch_bounds__(THREADS)
    quality_cdf_kernel(const float* __restrict__ j, const float* __restrict__ k,
                       float* __restrict__ out, long long n, long long head, long long n_vec,
                       float mu_j, float sigma_j, float a_j, float b_j, float mu_k,
                       float sigma_k, float a_k, float b_k) {
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long step = (long long)gridDim.x * THREADS;
  const float4* j4 = reinterpret_cast<const float4*>(j + head);
  const float4* k4 = reinterpret_cast<const float4*>(k + head);
  float4* o4 = reinterpret_cast<float4*>(out + head);
  // the first step's loads go out before the constants are computed
  long long i = first;
  float4 jv, kv;
  if (i < n_vec) {
    jv = j4[i];
    kv = k4[i];
  }
  __shared__ float s_t[2][2];                      // (phi_lo, den) of j and of k
  if (threadIdx.x < 2) {
    const bool is_j = threadIdx.x == 0;
    const float lo = phi(is_j ? a_j : a_k);
    s_t[threadIdx.x][0] = lo;
    s_t[threadIdx.x][1] = __fsub_rn(phi(is_j ? b_j : b_k), lo);
  }
  __syncthreads();
  const Trunc tj{mu_j, sigma_j, s_t[0][0], s_t[0][1]};
  const Trunc tk{mu_k, sigma_k, s_t[1][0], s_t[1][1]};

  const long long tail = head + 4 * n_vec;
  for (long long s = first; s < head + (n - tail); s += step) {
    const long long e = s < head ? s : tail + (s - head);
    out[e] = quality(j[e], k[e], tj, tk);
  }

  while (i < n_vec) {
    const long long next = i + step;
    float4 jn = jv, kn = kv;
    if (next < n_vec) {
      jn = j4[next];
      kn = k4[next];
    }
    o4[i] = quality4(jv, kv, tj, tk);
    jv = jn;
    kv = kn;
    i = next;
  }
}

int blocks_per_sm() {
  static const int n = [] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, quality_cdf_kernel, THREADS, 0);
    return b > 0 ? b : 1;
  }();
  return n;
}

}  // namespace

extern "C" {

// j, k (n,) f32 -> out (n,) f32; a_* = (lo - mu_*) / sigma_*, b_* = (hi -
// mu_*) / sigma_* as float32; n_sms: the card's SM count. Returns
// cudaGetLastError() after the launch.
int freyja_quality_cdf(const void* j, const void* k, void* out, long long n, float mu_j,
                       float sigma_j, float a_j, float b_j, float mu_k, float sigma_k,
                       float a_k, float b_k, int n_sms, void* stream) {
  if (n == 0) return 0;
  const long long sms = n_sms > 0 ? n_sms : 1;
  // offsets in floats mod 4 (16 bytes); the float4 groups start where j's do
  const auto phase = [](const void* p) { return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3); };
  // four pairs a thread once there is a block of them for every SM; below
  // that, one pair a thread spreads the work over more SMs (faster at the
  // labels' 50k pairs)
  long long head = n, n_vec = 0;
  if (n >= 4 * THREADS * sms && phase(j) == phase(k) && phase(j) == phase(out)) {
    head = (4 - phase(j)) & 3;
    if (head > n) head = n;
    n_vec = (n - head) / 4;
  }
  const long long work = n_vec > n - 4 * n_vec ? n_vec : n - 4 * n_vec;
  const long long want = (work + THREADS - 1) / THREADS, cap = blocks_per_sm() * sms;
  quality_cdf_kernel<<<(unsigned)(want < cap ? want : cap), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(j), static_cast<const float*>(k), static_cast<float*>(out),
      n, head, n_vec, mu_j, sigma_j, a_j, b_j, mu_k, sigma_k, a_k, b_k);
  return (int)cudaGetLastError();
}

}  // extern "C"
