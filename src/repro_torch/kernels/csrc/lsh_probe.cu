// Banded-LSH bucket probe for Hopper (sm_90a).
//
// Replaces: repro/kernels/lsh_probe.py::lsh_probe_pallas (the Pallas kernel
//   _kernel: hit[q, c] = any_b(qkeys[q, b] == ckeys[c, b])).
// Bound on the H100 at the main path's shapes (Q = 64 queries, C = 100k
//   columns, B = 64 bands): operations, narrowly. The bytes are the (C, B)
//   corpus keys once (25.6 MB) and the (Q, C) int32 hit mask (25.6 MB),
//   ~15 us at 3.35 TB/s; the work is Q·C·B = 4.1e8 compares plus as many ors,
//   ~25 us at the integer rate.
// Design: one thread computes the hits of one column for the QB queries of
//   its block. The block's (QB, B) query keys sit in shared memory and are
//   read as broadcasts; the thread walks its column's B keys once, comparing
//   each against the QB query keys of that band, so each corpus key is read
//   from device memory once per query tile rather than once per query.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_C = 128;
constexpr int QB = 8;
constexpr int MAX_BANDS = 256;

__global__ void lsh_probe_kernel(const uint32_t* __restrict__ qkeys,
                                 const uint32_t* __restrict__ ckeys,
                                 int32_t* __restrict__ out, int n_queries,
                                 int n_cols, int n_bands) {
  __shared__ uint32_t s_q[QB][MAX_BANDS];
  const int q0 = blockIdx.y * QB;
  const int nq = min(QB, n_queries - q0);
  for (int i = threadIdx.x; i < QB * n_bands; i += blockDim.x) {
    const int qi = i / n_bands, b = i % n_bands;
    // rows past the batch never match: they are not written below
    s_q[qi][b] = qi < nq ? qkeys[(long long)(q0 + qi) * n_bands + b] : 0u;
  }
  __syncthreads();
  const int c = blockIdx.x * BLOCK_C + threadIdx.x;
  if (c >= n_cols) return;
  const uint32_t* crow = ckeys + (long long)c * n_bands;
  bool hit[QB];
#pragma unroll
  for (int qi = 0; qi < QB; ++qi) hit[qi] = false;
  for (int b = 0; b < n_bands; ++b) {
    const uint32_t k = crow[b];
#pragma unroll
    for (int qi = 0; qi < QB; ++qi) hit[qi] |= (s_q[qi][b] == k);
  }
#pragma unroll
  for (int qi = 0; qi < QB; ++qi)
    if (qi < nq) out[(long long)(q0 + qi) * n_cols + c] = hit[qi] ? 1 : 0;
}

}  // namespace

extern "C" {

int freyja_lsh_probe_max_bands() { return MAX_BANDS; }

// qkeys (Q, B) u32 bits, ckeys (C, B) u32 bits -> out (Q, C) int32.
// Returns cudaGetLastError() after the launch.
int freyja_lsh_probe(const void* qkeys, const void* ckeys, void* out, int n_queries,
                     int n_cols, int n_bands, void* stream) {
  if (n_queries == 0 || n_cols == 0) return 0;
  dim3 grid((n_cols + BLOCK_C - 1) / BLOCK_C, (n_queries + QB - 1) / QB);
  lsh_probe_kernel<<<grid, BLOCK_C, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(qkeys), static_cast<const uint32_t*>(ckeys),
      static_cast<int32_t*>(out), n_queries, n_cols, n_bands);
  return (int)cudaGetLastError();
}

}  // extern "C"
