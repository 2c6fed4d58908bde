// Banded-LSH probe against per-query gathered survivors for Hopper (sm_90a).
//
// Replaces: repro/kernels/lsh_probe.py::lsh_probe_gathered_pallas (the
//   Pallas kernel _gathered_kernel: hit[q, c'] = any_b(qkeys[q, b] ==
//   ckeys[q, c', b])), the fine probe of the tiered candidate stage.
// Bound on the H100 at the main path's shapes (Q = 64 queries, C' = 2048
//   survivors each, B = 64 bands): bytes. The gathered keys are read once
//   (Q x C' x B x 4 = 33.5 MB) and the hit mask written once (0.5 MB), ~10 us
//   at 3.35 TB/s; the 8.4e6 compares are far below the integer rate.
// Design: each query brings its own key rows, so nothing is shared across
//   queries; a block takes one query's tile of TILE_ROWS survivor rows, whose
//   keys lie contiguous in memory. The query's B keys sit in shared memory.
//   The block's threads walk the tile's TILE_ROWS x B keys as one flat array,
//   neighbouring threads on neighbouring words, so every load is coalesced
//   (lsh_probe.cu, one thread per row, reads with a 256 B stride instead).
//   When B is a multiple of 4 and the keys are 16-byte aligned, each load
//   takes 4 keys of one row (16 bytes) and the loop is unrolled, so a thread
//   keeps several loads in flight: a scalar walk with one load in flight per
//   thread reached 16% of the bound on an H100. A thread that finds a match sets its
//   row's flag in shared memory (all writers store the same 1), and the flags
//   are written out together. Rows padded with PAD_CORPUS and queries padded
//   with PAD_QUERY hold different sentinels and never match.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE_ROWS = 256;
constexpr int MAX_BANDS = 256;

__device__ __forceinline__ bool any_match(uint32_t k, const uint32_t* q) { return k == q[0]; }
__device__ __forceinline__ bool any_match(uint4 k, const uint32_t* q) {
  return (k.x == q[0]) | (k.y == q[1]) | (k.z == q[2]) | (k.w == q[3]);
}

// Vec is uint32_t (one key a load) or uint4 (four keys of one row a load,
// which needs n_bands % 4 == 0 and 16-byte aligned keys).
template <typename Vec>
__global__ void lsh_probe_gathered_kernel(const uint32_t* __restrict__ qkeys,
                                          const uint32_t* __restrict__ ckeys,
                                          int32_t* __restrict__ out, int n_rows,
                                          int n_bands, int n_tiles) {
  constexpr int V = sizeof(Vec) / sizeof(uint32_t);
  __shared__ uint32_t s_q[MAX_BANDS];
  __shared__ int32_t s_hit[TILE_ROWS];
  const long long q = blockIdx.x / n_tiles;
  const int r0 = (blockIdx.x % n_tiles) * TILE_ROWS;
  const int nr = min(TILE_ROWS, n_rows - r0);
  for (int b = threadIdx.x; b < n_bands; b += THREADS) s_q[b] = qkeys[q * n_bands + b];
  for (int r = threadIdx.x; r < TILE_ROWS; r += THREADS) s_hit[r] = 0;
  __syncthreads();

  const Vec* tile = reinterpret_cast<const Vec*>(ckeys + (q * n_rows + r0) * n_bands);
  const int n = nr * n_bands / V;
  // key index k = i * V = r * n_bands + b, advanced by THREADS * V keys
  // without a division
  const int step_r = THREADS * V / n_bands, step_b = THREADS * V % n_bands;
  int r = threadIdx.x * V / n_bands, b = threadIdx.x * V % n_bands;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += THREADS) {
    if (any_match(tile[i], s_q + b)) s_hit[r] = 1;
    r += step_r;
    b += step_b;
    if (b >= n_bands) {
      b -= n_bands;
      r += 1;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nr; j += THREADS) out[q * n_rows + r0 + j] = s_hit[j];
}

}  // namespace

extern "C" {

int freyja_lsh_probe_gathered_max_bands() { return MAX_BANDS; }

// qkeys (Q, B) u32 bits, ckeys (Q, C', B) u32 bits -> out (Q, C') int32.
// Returns cudaGetLastError() after the launch.
int freyja_lsh_probe_gathered(const void* qkeys, const void* ckeys, void* out,
                              int n_queries, int n_rows, int n_bands, void* stream) {
  if (n_queries == 0 || n_rows == 0) return 0;
  const int n_tiles = (n_rows + TILE_ROWS - 1) / TILE_ROWS;
  const long long n_blocks = (long long)n_queries * n_tiles;
  if (n_blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  const auto* q = static_cast<const uint32_t*>(qkeys);
  const auto* c = static_cast<const uint32_t*>(ckeys);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (n_bands % 4 == 0 && reinterpret_cast<uintptr_t>(ckeys) % 16 == 0)
    lsh_probe_gathered_kernel<uint4><<<(unsigned)n_blocks, THREADS, 0, s>>>(
        q, c, o, n_rows, n_bands, n_tiles);
  else
    lsh_probe_gathered_kernel<uint32_t><<<(unsigned)n_blocks, THREADS, 0, s>>>(
        q, c, o, n_rows, n_bands, n_tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
