// Banded-LSH bucket probe for Hopper (sm_90a).
//
// Replaces: repro/kernels/lsh_probe.py::lsh_probe_pallas (the Pallas kernel
//   _kernel: hit[q, c] = any_b(qkeys[q, b] == ckeys[c, b])).
// Bound on the H100 at the main path's shapes (Q = 64 queries, C = 100k
//   columns, B = 64 bands): operations, narrowly. The bytes are the (C, B)
//   corpus keys once (25.6 MB) and the (Q, C) int32 hit mask (25.6 MB),
//   ~15 us at 3.35 TB/s; the work is Q·C·B = 4.1e8 compares plus as many ors,
//   ~25 us at the integer rate. The tiered coarse scan (B = 16) is bound by
//   its bytes, the hit mask's above all.
//
// Design. The first kernel gave each thread one column and a block 8
// queries: a thread read its column's keys with a 256-byte stride from its
// neighbours (32 L1 wavefronts a warp load) and each key was read once per
// 8-query tile, 8 times in all, ~2,560 wavefronts per warp and 32 columns,
// at 10% of the bound. This kernel:
//
// 1. Reads every corpus key from memory once, coalesced. A block takes a
//    tile of 128 columns (one a thread) and copies its 128 x B keys, one
//    contiguous stream, into shared memory at a row pitch of B + 4 words
//    with 16-byte cp.async (B % 4 == 0 and 16-byte aligned keys), or at an
//    odd pitch with 4-byte cp.async; a (row, vector) counter stepped without
//    division places each copy. The pitch makes a thread's reads of its own
//    row conflict-free: with 16-byte loads (B + 4 words) eight lanes cover
//    the 32 banks; with 4-byte loads an odd pitch puts 32 lanes on 32 banks.
// 2. Scores the tile against every query, in groups of up to 64 queries
//    (up to 4096 keys: 16 queries at B = 256). At the main path's Q = 64
//    there is one group.
// 3. Compares on the integer pipe. For B = 16 and B = 64 (the coarse and
//    fine band counts) a thread moves its column's keys into registers
//    with B / 4 LDS.128; the query group sits beside the tile (B = 16) or
//    reuses the tile's shared memory (B = 64). For each query the thread
//    reads the query's keys as LDS.128 broadcasts (4 bands a load) and
//    folds the B compares into four chains of ISETP.EQ.OR on predicates.
//    Other B up to MAX_BANDS keep the column's keys in shared memory and
//    read them per query. Each query's hits are written as neighbouring
//    threads' neighbouring columns: coalesced int32 stores.
// 4. Sentinels: queries padded with PAD_QUERY and a corpus padded with
//    PAD_CORPUS hold different keys and never match. Columns past C in the
//    last tile and queries past Q are never written.
//
// On the H100 (700 W) the B = 64 path takes 122 registers a thread, 4 blocks
// an SM (782 tiles of 100k columns: 1.5 waves), and runs at about half its
// operations bound. What did not help there, each measured in one call
// beside this kernel: capping registers for 6 blocks an SM (80 registers
// spilled the keys: 4.7x slower), two columns a thread so that one query
// broadcast serves both (212 registers), persistent warps each copying and
// scoring its own 32 columns so that copies overlap compares (166
// registers), two or eight predicate chains instead of four.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;        // corpus columns of a tile, one a thread
constexpr int MAX_BANDS = 256;
constexpr int GROUP_KEYS = 4096;    // query keys a block holds at once
constexpr int MAX_GROUP = 64;       // queries a group holds at most
// Up to this B the block kernel keeps its query group beside the column
// tile (staged in the same copy) rather than in the tile's memory once the
// keys are in registers.
constexpr int OWN_QUERY_BANDS = 16;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Copy n_rows rows of n_bands keys, contiguous at src, into dst at `pitch`
// words a row, kV keys a copy (kV = 4 needs 16-byte aligned src and dst rows).
template <int kV>
__device__ __forceinline__ void stage_keys(uint32_t* dst, const uint32_t* src, int n_rows,
                                           int n_bands, int pitch) {
  const int vb = n_bands / kV;                 // copies a row
  const int n = n_rows * vb;
  const int step_r = THREADS / vb, step_b = THREADS % vb;
  int r = threadIdx.x / vb, b = threadIdx.x % vb;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    if (kV == 4)
      cp_async16(dst + r * pitch + 4 * b, src + 4 * i);
    else
      cp_async4(dst + r * pitch + b, src + i);
    r += step_r;
    b += step_b;
    if (b >= vb) {
      b -= vb;
      ++r;
    }
  }
}

// Copy a group of nq queries' keys (contiguous) to dst; 4-byte copies.
__device__ __forceinline__ void stage_queries(uint32_t* dst, const uint32_t* src, int n) {
  for (int i = threadIdx.x; i < n; i += THREADS) cp_async4(dst + i, src + i);
}

// Any band of kB keys k[] equal to the query's kB keys at q4 (16-byte
// broadcasts), folded into four predicate chains (two chains measured
// slower, eight no faster).
template <int kB>
__device__ __forceinline__ bool any_band(const uint32_t (&k)[kB], const uint4* q4) {
  bool h0 = false, h1 = false, h2 = false, h3 = false;
#pragma unroll
  for (int j = 0; j < kB / 4; ++j) {
    const uint4 v = q4[j];
    h0 |= k[4 * j] == v.x;
    h1 |= k[4 * j + 1] == v.y;
    h2 |= k[4 * j + 2] == v.z;
    h3 |= k[4 * j + 3] == v.w;
  }
  return (h0 | h1) | (h2 | h3);
}

// A column's kB keys from its 16-byte aligned row into registers (kB / 4
// LDS.128).
template <int kB>
__device__ __forceinline__ void load_keys(const uint32_t* row, uint32_t (&k)[kB]) {
  const uint4* r4 = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int j = 0; j < kB / 4; ++j) {
    const uint4 v = r4[j];
    k[4 * j] = v.x;
    k[4 * j + 1] = v.y;
    k[4 * j + 2] = v.z;
    k[4 * j + 3] = v.w;
  }
}

// B = kB (16 or 64) with 16-byte copies: the column's keys in registers, the
// query group beside the tile (B = 16) or in the tile's shared memory once
// the keys are read (B = 64).
template <int kB>
__global__ void __launch_bounds__(THREADS) lsh_probe_regs_kernel(
    const uint32_t* __restrict__ qkeys, const uint32_t* __restrict__ ckeys,
    int32_t* __restrict__ out, int n_queries, int n_cols, int group) {
  constexpr int PITCH = kB + 4;
  constexpr bool kOwn = kB <= OWN_QUERY_BANDS;
  extern __shared__ __align__(16) uint32_t probe_smem[];
  uint32_t* s_q = kOwn ? probe_smem + THREADS * PITCH : probe_smem;
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * THREADS;
  const int nc = min(THREADS, n_cols - c0);
  const int c = c0 + tid;
  stage_keys<4>(probe_smem, ckeys + (long long)c0 * kB, nc, kB, PITCH);
  if (kOwn) stage_queries(s_q, qkeys, min(group, n_queries) * kB);
  cp_async_wait_all();
  __syncthreads();
  uint32_t k[kB];                 // rows past nc hold stale words; never written out
  load_keys<kB>(probe_smem + tid * PITCH, k);
  for (int q0 = 0; q0 < n_queries; q0 += group) {
    const int nq = min(group, n_queries - q0);
    if (q0 > 0 || !kOwn) {
      __syncthreads();            // every thread is done with the buffer
      stage_queries(s_q, qkeys + (long long)q0 * kB, nq * kB);
      cp_async_wait_all();
      __syncthreads();
    }
    const uint4* q4 = reinterpret_cast<const uint4*>(s_q);
    int32_t* o = out + (long long)q0 * n_cols + c;
    for (int q = 0; q < nq; ++q, q4 += kB / 4, o += n_cols) {
      const bool hit = any_band<kB>(k, q4);
      if (c < n_cols) *o = hit ? 1 : 0;
    }
  }
}

// Any B up to MAX_BANDS: the column's keys stay in shared memory at `pitch`
// words a row (kV = 4: B + 4 words and 16-byte reads; kV = 1: an odd pitch),
// the query group after them.
template <int kV>
__global__ void __launch_bounds__(THREADS) lsh_probe_smem_kernel(
    const uint32_t* __restrict__ qkeys, const uint32_t* __restrict__ ckeys,
    int32_t* __restrict__ out, int n_queries, int n_cols, int n_bands, int pitch, int group) {
  extern __shared__ __align__(16) uint32_t probe_smem[];
  uint32_t* s_q = probe_smem + THREADS * pitch;          // 16-byte aligned: 128 x 4 bytes
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * THREADS;
  const int nc = min(THREADS, n_cols - c0);
  const int c = c0 + tid;
  stage_keys<kV>(probe_smem, ckeys + (long long)c0 * n_bands, nc, n_bands, pitch);
  const uint32_t* mine = probe_smem + tid * pitch;
  for (int q0 = 0; q0 < n_queries; q0 += group) {
    const int nq = min(group, n_queries - q0);
    if (q0) __syncthreads();
    stage_queries(s_q, qkeys + (long long)q0 * n_bands, nq * n_bands);
    cp_async_wait_all();
    __syncthreads();
    for (int q = 0; q < nq; ++q) {
      const uint32_t* qk = s_q + q * n_bands;
      bool hit = false;
      if (kV == 4) {
        const uint4* m4 = reinterpret_cast<const uint4*>(mine);
        const uint4* q4 = reinterpret_cast<const uint4*>(qk);
        for (int j = 0; j < n_bands / 4; ++j) {
          const uint4 a = m4[j], v = q4[j];
          hit |= (a.x == v.x) | (a.y == v.y) | (a.z == v.z) | (a.w == v.w);
        }
      } else {
        for (int b = 0; b < n_bands; ++b) hit |= mine[b] == qk[b];
      }
      if (c < n_cols) out[(long long)(q0 + q) * n_cols + c] = hit ? 1 : 0;
    }
  }
}

int group_of(int n_bands) {
  return std::min(MAX_GROUP, std::max(1, GROUP_KEYS / n_bands));
}

}  // namespace

extern "C" {

int freyja_lsh_probe_max_bands() { return MAX_BANDS; }

// qkeys (Q, B) u32 bits, ckeys (C, B) u32 bits -> out (Q, C) int32, on
// `stream`. Returns the first CUDA error (0 when none).
int freyja_lsh_probe(const void* qkeys, const void* ckeys, void* out, int n_queries,
                     int n_cols, int n_bands, void* stream) {
  if (n_queries == 0 || n_cols == 0 || n_bands == 0) return 0;
  if (n_bands > MAX_BANDS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qk = static_cast<const uint32_t*>(qkeys);
  const auto* ck = static_cast<const uint32_t*>(ckeys);
  auto* o = static_cast<int32_t*>(out);
  const unsigned blocks = (unsigned)((n_cols + THREADS - 1) / THREADS);
  const int group = group_of(n_bands);
  const bool vec = n_bands % 4 == 0 && (reinterpret_cast<uintptr_t>(ckeys) & 15) == 0;
  cudaError_t err;
  if (vec && (n_bands == 16 || n_bands == 64)) {
    auto kernel = n_bands == 16 ? lsh_probe_regs_kernel<16> : lsh_probe_regs_kernel<64>;
    const size_t tile = (size_t)THREADS * (n_bands + 4), queries = (size_t)group * n_bands;
    const size_t smem = sizeof(uint32_t) *
        (n_bands <= OWN_QUERY_BANDS ? tile + queries : std::max(tile, queries));
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, THREADS, smem, st>>>(qk, ck, o, n_queries, n_cols, group);
  } else {
    const int pitch = vec ? n_bands + 4 : (n_bands | 1);
    auto kernel = vec ? lsh_probe_smem_kernel<4> : lsh_probe_smem_kernel<1>;
    const size_t smem = sizeof(uint32_t) * ((size_t)THREADS * pitch + (size_t)group * n_bands);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, THREADS, smem, st>>>(qk, ck, o, n_queries, n_cols, n_bands, pitch, group);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
