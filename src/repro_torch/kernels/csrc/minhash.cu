// MinHash signatures for Hopper (sm_90a).
//
// Replaces: repro/kernels/minhash.py::minhash_pallas (the Pallas kernel
//   _kernel, which carries the running minimum across a sequential R grid).
// Bound on the H100 at the main path's shapes (C = 100k columns of R = 256
//   rows, P = 128 permutations): operations. The bytes are the (C, R) values
//   once (102 MB) and the (C, P) signatures (51 MB); the work is C·R·P =
//   3.3e9 evaluations of a·v + b mod 2^32, each a multiply-add, a sentinel
//   select and a min — ~1.3e10 integer operations.
// Design: one thread keeps the running minima of one permutation p for the
//   COLS columns of its block in registers. The block streams the columns'
//   rows through shared memory in tiles of ROWS, loaded coalesced by all of
//   its threads, and every thread reads each staged value as a broadcast —
//   the sequential R grid of the TPU kernel becomes this loop inside the
//   block. Arithmetic is uint32 with wrap-around, as on the TPU.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int COLS = 8;
constexpr int ROWS = 256;
constexpr int THREADS = 128;
constexpr uint32_t SENTINEL = 0xFFFFFFFFu;

__global__ void minhash_kernel(const uint32_t* __restrict__ values,
                               const uint32_t* __restrict__ a,
                               const uint32_t* __restrict__ b,
                               uint32_t* __restrict__ out, int n_cols, int n_rows,
                               int n_perm) {
  __shared__ uint32_t tile[COLS][ROWS];
  const int c0 = blockIdx.x * COLS;
  for (int p0 = 0; p0 < n_perm; p0 += THREADS) {
    const int p = p0 + threadIdx.x;
    const bool live = p < n_perm;
    const uint32_t ap = live ? a[p] : 0u;
    const uint32_t bp = live ? b[p] : 0u;
    uint32_t m[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) m[c] = 0xFFFFFFFFu;

    for (int r0 = 0; r0 < n_rows; r0 += ROWS) {
      __syncthreads();
      for (int i = threadIdx.x; i < COLS * ROWS; i += THREADS) {
        const int c = i / ROWS, r = i % ROWS;
        const int col = c0 + c, row = r0 + r;
        tile[c][r] = (col < n_cols && row < n_rows)
                         ? values[(long long)col * n_rows + row]
                         : SENTINEL;
      }
      __syncthreads();
      for (int r = 0; r < ROWS; ++r) {
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          const uint32_t v = tile[c][r];
          const uint32_t h = (v == SENTINEL) ? 0xFFFFFFFFu : ap * v + bp;
          m[c] = min(m[c], h);
        }
      }
    }
    if (live) {
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int col = c0 + c;
        if (col < n_cols) out[(long long)col * n_perm + p] = m[c];
      }
    }
  }
}

}  // namespace

extern "C" {

// values (C, R) u32 bits, a/b (P,) u32 bits -> out (C, P) u32 bits.
// Returns cudaGetLastError() after the launch.
int freyja_minhash(const void* values, const void* a, const void* b, void* out,
                   int n_cols, int n_rows, int n_perm, void* stream) {
  if (n_cols == 0 || n_perm == 0) return 0;
  dim3 grid((n_cols + COLS - 1) / COLS);
  minhash_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(values), static_cast<const uint32_t*>(a),
      static_cast<const uint32_t*>(b), static_cast<uint32_t*>(out), n_cols, n_rows,
      n_perm);
  return (int)cudaGetLastError();
}

}  // extern "C"
