// MinHash signatures for Hopper (sm_90a).
//
// Replaces: repro/kernels/minhash.py::minhash_pallas (the Pallas kernel
//   _kernel, which carries the running minimum across a sequential R grid).
// Bound on the H100 at the main path's shapes (C = 100k columns of R = 256
//   rows, P = 128 permutations): operations. The bytes are the (C, R) values
//   once (102 MB) and the (C, P) signatures (51 MB); the work is C·R·P =
//   3.3e9 evaluations of a·v + b mod 2^32, each a multiply-add and a min —
//   ~6.6e9 integer operations. The sentinel test belongs to the value: C·R
//   tests, not C·R·P. The multiply-add is an IMAD, which issues at half the
//   int32 rate (64 lanes/clk/SM), and the min shares its issue slots: on an
//   H100 SXM at 700 W, multiply-add chains each with a min run at 77% of
//   the bound with registers alone (int_rate.cu).
// Design:
//   - No test in the permutation loop. A repeat of a column's own value
//     cannot lower its minimum, and a sentinel cell counts as 0xFFFFFFFF,
//     which cannot either. So each sentinel cell (and each padding row of
//     the last tile) is staged as the column's first valid value, found once
//     per block; a column with no valid cell writes 0xFFFFFFFF. The inner
//     loop is one IMAD and one min per (column, row, permutation); ptxas
//     pairs the mins into 3-way VIMNMX3.
//   - Register blocking. A thread keeps the minima of CT = 4 columns x
//     PT = 4 permutations (its permutations strided by the block's lanes, so
//     stores coalesce) with their a and b in registers; one 128-bit shared
//     load brings 4 rows of a column and feeds 16 hashes.
//   - The rows stream through shared memory in tiles of TR: 4-byte cp.async
//     from the contiguous (columns, rows) block, then one pass that replaces
//     the sentinels; the first tile's copies overlap the search for each
//     column's first valid value.
//   - Two shapes of block, chosen by the column count. Wide (C >= 4096, the
//     ingest chunk): 128 threads over 16 columns x 128 permutations, every
//     thread over all rows. Narrow (uploads of 8 columns, re-signing): 256
//     threads over 8 columns x 32 permutations, the rows split over 16 slices
//     whose minima merge in shared memory (a min is exact and order-free),
//     and the permutations over blocks, so 8 columns fill 4 SMs, not one.
//   Arithmetic is uint32 with wrap-around, as on the TPU.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t SENTINEL = 0xFFFFFFFFu;
constexpr uint32_t NO_VALUE = 0xFFFFFFFFu;   // the signature of a column with no valid cell
constexpr int CT = 4;                 // columns a thread
constexpr int PT = 4;                 // permutations a thread
constexpr int TR = 256;               // rows a staged tile
constexpr int STRIDE = TR + 4;        // a tile column's pitch (16-byte aligned, no bank conflicts)
constexpr int WIDE_MIN_COLS = 4096;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// PL permutation lanes x CG column groups x S row slices; the block covers
// CG·CT columns and PL·PT permutations.
template <int PL, int CG, int S>
__global__ void __launch_bounds__(PL * CG * S)
minhash_kernel(const uint32_t* __restrict__ values, const uint32_t* __restrict__ a,
               const uint32_t* __restrict__ b, uint32_t* __restrict__ out, int n_cols,
               int n_rows, int n_perm) {
  constexpr int COLS = CG * CT, PERMS = PL * PT, THREADS = PL * CG * S;
  constexpr int WARPS = THREADS / 32, CW = (COLS + WARPS - 1) / WARPS;
  __shared__ __align__(16) uint32_t tile[COLS][STRIDE];
  __shared__ uint32_t fill[COLS];
  __shared__ bool empty[COLS];
  __shared__ uint32_t merged[S > 1 ? COLS * PERMS : 1];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pl = tid % PL, cg = (tid / PL) % CG, s = tid / (PL * CG);
  const int c0 = blockIdx.x * COLS, p0 = blockIdx.y * PERMS;

  // Copies rows [r0, r0 + rows) of the block's columns into the tile; padding
  // up to the next 4 rows, and columns past n_cols, are staged as sentinels.
  auto stage = [&](int r0, int rows) {
    const int rows4 = (rows + 3) & ~3;
#pragma unroll 4
    for (int i = tid; i < COLS * TR; i += THREADS) {
      const int c = i / TR, r = i % TR, col = c0 + c;
      if (r >= rows4) continue;
      if (col < n_cols && r < rows)
        cp_async4(&tile[c][r], values + (long long)col * n_rows + r0 + r);
      else
        tile[c][r] = SENTINEL;
    }
  };

  stage(0, min(TR, n_rows));
  // Each column's first valid value, one warp a column: the first 32 rows of
  // all of a warp's columns are loaded at once; a column with none there
  // walks on.
  {
    uint32_t x[CW];
#pragma unroll
    for (int k = 0; k < CW; ++k) {
      const int c = warp + WARPS * k, col = c0 + c;
      x[k] = (c < COLS && col < n_cols && lane < n_rows)
                 ? values[(long long)col * n_rows + lane] : SENTINEL;
    }
#pragma unroll
    for (int k = 0; k < CW; ++k) {
      const int c = warp + WARPS * k, col = c0 + c;
      if (c >= COLS) break;
      uint32_t v = x[k];
      unsigned valid = __ballot_sync(0xFFFFFFFFu, v != SENTINEL);
      for (int r = 32 + lane; !valid && col < n_cols && r - lane < n_rows; r += 32) {
        v = r < n_rows ? values[(long long)col * n_rows + r] : SENTINEL;
        valid = __ballot_sync(0xFFFFFFFFu, v != SENTINEL);
      }
      const uint32_t f = __shfl_sync(0xFFFFFFFFu, v, valid ? __ffs(valid) - 1 : 0);
      if (lane == 0) {
        fill[c] = valid ? f : 0u;
        empty[c] = !valid;
      }
    }
  }
  if constexpr (S > 1) {
    for (int i = tid; i < COLS * PERMS; i += THREADS) merged[i] = NO_VALUE;
  }
  __syncthreads();  // fill, empty and merged are set, also where there are no rows

  uint32_t ar[PT], br[PT], m[CT][PT];
#pragma unroll
  for (int j = 0; j < PT; ++j) {
    const int p = p0 + pl + PL * j;
    ar[j] = p < n_perm ? a[p] : 0u;
    br[j] = p < n_perm ? b[p] : 0u;
  }
#pragma unroll
  for (int ct = 0; ct < CT; ++ct)
#pragma unroll
    for (int j = 0; j < PT; ++j) m[ct][j] = NO_VALUE;

  for (int r0 = 0; r0 < n_rows; r0 += TR) {
    const int rows = min(TR, n_rows - r0);
    const int groups = (rows + 3) / 4;
    if (r0 > 0) {
      __syncthreads();  // the last tile's readers are done
      stage(r0, rows);
    }
    cp_async_wait_all();
    __syncthreads();
    // the one sentinel test a staged value gets
#pragma unroll 4
    for (int i = tid; i < COLS * TR; i += THREADS) {
      const int c = i / TR, r = i % TR;
      if (r < 4 * groups && tile[c][r] == SENTINEL) tile[c][r] = fill[c];
    }
    __syncthreads();
    for (int g = s; g < groups; g += S) {
      uint4 q[CT];
#pragma unroll
      for (int ct = 0; ct < CT; ++ct)
        q[ct] = *reinterpret_cast<const uint4*>(&tile[cg * CT + ct][4 * g]);
#pragma unroll
      for (int ct = 0; ct < CT; ++ct)
#pragma unroll
        for (int j = 0; j < PT; ++j) {
          m[ct][j] = min(m[ct][j], ar[j] * q[ct].x + br[j]);
          m[ct][j] = min(m[ct][j], ar[j] * q[ct].y + br[j]);
          m[ct][j] = min(m[ct][j], ar[j] * q[ct].z + br[j]);
          m[ct][j] = min(m[ct][j], ar[j] * q[ct].w + br[j]);
        }
    }
  }

  if constexpr (S > 1) {
#pragma unroll
    for (int ct = 0; ct < CT; ++ct)
#pragma unroll
      for (int j = 0; j < PT; ++j) atomicMin(&merged[(cg * CT + ct) * PERMS + pl + PL * j], m[ct][j]);
    __syncthreads();
    for (int i = tid; i < COLS * PERMS; i += THREADS) {
      const int c = i / PERMS, col = c0 + c, p = p0 + i % PERMS;
      if (col < n_cols && p < n_perm)
        out[(long long)col * n_perm + p] = empty[c] ? NO_VALUE : merged[i];
    }
  } else {
#pragma unroll
    for (int ct = 0; ct < CT; ++ct) {
      const int c = cg * CT + ct, col = c0 + c;
      if (col >= n_cols) continue;
#pragma unroll
      for (int j = 0; j < PT; ++j) {
        const int p = p0 + pl + PL * j;
        if (p < n_perm) out[(long long)col * n_perm + p] = empty[c] ? NO_VALUE : m[ct][j];
      }
    }
  }
}

template <int PL, int CG, int S>
void launch(const uint32_t* values, const uint32_t* a, const uint32_t* b, uint32_t* out,
            int n_cols, int n_rows, int n_perm, cudaStream_t stream) {
  constexpr int COLS = CG * CT, PERMS = PL * PT;
  const dim3 grid((n_cols + COLS - 1) / COLS, (n_perm + PERMS - 1) / PERMS);
  minhash_kernel<PL, CG, S><<<grid, PL * CG * S, 0, stream>>>(values, a, b, out, n_cols,
                                                              n_rows, n_perm);
}

}  // namespace

extern "C" {

// values (C, R) u32 bits, a/b (P,) u32 bits -> out (C, P) u32 bits.
// Returns cudaGetLastError() after the launch.
int freyja_minhash(const void* values, const void* a, const void* b, void* out,
                   int n_cols, int n_rows, int n_perm, void* stream) {
  if (n_cols == 0 || n_perm == 0) return 0;
  const auto* v = static_cast<const uint32_t*>(values);
  const auto* av = static_cast<const uint32_t*>(a);
  const auto* bv = static_cast<const uint32_t*>(b);
  auto* o = static_cast<uint32_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (n_cols >= WIDE_MIN_COLS)
    launch<32, 4, 1>(v, av, bv, o, n_cols, n_rows, n_perm, st);   // 16 columns x 128 perms
  else
    launch<8, 2, 16>(v, av, bv, o, n_cols, n_rows, n_perm, st);   // 8 columns x 32 perms
  return (int)cudaGetLastError();
}

}  // extern "C"
