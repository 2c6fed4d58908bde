// Oblivious-GBDT ensemble inference for Hopper (sm_90a).
//
// Replaces: repro/kernels/gbdt_infer.py::gbdt_infer_pallas (the Pallas kernel
//   _kernel: per tree a one-hot feature-select matmul, the level compares, a
//   bit-pack and a one-hot leaf-lookup matmul).
// Bound on the H100 at the model path's shapes (N = 6.4M rows of F = 23
//   features, the (64, 100k, 23) distance tensor; T = 50 trees of depth 5):
//   bytes. The rows are read once (589 MB, ~0.18 ms at 3.35 TB/s) and one
//   prediction per row written (25.6 MB); the T x D compares and T adds per
//   row are ~1e-2 ms of float32 work.
//
// Design. The first kernel (one block per 128 rows) ran at 15% of the bound,
// paced by the SM's shared-memory load pipe and by issue: every block
// reloaded the whole ensemble into shared memory, staged its rows with a
// division and a modulo per element, and walked with two uniform LDS a
// condition (feature id, threshold) beside the feature lookup, ~900
// wavefronts per warp and 32 rows. This kernel walks as the fused scorer
// does (fused_score.cuh):
//
// 1. Conditions in the constant bank. pack_conditions() turns each
//    condition into (byte offset of its feature in a row, threshold bits)
//    and cudaMemcpyToSymbolAsync copies them to the header's c_conds on the
//    launch stream (device to device, no host sync). The walk reads a
//    condition with one uniform constant load (ULDC.64). c_conds is one per
//    library: two launches with different ensembles on two streams at once
//    would race on it; the port launches on the current stream only.
// 2. Tiles of RPT x 128 rows (RPT = 4 rows a thread), staged contiguously
//    with no division. When F is odd (F_DIST = 23 is) the rows keep their
//    pitch F, so a tile is one contiguous stream: 16-byte cp.async when the
//    input is 16-byte aligned (a 512-row tile of 23 features is 47,104
//    bytes, so every tile of an aligned input is aligned), 4-byte cp.async
//    otherwise. When F is even the rows go to pitch F + 1, copied word by
//    word with a (row, feature) counter stepped without division. An odd
//    pitch makes the 32 lanes' lookups of one feature of 32 consecutive
//    rows hit 32 banks.
// 3. The walk: per condition one ULDC.64, then RPT feature lookups
//    (LDS [row + uniform offset]) and RPT compares, so one constant load
//    serves RPT rows; per tree one leaf LDS a row. A thread owns rows
//    tid + j x 128, so the lanes of a warp read consecutive rows and store
//    consecutive predictions. The leaves sit in shared memory, copied once
//    per block. The compare is one FSET to 1.0f / 0.0f and the leaf index
//    is built with FFMA on the FMA pipe: `cond ? 1 << l : 0` compiled to
//    FSETP, SEL and IADD3, all on the ALU pipe beside the compares, and ran
//    13% slower. The tree loop is unrolled by 2.
// 4. Persistent grid: SM count (passed by the wrapper) x
//    cudaOccupancyMaxActiveBlocksPerMultiprocessor blocks walk tiles
//    gridDim.x apart. On the H100 at F = 23, T = 50, D = 5 a block holds
//    53.5 KB (the tile and 6.4 KB of leaves) and the card reports 4 blocks
//    an SM (16 warps). One tile buffer: a second one (2 blocks an SM) and
//    per-warp tiles each measured slower, as did 3 or 8 rows a thread.
// 5. Nothing refused that the first kernel took: an ensemble with more than
//    MAX_CONDS conditions, or whose leaves do not fit beside the tile, is
//    scored in chunks of trees, in tree order, each launch adding onto the
//    sums the previous one wrote; a row too wide for a 512-row tile beside
//    one tree's leaves is tiled 128 rows at a time (RPT = 1).
//
// Exactness (ref.gbdt_infer_ref, the arithmetic of the header's tree_walk):
// each sum starts from `base` and adds the leaves in tree order with plain
// float adds (no TF32, no fast-math); each compare is x >= thr on the same
// float32 value (NaN takes bit 0, -0.0 >= 0.0 holds); the float leaf index
// holds small integers exactly. A chunked ensemble stores and reloads the
// float32 partial sum, which is the same value.

#include "fused_score.cuh"

namespace {

using freyja_fused::MAX_CONDS;
using freyja_fused::MAX_SMEM;

constexpr int THREADS = 128;
constexpr int RPT = 4;            // rows a thread walks at once
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// x >= thr as 1.0f or 0.0f: one FSET (an ordered compare: NaN gives 0.0f,
// -0.0 >= 0.0 gives 1.0f), where `cond ? bit : 0` costs an FSETP and a SEL.
__device__ __forceinline__ float ge_one(float x, float thr) {
  float m;
  asm("set.ge.f32.f32 %0, %1, %2;" : "=f"(m) : "f"(x), "f"(thr));
  return m;
}

int row_pitch(int n_feats) { return n_feats | 1; }

// Shared memory of one launch: the block's tiles of rpt rows a thread (a
// multiple of 16 bytes), then the leaves of its n_trees trees.
size_t smem_bytes(int n_feats, int rpt, int n_trees, int depth) {
  return sizeof(float) * (size_t)rpt * THREADS * row_pitch(n_feats) +
         (sizeof(float) << depth) * (size_t)n_trees;
}

int rows_per_thread(int n_feats, int depth) {
  return smem_bytes(n_feats, RPT, 1, depth) <= MAX_SMEM ? RPT : 1;
}

// Trees per launch: all of them, unless their conditions overflow c_conds or
// their leaves the shared memory (0 if one tree's leaves do not fit).
int trees_per_launch(int n_feats, int n_trees, int depth) {
  int chunk = n_trees;
  if (depth > 0) chunk = std::min(chunk, MAX_CONDS / depth);
  const size_t fixed = smem_bytes(n_feats, rows_per_thread(n_feats, depth), 0, depth);
  const size_t fit = fixed < MAX_SMEM ? (MAX_SMEM - fixed) / (sizeof(float) << depth) : 0;
  return (int)std::min((size_t)chunk, fit);
}

// Copy nn rows of x at src into the tile at `pitch` words a row: every
// thread issues its share and waits for its own copies.
template <bool kContig>
__device__ __forceinline__ void stage_rows(const float* src, float* s_x, int nn, int n_feats,
                                           int pitch, bool vec16) {
  const int tid = threadIdx.x;
  const int nw = nn * n_feats;
  if (kContig) {                               // pitch == n_feats: one stream
    int i0 = 0;
    if (vec16) {
      const int n4 = nw >> 2;
      for (int i = tid; i < n4; i += THREADS) cp_async16(s_x + 4 * i, src + 4 * i);
      i0 = n4 << 2;
    }
    for (int i = i0 + tid; i < nw; i += THREADS) freyja_fused::cp_async4(s_x + i, src + i);
  } else {                                     // pitch n_feats + 1: word i is (r, f)
    const int step_r = THREADS / n_feats, step_f = THREADS % n_feats;
    int r = tid / n_feats, f = tid % n_feats;
    for (int i = tid; i < nw; i += THREADS) {
      freyja_fused::cp_async4(s_x + r * pitch + f, src + i);
      r += step_r;
      f += step_f;
      if (f >= n_feats) {
        f -= n_feats;
        ++r;
      }
    }
  }
  freyja_fused::cp_async_wait_all();
}

// tree_walk's sums over the ensemble in c_conds for kR rows at once (row j's
// features at xr[j]), each from acc[j]: one constant load serves kR rows.
// The leaf index is built on the FMA pipe from the deepest level up,
// fi = 2 fi + (x >= thr), exact in float32 (fi < 2^15), and read back as an
// integer through the bits of fi + 2^23; the compares stay on the ALU pipe.
template <int kDepth, int kR>
__device__ __forceinline__ void walk_rows(const char* (&xr)[kR], const float* leaves,
                                          float (&acc)[kR], int n_trees, int depth_rt) {
  const int depth = kDepth ? kDepth : depth_rt;
#pragma unroll 2
  for (int t = 0; t < n_trees; ++t) {
    float fi[kR] = {};
#pragma unroll
    for (int l = depth - 1; l >= 0; --l) {
      const int2 c = freyja_fused::c_conds[t * depth + l];
#pragma unroll
      for (int j = 0; j < kR; ++j)
        fi[j] = fmaf(fi[j], 2.0f, ge_one(*reinterpret_cast<const float*>(xr[j] + c.x),
                                         __int_as_float(c.y)));
    }
#pragma unroll
    for (int j = 0; j < kR; ++j)
      acc[j] = acc[j] + leaves[(t << depth) + (__float_as_int(fi[j] + 8388608.0f) - 0x4B000000)];
  }
}

template <int kDepth, int kR, bool kContig>
__global__ void __launch_bounds__(THREADS) gbdt_infer_kernel(
    const float* __restrict__ x, const float* __restrict__ leaves, float base,
    bool accumulate, float* __restrict__ out, long long n_rows, int n_feats, int pitch,
    long long n_tiles, int n_trees, int depth, bool vec16) {
  constexpr int TILE = kR * THREADS;
  extern __shared__ __align__(16) float rows_smem[];
  float* s_x = rows_smem;                                  // [TILE][pitch]
  float* s_leaves = rows_smem + TILE * pitch;              // [n_trees << depth]
  const int tid = threadIdx.x;
  for (int i = tid; i < (n_trees << depth); i += THREADS) s_leaves[i] = leaves[i];

  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long r0 = t * TILE;
    const int nn = (int)min((long long)TILE, n_rows - r0);
    stage_rows<kContig>(x + r0 * n_feats, s_x, nn, n_feats, pitch, vec16);
    __syncthreads();                           // tile t (and the leaves) landed

    const char* xr[kR];
    float acc[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int row = min(tid + j * THREADS, nn - 1);   // a ragged tile repeats its last row
      xr[j] = reinterpret_cast<const char*>(s_x + row * pitch);
      acc[j] = accumulate ? out[r0 + row] : base;
    }
    walk_rows<kDepth, kR>(xr, s_leaves, acc, n_trees, depth);
#pragma unroll
    for (int j = 0; j < kR; ++j)
      if (tid + j * THREADS < nn) out[r0 + tid + j * THREADS] = acc[j];
    __syncthreads();                           // the tile is free for the next one
  }
}

using Kernel = void (*)(const float*, const float*, float, bool, float*, long long, int, int,
                        long long, int, int, bool);

template <int kR, bool kContig>
Kernel pick_depth(int depth) {
  return depth == 5 ? gbdt_infer_kernel<5, kR, kContig> : gbdt_infer_kernel<0, kR, kContig>;
}

Kernel pick(int depth, int rpt, bool contig) {
  if (rpt == RPT) return contig ? pick_depth<RPT, true>(depth) : pick_depth<RPT, false>(depth);
  return contig ? pick_depth<1, true>(depth) : pick_depth<1, false>(depth);
}

}  // namespace

extern "C" {

// Shared memory of the largest launch scoring an n_trees x depth ensemble
// over n_feats features; above the 227 KB a block may hold only when one
// tree's leaves do not fit beside a 128-row tile (the wrapper refuses those).
long long freyja_gbdt_infer_smem(int n_feats, int n_trees, int depth) {
  const int chunk = trees_per_launch(n_feats, n_trees, depth);
  return (long long)smem_bytes(n_feats, rows_per_thread(n_feats, depth),
                               chunk >= 1 ? chunk : std::min(n_trees, 1), depth);
}

// x (N, F) f32, feats/thrs (T, D) i32/f32, leaves (T, 2^D) f32 -> out (N,)
// f32, on `stream`; n_sms: the card's SM count. Returns the first CUDA error
// (0 when none).
int freyja_gbdt_infer(const void* x, const void* feats, const void* thrs,
                      const void* leaves, float base, void* out, long long n_rows,
                      int n_feats, int n_trees, int depth, int n_sms, void* stream) {
  if (n_rows == 0) return 0;
  const int chunk = trees_per_launch(n_feats, n_trees, depth);
  if (chunk < 1 && n_trees > 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rpt = rows_per_thread(n_feats, depth);
  const int pitch = row_pitch(n_feats);
  const bool vec16 = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const long long tile = (long long)rpt * THREADS;
  const long long n_tiles = (n_rows + tile - 1) / tile;
  if (n_sms < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;

  int t0 = 0;
  do {
    const int nt = std::min(chunk, n_trees - t0);
    const size_t conds = (size_t)nt * depth;
    if (conds) {
      freyja_fused::pack_conditions<<<(unsigned)((conds + 255) / 256), 256, 0, st>>>(
          static_cast<const int32_t*>(feats) + (size_t)t0 * depth,
          static_cast<const float*>(thrs) + (size_t)t0 * depth, (int)conds, (int)sizeof(float));
      void* staged = nullptr;
      err = cudaGetLastError();
      if (err == cudaSuccess) err = cudaGetSymbolAddress(&staged, freyja_fused::g_conds);
      if (err == cudaSuccess)
        err = cudaMemcpyToSymbolAsync(freyja_fused::c_conds, staged, conds * sizeof(int2), 0,
                                      cudaMemcpyDeviceToDevice, st);
      if (err != cudaSuccess) return (int)err;
    }
    const Kernel kernel = pick(depth, rpt, pitch == n_feats);
    const size_t smem = smem_bytes(n_feats, rpt, nt, depth);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long grid = std::min(n_tiles, (long long)per_sm * n_sms);
    kernel<<<(unsigned)grid, THREADS, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(leaves) + ((size_t)t0 << depth),
        base, t0 > 0, static_cast<float*>(out), n_rows, n_feats, pitch, n_tiles, nt, depth,
        vec16);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    t0 += nt;
  } while (t0 < n_trees);
  return 0;
}

}  // extern "C"
