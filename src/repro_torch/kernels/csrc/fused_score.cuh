// Body of the fused profile-distance + oblivious-GBDT scorer, shared by
// fused_score.cu (float32 corpus) and fused_score_q.cu (int8 or float16
// sidecar), the device function profile_distance.cu calls, and the
// ensemble's constant arrays that gbdt_infer.cu walks too.
//
// distance_features() (called by profile_distance.cu) and tree_walk() (the
// arithmetic ref.gbdt_infer_ref mirrors) keep the arithmetic of the first
// scorer; the scorer below and gbdt_infer.cu compute the same features and
// the same walk, bit for bit, in their own device functions (row_features,
// walk_ensemble; gbdt_infer.cu's walk_rows).
//
// The scorer's design. The pipe that paced the first scorer was the SM's
// shared L1/shared-memory load pipe, not its arithmetic: per warp and 32
// pairs it issued ~500 uniform shared loads of the tree tables, ~250 feature
// lookups and ~700 wavefronts of uncoalesced corpus-row loads (an 84-byte
// stride between threads, reloaded for each of a block's queries), about
// 1,550 wavefronts in all. This body takes the tables and the rows off it:
//
// 1. Tiles. A tile is TILE_N corpus rows (one per thread) and the queries
//    scored against them: TILE_Q queries of a shared corpus (query stride
//    0), one query of a gathered corpus (stride M, where each query has its
//    own rows). A block copies a tile's rows and query profiles into shared
//    memory as contiguous streams with 4-byte cp.async (neighbouring threads
//    copy neighbouring words), reads its row once at an odd word pitch (21
//    or 11 words, conflict-free; the 21- and 42-byte sidecar rows through a
//    funnel shift), dequantizes it once with __fmul_rn and keeps it in 32
//    registers for all the tile's queries.
// 2. Tables in the constant bank. pack_conditions() turns each condition
//    into (byte offset of its feature in a thread's feature column, threshold
//    bits), and cudaMemcpyToSymbolAsync copies them to c_conds on the launch
//    stream (device to device, stream-ordered, no host sync). The walk reads
//    a condition with one uniform constant load (ULDC.64) and its feature
//    with one LDS at [thread column + uniform offset]. The uniform constant
//    path has a throughput of its own, which one pair per load saturated, so
//    a thread walks QPT queries of a shared-corpus tile at once and each
//    constant load serves QPT pairs. The constant arrays are one per
//    library: two launches of one scorer with different ensembles on two
//    streams at once would race on them; the port launches on the current
//    stream only. The leaves stay in shared memory (their index differs per
//    thread). An ensemble with more than MAX_CONDS conditions, or whose
//    leaves do not fit beside the tile, is scored in chunks of trees, in
//    tree order: each chunk's launch starts from the sums the previous one
//    wrote, so the float32 sum is the same.
// 3. Persistent grid. The grid is the card's SM count (passed by the
//    wrapper) times cudaOccupancyMaxActiveBlocksPerMultiprocessor; each block walks tiles
//    gridDim.x apart and copies the leaves to shared memory once. On the
//    H100 at T = 50, D = 5 a shared-corpus block (four queries' feature
//    columns) holds 72 KB (float32) or 64-67 KB (int8, fp16) and 96
//    registers a thread: 3 blocks an SM, bound by shared memory; a
//    gathered-corpus block (one query's columns) holds 29-37 KB and 94-96
//    registers: 5 blocks an SM, bound by registers. One tile buffer: the
//    other resident blocks score while one copies (a second buffer
//    measured no faster).
// 4. What stays in shared memory per pair: the 23 features in a per-thread
//    column (23 stores), read back by the T x D conditions, and the T leaf
//    loads: ~330 wavefronts per warp and 32 pairs.
//
// Exactness (the plain versions in ref.py): each sum starts from `base` and
// adds the leaves in tree order with plain float adds; the word overlap is
// (float)count / 10.0f with IEEE division; each compare is x >= thr on the
// same float32 value (NaN takes bit 0, -0.0 >= 0.0 holds). A sidecar element
// is widened to float32 (exact for int8 and float16) and multiplied by its
// feature's scale with __fmul_rn: the plain version rounds that product
// before it subtracts it from the query's value, and __fmul_rn keeps the
// compiler from contracting the two into one FMA, which would round once
// and could flip a GBDT leaf.

#pragma once

#include <algorithm>
#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace freyja_fused {

constexpr int F_NUM = 21;
constexpr int N_FREQ = 10;
constexpr int F_WORDS = 11;
constexpr int F_DIST = 23;
constexpr int BLOCK_N = 128;
constexpr int BLOCK_Q = 8;
constexpr uint32_t SENTINEL = 0xFFFFFFFFu;

__device__ __forceinline__ float dequant(float v, float) { return v; }
__device__ __forceinline__ float dequant(int8_t v, float s) {
  return __fmul_rn(static_cast<float>(v), s);
}
__device__ __forceinline__ float dequant(__half v, float s) {
  return __fmul_rn(__half2float(v), s);
}

// The F_DIST distance features of one (query, corpus row) pair, written to
// x[f * stride]: |zq - zc| per numeric slot (the corpus element dequantized
// first), the top-10 word overlap as (float)count / 10.0f with IEEE division,
// and first-word equality; the sentinel never matches.
template <typename T>
__device__ __forceinline__ void distance_features(
    const float* zq, const uint32_t* wq, const T* zrow, const float* scale,
    const uint32_t* wrow, float* x, int stride) {
#pragma unroll
  for (int f = 0; f < F_NUM; ++f) x[f * stride] = fabsf(zq[f] - dequant(zrow[f], scale[f]));

  uint32_t cw[N_FREQ];
#pragma unroll
  for (int j = 0; j < N_FREQ; ++j) cw[j] = wrow[j];
  int count = 0;
#pragma unroll
  for (int i = 0; i < N_FREQ; ++i) {
    const uint32_t a = wq[i];
    bool hit = false;
#pragma unroll
    for (int j = 0; j < N_FREQ; ++j) hit |= (a == cw[j]);
    count += (hit && a != SENTINEL) ? 1 : 0;
  }
  x[F_NUM * stride] = (float)count / 10.0f;
  const uint32_t fa = wq[N_FREQ];
  x[(F_NUM + 1) * stride] = (fa == wrow[N_FREQ] && fa != SENTINEL) ? 1.0f : 0.0f;
}

// Oblivious-GBDT prediction for one feature row read as x[f * stride]:
// base + sum over trees, in tree order with plain float adds, of
// leaves[t][sum_l (x[feats[t][l]] >= thrs[t][l]) << l].
__device__ __forceinline__ float tree_walk(const float* x, int stride,
                                           const int32_t* feats, const float* thrs,
                                           const float* leaves, float base,
                                           int n_trees, int depth) {
  const int n_leaves = 1 << depth;
  float acc = base;
  for (int t = 0; t < n_trees; ++t) {
    int idx = 0;
    for (int l = 0; l < depth; ++l) {
      const int k = t * depth + l;
      idx |= (x[feats[k] * stride] >= thrs[k]) ? (1 << l) : 0;
    }
    acc = acc + leaves[t * n_leaves + idx];
  }
  return acc;
}

// ---------------------------------------------------------------------------
// The scorer
// ---------------------------------------------------------------------------

constexpr int TILE_N = 128;      // corpus rows of a tile, one per thread
constexpr int TILE_Q = 16;       // queries of a shared-corpus tile
constexpr int QPT = 4;           // queries a thread walks at once (shared corpus)
constexpr int Q_WORDS = 32;      // a staged query: 21 z values, 11 words
constexpr int MAX_CONDS = 4096;  // conditions the constant arrays hold
constexpr size_t MAX_SMEM = 232448;  // dynamic shared memory a block may hold
constexpr int X_BYTES = F_DIST * TILE_N * (int)sizeof(float);  // one query's feature columns

// One condition of the ensemble: the byte offset of its feature from a
// thread's first feature (feature id x the caller's feature stride in bytes:
// TILE_N x 4 in the scorer's feature columns, 4 in gbdt_infer.cu's rows) and
// its threshold's bits. pack_conditions() writes them to g_conds, which is
// copied to c_conds. Both arrays are one per library (per .cu file).
__constant__ int2 c_conds[MAX_CONDS];
__device__ int2 g_conds[MAX_CONDS];

__global__ void pack_conditions(const int32_t* __restrict__ feats,
                                const float* __restrict__ thrs, int n, int stride_bytes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) g_conds[i] = make_int2(feats[i] * stride_bytes, __float_as_int(thrs[i]));
}

// 32-bit words of the tile buffer: the queries (16-byte aligned first), the
// corpus numeric rows (up to 3 lead bytes when a sidecar tile does not start
// on a word, and one word read past the end by the funnel shift), the words.
template <typename T>
struct TileLayout {
  static constexpr int ROW_BYTES = F_NUM * (int)sizeof(T);
  static constexpr int ROW_WORDS = (ROW_BYTES + 3) / 4;
  static constexpr int Q = TILE_Q * Q_WORDS;
  static constexpr int Z = ((3 + TILE_N * ROW_BYTES + 3) / 4 + 1 + 3) / 4 * 4;
  static constexpr int W = TILE_N * F_WORDS;
  static constexpr int WORDS = Q + Z + W;
};

// Shared memory of one launch scoring `n_trees` trees of `depth`, kq
// queries a thread: the tile buffer, kq queries' feature columns, the
// scales, the leaves.
template <typename T>
inline size_t smem_bytes(int n_trees, int depth, int kq = QPT) {
  return sizeof(uint32_t) * TileLayout<T>::WORDS + (size_t)kq * X_BYTES +
         sizeof(float) * 32 + (sizeof(float) << depth) * (size_t)n_trees;
}

// Trees per launch: all of them, unless their conditions overflow the
// constant arrays or their leaves the shared memory (then 0 if one tree's
// leaves do not fit).
template <typename T>
inline int trees_per_launch(int n_trees, int depth) {
  int chunk = n_trees;
  if (depth > 0) chunk = std::min(chunk, MAX_CONDS / depth);
  const size_t fixed = smem_bytes<T>(0, depth);
  const size_t per_tree = sizeof(float) << depth;
  const size_t fit = fixed < MAX_SMEM ? (MAX_SMEM - fixed) / per_tree : 0;
  return (int)std::min((size_t)chunk, fit);
}

// Shared memory of the largest launch that scores an n_trees x depth
// ensemble; above MAX_SMEM when one tree's leaves do not fit.
template <typename T>
inline long long launch_smem(int n_trees, int depth) {
  const int chunk = trees_per_launch<T>(n_trees, depth);
  return (long long)smem_bytes<T>(chunk >= 1 ? chunk : std::min(n_trees, 1), depth);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Element f of a row whose bytes sit in 32-bit words `al`.
__device__ __forceinline__ float element(const uint32_t* al, int f, float) {
  return __uint_as_float(al[f]);
}
__device__ __forceinline__ int8_t element(const uint32_t* al, int f, int8_t) {
  return (int8_t)((al[f >> 2] >> (8 * (f & 3))) & 0xFFu);
}
__device__ __forceinline__ __half element(const uint32_t* al, int f, __half) {
  return __ushort_as_half((unsigned short)((al[f >> 1] >> (16 * (f & 1))) & 0xFFFFu));
}

struct Scorer {
  const float* zq;
  const uint32_t* wq;
  const void* zc;
  const uint32_t* wc;
  float* out;
  int n_queries, n_cols;
  long long q_stride_rows;
  int n_cb, q_per_tile;
};

// Which rows and queries tile t covers.
struct Tile {
  int q0, nq, n0, nn;
  long long row0;
};

__device__ __forceinline__ Tile tile_of(const Scorer& s, long long t) {
  Tile g;
  const int qg = (int)(t / s.n_cb);
  g.n0 = (int)(t % s.n_cb) * TILE_N;
  g.q0 = qg * s.q_per_tile;
  g.nq = min(s.q_per_tile, s.n_queries - g.q0);
  g.nn = min(TILE_N, s.n_cols - g.n0);
  g.row0 = (long long)g.q0 * s.q_stride_rows + g.n0;
  return g;
}

// Byte offset of a sidecar tile's first row within its first word.
template <typename T>
__device__ __forceinline__ int tile_lead(const Scorer& s, const Tile& g) {
  const T* src = static_cast<const T*>(s.zc) + g.row0 * F_NUM;
  return (int)(reinterpret_cast<uintptr_t>(src) & 3);
}

// Copy tile g into `buf`: every thread issues its share of 4-byte cp.async
// copies, neighbouring threads on neighbouring words, then waits for its own.
template <typename T>
__device__ __forceinline__ void stage_tile(const Scorer& s, const Tile& g, uint32_t* buf) {
  using L = TileLayout<T>;
  const int tid = threadIdx.x;
  uint32_t* bq = buf;
  uint32_t* bz = buf + L::Q;
  uint32_t* bw = bz + L::Z;
  for (int i = tid; i < g.nq * F_NUM; i += TILE_N)
    cp_async4(bq + (i / F_NUM) * Q_WORDS + i % F_NUM, s.zq + (long long)g.q0 * F_NUM + i);
  for (int i = tid; i < g.nq * F_WORDS; i += TILE_N)
    cp_async4(bq + (i / F_WORDS) * Q_WORDS + F_NUM + i % F_WORDS,
              s.wq + (long long)g.q0 * F_WORDS + i);
  const int lead = tile_lead<T>(s, g);
  const uint32_t* zsrc = reinterpret_cast<const uint32_t*>(
      reinterpret_cast<const unsigned char*>(static_cast<const T*>(s.zc) + g.row0 * F_NUM) - lead);
  const int nz = (lead + g.nn * L::ROW_BYTES + 3) / 4;
  for (int i = tid; i < nz; i += TILE_N) cp_async4(bz + i, zsrc + i);
  const uint32_t* wsrc = s.wc + g.row0 * F_WORDS;
  for (int i = tid; i < g.nn * F_WORDS; i += TILE_N) cp_async4(bw + i, wsrc + i);
  cp_async_wait_all();
}

// The 23 features of (query record qrec, this thread's row zr/wr) into the
// thread's column x[f * TILE_N], with distance_features' arithmetic.
__device__ __forceinline__ void row_features(const uint32_t* qrec, const float* zr,
                                             const uint32_t* wr, float* x) {
  float qv[Q_WORDS];
  const float4* q4 = reinterpret_cast<const float4*>(qrec);
#pragma unroll
  for (int j = 0; j < Q_WORDS / 4; ++j) {
    const float4 v = q4[j];
    qv[4 * j] = v.x;
    qv[4 * j + 1] = v.y;
    qv[4 * j + 2] = v.z;
    qv[4 * j + 3] = v.w;
  }
#pragma unroll
  for (int f = 0; f < F_NUM; ++f) x[f * TILE_N] = fabsf(qv[f] - zr[f]);
  int count = 0;
#pragma unroll
  for (int i = 0; i < N_FREQ; ++i) {
    const uint32_t a = __float_as_uint(qv[F_NUM + i]);
    bool hit = false;
#pragma unroll
    for (int j = 0; j < N_FREQ; ++j) hit |= (a == wr[j]);
    count += (hit && a != SENTINEL) ? 1 : 0;
  }
  x[F_NUM * TILE_N] = (float)count / 10.0f;
  const uint32_t fa = __float_as_uint(qv[F_NUM + N_FREQ]);
  x[(F_NUM + 1) * TILE_N] = (fa == wr[N_FREQ] && fa != SENTINEL) ? 1.0f : 0.0f;
}

// tree_walk's sums over the ensemble in the constant arrays, for kQ queries'
// feature columns at once (query j's at x + j * X_BYTES), each from acc[j]:
// one constant load of a condition serves kQ pairs.
template <int kDepth, int kQ>
__device__ __forceinline__ void walk_ensemble(const float* x, const float* leaves, float* acc,
                                              int n_trees, int depth_rt) {
  const int depth = kDepth ? kDepth : depth_rt;
  const char* xb = reinterpret_cast<const char*>(x);
  int k = 0;
  for (int t = 0; t < n_trees; ++t) {
    int idx[kQ] = {};
#pragma unroll
    for (int l = 0; l < depth; ++l, ++k) {
      const int2 c = c_conds[k];
#pragma unroll
      for (int j = 0; j < kQ; ++j)
        idx[j] |= (*reinterpret_cast<const float*>(xb + j * X_BYTES + c.x) >= __int_as_float(c.y))
                      ? (1 << l) : 0;
    }
#pragma unroll
    for (int j = 0; j < kQ; ++j) acc[j] = acc[j] + leaves[(t << depth) + idx[j]];
  }
}

template <typename T, int kDepth, int kQ>
__global__ void __launch_bounds__(TILE_N) fused_score_kernel(
    Scorer s, const float* __restrict__ scale, const float* __restrict__ leaves, float base,
    bool accumulate, long long n_tiles, int n_trees, int depth) {
  using L = TileLayout<T>;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* buf = smem;                                             // [L::WORDS]
  float* s_x = reinterpret_cast<float*>(smem + L::WORDS);          // [kQ][F_DIST][TILE_N]
  float* s_scale = s_x + kQ * F_DIST * TILE_N;                      // [32]
  float* s_leaves = s_scale + 32;                                   // [n_trees << depth]
  const int tid = threadIdx.x;

  for (int i = tid; i < (n_trees << depth); i += TILE_N) s_leaves[i] = leaves[i];
  if (tid < F_NUM) s_scale[tid] = scale ? scale[tid] : 1.0f;
  float* x = s_x + tid;

  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const Tile g = tile_of(s, t);
    stage_tile<T>(s, g, buf);
    __syncthreads();                            // tile t (and the leaves) landed

    if (tid < g.nn) {
      // the row, once: numeric slots dequantized into registers, words
      const int off = tile_lead<T>(s, g) + tid * L::ROW_BYTES;
      const uint32_t* zw = buf + L::Q + (off >> 2);
      uint32_t al[L::ROW_WORDS];
#pragma unroll
      for (int j = 0; j < L::ROW_WORDS; ++j)
        al[j] = __funnelshift_r(zw[j], zw[j + 1], 8 * (off & 3));
      float zr[F_NUM];
#pragma unroll
      for (int f = 0; f < F_NUM; ++f) zr[f] = dequant(element(al, f, T()), s_scale[f]);
      uint32_t wr[F_WORDS];
      const uint32_t* ww = buf + L::Q + L::Z + tid * F_WORDS;
#pragma unroll
      for (int j = 0; j < F_WORDS; ++j) wr[j] = ww[j];

      for (int qi = 0; qi < g.nq; qi += kQ) {
        float acc[kQ];
        float* o[kQ];
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
          const int q = min(qi + j, g.nq - 1);  // a ragged group repeats its last query
          row_features(buf + q * Q_WORDS, zr, wr, x + j * F_DIST * TILE_N);
          o[j] = s.out + (long long)(g.q0 + q) * s.n_cols + g.n0 + tid;
          acc[j] = accumulate ? *o[j] : base;
        }
        walk_ensemble<kDepth, kQ>(x, s_leaves, acc, n_trees, depth);
#pragma unroll
        for (int j = 0; j < kQ; ++j)
          if (qi + j < g.nq) *o[j] = acc[j];
      }
    }
    __syncthreads();                            // buf is free for the next tile
  }
}

// Launch the scorer for corpus element type T on `stream`; `scale` is null
// for a float32 corpus, n_sms the card's SM count. Returns the first CUDA
// error (0 when none).
template <typename T>
int launch(const void* zq, const void* wq, const void* zc, const void* scale,
           const void* wc, const void* feats, const void* thrs, const void* leaves,
           float base, void* out, int n_queries, int n_cols, long long q_stride_rows,
           int n_trees, int depth, int n_sms, void* stream) {
  if (n_queries == 0 || n_cols == 0) return 0;
  const int chunk = trees_per_launch<T>(n_trees, depth);
  if (chunk < 1 && n_trees > 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Scorer s{static_cast<const float*>(zq), static_cast<const uint32_t*>(wq), zc,
           static_cast<const uint32_t*>(wc), static_cast<float*>(out), n_queries, n_cols,
           q_stride_rows, (n_cols + TILE_N - 1) / TILE_N, q_stride_rows ? 1 : TILE_Q};
  const long long n_tiles =
      (long long)s.n_cb * ((n_queries + s.q_per_tile - 1) / s.q_per_tile);
  if (n_sms < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;

  int t0 = 0;
  do {
    const int nt = std::min(chunk, n_trees - t0);
    const size_t conds = (size_t)nt * depth;
    if (conds) {
      pack_conditions<<<(unsigned)((conds + 255) / 256), 256, 0, st>>>(
          static_cast<const int32_t*>(feats) + (size_t)t0 * depth,
          static_cast<const float*>(thrs) + (size_t)t0 * depth, (int)conds,
          TILE_N * (int)sizeof(float));
      void* staged = nullptr;
      err = cudaGetLastError();
      if (err == cudaSuccess) err = cudaGetSymbolAddress(&staged, g_conds);
      if (err == cudaSuccess)
        err = cudaMemcpyToSymbolAsync(c_conds, staged, conds * sizeof(int2), 0,
                                      cudaMemcpyDeviceToDevice, st);
      if (err != cudaSuccess) return (int)err;
    }
    auto kernel = q_stride_rows ? (depth == 5 ? fused_score_kernel<T, 5, 1> : fused_score_kernel<T, 0, 1>)
                                : (depth == 5 ? fused_score_kernel<T, 5, QPT> : fused_score_kernel<T, 0, QPT>);
    const size_t smem = smem_bytes<T>(nt, depth, q_stride_rows ? 1 : QPT);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TILE_N, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long grid = std::min(n_tiles, (long long)per_sm * n_sms);
    kernel<<<(unsigned)grid, TILE_N, smem, st>>>(
        s, static_cast<const float*>(scale),
        static_cast<const float*>(leaves) + ((size_t)t0 << depth), base, t0 > 0, n_tiles, nt,
        depth);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    t0 += nt;
  } while (t0 < n_trees);
  return 0;
}

}  // namespace freyja_fused
