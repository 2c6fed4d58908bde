// Fused profile-distance + oblivious-GBDT scorer for Hopper (sm_90a).
//
// Replaces: repro/kernels/profile_distance.py::fused_score_pallas (the
//   Pallas kernel _fused_kernel = _distances + _fused_body).
// Bound on the H100 at the main path's shapes (Q = 64 queries against
//   N = 100k resident columns, T = 50 trees of depth D = 5): operations. The
//   bytes are the corpus profiles once (N x 32 words = 12.8 MB) plus the
//   (Q, N) score matrix (25.6 MB); the work is ~1.1e3 compares, adds and
//   loads per pair (|dz| x 21, a 10 x 10 word compare, T x D threshold
//   compares and T leaf loads), ~7e9 in all.
// Design: one thread scores one (query, column) pair. A block covers 128
//   columns and QB queries; the tree tables (feats, thrs, leaves: ~8 KB at
//   T = 50, D = 5) and the block's query profiles sit in shared memory, so a
//   thread reads its column's profile from device memory and nothing else.
//   The 23 features go to a per-thread column of shared memory and each tree
//   level is one indexed load from it, replacing the TPU kernel's one-hot
//   feature-select and leaf-lookup matmuls. The sum runs from `base` in tree
//   order, as the plain version does. The word overlap is
//   float(count) / 10.0f with IEEE division (no fast-math): GBDT thresholds
//   are quantiles of these very features, so one ulp can flip a leaf.
//   A query stride of 0 scores a shared corpus (N, F); a stride of M scores
//   a per-query gathered corpus (Q, M, F) with the same body.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int F_NUM = 21;
constexpr int N_FREQ = 10;
constexpr int F_WORDS = 11;
constexpr int F_DIST = 23;
constexpr int BLOCK_N = 128;
constexpr int BLOCK_Q = 8;
constexpr uint32_t SENTINEL = 0xFFFFFFFFu;

__global__ void fused_score_kernel(
    const float* __restrict__ zq, const uint32_t* __restrict__ wq,
    const float* __restrict__ zc, const uint32_t* __restrict__ wc,
    const int32_t* __restrict__ feats, const float* __restrict__ thrs,
    const float* __restrict__ leaves, float base, float* __restrict__ out,
    int n_queries, int n_cols, long long q_stride_rows, int n_trees,
    int depth) {
  extern __shared__ unsigned char smem_raw[];
  const int n_leaves = 1 << depth;
  int32_t* s_feats = reinterpret_cast<int32_t*>(smem_raw);
  float* s_thrs = reinterpret_cast<float*>(s_feats + n_trees * depth);
  float* s_leaves = s_thrs + n_trees * depth;
  float* s_zq = s_leaves + n_trees * n_leaves;                 // [BLOCK_Q][F_NUM]
  uint32_t* s_wq = reinterpret_cast<uint32_t*>(s_zq + BLOCK_Q * F_NUM);
  float* s_x = reinterpret_cast<float*>(s_wq + BLOCK_Q * F_WORDS);  // [F_DIST][BLOCK_N]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.y * BLOCK_Q;
  const int nq = min(BLOCK_Q, n_queries - q0);
  for (int i = tid; i < n_trees * depth; i += blockDim.x) {
    s_feats[i] = feats[i];
    s_thrs[i] = thrs[i];
  }
  for (int i = tid; i < n_trees * n_leaves; i += blockDim.x) s_leaves[i] = leaves[i];
  for (int i = tid; i < nq * F_NUM; i += blockDim.x) s_zq[i] = zq[q0 * F_NUM + i];
  for (int i = tid; i < nq * F_WORDS; i += blockDim.x) s_wq[i] = wq[q0 * F_WORDS + i];
  __syncthreads();

  const int n = blockIdx.x * BLOCK_N + tid;
  if (n >= n_cols) return;
  float* x = s_x + tid;                       // feature f at x[f * BLOCK_N]

  for (int qi = 0; qi < nq; ++qi) {
    const int q = q0 + qi;
    const long long row = (long long)q * q_stride_rows + n;
    const float* zrow = zc + row * F_NUM;
    const uint32_t* wrow = wc + row * F_WORDS;
    const float* zqq = s_zq + qi * F_NUM;
    const uint32_t* wqq = s_wq + qi * F_WORDS;

#pragma unroll
    for (int f = 0; f < F_NUM; ++f) x[f * BLOCK_N] = fabsf(zqq[f] - zrow[f]);

    uint32_t cw[N_FREQ];
#pragma unroll
    for (int j = 0; j < N_FREQ; ++j) cw[j] = wrow[j];
    int count = 0;
#pragma unroll
    for (int i = 0; i < N_FREQ; ++i) {
      const uint32_t a = wqq[i];
      bool hit = false;
#pragma unroll
      for (int j = 0; j < N_FREQ; ++j) hit |= (a == cw[j]);
      count += (hit && a != SENTINEL) ? 1 : 0;
    }
    x[F_NUM * BLOCK_N] = (float)count / 10.0f;
    const uint32_t fa = wqq[N_FREQ];
    x[(F_NUM + 1) * BLOCK_N] = (fa == wrow[N_FREQ] && fa != SENTINEL) ? 1.0f : 0.0f;

    float acc = base;
    for (int t = 0; t < n_trees; ++t) {
      int idx = 0;
      for (int l = 0; l < depth; ++l) {
        const int k = t * depth + l;
        idx |= (x[s_feats[k] * BLOCK_N] >= s_thrs[k]) ? (1 << l) : 0;
      }
      acc = acc + s_leaves[t * n_leaves + idx];
    }
    out[(long long)q * n_cols + n] = acc;
  }
}

size_t smem_bytes(int n_trees, int depth) {
  return sizeof(int32_t) * n_trees * depth + sizeof(float) * n_trees * depth +
         sizeof(float) * n_trees * (1 << depth) + sizeof(float) * BLOCK_Q * F_NUM +
         sizeof(uint32_t) * BLOCK_Q * F_WORDS + sizeof(float) * F_DIST * BLOCK_N;
}

}  // namespace

extern "C" {

// Shared memory the launch needs; the wrapper refuses shapes above the
// 227 KB a block may hold.
long long freyja_fused_score_smem(int n_trees, int depth) {
  return (long long)smem_bytes(n_trees, depth);
}

// zq (Q, 21) f32, wq (Q, 11) u32 bits, zc/wc rows of 21 f32 / 11 u32 with
// row index q * q_stride_rows + n, feats/thrs (T, D), leaves (T, 2^D)
// -> out (Q, N) f32. Returns cudaGetLastError() after the launch.
int freyja_fused_score(const void* zq, const void* wq, const void* zc,
                       const void* wc, const void* feats, const void* thrs,
                       const void* leaves, float base, void* out, int n_queries,
                       int n_cols, long long q_stride_rows, int n_trees, int depth,
                       void* stream) {
  if (n_queries == 0 || n_cols == 0) return 0;
  const size_t smem = smem_bytes(n_trees, depth);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((n_cols + BLOCK_N - 1) / BLOCK_N, (n_queries + BLOCK_Q - 1) / BLOCK_Q);
  fused_score_kernel<<<grid, BLOCK_N, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(zq), static_cast<const uint32_t*>(wq),
      static_cast<const float*>(zc), static_cast<const uint32_t*>(wc),
      static_cast<const int32_t*>(feats), static_cast<const float*>(thrs),
      static_cast<const float*>(leaves), base, static_cast<float*>(out), n_queries,
      n_cols, q_stride_rows, n_trees, depth);
  return (int)cudaGetLastError();
}

}  // extern "C"
