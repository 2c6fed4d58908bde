// Body of the fused profile-distance + oblivious-GBDT scorer, shared by
// fused_score.cu (float32 corpus) and fused_score_q.cu (int8 or float16
// sidecar). See fused_score.cu for the design and its bound.
//
// The two halves of that body are __device__ functions of their own, so the
// standalone kernels compute the very same arithmetic: distance_features()
// (also called by profile_distance.cu) and tree_walk() (also called by
// gbdt_infer.cu).
//
// Dequantization. A float32 corpus element is read as it is. A sidecar
// element is widened to float32 (exact for int8 and float16) and multiplied
// by its feature's scale with __fmul_rn: the plain version rounds that
// product before it subtracts it from the query's value, and __fmul_rn keeps
// the compiler from contracting the multiply and the subtraction into one
// FMA, which would round once and could flip a GBDT leaf.

#pragma once

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

template <typename T>
__global__ void fused_score_kernel(
    const float* __restrict__ zq, const uint32_t* __restrict__ wq,
    const T* __restrict__ zc, const float* __restrict__ scale,
    const uint32_t* __restrict__ wc, const int32_t* __restrict__ feats,
    const float* __restrict__ thrs, const float* __restrict__ leaves, float base,
    float* __restrict__ out, int n_queries, int n_cols, long long q_stride_rows,
    int n_trees, int depth) {
  extern __shared__ unsigned char smem_raw[];
  const int n_leaves = 1 << depth;
  int32_t* s_feats = reinterpret_cast<int32_t*>(smem_raw);
  float* s_thrs = reinterpret_cast<float*>(s_feats + n_trees * depth);
  float* s_leaves = s_thrs + n_trees * depth;
  float* s_scale = s_leaves + n_trees * n_leaves;              // [F_NUM]
  float* s_zq = s_scale + F_NUM;                               // [BLOCK_Q][F_NUM]
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
  for (int i = tid; i < F_NUM; i += blockDim.x) s_scale[i] = scale ? scale[i] : 1.0f;
  for (int i = tid; i < nq * F_NUM; i += blockDim.x) s_zq[i] = zq[q0 * F_NUM + i];
  for (int i = tid; i < nq * F_WORDS; i += blockDim.x) s_wq[i] = wq[q0 * F_WORDS + i];
  __syncthreads();

  const int n = blockIdx.x * BLOCK_N + tid;
  if (n >= n_cols) return;
  float* x = s_x + tid;                       // feature f at x[f * BLOCK_N]

  for (int qi = 0; qi < nq; ++qi) {
    const int q = q0 + qi;
    const long long row = (long long)q * q_stride_rows + n;
    distance_features(s_zq + qi * F_NUM, s_wq + qi * F_WORDS, zc + row * F_NUM, s_scale,
                      wc + row * F_WORDS, x, BLOCK_N);
    const float acc = tree_walk(x, BLOCK_N, s_feats, s_thrs, s_leaves, base, n_trees, depth);
    out[(long long)q * n_cols + n] = acc;
  }
}

inline size_t smem_bytes(int n_trees, int depth) {
  return sizeof(int32_t) * n_trees * depth + sizeof(float) * n_trees * depth +
         sizeof(float) * n_trees * (1 << depth) + sizeof(float) * F_NUM +
         sizeof(float) * BLOCK_Q * F_NUM + sizeof(uint32_t) * BLOCK_Q * F_WORDS +
         sizeof(float) * F_DIST * BLOCK_N;
}

// Launch the scorer for corpus element type T on `stream`; `scale` is null
// for a float32 corpus. Returns cudaGetLastError() after the launch.
template <typename T>
int launch(const void* zq, const void* wq, const void* zc, const void* scale,
           const void* wc, const void* feats, const void* thrs, const void* leaves,
           float base, void* out, int n_queries, int n_cols, long long q_stride_rows,
           int n_trees, int depth, void* stream) {
  if (n_queries == 0 || n_cols == 0) return 0;
  const size_t smem = smem_bytes(n_trees, depth);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_score_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((n_cols + BLOCK_N - 1) / BLOCK_N, (n_queries + BLOCK_Q - 1) / BLOCK_Q);
  fused_score_kernel<T><<<grid, BLOCK_N, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(zq), static_cast<const uint32_t*>(wq),
      static_cast<const T*>(zc), static_cast<const float*>(scale),
      static_cast<const uint32_t*>(wc), static_cast<const int32_t*>(feats),
      static_cast<const float*>(thrs), static_cast<const float*>(leaves), base,
      static_cast<float*>(out), n_queries, n_cols, q_stride_rows, n_trees, depth);
  return (int)cudaGetLastError();
}

}  // namespace freyja_fused
