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
// Design: one thread predicts one row. A block stages its BLOCK_N rows in
//   shared memory with one coalesced copy of the contiguous BLOCK_N x F
//   floats, at an odd row pitch (F, or F + 1 when F is even) so that the
//   block's threads reading one feature of their own rows hit 32 different
//   banks. The ensemble (feats, thrs, leaves) sits in shared memory too; at
//   (T, D) = (50, 8) it needs 54 KB, so the launch opts in to dynamic shared
//   memory above 48 KB. The walk is fused_score.cuh's tree_walk(), the
//   function the fused scorer calls: each tree level is one indexed
//   shared-memory load where the TPU kernel multiplied by one-hot matrices,
//   and the sum runs from `base` in tree order with plain float adds (no
//   TF32, no fast-math), so the result is meant to equal ref.gbdt_infer_ref
//   bit for bit.

#include "fused_score.cuh"

namespace {

constexpr int BLOCK_N = 128;

__global__ void gbdt_infer_kernel(const float* __restrict__ x,
                                  const int32_t* __restrict__ feats,
                                  const float* __restrict__ thrs,
                                  const float* __restrict__ leaves, float base,
                                  float* __restrict__ out, long long n_rows,
                                  int n_feats, int pitch, int n_trees, int depth) {
  extern __shared__ unsigned char smem_raw[];
  const int n_leaves = 1 << depth;
  int32_t* s_feats = reinterpret_cast<int32_t*>(smem_raw);
  float* s_thrs = reinterpret_cast<float*>(s_feats + n_trees * depth);
  float* s_leaves = s_thrs + n_trees * depth;
  float* s_x = s_leaves + n_trees * n_leaves;                  // [BLOCK_N][pitch]

  const int tid = threadIdx.x;
  for (int i = tid; i < n_trees * depth; i += blockDim.x) {
    s_feats[i] = feats[i];
    s_thrs[i] = thrs[i];
  }
  for (int i = tid; i < n_trees * n_leaves; i += blockDim.x) s_leaves[i] = leaves[i];
  const long long n0 = (long long)blockIdx.x * BLOCK_N;
  const int nn = (int)min((long long)BLOCK_N, n_rows - n0);
  const float* src = x + n0 * n_feats;
  for (int i = tid; i < nn * n_feats; i += blockDim.x)
    s_x[(i / n_feats) * pitch + i % n_feats] = src[i];
  __syncthreads();

  if (tid < nn)
    out[n0 + tid] = freyja_fused::tree_walk(s_x + tid * pitch, 1, s_feats, s_thrs,
                                            s_leaves, base, n_trees, depth);
}

int row_pitch(int n_feats) { return n_feats | 1; }

size_t smem_bytes(int n_feats, int n_trees, int depth) {
  return sizeof(int32_t) * n_trees * depth + sizeof(float) * n_trees * depth +
         sizeof(float) * n_trees * (1 << depth) +
         sizeof(float) * BLOCK_N * row_pitch(n_feats);
}

}  // namespace

extern "C" {

// Shared memory the launch needs; the wrapper refuses shapes above the
// 227 KB a block may hold.
long long freyja_gbdt_infer_smem(int n_feats, int n_trees, int depth) {
  return (long long)smem_bytes(n_feats, n_trees, depth);
}

// x (N, F) f32, feats/thrs (T, D) i32/f32, leaves (T, 2^D) f32 -> out (N,)
// f32. Returns cudaGetLastError() after the launch.
int freyja_gbdt_infer(const void* x, const void* feats, const void* thrs,
                      const void* leaves, float base, void* out, long long n_rows,
                      int n_feats, int n_trees, int depth, void* stream) {
  if (n_rows == 0) return 0;
  const size_t smem = smem_bytes(n_feats, n_trees, depth);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gbdt_infer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (n_rows + BLOCK_N - 1) / BLOCK_N;
  gbdt_infer_kernel<<<(unsigned)blocks, BLOCK_N, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(feats),
      static_cast<const float*>(thrs), static_cast<const float*>(leaves), base,
      static_cast<float*>(out), n_rows, n_feats, row_pitch(n_feats), n_trees, depth);
  return (int)cudaGetLastError();
}

}  // extern "C"
