// Materialized profile-distance features for Hopper (sm_90a).
//
// Replaces: repro/kernels/profile_distance.py::profile_distance_pallas (the
//   Pallas kernel _dist_kernel = _distances over one (query tile, corpus
//   tile) block).
// Bound on the H100 at the model path's shapes (Q = 64 queries against the
//   N = 100k-column lake): bytes. The (Q, N, 23) float32 output is written
//   once (64 x 100k x 92 B = 589 MB, ~0.18 ms at 3.35 TB/s); the corpus
//   profiles (12.8 MB) and queries are read once, and the ~250 compares and
//   subtractions per pair are far below the arithmetic rates.
// Design: the distance body is fused_score.cuh's distance_features(), the
//   very function the fused scorer calls, so the two cannot drift. A block
//   covers BLOCK_N corpus columns and BLOCK_Q queries, whose profiles sit in
//   shared memory. For each query, every thread writes its column's 23
//   features into a [BLOCK_N][23] tile of shared memory (the row pitch 23 is
//   odd, so a warp's stores hit 32 different banks), and the block then
//   copies the tile out: for one query the block's BLOCK_N output rows are
//   contiguous in memory, so the copy is one coalesced stream of
//   BLOCK_N x 23 floats. Offsets are 64-bit: Q x N x 23 passes 2^31 at
//   Q ~ 1000 queries against 100k columns. Arithmetic as the plain version:
//   IEEE division for the word overlap, no fast-math; the output is meant to
//   equal ref.profile_distance_ref bit for bit.

#include "fused_score.cuh"

namespace {

using freyja_fused::BLOCK_N;
using freyja_fused::BLOCK_Q;
using freyja_fused::F_DIST;
using freyja_fused::F_NUM;
using freyja_fused::F_WORDS;

__global__ void profile_distance_kernel(const float* __restrict__ zq,
                                        const uint32_t* __restrict__ wq,
                                        const float* __restrict__ zc,
                                        const uint32_t* __restrict__ wc,
                                        float* __restrict__ out, int n_queries,
                                        int n_cols) {
  __shared__ float s_scale[F_NUM];
  __shared__ float s_zq[BLOCK_Q * F_NUM];
  __shared__ uint32_t s_wq[BLOCK_Q * F_WORDS];
  __shared__ float s_x[BLOCK_N * F_DIST];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.y * BLOCK_Q;
  const int nq = min(BLOCK_Q, n_queries - q0);
  const int n0 = blockIdx.x * BLOCK_N;
  const int nn = min(BLOCK_N, n_cols - n0);
  for (int i = tid; i < F_NUM; i += blockDim.x) s_scale[i] = 1.0f;
  for (int i = tid; i < nq * F_NUM; i += blockDim.x) s_zq[i] = zq[q0 * F_NUM + i];
  for (int i = tid; i < nq * F_WORDS; i += blockDim.x) s_wq[i] = wq[q0 * F_WORDS + i];
  __syncthreads();

  const long long n = n0 + tid;
  for (int qi = 0; qi < nq; ++qi) {
    if (tid < nn)
      freyja_fused::distance_features(s_zq + qi * F_NUM, s_wq + qi * F_WORDS,
                                      zc + n * F_NUM, s_scale, wc + n * F_WORDS,
                                      s_x + tid * F_DIST, 1);
    __syncthreads();
    float* dst = out + ((long long)(q0 + qi) * n_cols + n0) * F_DIST;
    for (int i = tid; i < nn * F_DIST; i += blockDim.x) dst[i] = s_x[i];
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// zq (Q, 21) f32, wq (Q, 11) u32 bits, zc (N, 21) f32, wc (N, 11) u32 bits
// -> out (Q, N, 23) f32. Returns cudaGetLastError() after the launch.
int freyja_profile_distance(const void* zq, const void* wq, const void* zc,
                            const void* wc, void* out, int n_queries, int n_cols,
                            void* stream) {
  if (n_queries == 0 || n_cols == 0) return 0;
  dim3 grid((n_cols + BLOCK_N - 1) / BLOCK_N, (n_queries + BLOCK_Q - 1) / BLOCK_Q);
  profile_distance_kernel<<<grid, BLOCK_N, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(zq), static_cast<const uint32_t*>(wq),
      static_cast<const float*>(zc), static_cast<const uint32_t*>(wc),
      static_cast<float*>(out), n_queries, n_cols);
  return (int)cudaGetLastError();
}

}  // extern "C"
