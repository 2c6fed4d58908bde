// Fused profile-distance + oblivious-GBDT scorer for Hopper (sm_90a),
// float32 corpus.
//
// Replaces: repro/kernels/profile_distance.py::fused_score_pallas (the
//   Pallas kernel _fused_kernel = _distances + _fused_body).
// Bound on the H100 at the main path's shapes (Q = 64 queries against
//   N = 100k resident columns, T = 50 trees of depth D = 5): operations. The
//   bytes are the corpus profiles once (N x 32 words = 12.8 MB) plus the
//   (Q, N) score matrix (25.6 MB); the work is ~1.1e3 compares, adds and
//   loads per pair (|dz| x 21, a 10 x 10 word compare, T x D threshold
//   compares and T leaf loads), ~7e9 in all.
// Design (body in fused_score.cuh, shared with fused_score_q.cu): what paces
//   a scorer with one thread per (query, column) pair is the SM's
//   shared-memory load pipe. So a persistent grid of 128-thread blocks walks
//   tiles of 128 corpus rows and 16 queries: each tile's rows and query
//   profiles arrive in shared memory as one coalesced cp.async stream; each
//   thread reads its row once into registers and scores every query of the
//   tile against it, four queries at a time. The ensemble's conditions
//   (feature offset, threshold) sit in the constant bank, filled on the
//   launch stream, so their loop-uniform reads take the constant cache, one
//   load for four pairs; the leaves and each pair's 23 features stay in
//   shared memory, and each tree level is one indexed load of a feature,
//   replacing the TPU kernel's one-hot feature-select and leaf-lookup
//   matmuls. The sum runs from `base` in tree order, as the plain version
//   does. The word overlap is float(count) / 10.0f with IEEE division (no
//   fast-math): GBDT thresholds are quantiles of these very features, so one
//   ulp can flip a leaf. A query stride of 0 scores a shared corpus (N, F);
//   a stride of M scores a per-query gathered corpus (Q, M, F), one query a
//   tile.

#include "fused_score.cuh"

extern "C" {

// Shared memory of the largest launch the ensemble needs; the wrapper
// refuses an ensemble above the 227 KB a block may hold.
long long freyja_fused_score_smem(int n_trees, int depth) {
  return freyja_fused::launch_smem<float>(n_trees, depth);
}

// zq (Q, 21) f32, wq (Q, 11) u32 bits, zc/wc rows of 21 f32 / 11 u32 with
// row index q * q_stride_rows + n, feats/thrs (T, D), leaves (T, 2^D)
// -> out (Q, N) f32; n_sms: the card's SM count. Returns the first CUDA
// error of the launch (0 if none).
int freyja_fused_score(const void* zq, const void* wq, const void* zc,
                       const void* wc, const void* feats, const void* thrs,
                       const void* leaves, float base, void* out, int n_queries,
                       int n_cols, long long q_stride_rows, int n_trees, int depth,
                       int n_sms, void* stream) {
  return freyja_fused::launch<float>(zq, wq, zc, nullptr, wc, feats, thrs, leaves,
                                     base, out, n_queries, n_cols, q_stride_rows,
                                     n_trees, depth, n_sms, stream);
}

}  // extern "C"
