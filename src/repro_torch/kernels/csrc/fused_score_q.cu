// Fused scorer over a quantized corpus sidecar for Hopper (sm_90a).
//
// Replaces: repro/kernels/profile_distance.py::fused_score_q_pallas (the
//   Pallas kernel _fused_q_kernel: dequantize, _distances, _fused_body).
// Bound on the H100 at the main path's shapes (int8 sidecar, Q = 64 queries
//   against N = 100k columns, T = 50, D = 5): operations, the same work per
//   pair as fused_score.cu (~0.17 ms). The bytes shrink to the 21-byte int8
//   rows and 44 bytes of words per column (~6.5 MB) plus the (Q, N) score
//   matrix (25.6 MB).
// Design: the body of fused_score.cu (fused_score.cuh) with the corpus
//   element type templated, int8_t (scale = abs-max / 127 per feature) or
//   __half (scale 1). A tile's sidecar rows (21 or 42 bytes, at any byte
//   offset) are copied as the 4-byte words that hold them; each thread
//   funnel-shifts its row out of those words, widens each element and
//   dequantizes it once per tile as float(v) * scale[f] with one IEEE
//   multiply (__fmul_rn), which is the plain version's arithmetic: the
//   kernel's scores equal fused_score_q_ref's. Shared (N, F) and gathered
//   (Q, M, F) sidecars are served by the query stride, as in the float32
//   kernel.

#include "fused_score.cuh"

extern "C" {

// As freyja_fused_score_smem, for the wider (float16) sidecar.
long long freyja_fused_score_q_smem(int n_trees, int depth) {
  return freyja_fused::launch_smem<__half>(n_trees, depth);
}

// As freyja_fused_score, with zc an int8 (dtype 0) or float16 (dtype 1)
// sidecar and scale its (21,) f32 dequantization multiplier.
int freyja_fused_score_q(const void* zq, const void* wq, const void* zc,
                         const void* scale, const void* wc, const void* feats,
                         const void* thrs, const void* leaves, float base, void* out,
                         int n_queries, int n_cols, long long q_stride_rows,
                         int n_trees, int depth, int dtype, void* stream) {
  switch (dtype) {
    case 0:
      return freyja_fused::launch<int8_t>(zq, wq, zc, scale, wc, feats, thrs, leaves,
                                          base, out, n_queries, n_cols, q_stride_rows,
                                          n_trees, depth, stream);
    case 1:
      return freyja_fused::launch<__half>(zq, wq, zc, scale, wc, feats, thrs, leaves,
                                          base, out, n_queries, n_cols, q_stride_rows,
                                          n_trees, depth, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
