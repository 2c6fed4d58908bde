// Candidate priority of the lsh and hybrid plans, for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. The JAX package leaves this step to XLA
//   (repro/exec/stages.py::candidate_priorities, after the band probe); the
//   port ran it as an ATen composition of about a dozen passes over (Q, C)
//   tensors after the proxy's sgemm: the broadcast subtract of the column
//   norms, abs, 1 + |x|, the divide, the hits' cast, multiply and add, then
//   the exclusion's int64 compares, ors and the last where. That composition
//   is the plain version (kernels/ref.py, candidate_priority_ref). For each
//   (query q, column c):
//
//     hybrid:   p    = g[q, c] - znorm[c]     (g = (2·zq) @ zᵀ, cuBLAS, before)
//               prio = (float)hit * 4 + p / (1 + |p|)
//     lsh:      prio = hit > 0 ? 0 : -inf     (no g)
//     excluded  = cid[c] < 0 || cid[c] == qid[q] || (tq[q] >= 0 && tid[c] == tq[q])
//     prio      = excluded ? -inf : prio
//
//   The float arithmetic is the plain version's, in its order, with
//   round-to-nearest intrinsics, which nvcc never contracts into an FMA, and
//   no fast-math, so the budget's top-k sees the same bits.
// Bound on the H100: bytes. Per element the hit (int32) and g (float32) are
//   read once and the priority (float32) written once, over g: 12 bytes,
//   12.9 GB at hybrid4m's (Q, C) = (256, 4,194,304), 3.85 ms at 3.35 TB/s;
//   8 bytes an element for lsh. The columns' norms, ids and tables (20 bytes
//   a column) and the queries' ids and tables are small beside it.
//
// Design.
// 1. A block owns a tile of columns and walks a group of queries. Each
//    thread loads its columns' norm, id and table once, into registers, and
//    reuses them for every query of the group, rather than reading the
//    lake's 84 MB of column data again for each query. The group is sized
//    from Q so that the grid holds a few waves of blocks: at (256, 4M) one
//    group of 256 over 4,096 tiles; at (64, 100k) 8 groups of 8 over 98.
// 2. Fast path (C % 4 == 0 and every tensor 16-byte aligned, as the executor
//    calls it): a thread holds 4 neighbouring columns, read as one 16-byte
//    read-once load (ld.global.cs) of hits and one of g, and written as one
//    streaming 16-byte store (st.global.cs). UNROLL queries' loads are issued
//    before any of them is used, to keep enough bytes in flight.
// 3. Any other C or alignment: the same loop with one column a thread and
//    4-byte accesses (a warp still reads 128 contiguous bytes a row).
// 4. In place: each element of g is read and then overwritten by the same
//    thread, so prio may be g itself (the hybrid stage's call); g and prio
//    are therefore not __restrict__.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;               // queries whose loads are issued together
constexpr int WAVES = 2;                // blocks the grid aims at, in full waves
constexpr int BLOCKS_PER_SM = 3;        // resident blocks an SM (launch bounds)
constexpr float BOOST = 4.0f;           // ref.LSH_PRIORITY_BOOST

__device__ __forceinline__ bool excluded(long long cid, long long tid, long long qid,
                                         long long tq) {
  return cid < 0 || cid == qid || (tq >= 0 && tid == tq);
}

// The plain version's priority of one element, before the exclusion.
template <bool kProxy>
__device__ __forceinline__ float priority(int h, float g, float zn) {
  if (kProxy) {
    const float p = __fsub_rn(g, zn);
    const float squash = __fdiv_rn(p, __fadd_rn(1.0f, fabsf(p)));
    return __fadd_rn(__fmul_rn(__int2float_rn(h), BOOST), squash);
  }
  return h > 0 ? 0.0f : -INFINITY;
}

// VEC neighbouring elements: one 16-byte access for 4, one 4-byte for 1.
template <int VEC>
__device__ __forceinline__ void load_hits(const int32_t* p, int (&h)[VEC]) {
  if constexpr (VEC == 4) {
    const int4 v = __ldcs(reinterpret_cast<const int4*>(p));
    h[0] = v.x, h[1] = v.y, h[2] = v.z, h[3] = v.w;
  } else {
    h[0] = __ldcs(p);
  }
}

template <int VEC>
__device__ __forceinline__ void load_floats(const float* p, float (&f)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  } else {
    f[0] = __ldcs(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_floats(float* p, const float (&f)[VEC]) {
  if constexpr (VEC == 4)
    __stcs(reinterpret_cast<float4*>(p), make_float4(f[0], f[1], f[2], f[3]));
  else
    __stcs(p, f[0]);
}

// A thread's VEC columns' ids, tables and (with a proxy) norms.
template <int VEC, bool kProxy>
__device__ __forceinline__ void load_columns(const long long* __restrict__ cids,
                                             const long long* __restrict__ tids,
                                             const float* __restrict__ znorm, long long c,
                                             long long (&cid)[VEC], long long (&tid)[VEC],
                                             float (&zn)[VEC]) {
  if constexpr (VEC == 4) {
    const longlong2* ci = reinterpret_cast<const longlong2*>(cids + c);
    const longlong2* ti = reinterpret_cast<const longlong2*>(tids + c);
    const longlong2 c01 = __ldg(ci), c23 = __ldg(ci + 1), t01 = __ldg(ti), t23 = __ldg(ti + 1);
    cid[0] = c01.x, cid[1] = c01.y, cid[2] = c23.x, cid[3] = c23.y;
    tid[0] = t01.x, tid[1] = t01.y, tid[2] = t23.x, tid[3] = t23.y;
    if (kProxy) {
      const float4 z = __ldg(reinterpret_cast<const float4*>(znorm + c));
      zn[0] = z.x, zn[1] = z.y, zn[2] = z.z, zn[3] = z.w;
    }
  } else {
    cid[0] = __ldg(cids + c);
    tid[0] = __ldg(tids + c);
    if (kProxy) zn[0] = __ldg(znorm + c);
  }
  if (!kProxy) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) zn[k] = 0.f;
  }
}

template <int VEC, bool kProxy>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) candidate_priority_kernel(
    const int32_t* __restrict__ hit, const float* g, const float* __restrict__ znorm,
    const long long* __restrict__ cids, const long long* __restrict__ tids,
    const long long* __restrict__ tq, const long long* __restrict__ qid, float* prio,
    int n_queries, int n_cols, int group) {
  // VEC == 4 only with C % 4 == 0: a thread's columns all exist or none do.
  // No barrier follows, so a thread past the lake's end leaves at once.
  const long long c = ((long long)blockIdx.x * THREADS + threadIdx.x) * VEC;
  if (c >= n_cols) return;
  long long cid[VEC], tid[VEC];
  float zn[VEC];
  load_columns<VEC, kProxy>(cids, tids, znorm, c, cid, tid, zn);
  const int q0 = blockIdx.y * group;
  const int nq = min(group, n_queries - q0);
  for (int i = 0; i < nq; i += UNROLL) {
    int h[UNROLL][VEC];
    float p[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) h[u][k] = 0, p[u][k] = 0.f;
      if (i + u < nq) {
        const long long at = (long long)(q0 + i + u) * n_cols + c;
        load_hits<VEC>(hit + at, h[u]);
        if (kProxy) load_floats<VEC>(g + at, p[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (i + u >= nq) break;
      const int q = q0 + i + u;
      const long long qq = __ldg(qid + q), tt = __ldg(tq + q);
      float out[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        out[k] = excluded(cid[k], tid[k], qq, tt) ? -INFINITY
                                                  : priority<kProxy>(h[u][k], p[u][k], zn[k]);
      store_floats<VEC>(prio + (long long)q * n_cols + c, out);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

template <int VEC, bool kProxy>
void launch(dim3 grid, cudaStream_t st, const int32_t* h, const float* g, const float* zn,
            const long long* ci, const long long* ti, const long long* tqq,
            const long long* qi, float* o, int n_queries, int n_cols, int group) {
  candidate_priority_kernel<VEC, kProxy><<<grid, THREADS, 0, st>>>(
      h, g, zn, ci, ti, tqq, qi, o, n_queries, n_cols, group);
}

}  // namespace

extern "C" {

// hit (Q, C) int32; g (Q, C) float32 and znorm (C,) float32, both or neither
// (neither: the lsh kind); cids / tids (C,) int64; tq / qid (Q,) int64 ->
// prio (Q, C) float32, which may be g itself. n_sms sizes the grid. Returns
// the first CUDA error (0 when none).
int freyja_candidate_priority(const void* hit, const void* g, const void* znorm,
                              const void* cids, const void* tids, const void* tq,
                              const void* qid, void* prio, int n_queries, int n_cols,
                              int n_sms, void* stream) {
  if (n_queries == 0 || n_cols == 0) return 0;
  if (n_sms < 1 || (g == nullptr) != (znorm == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* h = static_cast<const int32_t*>(hit);
  const auto* gg = static_cast<const float*>(g);
  const auto* zn = static_cast<const float*>(znorm);
  const auto* ci = static_cast<const long long*>(cids);
  const auto* ti = static_cast<const long long*>(tids);
  const auto* tqq = static_cast<const long long*>(tq);
  const auto* qi = static_cast<const long long*>(qid);
  auto* o = static_cast<float*>(prio);
  const bool fast = n_cols % 4 == 0 && aligned16(hit) && aligned16(cids) && aligned16(tids) &&
                    aligned16(prio) && (g == nullptr || (aligned16(g) && aligned16(znorm)));
  const long long tiles = ceil_div(n_cols, (long long)THREADS * (fast ? 4 : 1));
  // query groups: enough blocks for WAVES full waves
  const long long target = (long long)WAVES * BLOCKS_PER_SM * n_sms;
  long long groups = std::min<long long>(n_queries, std::max(1LL, ceil_div(target, tiles)));
  const int group = (int)ceil_div(n_queries, groups);
  groups = ceil_div(n_queries, group);
  if (groups > 65535 || tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)groups);
  if (fast && gg)
    launch<4, true>(grid, st, h, gg, zn, ci, ti, tqq, qi, o, n_queries, n_cols, group);
  else if (fast)
    launch<4, false>(grid, st, h, gg, zn, ci, ti, tqq, qi, o, n_queries, n_cols, group);
  else if (gg)
    launch<1, true>(grid, st, h, gg, zn, ci, ti, tqq, qi, o, n_queries, n_cols, group);
  else
    launch<1, false>(grid, st, h, gg, zn, ci, ti, tqq, qi, o, n_queries, n_cols, group);
  return (int)cudaGetLastError();
}

}  // extern "C"
