// Survivor priority and counts of the tiered coarse pass, for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. The JAX package leaves this step to XLA
//   (repro/exec/stages.py::tiered_survivors, after the coarse probe); the
//   port ran it as an ATen composition of about twenty passes over (Q, C)
//   tensors: the hit mask padded, a bool any over blocks of block_c columns
//   and its repeat back to columns, the exclusion mask, the priority's casts,
//   adds, divide and wheres, then two int64 casts and sums for the counts.
//   That composition is the plain version (kernels/ref.py,
//   coarse_priority_ref). For each (query q, column c):
//
//     block_hit = any(hit[q, c'] > 0) over c's block of block_c columns
//     excluded  = cid[c] < 0 || cid[c] == qid[q] || (tq[q] >= 0 && tid[c] == tq[q])
//     prio      = (where(block_hit, 4, 0) + (float)hit) + proxy / (1 + |proxy|)
//                 (without a proxy: where(block_hit, 1, -inf) + (float)hit)
//     prio      = excluded ? -inf : prio
//     n_hits[q] += hit > 0 && !excluded;  n_survivors[q] += block_hit && !excluded
//
//   The float arithmetic is the plain version's, in its order, with
//   round-to-nearest intrinsics and no fast-math, so the survivors' top-k sees
//   the same bits.
// Bound on the H100: bytes. Per element the hit (int32) and the proxy
//   (float32) are read once and the priority (float32) written once: 12 bytes,
//   12.9 GB at the main path's (Q, C) = (256, 4,194,304), 3.85 ms at
//   3.35 TB/s. The column ids and tables (16 bytes a column) and the counts
//   are small beside it.
//
// Design.
// 1. A block owns a tile of columns and walks a group of queries. It loads
//    the tile's ids and tables once, into registers (fast path) and reuses
//    them for every query of the group, rather than reading 64 MB of column
//    metadata again for each query. The group is sized from Q so that the
//    grid holds a few waves of blocks: at (256, 4M) one group of 256 over
//    4,096 tiles; at (64, 100k) 8 groups of 8 over 98 tiles.
// 2. Fast path (block_c = 32, C % 4 == 0, 16-byte aligned tensors, as the
//    executor calls it): a thread holds 4 neighbouring columns, read as one
//    16-byte read-once load (ld.global.cs) of hits and one of proxies, and
//    written as one streaming 16-byte store (st.global.cs). Eight lanes
//    cover one block of 32 columns, so the block's any is one warp ballot
//    masked to the lane's 8-lane group. UNROLL queries' loads are issued
//    before any of them is used, to keep enough bytes in flight.
// 3. Any other block_c, or a C that is not a multiple of 4: a tile of whole
//    blocks (GEN_TILE columns, or one block when block_c is larger), one
//    column a thread at a time. Per query the block-hit flags go to shared
//    memory as stamps (the query's index in the group), two queries deep so
//    that one barrier a query suffices; then each column reads its block's
//    stamp. A ragged last block holds only the columns that exist, as the
//    plain version's zero padding does.
// 4. Counts: per query, both are summed in the warp (redux), the warps'
//    sums meet in shared memory, and after the group one 64-bit atomicAdd
//    a block and query (none for a zero). Integer sums: the order does not
//    matter. The counts must be zero before the launch.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 4;                  // columns a thread on the fast path
constexpr int TILE = THREADS * VEC;     // columns a block on the fast path
constexpr int FAST_BLOCK = 32;          // block_c of the fast path
constexpr int UNROLL = 4;               // queries whose loads are issued together
constexpr int MAX_GROUP = 256;          // queries a block walks at most
constexpr int GEN_TILE = 1024;          // columns of a generic tile (whole blocks)
constexpr int WAVES = 2;                // blocks the grid aims at, in full waves
constexpr int BLOCKS_PER_SM = 3;        // resident blocks an SM (launch bounds)

__device__ __forceinline__ bool excluded(long long cid, long long tid, long long qid,
                                         long long tq) {
  return cid < 0 || cid == qid || (tq >= 0 && tid == tq);
}

// The plain version's priority of one element, before the exclusion.
template <bool kProxy>
__device__ __forceinline__ float priority(bool block_hit, int h, float p) {
  const float hf = __int2float_rn(h);
  if (kProxy) {
    const float squash = __fdiv_rn(p, __fadd_rn(1.0f, fabsf(p)));
    return __fadd_rn(__fadd_rn(block_hit ? 4.0f : 0.0f, hf), squash);
  }
  return __fadd_rn(block_hit ? 1.0f : -INFINITY, hf);
}

// The warps' sums of one query's counts, in shared memory.
__device__ __forceinline__ void warp_counts(unsigned nh, unsigned ns, unsigned* s_hits,
                                            unsigned* s_surv) {
  nh = __reduce_add_sync(0xffffffffu, nh);
  ns = __reduce_add_sync(0xffffffffu, ns);
  if ((threadIdx.x & 31) == 0) {
    s_hits[threadIdx.x >> 5] = nh;
    s_surv[threadIdx.x >> 5] = ns;
  }
}

// After the group: one atomicAdd a query and count, from the warps' sums.
__device__ __forceinline__ void flush_counts(unsigned (*s_hits)[WARPS],
                                             unsigned (*s_surv)[WARPS], int q0, int nq,
                                             int n_queries, unsigned long long* counts) {
  __syncthreads();
  for (int j = threadIdx.x; j < nq; j += THREADS) {
    unsigned a = 0, b = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      a += s_hits[j][w];
      b += s_surv[j][w];
    }
    if (a) atomicAdd(counts + q0 + j, (unsigned long long)a);
    if (b) atomicAdd(counts + n_queries + q0 + j, (unsigned long long)b);
  }
}

template <bool kProxy>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) coarse_priority_b32_kernel(
    const int32_t* __restrict__ hit, const float* __restrict__ proxy,
    const long long* __restrict__ cids, const long long* __restrict__ tids,
    const long long* __restrict__ tq, const long long* __restrict__ qid,
    float* __restrict__ prio, unsigned long long* __restrict__ counts, int n_queries,
    int n_cols, int group) {
  __shared__ unsigned s_hits[MAX_GROUP][WARPS], s_surv[MAX_GROUP][WARPS];
  const int lane = threadIdx.x & 31;
  const long long c = (long long)blockIdx.x * TILE + threadIdx.x * VEC;
  const bool live = c < n_cols;         // C % 4 == 0: a thread's 4 columns all exist or none
  long long cid[VEC], tid[VEC];
  if (live) {
    const longlong2* ci = reinterpret_cast<const longlong2*>(cids + c);
    const longlong2* ti = reinterpret_cast<const longlong2*>(tids + c);
    const longlong2 c01 = __ldg(ci), c23 = __ldg(ci + 1), t01 = __ldg(ti), t23 = __ldg(ti + 1);
    cid[0] = c01.x, cid[1] = c01.y, cid[2] = c23.x, cid[3] = c23.y;
    tid[0] = t01.x, tid[1] = t01.y, tid[2] = t23.x, tid[3] = t23.y;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) cid[k] = -1, tid[k] = -1;
  }
  const int q0 = blockIdx.y * group;
  const int nq = min(group, n_queries - q0);
  for (int i = 0; i < nq; i += UNROLL) {
    int4 h[UNROLL];
    float4 p[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      h[u] = make_int4(0, 0, 0, 0);
      p[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live && i + u < nq) {
        const long long at = (long long)(q0 + i + u) * n_cols + c;
        h[u] = __ldcs(reinterpret_cast<const int4*>(hit + at));
        if (kProxy) p[u] = __ldcs(reinterpret_cast<const float4*>(proxy + at));
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (i + u >= nq) break;           // the same for the whole block
      const int q = q0 + i + u;
      const long long qq = __ldg(qid + q), tt = __ldg(tq + q);
      const int hv[VEC] = {h[u].x, h[u].y, h[u].z, h[u].w};
      const float pv[VEC] = {p[u].x, p[u].y, p[u].z, p[u].w};
      const bool any = (hv[0] > 0) | (hv[1] > 0) | (hv[2] > 0) | (hv[3] > 0);
      // 8 lanes a block of 32 columns: the lane's group of the ballot
      const bool block_hit = (__ballot_sync(0xffffffffu, any) >> (lane & 24)) & 0xffu;
      float out[VEC];
      unsigned nh = 0, ns = 0;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const bool e = excluded(cid[k], tid[k], qq, tt);
        out[k] = e ? -INFINITY : priority<kProxy>(block_hit, hv[k], pv[k]);
        nh += (hv[k] > 0) & !e;
        ns += block_hit & !e;
      }
      if (live)
        __stcs(reinterpret_cast<float4*>(prio + (long long)q * n_cols + c),
               make_float4(out[0], out[1], out[2], out[3]));
      warp_counts(nh, ns, s_hits[i + u], s_surv[i + u]);
    }
  }
  flush_counts(s_hits, s_surv, q0, nq, n_queries, counts);
}

template <bool kProxy>
__global__ void __launch_bounds__(THREADS) coarse_priority_any_kernel(
    const int32_t* __restrict__ hit, const float* __restrict__ proxy,
    const long long* __restrict__ cids, const long long* __restrict__ tids,
    const long long* __restrict__ tq, const long long* __restrict__ qid,
    float* __restrict__ prio, unsigned long long* __restrict__ counts, int n_queries,
    int n_cols, int block_c, int tile_cols, int group) {
  __shared__ unsigned s_hits[MAX_GROUP][WARPS], s_surv[MAX_GROUP][WARPS];
  __shared__ int s_stamp[2][GEN_TILE];  // a block's last query with a hit, two queries deep
  const long long c0 = (long long)blockIdx.x * tile_cols;
  const int nc = (int)min((long long)tile_cols, (long long)n_cols - c0);
  for (int k = threadIdx.x; k < 2 * GEN_TILE; k += THREADS) (&s_stamp[0][0])[k] = -1;
  __syncthreads();
  const int q0 = blockIdx.y * group;
  const int nq = min(group, n_queries - q0);
  for (int j = 0; j < nq; ++j) {
    const int q = q0 + j;
    const long long row = (long long)q * n_cols + c0;
    // two buffers: the barrier after query j - 1's stamps also ends every
    // read of query j - 2's, in the buffer query j now fills
    int* stamp = s_stamp[j & 1];
    for (int k = threadIdx.x; k < nc; k += THREADS)
      if (hit[row + k] > 0) stamp[k / block_c] = j;
    __syncthreads();
    const long long qq = __ldg(qid + q), tt = __ldg(tq + q);
    unsigned nh = 0, ns = 0;
    for (int k = threadIdx.x; k < nc; k += THREADS) {
      const int h = hit[row + k];
      const bool block_hit = stamp[k / block_c] == j;
      const bool e = excluded(__ldg(cids + c0 + k), __ldg(tids + c0 + k), qq, tt);
      const float p = kProxy ? proxy[row + k] : 0.f;
      prio[row + k] = e ? -INFINITY : priority<kProxy>(block_hit, h, p);
      nh += (h > 0) & !e;
      ns += block_hit & !e;
    }
    warp_counts(nh, ns, s_hits[j], s_surv[j]);
  }
  flush_counts(s_hits, s_surv, q0, nq, n_queries, counts);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// hit (Q, C) int32, proxy (Q, C) float32 or null, cids / tids (C,) int64,
// tq / qid (Q,) int64 -> prio (Q, C) float32, and counts (2, Q) uint64 (the
// hits, then the survivors) added to, which the caller zeroes. n_sms sizes
// the grid. Returns the first CUDA error (0 when none).
int freyja_coarse_priority(const void* hit, const void* proxy, const void* cids,
                           const void* tids, const void* tq, const void* qid, void* prio,
                           void* counts, int n_queries, int n_cols, int block_c, int n_sms,
                           void* stream) {
  if (n_queries == 0 || n_cols == 0) return 0;
  if (block_c < 1 || n_sms < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* h = static_cast<const int32_t*>(hit);
  const auto* p = static_cast<const float*>(proxy);
  const auto* ci = static_cast<const long long*>(cids);
  const auto* ti = static_cast<const long long*>(tids);
  const auto* tqq = static_cast<const long long*>(tq);
  const auto* qi = static_cast<const long long*>(qid);
  auto* o = static_cast<float*>(prio);
  auto* n = static_cast<unsigned long long*>(counts);
  const bool fast = block_c == FAST_BLOCK && n_cols % VEC == 0 && aligned16(hit) &&
                    (proxy == nullptr || aligned16(proxy)) && aligned16(cids) &&
                    aligned16(tids) && aligned16(prio);
  const long long tile_cols =
      fast ? TILE : (block_c >= GEN_TILE ? block_c : (long long)(GEN_TILE / block_c) * block_c);
  const long long tiles = ceil_div(n_cols, tile_cols);
  // query groups: enough blocks for WAVES full waves, at most MAX_GROUP queries each
  const long long target = (long long)WAVES * BLOCKS_PER_SM * n_sms;
  long long groups = std::min<long long>(n_queries, std::max(1LL, ceil_div(target, tiles)));
  const int group = (int)std::min<long long>(MAX_GROUP, ceil_div(n_queries, groups));
  groups = ceil_div(n_queries, group);
  if (groups > 65535 || tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)groups);
  if (fast) {
    if (p)
      coarse_priority_b32_kernel<true><<<grid, THREADS, 0, st>>>(h, p, ci, ti, tqq, qi, o, n,
                                                                n_queries, n_cols, group);
    else
      coarse_priority_b32_kernel<false><<<grid, THREADS, 0, st>>>(h, p, ci, ti, tqq, qi, o, n,
                                                                 n_queries, n_cols, group);
  } else if (p) {
    coarse_priority_any_kernel<true><<<grid, THREADS, 0, st>>>(
        h, p, ci, ti, tqq, qi, o, n, n_queries, n_cols, block_c, (int)tile_cols, group);
  } else {
    coarse_priority_any_kernel<false><<<grid, THREADS, 0, st>>>(
        h, p, ci, ti, tqq, qi, o, n, n_queries, n_cols, block_c, (int)tile_cols, group);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
