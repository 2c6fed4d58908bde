// Exact top-k in jax.lax.top_k's order for Hopper (sm_90a).
//
// Replaces: jax.lax.top_k (XLA's TopK; there is no pallas_call) at
//   src/repro/exec/stages.py:155 (gather_candidates), :205 (merge_topk),
//   :223 (merge_topk_sharded), src/repro/exec/executor.py:153
//   (_rescore_exact), src/repro/models/moe.py:92 (the router) and
//   src/repro/core/profiles.py:150 (the top-10 words). Before this kernel
//   the port took every top-k from a full stable sort of the row (cub's
//   segmented radix sort), which also treated -0.0 and +0.0 as equal and put
//   every NaN first.
// Order. Each float32 maps to an order-preserving 32-bit key: its bits with
//   the sign bit set when non-negative, all bits flipped when negative. The
//   keys then run -NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN, one
//   key a bit pattern. A key packed above the complemented column index in
//   64 bits makes every element of a row unique; the k largest packed words
//   in descending order are jax.lax.top_k's positions, the lower index first
//   among equal bit patterns.
// Bound on the H100: bytes. The scores are read once and k positions
//   written, R·N·4 + R·k·8 bytes over 3.35 TB/s (the main path's (64, 100k)
//   at k = 10: 0.0076 ms); a compare or two an element is far below the
//   card's integer rate.
// Design, by the wrapper's plan (kernels/topk.py::topk_plan):
//   - warp (k <= 128: the merges' 10, 40 and 100, the router's 2, the
//     profiles' 10): a warp takes a slice of a row and keeps its k largest
//     words in registers, sorted, spread over the lanes. A batch of 32 words
//     costs one compare and one ballot against the k-th word; the words
//     above it are buffered, 32 at a time sorted and merged into the list
//     by shuffle networks. Once the first k are held, a random row passes
//     ~k·ln(slice / k) words of a slice, so the slice is read at the
//     memory's pace. Then the same kernel over the slices' words, until one
//     slice a row writes the positions: 1-3 launches, each score read once.
//     A row in ascending order passes every word (the slowest input).
//   - sort (N <= 4096, k > 128): one block a row packs the row into
//     shared memory and sorts it with a bitonic network; the first k
//     positions are written. One launch; the tiered plan's (64, 2048) fine
//     gather at k = 2048.
//   - select (N > 4096, k > 128: the budget gathers' 2048 and 4096):
//     radix select of the k-th largest key T, 8 bits a round over 4
//     rounds, each row split over up to 64 blocks that read the row in
//     parallel. A round's blocks histogram the next
//     digit of the keys that match the prefix chosen so far (warp-aggregated
//     shared atomics: a row of equal scores puts every key in one bin) and
//     store their histogram; the last block of the row to finish (an atomic
//     ticket) sums them and picks the bin where the k-th key falls. Then a
//     collect pass writes every key above T (an atomic slot: they are sorted
//     afterwards) and the lowest-index keys equal to T: each block starts at
//     the count of T's in the blocks before it (their last-round histograms)
//     and ranks its own in index order with a ballot scan, so the choice is
//     the same whatever order the blocks run in, as the lsh stage's rows of
//     0.0 hits and -inf need. Last, the k words a row are sorted: in shared
//     memory in one launch when 2^ceil(log2 k) <= 4096 (six launches in all;
//     the scores read five times, from L2 after the first at the main
//     path's (64, 100k)); past that (a budget above 4096) by the same
//     bitonic network over a (R, 2^ceil(log2 k)) scratch, chunks of 4096 in
//     shared memory and the strides above a chunk in global passes. The
//     network costs O(k log^2 k): near k = N it is slower than the stable
//     sort it replaced (PERF.md).
//   Scratch comes from the wrapper (torch.empty on the current stream), the
//   per-row state zeroed, so concurrent calls share nothing.
// Measured on the H100 (700 W; PERF.md, chip_smoke.py phase 4): (64, 100k)
//   k = 10 0.0431 ms (the stable sort it replaced 0.5263), k = 4096 0.1377
//   (0.5647), k = 8192 0.1643 (0.5685), k = N 1.6426 (0.5675: slower),
//   (64, 4,194,304) k = 100 0.9632 (18.4861); the select regime at 5-7% of
//   its bound is the one left to tune.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int SORT_MAX = 4096;        // words one block sorts in shared memory
constexpr int RADIX_THREADS = 256;    // threads of a radix round or a collect: one a bin
constexpr int BINS = 256;
constexpr int UNROLL = 8;             // loads in flight a thread
constexpr int WARP_UNROLL = 8;        // words a lane of the warp regime loads at once
constexpr int WARPS = 8;              // warps a block of the warp regime
constexpr int WARP_K_MAX = 128;       // the warp regime's largest k: 4 words a lane
constexpr int STATE = 8;              // per-row state words
// state words: the key prefix chosen so far, the count of keys equal to it
// still to take, the slot counter of keys above T, one ticket a round
constexpr int ST_PREFIX = 0, ST_KK = 1, ST_GT = 2, ST_TICKET = 3;

__device__ __forceinline__ unsigned f2key(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ u64 pack(unsigned key, long long idx) {
  return ((u64)key << 32) | (u64)(~(unsigned)idx);
}

// Sort `chunk` packed words a block in shared memory, descending over the
// whole (R, p) array: the network's stages for sizes size_lo..size_hi, each
// from its stride (at most chunk / 2) down to 1. The source is the float32
// rows (packed on load) or packed words; padding past n is 0, below every
// real word (a real word's low half is ~index > 0). EMIT writes the first k
// positions of each row, otherwise the words go back to dst.
template <bool FROM_FLOATS, bool EMIT>
__global__ void bitonic_chunk(const float* __restrict__ x, const u64* src, u64* dst,
                              long long* __restrict__ out, long long n, long long ld,
                              long long p, int chunk, long long size_lo, long long size_hi,
                              int k) {
  extern __shared__ u64 s[];
  const long long row = blockIdx.x;
  const long long c0 = (long long)blockIdx.y * chunk;
  if (EMIT && c0 >= k) return;
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
    const long long g = c0 + i;
    u64 v = 0;
    if (g < n) {
      if (FROM_FLOATS) v = pack(f2key(x[row * ld + g]), g);
      else v = src[row * ld + g];
    }
    s[i] = v;
  }
  __syncthreads();
  const int half = chunk >> 1;
  for (long long size = size_lo; size <= size_hi; size <<= 1) {
    for (int stride = (int)(size / 2 < half ? size / 2 : half); stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const bool desc = ((c0 + i) & size) == 0;
        const u64 a = s[i], b = s[j];
        if ((a < b) == desc) {
          s[i] = b;
          s[j] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
    const long long g = c0 + i;
    if (EMIT) {
      if (g < k) out[row * k + g] = (long long)(~(unsigned)(s[i] & 0xffffffffull));
    } else {
      dst[row * p + g] = s[i];
    }
  }
}

// One stage of the network at a stride of a chunk or more, over (rows, p).
__global__ void bitonic_global(u64* a, long long rows, long long p, long long size,
                               long long stride) {
  const long long half = p >> 1, total = rows * half;
  for (long long f = (long long)blockIdx.x * blockDim.x + threadIdx.x; f < total;
       f += (long long)gridDim.x * blockDim.x) {
    const long long row = f / half, t = f % half;
    const long long i = 2 * t - (t & (stride - 1)), j = i + stride;
    const bool desc = (i & size) == 0;
    u64* r = a + row * p;
    const u64 v = r[i], w = r[j];
    if ((v < w) == desc) {
      r[i] = w;
      r[j] = v;
    }
  }
}

// One radix round: block (row, slice) histograms digit (key >> shift) & 255
// of its slice's keys whose bits under `mask` equal the row's prefix; the
// row's last block picks the bin of the kk-th largest key.
__global__ void __launch_bounds__(RADIX_THREADS)
radix_round(const float* __restrict__ x, long long n, int slices, long long slice_len,
            int round, unsigned mask, int shift, int k, int* state, int* hist) {
  __shared__ int h[BINS];
  __shared__ int incl[BINS];
  __shared__ bool last;
  const long long row = blockIdx.x;
  const int b = blockIdx.y;
  int* st = state + row * STATE;
  const unsigned prefix = round == 0 ? 0u : (unsigned)st[ST_PREFIX];
  const unsigned lane = threadIdx.x & 31;
  h[threadIdx.x] = 0;
  __syncthreads();
  const float* xr = x + row * n;
  const long long lo = (long long)b * slice_len;
  const long long hi = lo + slice_len < n ? lo + slice_len : n;
  for (long long base = lo; base < hi; base += (long long)RADIX_THREADS * UNROLL) {
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + u * RADIX_THREADS + threadIdx.x;
      v[u] = i < hi ? __ldg(xr + i) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + u * RADIX_THREADS + threadIdx.x;
      const unsigned key = f2key(v[u]);
      const bool in = i < hi && (key & mask) == prefix;
      const unsigned active = __ballot_sync(0xffffffffu, in);
      if (in) {
        const unsigned digit = (key >> shift) & 0xffu;
        const unsigned peers = __match_any_sync(active, digit);
        if ((int)lane == __ffs(peers) - 1) atomicAdd(&h[digit], __popc(peers));
      }
    }
  }
  __syncthreads();
  hist[(row * slices + b) * BINS + threadIdx.x] = h[threadIdx.x];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(st + ST_TICKET + round, 1) == slices - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int kk = round == 0 ? k : st[ST_KK];
  int c = 0;
  for (int s2 = 0; s2 < slices; ++s2) c += __ldcg(hist + (row * slices + s2) * BINS + threadIdx.x);
  // counts of the bins >= t: an inclusive scan from the top bin down
  const int u = BINS - 1 - threadIdx.x;
  incl[u] = c;
  __syncthreads();
  for (int off = 1; off < BINS; off <<= 1) {
    const int add = u >= off ? incl[u - off] : 0;
    __syncthreads();
    incl[u] += add;
    __syncthreads();
  }
  const int ge = incl[u], gt = ge - c;
  if (gt < kk && kk <= ge) {
    st[ST_PREFIX] = (int)(prefix | ((unsigned)threadIdx.x << shift));
    st[ST_KK] = kk - gt;
  }
}

// Write the row's k words: every key above T at an atomic slot in [0, k - kk),
// and the kk lowest-index keys equal to T in index order at [k - kk, k).
__global__ void __launch_bounds__(RADIX_THREADS)
collect(const float* __restrict__ x, long long n, int slices, long long slice_len, int k,
        int* state, const int* __restrict__ hist, u64* cand) {
  __shared__ int warp_eq[RADIX_THREADS / 32];
  const long long row = blockIdx.x;
  const int b = blockIdx.y;
  int* st = state + row * STATE;
  const unsigned t_key = (unsigned)st[ST_PREFIX];
  const int kk = st[ST_KK];
  const int n_gt = k - kk;
  const int bin = (int)(t_key & 0xffu);
  // the T's of the blocks before this one: their last round's bin of T
  int before = 0;
  for (int s2 = 0; s2 < b; ++s2) before += hist[(row * slices + s2) * BINS + bin];
  const int mine = hist[(row * slices + b) * BINS + bin];
  bool need_eq = before < kk && mine > 0;
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* xr = x + row * n;
  u64* cr = cand + row * k;
  const long long lo = (long long)b * slice_len;
  const long long hi = lo + slice_len < n ? lo + slice_len : n;
  for (long long base = lo; base < hi; base += (long long)RADIX_THREADS * UNROLL) {
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + u * RADIX_THREADS + threadIdx.x;
      v[u] = i < hi ? __ldg(xr + i) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + u * RADIX_THREADS + threadIdx.x;
      const bool ok = i < hi;
      const unsigned key = f2key(v[u]);
      if (ok && key > t_key) cr[atomicAdd(st + ST_GT, 1)] = pack(key, i);
      if (need_eq) {                       // uniform over the block
        const bool eq = ok && key == t_key;
        const unsigned bal = __ballot_sync(0xffffffffu, eq);
        if (lane == 0) warp_eq[warp] = __popc(bal);
        __syncthreads();
        int off = before, total = 0;
#pragma unroll
        for (int w = 0; w < RADIX_THREADS / 32; ++w) {
          off += (int)w < (int)warp ? warp_eq[w] : 0;
          total += warp_eq[w];
        }
        const int rank = off + __popc(bal & ((1u << lane) - 1u));
        if (eq && rank < kk) cr[n_gt + rank] = pack(key, i);
        before += total;
        need_eq = before < kk;
        __syncthreads();
      }
    }
  }
}

// A warp's 32 words (one a lane) sorted descending: a bitonic network of
// shuffles.
__device__ __forceinline__ u64 sort32_desc(u64 b, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const u64 o = __shfl_xor_sync(0xffffffffu, b, stride);
      const bool keep_max = ((lane & stride) == 0) == ((lane & size) == 0);
      b = keep_max ? (b > o ? b : o) : (b < o ? b : o);
    }
  }
  return b;
}

// A bitonic sequence over the warp sorted descending (the half-cleaners).
__device__ __forceinline__ u64 merge32_desc(u64 b, int lane) {
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const u64 o = __shfl_xor_sync(0xffffffffu, b, stride);
    b = (lane & stride) == 0 ? (b > o ? b : o) : (b < o ? b : o);
  }
  return b;
}

// Merge 32 words (one a lane, any order) into the list e, sorted descending
// as chunks of 32 (chunk r in e[r], word r * 32 + lane): the words sorted,
// then merged with chunk 0 (the larger 32 of the two runs, a bitonic
// sequence, stay; the smaller 32 go on to chunk 1), and so on; the last
// smaller 32 drop out.
template <int R>
__device__ __forceinline__ void merge_into(u64 (&e)[R], u64 b, int lane) {
  b = sort32_desc(b, lane);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const u64 rev = __shfl_sync(0xffffffffu, b, 31 - lane);
    const u64 hi = e[r] > rev ? e[r] : rev, lo = e[r] > rev ? rev : e[r];
    e[r] = merge32_desc(hi, lane);
    if (r + 1 < R) b = merge32_desc(lo, lane);
  }
}

// One warp a slice of a row keeps the slice's k largest words (k <= 128) in
// registers, sorted descending as R chunks of 32. A batch of 32 words costs
// one compare and one ballot against the list's k-th word; the words above
// it go to the warp's 32-word buffer in shared memory, and a full buffer is
// sorted and merged into the list (shuffle networks), which raises the k-th
// word. A slice writes its k words (0 past its end: below every real word),
// or, in the last pass (one slice a row), the k positions.
template <int R, bool FROM_FLOATS>
__global__ void __launch_bounds__(WARPS * 32)
warp_topk(const float* __restrict__ x, const u64* __restrict__ src, u64* __restrict__ dst,
          long long* __restrict__ out, long long n, long long slice_len, int slices, int k,
          int emit) {
  __shared__ u64 sbuf[WARPS][32];
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.y * WARPS + (threadIdx.x >> 5);
  if (w >= slices) return;
  u64* buf = sbuf[threadIdx.x >> 5];
  const long long row = blockIdx.x;
  const long long lo = (long long)w * slice_len;
  const long long hi = lo + slice_len < n ? lo + slice_len : n;
  const int kr = (k - 1) >> 5, kl = (k - 1) & 31;
  const unsigned below = (1u << lane) - 1u;
  u64 e[R];
#pragma unroll
  for (int r = 0; r < R; ++r) e[r] = 0;
  u64 thr = 0;                           // the k-th word; 0 until k words are held
  int count = 0;                         // words in the buffer
  for (long long base = lo; base < hi; base += 32 * WARP_UNROLL) {
    u64 v[WARP_UNROLL];
#pragma unroll
    for (int u = 0; u < WARP_UNROLL; ++u) {
      const long long i = base + u * 32 + lane;
      v[u] = 0;
      if (i < hi) {
        if (FROM_FLOATS) v[u] = pack(f2key(__ldg(x + row * n + i)), i);
        else v[u] = src[row * n + i];
      }
    }
#pragma unroll
    for (int u = 0; u < WARP_UNROLL; ++u) {
      unsigned m = __ballot_sync(0xffffffffu, v[u] > thr);
      if (m == 0) continue;
      if (count + __popc(m) > 32) {
        __syncwarp();
        const u64 b = lane < count ? buf[lane] : 0ull;
        __syncwarp();
        merge_into<R>(e, b, lane);
        count = 0;
        u64 t = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) t = r == kr ? e[r] : t;
        thr = __shfl_sync(0xffffffffu, t, kl);
        m = __ballot_sync(0xffffffffu, v[u] > thr);
      }
      if (v[u] > thr) buf[count + __popc(m & below)] = v[u];
      count += __popc(m);
    }
  }
  __syncwarp();
  if (count > 0) merge_into<R>(e, lane < count ? buf[lane] : 0ull, lane);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int idx = r * 32 + lane;
    if (idx < k) {
      if (emit) out[row * k + idx] = (long long)(~(unsigned)(e[r] & 0xffffffffull));
      else dst[(row * slices + w) * k + idx] = e[r];
    }
  }
}

template <int R>
void launch_warp(bool from_floats, dim3 grid, cudaStream_t stream, const float* x,
                 const u64* src, u64* dst, long long* out, long long n, long long slice_len,
                 int slices, int k, int emit) {
  if (from_floats)
    warp_topk<R, true><<<grid, WARPS * 32, 0, stream>>>(x, src, dst, out, n, slice_len,
                                                        slices, k, emit);
  else
    warp_topk<R, false><<<grid, WARPS * 32, 0, stream>>>(x, src, dst, out, n, slice_len,
                                                         slices, k, emit);
}

int launch_threads(int chunk) {
  const int t = chunk / 2;
  return t < 32 ? 32 : (t > 1024 ? 1024 : t);
}

// Sort each row's first n words (the float32 row packed on load, or words
// at src with row stride ld) descending and write the first k positions.
// p = 2^ceil(log2 n): up to SORT_MAX one block a row sorts the row in
// shared memory; past it, chunks of SORT_MAX sorted in shared memory into
// buf (rows, p), the strides of a chunk or more in global passes, the last
// chunk pass writing the positions.
template <bool FROM_FLOATS>
cudaError_t sort_emit(const float* x, const u64* src, u64* buf, long long* out,
                      long long rows, long long n, long long ld, long long p, int k,
                      cudaStream_t stream) {
  if (p <= SORT_MAX) {
    const int chunk = (int)p;
    bitonic_chunk<FROM_FLOATS, true><<<dim3((unsigned)rows, 1), launch_threads(chunk),
                                       chunk * sizeof(u64), stream>>>(
        x, src, nullptr, out, n, ld, p, chunk, 2, p, k);
    return cudaGetLastError();
  }
  const int chunk = SORT_MAX;
  const dim3 grid((unsigned)rows, (unsigned)(p / chunk));
  const int threads = launch_threads(chunk);
  const size_t smem = chunk * sizeof(u64);
  bitonic_chunk<FROM_FLOATS, false><<<grid, threads, smem, stream>>>(
      x, src, buf, nullptr, n, ld, p, chunk, 2, chunk, k);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long pairs = rows * (p / 2);
  long long blocks = (pairs + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;
  for (long long size = 2LL * chunk; size <= p; size <<= 1) {
    for (long long stride = size / 2; stride >= chunk; stride >>= 1) {
      bitonic_global<<<(unsigned)blocks, 256, 0, stream>>>(buf, rows, p, size, stride);
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
    if (size == p)
      bitonic_chunk<false, true><<<grid, threads, smem, stream>>>(
          nullptr, buf, nullptr, out, p, p, p, chunk, size, size, k);
    else
      bitonic_chunk<false, false><<<grid, threads, smem, stream>>>(
          nullptr, buf, buf, nullptr, p, p, p, chunk, size, size, k);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// x (rows, n) float32 -> out (rows, k) int64 positions, by the wrapper's
// plan (kernels/topk.py::topk_plan). regime 0: sort (p = 2^ceil(log2 n)
// <= 4096); 1: select (passes[0..1] = slices, slice length; buf (rows, k)
// words, state (rows, 8) zeroed, hist (rows, slices, 256); p =
// 2^ceil(log2 k), buf2 (rows, p) words when p > 4096); 2: warp (k <= 128;
// passes = (slices, slice length) a pass, the last of one slice; buf (rows,
// slices of pass 1 x k) and buf2 (rows, slices of pass 2 x k) words between
// the passes).
extern "C" int freyja_topk(const float* x, long long* out, int* state, int* hist, u64* buf,
                           u64* buf2, long long rows, long long n, int k, int regime,
                           const long long* passes, int n_passes, long long p,
                           cudaStream_t stream) {
  if (rows <= 0 || k <= 0) return 0;
  if (rows > 0x7fffffffLL || n >= 0x7fffffffLL || k > n) return (int)cudaErrorInvalidValue;
  if (regime == 0) {
    if (p > SORT_MAX || p < n) return (int)cudaErrorInvalidValue;
    return (int)sort_emit<true>(x, nullptr, nullptr, out, rows, n, n, p, k, stream);
  }
  if (regime == 1) {
    if (n_passes != 1) return (int)cudaErrorInvalidValue;
    const long long slices_ll = passes[0], slice_len = passes[1];
    if (p < k || (p & (p - 1)) != 0 || p / SORT_MAX > 65535 || (p > SORT_MAX && !buf2) ||
        slices_ll < 1 || slices_ll > 65535 || (slices_ll - 1) * slice_len >= n ||
        slices_ll * slice_len < n)
      return (int)cudaErrorInvalidValue;
    const int slices = (int)slices_ll;
    const unsigned masks[4] = {0u, 0xff000000u, 0xffff0000u, 0xffffff00u};
    const dim3 grid((unsigned)rows, (unsigned)slices);
    for (int r = 0; r < 4; ++r) {
      radix_round<<<grid, RADIX_THREADS, 0, stream>>>(x, n, slices, slice_len, r, masks[r],
                                                      24 - 8 * r, k, state, hist);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    collect<<<grid, RADIX_THREADS, 0, stream>>>(x, n, slices, slice_len, k, state, hist, buf);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return (int)sort_emit<false>(nullptr, buf, buf2, out, rows, k, k, p, k, stream);
  }
  if (regime == 2) {
    if (k > WARP_K_MAX || n_passes < 1 || passes[2 * (n_passes - 1)] != 1)
      return (int)cudaErrorInvalidValue;
    const u64* src = nullptr;
    long long len = n;
    for (int i = 0; i < n_passes; ++i) {
      const long long slices = passes[2 * i], slice_len = passes[2 * i + 1];
      if (slices < 1 || (slices - 1) * slice_len >= len || slices * slice_len < len ||
          (slices + WARPS - 1) / WARPS > 65535)
        return (int)cudaErrorInvalidValue;
      u64* dst = i % 2 == 0 ? buf : buf2;
      const int emit = i == n_passes - 1;
      const dim3 grid((unsigned)rows, (unsigned)((slices + WARPS - 1) / WARPS));
      if (k <= 32)
        launch_warp<1>(i == 0, grid, stream, x, src, dst, out, len, slice_len, (int)slices, k,
                       emit);
      else if (k <= 64)
        launch_warp<2>(i == 0, grid, stream, x, src, dst, out, len, slice_len, (int)slices, k,
                       emit);
      else
        launch_warp<4>(i == 0, grid, stream, x, src, dst, out, len, slice_len, (int)slices, k,
                       emit);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      src = dst;
      len = slices * k;
    }
    return 0;
  }
  return (int)cudaErrorInvalidValue;
}
