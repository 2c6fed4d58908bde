// Banded-LSH probe of each query against its own survivor rows, for Hopper
// (sm_90a).
//
// Replaces: repro/kernels/lsh_probe.py::lsh_probe_gathered_pallas (the
//   Pallas kernel _gathered_kernel: hit[q, c'] = any_b(qkeys[q, b] ==
//   ckeys[q, c', b])), the fine probe of the tiered candidate stage.
//
// Two forms, one kernel. The indexed form reads query q's row c' in place
//   from the resident (N, B) key table through its position pos[q, c']:
//   hit[q, c'] = any_b(qkeys[q, b] == table[pos[q, c'], b]). The tiered
//   stage no longer writes the (Q, C', B) gathered copy of its survivors'
//   keys only to read it back. The pre-gathered form (the TPU kernel's
//   signature, (Q, C', B) keys) is the special case pos[q, c'] = q·C' + c'
//   over a (Q·C', B) view, passed as a null pos. A position outside
//   [-N, N) traps the kernel (the error surfaces at the next
//   synchronization), as the plain version's indexing raises; a negative
//   one counts from the end, as torch indexing does.
//
// Bound on the H100 at the main path's shapes (Q = 64 queries, C' = 2048
//   survivors each, B = 64 bands): bytes. The function must read each
//   distinct row the positions name once, the positions (1 MB) and write the
//   hit mask (0.5 MB); the 8.4e6 compares are far below the integer rate.
//   Neighbouring queries share most survivors (the coarse digest picks
//   blocks of columns), so the 131,072 positions name ~12,000 distinct rows
//   (3.1 MB, ~1.4 us in all at 3.35 TB/s), and the repeats are read from
//   L2. The pre-gathered form reads all Q x C' x B x 4 = 33.5 MB (~10 us).
//
// Design. A warp takes a chunk of 32 rows of one query: each lane reads one
//   row's position (one coalesced 256-byte load a warp), checks it, and
//   later writes that row's flag (one coalesced 128-byte store). Two
//   variants of one walk. When B % 4 == 0, B <= 64 and the table is 16-byte
//   aligned (the main path's B = 64), 16 neighbouring lanes read a row, 16
//   bytes (4 keys) each, so one LDG.128 a warp reads two whole 256-byte
//   rows. Every other B (1-256) and an unaligned table take one key a load:
//   32 lanes read a row, lane l the keys l, l + 32, ... (at most 8). The
//   positions reach the reading lanes by __shfl_sync. Each lane keeps the
//   query keys of its band slots in registers, loaded once a chunk's query
//   changes, so a compare is register against register, with no shared
//   memory and no band arithmetic. A row's hit is one __ballot_sync over its
//   lanes. A lane issues UNROLL rows' loads before the first compare, so
//   several loads are in flight. A persistent grid (the SM count, passed by
//   the wrapper, x resident blocks, queried once per variant) walks the
//   (query, chunk) items. The pre-gathered form's rows, each read once, are
//   loaded evict-first (__ldcs); the indexed form's keep the default policy,
//   since its repeated rows come from L2. Rows padded with PAD_CORPUS and
//   queries padded with PAD_QUERY hold different sentinels and never match.
//
// Measured on the H100 (700 W; PERF.md): the indexed form at the main path
//   takes ~0.0124 ms, of which ~0.0047 ms is the launch floor of the timing
//   harness; the earlier route, the ck[pos] index kernel and then a probe of
//   the copy, took ~0.094 ms. The pre-gathered form takes ~0.0197 ms (the
//   earlier kernel: one block per query tile, a flat walk with a band
//   counter, the query in shared memory, 0.0220 ms). What did not help:
//   UNROLL 2 or 4 (slower), evict-first loads in the indexed form (5%
//   slower); without the 64-register cap the 16-byte variant took 77
//   registers, 3 blocks an SM, and 12% more time. The one-key variant
//   holds 8 keys' slots a lane at every B (128 registers) and takes
//   ~0.039 ms at B = 64 over an unaligned table, which no path passes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 32;           // rows a warp takes at once: one a lane
constexpr int UNROLL = 8;           // row steps whose loads a lane issues together
constexpr int MIN_BLOCKS = 4;       // blocks an SM the 16-byte variant's registers allow
constexpr int MAX_BANDS = 256;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ bool match(uint32_t a, uint32_t b) { return a == b; }
__device__ __forceinline__ bool match(uint4 a, uint4 b) {
  return (a.x == b.x) | (a.y == b.y) | (a.z == b.z) | (a.w == b.w);
}

__device__ __forceinline__ void load_query(uint32_t& v, const uint32_t* q) { v = q[0]; }
__device__ __forceinline__ void load_query(uint4& v, const uint32_t* q) {
  v = make_uint4(q[0], q[1], q[2], q[3]);
}

// Vec: uint4 (4 keys a load) or uint32_t (1 key). LANES lanes read a row;
// lane `sub` reads the row's vectors sub, sub + LANES, ... below nv, at most
// PER of them. The 16-byte variant is held to MIN_BLOCKS blocks an SM (64
// registers): then the main path's 512 blocks are all resident at once (77
// registers left 3 an SM and a second round).
template <typename Vec, int LANES, int PER>
__global__ void __launch_bounds__(THREADS, sizeof(Vec) == 16 ? MIN_BLOCKS : 1)
    probe_kernel(const uint32_t* __restrict__ qkeys, const Vec* __restrict__ table,
                 const long long* __restrict__ pos, int32_t* __restrict__ out,
                 int n_queries, int n_rows, int n_bands, long long n_table, int n_chunks) {
  constexpr int KEYS = sizeof(Vec) / sizeof(uint32_t);
  constexpr int RPW = 32 / LANES;                  // rows a warp reads a step
  constexpr int STEPS = CHUNK / RPW;
  static_assert(STEPS % UNROLL == 0, "a chunk is whole rounds of UNROLL steps");
  constexpr unsigned SEG = LANES == 32 ? FULL : (1u << LANES) - 1;
  const int nv = n_bands / KEYS;
  const int lane = threadIdx.x & 31, group = lane / LANES, sub = lane % LANES;
  const long long n_items = (long long)n_queries * n_chunks;
  const long long n_warps = (long long)gridDim.x * WARPS;
  const bool stream = pos == nullptr;              // rows read once: evict-first
  int cur = -1;
  Vec qv[PER];
  for (long long item = (long long)blockIdx.x * WARPS + threadIdx.x / 32; item < n_items;
       item += n_warps) {
    const int q = (int)(item / n_chunks);
    const int row = (int)(item % n_chunks) * CHUNK + lane;   // this lane's row
    if (q != cur) {
      cur = q;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int v = sub + i * LANES;
        if (v < nv) load_query(qv[i], qkeys + (long long)q * n_bands + v * KEYS);
      }
    }
    long long p = -1;                              // -1: past the last row
    if (row < n_rows) {
      const long long flat = (long long)q * n_rows + row;
      if (pos == nullptr) {
        p = flat;
      } else {
        p = pos[flat];
        if (p < 0) p += n_table;
        if (p < 0 || p >= n_table) __trap();
      }
    }
    int hit = 0;
#pragma unroll
    for (int s0 = 0; s0 < STEPS; s0 += UNROLL) {
      Vec k[UNROLL][PER];
      bool live[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long pr = __shfl_sync(FULL, p, (s0 + u) * RPW + group);
        live[u] = pr >= 0;
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int v = sub + i * LANES;
          if (live[u] && v < nv) k[u][i] = stream ? __ldcs(table + pr * nv + v) : table[pr * nv + v];
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        bool m = false;
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int v = sub + i * LANES;
          if (live[u] && v < nv) m |= match(k[u][i], qv[i]);
        }
        const unsigned b = __ballot_sync(FULL, m);
        // lane l owns the chunk's row l: step l / RPW, group l % RPW
        if (lane / RPW == s0 + u) hit = ((b >> ((lane % RPW) * LANES)) & SEG) != 0;
      }
    }
    if (row < n_rows) out[(long long)q * n_rows + row] = hit;
  }
}

template <typename Vec, int LANES, int PER>
int launch(const uint32_t* qkeys, const void* table, const long long* pos, int32_t* out,
           int n_queries, int n_rows, int n_bands, long long n_table, int n_sms,
           cudaStream_t stream) {
  static const int per_sm = [] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, probe_kernel<Vec, LANES, PER>, THREADS, 0);
    return n > 0 ? n : 1;
  }();
  const int n_chunks = (n_rows + CHUNK - 1) / CHUNK;
  const long long want = ((long long)n_queries * n_chunks + WARPS - 1) / WARPS;
  const long long cap = (long long)per_sm * (n_sms > 0 ? n_sms : 1);
  probe_kernel<Vec, LANES, PER><<<(unsigned)(want < cap ? want : cap), THREADS, 0, stream>>>(
      qkeys, static_cast<const Vec*>(table), pos, out, n_queries, n_rows, n_bands, n_table,
      n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int freyja_lsh_probe_gathered_max_bands() { return MAX_BANDS; }

// qkeys (Q, B) u32 bits; table (N, B) u32 bits; pos (Q, C') int64 positions
// into the table, or null for the pre-gathered form (table (Q·C', B), N =
// Q·C') -> out (Q, C') int32, on `stream`. n_sms: the card's SM count.
// Returns cudaGetLastError() after the launch.
int freyja_lsh_probe_gathered(const void* qkeys, const void* table, const void* pos,
                              void* out, int n_queries, int n_rows, int n_bands,
                              long long n_table, int n_sms, void* stream) {
  if (n_queries == 0 || n_rows == 0) return 0;   // B = 0 still checks positions
  if (n_bands > MAX_BANDS) return (int)cudaErrorInvalidValue;
  const bool vec16 = n_bands % 4 == 0 && n_bands <= 64 &&
                     reinterpret_cast<uintptr_t>(table) % 16 == 0;
  const auto fn = vec16 ? launch<uint4, 16, 1> : launch<uint32_t, 32, MAX_BANDS / 32>;
  return fn(static_cast<const uint32_t*>(qkeys), table, static_cast<const long long*>(pos),
            static_cast<int32_t*>(out), n_queries, n_rows, n_bands, n_table, n_sms,
            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
