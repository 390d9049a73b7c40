// L6 match finder on NVIDIA Hopper (sm_90a): (ml, dist) for every position
// of [32 KiB history | payload] windows, one thread block per window.
//
// Replaces the JAX package's XLA graph libdeflate_rsx_tpu/ops/
// encode_dynamic.py:194 find_matches_l6 (no Pallas kernel) and computes
// what its plain PyTorch version, ops/encode_dynamic.py
// find_matches_l6_plain, computes, for every position:
// - base tier: candidate j (1..4) of a position is the j-th nearest
//   earlier position with the same 4-byte little-endian word, kept when
//   it lies within 32,768 bytes and at or past hist_start, and when the
//   position's rank in the stable sort of the window's words is at least
//   2j (the JAX graph tests its shifted position vector against j, so the
//   first 8 positions of the sorted order lose candidates); its length is
//   4 plus the common prefix of the next 12 bytes;
// - rank ladder on the even positions (the grid): at L = 16, 32, 64 the
//   up to 6 nearest earlier grid positions whose L-byte prefix is equal
//   as the ladder's dense ranks define it (a grid position whose rank
//   partner lies past the grid's end is equal to no other), kept under
//   the same window and hist_start rule, of length L plus the common
//   prefix of the 8 bytes at L; merged into the base tier's candidate
//   (longer wins, then nearer), level by level;
// - covering decay: an inclusive prefix max of (ml + pos) << 15 |
//   (32768 - dist) over the positions with ml >= 4 lends a covering
//   match's remainder to each position it covers where it is longer;
//   then clip to min(valid_len - pos, 258) and zero below 4.
//
// The TPU form builds this from stable sorts and inverse permutations
// (no fast scatter or hash table there), and the long matches from a
// ladder of 2-key sorts because one 64-byte lexicographic sort made XLA's
// compile explode. Here the sorts are the kernel's own: each is an LSD
// radix sort of one window inside one thread block, over keys that the
// ladder keeps narrow:
// - the base sort orders 64-bit elements (word << 17 | position) by 4
//   8-bit digits of the word, over the window's s positions and the 4
//   past it (their words give the 8-byte ranks of the last grid
//   positions; they sort after every equal word of the window, and a
//   position's rank for the rule above discounts those with smaller
//   words);
// - the 8-byte rank of grid position g is the dense rank of the pair of
//   word ranks at 2g and 2g + 4 (17 bits each: 5 digits; the word ranks
//   are kept for even positions only); each ladder level sorts the pair
//   (rank at g, rank at g + L/4) in 16 bits each (4 digits), a partner
//   past the grid taking a label above every rank;
// - a pass: the pass's digit counts give each digit its first slot; then
//   tile by tile (kTile elements, in order) each warp ranks its share by
//   digit with __match_any_sync, a scan of the warps' counts puts the
//   tile in digit order in shared memory, and the tile goes out in that
//   order, each digit's run to consecutive addresses. Stable, with no
//   atomics on the output, and the writes coalesce: writing each element
//   to its own slot (the first design) made the sorts 1.4-2.0x slower
//   on this card. Element reads and writes are streamed (__ldcs,
//   __stcs), which leaves L2 to the ranks and candidates that the sweeps
//   write by position;
// - after each sort one sweep in sorted order, a tile at a time staged
//   in shared memory, reads a position's candidates from its neighbours,
//   compares their bytes in the window held in shared memory, merges
//   them into the position's best candidate, and takes the next level's
//   dense ranks from a block scan.
// The outputs are written once, as the plain version's int64 (B, s).
//
// What bounds it on this card: not the bytes the function must move
// (the window rows in, (ml, dist) out: 0.13 ms for the L6 pass's 259
// windows of 98,304 positions) but, per window, the latency of the radix
// passes' tiles (a few block barriers and a serial scan of 32 warps'
// counts each: 21 passes of 12-24 tiles) and the scattered 4-byte writes
// of ranks and candidates by position in the sweeps; see PERF.md for the
// stage split (scripts/match_probe.py). Persistent blocks, at most one
// per SM (the window's bytes, 98,320 B at s = 98,304, a tile and the
// warps' digit counts in shared memory), keep the scratch at one set of
// buffers per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPay = 17;                     // payload bits of an element
constexpr uint64_t kPayMask = (uint64_t{1} << kPay) - 1;
constexpr int kWindow = 32768;
constexpr int kIpt = 4;                      // elements a thread a tile
constexpr int kTile = kThreads * kIpt;       // elements a radix-pass tile
constexpr int kBaseK = 4;                    // base-tier candidates
constexpr int kTierK = 6;                    // ladder candidates a level
constexpr int kStages = 12;                  // stamps 0..kStages a window

__device__ __forceinline__ uint32_t word_at(const uint8_t* w, int p) {
  return static_cast<uint32_t>(w[p]) | static_cast<uint32_t>(w[p + 1]) << 8 |
         static_cast<uint32_t>(w[p + 2]) << 16 |
         static_cast<uint32_t>(w[p + 3]) << 24;
}

__device__ __forceinline__ int common_prefix(const uint8_t* w, int a, int b,
                                             int n) {
  int k = 0;
  while (k < n && w[a + k] == w[b + k]) ++k;
  return k;
}

// The plain version's _merge_cand: a longer match wins; at equal length,
// a nearer one, when there is a match.
__device__ __forceinline__ void merge(int ml, int dist, int& best_ml,
                                      int& best_dist) {
  if (ml > best_ml || (ml == best_ml && dist < best_dist && ml > 0)) {
    best_ml = ml;
    best_dist = dist;
  }
}

// With stamps, thread 0 of block 0 writes the global nanosecond timer
// into stamps[k] at stage k of its first window (a probe's stage split;
// scripts/match_probe.py names the stages).
__device__ __forceinline__ void stamp(uint64_t* stamps, int row, int k) {
  if (stamps != nullptr && row == 0 && threadIdx.x == 0) {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    stamps[k] = t;
  }
}

// Inclusive scan (sum, or max with kMax) of x over the block's threads in
// thread order; total gets the block's whole. Every thread calls it.
template <bool kMax>
__device__ uint32_t block_scan(uint32_t x, uint32_t* wsum, uint32_t& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = kMax ? max(x, y) : x + y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t v = lane < kWarps ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v = kMax ? max(v, y) : v + y;
    }
    if (lane < kWarps) wsum[lane] = v;
  }
  __syncthreads();
  const uint32_t pre = warp ? wsum[warp - 1] : 0;
  total = wsum[kWarps - 1];
  __syncthreads();
  return kMax ? max(pre, x) : pre + x;
}

// Exclusive scan of in[0, 256) into out[0, 256) by warp 0 (in and out
// may be the same array); the other warps return at once.
__device__ void scan256(const uint32_t* in, uint32_t* out) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= 32) return;
  uint32_t t[8], sum = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    t[k] = in[lane * 8 + k];
    sum += t[k];
  }
  uint32_t x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  uint32_t run = x - sum;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    out[lane * 8 + k] = run;
    run += t[k];
  }
}

// Shared-memory state of the radix passes.
struct SortSmem {
  uint32_t* cnt;                  // kWarps x 256 per-warp digit counts
  uint32_t* tc;                   // 256: a tile's (or the pass's) counts
  uint32_t* tb;                   // 256: a tile's first slot of each digit
  uint32_t* gofs;                 // 256: the pass's next slot of each digit
  uint64_t* stage;                // kTile elements: a tile in digit order
};

// One stable pass of the LSD radix sort: src[0, n) -> dst by the 8-bit
// digit at bit `shift`. First the pass's digit counts give each digit its
// first slot (gofs); then tile by tile (kTile elements, in order) each
// warp ranks its 32 x kIpt elements by digit with __match_any_sync, a scan
// of the warps' counts places the tile in digit order in shared memory,
// and the tile is written out in that order: each digit's run of the tile
// goes to consecutive addresses, so the writes coalesce.
__device__ void radix_pass(const uint64_t* src, uint64_t* dst, int n,
                           int shift, const SortSmem& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* mine = sm.cnt + warp * 256;
  for (int d = lane; d < 256; d += 32) mine[d] = 0;
  __syncwarp();
  for (int i0 = warp * 32 * kIpt; i0 < n; i0 += kTile) {
    uint64_t v[kIpt];
#pragma unroll
    for (int u = 0; u < kIpt; ++u) {
      const int i = i0 + u * 32 + lane;
      v[u] = i < n ? __ldcs(src + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < kIpt; ++u)
      if (i0 + u * 32 + lane < n)
        atomicAdd(&mine[static_cast<uint32_t>(v[u] >> shift) & 255], 1u);
  }
  __syncthreads();
  if (threadIdx.x < 256) {
    uint32_t sum = 0;
    for (int w = 0; w < kWarps; ++w) sum += sm.cnt[w * 256 + threadIdx.x];
    sm.tc[threadIdx.x] = sum;
  }
  __syncthreads();
  scan256(sm.tc, sm.gofs);
  for (int t0 = 0; t0 < n; t0 += kTile) {
    __syncthreads();              // gofs is set; the last tile is out
    for (int d = lane; d < 256; d += 32) mine[d] = 0;
    __syncwarp();
    uint64_t v[kIpt];
    uint32_t dig[kIpt], rk[kIpt];
    const int base = t0 + warp * 32 * kIpt;
#pragma unroll
    for (int u = 0; u < kIpt; ++u) {
      const int i = base + u * 32 + lane;
      v[u] = i < n ? __ldcs(src + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < kIpt; ++u) {
      const bool ok = base + u * 32 + lane < n;
      const uint32_t d =
          ok ? static_cast<uint32_t>(v[u] >> shift) & 255 : 256 + lane;
      const uint32_t peers = __match_any_sync(0xffffffffu, d);
      const uint32_t below = __popc(peers & ((1u << lane) - 1));
      rk[u] = ok ? mine[d] + below : 0;
      dig[u] = d;
      __syncwarp();
      if (ok && below == 0) mine[d] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    if (threadIdx.x < 256) {      // each digit: warps' counts -> offsets
      uint32_t sum = 0;
      for (int w = 0; w < kWarps; ++w) {
        const uint32_t c = sm.cnt[w * 256 + threadIdx.x];
        sm.cnt[w * 256 + threadIdx.x] = sum;
        sum += c;
      }
      sm.tc[threadIdx.x] = sum;
    }
    __syncthreads();
    scan256(sm.tc, sm.tb);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kIpt; ++u)
      if (base + u * 32 + lane < n)
        sm.stage[sm.tb[dig[u]] + mine[dig[u]] + rk[u]] = v[u];
    __syncthreads();
    const int tile_n = min(kTile, n - t0);
    for (int k = threadIdx.x; k < tile_n; k += kThreads) {
      const uint64_t e = sm.stage[k];
      const uint32_t d = static_cast<uint32_t>(e >> shift) & 255;
      __stcs(dst + sm.gofs[d] + k - sm.tb[d], e);
    }
    __syncthreads();
    if (threadIdx.x < 256) sm.gofs[threadIdx.x] += sm.tc[threadIdx.x];
  }
  __syncthreads();
}

// LSD radix sort of a[0, n) by `passes` digits of the key above the
// payload, through b; returns the buffer that holds the result.
__device__ uint64_t* radix_sort(uint64_t* a, uint64_t* b, int n, int passes,
                                const SortSmem& sm) {
  __syncthreads();                // the elements are written
  for (int k = 0; k < passes; ++k) {
    radix_pass(a, b, n, kPay + 8 * k, sm);
    uint64_t* t = a;
    a = b;
    b = t;
  }
  return a;
}

// One pass over sorted elements srt[0, count) in tiles of kThreads: each
// tile is staged in shared memory behind the 8 elements before it (two
// buffers of kThreads + 8 in tiles, taken in turn), the next tile's
// element is loaded ahead, and the dense rank (from 1) of each element's
// key comes from a block scan. visit(i, e, self, rank) runs for each
// element, self[-j] being element i - j for j <= min(i, 8).
template <class Visit>
__device__ void sorted_sweep(const uint64_t* srt, int count, uint64_t* tiles,
                             uint32_t* wsum, Visit visit) {
  uint32_t carry = 0;
  uint64_t ahead = threadIdx.x < count ? srt[threadIdx.x] : 0;
  for (int t0 = 0, k = 0; t0 < count; t0 += kThreads, ++k) {
    uint64_t* buf = tiles + (k & 1) * (kThreads + 8);
    const uint64_t* before = tiles + ((k + 1) & 1) * (kThreads + 8);
    const int i = t0 + threadIdx.x;
    const uint64_t e = ahead;
    buf[8 + threadIdx.x] = e;
    if (threadIdx.x < 8) buf[threadIdx.x] = before[kThreads + threadIdx.x];
    if (i + kThreads < count) ahead = srt[i + kThreads];
    __syncthreads();
    const bool in = i < count;
    const uint64_t key = e >> kPay;
    const uint32_t neq =
        in && (i == 0 || (buf[7 + threadIdx.x] >> kPay) != key);
    uint32_t total;
    const uint32_t r = block_scan<false>(neq, wsum, total) + carry;
    carry += total;
    if (in) visit(i, e, buf + 8 + threadIdx.x, r);
  }
}

// The sweep after a ladder sort: with keep_rank, dense ranks stored by
// grid position in rank; with L > 0 the level's candidates of each grid
// position, merged into best at its even position.
__device__ void ladder_sweep(const uint64_t* srt, int m, int L, bool keep_rank,
                             int hs, const uint8_t* win, uint32_t* rank,
                             uint32_t* best, uint64_t* tiles,
                             uint32_t* wsum) {
  sorted_sweep(srt, m, tiles, wsum,
               [&](int i, uint64_t e, const uint64_t* self, uint32_t r) {
    const int g = static_cast<int>(e & kPayMask);
    if (keep_rank) rank[g] = r;
    if (L == 0) return;
    const uint64_t key = e >> kPay;
    int bml = 0, bd = 0;
    for (int j = 1; j <= kTierK && j <= i; ++j) {
      const uint64_t c = self[-j];
      if ((c >> kPay) != key) break;
      const int q = 2 * static_cast<int>(c & kPayMask);
      const int dist = 2 * g - q;
      if (dist > kWindow || q < hs) break;
      merge(L + common_prefix(win, 2 * g + L, q + L, 8), dist, bml, bd);
    }
    if (bml > 0) {
      const uint32_t b = best[2 * g];
      int ml0 = static_cast<int>(b >> 16), d0 = static_cast<int>(b & 0xFFFF);
      merge(bml, bd, ml0, d0);
      best[2 * g] = static_cast<uint32_t>(ml0) << 16 |
                    static_cast<uint32_t>(d0);
    }
  });
}

// The window's first wlen bytes into shared memory: 2-byte loads where the
// row is 2-byte aligned, 8 in flight a thread.
__device__ void load_window(const uint8_t* src, uint8_t* win, int wlen) {
  if ((reinterpret_cast<uintptr_t>(src) & 1) == 0) {
    const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
    uint16_t* w16 = reinterpret_cast<uint16_t*>(win);
    const int n16 = wlen / 2;
    for (int k0 = threadIdx.x; k0 < n16; k0 += 8 * kThreads) {
      uint16_t v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int k = k0 + u * kThreads;
        v[u] = k < n16 ? s16[k] : 0;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int k = k0 + u * kThreads;
        if (k < n16) w16[k] = v[u];
      }
    }
  } else {
    for (int k = threadIdx.x; k < wlen; k += kThreads) win[k] = src[k];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    match_l6_kernel(const uint8_t* __restrict__ data, int rows, int stride,
                    int s, const int32_t* __restrict__ valid,
                    const int32_t* __restrict__ hist, uint64_t* scratch,
                    long long scratch_words, int64_t* out_ml,
                    int64_t* out_dist, uint64_t* stamps) {
  extern __shared__ __align__(16) unsigned char smem[];
  SortSmem sm;
  sm.stage = reinterpret_cast<uint64_t*>(smem);
  sm.cnt = reinterpret_cast<uint32_t*>(sm.stage + kTile);
  sm.tc = sm.cnt + kWarps * 256;
  sm.tb = sm.tc + 256;
  sm.gofs = sm.tb + 256;
  uint32_t* wsum = sm.gofs + 256;
  uint8_t* win = reinterpret_cast<uint8_t*>(wsum + 32);
  uint64_t* tiles = sm.stage;     // the sweeps' tiles, between the sorts
  const int n = s + 4, m = s / 2, wlen = s + 16;
  uint64_t* e0 = scratch + blockIdx.x * scratch_words;
  uint64_t* e1 = e0 + n;
  uint32_t* rank = reinterpret_cast<uint32_t*>(e1 + n);
  uint32_t* best = rank + n / 2;

  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int hs = hist[row], vl = valid[row];
    __syncthreads();              // the last row's reads of win are done
    stamp(stamps, row, 0);
    load_window(data + static_cast<size_t>(row) * stride, win, wlen);
    __syncthreads();
    stamp(stamps, row, 1);

    // base tier: the window's words and the 4 past it, stably sorted
    for (int p = threadIdx.x; p < n; p += kThreads)
      e0[p] = static_cast<uint64_t>(word_at(win, p)) << kPay |
              static_cast<uint64_t>(p);
    const uint64_t* srt = radix_sort(e0, e1, n, 4, sm);
    stamp(stamps, row, 2);
    uint32_t extra[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) extra[t] = word_at(win, s + t);
    sorted_sweep(srt, n, tiles, wsum,
                 [&](int i, uint64_t e, const uint64_t* self, uint32_t r) {
      const int p = static_cast<int>(e & kPayMask);
      if ((p & 1) == 0) rank[p / 2] = r;   // the word's dense rank
      if (p >= s) return;
      const uint64_t key = e >> kPay;
      int before = 0;             // words past the window sorted before p
#pragma unroll
      for (int t = 0; t < 4; ++t) before += extra[t] < key;
      const int ri = i - before;  // p's rank among the window's words
      int bml = 0, bd = 0;
      for (int j = 1; j <= kBaseK && j <= i && ri >= 2 * j; ++j) {
        const uint64_t c = self[-j];
        if ((c >> kPay) != key) break;
        const int q = static_cast<int>(c & kPayMask);
        if (p - q > kWindow || q < hs) break;
        merge(4 + common_prefix(win, p + 4, q + 4, 12), p - q, bml, bd);
      }
      best[p] = static_cast<uint32_t>(bml) << 16 | static_cast<uint32_t>(bd);
    });
    __syncthreads();
    stamp(stamps, row, 3);

    // the 8-byte rank of each grid position: the word ranks at 2g, 2g + 4
    uint64_t* a = srt == e0 ? e1 : e0;
    uint64_t* b = srt == e0 ? e0 : e1;
    for (int g = threadIdx.x; g < m; g += kThreads)
      a[g] = (static_cast<uint64_t>(rank[g]) << 17 | rank[g + 2]) << kPay |
             static_cast<uint64_t>(g);
    srt = radix_sort(a, b, m, 5, sm);
    stamp(stamps, row, 4);
    ladder_sweep(srt, m, 0, true, hs, win, rank, best, tiles, wsum);

    // the ladder: level L pairs the ranks at g and g + half
    int half = 4, stage = 5;
    for (int L = 16; L <= 64; L *= 2) {
      __syncthreads();            // the last sweep's ranks are written
      stamp(stamps, row, stage++);
      a = srt == e0 ? e1 : e0;
      b = srt == e0 ? e0 : e1;
      for (int g = threadIdx.x; g < m; g += kThreads) {
        const int gh = g + half;
        const uint32_t rb = gh < m ? rank[gh] : static_cast<uint32_t>(gh + 1);
        a[g] = static_cast<uint64_t>(rank[g] << 16 | rb) << kPay |
               static_cast<uint64_t>(g);
      }
      srt = radix_sort(a, b, m, 4, sm);
      stamp(stamps, row, stage++);
      ladder_sweep(srt, m, L, L < 64, hs, win, rank, best, tiles, wsum);
      half = L / 2;
    }
    __syncthreads();
    stamp(stamps, row, stage);

    // covering decay, the clip to the valid bytes, the outputs
    uint32_t carry = 0;
    uint32_t ahead = threadIdx.x < s ? best[threadIdx.x] : 0;
    for (int t0 = 0; t0 < s; t0 += kThreads) {
      const int p = t0 + threadIdx.x;
      const bool in = p < s;
      const uint32_t bp = ahead;
      if (p + kThreads < s) ahead = best[p + kThreads];
      int ml = static_cast<int>(bp >> 16), dist = static_cast<int>(bp & 0xFFFF);
      const uint32_t v =
          in && ml >= 4
              ? static_cast<uint32_t>(ml + p) << 15 |
                    static_cast<uint32_t>(32768 - min(max(dist, 1), 32768))
              : 0u;
      uint32_t total;
      const uint32_t c = max(block_scan<true>(v, wsum, total), carry);
      carry = max(carry, total);
      if (!in) continue;
      const int cml = static_cast<int>(c >> 15) - p;
      if (cml > ml && cml >= 4) {
        ml = cml;
        dist = 32768 - static_cast<int>(c & 0x7FFF);
      }
      ml = min(ml, min(max(vl - p, 0), 258));
      if (ml < 4) ml = 0;
      const size_t o = static_cast<size_t>(row) * s + p;
      out_ml[o] = ml;
      out_dist[o] = dist;
    }
    stamp(stamps, row, kStages);
  }
}

int smem_bytes(int s) {
  return static_cast<int>(kTile * sizeof(uint64_t) +
                          (kWarps * 256 + 3 * 256 + 32) * sizeof(uint32_t)) +
         ((s + 16 + 15) & ~15);
}

}  // namespace

// 64-bit words of global scratch one thread block needs at window s: two
// element buffers of s + 4, the ranks ((s + 4) / 2: the words' at even
// positions, then the grid's) and the best candidates (s) in 32 bits.
extern "C" long long ldrsx_match_l6_scratch(int s) {
  const long long n = s + 4;
  return 2 * n + (n / 2 + s + 1) / 2;
}

// (ml, dist) int64 (rows, s) of rows windows of `stride` bytes (stride >=
// s + 16), valid and hist int32 (rows,), with `blocks` persistent thread
// blocks and scratch of blocks x ldrsx_match_l6_scratch(s) words; stamps
// (null, or kStages + 1 words) takes the stage times of the first window.
// Returns a CUDA error code (0: launched).
extern "C" int ldrsx_match_l6_stamped(const void* data, int rows, int stride,
                                      int s, const void* valid,
                                      const void* hist, void* scratch,
                                      int blocks, void* ml, void* dist,
                                      void* stamps, void* stream) {
  if (rows <= 0) return 0;
  if (s < 2 || (s & 1) || s / 2 + 16 >= 65536 || stride < s + 16 ||
      blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = smem_bytes(s);
  const cudaError_t rc = cudaFuncSetAttribute(
      match_l6_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  match_l6_kernel<<<blocks, kThreads, bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), rows, stride, s,
      static_cast<const int32_t*>(valid), static_cast<const int32_t*>(hist),
      static_cast<uint64_t*>(scratch), ldrsx_match_l6_scratch(s),
      static_cast<int64_t*>(ml), static_cast<int64_t*>(dist),
      static_cast<uint64_t*>(stamps));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ldrsx_match_l6(const void* data, int rows, int stride, int s,
                              const void* valid, const void* hist,
                              void* scratch, int blocks, void* ml,
                              void* dist, void* stream) {
  return ldrsx_match_l6_stamped(data, rows, stride, s, valid, hist, scratch,
                                blocks, ml, dist, nullptr, stream);
}
