// L6 match finder on NVIDIA Hopper (sm_90a): (ml, dist) for every position
// of [32 KiB history | payload] windows, one thread block cluster per
// window, every sort of the window in the cluster's shared memory.
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
//   as the ladder's ranks define it (a grid position whose rank partner
//   lies past the grid's end is equal to no other), kept under the same
//   window and hist_start rule, of length L plus the common prefix of the
//   8 bytes at L; merged into the base tier's candidate (longer wins,
//   then nearer), level by level;
// - covering decay: an inclusive prefix max of (ml + pos) << 15 |
//   (32768 - dist) over the positions with ml >= 4 lends a covering
//   match's remainder to each position it covers where it is longer;
//   then clip to min(valid_len - pos, 258) and zero below 4.
//
// The TPU form builds this from five stable sorts of the whole window.
// Only equality of the ladder's ranks matters to the candidates, and a
// stable sort keeps equal keys in position order, so here:
// - the base sort is a stable LSD radix sort of the s + 4 positions (the
//   4 past the window give the last grid positions their 8-byte keys) by
//   the 4 bytes of their word, each pass reading its digit from the
//   window in shared memory; a position's rank for the rule above
//   discounts the positions past the window that sort before it;
// - its sweep takes the base candidates and lists the even positions in
//   sorted order (the grid sorted by word); a sweep of that list labels
//   each grid position with the first member of its word group and keeps
//   the groups of two or more (the active list);
// - each ladder level (8-byte, then L = 16, 32, 64) sorts only the
//   active list, which holds each group of the level below in one run
//   in grid order: a stable sort by the partner's 16-bit label (at g +
//   L/4 grid steps) alone, two passes, brings equal pairs (partner's
//   label, own label) together in grid order. A group of one stays one
//   at every later level, so it drops out and keeps its label, and a
//   label is the first grid position of its group, so labels stay
//   unique without being written for the groups that dropped out
//   (Larsson and Sadakane's refinement). A partner past the grid takes a
//   label above every grid position. A list element is g with its
//   partner's label, read once from the label array;
// - the level's sweep reads the candidates from the sorted neighbours,
//   relabels the list and keeps its groups of two or more for the next
//   level.
//
// The layout on this card: a cluster of 8 thread blocks (16 when the
// window does not fit 8; one block per SM) holds one window, persistent
// over the windows. A TMA bulk copy multicast to the cluster puts the
// window's bytes in every block's shared memory; the sorted lists, the
// labels and the best candidates are spread over the blocks in equal
// chunks and read and written through distributed shared memory
// (ld/st.shared::cluster). A radix pass: each warp ranks its contiguous
// share by digit with __match_any_sync into 16-bit per-warp counts, a
// warp scan per digit turns them into offsets, the block puts its share
// in digit order in place, the blocks exchange their digit totals over
// the cluster, and each block copies its share out in order, each
// digit's run to consecutive slots (coalesced stores to the owning
// blocks); a pass whose digit is the same for every element is skipped.
// Sweeps scan blockwise, then carry across the cluster's blocks; the
// covering decay likewise. So no element goes through device memory: the
// kernel moves the window rows in and (ml, dist) out, which is its bound
// (0.13 ms for the L6 pass's 259 windows of 98,304 positions).
//
// What holds it back (PERF.md; scripts/match_probe.py splits one window
// into its stages): 12 radix passes a window, each ~5 us of fixed
// latency (two cluster barriers, three digit scans, six block barriers)
// plus ~1 us per 1,000 elements a block; the random remote accesses
// (~2-3 cycles each: the base sweep's stores of candidates by position,
// the ladder's reads of partner labels); and 18 rounds of 15 resident
// clusters over 259 windows. Register pressure is the other cost: at
// 1,024 threads a block has 64 registers a thread, so the lists' handles
// are three 32-bit words, the small arrays sit at fixed shared-memory
// offsets, and the sweeps read their elements again from shared memory
// rather than hold them across a cluster scan (each spill step cost
// 4-6 % of the kernel's time).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 13;                   // elements a thread holds
constexpr int kWindow = 32768;
constexpr int kBaseK = 4;                    // base-tier candidates
constexpr int kTierK = 6;                    // ladder candidates a level
constexpr int kStages = 13;                  // stamps 0..kStages a window
constexpr int kSlots = 32;                   // cluster carry words

__device__ __forceinline__ uint32_t lanemask_lt() {
  uint32_t m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

extern __shared__ __align__(16) unsigned char smem[];

// Loads and stores in a block's shared memory or another block's of the
// cluster, by a 32-bit shared::cluster address: the explicit form, not a
// generic pointer into the cluster's window.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t r) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(a), "r"(r));
  return a;
}
__device__ __forceinline__ uint32_t ld_cluster(uint32_t a, uint32_t*) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ uint16_t ld_cluster(uint32_t a, uint16_t*) {
  uint16_t v;
  asm volatile("ld.shared::cluster.u16 %0, [%1];" : "=h"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void st_cluster(uint32_t a, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ void st_cluster(uint32_t a, uint16_t v) {
  asm volatile("st.shared::cluster.u16 [%0], %1;" ::"r"(a), "h"(v) : "memory");
}

// A list spread over the cluster: element i lives in block i / chunk, at
// i % chunk of the array at byte `off` of that block's shared memory.
// (32-bit fields, so a list costs three registers.)
template <class T>
struct Spread {
  uint32_t off, chunk;
  uint32_t magic;                 // ceil(2^32 / chunk): i / chunk exactly
                                  // for i * chunk < 2^32

  __device__ void set(uint32_t at, uint32_t count, uint32_t nblocks) {
    off = at;
    chunk = max((count + nblocks - 1) / nblocks, 2u);
    magic = static_cast<uint32_t>(((uint64_t{1} << 32) + chunk - 1) / chunk);
  }
  __device__ T* local() const { return reinterpret_cast<T*>(smem + off); }
  __device__ T get(uint32_t i) const {
    const uint32_t r = __umulhi(i, magic), at = i - r * chunk;
    if (r == cg::this_cluster().block_rank()) return local()[at];
    return ld_cluster(cluster_addr(local() + at, r), static_cast<T*>(nullptr));
  }
  __device__ void put(uint32_t i, T v) const {
    const uint32_t r = __umulhi(i, magic), at = i - r * chunk;
    if (r == cg::this_cluster().block_rank())
      local()[at] = v;
    else
      st_cluster(cluster_addr(local() + at, r), v);
  }
  // this block's share [lo, lo + len) of a list of count elements
  __device__ void share(uint32_t count, uint32_t& lo, uint32_t& len) const {
    lo = min(cg::this_cluster().block_rank() * chunk, count);
    len = min(count - lo, chunk);
  }
};

// The window's bytes, byte p at `at` + p of the block's shared memory
// (at 16-byte aligned less the row's misalignment).
struct Win {
  int at;
  __device__ uint32_t byte(int p) const { return smem[at + p]; }
  __device__ uint32_t word(int p) const {
    const int a = at + p;
    const uint32_t* w = reinterpret_cast<const uint32_t*>(smem) + (a >> 2);
    return __funnelshift_r(w[0], w[1], (a & 3) * 8);
  }
  // equal leading bytes of the n bytes (a multiple of 4) at a and b
  __device__ int common(int a, int b, int n) const {
    for (int k = 0; k < n; k += 4) {
      const uint32_t x = word(a + k) ^ word(b + k);
      if (x) return k + ((__ffs(x) - 1) >> 3);
    }
    return n;
  }
};

// The plain version's _merge_cand: a longer match wins; at equal length,
// a nearer one, when there is a match.
__device__ __forceinline__ void merge(int ml, int dist, int& best_ml,
                                      int& best_dist) {
  if (ml > best_ml || (ml == best_ml && dist < best_dist && ml > 0)) {
    best_ml = ml;
    best_dist = dist;
  }
}

// Dynamic shared memory (smem): the small arrays at fixed offsets (so
// their addresses cost no registers), then the lists and the window
// (Layout).
constexpr int kHistOff = 16;                 // 2 x 256: a pass's digit totals
constexpr int kOffOff = kHistOff + 2048;     // 256: a pass's first slots
constexpr int kLstOff = kOffOff + 1024;      // 256: first places in a block
constexpr int kWsOff = kLstOff + 1024;       // 64: block scans' warp totals
constexpr int kSlotsOff = kWsOff + 256;      // totals published to the cluster
constexpr int kWcOff = kSlotsOff + kSlots * 4;  // per-warp digit counts

__device__ __forceinline__ uint16_t* sm_wc() {
  return reinterpret_cast<uint16_t*>(smem + kWcOff);
}
__device__ __forceinline__ uint32_t* sm_words(int off) {
  return reinterpret_cast<uint32_t*>(smem + off);
}

// The state a sweep or sort carries besides the shared memory.
struct Smem {
  uint64_t* stamps;               // null, or the probe's stage times
  int par;                        // which half of hist the next pass uses
};

__device__ __forceinline__ void stamp(const Smem& sm, int k, uint64_t v) {
  if (sm.stamps != nullptr && threadIdx.x == 0) sm.stamps[k] = v;
}

__device__ __forceinline__ void stamp_time(const Smem& sm, int k) {
  if (sm.stamps != nullptr && threadIdx.x == 0) {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    sm.stamps[k] = t;
  }
}

// Exclusive prefix over the block's threads in thread order of a (sum)
// and b (max, from 0); ta and tb get the block's totals.
__device__ __forceinline__ void block_scan2(uint32_t& a, uint32_t& b, uint32_t* ws,
                            uint32_t& ta, uint32_t& tb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t ia = a, ib = b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t ya = __shfl_up_sync(0xffffffffu, ia, o);
    const uint32_t yb = __shfl_up_sync(0xffffffffu, ib, o);
    if (lane >= o) {
      ia += ya;
      ib = max(ib, yb);
    }
  }
  uint32_t eb = __shfl_up_sync(0xffffffffu, ib, 1);
  if (lane == 0) eb = 0;
  if (lane == 31) {
    ws[warp] = ia;
    ws[32 + warp] = ib;
  }
  __syncthreads();
  if (warp == 0) {
    uint32_t va = ws[lane], vb = ws[32 + lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t ya = __shfl_up_sync(0xffffffffu, va, o);
      const uint32_t yb = __shfl_up_sync(0xffffffffu, vb, o);
      if (lane >= o) {
        va += ya;
        vb = max(vb, yb);
      }
    }
    ws[lane] = va;
    ws[32 + lane] = vb;
  }
  __syncthreads();
  const uint32_t pa = warp ? ws[warp - 1] : 0;
  const uint32_t pb = warp ? ws[32 + warp - 1] : 0;
  ta = ws[31];
  tb = ws[63];
  __syncthreads();
  a = pa + ia - a;
  b = max(pb, eb);
}

// Publish this block's totals (ta, tb) in slot k, then from the cluster:
// ca and cb, the sum and max of the blocks ranked below this one, and
// all, the sum over every block. A cluster barrier: every write of the
// cluster before it is visible after it.
__device__ __forceinline__ void cluster_carry(uint32_t ta, uint32_t tb, const Smem& sm,
                              int k, uint32_t& ca, uint32_t& cb,
                              uint32_t& all) {
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t me = cluster.block_rank(), nb = cluster.num_blocks();
  if (threadIdx.x == 0) {
    sm_words(kSlotsOff)[2 * k] = ta;
    sm_words(kSlotsOff)[2 * k + 1] = tb;
  }
  cluster.sync();
  const int lane = threadIdx.x & 31;
  uint32_t va = 0, vb = 0, vall = 0;
  if (lane < nb) {
    vall = ld_cluster(cluster_addr(sm_words(kSlotsOff) + 2 * k, lane), sm_words(kSlotsOff));
    if (lane < me) {
      va = vall;
      vb = ld_cluster(cluster_addr(sm_words(kSlotsOff) + 2 * k + 1, lane), sm_words(kSlotsOff));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    va += __shfl_xor_sync(0xffffffffu, va, o);
    vb = max(vb, __shfl_xor_sync(0xffffffffu, vb, o));
    vall += __shfl_xor_sync(0xffffffffu, vall, o);
  }
  ca = va;
  cb = vb;
  all = vall;
}

// Exclusive prefix over the 256 digits, thread d holding digit d's value
// x (the other threads pass 0); every thread calls it.
__device__ __forceinline__ uint32_t digit_scan(uint32_t x, uint32_t* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t v = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  if (warp < 8 && lane == 31) ws[warp] = v;
  __syncthreads();
  uint32_t pre = 0;
  if (warp < 8)
    for (int w = 0; w < warp; ++w) pre += ws[w];
  __syncthreads();
  return pre + v - x;
}

// A stable LSD radix sort of the list in a (cur 0) or b (count elements; with
// ident, the list 0, 1, ..., count - 1, not stored) by `passes` 8-bit
// digits, digit(e, k) being digit k (from the least significant) of
// element e's key, read from the element or the window; load(e, k) is
// the element as pass k takes it (the ladder puts its key's next half in
// the element there). Through the other one; returns the buffer that
// holds the result. Both buffers are spread with the chunk of count
// elements.
//
// A pass: each warp ranks its contiguous share by digit; the block puts
// its share in digit order in place (its own chunk of the source, which
// only it reads); the blocks exchange their digit totals; each block
// copies its share out in order, each digit's run to consecutive slots,
// so the stores to other blocks coalesce. A pass whose digit is the same
// for every element leaves the list as it is.
template <class Digit, class Load>
__device__ __forceinline__ int cluster_sort(Spread<uint32_t> a, Spread<uint32_t> b,
                                            int cur, uint32_t count,
                                            int passes, bool ident,
                                            Digit digit, Load load, Smem& sm) {
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t me = cluster.block_rank(), nb = cluster.num_blocks();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t lo, len;
  a.share(count, lo, len);
  const int steps = static_cast<int>((len + kThreads - 1) / kThreads);
  const uint32_t w0 = static_cast<uint32_t>(warp * steps * 32);
  for (int k = 0; k < passes; ++k) {
    const Spread<uint32_t> src = cur ? b : a;
    const Spread<uint32_t> dst = cur ? a : b;
    uint32_t* hist = sm_words(kHistOff) + 256 * sm.par;
    sm.par ^= 1;
    for (int d = lane; d < 256; d += 32) sm_wc()[d * kWarps + warp] = 0;
    __syncwarp();
    // each warp ranks its share by digit: rk, the element's place among
    // the warp's elements of its digit (two 16-bit places a word)
    uint32_t el[kSteps], rk[(kSteps + 1) / 2];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const uint32_t li = w0 + u * 32 + lane;
      el[u] = 0;
      if (u < steps && li < len) el[u] = ident ? lo + li : load(src.local()[li], k);
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      if (u >= steps) break;
      const bool ok = w0 + u * 32 + lane < len;
      const uint32_t d = ok ? digit(el[u], k) : 256 + lane;
      const uint32_t peers = __match_any_sync(0xffffffffu, d);
      const uint32_t below = __popc(peers & lanemask_lt());
      uint16_t* c = sm_wc() + (d & 255) * kWarps + warp;
      const uint32_t r = ok ? *c + below : 0;
      if (u & 1)
        rk[u / 2] |= r << 16;
      else
        rk[u / 2] = r;
      __syncwarp();
      if (ok && below == 0) *c += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // per digit, the warps' counts -> each warp's first place; the block's
    // total of each digit to hist
    for (int q0 = 0; q0 < 8; q0 += 4) {
      uint32_t c[4], x[4];
      uint16_t* w = sm_wc() + (warp * 8 + q0) * kWarps + lane;
#pragma unroll
      for (int q = 0; q < 4; ++q) x[q] = c[q] = w[q * kWarps];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t y = __shfl_up_sync(0xffffffffu, x[q], o);
          if (lane >= o) x[q] += y;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        w[q * kWarps] = static_cast<uint16_t>(x[q] - c[q]);
        if (lane == 31) hist[warp * 8 + q0 + q] = x[q];
      }
    }
    __syncthreads();
    const uint32_t first =
        digit_scan(threadIdx.x < 256 ? hist[threadIdx.x] : 0, sm_words(kWsOff));
    if (threadIdx.x < 256) sm_words(kLstOff)[threadIdx.x] = first;
    __syncthreads();
    // the block's share in digit order, in place
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const uint32_t li = w0 + u * 32 + lane;
      if (u < steps && li < len) {
        const uint32_t d = digit(el[u], k);
        src.local()[sm_words(kLstOff)[d] + sm_wc()[d * kWarps + warp] +
                  (rk[u / 2] >> (16 * (u & 1)) & 0xFFFF)] = el[u];
      }
    }
    ident = false;
    cluster.sync();
    // each digit's first slot: the digits below it in the whole list, and
    // this digit in the blocks ranked below this one
    uint32_t tot = 0, before = 0;
    if (threadIdx.x < 256) {
      uint32_t h[16];
#pragma unroll
      for (int r = 0; r < 16; ++r)
        h[r] = r < static_cast<int>(nb)
                   ? ld_cluster(cluster_addr(hist + threadIdx.x, r), hist)
                   : 0;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        tot += h[r];
        if (r < static_cast<int>(me)) before += h[r];
      }
    }
    const uint32_t slot0 = digit_scan(tot, sm_words(kWsOff));
    if (threadIdx.x < 256) sm_words(kOffOff)[threadIdx.x] = slot0 + before;
    // a digit that every element has: the pass keeps the order
    if (__syncthreads_or(threadIdx.x < 256 && tot == count)) continue;
    for (uint32_t li = threadIdx.x; li < len; li += kThreads) {
      const uint32_t e = src.local()[li], d = digit(e, k);
      dst.put(sm_words(kOffOff)[d] + li - sm_words(kLstOff)[d], e);
    }
    cluster.sync();
    cur ^= 1;
  }
  return cur;
}

// The ladder's key of grid position g: (label at g + half, label at g),
// the partner past the grid's end (m) taking a label above every grid
// position; at the 8-byte level the partner (g + 2 <= m + 1) always has
// a word label. The list holds each group of the level below (one label
// at g) in one run, in grid order, so a stable sort by the partner's
// label alone keeps equal keys together in grid order: two passes. A
// list element is g | the partner's label << 16.
struct LadderKey {
  Spread<uint16_t> R;
  uint32_t m, half;
  bool first;
  __device__ uint32_t kb(uint32_t g) const {
    const uint32_t h = g + half;
    return first || h < m ? R.get(h) : h + 1;
  }
  __device__ uint32_t load(uint32_t e, int k) const {
    const uint32_t g = e & 0xFFFF;
    return k == 0 ? g | kb(g) << 16 : e;
  }
};

__device__ __forceinline__ void wait_window(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (int tries = 0; !done; ++tries) {
    if (tries > (1 << 24)) __trap();     // the copy never landed: fail
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

struct Layout {                   // byte offsets in dynamic shared memory
  int win, x0, x1, r, total;
  uint32_t chunk_n;
};

__host__ __device__ inline int up16(long long v) {
  return static_cast<int>((v + 15) & ~15ll);
}

__host__ __device__ inline long long larger(long long a, long long b) {
  return a > b ? a : b;
}

__host__ __device__ inline Layout layout(int s, int nb) {
  Layout l;
  const long long n = s + 4, m2 = s / 2 + 2;
  l.chunk_n = static_cast<uint32_t>((n + nb - 1) / nb);
  const long long chunk_r = (m2 + nb - 1) / nb;
  // the mbarrier at 0, the small arrays; the per-warp counts, or the list
  // of even positions between the base sort and the ladder
  int at = kWcOff + up16(larger(256ll * kWarps * 2, chunk_r * 2));
  l.r = at;
  at += up16(chunk_r * 2);
  // the base sort's lists; then the best candidates and the ladder's two
  // lists
  const long long cap = ((s / 2 + nb - 1) / nb + 7) & ~7ll;
  const int xb = up16(larger(l.chunk_n * 4ll, cap * 8));
  l.x0 = at;
  at += xb;
  l.x1 = at;
  at += xb;
  l.win = at;
  at += up16(s + 48ll);
  l.total = at;
  return l;
}

__global__ void __launch_bounds__(kThreads, 1)
    match_l6_kernel(const uint8_t* __restrict__ data, int rows, int stride,
                    int s, const int32_t* __restrict__ valid,
                    const int32_t* __restrict__ hist_start,
                    int64_t* out_ml, int64_t* out_dist, uint64_t* stamps) {
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t me = cluster.block_rank(), nb = cluster.num_blocks();
  const int clusters = gridDim.x / nb, cid = blockIdx.x / nb;
  const Layout lay = layout(s, nb);
  Smem sm;
  sm.par = 0;
  const uint32_t bar = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t n = s + 4, m = s / 2;

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  uint32_t it = 0;
  for (int row = cid; row < rows; row += clusters, ++it) {
    sm.stamps = row == 0 && me == 0 ? stamps : nullptr;
    stamp_time(sm, 0);
    const int hs = hist_start[row], vl = valid[row];
    // the window's bytes into every block: one TMA copy multicast to the
    // cluster, from the 16-byte aligned address at or below the row
    const uint8_t* src = data + static_cast<size_t>(row) * stride;
    const int off = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
    const uint32_t bytes = static_cast<uint32_t>(up16(off + s + 20));
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (threadIdx.x == 0)
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
          "r"(bytes)
          : "memory");
    cluster.sync();               // every block's barrier armed, last window read
    if (me == 0 && threadIdx.x == 0) {
      const uint16_t mask = static_cast<uint16_t>((1u << nb) - 1);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(
              static_cast<uint32_t>(__cvta_generic_to_shared(smem + lay.win))),
          "l"(src - off), "r"(bytes), "r"(bar), "h"(mask)
          : "memory");
    }
    wait_window(bar, it & 1);
    const Win win{lay.win + off};
    stamp_time(sm, 1);

    // base tier: the s + 4 positions stably sorted by word
    Spread<uint32_t> pb0, pb1;
    pb0.set(lay.x0, n, nb);
    pb1.set(lay.x1, n, nb);
    const int pc = cluster_sort(
        pb0, pb1, 0, n, 4, true,
        [&](uint32_t p, int k) { return win.byte(static_cast<int>(p) + k); },
        [](uint32_t p, int) { return p; }, sm);
    stamp_time(sm, 2);
    const Spread<uint32_t> P = pc ? pb1 : pb0;
    Spread<uint32_t> best;
    best.set(pc ? pb0.off : pb1.off, s, nb);
    Spread<uint16_t> E, R;
    E.set(kWcOff, m + 2, nb);
    R.set(lay.r, m + 2, nb);
    {
      uint32_t extra[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) extra[t] = win.word(s + t);
      uint32_t lo, len;
      P.share(n, lo, len);
      const uint32_t spt = (len + kThreads - 1) / kThreads;
      const uint32_t t0 = min(threadIdx.x * spt, len),
                     t1 = min(t0 + spt, len);
      uint32_t bmask = 0, evens = 0, mx = 0;
      uint32_t kprev = t0 < t1 && lo + t0 > 0 ? win.word(P.get(lo + t0 - 1))
                                              : 0;
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        if (t0 + u < t1) {
          const uint32_t i = lo + t0 + u, p = P.local()[t0 + u];
          const uint32_t key = win.word(p);
          if (i == 0 || key != kprev) {
            bmask |= 1u << u;
            mx = i;
          }
          kprev = key;
          evens += (p & 1) == 0;
        }
      }
      uint32_t ta, tb, ca, cb, all;
      block_scan2(evens, mx, sm_words(kWsOff), ta, tb);
      cluster_carry(ta, tb, sm, 0, ca, cb, all);
      uint32_t ei = ca + evens, gsi = max(cb, mx);
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        if (t0 + u < t1) {
          const uint32_t i = lo + t0 + u, p = P.local()[t0 + u];
          if (bmask >> u & 1) gsi = i;
          if (p < static_cast<uint32_t>(s)) {
            const uint32_t key = win.word(p);
            int before = 0;       // words past the window sorted before p
#pragma unroll
            for (int t = 0; t < 4; ++t) before += extra[t] < key;
            const int ri = static_cast<int>(i) - before;
            int bml = 0, bd = 0;
            for (uint32_t j = 1; j <= kBaseK && j <= i - gsi && ri >= 2 * static_cast<int>(j);
                 ++j) {
              const int q = static_cast<int>(P.get(i - j));
              if (static_cast<int>(p) - q > kWindow || q < hs) break;
              merge(4 + win.common(p + 4, q + 4, 12), p - q, bml, bd);
            }
            best.put(p, static_cast<uint32_t>(bml) << 16 |
                            static_cast<uint32_t>(bd));
          }
          if ((p & 1) == 0) E.put(ei++, static_cast<uint16_t>(p / 2));
        }
      }
      cluster.sync();
    }
    stamp_time(sm, 3);

    // the grid in word order: each grid position's word label (the first
    // of its group) and the groups of two or more
    Spread<uint32_t> lb0, lb1;
    const uint32_t lists = P.off;
    const uint32_t cap = (((m + nb - 1) / nb) + 7) & ~7u;
    uint32_t count;
    {
      uint32_t lo, len;
      E.share(m + 2, lo, len);
      const uint32_t spt = (len + kThreads - 1) / kThreads;
      const uint32_t t0 = min(threadIdx.x * spt, len),
                     t1 = min(t0 + spt, len);
      uint32_t bmask = 0, mx = 0;
      uint32_t kprev = t0 < t1 && lo + t0 > 0 ? win.word(2 * E.get(lo + t0 - 1))
                                              : 0;
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        if (t0 + u < t1) {
          const uint32_t i = lo + t0 + u, g = E.local()[t0 + u];
          const uint32_t key = win.word(2 * g);
          if (i == 0 || key != kprev) {
            bmask |= 1u << u;
            mx = i << 16 | g;
          }
          kprev = key;
        }
      }
      if (t0 < t1 && (lo + t1 >= m + 2 ||
                      win.word(2 * E.get(lo + t1)) != kprev))
        bmask |= 1u << (t1 - t0);
      uint32_t act = 0;
#pragma unroll
      for (int u = 0; u < kSteps; ++u)
        if (t0 + u < t1)
          act += (bmask >> u & 3) != 3 && E.local()[t0 + u] < m;
      uint32_t ta, tb, ca, cb, all;
      block_scan2(act, mx, sm_words(kWsOff), ta, tb);
      cluster_carry(ta, tb, sm, 1, ca, cb, all);
      count = all;
      lb0.set(lists, count, nb);
      lb1.set(lists + 4 * cap, count, nb);
      uint32_t ai = ca + act, lab = max(cb, mx);
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        if (t0 + u < t1) {
          const uint32_t i = lo + t0 + u, g = E.local()[t0 + u];
          if (bmask >> u & 1) lab = i << 16 | g;
          R.put(g, static_cast<uint16_t>(lab & 0xFFFF));
          if ((bmask >> u & 3) != 3 && g < m) lb0.put(ai++, g | (lab & 0xFFFF) << 16);
        }
      }
      cluster.sync();
    }
    stamp_time(sm, 4);
    stamp(sm, kStages + 1, count);

    // the ladder: the 8-byte level (no candidates), then L = 16, 32, 64
    int cur = 0, stage = 5;
    for (int level = 0; level < 4; ++level) {
      const int L = 8 << level;
      const LadderKey key{R, m, static_cast<uint32_t>(2) << level, level == 0};
      if (cur)
        lb0.set(lb0.off, count, nb);
      else
        lb1.set(lb1.off, count, nb);
      cur = cluster_sort(
          lb0, lb1, cur, count, 2, false,
          [](uint32_t e, int k) { return e >> (16 + 8 * (k & 1)) & 255; },
          [&](uint32_t e, int k) { return key.load(e, k); }, sm);
      stamp_time(sm, stage++);
      const Spread<uint32_t> A = cur ? lb1 : lb0;
      uint32_t lo, len;
      A.share(count, lo, len);
      const uint32_t spt = (len + kThreads - 1) / kThreads;
      const uint32_t t0 = min(threadIdx.x * spt, len),
                     t1 = min(t0 + spt, len);
      // an element holds g and its partner's label: the key is that and
      // g's own label
      auto pair = [&](uint32_t e) {
        return (e & 0xFFFF0000u) | key.R.get(e & 0xFFFF);
      };
      uint32_t bmask = 0, mx = 0;
      uint32_t kprev = t0 < t1 && lo + t0 > 0 ? pair(A.get(lo + t0 - 1)) : 0;
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        if (t0 + u < t1) {
          const uint32_t i = lo + t0 + u, e = A.local()[t0 + u];
          const uint32_t g = e & 0xFFFF, kg = pair(e);
          if (i == 0 || kg != kprev) {
            bmask |= 1u << u;
            mx = i << 16 | g;
          }
          kprev = kg;
        }
      }
      if (t0 < t1 && (lo + t1 >= count || pair(A.get(lo + t1)) != kprev))
        bmask |= 1u << (t1 - t0);
      uint32_t rep = 0;
#pragma unroll
      for (int u = 0; u < kSteps; ++u)
        if (t0 + u < t1) rep += (bmask >> u & 3) != 3;
      uint32_t ta, tb, ca, cb, all;
      block_scan2(rep, mx, sm_words(kWsOff), ta, tb);
      cluster_carry(ta, tb, sm, 2 + level, ca, cb, all);
      // every label of the level is read: relabel, take the candidates and
      // keep the groups of two or more
      Spread<uint32_t> next;
      next.set(cur ? lb0.off : lb1.off, all, nb);
      uint32_t ni = ca + rep, lab = max(cb, mx);
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        if (t0 + u < t1) {
          const uint32_t i = lo + t0 + u, g = A.local()[t0 + u] & 0xFFFF;
          if (bmask >> u & 1) lab = i << 16 | g;
          if (level > 0) {
            const uint32_t gsi = lab >> 16;
            int bml = 0, bd = 0;
            for (uint32_t j = 1; j <= kTierK && j <= i - gsi; ++j) {
              const int q = 2 * static_cast<int>(A.get(i - j) & 0xFFFF);
              const int dist = 2 * static_cast<int>(g) - q;
              if (dist > kWindow || q < hs) break;
              merge(L + win.common(2 * g + L, q + L, 8), dist, bml, bd);
            }
            if (bml > 0) {
              const uint32_t b = best.get(2 * g);
              int ml0 = static_cast<int>(b >> 16),
                  d0 = static_cast<int>(b & 0xFFFF);
              merge(bml, bd, ml0, d0);
              best.put(2 * g, static_cast<uint32_t>(ml0) << 16 |
                                  static_cast<uint32_t>(d0));
            }
          }
          if (level < 3) R.put(g, static_cast<uint16_t>(lab & 0xFFFF));
          if ((bmask >> u & 3) != 3) next.put(ni++, g | (lab & 0xFFFF) << 16);
        }
      }
      cluster.sync();
      stamp_time(sm, stage++);
      count = all;
      cur ^= 1;
      if (cur)
        lb1 = next;
      else
        lb0 = next;
      if (level < 3) stamp(sm, kStages + 2 + level, count);
    }

    // covering decay, the clip to the valid bytes, the outputs
    {
      uint32_t lo, len;
      best.share(s, lo, len);
      const uint32_t spt = (len + kThreads - 1) / kThreads;
      const uint32_t t0 = min(threadIdx.x * spt, len),
                     t1 = min(t0 + spt, len);
      uint32_t mx = 0, zero = 0;
      for (uint32_t li = t0; li < t1; ++li) {
        const uint32_t b = best.local()[li], p = lo + li;
        const uint32_t ml = b >> 16, dist = b & 0xFFFF;
        if (ml >= 4)
          mx = max(mx, (ml + p) << 15 |
                           (32768 - min(max(dist, 1u), 32768u)));
      }
      uint32_t ta, tb, ca, cb, all;
      block_scan2(zero, mx, sm_words(kWsOff), ta, tb);
      cluster_carry(ta, tb, sm, 6, ca, cb, all);
      uint32_t c = max(cb, mx);
      for (uint32_t li = t0; li < t1; ++li) {
        const uint32_t b = best.local()[li];
        const int p = static_cast<int>(lo + li);
        int ml = static_cast<int>(b >> 16), dist = static_cast<int>(b & 0xFFFF);
        if (ml >= 4)
          c = max(c, static_cast<uint32_t>(ml + p) << 15 |
                         static_cast<uint32_t>(32768 - min(max(dist, 1), 32768)));
        const int cml = static_cast<int>(c >> 15) - p;
        if (cml > ml && cml >= 4) {
          ml = cml;
          dist = 32768 - static_cast<int>(c & 0x7FFF);
        }
        ml = min(ml, min(max(vl - p, 0), 258));
        if (ml < 4) ml = 0;
        best.local()[li] = static_cast<uint32_t>(ml) << 16 |
                         static_cast<uint32_t>(dist);
      }
      __syncthreads();
      const size_t o = static_cast<size_t>(row) * s + lo;
      for (uint32_t li = threadIdx.x; li < len; li += kThreads) {
        const uint32_t b = best.local()[li];
        out_ml[o + li] = b >> 16;
        out_dist[o + li] = b & 0xFFFF;
      }
    }
    stamp_time(sm, kStages);
  }
  cluster.sync();                 // no block leaves while others read it
}

// The cluster size (8, or 16 where the window does not fit 8) and the
// dynamic shared memory of a block, or 0 when no size fits.
int pick(int s, int& nb, int& bytes) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  for (nb = 8; nb <= 16; nb *= 2) {
    const Layout l = layout(s, nb);
    bytes = l.total;
    if (bytes <= optin &&
        (static_cast<int>(l.chunk_n) + kThreads - 1) / kThreads <= kSteps)
      return 1;
  }
  return 0;
}

cudaError_t configure(int s, int& nb, int& bytes, int& clusters) {
  if (!pick(s, nb, bytes)) return cudaErrorInvalidValue;
  cudaError_t rc = cudaFuncSetAttribute(
      match_l6_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc == cudaSuccess && nb > 8)
    rc = cudaFuncSetAttribute(match_l6_kernel,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (rc != cudaSuccess) return rc;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(nb, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = cudaOccupancyMaxActiveClusters(&clusters, match_l6_kernel, &cfg);
  if (rc == cudaSuccess && clusters <= 0) rc = cudaErrorInvalidConfiguration;
  return rc;
}

}  // namespace

// The launch shape at window s: the cluster size, the dynamic shared
// memory of a block and the clusters resident on the card at once (the
// kernel's persistent clusters, at most one per window). Returns a CUDA
// error code (0: the kernel takes such windows).
extern "C" int ldrsx_match_l6_shape(int s, int* cluster_size, int* shared,
                                    int* clusters) {
  int nb = 0, bytes = 0, c = 0;
  if (s < 2 || (s & 1) || s / 2 + 40 >= 65536)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t rc = configure(s, nb, bytes, c);
  *cluster_size = nb;
  *shared = bytes;
  *clusters = c;
  return static_cast<int>(rc);
}

// (ml, dist) int64 (rows, s) of rows windows of `stride` bytes (stride >=
// s + 48), valid and hist int32 (rows,); stamps (null, or kStages + 5
// words) takes the stage times of the first window and the sizes
// of its active lists (8-byte level, L16, L32, L64). Returns a CUDA error
// code (0: launched).
extern "C" int ldrsx_match_l6_stamped(const void* data, int rows, int stride,
                                      int s, const void* valid,
                                      const void* hist, void* ml, void* dist,
                                      void* stamps, void* stream) {
  if (rows <= 0) return 0;
  if (s < 2 || (s & 1) || s / 2 + 40 >= 65536 || stride < s + 48)
    return static_cast<int>(cudaErrorInvalidValue);
  int nb = 0, bytes = 0, clusters = 0;
  cudaError_t rc = configure(s, nb, bytes, clusters);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(nb * (clusters < rows ? clusters : rows), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = cudaLaunchKernelEx(
      &cfg, match_l6_kernel, static_cast<const uint8_t*>(data), rows, stride,
      s, static_cast<const int32_t*>(valid), static_cast<const int32_t*>(hist),
      static_cast<int64_t*>(ml), static_cast<int64_t*>(dist),
      static_cast<uint64_t*>(stamps));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ldrsx_match_l6(const void* data, int rows, int stride, int s,
                              const void* valid, const void* hist, void* ml,
                              void* dist, void* stream) {
  return ldrsx_match_l6_stamped(data, rows, stride, s, valid, hist, ml, dist,
                                nullptr, stream);
}
