// L1-5 match finder on NVIDIA Hopper (sm_90a): (ml, dist) for every position
// of a batch of blocks, one thread block cluster per window of a block, the
// window's sort in the cluster's shared memory.
//
// Replaces the JAX package's XLA graph libdeflate_rsx_tpu/ops/encode_v2.py:73
// find_matches_v2 (no Pallas kernel) and computes what its plain PyTorch
// version, ops/encode_v2.py find_matches_v2_plain, computes, for every
// position p < s of a block (positions past valid_len included):
// - q is p's predecessor in the stable sort of the block's positions by
//   w0, the little-endian word of bytes p..p+3 (the nearest earlier
//   position with the same word); the first position of the sorted order
//   has none;
// - where q exists and p - q <= 32,768: dist = p - q and ml = 4 plus the
//   equal low bytes of w1(p) ^ w1(q) (w1: the word of bytes p+4..p+7), 8
//   when they are equal; elsewhere both are 0. Only the nearest copy
//   counts: one 32,769 back gives no match, whatever lies further back;
// - ml = min(ml, clamp(valid_len - p, 0, 8)), then 0 below 4; dist is not
//   zeroed again, so past valid_len a position can keep its dist with ml 0.
// The words read the block's padding as it is (not as zeros).
//
// The TPU form is a whole-block stable sort carrying the next word, then a
// second sort by position in place of a scatter. Here:
// - a window of at most 65,536 positions is one cluster's work: a block of
//   up to 65,536 bytes is one window; a longer block is cut into windows
//   whose outputs are 32,768 positions [o, o + 32,768), each window taking
//   the 32,768 positions before o as well (from max(0, o - 32,768)), so
//   that p's predecessor within 32,768 bytes, when there is one, lies in
//   the window, and none does when the nearest copy is further back: the
//   window's answer is the block's;
// - the window's positions (16-bit, within the window) are sorted stably
//   by a 16-bit hash of their word, h = (w0 * 0x9E3779B1) >> 16, in two
//   LSD radix passes of 8 bits (a pass whose digit is the same for every
//   element is skipped, so a block of one repeated byte sorts in no pass).
//   Every copy of p's word then lies in p's bucket, in position order;
// - each element compares its word with its sorted neighbour below: an
//   equal word is p's nearest earlier copy, a neighbour of another hash
//   (or none) means there is no copy, and so does a neighbour more than
//   32,768 back. The few elements left (the neighbour is another word of
//   the same hash) walk back through their bucket a run of one word at a
//   time, along a bitmap of the list's word boundaries: each step passes
//   a whole run of an unequal word, and the walk stops at the first equal
//   word (the match), at the bucket's start or past 32,768 (no match);
// - a walk may pass at most kWalkCap runs of unequal words: a window in
//   which one would pass more (many distinct words of one hash, as crafted
//   input can make) is sorted again in the same launch by the four 8-bit
//   passes of the whole word and swept against each sorted neighbour, the
//   exact path that bounds the walk; the launch counts such windows;
// - each element stores its dist (16 bits) by position in the cluster;
//   each block then writes its share of positions out, ml from the two w1
//   words of p and p - dist, the cap on ml alone.
//
// The layout on this card: a cluster of 4 thread blocks of 1,024 threads
// (one block per SM) holds one window, persistent over the windows; a
// launch whose windows all fit in one round of resident 8-block clusters
// takes clusters of 8 instead, or else, where they fit one round of
// 6-block clusters, of 6 (an L1 pass's 16 blocks: 15 clusters of 8 are
// resident on an H100, 17 of 6). A TMA bulk copy multicast to the cluster
// puts the window's bytes in every block's shared memory, into one of two
// buffers: the next window's copy is issued as soon as its buffer is free,
// so that it lands while this window is sorted, walked and written. The
// two lists, the boundary bitmap and the dist words are spread over the
// blocks in equal chunks (16,384 elements a block of 4 at 65,536
// positions) and read and written through distributed shared memory
// (ld/st.shared::cluster). A radix pass (the code of csrc/match_l6.cu's
// base sort, kept as a copy here, its per-warp counts padded against bank
// conflicts): each warp ranks its contiguous share by digit into 16-bit
// per-warp counts, a warp scan per digit turns them into offsets, the
// block puts its share in digit order in place, the blocks exchange their
// digit totals over the cluster, and each block copies its share out in
// order, each digit's run to consecutive slots. So no element goes
// through device memory: the kernel moves the block rows in and int64
// (ml, dist) out, which is its bound.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kWindowMax = 65536;            // positions a cluster sorts
constexpr int kSegment = 32768;              // outputs of a longer block's window
constexpr int kReach = 32768;                // WINDOW_SIZE
constexpr int kMaxVecMl = 8;
constexpr int kRowPad = 24;                  // bytes a row holds past s at least
constexpr uint32_t kHashMul = 0x9E3779B1u;
constexpr int kWalkCap = 64;                 // unequal runs a walk may pass

// The probe's stage times of the first window (block 0 of cluster 0): the
// global nanosecond timer at each stage end, thread 0 writing.
constexpr int kStages = 17;

__device__ unsigned long long g_escapes;     // windows sorted by the whole word

__device__ __forceinline__ void stamp_time(uint64_t* st, int k) {
  if (st != nullptr && threadIdx.x == 0) {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    st[k] = t;
  }
}

__device__ __forceinline__ uint32_t lanemask_lt() {
  uint32_t m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ uint32_t hash_of(uint32_t w) {
  return (w * kHashMul) >> 16;
}

extern __shared__ __align__(16) unsigned char smem[];

// Loads and stores in a block's shared memory or another block's of the
// cluster, by a 32-bit shared::cluster address.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t r) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(a), "r"(r));
  return a;
}
__device__ __forceinline__ uint32_t ld_cluster(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ uint32_t ld_cluster16(uint32_t a) {
  uint16_t v;
  asm volatile("ld.shared::cluster.u16 %0, [%1];" : "=h"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void st_cluster16(uint32_t a, uint32_t v) {
  asm volatile("st.shared::cluster.u16 [%0], %1;" ::"r"(a),
               "h"(static_cast<uint16_t>(v))
               : "memory");
}

// The elements a block of a cluster of c holds at most (a multiple of
// 32), and a thread's at most.
__host__ __device__ constexpr int chunk_of(int c) {
  return ((kWindowMax + c - 1) / c + 31) / 32 * 32;
}
__host__ __device__ constexpr int steps_of(int c) {
  return (chunk_of(c) + kThreads - 1) / kThreads;
}

// A list of 16-bit elements spread over the cluster of C blocks: element
// i lives in block i / chunk, at i % chunk of the array at byte `off` of
// that block's shared memory. The chunk is a multiple of 32, so that a
// 32-bit word of a bitmap over the list lies in one block.
template <int C>
struct Spread {
  uint32_t off, chunk;
  uint32_t magic;                 // ceil(2^32 / chunk): i / chunk exactly
                                  // for i * chunk < 2^32

  __device__ void set(uint32_t at, uint32_t count) {
    off = at;
    chunk = max(((count + C - 1) / C + 31) & ~31u, 32u);
    magic = static_cast<uint32_t>(((uint64_t{1} << 32) + chunk - 1) / chunk);
  }
  __device__ uint16_t* local() const {
    return reinterpret_cast<uint16_t*>(smem + off);
  }
  __device__ uint32_t get(uint32_t i) const {
    const uint32_t r = __umulhi(i, magic), at = i - r * chunk;
    if (r == cg::this_cluster().block_rank()) return local()[at];
    return ld_cluster16(cluster_addr(local() + at, r));
  }
  __device__ void put(uint32_t i, uint32_t v) const {
    const uint32_t r = __umulhi(i, magic), at = i - r * chunk;
    if (r == cg::this_cluster().block_rank())
      local()[at] = static_cast<uint16_t>(v);
    else
      st_cluster16(cluster_addr(local() + at, r), v);
  }
  // word g of a bitmap over the list, kept at byte `bits` of each block
  // (chunk / 32 words a block)
  __device__ uint32_t bit_word(uint32_t bits, uint32_t g) const {
    const uint32_t i = g * 32, r = __umulhi(i, magic);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(smem + bits) +
                        ((i - r * chunk) >> 5);
    if (r == cg::this_cluster().block_rank()) return *w;
    return ld_cluster(cluster_addr(w, r));
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
  __device__ uint32_t byte(uint32_t p) const { return smem[at + p]; }
  __device__ uint32_t word(uint32_t p) const {
    const int a = at + static_cast<int>(p);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(smem) + (a >> 2);
    return __funnelshift_r(w[0], w[1], (a & 3) * 8);
  }
  // digit k of element e's key: a byte of the word's hash, or of the word
  template <bool kHash>
  __device__ uint32_t digit(uint32_t e, int k) const {
    if (kHash) return hash_of(word(e)) >> (8 * k) & 255;
    return byte(e + k);
  }
};

// Dynamic shared memory (smem): the two mbarriers at 0, the small arrays
// at fixed offsets, then the lists, the bitmap and the windows (Layout).
constexpr int kFlagOff = 16;                 // a walk here passed the cap
constexpr int kHistOff = 32;                 // 2 x 256: a pass's digit totals
constexpr int kOffOff = kHistOff + 2048;     // 256: a pass's first slots
constexpr int kLstOff = kOffOff + 1024;      // 256: first places in a block
constexpr int kWsOff = kLstOff + 1024;       // 8: the digit scan's warp totals
constexpr int kWcOff = kWsOff + 64;          // per-warp digit counts
// 16-bit counts a warp: 256 digits, padded to an odd number of words so
// that the warps' counts of one digit lie in distinct banks
constexpr int kWcStride = 258;

__device__ __forceinline__ uint16_t* sm_wc() {
  return reinterpret_cast<uint16_t*>(smem + kWcOff);
}
__device__ __forceinline__ uint32_t* sm_words(int off) {
  return reinterpret_cast<uint32_t*>(smem + off);
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

// The stable LSD radix sort of the window's positions 0..count-1 (the
// identity list, not stored before the first pass) through the lists a
// and b, by the 2 bytes of their word's hash (kHash) or the 4 bytes of the
// word; returns which list holds the result (0: a). `par` is which half of
// the digit totals the next pass uses (a peer may still read the other
// half). st, when set, takes pass k's five stage ends at base + 5k.
template <int C, bool kHash>
__device__ __forceinline__ int cluster_sort(Spread<C> a, Spread<C> b,
                                            uint32_t count, const Win& win,
                                            int& par, uint64_t* st, int base) {
  constexpr int kSteps = steps_of(C);       // elements a thread at most
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t me = cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t lo, len;
  a.share(count, lo, len);
  const int steps = static_cast<int>((len + kThreads - 1) / kThreads);
  const uint32_t w0 = static_cast<uint32_t>(warp * steps * 32);
  int cur = 0;
  bool ident = true;
  for (int k = 0; k < (kHash ? 2 : 4); ++k) {
    const Spread<C> src = cur ? b : a;
    const Spread<C> dst = cur ? a : b;
    uint32_t* hist = sm_words(kHistOff) + 256 * par;
    par ^= 1;
    for (int d = lane; d < 256; d += 32) sm_wc()[warp * kWcStride + d] = 0;
    __syncwarp();
    // each warp ranks its share by digit: rk, the element's place among
    // the warp's elements of its digit (two 16-bit places a word); el, the
    // element with its digit above it
    uint32_t el[kSteps], rk[(kSteps + 1) / 2];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const uint32_t li = w0 + u * 32 + lane;
      el[u] = 0;
      if (u < steps && li < len) {
        const uint32_t e = ident ? lo + li : src.local()[li];
        el[u] = e | win.digit<kHash>(e, k) << 16;
      }
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      if (u >= steps) break;
      const bool ok = w0 + u * 32 + lane < len;
      const uint32_t d = ok ? el[u] >> 16 : 256 + lane;
      // the lanes of the warp with this lane's digit: by 9 ballots in the
      // hash's first pass (nearly every lane's digit differs there, and
      // __match_any_sync's time grows with the distinct values), else by
      // __match_any_sync
      uint32_t peers = 0xffffffffu;
      if (kHash && k == 0) {
#pragma unroll
        for (int bit = 0; bit < 9; ++bit) {
          const uint32_t m = __ballot_sync(0xffffffffu, d >> bit & 1);
          peers &= d >> bit & 1 ? m : ~m;
        }
      } else {
        peers = __match_any_sync(0xffffffffu, d);
      }
      const uint32_t below = __popc(peers & lanemask_lt());
      uint16_t* c = sm_wc() + warp * kWcStride + (d & 255);
      const uint32_t r = ok ? *c + below : 0;
      __syncwarp();
      if (ok && below == 0) *c += __popc(peers);
      if (u & 1)
        rk[u / 2] |= r << 16;
      else
        rk[u / 2] = r;
      __syncwarp();               // the next step's count after this one
    }
    __syncthreads();
    // per digit, the warps' counts -> each warp's first place; the block's
    // total of each digit to hist
    for (int q0 = 0; q0 < 8; q0 += 4) {
      uint32_t c[4], x[4];
      uint16_t* w = sm_wc() + lane * kWcStride + warp * 8 + q0;
#pragma unroll
      for (int q = 0; q < 4; ++q) x[q] = c[q] = w[q];
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
        w[q] = static_cast<uint16_t>(x[q] - c[q]);
        if (lane == 31) hist[warp * 8 + q0 + q] = x[q];
      }
    }
    __syncthreads();
    const uint32_t first =
        digit_scan(threadIdx.x < 256 ? hist[threadIdx.x] : 0, sm_words(kWsOff));
    if (threadIdx.x < 256) sm_words(kLstOff)[threadIdx.x] = first;
    __syncthreads();
    stamp_time(st, base + 5 * k);
    // the block's share in digit order, in place
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const uint32_t li = w0 + u * 32 + lane;
      if (u < steps && li < len) {
        const uint32_t d = el[u] >> 16;
        src.local()[sm_words(kLstOff)[d] + sm_wc()[warp * kWcStride + d] +
                    (rk[u / 2] >> (16 * (u & 1)) & 0xFFFF)] =
            static_cast<uint16_t>(el[u]);
      }
    }
    ident = false;
    if (st != nullptr) __syncthreads();
    stamp_time(st, base + 5 * k + 1);
    cluster.sync();
    stamp_time(st, base + 5 * k + 2);
    // each digit's first slot: the digits below it in the whole list, and
    // this digit in the blocks ranked below this one
    uint32_t tot = 0, before = 0;
    if (threadIdx.x < 256) {
#pragma unroll
      for (int r = 0; r < C; ++r) {
        const uint32_t h = ld_cluster(cluster_addr(hist + threadIdx.x, r));
        tot += h;
        if (r < static_cast<int>(me)) before += h;
      }
    }
    const uint32_t slot0 = digit_scan(tot, sm_words(kWsOff));
    if (threadIdx.x < 256) sm_words(kOffOff)[threadIdx.x] = slot0 + before;
    // a digit that every element has: the pass keeps the order
    if (__syncthreads_or(threadIdx.x < 256 && tot == count)) {
      stamp_time(st, base + 5 * k + 3);
      stamp_time(st, base + 5 * k + 4);
      continue;
    }
    for (uint32_t li = threadIdx.x; li < len; li += kThreads) {
      const uint32_t e = src.local()[li], d = win.digit<kHash>(e, k);
      dst.put(sm_words(kOffOff)[d] + li - sm_words(kLstOff)[d], e);
    }
    if (st != nullptr) __syncthreads();
    stamp_time(st, base + 5 * k + 3);
    cluster.sync();
    stamp_time(st, base + 5 * k + 4);
    cur ^= 1;
  }
  return cur;
}

// The first index of the run of equal words that holds sorted index j:
// the highest boundary bit at or below j (bit 0 is always set).
template <int C>
__device__ __forceinline__ uint32_t run_start(const Spread<C>& P, uint32_t bits,
                                              uint32_t j) {
  uint32_t g = j >> 5;
  uint32_t m = P.bit_word(bits, g) & (0xFFFFFFFFu >> (31 - (j & 31)));
  while (m == 0) m = P.bit_word(bits, --g);
  return g * 32 + 31 - __clz(m);
}

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

__host__ __device__ inline int up16(long long v) {
  return static_cast<int>((v + 15) & ~15ll);
}

// Windows of a block of s positions, and window k's outputs [o, e) and
// first position w: one window [0, s) up to kWindowMax, else windows of
// kSegment outputs, each with the kReach positions before them.
__host__ __device__ inline long long windows_of(int s) {
  return s <= kWindowMax ? 1 : (s + kSegment - 1) / kSegment;
}
__host__ __device__ inline int window_positions(int s) {
  return s < kWindowMax ? s : kWindowMax;
}

// Window w of a batch: its row, outputs [o, e), first position and size,
// and the TMA copy of its bytes and the 7 after them, from the 16-byte
// aligned address `src` at or below them (`off` bytes below).
struct Geo {
  int row, o, e, first, off;
  uint32_t n, bytes;
  const uint8_t* src;
};

__device__ __forceinline__ Geo geo_of(long long w, const uint8_t* data,
                                      int stride, int s) {
  const long long per_row = windows_of(s);
  Geo g;
  g.row = static_cast<int>(w / per_row);
  const int seg = static_cast<int>(w - static_cast<long long>(g.row) * per_row);
  g.o = per_row == 1 ? 0 : seg * kSegment;
  g.e = per_row == 1 ? s : min(s, g.o + kSegment);
  g.first = max(0, g.o - (per_row == 1 ? 0 : kReach));
  g.n = static_cast<uint32_t>(g.e - g.first);
  const uint8_t* src = data + static_cast<size_t>(g.row) * stride + g.first;
  g.off = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  g.src = src - g.off;
  g.bytes = static_cast<uint32_t>(up16(g.off + g.n + 8));
  return g;
}

struct Layout {                   // byte offsets in dynamic shared memory
  int x0, x1, bits, win[2], total;
};

template <int C>
__host__ __device__ inline Layout layout(int s) {
  const long long n = window_positions(s);
  long long chunk = ((n + C - 1) / C + 31) & ~31ll;
  if (chunk < 32) chunk = 32;
  Layout l;
  l.x0 = kWcOff + up16(kWarps * kWcStride * 2);
  l.x1 = l.x0 + up16(chunk * 2);
  l.bits = l.x1 + up16(chunk * 2);
  l.win[0] = l.bits + up16(chunk / 8);
  l.win[1] = l.win[0] + up16(n + 48);
  l.total = l.win[1] + up16(n + 48);
  return l;
}

__device__ __forceinline__ void arm(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// One TMA copy of window g's bytes into the buffer at `dst` of every block
// of the cluster, completing on each block's barrier at `bar`.
template <int C>
__device__ __forceinline__ void issue(const Geo& g, uint32_t dst,
                                      uint32_t bar) {
  const uint16_t mask = static_cast<uint16_t>((1u << C) - 1);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(dst),
      "l"(g.src), "r"(g.bytes), "r"(bar), "h"(mask)
      : "memory");
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
    match_v2_kernel(const uint8_t* __restrict__ data, int rows, int stride,
                    int s, const int32_t* __restrict__ valid,
                    int64_t* out_ml, int64_t* out_dist, uint64_t* stamps) {
  constexpr int kSteps = steps_of(C);
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t me = cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long clusters = gridDim.x / C, cid = blockIdx.x / C;
  const long long windows = windows_of(s) * rows;
  const Layout lay = layout<C>(s);
  const uint32_t bar0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t buf0 =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem + lay.win[0]));
  const uint32_t buf1 =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem + lay.win[1]));
  volatile uint32_t* flag = sm_words(kFlagOff);
  int par = 0;

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0 + 8));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (cid < windows) arm(bar0, geo_of(cid, data, stride, s).bytes);
  }
  cluster.sync();                 // every block's barriers set up and armed
  if (cid < windows && me == 0 && threadIdx.x == 0)
    issue<C>(geo_of(cid, data, stride, s), buf0, bar0);

  uint32_t it = 0;
  for (long long w = cid; w < windows; w += clusters, ++it) {
    const int buf = it & 1;
    const Geo g = geo_of(w, data, stride, s);
    uint64_t* st = it == 0 && cid == 0 && me == 0 ? stamps : nullptr;
    stamp_time(st, 0);
    // the next window's copy into the other buffer, once every block is
    // done with the window that used it
    const long long next = w + clusters;
    if (next < windows && threadIdx.x == 0)
      arm(bar0 + 8 * (buf ^ 1), geo_of(next, data, stride, s).bytes);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    cluster.sync();               // last window done: lists, flags, buffer
    if (next < windows && me == 0 && threadIdx.x == 0)
      issue<C>(geo_of(next, data, stride, s), buf ? buf0 : buf1,
               bar0 + 8 * (buf ^ 1));
    if (threadIdx.x == 0) *flag = 0;
    wait_window(bar0 + 8 * buf, (it >> 1) & 1);
    stamp_time(st, 1);
    const Win win{lay.win[buf] + g.off};
    const uint32_t n = g.n;

    Spread<C> a, b;
    a.set(lay.x0, n);
    b.set(lay.x1, n);
    int pc = cluster_sort<C, true>(a, b, n, win, par, st, 2);
    Spread<C> P = pc ? b : a;
    Spread<C> best = pc ? a : b;

    // each sorted element against its neighbour below (the lane below's,
    // for lane 0 the list's): the match, or none, or (another word of the
    // same hash within reach) a walk to make, queued in the warp's row of
    // the digit counts (free until the next sort; past kWcStride walks a
    // thread makes its own); the list's word boundaries to the bitmap, a
    // word a warp and step
    uint32_t lo, len;
    P.share(n, lo, len);
    const int steps = static_cast<int>((len + kThreads - 1) / kThreads);
    uint16_t* queue = sm_wc() + warp * kWcStride;
    uint32_t own = 0, queued = 0;
    for (int u = 0; u < steps; ++u) {
      const uint32_t li = u * kThreads + threadIdx.x, i = lo + li;
      const bool in = li < len;
      uint32_t p = 0, wp = 0;
      if (in) {
        p = P.local()[li];
        wp = win.word(p);
      }
      uint32_t q = __shfl_up_sync(0xffffffffu, p, 1);
      uint32_t wq = __shfl_up_sync(0xffffffffu, wp, 1);
      if (in && lane == 0 && i > 0) {
        q = li > 0 ? P.local()[li - 1] : P.get(i - 1);
        wq = win.word(q);
      }
      bool edge = true, defer = false;
      uint32_t dist = 0;
      if (in && i > 0) {
        if (wp == wq) {
          edge = false;
          if (p - q <= kReach) dist = p - q;
        } else {
          defer = hash_of(wp) == hash_of(wq) && p - q <= kReach;
        }
      }
      if (in && !defer) best.put(p, dist);
      const uint32_t bits = __ballot_sync(0xffffffffu, in && edge);
      if (lane == 0 && u * kThreads + warp * 32 < len)
        sm_words(lay.bits)[u * kWarps + warp] = bits;
      const uint32_t m = __ballot_sync(0xffffffffu, defer);
      if (defer) {
        const uint32_t at = queued + __popc(m & lanemask_lt());
        if (at < kWcStride)
          queue[at] = static_cast<uint16_t>(li);
        else
          own |= 1u << u;
      }
      queued += __popc(m);
    }
    if (st != nullptr) __syncthreads();
    stamp_time(st, 12);
    cluster.sync();               // the bitmap whole
    stamp_time(st, 13);
    // the walks, a run of one unequal word a step, the warp's queue a walk
    // a lane
    const uint32_t shared_walks = min(queued, static_cast<uint32_t>(kWcStride));
#pragma unroll 1
    for (uint32_t k = lane; k < shared_walks + 32 * kSteps; k += 32) {
      uint32_t li;
      if (k < shared_walks) {
        li = queue[k];
      } else {
        const int u = (k - shared_walks) >> 5;
        if (!(own >> u & 1)) continue;
        li = u * kThreads + threadIdx.x;
      }
      const uint32_t i = lo + li;
      const uint32_t p = P.local()[li], wp = win.word(p), hp = hash_of(wp);
      uint32_t k0 = run_start(P, lay.bits, i - 1), dist = 0;
      for (int passed = 1; k0 > 0;) {
        const uint32_t q = P.get(k0 - 1), wq = win.word(q);
        if (wq == wp) {
          if (p - q <= kReach) dist = p - q;
          break;
        }
        if (hash_of(wq) != hp || p - q > kReach) break;
        if (++passed == kWalkCap) {
          *flag = 1;
          break;
        }
        k0 = run_start(P, lay.bits, k0 - 1);
      }
      best.put(p, dist);
    }
    if (st != nullptr) __syncthreads();
    stamp_time(st, 14);
    cluster.sync();               // every dist stored, every flag set
    uint32_t over = 0;
    if (threadIdx.x < C)
      over = ld_cluster(cluster_addr(const_cast<uint32_t*>(flag), threadIdx.x));
    const bool escape = __syncthreads_or(over != 0);
    stamp_time(st, 15);
    if (escape) {
      // a walk passed the cap: the exact path, the sort by the whole word
      // and one sweep against each sorted neighbour
      if (me == 0 && threadIdx.x == 0) atomicAdd(&g_escapes, 1ull);
      pc = cluster_sort<C, false>(a, b, n, win, par, nullptr, 0);
      P = pc ? b : a;
      best = pc ? a : b;
      P.share(n, lo, len);
      for (uint32_t li = threadIdx.x; li < len; li += kThreads) {
        const uint32_t i = lo + li, p = P.local()[li];
        uint32_t dist = 0;
        if (i > 0) {
          const uint32_t q = li > 0 ? P.local()[li - 1] : P.get(i - 1);
          if (win.word(p) == win.word(q) && p - q <= kReach) dist = p - q;
        }
        best.put(p, dist);
      }
      cluster.sync();
    }
    stamp_time(st, 16);
    // this block's share of positions out, those of the window's outputs
    best.share(n, lo, len);
    const int vl = valid[g.row];
    const size_t at = static_cast<size_t>(g.row) * s + g.first;
    for (uint32_t li = threadIdx.x; li < len; li += kThreads) {
      const uint32_t p = lo + li;
      if (g.first + static_cast<int>(p) < g.o) continue;
      const uint32_t dist = best.local()[li];
      int ml = 0;
      if (dist != 0) {
        const uint32_t x = win.word(p + 4) ^ win.word(p - dist + 4);
        ml = x == 0 ? kMaxVecMl : 4 + ((__ffs(x) - 1) >> 3);
        const int cap = min(max(vl - g.first - static_cast<int>(p), 0),
                            kMaxVecMl);
        ml = min(ml, cap);
        if (ml < 4) ml = 0;
      }
      out_ml[at + p] = ml;
      out_dist[at + p] = dist;
    }
    if (st != nullptr) __syncthreads();
    stamp_time(st, kStages);
  }
  cluster.sync();                 // no block leaves while others read it
}

// The dynamic shared memory of a block and the clusters of C blocks
// resident on the card at once, at block size s (the kernel's shared
// memory attribute raised once a device, as far as it must go).
template <int C>
cudaError_t configure(int s, int& bytes, int& clusters) {
  static std::mutex mu;
  static int allowed[64] = {};
  int dev = 0, optin = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&optin,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc != cudaSuccess) return rc;
  bytes = layout<C>(s).total;
  if (bytes > optin) return cudaErrorInvalidValue;
  {
    std::lock_guard<std::mutex> hold(mu);
    if (dev >= 64 || allowed[dev] < bytes) {
      rc = cudaFuncSetAttribute(match_v2_kernel<C>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                bytes);
      if (rc != cudaSuccess) return rc;
      if (dev < 64) allowed[dev] = bytes;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = cudaOccupancyMaxActiveClusters(&clusters, match_v2_kernel<C>, &cfg);
  if (rc == cudaSuccess && clusters <= 0) rc = cudaErrorInvalidConfiguration;
  return rc;
}

// The launch of `windows` windows at block size s: the larger cluster, of
// 8 blocks or else of 6, whose resident clusters take every window in one
// round, else clusters of 4.
struct Shape {
  int cluster, bytes, clusters;
};

cudaError_t choose(int s, long long windows, Shape& sh) {
  int bytes = 0, clusters = 0;
  if (configure<8>(s, bytes, clusters) == cudaSuccess && windows <= clusters) {
    sh = {8, bytes, clusters};
    return cudaSuccess;
  }
  cudaGetLastError();             // a refused larger shape is no error
  if (configure<6>(s, bytes, clusters) == cudaSuccess && windows <= clusters) {
    sh = {6, bytes, clusters};
    return cudaSuccess;
  }
  cudaGetLastError();
  const cudaError_t rc = configure<4>(s, bytes, clusters);
  sh = {4, bytes, clusters};
  return rc;
}

bool takes(int s) { return s >= 1 && s <= (1 << 30); }

}  // namespace

// The launch shape of rows blocks of size s: the cluster size, the
// dynamic shared memory of a block, the clusters resident on the card at
// once and the rounds they take over the windows. Returns a CUDA error
// code (0: the kernel takes such blocks).
extern "C" int ldrsx_match_v2_shape(int s, int rows, int* cluster_size,
                                    int* shared, int* clusters, int* rounds) {
  if (!takes(s) || rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long windows = windows_of(s) * rows;
  Shape sh = {};
  const cudaError_t rc = choose(s, windows, sh);
  *cluster_size = sh.cluster;
  *shared = sh.bytes;
  *clusters = sh.clusters;
  *rounds = sh.clusters > 0
                ? static_cast<int>((windows + sh.clusters - 1) / sh.clusters)
                : 0;
  return static_cast<int>(rc);
}

// The windows that took the exact path (the sort by the whole word) since
// the last reset, on the current device; reading waits for the device.
extern "C" int ldrsx_match_v2_escapes(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_escapes, sizeof(*out)));
}

extern "C" int ldrsx_match_v2_reset_escapes() {
  const unsigned long long zero = 0;
  return static_cast<int>(cudaMemcpyToSymbol(g_escapes, &zero, sizeof(zero)));
}

// The stage names of the stamped entry's kStages stamps after the first.
extern "C" const char* ldrsx_match_v2_stage_names() {
  return "wait,h0 rank,h0 reorder,h0 barrier,h0 scatter,h0 barrier,"
         "h1 rank,h1 reorder,h1 barrier,h1 scatter,h1 barrier,"
         "neighbours and scatter by position,barrier,walks,barrier,"
         "word sort (escape),output";
}

// (ml, dist) int64 (rows, s) of rows blocks of `stride` bytes (stride >=
// s + 24: the words past the block and the aligned copy read into the
// padding), valid int32 (rows,); stamps (null, or kStages + 1 words)
// takes the stage times of the first window. Returns a CUDA error code
// (0: launched).
extern "C" int ldrsx_match_v2_stamped(const void* data, int rows, int stride,
                                      int s, const void* valid, void* ml,
                                      void* dist, void* stamps, void* stream) {
  if (rows <= 0) return 0;
  if (!takes(s) || stride < s + kRowPad)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long windows = windows_of(s) * rows;
  Shape sh = {};
  cudaError_t rc = choose(s, windows, sh);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = sh.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  const long long grid = sh.clusters < windows ? sh.clusters : windows;
  cfg.gridDim = dim3(sh.cluster * static_cast<unsigned>(grid), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = sh.bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const auto* in = static_cast<const uint8_t*>(data);
  const auto* v = static_cast<const int32_t*>(valid);
  auto* m = static_cast<int64_t*>(ml);
  auto* d = static_cast<int64_t*>(dist);
  auto* t = static_cast<uint64_t*>(stamps);
  rc = sh.cluster == 8   ? cudaLaunchKernelEx(&cfg, match_v2_kernel<8>, in,
                                                rows, stride, s, v, m, d, t)
       : sh.cluster == 6 ? cudaLaunchKernelEx(&cfg, match_v2_kernel<6>, in,
                                                rows, stride, s, v, m, d, t)
                         : cudaLaunchKernelEx(&cfg, match_v2_kernel<4>, in,
                                                rows, stride, s, v, m, d, t);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ldrsx_match_v2(const void* data, int rows, int stride, int s,
                              const void* valid, void* ml, void* dist,
                              void* stream) {
  return ldrsx_match_v2_stamped(data, rows, stride, s, valid, ml, dist,
                                nullptr, stream);
}
