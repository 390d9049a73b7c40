// Dynamic-Huffman table step on NVIDIA Hopper (sm_90a): per-block
// litlen/offset histograms -> bit-reversed canonical code tables and the
// serialized dynamic block header, two warps per histogram.
//
// Replaces the JAX package's host table step (libdeflate_rsx_tpu/native/
// codec.c dyn_tables_c, bound at native/__init__.py dyn_tables_native),
// computing what the JAX package runs while that library does not build:
// its Python builder _build_tables_py (ops/encode_dynamic.py). That
// builder and this kernel give the same tables and header bytes for every
// histogram; the C builder gives other tables. Steps per histogram: +1 in
// the EOB bin; package-merge code lengths limited to 14 bits (litlen) and
// 15 (offsets); a lone used symbol gets a partner of length 1
// (_ensure_complete); canonical codes, bit-reversed; the header: HLIT and
// HDIST trimmed, the code lengths run-length coded into precode symbols
// (_precode_rle), a 7-bit-limited precode by package-merge, HCLEN trimmed
// in RFC 1951's permutation order, all packed LSB-first behind the 3 bits
// BFINAL | BTYPE=10. The plain PyTorch version of this kernel is
// ops/dyn_tables.py's build_tables_plain.
//
// Tie order. The Python package-merge sorts items as (weight, tuple of
// symbols) at every level. Two items of equal weight never have one tuple
// as a proper prefix of the other (every symbol adds weight > 0), so the
// packages, made by pairing neighbours of a sorted list, are already in
// order, and the sorted level is a merge of the leaves, sorted by
// (frequency, symbol), with the packages keyed by (weight, first symbol);
// a leaf goes first when its key is not greater, and a leaf and a package
// never tie on both keys. The kernel keeps (weight, first symbol) per
// item and a bit mask of the leaves among each level's items, and counts
// a symbol's length as the number of levels whose selected prefix holds
// its leaf: the selected items of a level are a prefix, and the packages
// among them select a prefix of the level below.
//
// What bounds it on this card: latency. Its bytes (318 counts in, 318
// table entries and 512 header bytes out per histogram) take well under
// a microsecond at the card's memory rate; the work is a chain of ~35
// dependent merge levels and the header. What the design does about it:
// - two warps per histogram, one for the litlen code and one for the
//   offset code, which meet at a 64-thread named barrier before the
//   litlen warp writes the header; four histograms per thread block, so
//   a pass's histograms run in one wave; every other step is
//   warp-synchronous (__syncwarp, shuffles, ballots), with no block-wide
//   barrier;
// - weights below 2^25 (a count is at most 65,535, so a weight is below
//   288 x 65,536), each item kept as one (weight << 9 | first symbol)
//   word, so a package's key is one 16-byte load of its two items; the
//   leaves sorted as packed (frequency << 9 | symbol) keys by a bitonic
//   sort in registers (16 keys a lane for 288 symbols, one for 30 and 19),
//   every count loaded at once;
// - each level merged by merge path: a lane finds where its share of the
//   output starts by one binary search, then merges its share in order;
// - canonical codes from per-length counts taken with __match_any_sync and
//   population counts, a symbol's rank among its length a prefix count;
// - the header in parallel: run starts by ballot, each run's precode
//   symbols in closed form, placed by a warp scan; the precode histogram
//   by shared atomics; each field's bit offset by a warp scan, the field
//   ORed into at most two words of the header with shared atomicOr.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NUM_LL = 288;
constexpr int NUM_OF = 30;
constexpr int NUM_PRE = 19;
constexpr int HDR_CAP = 512;
constexpr int HDR_WORDS = HDR_CAP / 4;
constexpr int SORT_LL = 512;               // litlen keys, to a power of two
constexpr int MAX_ITEMS = 576;             // a level holds < 2 * 288 items
constexpr int MAX_LEVELS = 15;
constexpr int MAX_RLE = NUM_LL + NUM_OF;
constexpr int HISTS = 4;                   // histograms per thread block,
constexpr int WARPS = 2 * HISTS;           // two warps each
constexpr unsigned FULL = 0xFFFFFFFFu;
enum : uint32_t { NONE = 0xFFFFFFFFu };     // the key of an unused symbol

__constant__ uint8_t kPerm[NUM_PRE] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                       11, 4, 12, 3, 13, 2, 14, 1, 15};

// One package-merge's shared state, with the canonical codes' scratch of
// the warp that runs it.
template <int KEYS, int ITEMS>
struct Chain {
  static constexpr int WORDS = (ITEMS + 31) / 32;
  // a level's items as (weight << 9 | first symbol), two levels
  alignas(16) unsigned long long item[2][ITEMS];
  uint32_t key[KEYS];                      // (freq << 9 | sym), sorted
  uint32_t mask[MAX_LEVELS][WORDS];        // leaves among a level's items
  int lencount[16];
  uint32_t next_code[16];
};

// One histogram's shared state (its two warps').
struct Hist {
  Chain<SORT_LL, MAX_ITEMS> ll;            // litlen
  Chain<32, 64> small;                     // offsets, then the precode
  uint32_t pre_freq[NUM_PRE + 1];
  uint32_t pre_code[NUM_PRE + 1];
  uint32_t hdr[HDR_WORDS];
  uint16_t run_start[MAX_RLE + 2];
  uint8_t ll_len[NUM_LL];
  uint8_t of_len[32];
  uint8_t pre_len[32];
  uint8_t all_len[MAX_RLE + 2];            // HLIT + HDIST lengths
  uint8_t rle_sym[MAX_RLE];
  uint8_t rle_ev[MAX_RLE];
};

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << lane_id()) - 1;
}

__device__ __forceinline__ int warp_incl_scan(int v) {
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(FULL, v, d);
    if (lane_id() >= d) v += o;
  }
  return v;
}

// Bitonic sort of 32 keys, one a lane, ascending by lane.
__device__ __forceinline__ uint32_t sort32(uint32_t v) {
  const int lane = lane_id();
  for (int k = 2; k <= 32; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      const uint32_t o = __shfl_xor_sync(FULL, v, j);
      const bool up = (lane & k) == 0, lower = (lane & j) == 0;
      v = (lower == up) ? min(v, o) : max(v, o);
    }
  return v;
}

// Bitonic sort of SORT_LL keys in registers, 16 a lane: key i = 16 *
// lane + r is v[r]; partners within a lane are swapped in place, across
// lanes exchanged by shuffles. Ascending in i.
__device__ __forceinline__ void sort512(uint32_t (&v)[16]) {
  const int lane = lane_id();
#pragma unroll
  for (int k = 2; k <= SORT_LL; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= 16) {
        const bool keep_min = ((lane & (j >> 4)) == 0) ==
                              (((lane << 4) & k) == 0);
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const uint32_t o = __shfl_xor_sync(FULL, v[r], j >> 4);
          v[r] = keep_min ? min(v[r], o) : max(v[r], o);
        }
      } else {
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          if (r & j) continue;
          const bool up = ((lane << 4 | r) & k) == 0;
          const uint32_t a = v[r], b = v[r | j];
          v[r] = up ? min(a, b) : max(a, b);
          v[r | j] = up ? max(a, b) : min(a, b);
        }
      }
    }
  }
}

// A package of two items of the level below: (weight sum << 9 | the
// first item's symbol), the key it is merged by.
__device__ __forceinline__ unsigned long long package(
    const unsigned long long* level, int p) {
  const ulonglong2 two = reinterpret_cast<const ulonglong2*>(level)[p];
  return (((two.x >> 9) + (two.y >> 9)) << 9) | (two.x & 511);
}

// Package-merge code lengths (<= MAX_LEN) of the n leaves sorted in
// s.key, as the Python length_limited_lengths gives them, into
// lens[0, nsym). A leaf goes before a package when its key is not
// greater. The whole warp calls it.
template <int MAX_LEN, class C>
__device__ __forceinline__ void code_lengths(C& s, int nsym, int n,
                                             uint8_t* lens) {
  const int lane = lane_id();
  for (int i = lane; i < nsym; i += 32) lens[i] = 0;
  __syncwarp();
  if (n <= 1) {
    if (n == 1 && lane == 0) lens[s.key[0] & 511] = 1;
    __syncwarp();
    return;
  }
  for (int i = lane; i < n; i += 32) s.item[0][i] = s.key[i];
  if (lane < C::WORDS) {
    const int bits = n - 32 * lane;
    s.mask[0][lane] = bits >= 32 ? FULL : bits > 0 ? (1u << bits) - 1 : 0u;
#pragma unroll
    for (int k = 1; k < MAX_LEN; ++k) s.mask[k][lane] = 0;
  }
  __syncwarp();
  int cnt = n;
#pragma unroll 1
  for (int k = 1; k < MAX_LEN; ++k) {
    const unsigned long long* prev = s.item[(k - 1) & 1];
    unsigned long long* cur = s.item[k & 1];
    const int np = cnt >> 1, m = n + np;
    const int d0 = (m * lane) >> 5, d1 = (m * (lane + 1)) >> 5;
    // merge path: the leaves among the first d0 items of this level
    int lo = max(0, d0 - np), hi = min(d0, n);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const bool before = s.key[mid] <= package(prev, d0 - 1 - mid);
      lo = before ? mid + 1 : lo;
      hi = before ? hi : mid;
    }
    int i = lo, p = d0 - lo;
    const int base = d0 & ~31;
    uint64_t bits = 0;
    for (int d = d0; d < d1; ++d) {      // branch-free: both sides read
      const unsigned long long lk = i < n ? s.key[i] : ~0ull;
      const unsigned long long pk = p < np ? package(prev, p) : ~0ull;
      const bool leaf = lk <= pk;        // (a spent side reads as ~0)
      cur[d] = leaf ? lk : pk;
      bits |= uint64_t(leaf) << (d - base);
      i += leaf;
      p += !leaf;
    }
    if (bits & 0xFFFFFFFFull)
      atomicOr(&s.mask[k][base >> 5], static_cast<uint32_t>(bits));
    if (bits >> 32)
      atomicOr(&s.mask[k][(base >> 5) + 1],
               static_cast<uint32_t>(bits >> 32));
    cnt = m;
    __syncwarp();
  }
  // the first 2n-2 items of the top level are selected; the packages
  // among a level's selected prefix select a prefix of the level below
  int take[MAX_LEN];
  int c = min(2 * n - 2, cnt);
#pragma unroll
  for (int k = MAX_LEN - 1; k >= 0; --k) {
    uint32_t word = 0;
    if (lane < C::WORDS) {
      const int below = c - 32 * lane;
      const uint32_t mk = s.mask[k][lane];
      word = below >= 32 ? mk : below > 0 ? mk & ((1u << below) - 1) : 0u;
    }
    take[k] = __reduce_add_sync(FULL, __popc(word));
    c = 2 * (c - take[k]);
  }
  for (int i = lane; i < n; i += 32) {
    int len = 0;
#pragma unroll
    for (int k = 0; k < MAX_LEN; ++k) len += i < take[k];
    lens[s.key[i] & 511] = static_cast<uint8_t>(len);
  }
  __syncwarp();
}

// A code with one used symbol gets a second symbol of length 1
// (_ensure_complete). The whole warp calls it.
__device__ __forceinline__ void ensure_complete(uint8_t* lens, int nsym) {
  int used = 0, at = 0;
  for (int base = 0; base < nsym; base += 32) {
    const int i = base + lane_id();
    const unsigned bal = __ballot_sync(FULL, i < nsym && lens[i]);
    if (used == 0 && __popc(bal) == 1) at = base + __ffs(bal) - 1;
    used += __popc(bal);
  }
  if (used == 1 && lane_id() == 0) {
    lens[at == 0 ? 1 : 0] = 1;
    lens[at] = 1;
  }
  __syncwarp();
}

// Canonical codes of lens[0, nsym) (nsym <= 288), bit-reversed for
// LSB-first emission (canonical_codes): emit(symbol, code, length) for
// every symbol. The whole warp calls it.
template <class C, typename Emit>
__device__ __forceinline__ void canonical(C& s, const uint8_t* lens,
                                          int nsym, Emit emit) {
  const int lane = lane_id();
  if (lane < 16) s.lencount[lane] = 0;
  __syncwarp();
  uint32_t rank[NUM_LL / 32];
#pragma unroll
  for (int c = 0; c < NUM_LL / 32; ++c) {
    if (32 * c >= nsym) break;
    const int i = 32 * c + lane;
    const int l = i < nsym ? lens[i] : 0;
    const unsigned peers = __match_any_sync(FULL, l);
    rank[c] = s.lencount[l] + __popc(peers & lanes_below());
    __syncwarp();
    if (l && lane == __ffs(peers) - 1) s.lencount[l] += __popc(peers);
    __syncwarp();
  }
  if (lane >= 1 && lane < 16) {
    uint32_t code = 0;                     // the exclusive scan of
    for (int j = 1; j < lane; ++j)         // code = (code + count) << 1
      code += uint32_t(s.lencount[j]) << (lane - j);
    s.next_code[lane] = code;
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < NUM_LL / 32; ++c) {
    if (32 * c >= nsym) break;
    const int i = 32 * c + lane;
    if (i < nsym) {
      const int l = lens[i];
      emit(i, l ? __brev(s.next_code[l] + rank[c]) >> (32 - l) : 0u, l);
    }
  }
  __syncwarp();
}

// ORs the low `width` bits of v into the header at bit `off`.
__device__ __forceinline__ void put_bits(uint32_t* hdr, int off, uint32_t v,
                                         int width) {
  const int word = off >> 5, sh = off & 31;
  if (word < HDR_WORDS) atomicOr(&hdr[word], v << sh);
  if (sh + width > 32 && word + 1 < HDR_WORDS)
    atomicOr(&hdr[word + 1], v >> (32 - sh));
}

__device__ __forceinline__ int extra_bits(int sym) {
  return sym == 16 ? 2 : sym == 17 ? 3 : sym == 18 ? 7 : 0;
}

// The precode symbols of the run of L lengths of value v (_precode_rle;
// the runs are maximal, so a nonzero run always opens with its value):
// their count, or, with put, each one put(position, symbol, extra value).
template <typename Put>
__device__ __forceinline__ int run_symbols(int v, int L, Put put) {
  int k = 0;
  if (v == 0) {
    const int q = L / 138, rem = L % 138;
    for (int j = 0; j < q; ++j) put(k++, 18, 127);
    int r = rem;
    if (r >= 11) {
      put(k++, 18, r - 11);
      r = 0;
    }
    if (r >= 3) {
      put(k++, 17, r - 3);
      r = 0;
    }
    for (; r > 0; --r) put(k++, 0, 0);
  } else {
    put(k++, v, 0);
    const int q = (L - 1) / 6;
    int r = (L - 1) % 6;
    for (int j = 0; j < q; ++j) put(k++, 16, 3);
    if (r >= 3) {
      put(k++, 16, r - 3);
      r = 0;
    }
    for (; r > 0; --r) put(k++, v, 0);
  }
  return k;
}

__device__ __forceinline__ int run_count(int v, int L) {
  if (v == 0) {
    const int rem = L % 138;
    const int r = rem >= 11 ? 0 : rem;
    return L / 138 + (rem >= 11) + (r >= 3) + (r >= 3 ? 0 : r);
  }
  const int rem = (L - 1) % 6;
  return 1 + (L - 1) / 6 + (rem >= 3) + (rem >= 3 ? 0 : rem);
}

__global__ void __launch_bounds__(32 * WARPS)
dyn_tables_kernel(const uint16_t* __restrict__ ll_hist,
                  const uint16_t* __restrict__ of_hist,
                  const uint8_t* __restrict__ finals, int nhist,
                  int32_t* __restrict__ ll_tab, int32_t* __restrict__ of_tab,
                  uint8_t* __restrict__ hdr_out,
                  int32_t* __restrict__ hdr_bits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Hist& s = reinterpret_cast<Hist*>(smem_raw)[threadIdx.x >> 6];
  const int b = blockIdx.x * HISTS + (threadIdx.x >> 6);
  if (b >= nhist) return;
  const int lane = lane_id();
  if ((threadIdx.x >> 5) & 1) {
    // the offsets warp: lengths limited to 15 bits, codes, table
    const uint32_t f = lane < NUM_OF ? uint32_t(of_hist[b * NUM_OF + lane])
                                     : 0u;
    const int n = __popc(__ballot_sync(FULL, f != 0));
    s.small.key[lane] = sort32(f ? (f << 9 | lane) : uint32_t(NONE));
    __syncwarp();
    code_lengths<15>(s.small, NUM_OF, n, s.of_len);
    ensure_complete(s.of_len, NUM_OF);
    canonical(s.small, s.of_len, NUM_OF, [&](int i, uint32_t code, int l) {
      of_tab[b * NUM_OF + i] = static_cast<int32_t>(code | uint32_t(l) << 16);
    });
  } else {
    // the litlen warp: every count loaded at once, symbols 16 * lane + r
    uint32_t v[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int i = 16 * lane + r;
      v[r] = i < NUM_LL ? uint32_t(ll_hist[b * NUM_LL + i]) + (i == 256)
                        : 0u;
    }
    for (int i = lane; i < HDR_WORDS; i += 32) s.hdr[i] = 0;
    if (lane < NUM_PRE + 1) s.pre_freq[lane] = 0;
    int used = 0;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      used += v[r] != 0;
      v[r] = v[r] ? (v[r] << 9 | (16 * lane + r)) : uint32_t(NONE);
    }
    const int n = __reduce_add_sync(FULL, used);
    sort512(v);
#pragma unroll
    for (int r = 0; r < 16; ++r) s.ll.key[16 * lane + r] = v[r];
    __syncwarp();
    code_lengths<14>(s.ll, NUM_LL, n, s.ll_len);
    ensure_complete(s.ll_len, NUM_LL);
    canonical(s.ll, s.ll_len, NUM_LL, [&](int i, uint32_t code, int l) {
      ll_tab[b * NUM_LL + i] = static_cast<int32_t>(code | uint32_t(l) << 16);
    });
  }
  // the histogram's two warps meet; the litlen warp writes the header
  asm volatile("bar.sync %0, 64;" ::"r"(1 + (threadIdx.x >> 6)) : "memory");
  if ((threadIdx.x >> 5) & 1) return;

  // HLIT and HDIST trimmed; the lengths they cover
  int last_ll = 0, last_of = -1;
  for (int base = 0; base < NUM_LL; base += 32) {
    const unsigned bal = __ballot_sync(FULL, s.ll_len[base + lane] != 0);
    if (bal) last_ll = base + 31 - __clz(bal);
  }
  {
    const unsigned bal =
        __ballot_sync(FULL, lane < NUM_OF && s.of_len[lane] != 0);
    if (bal) last_of = 31 - __clz(bal);
  }
  const int num_ll = max(257, last_ll + 1), num_of = max(1, last_of + 1);
  const int total = num_ll + num_of;
  for (int i = lane; i < total; i += 32)
    s.all_len[i] = i < num_ll ? s.ll_len[i] : s.of_len[i - num_ll];
  __syncwarp();

  // runs of equal lengths: their starts by ballot
  int nruns = 0;
  for (int base = 0; base < total; base += 32) {
    const int i = base + lane;
    const bool start =
        i < total && (i == 0 || s.all_len[i] != s.all_len[i - 1]);
    const unsigned bal = __ballot_sync(FULL, start);
    if (start) s.run_start[nruns + __popc(bal & lanes_below())] = i;
    nruns += __popc(bal);
  }
  if (lane == 0) s.run_start[nruns] = static_cast<uint16_t>(total);
  __syncwarp();
  // each run's precode symbols in closed form, placed by a warp scan;
  // the precode histogram by shared atomics
  int nsyms = 0;
  for (int base = 0; base < nruns; base += 32) {
    const int r = base + lane;
    int v = 0, len = 0, cnt = 0;      // the run's length value and size
    if (r < nruns) {
      v = s.all_len[s.run_start[r]];
      len = s.run_start[r + 1] - s.run_start[r];
      cnt = run_count(v, len);
    }
    const int incl = warp_incl_scan(cnt);
    if (r < nruns) {
      const int at = nsyms + incl - cnt;
      int count[4] = {0, 0, 0, 0};         // v (or 0), 16, 17, 18
      run_symbols(v, len, [&](int k, int sym, int ev) {
        s.rle_sym[at + k] = static_cast<uint8_t>(sym);
        s.rle_ev[at + k] = static_cast<uint8_t>(ev);
        ++count[sym < 16 ? 0 : sym - 15];
      });
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (count[q])
          atomicAdd(&s.pre_freq[q ? 15 + q : v], uint32_t(count[q]));
    }
    nsyms += __shfl_sync(FULL, incl, 31);
  }
  __syncwarp();

  // the precode, limited to 7 bits
  {
    const uint32_t f = lane < NUM_PRE ? s.pre_freq[lane] : 0u;
    const int n = __popc(__ballot_sync(FULL, f != 0));
    s.small.key[lane] = sort32(f ? (f << 9 | lane) : uint32_t(NONE));
    __syncwarp();
    code_lengths<7>(s.small, NUM_PRE, n, s.pre_len);
  }
  ensure_complete(s.pre_len, NUM_PRE);
  canonical(s.small, s.pre_len, NUM_PRE,
            [&](int i, uint32_t code, int) { s.pre_code[i] = code; });
  const unsigned sent = __ballot_sync(
      FULL, lane < NUM_PRE && s.pre_len[kPerm[lane < NUM_PRE ? lane : 0]]);
  const int nexp = max(4, 32 - __clz(sent));

  // the header: each field's bit offset by a warp scan, ORed in
  if (lane == 0)
    put_bits(s.hdr, 0,
             (finals[b] ? 1u : 0u) | 4u | uint32_t(num_ll - 257) << 3 |
                 uint32_t(num_of - 1) << 8 | uint32_t(nexp - 4) << 13,
             17);
  if (lane < nexp) put_bits(s.hdr, 17 + 3 * lane, s.pre_len[kPerm[lane]], 3);
  int bit = 17 + 3 * nexp;
  for (int base = 0; base < nsyms; base += 32) {
    const int j = base + lane;
    uint32_t value = 0;
    int width = 0;
    if (j < nsyms) {
      const int sym = s.rle_sym[j], l = s.pre_len[sym];
      value = s.pre_code[sym] | uint32_t(s.rle_ev[j]) << l;
      width = l + extra_bits(sym);
    }
    const int incl = warp_incl_scan(width);
    if (width) put_bits(s.hdr, bit + incl - width, value, width);
    bit += __shfl_sync(FULL, incl, 31);
  }
  __syncwarp();
  uint32_t* out =
      reinterpret_cast<uint32_t*>(hdr_out + static_cast<int64_t>(b) * HDR_CAP);
  for (int i = lane; i < HDR_WORDS; i += 32) out[i] = s.hdr[i];
  if (lane == 0) hdr_bits[b] = bit;
}

}  // namespace

// Plain C entry point (bound with ctypes). ll_hist (n, 288) and of_hist
// (n, 30) uint16 counts, finals (n,) uint8 (or bool); ll_tab (n, 288) and
// of_tab (n, 30) int32 entries code | len << 16, hdr (n, 512) uint8
// (4-byte aligned) and hdr_bits (n,) int32, every element of which the
// kernel writes. Launches on `stream` (HISTS histograms a thread block)
// and returns the launch's CUDA error as an int (0 on success). No
// synchronisation.
extern "C" int ldrsx_dyn_tables(const void* ll_hist, const void* of_hist,
                                const void* finals, int n, void* ll_tab,
                                void* of_tab, void* hdr, void* hdr_bits,
                                void* stream) {
  if (n <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(hdr) & 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = static_cast<int>(HISTS * sizeof(Hist));
  static bool raised[64] = {};             // the attribute, once a device
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (device >= 64 || !raised[device]) {
    rc = cudaFuncSetAttribute(dyn_tables_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (device < 64) raised[device] = true;
  }
  dyn_tables_kernel<<<(n + HISTS - 1) / HISTS, 32 * WARPS, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(ll_hist),
      static_cast<const uint16_t*>(of_hist),
      static_cast<const uint8_t*>(finals), n, static_cast<int32_t*>(ll_tab),
      static_cast<int32_t*>(of_tab), static_cast<uint8_t*>(hdr),
      static_cast<int32_t*>(hdr_bits));
  return static_cast<int>(cudaGetLastError());
}
