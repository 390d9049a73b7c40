// Small-batch DEFLATE decoder on NVIDIA Hopper (sm_90a): whole raw-DEFLATE
// streams (BTYPE 00, 01 and 10) -> decoded bytes, one stream per block of
// one warp.
//
// Replaces libdeflate_rsx_tpu/ops/pallas/inflate_v2.py::_kernel. It gives
// what that kernel gives: the decoded bytes, the cause bits in the flag
// word (out[OUT_WORDS-2]) and the count or -1 (out[OUT_WORDS-1]); bits
// read past the row wrap to its start, as the TPU kernel's word index
// does. The plain PyTorch version of this kernel is ops/inflate_v2.py's
// inflate_v2_plain; its docstring lists the rules. What the TPU forced
// and this kernel drops: the stream DMA'd into scalar memory, the output
// packed into int32 words by read-modify-write, the fori/while/cond
// nesting, and tables filled symbol by symbol.
//
// What bounds it on this card: not bytes (its byte bound is ~1/15,000 of
// its time) but latency. Decoding is serial within a stream: each
// symbol's table lookup waits on the bits the one before it consumed,
// and a batch of a few streams gives a few SMs one warp each, so every
// dependent instruction's latency shows. What the design does about it
// (stream_decode.cuh holds the parts shared with inflate_static.cu):
// - Everything the decode loop touches is in shared memory or registers:
//   the 64 KiB input row, staged by one TMA bulk copy; the output row,
//   built there and written back whole in 16-byte stores (so the caller
//   need not zero it); the tables. A literal's dependent chain is one
//   shared table load, a length mask and a 64-bit shift of the bit
//   buffer; literals are tested on the root entry, first.
// - One table lookup per symbol: pre-decoded entries (litlen: 10-bit root
//   and 5-bit subtables, literal / length base and extra bits / end of
//   block; distance: 8-bit root and 7-bit subtables, base and extra bits;
//   precode: flat 7 bits), room for a subtable under every root slot a
//   valid code can split, so no symbol needs a canonical fallback. A slot
//   no valid code fills (an incomplete code, litlen 286/287, distance
//   30/31) holds 0, which the loop judges as the TPU kernel judges it.
// - Tables built by the warp: canonical codes by ballots and scans, every
//   slot filled by a canonical decode of its own bits (as pass 1 does),
//   with no barrier per symbol. A code that is bad already is not
//   filled: only the TPU fill's subtable overflow (BAD_TABLE) is worked
//   out, in closed form, as the plain version does.
// - LZ and stored copies split across the 32 lanes inside shared memory
//   (one __syncwarp per match); literals are stored by every lane at once
//   (the same byte to the same place: one store, no branch).
// Shared memory: 192,016 bytes a block (one block per SM), set with
// cudaFuncSetAttribute by the entry point.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stream_decode.cuh"

namespace {

using sd::FULL;
using sd::IN_WORDS;
using sd::OUT_WORDS;
constexpr int IN_MASK = sd::IN_BYTES - 1;
constexpr int OUT_CAP = (OUT_WORDS - 2) * 4;
// the TPU kernel's table sizes, against which its subtable overflow is judged
constexpr int JAX_LL_WORDS = 4096, JAX_OF_WORDS = 2048;
constexpr int LL_ROOT = 10, LL_SUB = 5, LL_MAXSUB = 288;
constexpr int OF_ROOT = 8, OF_SUB = 7, OF_MAXSUB = 30;
constexpr int PRE_ROOT = 7;
constexpr int LENS_WORDS = 320;
// entry: bits 0-3 code length (0: no valid code here), 4-5 type, 8-12
// extra bits, 16-31 literal, length base, distance base or subtable start
constexpr uint32_t E_LIT = 0, E_LEN = 1, E_EOB = 2, E_PTR = 3;
enum Kind : int { K_PRE, K_LL, K_OF };

// cause bits of the flag word (ops/inflate_v2.py)
constexpr int BAD_BTYPE = 1, BAD_STORED_LEN = 2, BAD_STORED_END = 4,
              BAD_COUNTS = 8, BAD_PRE_END = 16, BAD_OVERSUB = 32,
              BAD_TABLE = 64, BAD_PRE_CODE = 128, BAD_REPEAT = 256,
              BAD_LENS_COUNT = 512, BAD_LENS_END = 1024, BAD_NO_EOB = 2048,
              BAD_LL_CODE = 4096, BAD_OF_CODE = 8192, BAD_DIST = 16384,
              BAD_OUT_CAP = 32768, BAD_MATCH_END = 65536,
              BAD_BLOCK_END = 131072, BAD_STREAM_END = 262144;

__constant__ uint8_t kOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                   11, 4, 12, 3, 13, 2, 14, 1, 15};

struct Code {
  int32_t lim[16];  // MSB-aligned 15-bit limit per code length (row 0 unused)
  int32_t fb[16];   // base index - first code per code length
};

struct alignas(16) Smem {
  uint32_t in[IN_WORDS];
  uint32_t out[OUT_WORDS];
  uint32_t ll[(1 << LL_ROOT) + (LL_MAXSUB << LL_SUB)];
  uint32_t of[(1 << OF_ROOT) + (OF_MAXSUB << OF_SUB)];
  uint32_t pre[1 << PRE_ROOT];
  int32_t lens[LENS_WORDS];   // litlen 0..287, distance 288..317
  Code c;                     // the code being built
  uint16_t perm[288];
  uint16_t sub_prefix[LL_MAXSUB];
  uint64_t bar;
};

__device__ __forceinline__ int rev15(int x) {
  return static_cast<int>(__brev(static_cast<unsigned>(x) & 0xFFFFu) >> 17);
}

__device__ __forceinline__ uint32_t mask(uint32_t n) { return (1u << n) - 1u; }

// Canonical tables from code lengths, built by the warp: lane l (1..15)
// counts the codes of length l by ballots, warp scans give lim and the
// first index of each length, and each symbol's place in perm is that
// index plus its rank among the symbols of its length. Returns whether
// the code is over-subscribed (every lane).
__device__ __noinline__ bool build(const int32_t* lens, int nsym, int nperm,
                                   Code& c, uint16_t* perm, int lane) {
  int cnt = 0;
  for (int base = 0; base < nsym; base += 32) {
    const int ln = base + lane < nsym ? lens[base + lane] : 0;
#pragma unroll
    for (int l = 1; l < 16; ++l) {
      const int n = __popc(__ballot_sync(FULL, ln == l));
      if (lane == l) cnt += n;
    }
  }
  const bool coded = lane >= 1 && lane < 16;
  int lim = coded ? cnt << (15 - lane) : 0;
  int idx = coded ? cnt : 0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(FULL, lim, o);
    const int b = __shfl_up_sync(FULL, idx, o);
    if (lane >= o) {
      lim += a;
      idx += b;
    }
  }
  int first = idx - (coded ? cnt : 0);
  const int lim_before = lim - (coded ? cnt << (15 - lane) : 0);
  if (coded) {
    c.lim[lane] = lim;
    c.fb[lane] = first - (lim_before >> (15 - lane));
  } else if (lane == 0) {
    c.lim[0] = 1 << 29;
    c.fb[0] = 0;
  }
  const int kraft = __shfl_sync(FULL, lim, 15);
  for (int i = lane; i < nperm; i += 32) perm[i] = 0;
  __syncwarp();
  for (int base = 0; base < nsym; base += 32) {
    const int s = base + lane;
    const int ln = s < nsym ? lens[s] : 0;
    const unsigned same = __match_any_sync(FULL, ln);
    const int at = __shfl_sync(FULL, first, ln) +
                   __popc(same & ((1u << lane) - 1u));
    if (ln > 0) perm[at < nperm ? at : nperm - 1] = static_cast<uint16_t>(s);
#pragma unroll
    for (int l = 1; l < 16; ++l) {
      const int n = __popc(__ballot_sync(FULL, ln == l));
      if (lane == l) first += n;
    }
  }
  __syncwarp();
  return kraft > (1 << 15);
}

// One canonical decode from the low 15 peeked bits: the symbol, its code
// length in *lc, and *bad when no code of length <= 15 matches.
__device__ __forceinline__ int decode(const Code& c, const uint16_t* perm,
                                      int nperm, uint32_t pk, int* lc,
                                      bool* bad) {
  const int v = static_cast<int>(__brev(pk & 0x7FFFu) >> 17);
  int length = 1;
#pragma unroll
  for (int l = 1; l < 16; ++l) length += v >= c.lim[l];
  *bad = length >= 16;
  const int n = length > 15 ? 15 : length;
  int off = (v >> (15 - n)) + c.fb[n];
  off = off < 0 ? 0 : (off > nperm - 1 ? nperm - 1 : off);
  *lc = n;
  return perm[off];
}

__device__ __forceinline__ void len_extra(int sym, int* eb, int* base) {
  const int ls = sym - 257;
  *eb = ls < 8 ? 0 : (ls == 28 ? 0 : (ls >> 2) - 1);
  *base = ls < 8 ? ls + 3 : (ls == 28 ? 258 : ((4 + (ls & 3)) << *eb) + 3);
}

__device__ __forceinline__ void dist_extra(int dsym, int* deb, int* dbase) {
  *deb = (dsym >> 1) - 1 > 0 ? (dsym >> 1) - 1 : 0;
  *dbase = dsym < 4 ? dsym + 1 : ((2 + (dsym & 1)) << *deb) + 1;
}

// Whether the TPU kernel's entry for symbol sym is valid: litlen 286/287
// and distance 30/31 have none.
__device__ __forceinline__ bool has_entry(int kind, int sym) {
  return kind == K_PRE || (kind == K_OF ? sym <= 29 : sym <= 285);
}

// The pre-decoded entry of symbol sym with a code of len bits, or 0.
__device__ __forceinline__ uint32_t make_entry(int kind, int sym, int len) {
  if (!has_entry(kind, sym)) return 0u;
  if (kind == K_PRE) return (static_cast<uint32_t>(sym) << 16) | len;
  if (kind == K_OF) {
    int deb, dbase;
    dist_extra(sym, &deb, &dbase);
    return (static_cast<uint32_t>(dbase) << 16) | (deb << 8) | len;
  }
  if (sym < 256)
    return (static_cast<uint32_t>(sym) << 16) | (E_LIT << 4) | len;
  if (sym == 256) return (E_EOB << 4) | len;
  int eb, base;
  len_extra(sym, &eb, &base);
  return (static_cast<uint32_t>(base) << 16) | (eb << 8) | (E_LEN << 4) | len;
}

// Fill a table from a valid canonical code, every slot by a canonical
// decode of its bits, so the two agree slot for slot. Lanes take runs of
// root slots; a root slot whose code is longer than `root` bits gets a
// subtable of `sub` bits, numbered in slot order by a warp scan.
__device__ __noinline__ void fill(uint32_t* tab, int root, int sub, int maxsub,
                                  const Code& c, const uint16_t* perm,
                                  int nperm, int kind, uint16_t* sub_prefix,
                                  int lane) {
  const int per = (1 << root) / 32;
  int nlong = 0;
  for (int k = 0; k < per; ++k) {
    int len;
    bool bad;
    decode(c, perm, nperm, lane * per + k, &len, &bad);
    nlong += !bad && len > root;
  }
  int incl = nlong;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  const int total = __shfl_sync(FULL, incl, 31);
  int next = incl - nlong;
  for (int k = 0; k < per; ++k) {
    const int idx = lane * per + k;
    int len;
    bool bad;
    const int sym = decode(c, perm, nperm, idx, &len, &bad);
    uint32_t e = 0u;
    if (!bad && len <= root) {
      e = make_entry(kind, sym, len);
    } else if (!bad && next < maxsub) {
      e = (static_cast<uint32_t>((1 << root) + (next << sub)) << 16) |
          (E_PTR << 4);
      sub_prefix[next++] = static_cast<uint16_t>(idx);
    }
    tab[idx] = e;
  }
  __syncwarp();
  const int nsub = total < maxsub ? total : maxsub;
  for (int t = lane; t < (nsub << sub); t += 32) {
    const uint32_t pk = sub_prefix[t >> sub] |
                        ((t & ((1 << sub) - 1)) << root);
    int len;
    bool bad;
    const int sym = decode(c, perm, nperm, pk, &len, &bad);
    tab[(1 << root) + t] = bad ? 0u : make_entry(kind, sym, len);
  }
  __syncwarp();
}

// For a stream that is bad already, the TPU kernel fills a table without
// subtables, yet allocates one of 2**bits entries for each code longer
// than `root`, with bits read from its root slot as the fill finds it:
// the length of the last shorter code (of lower symbol) whose replicas
// cover the slot (0 for one with no entry), else the longest excess over
// `root` of the codes under that slot; clipped to 1..15-root. Returns
// whether the allocations pass tab_words (BAD_TABLE). Codes are numbered
// canonically in symbol order and wrap, as the TPU fill's do.
// `scratch` holds nsym + 2**root words (the litlen table's room, which a
// bad stream no longer reads).
__device__ __noinline__ bool overflows(const int32_t* lens, int nsym,
                                       int root, int tab_words, int kind,
                                       int32_t* scratch, int lane) {
  const int root_size = 1 << root;
  int32_t* rev = scratch;
  int32_t* submax = scratch + nsym;
  for (int k = lane; k < root_size; k += 32) submax[k] = 0;
  __syncwarp();
  if (lane == 0) {
    int cnt[16], nxt[16];
    for (int l = 0; l < 16; ++l) cnt[l] = 0;
    for (int i = 0; i < nsym; ++i) cnt[lens[i]]++;
    cnt[0] = 0;
    int code = 0;
    for (int l = 1; l < 16; ++l) nxt[l] = code = (code + cnt[l - 1]) << 1;
    for (int i = 0; i < nsym; ++i) {
      const int l = lens[i];
      rev[i] = l > 0 ? rev15(nxt[l]++ << (15 - l)) : 0;
      const int p = rev[i] & (root_size - 1);
      if (l > root && submax[p] < l - root) submax[p] = l - root;
    }
  }
  __syncwarp();
  int total = 0;
  for (int i = lane; i < nsym; i += 32) {
    const int l = lens[i];
    if (l <= root) continue;
    const int p = rev[i] & (root_size - 1);
    int cur = submax[p];
    for (int j = i - 1; j >= 0; --j) {
      const int lj = lens[j];
      if (lj > 0 && lj <= root && (p & ((1 << lj) - 1)) == rev[j]) {
        cur = has_entry(kind, j) ? lj : 0;
        break;
      }
    }
    const int bits = cur < 1 ? 1 : (cur > 15 - root ? 15 - root : cur);
    total += 1 << bits;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(FULL, total, o);
  __syncwarp();
  return root_size + total > tab_words;
}

// The body's tables from lens (litlen 0..287, distance 288..317).
__device__ int build_body(Smem& s, int bad, int lane) {
  int32_t* scratch = reinterpret_cast<int32_t*>(s.ll);
  if (build(s.lens, 288, 288, s.c, s.perm, lane)) bad |= BAD_OVERSUB;
  if (bad != 0) {
    if (overflows(s.lens, 288, LL_ROOT, JAX_LL_WORDS, K_LL, scratch, lane))
      bad |= BAD_TABLE;
  } else {
    fill(s.ll, LL_ROOT, LL_SUB, LL_MAXSUB, s.c, s.perm, 288, K_LL,
         s.sub_prefix, lane);
  }
  if (build(s.lens + 288, 30, 32, s.c, s.perm, lane)) bad |= BAD_OVERSUB;
  if (bad != 0) {
    if (overflows(s.lens + 288, 30, OF_ROOT, JAX_OF_WORDS, K_OF, scratch,
                  lane))
      bad |= BAD_TABLE;
  } else {
    fill(s.of, OF_ROOT, OF_SUB, OF_MAXSUB, s.c, s.perm, 32, K_OF,
         s.sub_prefix, lane);
  }
  return bad;
}

// A table's entry for the peeked bits pk, through its subtable if the
// root entry points to one; `tab` is the table's shared-memory address.
__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t lookup(uint32_t tab, int root, int sub,
                                           uint32_t pk) {
  uint32_t e = lds(tab + 4u * (pk & mask(root)));
  if (((e >> 4) & 3u) == E_PTR)
    e = lds(tab + 4u * ((e >> 16) + ((pk >> root) & mask(sub))));
  return e;
}

using Reader = sd::Reader<true>;

__device__ int parse_dynamic(Smem& s, Reader& r, uint32_t in_bits, int bad,
                             int lane) {
  const uint32_t pk = r.peek();
  const int num_ll = (pk & 31) + 257;
  const int num_of = ((pk >> 5) & 31) + 1;
  const int ne = ((pk >> 10) & 15) + 4;
  r.consume(14);
  if (num_ll > 286 || num_of > 30) bad |= BAD_COUNTS;
  if (lane < 19) s.lens[lane] = 0;
  __syncwarp();
  for (int k = 0; k < ne; ++k) {
    const int v = r.peek() & 7;
    if (lane == 0) s.lens[kOrder[k]] = v;
    r.consume(3);
  }
  __syncwarp();
  if (r.abit > in_bits) bad |= BAD_PRE_END;
  if (build(s.lens, 19, 19, s.c, s.perm, lane)) bad |= BAD_OVERSUB;
  if (bad == 0)
    fill(s.pre, PRE_ROOT, 0, 0, s.c, s.perm, 19, K_PRE, s.sub_prefix, lane);

  // code lengths, run-length coded through the precode; every lane
  // writes a literal length (the same value to the same place), the
  // lanes split a repeat, and the previous length is kept in a register
  const int tot = num_ll + num_of;
  int i = 0, prev = 0;
  while (i < tot && bad == 0 && r.abit <= in_bits) {
    const uint32_t pk2 = r.peek();
    const uint32_t e = s.pre[pk2 & mask(PRE_ROOT)];
    const int l = e & 15;
    if (l == 0) bad |= BAD_PRE_CODE;
    const int sym = e >> 16;
    if (sym <= 15) {
      r.consume(l);
      s.lens[i] = sym;
      prev = sym;
      ++i;
      continue;
    }
    // 16: repeat the previous length 3-6 | 17: zeros 3-10 | 18: zeros 11-138
    const int ebits = sym == 16 ? 2 : (sym == 17 ? 3 : 7);
    const int rep = (sym == 18 ? 11 : 3) + ((pk2 >> l) & mask(ebits));
    r.consume(l + ebits);
    const int val = sym == 16 ? prev : 0;
    if ((sym == 16 && i == 0) || i + rep > tot) bad |= BAD_REPEAT;
    if (bad == 0)
      for (int k = lane; k < rep; k += 32) s.lens[i + k] = val;
    prev = val;
    i += rep;
  }
  __syncwarp();
  if (i != tot) bad |= BAD_LENS_COUNT;
  if (r.abit > in_bits) bad |= BAD_LENS_END;
  // distance lengths to 288.., litlen lengths zeroed from num_ll to 288
  if (lane == 0) {
    for (int k = 29; k >= 0; --k)
      s.lens[288 + k] = k < num_of ? s.lens[num_ll + k] : 0;
    for (int k = num_ll; k < 288; ++k) s.lens[k] = 0;
  }
  __syncwarp();
  if (s.lens[256] == 0) bad |= BAD_NO_EOB;
  return build_body(s, bad, lane);
}

__device__ int load_static(Smem& s, int bad, int lane) {
  for (int k = lane; k < 318; k += 32)
    s.lens[k] = k >= 288 ? 5 : (k < 144 ? 8 : (k < 256 ? 9 : (k < 280 ? 7 : 8)));
  __syncwarp();
  return build_body(s, bad, lane);
}

extern __shared__ __align__(16) unsigned char smem_raw[];

__global__ void __launch_bounds__(32, 1)
inflate_v2_kernel(const int32_t* __restrict__ lens,
                  const int32_t* __restrict__ words,
                  int32_t* __restrict__ out) {
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int sid = blockIdx.x;
  const int lane = threadIdx.x;
  const int in_len = lens[sid];
  const uint32_t in_bits = 8u * in_len;
  sd::stage_row(s.in, s.out, words + static_cast<int64_t>(sid) * IN_WORDS,
                &s.bar, lane);
  for (int k = lane; k < LENS_WORDS; k += 32) s.lens[k] = 0;
  __syncwarp();

  uint8_t* ob = reinterpret_cast<uint8_t*>(s.out);
  const uint8_t* ib = reinterpret_cast<const uint8_t*>(s.in);
  Reader r;
  r.in = s.in;
  r.seek(0);
  int bad = 0, op = 0, done = 0;
  while (done == 0 && bad == 0 && r.abit + 3 <= in_bits) {
    const int hdr = r.peek() & 7;
    r.consume(3);
    const int bfinal = hdr & 1, btype = hdr >> 1;
    if (btype == 0) {                                 // stored block
      r.consume((8 - (r.abit & 7)) & 7);
      const uint32_t pk = r.peek();
      const int ln = pk & 0xFFFF, nlen = pk >> 16;
      if (ln != (~nlen & 0xFFFF)) bad |= BAD_STORED_LEN;
      r.consume(32);
      const int start = r.abit >> 3;
      if (start + ln > in_len || op + ln > OUT_CAP) bad |= BAD_STORED_END;
      const int n = bad != 0 ? 0 : ln;
      for (int k = lane; k < n; k += 32) ob[op + k] = ib[(start + k) & IN_MASK];
      r.seek(r.abit + 8 * n);
      op += n;
    } else if (btype == 3) {
      bad |= BAD_BTYPE | BAD_BLOCK_END;
    } else {
      bad = btype == 2 ? parse_dynamic(s, r, in_bits, bad, lane)
                       : load_static(s, bad, lane);
      const uint32_t ll = sd::smem_addr(s.ll), of = sd::smem_addr(s.of);
      bool eob = false;
      while (bad == 0 && r.abit <= in_bits) {         // block body
        const uint32_t pk = r.peek();
        uint32_t e = lds(ll + 4u * (pk & mask(LL_ROOT)));
        if ((e & 0x3Fu) - 1u < 15u && op < OUT_CAP) {  // a literal that fits
          r.consume(e & 15);
          ob[op++] = static_cast<uint8_t>(e >> 16);
          continue;
        }
        if (((e >> 4) & 3) == E_PTR)
          e = lds(ll + 4u * ((e >> 16) + ((pk >> LL_ROOT) & mask(LL_SUB))));
        const uint32_t l = e & 15, ty = (e >> 4) & 3;
        if (ty == E_EOB) {
          r.consume(l);
          eob = true;
          break;
        }
        if (ty == E_LIT) {   // in a subtable, past OUT_CAP, or no code here
          if (l == 0) bad |= BAD_LL_CODE;
          if (op >= OUT_CAP) bad |= BAD_OUT_CAP;
          r.consume(l);
          ob[op < OUT_CAP - 1 ? op : OUT_CAP - 1] = static_cast<uint8_t>(e >> 16);
          ++op;
          continue;
        }
        const uint32_t eb = (e >> 8) & 31;
        const int length = static_cast<int>((e >> 16) + ((pk >> l) & mask(eb)));
        r.consume(l + eb);
        const uint32_t pk2 = r.peek();
        const uint32_t d = lookup(of, OF_ROOT, OF_SUB, pk2);
        const uint32_t dl = d & 15, deb = (d >> 8) & 31;
        if (dl == 0) bad |= BAD_OF_CODE;
        const int dist = static_cast<int>((d >> 16) + ((pk2 >> dl) & mask(deb)));
        r.consume(dl + deb);
        if (dist > op) bad |= BAD_DIST;
        if (op + length > OUT_CAP - 4) bad |= BAD_OUT_CAP;
        if (r.abit > in_bits) bad |= BAD_MATCH_END;
        if (bad == 0) {
          __syncwarp();                  // every byte before op is visible
          sd::lz_copy(ob, op, dist, length, lane);
          op += length;
        }
      }
      if (!eob) bad |= BAD_BLOCK_END;
    }
    done = bad != 0 ? 1 : bfinal;
  }
  if (done == 0) bad |= BAD_STREAM_END;
  __syncwarp();
  if (lane == 0) {
    s.out[OUT_WORDS - 2] = bad;
    s.out[OUT_WORDS - 1] = bad != 0 ? -1 : op;
  }
  sd::write_back(out + static_cast<int64_t>(sid) * OUT_WORDS, s.out, lane);
}

}  // namespace

// Plain C entry point (bound with ctypes). lens (nstreams,) and words
// (nstreams, 16384) int32, words 16-byte aligned; out (nstreams, 16512)
// int32, every word of which the kernel writes. Launches on `stream`
// and returns the first CUDA error as an int (0 on success): that of
// raising the kernel's shared-memory limit, of a misaligned `words`
// (cudaErrorInvalidValue), or of the launch. No synchronisation.
extern "C" int ldrsx_inflate_v2(const void* lens, const void* words,
                                int nstreams, void* out, void* stream) {
  if (nstreams <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(words) & 15)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = static_cast<int>(sizeof(Smem));
  const cudaError_t rc = cudaFuncSetAttribute(
      inflate_v2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  inflate_v2_kernel<<<nstreams, 32, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lens), static_cast<const int32_t*>(words),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
