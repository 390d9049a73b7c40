// Pass 1 of the two-pass DEFLATE decoder on NVIDIA Hopper (sm_90a):
// raw-DEFLATE streams -> compact LZ tokens in the ops/tokens.py format.
//
// Replaces libdeflate_rsx_tpu/ops/pallas/inflate_tokens.py::_make_kernel.
// It computes what that kernel computes, not its schedule: the TPU kernel
// runs 128 streams per grid cell in lockstep across vector lanes, with a
// lane mode machine, quorum-batched header and table phases, overlapped
// 512-byte DMA chunks and one-hot gathers, because TPU lanes can neither
// branch nor gather on their own. Verdicts follow the TPU kernel rule for
// rule, step for step (see the Python module ops/inflate_tokens.py, whose
// pass1_plain is the plain version of this function and whose docstring
// sets out the segment route below).
//
// What bounds it on this card: not bytes (its byte bound is ~1/1000 of
// its time) but latency. Huffman decoding is serial within a stream: each
// symbol's table lookup waits on the bits the one before it consumed, and
// a warp alone on its scheduler pays every dependent instruction's full
// latency, so a launch lasts as long as its longest serial run; 17
// streams of 1 MiB decoded whole would fill 17 of 132 SMs. What the
// design does about it:
// - Segments. Blocks that follow a sync point (an empty non-final stored
//   block, 00 00 FF FF, left by Z_SYNC_FLUSH, Z_FULL_FLUSH and the L6
//   encoder's SYNC join) decode independently into tokens; only outpos,
//   the token count and the bit position carry over, and all three are
//   patched afterwards. So every candidate start found by the finder is
//   decoded by a warp of its own (measure_kernel; a stream's first
//   segment into its row, the others into scratch), one thread per stream
//   follows the chain of true segments and checks what a segment could
//   not judge alone (chain_kernel), the later segments of each finished
//   stream are copied into their place (emit_kernel; one whose tokens
//   passed its scratch room is decoded again there), and any stream the
//   chain cannot finish is decoded serially from bit 0 (rerun_kernel),
//   which gives the serial verdict. The longest segment now sets the
//   time: 64 KiB blocks instead of 1 MiB streams.
// - Short steps. The body loop takes a literal, then a match, on a path
//   of its own before the general symbol code; positions are 32-bit; a
//   stored block's bytes are written by the 32 lanes at once, in the
//   closed form of its per-byte steps.
// - One table lookup per symbol. Each code gets a decode table in shared
//   memory with pre-decoded entries (litlen: 10-bit root and 5-bit
//   subtables, literal / length base and extra bits / end of block;
//   distance: 8-bit root and 7-bit subtables; precode: flat 7 bits). The
//   canonical tables (lim/fb per length, the symbol permutation) stay
//   beside them: a slot that no valid code fills (an incomplete code, a
//   symbol the format forbids, or a subtable past the table's room) is
//   decoded the canonical way, so a bad stream consumes exactly the bits
//   the reference consumes before it is judged BAD.
// - The bit reader takes aligned 32-bit words (read through the L1
//   cache) and reads 32 bits at a time with __funnelshift_r; bits past
//   the stream's end read as 0. (Staging the input in a shared-memory
//   ring fed by cp.async.bulk with mbarriers measured slower on the main
//   path's batches, and was dropped: PERF.md.)
// A segment's warp runs its control flow in all 32 lanes on the same
// data: lanes split the table fills, lane 0 writes tokens and tables'
// serial parts, and __syncwarp orders shared memory between them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum : int {
  BLKSTART = 0, PRELEN = 1, LENS = 2, BODY = 4, STORED = 5, DONE = 6, BAD = 7,
  SYNC = 8
};
constexpr int RES = 5;   // segment result: mode, outlen, bits, ntok, excess

constexpr int32_t TOK_LIT = 1 << 29;
constexpr int32_t TOK_MATCH = 2 << 29;
constexpr unsigned FULL = 0xFFFFFFFFu;

// fast tables: root bits, subtable bits, subtables at most
constexpr int LL_ROOT = 10, LL_SUB = 5, LL_MAXSUB = 64;
constexpr int OF_ROOT = 8, OF_SUB = 7, OF_MAXSUB = 8;
constexpr int PRE_ROOT = 7;
// entry: bits 0-3 code length (0: no valid code here), 4-5 type, 8-12
// extra bits, 16-31 literal, length base, distance base or subtable start;
// 0 is the invalid entry
constexpr int E_LIT = 0, E_LEN = 1, E_EOB = 2, E_PTR = 3;
enum Kind : int { K_PRE, K_LL, K_OF };

__constant__ uint8_t kOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                   11, 4, 12, 3, 13, 2, 14, 1, 15};

struct Code {
  int32_t lim[16];  // MSB-aligned 15-bit limit per code length (row 0 unused)
  int32_t fb[16];   // base index - first code per code length
};

struct Tables {     // one per segment's warp, in shared memory
  uint32_t ll[(1 << LL_ROOT) + (LL_MAXSUB << LL_SUB)];
  uint32_t of[(1 << OF_ROOT) + (OF_MAXSUB << OF_SUB)];
  uint32_t pre[1 << PRE_ROOT];
  uint16_t sub_prefix[LL_MAXSUB];
  Code llc, ofc, prec;
  uint16_t ll_perm[288];
  uint16_t of_perm[32];
  uint16_t pre_perm[20];
  uint8_t ll_lens[288];
  uint8_t of_lens[32];
  uint8_t pre_lens[20];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The stream as aligned 32-bit words. `wp` is the word holding the
// stream's first byte, `lead` the bytes before it in that word, so stream
// bit b is bit abit = 8 * lead + b from wp; positions are 32-bit (streams
// are shorter than 2^28 bytes).
struct Reader {
  const uint32_t* wp;
  int lead;
  uint32_t end;      // the stream's end in bytes from wp
  uint32_t abit;     // bits consumed, from wp
  uint32_t nw;       // next word to load, from wp
  uint32_t w0, w1, w2;

  __device__ __forceinline__ uint32_t load(uint32_t w) const {
    const uint32_t b0 = w * 4;
    if (b0 + 4 <= end) return __ldg(wp + w);
    if (b0 >= end) return 0u;
    return __ldg(wp + w) & ((1u << (8 * (end - b0))) - 1u);
  }
  // from stream bit `bit`, in the stream at byte `first` of words (the
  // input rounded down to 4 bytes) of `len` bytes
  __device__ void init(const uint32_t* words, int64_t first, int len,
                       uint32_t bit) {
    wp = words + (first >> 2);
    lead = static_cast<int>(first & 3);
    end = lead + len;
    seek(bit);
  }
  // bits consumed from the stream's bit 0
  __device__ __forceinline__ uint32_t bitpos() const {
    return abit - 8 * lead;
  }
  // read on from stream bit `bit`
  __device__ void seek(uint32_t bit) {
    abit = 8 * lead + bit;
    const uint32_t w = abit >> 5;
    w0 = load(w);
    w1 = load(w + 1);
    w2 = load(w + 2);
    nw = w + 3;
  }
  // stream byte i from device memory (0 past the end)
  __device__ __forceinline__ uint32_t byte(uint32_t i) const {
    return lead + i < end
        ? __ldg(reinterpret_cast<const uint8_t*>(wp) + lead + i) : 0u;
  }
  // the 32 bits at abit (the funnel shift takes abit mod 32)
  __device__ __forceinline__ uint32_t peek() const {
    return __funnelshift_r(w0, w1, abit);
  }
  // n <= 32
  __device__ __forceinline__ void consume(uint32_t n) {
    const uint32_t nb = abit + n;
    if ((nb ^ abit) >= 32u) {  // into the next word
      w0 = w1;
      w1 = w2;
      w2 = load(nw++);
    }
    abit = nb;
  }
};

// Canonical tables from code lengths, built by the warp: lane l (1..15)
// counts the codes of length l by ballots, warp scans give lim (the sum of
// count_k << (15 - k) over k <= l) and the first index of each length,
// and each symbol's place in perm is that index plus its rank among the
// symbols of its length (__match_any_sync). Every lane gets whether the
// code is over-subscribed.
__device__ __noinline__ bool build(const uint8_t* lens, int nsym, int nperm, Code& c,
                      uint16_t* perm, int lane) {
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
  int first = idx - (coded ? cnt : 0);         // first perm index of length
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
// length clipped to 1..15 in *lc, and *bad when no code of length <= 15
// matches.
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

// The pre-decoded entry of symbol sym with a code of len bits, or 0 for a
// symbol that the canonical path must judge.
__device__ __forceinline__ uint32_t make_entry(int kind, int sym, int len) {
  if (kind == K_PRE) return (static_cast<uint32_t>(sym) << 16) | len;
  if (kind == K_OF) {
    if (sym > 29) return 0u;
    int deb, dbase;
    dist_extra(sym, &deb, &dbase);
    return (static_cast<uint32_t>(dbase) << 16) | (deb << 8) | len;
  }
  if (sym < 256)
    return (static_cast<uint32_t>(sym) << 16) | (E_LIT << 4) | len;
  if (sym == 256) return (E_EOB << 4) | len;
  if (sym > 285) return 0u;
  int eb, base;
  len_extra(sym, &eb, &base);
  return (static_cast<uint32_t>(base) << 16) | (eb << 8) | (E_LEN << 4) | len;
}

// Fill a fast table from the canonical code, every slot by a canonical
// decode of its bits, so the two agree slot for slot. Lanes take runs of
// root slots; a root slot whose code is longer than `root` bits gets a
// subtable of `sub` bits, numbered in slot order by a warp scan.
__device__ __noinline__ void fill(uint32_t* tab, int root, int sub, int maxsub,
                     const Code& c, const uint16_t* perm, int nperm, int kind,
                     uint16_t* sub_prefix, int lane) {
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

// A fast table's entry for the peeked bits pk, through its subtable if
// the root entry points to one; `tab` is the table's shared-memory address
// (a 32-bit address taken once, so the loop does not rebuild it).
__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t lookup(uint32_t tab, int root, int sub,
                                           uint32_t pk) {
  uint32_t e = lds(tab + 4u * (pk & ((1u << root) - 1u)));
  if (((e >> 4) & 3) == E_PTR)
    e = lds(tab + 4u * ((e >> 16) + ((pk >> root) & ((1u << sub) - 1u))));
  return e;
}

// The body's tables; the distance code has 30 symbols in a dynamic block
// and 32 in a static one (30 and 31 decode there, and are then BAD).
__device__ __noinline__ bool build_body(Tables& t, int n_of, int lane) {
  const bool o1 = build(t.ll_lens, 288, 288, t.llc, t.ll_perm, lane);
  const bool o2 = build(t.of_lens, n_of, 32, t.ofc, t.of_perm, lane);
  if (o1 || o2) return true;
  fill(t.ll, LL_ROOT, LL_SUB, LL_MAXSUB, t.llc, t.ll_perm, 288, K_LL,
       t.sub_prefix, lane);
  fill(t.of, OF_ROOT, OF_SUB, OF_MAXSUB, t.ofc, t.of_perm, 32, K_OF,
       t.sub_prefix, lane);
  return false;
}

__device__ __noinline__ void install_static(Tables& t, int lane) {
  for (int s = lane; s < 288; s += 32)
    t.ll_lens[s] = s < 144 ? 8 : (s < 256 ? 9 : (s < 280 ? 7 : 8));
  t.of_lens[lane] = 5;
  __syncwarp();
  build_body(t, 32, lane);
}

struct Result {
  int mode, outpos, ntok, excess;
  uint32_t bits;
};

// Decode one segment: the stream's bytes start..start+len of `words`,
// from bit `bit` as a block start, to DONE, BAD or (sync_stop) the end of
// an empty non-final stored block. strict: a match reaching before the
// segment's own output is BAD; otherwise its reach goes to excess. Tokens
// go to out[0..room); out[room] takes those past it (every lane stores
// the same token to the same place: one store, and no branch).
__device__ Result run(Tables& t, const uint32_t* words,
                      int64_t start, int len, uint32_t bit, bool strict,
                      bool sync_stop, int32_t* out, int room, int out_cap,
                      int lane) {
  Reader r;
  r.init(words, start, len, bit);
  const uint32_t inbits = 8u * len;
  const uint32_t lim = r.abit - bit + inbits;   // the stream's end in abit

  int mode = BLKSTART, final_blk = 0;
  int outpos = 0, ntok = 0, srem = 0, excess = 0;
  int nlit = 0, ndist = 0, hclen = 0, idx = 0, prev = -1, rep = 0,
      repval = 0;

  while (mode < DONE) {
    // ---- one step of the TPU kernel's schedule, for this segment alone
    bool sync_hit = false;
    if (mode == BLKSTART) {
      const uint32_t pk = r.peek();
      final_blk = pk & 1;
      const int btype = (pk >> 1) & 3;
      r.consume(3);
      if (btype == 0) {
        r.consume((8 - r.bitpos()) & 7);
        const uint32_t w = r.peek();
        const int slen = w & 0xFFFF, snlen = w >> 16;
        r.consume(32);
        srem = slen;
        if (slen != (snlen ^ 0xFFFF)) {
          mode = BAD;
        } else if (slen > 0) {
          mode = STORED;
        } else if (final_blk) {
          mode = DONE;
        } else {
          mode = BLKSTART;
          sync_hit = sync_stop;
        }
      } else if (btype == 1) {
        install_static(t, lane);
        mode = BODY;
      } else if (btype == 2) {
        nlit = 257 + ((pk >> 3) & 31);
        ndist = 1 + ((pk >> 8) & 31);
        hclen = 4 + ((pk >> 13) & 15);
        r.consume(14);
        idx = 0;
        prev = -1;
        rep = 0;
        for (int i = lane; i < 288; i += 32) t.ll_lens[i] = 0;
        t.of_lens[lane] = 0;
        if (lane < 20) t.pre_lens[lane] = 0;
        __syncwarp();
        mode = (nlit > 286 || ndist > 30) ? BAD : PRELEN;
      } else {
        mode = BAD;
      }
    } else if (mode == PRELEN) {
      const uint32_t pk = r.peek();
      if (lane == 0) t.pre_lens[kOrder[idx < 18 ? idx : 18]] = pk & 7;
      r.consume(3);
      ++idx;
      if (idx >= hclen) {
        __syncwarp();
        const bool over = build(t.pre_lens, 19, 19, t.prec, t.pre_perm, lane);
        if (!over)
          fill(t.pre, PRE_ROOT, 0, 0, t.prec, t.pre_perm, 19, K_PRE,
               t.sub_prefix, lane);
        mode = over ? BAD : LENS;
        idx = 0;
      }
    } else if (mode == LENS) {
      bool bad = false;
      int wval = 0;
      bool wr = false;
      if (rep > 0) {
        wval = repval;
        wr = true;
        --rep;
      } else {
        const uint32_t pk = r.peek();
        const uint32_t e = t.pre[pk & ((1u << PRE_ROOT) - 1u)];
        int clen, sym;
        bool badc = false;
        if (e != 0u) {
          sym = e >> 16;
          clen = e & 15;
        } else {
          sym = decode(t.prec, t.pre_perm, 19, pk, &clen, &badc);
        }
        const int rbits = sym == 16 ? 2 : (sym == 17 ? 3 : (sym == 18 ? 7 : 0));
        const int rv = (pk >> clen) & ((1u << rbits) - 1);
        r.consume(clen + rbits);
        const int newrep =
            (sym == 16 || sym == 17) ? 3 + rv : (sym == 18 ? 11 + rv : 0);
        if (sym == 16)
          repval = prev;
        else if (sym == 17 || sym == 18)
          repval = 0;
        const bool elit = sym <= 15;
        bad = badc || (sym == 16 && prev < 0) ||
              (!elit && idx + newrep > nlit + ndist);
        if (elit) {
          wval = sym;
          wr = true;
          prev = sym;
        }
        rep = newrep;
      }
      if (wr) {
        if (lane == 0) {
          if (idx < nlit)
            t.ll_lens[idx < 0 ? 0 : (idx > 287 ? 287 : idx)] = wval;
          else
            t.of_lens[idx - nlit > 31 ? 31 : idx - nlit] = wval;
        }
        ++idx;
      }
      if (bad) {
        mode = BAD;
      } else if (idx >= nlit + ndist) {
        __syncwarp();
        mode = build_body(t, 30, lane) ? BAD : BODY;
      }
    }

    if (mode == BODY) {
      // the block's symbols, one step each (a litlen symbol, and its
      // distance when it starts a match), with each step's overrun check
      const uint32_t ll = smem_addr(t.ll), of = smem_addr(t.of);
      // a match of `length`: its distance (by the table, or the canonical
      // way from an invalid slot) and its token; false when it is BAD
      auto match = [&](int length) {
        const uint32_t pk2 = r.peek();
        const uint32_t d = lookup(of, OF_ROOT, OF_SUB, pk2);
        int dlen, deb, dbase;
        bool dbad = false;
        if (d != 0u) {
          dlen = d & 15;
          deb = (d >> 8) & 31;
          dbase = d >> 16;
        } else {
          bool dbadc;
          const int dsym = decode(t.ofc, t.of_perm, 32, pk2, &dlen, &dbadc);
          dbad = dbadc || dsym > 29;
          dist_extra(dsym, &deb, &dbase);
        }
        const int dist =
            dbase + static_cast<int>((pk2 >> dlen) & ((1u << deb) - 1));
        r.consume(dlen + deb);
        if (dbad || (strict && dist > outpos) || outpos + length > out_cap)
          return false;
        excess = max(excess, dist - outpos);
        out[min(ntok, room)] = TOK_MATCH | (length - 3) | ((dist - 1) << 8);
        ++ntok;
        outpos += length;
        return true;
      };
      do {
        const uint32_t pk = r.peek();
        const uint32_t e = lookup(ll, LL_ROOT, LL_SUB, pk);
        const uint32_t clen_e = e & 15u, type = (e >> 4) & 3u;
        if (type == E_LIT && clen_e != 0u && outpos < out_cap) {
          // the common cases first: a literal that fits, ...
          r.consume(clen_e);
          out[min(ntok, room)] = TOK_LIT | (e >> 16);
          ++ntok;
          ++outpos;
          if (r.abit > lim) mode = BAD;
          continue;
        }
        if (type == E_LEN && clen_e != 0u) {
          // ... and a match whose length code is in the table
          const uint32_t eb = (e >> 8) & 31u;
          const int length = static_cast<int>(
              (e >> 16) + ((pk >> clen_e) & ((1u << eb) - 1u)));
          r.consume(clen_e + eb);
          if (!match(length) || r.abit > lim) mode = BAD;
          continue;
        }
        int clen, kind, val, eb;
        bool bad = false;
        if (e != 0u) {
          clen = clen_e;
          kind = type;
          val = e >> 16;
          eb = (e >> 8) & 31;
        } else {            // the canonical path: an invalid slot
          bool badc;
          const int sym = decode(t.llc, t.ll_perm, 288, pk, &clen, &badc);
          bad = badc || sym > 285;
          kind = sym < 256 ? E_LIT : (sym == 256 ? E_EOB : E_LEN);
          len_extra(sym, &eb, &val);
          if (kind == E_LIT) val = sym;
        }
        if (kind == E_LIT) {
          r.consume(clen);
          if (outpos + 1 > out_cap) bad = true;
          if (!bad) {
            out[min(ntok, room)] = TOK_LIT | val;
            ++ntok;
            ++outpos;
          }
        } else if (kind == E_EOB) {
          r.consume(clen);
          mode = final_blk ? DONE : BLKSTART;
        } else {
          const int length =
              val + static_cast<int>((pk >> clen) & ((1u << eb) - 1));
          r.consume(clen + eb);
          if (!bad) bad = !match(length);
        }
        if (bad) mode = BAD;
        if (mode < DONE && r.abit > lim) mode = BAD;
      } while (mode == BODY);
    } else if (mode == STORED) {
      // every remaining step of the stored block at once, in the closed
      // form of pass1_plain: a step k (from 0) emits byte k unless the
      // output is full (BAD without it), and the stream overruns at the
      // step whose byte lies past its end, unless that step ends the
      // final block
      const int64_t q = static_cast<int64_t>(lim) - r.abit;
      int64_t i_over = q >= 0 ? q >> 3 : 0;
      if (i_over == srem - 1 && final_blk) i_over = srem;
      const int i_cap = out_cap - outpos;
      const bool by_cap = i_cap < srem && i_cap <= i_over;
      const bool by_over = !by_cap && i_over < srem;
      const int nemit = by_cap ? i_cap : (by_over ? static_cast<int>(i_over) + 1 : srem);
      const int nuse = by_cap ? i_cap + 1 : nemit;
      const uint32_t at = r.bitpos() >> 3;
      for (int k = lane; k < min(nemit, room - ntok); k += 32)
        out[ntok + k] = TOK_LIT | r.byte(at + k);
      ntok += nemit;
      outpos += nemit;
      srem -= nuse;
      r.seek(r.bitpos() + 8u * nuse);
      if (srem == 0) mode = final_blk ? DONE : BLKSTART;
      if (by_cap || by_over) mode = BAD;
    }

    // consumed past the stream end while still active -> malformed
    if (mode < DONE && r.abit > lim) mode = BAD;
    if (sync_hit && mode == BLKSTART) mode = SYNC;
  }
  Result res;
  res.mode = mode;
  res.outpos = outpos;
  res.ntok = ntok;
  res.excess = excess;
  res.bits = r.bitpos();
  return res;
}

struct Batch {
  const uint32_t* words;    // the input's base, rounded down to 4 bytes
  int mis;                  // bytes from there to the input's first byte
  const int64_t* offsets;
  const int32_t* lengths;
  int out_cap;
  int32_t* tokens;          // (nstreams, out_cap), then the scratch
  const int32_t* room;      // each segment's room in the scratch
  const int64_t* at;        // and where it starts in `tokens`
};

__device__ __forceinline__ Result run_stream(Tables& t, const Batch& b,
                                             int64_t s, int64_t bit,
                                             bool strict, bool sync_stop,
                                             int32_t* out, int room,
                                             int lane) {
  return run(t, b.words, b.mis + b.offsets[s], b.lengths[s], bit, strict,
             sync_stop, out, room, b.out_cap, lane);
}

// Step 2: every candidate segment from its start bit; a stream's first
// segment (bit 0) is strict and writes its tokens into the stream's row,
// any other into its room in the scratch.
__global__ void __launch_bounds__(32)
measure_kernel(Batch b, const int64_t* __restrict__ seg_stream,
               const int64_t* __restrict__ seg_bit, int sync_stop,
               int32_t* __restrict__ seg_res) {
  __shared__ Tables t;
  const int i = blockIdx.x, lane = threadIdx.x;
  const int64_t s = seg_stream[i], bit = seg_bit[i];
  const Result r = run_stream(
      t, b, s, bit, bit == 0, sync_stop != 0,
      b.tokens + (bit == 0 ? s * b.out_cap : b.at[i]),
      bit == 0 ? b.out_cap : b.room[i], lane);
  if (lane == 0) {
    int32_t* o = seg_res + static_cast<int64_t>(i) * RES;
    o[0] = r.mode;
    o[1] = r.outpos;
    o[2] = static_cast<int32_t>(r.bits);
    o[3] = r.ntok;
    o[4] = r.excess;
  }
}

// Step 3: one thread per stream walks its chain of segments.
__global__ void chain_kernel(const int64_t* __restrict__ seg_bit,
                             const int64_t* __restrict__ seg_first,
                             int nstreams, int out_cap,
                             const int32_t* __restrict__ seg_res,
                             int32_t* __restrict__ seg_base,
                             int32_t* __restrict__ landed,
                             int32_t* __restrict__ rerun,
                             int32_t* __restrict__ stats) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= nstreams) return;
  const int64_t first = seg_first[s], last = seg_first[s + 1];
  int32_t* st = stats + static_cast<int64_t>(s) * 4;
  int64_t i = first, pout = 0, ptok = 0;
  int again = 1;
  while (true) {
    landed[i] = 1;
    const int32_t* r = seg_res + i * RES;
    if (r[0] == BAD) {
      if (i == first) {            // the serial decode's own verdict
        for (int k = 0; k < 4; ++k) st[k] = r[k];
        again = 0;
      }
      break;
    }
    if (r[4] > pout || pout + r[1] > out_cap) break;
    if (i != first) seg_base[i] = static_cast<int32_t>(ptok);
    pout += r[1];
    ptok += r[3];
    if (r[0] == DONE) {
      st[0] = DONE;
      st[1] = static_cast<int32_t>(pout);
      st[2] = r[2];
      st[3] = static_cast<int32_t>(ptok);
      again = 0;
      break;
    }
    // SYNC: the candidate that starts at the stop bit
    int64_t lo = i + 1, hi = last;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (seg_bit[mid] < r[2])
        lo = mid + 1;
      else
        hi = mid;
    }
    if (lo >= last || seg_bit[lo] != r[2]) break;
    i = lo;
  }
  rerun[s] = again;
}

// Step 4: the later segments of each finished stream, copied from the
// scratch into their place, or decoded again there if their tokens did
// not fit their room.
__global__ void __launch_bounds__(32)
emit_kernel(Batch b, const int64_t* __restrict__ seg_stream,
            const int64_t* __restrict__ seg_bit,
            const int32_t* __restrict__ seg_res,
            const int32_t* __restrict__ seg_base,
            const int32_t* __restrict__ rerun) {
  __shared__ Tables t;
  const int i = blockIdx.x, lane = threadIdx.x;
  const int64_t s = seg_stream[i];
  if (seg_base[i] < 0 || rerun[s]) return;
  int32_t* dst = b.tokens + s * b.out_cap + seg_base[i];
  const int n = seg_res[static_cast<int64_t>(i) * RES + 3];
  if (n <= b.room[i]) {
    const int32_t* src = b.tokens + b.at[i];
    for (int k = lane; k < n; k += 32) dst[k] = src[k];
    return;
  }
  run_stream(t, b, s, seg_bit[i], false, true, dst, b.out_cap, lane);
}

// Step 5: streams the chain did not finish, serially from bit 0.
__global__ void __launch_bounds__(32)
rerun_kernel(Batch b, const int32_t* __restrict__ rerun,
             int32_t* __restrict__ stats) {
  __shared__ Tables t;
  const int s = blockIdx.x, lane = threadIdx.x;
  if (!rerun[s]) return;
  const Result r = run_stream(
      t, b, s, 0, true, false, b.tokens + static_cast<int64_t>(s) * b.out_cap,
      b.out_cap, lane);
  if (lane == 0) {
    int32_t* st = stats + static_cast<int64_t>(s) * 4;
    st[0] = r.mode;
    st[1] = r.outpos;
    st[2] = static_cast<int32_t>(r.bits);
    st[3] = r.ntok;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes): steps 2-5 of the segment route
// (ops/inflate_tokens.py) for a batch whose candidates the finder listed.
// seg_stream, seg_bit (nseg,) int64 in stream order, seg_first
// (nstreams+1,) int64, seg_room (nseg,) int32 and seg_at (nseg,) int64:
// each segment's scratch room in tokens and its start in `tokens`, which
// holds the (nstreams, out_cap) rows, zeroed, and then the scratch; work
// space seg_res (nseg, 5) int32, seg_base (nseg,) int32 filled with -1,
// landed (nseg,) and rerun (nstreams,) int32 zeroed; stats (nstreams, 4)
// int32. Launches the four kernels on `stream` and returns the first
// cudaGetLastError() that is not 0, or 0. No synchronisation.
extern "C" int ldrsx_pass1(const void* data, const void* offsets,
                           const void* lengths, int nstreams, int out_cap,
                           const void* seg_stream, const void* seg_bit,
                           const void* seg_first, const void* seg_room,
                           const void* seg_at, int nseg, int sync_stop,
                           void* seg_res, void* seg_base,
                           void* landed, void* rerun, void* tokens,
                           void* stats, void* stream) {
  if (nstreams <= 0 || nseg <= 0) return 0;
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const uintptr_t p = reinterpret_cast<uintptr_t>(data);
  Batch b;
  b.words = reinterpret_cast<const uint32_t*>(p & ~static_cast<uintptr_t>(3));
  b.mis = static_cast<int>(p & 3);
  b.offsets = static_cast<const int64_t*>(offsets);
  b.lengths = static_cast<const int32_t*>(lengths);
  b.out_cap = out_cap;
  b.tokens = static_cast<int32_t*>(tokens);
  b.room = static_cast<const int32_t*>(seg_room);
  b.at = static_cast<const int64_t*>(seg_at);
  const int64_t* sst = static_cast<const int64_t*>(seg_stream);
  const int64_t* sbit = static_cast<const int64_t*>(seg_bit);
  int32_t* res = static_cast<int32_t*>(seg_res);
  int32_t* base = static_cast<int32_t*>(seg_base);
  int32_t* again = static_cast<int32_t*>(rerun);
  int32_t* st = static_cast<int32_t*>(stats);

  measure_kernel<<<nseg, 32, 0, cs>>>(b, sst, sbit, sync_stop, res);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  chain_kernel<<<(nstreams + 127) / 128, 128, 0, cs>>>(
      sbit, static_cast<const int64_t*>(seg_first), nstreams, out_cap, res,
      base, static_cast<int32_t*>(landed), again, st);
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  if (sync_stop) {   // without sync stops no segment follows another
    emit_kernel<<<nseg, 32, 0, cs>>>(b, sst, sbit, res, base, again);
    rc = static_cast<int>(cudaGetLastError());
    if (rc) return rc;
  }
  rerun_kernel<<<nstreams, 32, 0, cs>>>(b, again, st);
  return static_cast<int>(cudaGetLastError());
}
