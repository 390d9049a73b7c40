// Pass 1 of the two-pass DEFLATE decoder on NVIDIA Hopper (sm_90a):
// raw-DEFLATE streams -> compact LZ tokens in the ops/tokens.py format.
//
// Replaces libdeflate_rsx_tpu/ops/pallas/inflate_tokens.py::_make_kernel.
// It computes what that kernel computes, not its schedule: the TPU kernel
// runs 128 streams per grid cell in lockstep across vector lanes, with a
// lane mode machine, quorum-batched header and table phases, overlapped
// 512-byte DMA chunks and one-hot gathers, because TPU lanes can neither
// branch nor gather on their own. Here one thread owns one stream and
// loops over its symbols: a 64-bit bit buffer refilled byte by byte from
// the stream in global memory, and the stream's canonical tables (lim/fb
// per code length and the symbol permutation, ~1.4 KB) in dynamic shared
// memory. Verdicts follow the TPU kernel rule for rule (see the Python
// module ops/inflate_tokens.py, whose pass1_plain is the plain version of
// this kernel).
//
// What bounds it on this card: decoding is serial within a stream, so the
// kernel is latency-bound: each symbol waits on its bit-buffer refill and
// table lookups. 256 streams are 256 threads on a 132-SM card; with one
// stream per block every stream gets its own warp (no divergence), and
// the card's lanes sit mostly idle. A later version would split each
// stream at its block boundaries (or decode speculatively from several
// bit offsets) to get more than one thread per stream, keep a lookup
// table per code instead of the 15-compare canonical decode, and refill
// 32 bits at a time from aligned words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum : int {
  BLKSTART = 0, PRELEN = 1, LENS = 2, BODY = 4, STORED = 5, DONE = 6, BAD = 7
};

constexpr int32_t TOK_LIT = 1 << 29;
constexpr int32_t TOK_MATCH = 2 << 29;

__constant__ uint8_t kOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                   11, 4, 12, 3, 13, 2, 14, 1, 15};

struct Code {
  int32_t lim[16];  // MSB-aligned 15-bit limit per code length (row 0 unused)
  int32_t fb[16];   // base index - first code per code length
};

struct Tables {     // one per stream, in shared memory
  Code ll, of, pre;
  uint16_t ll_perm[288];
  uint16_t of_perm[32];
  uint16_t pre_perm[20];
  uint8_t ll_lens[288];
  uint8_t of_lens[32];
  uint8_t pre_lens[20];
};

struct Reader {
  const uint8_t* src;
  int64_t len;
  int64_t next;      // next byte to load
  uint64_t buf;
  int nbits;
  int64_t bitpos;    // bits consumed

  __device__ __forceinline__ void refill() {
    while (nbits <= 56) {
      uint64_t b = next < len ? static_cast<uint64_t>(src[next]) : 0ull;
      buf |= b << nbits;
      nbits += 8;
      ++next;
    }
  }
  __device__ __forceinline__ uint32_t peek() const {
    return static_cast<uint32_t>(buf);
  }
  __device__ __forceinline__ void consume(int n) {
    buf >>= n;
    nbits -= n;
    bitpos += n;
  }
};

// Canonical tables from code lengths; returns true when over-subscribed.
__device__ bool build(const uint8_t* lens, int nsym, int nperm, Code& c,
                      uint16_t* perm) {
  int cnt[16];
  for (int l = 0; l < 16; ++l) cnt[l] = 0;
  for (int s = 0; s < nsym; ++s) cnt[lens[s]]++;
  int kraft = 0;
  for (int l = 1; l < 16; ++l) kraft += cnt[l] << (15 - l);
  int nxt[16];
  int code = 0, bidx = 0;
  c.lim[0] = 1 << 29;
  c.fb[0] = 0;
  nxt[0] = 0;
  for (int l = 1; l < 16; ++l) {
    c.lim[l] = (code + cnt[l]) << (15 - l);
    c.fb[l] = bidx - code;
    nxt[l] = bidx;
    code = (code + cnt[l]) << 1;
    bidx += cnt[l];
  }
  for (int i = 0; i < nperm; ++i) perm[i] = 0;
  for (int s = 0; s < nsym; ++s) {
    int l = lens[s];
    if (l) {
      int p = nxt[l]++;
      perm[p < nperm ? p : nperm - 1] = static_cast<uint16_t>(s);
    }
  }
  return kraft > (1 << 15);
}

// One canonical decode from the low 15 peeked bits: the symbol, its code
// length clipped to 1..15 in *lc, and *bad when no code of length <= 15
// matches.
__device__ __forceinline__ int decode(const Code& c, const uint16_t* perm,
                                      int nperm, uint32_t pk, int* lc,
                                      bool* bad) {
  int v = static_cast<int>(__brev(pk & 0x7FFFu) >> 17);
  int length = 1;
#pragma unroll
  for (int l = 1; l < 16; ++l) length += v >= c.lim[l];
  *bad = length >= 16;
  int n = length > 15 ? 15 : length;
  int off = (v >> (15 - n)) + c.fb[n];
  off = off < 0 ? 0 : (off > nperm - 1 ? nperm - 1 : off);
  *lc = n;
  return perm[off];
}

__device__ void install_static(Tables& t) {
  for (int s = 0; s < 288; ++s)
    t.ll_lens[s] = s < 144 ? 8 : (s < 256 ? 9 : (s < 280 ? 7 : 8));
  for (int s = 0; s < 32; ++s) t.of_lens[s] = 5;
  build(t.ll_lens, 288, 288, t.ll, t.ll_perm);
  build(t.of_lens, 32, 32, t.of, t.of_perm);
}

__global__ void inflate_tokens_kernel(const uint8_t* __restrict__ data,
                                      const int64_t* __restrict__ offsets,
                                      const int32_t* __restrict__ lengths,
                                      int nstreams, int out_cap,
                                      int32_t* __restrict__ tokens,
                                      int32_t* __restrict__ stats) {
  // one stream per block of one thread; its tables in shared memory
  extern __shared__ __align__(16) unsigned char smem[];
  const int sid = blockIdx.x;
  if (sid >= nstreams) return;
  Tables& t = *reinterpret_cast<Tables*>(smem);
  Reader r;
  r.src = data + offsets[sid];
  r.len = lengths[sid];
  r.next = 0;
  r.buf = 0;
  r.nbits = 0;
  r.bitpos = 0;
  const int64_t inbits = r.len * 8;
  int32_t* out = tokens + static_cast<int64_t>(sid) * out_cap;

  int mode = BLKSTART, final_blk = 0;
  int outpos = 0, ntok = 0, srem = 0;
  int nlit = 0, ndist = 0, hclen = 0, idx = 0, prev = -1, rep = 0,
      repval = 0;

  while (mode < DONE) {
    // ---- one step of the TPU kernel's schedule, for this stream alone
    if (mode == BLKSTART) {
      r.refill();
      const uint32_t pk = r.peek();
      final_blk = pk & 1;
      const int btype = (pk >> 1) & 3;
      r.consume(3);
      if (btype == 0) {
        r.consume((8 - static_cast<int>(r.bitpos & 7)) & 7);
        r.refill();
        const uint32_t w = r.peek();
        const int slen = w & 0xFFFF, snlen = w >> 16;
        r.consume(32);
        srem = slen;
        if (slen != (snlen ^ 0xFFFF))
          mode = BAD;
        else
          mode = slen > 0 ? STORED : (final_blk ? DONE : BLKSTART);
      } else if (btype == 1) {
        install_static(t);
        mode = BODY;
      } else if (btype == 2) {
        nlit = 257 + ((pk >> 3) & 31);
        ndist = 1 + ((pk >> 8) & 31);
        hclen = 4 + ((pk >> 13) & 15);
        r.consume(14);
        idx = 0;
        prev = -1;
        rep = 0;
        for (int i = 0; i < 288; ++i) t.ll_lens[i] = 0;
        for (int i = 0; i < 32; ++i) t.of_lens[i] = 0;
        for (int i = 0; i < 20; ++i) t.pre_lens[i] = 0;
        mode = (nlit > 286 || ndist > 30) ? BAD : PRELEN;
      } else {
        mode = BAD;
      }
    } else if (mode == PRELEN) {
      r.refill();
      t.pre_lens[kOrder[idx < 18 ? idx : 18]] = r.peek() & 7;
      r.consume(3);
      ++idx;
      if (idx >= hclen) {
        mode = build(t.pre_lens, 19, 19, t.pre, t.pre_perm) ? BAD : LENS;
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
        r.refill();
        const uint32_t pk = r.peek();
        int clen;
        bool badc;
        const int sym = decode(t.pre, t.pre_perm, 19, pk, &clen, &badc);
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
        if (idx < nlit)
          t.ll_lens[idx < 0 ? 0 : (idx > 287 ? 287 : idx)] = wval;
        else
          t.of_lens[idx - nlit > 31 ? 31 : idx - nlit] = wval;
        ++idx;
      }
      if (bad) {
        mode = BAD;
      } else if (idx >= nlit + ndist) {
        const bool o1 = build(t.ll_lens, 288, 288, t.ll, t.ll_perm);
        const bool o2 = build(t.of_lens, 30, 32, t.of, t.of_perm);
        mode = (o1 || o2) ? BAD : BODY;
      }
    }

    if (mode == BODY) {
      // one litlen symbol, and its distance when it starts a match
      r.refill();
      const uint32_t pk = r.peek();
      int clen;
      bool badc;
      const int sym = decode(t.ll, t.ll_perm, 288, pk, &clen, &badc);
      const bool is_lit = sym < 256, is_eob = sym == 256, is_len = sym > 256;
      bool bad = badc || sym > 285;
      const int ls = sym - 257;
      const int eb = ls < 8 ? 0 : (ls == 28 ? 0 : (ls >> 2) - 1);
      const int lbase =
          ls < 8 ? ls + 3 : (ls == 28 ? 258 : ((4 + (ls & 3)) << eb) + 3);
      const int length = lbase + static_cast<int>((pk >> clen) & ((1u << eb) - 1));
      r.consume(clen + (is_len ? eb : 0));
      if (is_lit && outpos + 1 > out_cap) bad = true;
      if (is_lit && !bad) {
        out[ntok++] = TOK_LIT | sym;
        ++outpos;
      }
      if (is_eob) mode = final_blk ? DONE : BLKSTART;
      if (bad) {
        mode = BAD;
      } else if (is_len) {
        r.refill();
        const uint32_t pk2 = r.peek();
        int dlen;
        bool dbadc;
        const int dsym = decode(t.of, t.of_perm, 32, pk2, &dlen, &dbadc);
        const int deb = (dsym >> 1) - 1 > 0 ? (dsym >> 1) - 1 : 0;
        const int dbase = dsym < 4 ? dsym + 1 : ((2 + (dsym & 1)) << deb) + 1;
        const int dist =
            dbase + static_cast<int>((pk2 >> dlen) & ((1u << deb) - 1));
        r.consume(dlen + deb);
        if (dbadc || dsym > 29 || dist > outpos || outpos + length > out_cap) {
          mode = BAD;
        } else {
          out[ntok++] = TOK_MATCH | (length - 3) | ((dist - 1) << 8);
          outpos += length;
        }
      }
    } else if (mode == STORED) {
      r.refill();
      const int byte = r.peek() & 0xFF;
      r.consume(8);
      const bool badv = outpos + 1 > out_cap;
      if (!badv) {
        out[ntok++] = TOK_LIT | byte;
        ++outpos;
      }
      --srem;
      if (srem == 0) mode = final_blk ? DONE : BLKSTART;
      if (badv) mode = BAD;
    }

    // consumed past the stream end while still active -> malformed
    if (mode < DONE && r.bitpos > inbits) mode = BAD;
  }

  int32_t* st = stats + static_cast<int64_t>(sid) * 4;
  st[0] = mode;
  st[1] = outpos;
  st[2] = static_cast<int32_t>(r.bitpos);
  st[3] = ntok;
}

}  // namespace

// Plain C entry point (bound with ctypes). tokens must be zeroed by the
// caller; stats is (nstreams, 4) int32. Launches on `stream` and returns
// cudaGetLastError() as an int (0 on success). No synchronisation.
extern "C" int ldrsx_inflate_tokens(const void* data, const void* offsets,
                                    const void* lengths, int nstreams,
                                    int out_cap, void* tokens, void* stats,
                                    void* stream) {
  if (nstreams <= 0) return 0;
  // one stream per block: each stream gets a warp of its own, so its
  // serial symbol loop never waits on another stream's branch (measured
  // fastest of 1, 2, 4, 8 and 32 streams per block on 256 streams)
  const int grid = nstreams;
  inflate_tokens_kernel<<<grid, 1, sizeof(Tables),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int64_t*>(offsets),
      static_cast<const int32_t*>(lengths), nstreams, out_cap,
      static_cast<int32_t*>(tokens), static_cast<int32_t*>(stats));
  return static_cast<int>(cudaGetLastError());
}
