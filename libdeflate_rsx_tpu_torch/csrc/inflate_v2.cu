// Small-batch DEFLATE decoder on NVIDIA Hopper (sm_90a): whole raw-DEFLATE
// streams (BTYPE 00, 01 and 10) -> decoded bytes, one stream per block.
//
// Replaces libdeflate_rsx_tpu/ops/pallas/inflate_v2.py::_kernel. It computes
// what that kernel computes: the same two-level decode tables built from
// each block's header (10-bit litlen root, 8-bit offset root, 7-bit
// precode table; entry layout bits 0-4 length, 5-7 type, 8-15 extra or
// subtable bits, 16-31 payload), the same cause bits in the flag word
// (out[OUT_WORDS-2]) and the same count or -1 (out[OUT_WORDS-1]). The
// plain PyTorch version of this kernel is ops/inflate_v2.py's
// inflate_v2_plain; its docstring lists the rules.
//
// What the TPU forced and this kernel drops: the stream DMA'd into scalar
// memory and read as int32 words through funnel shifts, the output packed
// into int32 words by read-modify-write, and the fori/while/cond nesting.
// Here the stream is read from device memory through a 64-bit bit buffer
// refilled a byte at a time (the row is read as a 64 KiB ring, as the TPU
// kernel's word index wraps), and bytes are stored straight into the
// output row in device memory.
//
// What bounds it on this card: the bytes it must move are each input byte
// read once and each output byte written once, but decoding is serial
// within a stream, so it is latency-bound: each symbol waits on its table
// lookup and bit-buffer refill. A batch of a few streams fills a few SMs
// of 132. The design keeps each stream's tables (~26 KB) in shared memory
// and gives the stream a warp: all 32 lanes walk the stream's control flow
// together (same data, same branches), lane 0 alone writes literals, and
// the lanes split the table fills, subtable clears, stored-block copies
// and LZ copies (every source byte of a match lies before it, so byte k
// of a match at distance d is byte k % d before it), with a warp barrier
// (__syncwarp orders memory among the lanes) wherever a lane reads what
// another wrote.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int IN_WORDS = 16384;
constexpr int OUT_WORDS = 16384 + 128;
constexpr int IN_MASK = IN_WORDS * 4 - 1;      // the row as a 64 KiB ring
constexpr int OUT_CAP = (OUT_WORDS - 2) * 4;
constexpr int LL_WORDS = 4096, OF_WORDS = 2048, PRE_WORDS = 128;
constexpr int LENS_WORDS = 320;
constexpr int T_LIT = 0, T_BASE = 1, T_EOB = 2, T_SUB = 3;
constexpr int PRE = 0, LITLEN = 1, OFFSET = 2;

__constant__ uint8_t kOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                   11, 4, 12, 3, 13, 2, 14, 1, 15};

struct Smem {
  int32_t ll[LL_WORDS];
  int32_t of[OF_WORDS];
  int32_t pre[PRE_WORDS];
  int32_t lens[LENS_WORDS];
};

struct Reader {
  const uint8_t* row;
  uint64_t buf;
  int nbits;
  int next;   // next byte to load (mod 64 KiB)
  int bp;     // bits consumed

  __device__ __forceinline__ void seek(int bitpos) {
    next = bitpos >> 3;
    buf = 0;
    nbits = 0;
    bp = bitpos & ~7;
    refill();
    skip(bitpos & 7);
  }
  __device__ __forceinline__ void refill() {
    while (nbits <= 56) {
      buf |= static_cast<uint64_t>(row[next & IN_MASK]) << nbits;
      nbits += 8;
      ++next;
    }
  }
  // the 32 bits at bp
  __device__ __forceinline__ uint32_t peek() {
    refill();
    return static_cast<uint32_t>(buf);
  }
  __device__ __forceinline__ void skip(int n) {
    buf >>= n;
    nbits -= n;
    bp += n;
  }
};

__device__ __forceinline__ int rev15(int x) {
  return static_cast<int>(__brev(static_cast<unsigned>(x) & 0xFFFFu) >> 17);
}

__device__ __forceinline__ int mask_bits(uint32_t v, int n) {
  return static_cast<int>(v & ((1u << n) - 1u));
}

__device__ int entry(int kind, int sym) {
  if (kind == PRE) return (sym << 16) | (T_LIT << 5);
  if (kind == OFFSET) {
    const int oeb = sym / 2 - 1 > 0 ? sym / 2 - 1 : 0;
    const int obase = sym < 4 ? sym + 1 : ((2 + (sym & 1)) << oeb) + 1;
    return sym <= 29 ? (obase << 16) | (oeb << 8) | (T_BASE << 5) : -1;
  }
  if (sym < 256) return (sym << 16) | (T_LIT << 5);
  if (sym == 256) return T_EOB << 5;
  if (sym > 285) return -1;
  const int ls = sym - 257;
  const int eb = ls < 8 ? 0 : (ls == 28 ? 0 : (ls - 4) >> 2);
  const int base = ls < 8 ? ls + 3 : (ls == 28 ? 258 : ((4 + (ls & 3)) << eb) + 3);
  return (base << 16) | (eb << 8) | (T_BASE << 5);
}

// Two-level canonical table from lens[0..nsym), as the TPU kernel builds
// it; returns bad ORed with 32 (over-subscribed) and 64 (subtables past
// tab_words). Every lane runs the loop with the same values; table writes
// are split across lanes, with a warp barrier before any lane reads them.
__device__ int build_table(int32_t* tab, int tab_words, int root_bits,
                           int nsym, const int32_t* lens, int kind, int bad,
                           int lane) {
  int cnt[16], nxt[16];
  for (int l = 0; l < 16; ++l) cnt[l] = 0;
  for (int i = 0; i < nsym; ++i) cnt[lens[i] & 15]++;
  cnt[0] = 0;
  int used = 0;
  for (int l = 1; l < 16; ++l) used += cnt[l] << (15 - l);
  if (used > (1 << 15)) bad |= 32;
  const int root_size = 1 << root_bits;
  const int max_sub = 15 - root_bits;
  for (int k = lane; k < root_size; k += 32) tab[k] = 0;
  __syncwarp();
  // pre-pass: the longest excess over root_bits at each long prefix
  int code = 0;
  for (int l = 1; l < 16; ++l) nxt[l] = code = (code + cnt[l - 1]) << 1;
  for (int i = 0; i < nsym; ++i) {
    const int l = lens[i];
    if (l > root_bits) {
      const int prefix = rev15(nxt[l]++ << (15 - l)) & (root_size - 1);
      if (lane == 0 && tab[prefix] < l - root_bits) tab[prefix] = l - root_bits;
    } else if (l > 0) {
      nxt[l]++;
    }
  }
  __syncwarp();
  code = 0;
  for (int l = 1; l < 16; ++l) nxt[l] = code = (code + cnt[l - 1]) << 1;
  int alloc = root_size;
  for (int i = 0; i < nsym; ++i) {
    const int l = lens[i];
    if (l == 0) continue;
    const int rev = rev15(nxt[l]++ << (15 - l));
    const int ent = entry(kind, i);
    const int ent_ok = ent < 0 ? 0 : (ent | l);
    if (l <= root_bits) {
      const int step = 1 << l;
      for (int k = lane; k < (root_size >> l); k += 32) {
        const int at = rev + k * step;
        tab[at < root_size - 1 ? at : root_size - 1] = ent_ok;
      }
      __syncwarp();
      continue;
    }
    const int prefix = rev & (root_size - 1);
    const int cur = tab[prefix];
    const bool is_ptr = ((cur >> 5) & 7) == T_SUB;
    int sub_bits = is_ptr ? (cur >> 8) & 255 : cur & 31;
    sub_bits = sub_bits < 1 ? 1 : (sub_bits > max_sub ? max_sub : sub_bits);
    const int sub_base = is_ptr ? (cur >> 16) & 0xFFFF : alloc;
    const int new_alloc = is_ptr ? alloc : alloc + (1 << sub_bits);
    if (new_alloc > tab_words) bad |= 64;
    __syncwarp();                       // every lane has read cur
    if (!is_ptr && bad == 0) {
      for (int k = lane; k < (1 << sub_bits); k += 32) {
        const int at = sub_base + k;
        tab[at < tab_words - 1 ? at : tab_words - 1] = 0;
      }
      __syncwarp();
      if (lane == 0)
        tab[prefix] = (sub_base << 16) | (sub_bits << 8) | (T_SUB << 5);
    }
    const int hi = rev >> root_bits;
    const int step = 1 << (l - root_bits);
    const int nrep = bad != 0 ? 0 : (1 << sub_bits) >> (l - root_bits);
    for (int k = lane; k < nrep; k += 32) {
      const int at = sub_base + hi + k * step;
      tab[at < tab_words - 1 ? at : tab_words - 1] = ent_ok;
    }
    __syncwarp();
    alloc = new_alloc;
  }
  return bad;
}

// Resolve a root entry through its subtable pointer, if it is one.
__device__ __forceinline__ int lookup(const int32_t* tab, int tab_words,
                                      int root_bits, uint32_t pk) {
  const int e = tab[pk & ((1u << root_bits) - 1)];
  if (((e >> 5) & 7) != T_SUB) return e;
  const int at = ((e >> 16) & 0xFFFF) + mask_bits(pk >> root_bits, (e >> 8) & 255);
  return tab[at < tab_words - 1 ? at : tab_words - 1];
}

__device__ int parse_dynamic(Smem& s, Reader& r, int in_bits, int bad,
                             int lane) {
  const uint32_t pk = r.peek();
  const int num_ll = (pk & 31) + 257;
  const int num_of = ((pk >> 5) & 31) + 1;
  const int ne = ((pk >> 10) & 15) + 4;
  r.skip(14);
  if (num_ll > 286 || num_of > 30) bad |= 8;
  for (int k = lane; k < 19; k += 32) s.lens[k] = 0;
  __syncwarp();
  for (int k = 0; k < ne; ++k) {
    const int v = r.peek() & 7;
    if (lane == 0) s.lens[kOrder[k]] = v;
    r.skip(3);
  }
  __syncwarp();
  if (r.bp > in_bits) bad |= 16;
  bad = build_table(s.pre, PRE_WORDS, 7, 19, s.lens, PRE, bad, lane);

  // code lengths, run-length coded through the precode
  const int tot = num_ll + num_of;
  int i = 0;
  while (i < tot && bad == 0 && r.bp <= in_bits) {
    const int e = s.pre[r.peek() & 127];
    const int l = e & 31;
    if (l == 0) bad |= 128;
    r.skip(l);
    const int sym = (e >> 16) & 0xFFFF;
    const uint32_t pk2 = r.peek();
    if (sym <= 15) {
      if (lane == 0) s.lens[i < LENS_WORDS - 1 ? i : LENS_WORDS - 1] = sym;
      __syncwarp();
      ++i;
      continue;
    }
    // 16: repeat the previous length 3-6 | 17: zeros 3-10 | 18: zeros 11-138
    const int ebits = sym == 16 ? 2 : (sym == 17 ? 3 : 7);
    const int rep = (sym == 18 ? 11 : 3) + mask_bits(pk2, ebits);
    r.skip(ebits);
    const int prev = s.lens[i - 1 > 0 ? i - 1 : 0];
    const int val = sym == 16 ? prev : 0;
    if ((sym == 16 && i == 0) || i + rep > tot) bad |= 256;
    __syncwarp();                       // every lane has read prev
    for (int k = lane; k < (bad != 0 ? 0 : rep); k += 32) {
      const int at = i + k;
      s.lens[at < LENS_WORDS - 1 ? at : LENS_WORDS - 1] = val;
    }
    __syncwarp();
    i += rep;
  }
  if (i != tot) bad |= 512;
  if (r.bp > in_bits) bad |= 1024;
  // offset lengths to 288.., litlen lengths zeroed from num_ll to 288
  if (lane == 0) {
    for (int k = 29; k >= 0; --k)
      s.lens[288 + k] = k < num_of ? s.lens[num_ll + k] : 0;
    for (int k = num_ll; k < 288; ++k) s.lens[k] = 0;
  }
  __syncwarp();
  if (s.lens[256] == 0) bad |= 2048;
  bad = build_table(s.ll, LL_WORDS, 10, 288, s.lens, LITLEN, bad, lane);
  return build_table(s.of, OF_WORDS, 8, 30, s.lens + 288, OFFSET, bad, lane);
}

__device__ int load_static(Smem& s, int bad, int lane) {
  for (int k = lane; k < 318; k += 32)
    s.lens[k] = k >= 288 ? 5 : (k < 144 ? 8 : (k < 256 ? 9 : (k < 280 ? 7 : 8)));
  __syncwarp();
  bad = build_table(s.ll, LL_WORDS, 10, 288, s.lens, LITLEN, bad, lane);
  return build_table(s.of, OF_WORDS, 8, 30, s.lens + 288, OFFSET, bad, lane);
}

__global__ void __launch_bounds__(32)
inflate_v2_kernel(const int32_t* __restrict__ lens,
                  const int32_t* __restrict__ words, int nstreams,
                  int32_t* __restrict__ out) {
  __shared__ Smem s;
  const int sid = blockIdx.x;
  const int lane = threadIdx.x;
  if (sid >= nstreams) return;
  const uint8_t* row =
      reinterpret_cast<const uint8_t*>(words + static_cast<int64_t>(sid) * IN_WORDS);
  int32_t* orow = out + static_cast<int64_t>(sid) * OUT_WORDS;
  uint8_t* ob = reinterpret_cast<uint8_t*>(orow);
  const int in_len = lens[sid];
  const int in_bits = in_len * 8;
  for (int k = lane; k < LENS_WORDS; k += 32) s.lens[k] = 0;
  __syncwarp();

  Reader r;
  r.row = row;
  r.seek(0);
  int bad = 0, op = 0, done = 0;
  while (done == 0 && bad == 0 && r.bp + 3 <= in_bits) {
    const int hdr = r.peek() & 7;
    r.skip(3);
    const int bfinal = hdr & 1, btype = hdr >> 1;
    if (btype == 3) bad |= 1;
    if (btype == 0) {                                 // stored block
      r.skip((8 - (r.bp & 7)) & 7);
      const uint32_t pk = r.peek();
      const int ln = pk & 0xFFFF, nlen = pk >> 16;
      if (ln != (~nlen & 0xFFFF)) bad |= 2;
      r.skip(32);
      const int start = r.bp >> 3;
      if (start + ln > in_len || op + ln > OUT_CAP) bad |= 4;
      const int n = bad != 0 ? 0 : ln;
      for (int k = lane; k < n; k += 32) ob[op + k] = row[(start + k) & IN_MASK];
      __syncwarp();
      r.seek(r.bp + 8 * n);
      op += n;
    } else {
      bad = btype == 2 ? parse_dynamic(s, r, in_bits, bad, lane)
                       : load_static(s, bad, lane);
      int eob = 0;
      while (eob == 0 && bad == 0 && r.bp <= in_bits) {   // block body
        const uint32_t pk = r.peek();
        const int e = lookup(s.ll, LL_WORDS, 10, pk);
        const int l = e & 31, ty = (e >> 5) & 7;
        if (l == 0) bad |= 4096;
        r.skip(l);
        if (ty == T_LIT) {
          if (op >= OUT_CAP) bad |= 32768;
          if (lane == 0) ob[op < OUT_CAP - 1 ? op : OUT_CAP - 1] = (e >> 16) & 0xFF;
          ++op;
        } else if (ty == T_EOB) {
          eob = 1;
        } else {
          const int ebits = (e >> 8) & 255;
          const int length = ((e >> 16) & 0xFFFF) + mask_bits(r.peek(), ebits);
          r.skip(ebits);
          const int oe = lookup(s.of, OF_WORDS, 8, r.peek());
          const int ol = oe & 31;
          if (ol == 0 || ((oe >> 5) & 7) != T_BASE) bad |= 8192;
          r.skip(ol);
          const int oeb = (oe >> 8) & 255;
          const int off = ((oe >> 16) & 0xFFFF) + mask_bits(r.peek(), oeb);
          r.skip(oeb);
          if (off > op) bad |= 16384;
          if (op + length > OUT_CAP - 4) bad |= 32768;
          if (r.bp > in_bits) bad |= 65536;
          if (bad == 0) {
            // every source byte lies before op, so the lanes copy at once:
            // byte k of the match is byte op - off + k % off
            __syncwarp();
            for (int k = lane; k < length; k += 32) ob[op + k] = ob[op - off + k % off];
            __syncwarp();
            op += length;
          }
        }
      }
      if (eob == 0) bad |= 131072;
    }
    done = bad != 0 ? 1 : bfinal;
  }
  if (done == 0) bad |= 262144;
  if (lane == 0) {
    orow[OUT_WORDS - 2] = bad;
    orow[OUT_WORDS - 1] = bad != 0 ? -1 : op;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). lens (nstreams,) and words
// (nstreams, 16384) int32; out (nstreams, 16512) int32, zeroed by the
// caller. Launches on `stream` and returns cudaGetLastError() as an int
// (0 on success). No synchronisation.
extern "C" int ldrsx_inflate_v2(const void* lens, const void* words,
                                int nstreams, void* out, void* stream) {
  if (nstreams <= 0) return 0;
  inflate_v2_kernel<<<nstreams, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lens), static_cast<const int32_t*>(words),
      nstreams, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
