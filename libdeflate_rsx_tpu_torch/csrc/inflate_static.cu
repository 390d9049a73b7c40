// Stored/static-Huffman DEFLATE decoder on NVIDIA Hopper (sm_90a): raw
// streams of BTYPE 00 and 01 -> decoded bytes, one thread per stream.
//
// Replaces libdeflate_rsx_tpu/ops/pallas/inflate_static.py::_kernel, with
// that kernel's verdicts and count (out[OUT_WORDS-1], -1 for a bad
// stream): the same 32-bit bit buffer refilled a byte at a time while it
// holds at most 24 bits (zero bits past the input's end), the static
// litlen code inverted in closed form from 9 peeked bits, the same
// stored-length, output-cap and distance checks. BTYPE 10 and 11 make the
// stream bad at once (the TPU kernel first decodes such a block as static,
// which changes neither verdict nor count). The plain PyTorch version of
// this kernel is ops/inflate_static.py's inflate_static_plain.
//
// What the TPU forced and this kernel drops: the stream DMA'd into scalar
// memory as int32 words and the output packed into int32 words by
// read-modify-write; here bytes are read from and stored to device
// memory directly.
//
// What bounds it on this card: the bytes it must move are each input byte
// read once and each output byte written once, but the decode is
// bit-serial within a stream, so it is latency-bound (a symbol's length
// is known only after its bits are reversed and classified). Each stream
// gets a block of its own, so no stream's branches wait on another's; a
// batch fills as many SMs as it has streams, up to 132.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int IN_WORDS = 16384;
constexpr int OUT_WORDS = 16384 + 128;
constexpr int OUT_CAP = (OUT_WORDS - 1) * 4;

struct Bits {
  const uint8_t* src;
  int in_len;
  uint32_t buf;   // the next `bits` bits of the stream (0 above them)
  int bits;       // may fall below 0 once zero bits past the end are read
  int inpos;

  __device__ __forceinline__ void refill() {
    while (bits <= 24 && inpos < in_len) {
      buf |= static_cast<uint32_t>(src[inpos]) << bits;
      bits += 8;
      ++inpos;
    }
  }
  __device__ __forceinline__ uint32_t take(int n) {
    const uint32_t v = buf & ((1u << n) - 1u);
    buf >>= n;
    bits -= n;
    return v;
  }
};

__global__ void inflate_static_kernel(const int32_t* __restrict__ lens,
                                      const int32_t* __restrict__ words,
                                      int nstreams, int32_t* __restrict__ out) {
  const int sid = blockIdx.x;
  if (sid >= nstreams) return;
  Bits r;
  r.src = reinterpret_cast<const uint8_t*>(words + static_cast<int64_t>(sid) * IN_WORDS);
  r.in_len = lens[sid];
  r.buf = 0;
  r.bits = 0;
  r.inpos = 0;
  int32_t* orow = out + static_cast<int64_t>(sid) * OUT_WORDS;
  uint8_t* ob = reinterpret_cast<uint8_t*>(orow);
  int outpos = 0, done = 0, bad = 0;

  while (done == 0 && bad == 0 && (r.inpos < r.in_len || r.bits >= 3)) {
    r.refill();
    const int hdr = r.take(3);
    const int bfinal = hdr & 1, btype = hdr >> 1;
    if (btype >= 2) {
      bad = 1;
    } else if (btype == 0) {                          // stored block
      r.take(r.bits & 7);
      r.refill();
      const int ln = r.buf & 0xFFFF, nlen = r.buf >> 16;
      // rewind past the bytes still held after LEN/NLEN
      const int start = r.inpos - (r.bits - 32) / 8;
      r.buf = 0;
      r.bits = 0;
      bad = ln != (~nlen & 0xFFFF) || start + ln > r.in_len ||
            outpos + ln > OUT_CAP;
      const int n = bad ? 0 : ln;
      for (int k = 0; k < n; ++k) ob[outpos + k] = r.src[start + k];
      outpos += n;
      r.inpos = start + n;
    } else {                                          // static block
      for (;;) {
        r.refill();
        const int rev9 = static_cast<int>(__brev(r.buf & 0x1FFu) >> 23);
        const int rev7 = rev9 >> 2, rev8 = rev9 >> 1;
        int sym, used;
        if (rev7 < 0x18) {
          sym = 256 + rev7;                           // 7-bit codes
          used = 7;
        } else if (rev8 >= 0x30 && rev8 < 0xC0) {
          sym = rev8 - 0x30;                          // literals 0-143
          used = 8;
        } else if (rev8 >= 0xC0 && rev8 < 0xC8) {
          sym = 280 + (rev8 - 0xC0);                  // 280-287
          used = 8;
        } else {
          sym = 144 + (rev9 - 0x190);                 // literals 144-255
          used = 9;
        }
        r.take(used);
        if (sym < 256) {
          const bool over = outpos >= OUT_CAP;
          ob[outpos < OUT_CAP - 1 ? outpos : OUT_CAP - 1] = static_cast<uint8_t>(sym);
          ++outpos;
          if (over) {
            bad = 1;
            break;
          }
        } else if (sym == 256) {
          break;
        } else {
          r.refill();
          const int ls = sym - 257;
          const int eb = (ls < 8 || ls == 28) ? 0 : (ls - 4) >> 2;
          const int base = ls < 8 ? ls + 3 : (ls == 28 ? 258 : ((4 + (ls & 3)) << eb) + 3);
          const int length = base + static_cast<int>(r.take(eb));
          const int osym = static_cast<int>(__brev(r.take(5)) >> 27);
          r.refill();
          const int oeb = osym / 2 - 1 > 0 ? osym / 2 - 1 : 0;
          const int obase = osym < 4 ? osym + 1 : ((2 + (osym & 1)) << oeb) + 1;
          const int dist = obase + static_cast<int>(r.take(oeb));
          if (dist > outpos || outpos + length > OUT_CAP) {
            bad = 1;
            break;
          }
          for (int k = 0; k < length; ++k) ob[outpos + k] = ob[outpos + k - dist];
          outpos += length;
        }
      }
    }
    done = bad ? 1 : bfinal;
  }
  orow[OUT_WORDS - 1] = bad ? -1 : outpos;
}

}  // namespace

// Plain C entry point (bound with ctypes). lens (nstreams,) and words
// (nstreams, 16384) int32; out (nstreams, 16512) int32, zeroed by the
// caller. Launches on `stream` and returns cudaGetLastError() as an int
// (0 on success). No synchronisation.
extern "C" int ldrsx_inflate_static(const void* lens, const void* words,
                                    int nstreams, void* out, void* stream) {
  if (nstreams <= 0) return 0;
  inflate_static_kernel<<<nstreams, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lens), static_cast<const int32_t*>(words),
      nstreams, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
