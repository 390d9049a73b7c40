// Stored/static-Huffman DEFLATE decoder on NVIDIA Hopper (sm_90a): raw
// streams of BTYPE 00 and 01 -> decoded bytes, one stream per block of
// one warp.
//
// Replaces libdeflate_rsx_tpu/ops/pallas/inflate_static.py::_kernel, with
// that kernel's verdicts and count (out[OUT_WORDS-1], -1 for a bad
// stream). That kernel reads through a 32-bit bit buffer refilled a byte
// at a time; every read it makes falls within the bits its refill holds,
// so it reads what a plain bit position reads with zero bits past the
// input's end, which is how this kernel reads. The static litlen code is
// the TPU kernel's closed form (symbols 286 and 287 decode as lengths),
// the stored-length, output-cap and distance checks are its checks, and
// BTYPE 10 and 11 make the stream bad at once (the TPU kernel first
// decodes such a block as static, which changes neither verdict nor
// count). The plain PyTorch version of this kernel is
// ops/inflate_static.py's inflate_static_plain.
//
// What bounds it on this card: latency, not bytes (its byte bound is
// ~1/1,000 of its time): the decode is serial within a stream, and one
// warp on an SM pays each dependent instruction's full latency. What the
// design does about it (stream_decode.cuh holds the parts shared with
// inflate_v2.cu): the input row is staged in shared memory by one TMA bulk
// copy and the bytes past the stream's end zeroed there; the output row
// is built in shared memory and written back whole in 16-byte stores; a
// symbol is one lookup in a 512-entry table of pre-decoded litlen entries
// (built from the closed form when the block starts) indexed by 9 peeked
// bits, and a distance one lookup in a 32-entry table; LZ and stored
// copies are split across the 32 lanes. Shared memory: 133,776 bytes a
// block (one block per SM), set with cudaFuncSetAttribute by the entry
// point.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stream_decode.cuh"

namespace {

using sd::IN_WORDS;
using sd::OUT_WORDS;
constexpr int OUT_CAP = (OUT_WORDS - 1) * 4;
constexpr int TAIL = 128;     // bytes past the stream's end zeroed
// litlen entry: bits 0-3 code length, 4-5 type, 8-12 extra bits, 16-31
// literal or length base; distance entry: bits 8-12 extra bits, 16-31 base
constexpr uint32_t E_LIT = 0, E_LEN = 1, E_EOB = 2;

struct alignas(16) Smem {
  uint32_t in[IN_WORDS];
  uint32_t out[OUT_WORDS];
  uint32_t lit[512];
  uint32_t dist[32];
  uint64_t bar;
};

// The static litlen code from 9 peeked bits (stream order), inverted in
// closed form as the TPU kernel does, and the distance code from 5.
__device__ void build_tables(Smem& s, int lane) {
  for (int k = lane; k < 512; k += 32) {
    const int rev9 = static_cast<int>(__brev(static_cast<unsigned>(k)) >> 23);
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
    uint32_t e;
    if (sym < 256) {
      e = (static_cast<uint32_t>(sym) << 16) | (E_LIT << 4) | used;
    } else if (sym == 256) {
      e = (E_EOB << 4) | used;
    } else {
      const int ls = sym - 257;
      const int eb = (ls < 8 || ls == 28) ? 0 : (ls - 4) >> 2;
      const int base = ls < 8 ? ls + 3 : (ls == 28 ? 258 : ((4 + (ls & 3)) << eb) + 3);
      e = (static_cast<uint32_t>(base) << 16) | (eb << 8) | (E_LEN << 4) | used;
    }
    s.lit[k] = e;
  }
  const int osym = static_cast<int>(__brev(static_cast<unsigned>(lane)) >> 27);
  const int oeb = osym / 2 - 1 > 0 ? osym / 2 - 1 : 0;
  const int obase = osym < 4 ? osym + 1 : ((2 + (osym & 1)) << oeb) + 1;
  s.dist[lane] = (static_cast<uint32_t>(obase) << 16) | (oeb << 8);
  __syncwarp();
}

extern __shared__ __align__(16) unsigned char smem_raw[];

__global__ void __launch_bounds__(32, 1)
inflate_static_kernel(const int32_t* __restrict__ lens,
                      const int32_t* __restrict__ words,
                      int32_t* __restrict__ out) {
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int sid = blockIdx.x;
  const int lane = threadIdx.x;
  const int in_len = lens[sid];
  const uint32_t in_bits = 8u * in_len;
  sd::stage_row(s.in, s.out, words + static_cast<int64_t>(sid) * IN_WORDS,
                &s.bar, lane);
  uint8_t* ob = reinterpret_cast<uint8_t*>(s.out);
  uint8_t* ib = reinterpret_cast<uint8_t*>(s.in);
  // zero bits past the end, whatever the row holds there
  for (int k = in_len + lane; k < in_len + TAIL && k < sd::IN_BYTES; k += 32)
    ib[k] = 0;
  build_tables(s, lane);

  sd::Reader<false> r;
  r.in = s.in;
  r.seek(0);
  int outpos = 0, done = 0, bad = 0;
  while (done == 0 && bad == 0 && r.abit + 3 <= in_bits) {
    const int hdr = r.peek() & 7;
    r.consume(3);
    const int bfinal = hdr & 1, btype = hdr >> 1;
    if (btype >= 2) {
      bad = 1;
    } else if (btype == 0) {                          // stored block
      r.consume((8 - (r.abit & 7)) & 7);
      const uint32_t pk = r.peek();
      const int ln = pk & 0xFFFF, nlen = pk >> 16;
      const int start = (r.abit >> 3) + 4;
      bad = ln != (~nlen & 0xFFFF) || start + ln > in_len ||
            outpos + ln > OUT_CAP;
      const int n = bad ? 0 : ln;
      for (int k = lane; k < n; k += 32) ob[outpos + k] = ib[start + k];
      outpos += n;
      r.seek(8u * (start + n));
    } else {                                          // static block
      for (;;) {
        const uint32_t pk = r.peek();
        const uint32_t e = s.lit[pk & 511];
        const uint32_t used = e & 15, ty = (e >> 4) & 3;
        r.consume(used);
        if (ty == E_LIT) {
          const bool over = outpos >= OUT_CAP;
          ob[outpos < OUT_CAP - 1 ? outpos : OUT_CAP - 1] =
              static_cast<uint8_t>(e >> 16);
          ++outpos;
          if (over) {
            bad = 1;
            break;
          }
          continue;
        }
        if (ty == E_EOB) break;
        const uint32_t eb = (e >> 8) & 31;
        const int length =
            static_cast<int>((e >> 16) + ((pk >> used) & ((1u << eb) - 1u)));
        r.consume(eb);
        const uint32_t pk2 = r.peek();
        const uint32_t d = s.dist[pk2 & 31];
        const uint32_t oeb = (d >> 8) & 31;
        const int dist =
            static_cast<int>((d >> 16) + ((pk2 >> 5) & ((1u << oeb) - 1u)));
        r.consume(5 + oeb);
        if (dist > outpos || outpos + length > OUT_CAP) {
          bad = 1;
          break;
        }
        __syncwarp();                    // every byte before outpos is visible
        sd::lz_copy(ob, outpos, dist, length, lane);
        outpos += length;
      }
    }
    done = bad ? 1 : bfinal;
  }
  __syncwarp();
  if (lane == 0) s.out[OUT_WORDS - 1] = bad ? -1 : outpos;
  sd::write_back(out + static_cast<int64_t>(sid) * OUT_WORDS, s.out, lane);
}

}  // namespace

// Plain C entry point (bound with ctypes). lens (nstreams,) and words
// (nstreams, 16384) int32, words 16-byte aligned; out (nstreams, 16512)
// int32, every word of which the kernel writes. Launches on `stream`
// and returns the first CUDA error as an int (0 on success): that of
// raising the kernel's shared-memory limit, of a misaligned `words`
// (cudaErrorInvalidValue), or of the launch. No synchronisation.
extern "C" int ldrsx_inflate_static(const void* lens, const void* words,
                                    int nstreams, void* out, void* stream) {
  if (nstreams <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(words) & 15)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = static_cast<int>(sizeof(Smem));
  const cudaError_t rc = cudaFuncSetAttribute(
      inflate_static_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  inflate_static_kernel<<<nstreams, 32, bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lens), static_cast<const int32_t*>(words),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
