// What the two stream kernels (inflate_v2.cu, inflate_static.cu) share on
// NVIDIA Hopper (sm_90a): one block of one warp per stream, the stream's
// 64 KiB input row and its output row held in dynamic shared memory.
//
// - stage_row: one lane issues a 1-D TMA bulk copy (cp.async.bulk) of the
//   input row into shared memory, completed on an mbarrier; the lanes
//   zero the output row meanwhile and then wait on the barrier.
// - Reader: a bit reader over the staged words: a 64-bit bit buffer
//   refilled a word at a time, 32 bits at a time to the decoder, and a
//   32-bit position beside it. Words past the row wrap to its
//   start (kRing, inflate_v2's rule) or read as 0 (inflate_static's rule,
//   whose bytes past the stream's end are zeroed after staging).
// - lz_copy: an LZ match copied inside shared memory by the 32 lanes (the
//   kernels copy stored blocks' bytes the same way). Byte k of a match at distance d
//   is byte k % d before the match, so every source byte lies before the
//   match and the lanes copy at once; each lane works out its first
//   source once per match and steps it by 32 % d, with no % per byte.
//   The rounds' control is the same in every lane (no divergence).
// - write_back: the whole output row, zeros and trailer words included,
//   to device memory in 16-byte stores by all lanes (so the wrapper's
//   output needs no zero fill).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sd {

constexpr int IN_WORDS = 16384;              // 64 KiB input row
constexpr int IN_BYTES = IN_WORDS * 4;
constexpr int OUT_WORDS = 16384 + 128;       // output row, trailer included
constexpr int OUT_BYTES = OUT_WORDS * 4;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Stage the input row (IN_BYTES at `src`, 16-byte aligned) into `in` and
// zero the output row `out`; returns when both are done. All 32 lanes
// call it. `bar` is an mbarrier in shared memory, used once.
__device__ __forceinline__ void stage_row(uint32_t* in, uint32_t* out,
                                          const void* src, uint64_t* bar,
                                          int lane) {
  const uint32_t b = smem_addr(bar);
  if (lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
        "r"(static_cast<uint32_t>(IN_BYTES))
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_addr(in)),
        "l"(src), "r"(static_cast<uint32_t>(IN_BYTES)), "r"(b)
        : "memory");
  }
  int4* o = reinterpret_cast<int4*>(out);
  const int4 z = make_int4(0, 0, 0, 0);
  for (int k = lane; k < OUT_BYTES / 16; k += 32) o[k] = z;
  __syncwarp();
  uint32_t done = 0;
  for (int tries = 0; !done; ++tries) {
    if (tries > (1 << 22)) __trap();     // the copy never landed: fail, not hang
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(b), "r"(0u)
        : "memory");
  }
}

// The output row from shared to device memory, 16 bytes a lane per store.
__device__ __forceinline__ void write_back(int32_t* dst, const uint32_t* out,
                                           int lane) {
  __syncwarp();
  const int4* s = reinterpret_cast<const int4*>(out);
  int4* d = reinterpret_cast<int4*>(dst);
  for (int k = lane; k < OUT_BYTES / 16; k += 32) d[k] = s[k];
}

// Bits of the staged row from a 32-bit position `abit`: a 64-bit buffer
// holding the next 32 to 64 bits, refilled a word at a time from a word
// loaded one refill ahead (so no refill waits on a shared-memory load).
template <bool kRing>
struct Reader {
  const uint32_t* in;
  uint32_t abit;     // bits consumed
  uint32_t nw;       // next word to load
  uint64_t buf;      // the bits from abit on, first bit lowest
  uint32_t nbits;    // bits held in buf
  uint32_t next;     // word nw - 1

  __device__ __forceinline__ uint32_t load(uint32_t w) const {
    if (kRing) return in[w & (IN_WORDS - 1)];
    return w < IN_WORDS ? in[w] : 0u;
  }
  __device__ __forceinline__ void seek(uint32_t bit) {
    abit = bit;
    const uint32_t w = bit >> 5;
    buf = ((static_cast<uint64_t>(load(w + 1)) << 32) | load(w)) >> (bit & 31);
    nbits = 64 - (bit & 31);
    next = load(w + 2);
    nw = w + 3;
  }
  // the 32 bits at abit
  __device__ __forceinline__ uint32_t peek() const {
    return static_cast<uint32_t>(buf);
  }
  // n <= 32
  __device__ __forceinline__ void consume(uint32_t n) {
    abit += n;
    buf >>= n;
    nbits -= n;
    if (nbits < 32) {
      buf |= static_cast<uint64_t>(next) << nbits;
      nbits += 32;
      next = load(nw++);
    }
  }
};

// out[op + k] = out[op - dist + k % dist] for k < len (1 <= dist <= op,
// len <= 258): the sources all lie before op, so the lanes copy at once,
// in rounds of 32 bytes whose control is the same in every lane. The
// caller has made every earlier byte visible to all lanes (__syncwarp).
__device__ __forceinline__ void lz_copy(uint8_t* ob, int op, int dist,
                                        int len, int lane) {
  const uint8_t* src = ob + op - dist;
  uint8_t* dst = ob + op;
  if (dist >= len) {
    for (int base = 0; base < len; base += 32)
      if (base + lane < len) dst[base + lane] = src[base + lane];
    return;
  }
  // lane % dist and 32 % dist through a float reciprocal: exact, since
  // (x + 0.5) / dist lies at least 0.5 / 257 from an integer
  const float rd = __frcp_rn(static_cast<float>(dist));
  int s = lane - dist * static_cast<int>((lane + 0.5f) * rd);
  const int step = 32 - dist * static_cast<int>(32.5f * rd);
  for (int base = 0; base < len; base += 32) {
    if (base + lane < len) dst[base + lane] = src[s];
    s += step;
    s -= s >= dist ? dist : 0;
  }
}

}  // namespace sd
