// Block assembly of the device encoder on NVIDIA Hopper (sm_90a): the
// bit-aligned row buffers of a batch of blocks -> each block's DEFLATE
// stream, then the streams (or their stored form) joined end to end.
//
// Replaces the JAX package's host tail of the L1-9 device encoders:
// libdeflate_rsx_tpu/native/assemble.c assemble_rows (the OR-placement
// of the rows, numpy's bitwise_or.at where that library does not build)
// together with the per-block tail that its numpy assemblers write
// (ops/encode_v2.py assemble_blocks, models/greedy_dynamic.py
// assemble_dynamic: header, EOB, SYNC trailer) and the stored fallback
// and join of models/greedy_static.py and greedy_dynamic.py. The plain
// PyTorch version of both kernels is ops/assemble.py's place_rows_plain
// and join_rows_plain.
//
// place_kernel: one warp per (block, row), and one more warp per block
// for its header, EOB and trailer. A row's bits are disjoint from every
// other row's, so only a row's first and last byte (and the header's
// last byte, the EOB's first) can be shared with a neighbour, and OR
// equals add there. A warp's lane builds one aligned 32-bit word of the
// output from the row: a word whose four bytes are all inside the row
// (never its first or last byte) belongs to this row alone and is a plain
// store; any other word is an atomicOr of the row's bytes in it (there
// are no byte atomics). No word is written both ways. A block whose
// stream would pass out_cap sets its status and writes nothing past it.
//
// join_kernel: one grid row per block; each thread writes bytes of the
// joined buffer at the block's offset: the assembled stream, or, for a
// block whose stream is longer than its stored form, stored blocks of at
// most 65,535 bytes read from the block's raw bytes.
//
// What bounds them on this card: bytes (the rows are read once and the
// streams written once; a few tens of MB for 259 blocks of 64 KiB). What
// the design does about it: lanes read neighbouring row bytes and write
// whole words, atomics only on a row's two boundary words, no pass over
// the output other than the zero fill.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int64_t MAX_STORED = 65535;

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ void or_byte(uint32_t* words, int64_t x,
                                        uint32_t v) {
  if (v) atomicOr(&words[x >> 2], v << (8 * (x & 3)));
}

__global__ void __launch_bounds__(32 * WARPS)
place_kernel(const uint8_t* __restrict__ rows,
             const int64_t* __restrict__ byte_off,
             const int64_t* __restrict__ row_bit0,
             const int64_t* __restrict__ end_bits,
             const uint8_t* __restrict__ hdr,
             const int32_t* __restrict__ hdr_bits,
             const int32_t* __restrict__ eob,
             const uint8_t* __restrict__ finals, int nblocks, int nrows,
             int width, int hdr_cap, int64_t out_cap, int64_t pitch,
             uint32_t* __restrict__ out, int64_t* __restrict__ nbytes,
             int32_t* __restrict__ status) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * WARPS +
                    (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (g >= static_cast<int64_t>(nblocks) * (nrows + 1)) return;
  const int b = static_cast<int>(g / (nrows + 1));
  const int r = static_cast<int>(g % (nrows + 1));
  uint32_t* words = out + b * (pitch >> 2);
  if (r < nrows) {
    const int64_t i = static_cast<int64_t>(b) * nrows + r;
    const int64_t b0 = row_bit0[i];
    const int64_t nxt = r + 1 < nrows ? row_bit0[i + 1] : end_bits[b];
    const int64_t e =
        imin(width, ((b0 & 7) + (nxt - b0) + 7) >> 3);
    if (e <= 0) return;
    const int64_t o = byte_off[i];
    if (o + e > out_cap) {
      if (lane == 0) atomicOr(&status[b], 1);
      return;
    }
    const uint8_t* src = rows + i * width;
    for (int64_t wi = (o >> 2) + lane; wi <= (o + e - 1) >> 2; wi += 32) {
      uint32_t v = 0;
      bool mine = true;
      for (int q = 0; q < 4; ++q) {
        const int64_t k = wi * 4 + q - o;
        if (k >= 0 && k < e) v |= uint32_t(src[k]) << (8 * q);
        mine = mine && k >= 1 && k <= e - 2;
      }
      if (mine) words[wi] = v;
      else if (v) atomicOr(&words[wi], v);
    }
    return;
  }
  // the block's own warp: header bytes, EOB code, trailer, byte count
  const int hb = (hdr_bits[b] + 7) >> 3;
  for (int j = lane; j < hb && j < hdr_cap && j < out_cap; j += 32)
    or_byte(words, j, hdr[static_cast<int64_t>(b) * hdr_cap + j]);
  if (lane != 0) return;
  const int64_t end = end_bits[b];
  const uint32_t code = static_cast<uint32_t>(eob[b]) & 0xFFFFu;
  const int len = static_cast<uint32_t>(eob[b]) >> 16;
  const int64_t total = end + len;
  const int64_t nb = finals[b] ? (total + 7) >> 3 : ((total + 10) >> 3) + 4;
  if (nb > out_cap) {
    atomicOr(&status[b], 1);
    nbytes[b] = nb;
    return;
  }
  const uint64_t v = uint64_t(code) << (end & 7);
  for (int64_t k = 0; k < (((end & 7) + len + 7) >> 3); ++k)
    or_byte(words, (end >> 3) + k, static_cast<uint32_t>(v >> (8 * k)) & 0xFF);
  if (!finals[b]) {          // SYNC: empty stored block, LEN 0000 NLEN FFFF
    or_byte(words, nb - 2, 0xFF);
    or_byte(words, nb - 1, 0xFF);
  }
  nbytes[b] = nb;
}

__global__ void join_kernel(const uint8_t* __restrict__ out, int64_t pitch,
                            const int64_t* __restrict__ sizes,
                            const int64_t* __restrict__ offsets,
                            const uint8_t* __restrict__ stored,
                            const uint8_t* __restrict__ raw,
                            int64_t raw_stride,
                            const int64_t* __restrict__ raw_len,
                            const uint8_t* __restrict__ finals, int nblocks,
                            uint8_t* __restrict__ joined) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  for (int b = blockIdx.y; b < nblocks; b += gridDim.y) {
    const int64_t size = sizes[b];
    uint8_t* dst = joined + offsets[b];
    if (!stored[b]) {
      const uint8_t* src = out + b * pitch;
      for (int64_t t = t0; t < size; t += step) dst[t] = src[t];
      continue;
    }
    const int64_t v = raw_len[b];
    const int64_t nchunks = v > 0 ? (v + MAX_STORED - 1) / MAX_STORED : 1;
    const uint8_t* src = raw + b * raw_stride;
    for (int64_t t = t0; t < size; t += step) {
      const int64_t c = t / (MAX_STORED + 5);
      const int64_t q = t - c * (MAX_STORED + 5);
      const int64_t n = imin(v - c * MAX_STORED, MAX_STORED);
      uint8_t byte;
      if (q == 0) byte = (finals[b] && c == nchunks - 1) ? 1 : 0;
      else if (q == 1) byte = n & 0xFF;
      else if (q == 2) byte = (n >> 8) & 0xFF;
      else if (q == 3) byte = ~n & 0xFF;
      else if (q == 4) byte = (~n >> 8) & 0xFF;
      else byte = src[c * MAX_STORED + q - 5];
      dst[t] = byte;
    }
  }
}

}  // namespace

// Plain C entry points (bound with ctypes). Launch on `stream` and return
// the launch's CUDA error as an int (0 on success). No synchronisation.
//
// ldrsx_place_rows: rows (nblocks, nrows, width) uint8, byte_off and
// row_bit0 (nblocks, nrows) int64, end_bits (nblocks,) int64, hdr
// (nblocks, hdr_cap) uint8, hdr_bits and eob (nblocks,) int32 (eob: code
// | len << 16), finals (nblocks,) uint8; out (nblocks, pitch) uint8,
// zero-filled, pitch a multiple of 4 and >= out_cap, 4-byte aligned;
// nbytes (nblocks,) int64, written; status (nblocks,) int32, zero-filled,
// set to 1 for a block whose stream passes out_cap.
extern "C" int ldrsx_place_rows(const void* rows, const void* byte_off,
                                const void* row_bit0, const void* end_bits,
                                const void* hdr, const void* hdr_bits,
                                const void* eob, const void* finals,
                                int nblocks, int nrows, int width,
                                int hdr_cap, int64_t out_cap, int64_t pitch,
                                void* out, void* nbytes, void* status,
                                void* stream) {
  if (nblocks <= 0) return 0;
  if ((pitch & 3) || (reinterpret_cast<uintptr_t>(out) & 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t warps = static_cast<int64_t>(nblocks) * (nrows + 1);
  const int64_t grid = (warps + WARPS - 1) / WARPS;
  place_kernel<<<static_cast<unsigned>(grid), 32 * WARPS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rows), static_cast<const int64_t*>(byte_off),
      static_cast<const int64_t*>(row_bit0),
      static_cast<const int64_t*>(end_bits), static_cast<const uint8_t*>(hdr),
      static_cast<const int32_t*>(hdr_bits), static_cast<const int32_t*>(eob),
      static_cast<const uint8_t*>(finals), nblocks, nrows, width, hdr_cap,
      out_cap, pitch, static_cast<uint32_t*>(out),
      static_cast<int64_t*>(nbytes), static_cast<int32_t*>(status));
  return static_cast<int>(cudaGetLastError());
}

// ldrsx_join_rows: out (nblocks, pitch) uint8 from ldrsx_place_rows;
// sizes, offsets (nblocks,) int64: each block's joined size and its
// exclusive scan; stored, finals (nblocks,) uint8; raw: each block's raw
// bytes, row b at raw + b * raw_stride, raw_len (nblocks,) int64 of them;
// joined: sum(sizes) bytes, every one of which is written. max_size is
// the largest size (it sets the grid).
extern "C" int ldrsx_join_rows(const void* out, int64_t pitch,
                               const void* sizes, const void* offsets,
                               const void* stored, const void* raw,
                               int64_t raw_stride, const void* raw_len,
                               const void* finals, int nblocks,
                               int64_t max_size, void* joined, void* stream) {
  if (nblocks <= 0 || max_size <= 0) return 0;
  const int threads = 256;
  const int64_t tiles = (max_size + threads * 4 - 1) / (threads * 4);
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(nblocks < 65535 ? nblocks : 65535));
  join_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(out), pitch,
      static_cast<const int64_t*>(sizes), static_cast<const int64_t*>(offsets),
      static_cast<const uint8_t*>(stored), static_cast<const uint8_t*>(raw),
      raw_stride, static_cast<const int64_t*>(raw_len),
      static_cast<const uint8_t*>(finals), nblocks,
      static_cast<uint8_t*>(joined));
  return static_cast<int>(cudaGetLastError());
}
