// Block assembly of the device encoder on NVIDIA Hopper (sm_90a): the
// bit-aligned row buffers of a batch of blocks -> each block's DEFLATE
// stream, or its stored form, joined end to end, in one launch.
//
// Replaces the JAX package's host tail of the L1-9 device encoders:
// libdeflate_rsx_tpu/native/assemble.c assemble_rows (the OR-placement
// of the rows, numpy's bitwise_or.at where that library does not build)
// together with the per-block tail that its numpy assemblers write
// (ops/encode_v2.py assemble_blocks, models/greedy_dynamic.py
// assemble_dynamic: header, EOB, SYNC trailer) and the stored fallback
// and join of models/greedy_static.py and greedy_dynamic.py. The plain
// PyTorch versions are ops/assemble.py's place_rows_plain and
// join_rows_plain.
//
// assemble_kernel: one thread block per DEFLATE block.
// - The block's byte count `nb` follows from its end bit, EOB code and
//   final flag, and its stored cost from its raw length, before any byte
//   is built; so is its joined size (the stored cost where the stream is
//   longer). A block past out_cap gets byte count -1 (the wrapper raises).
// - It builds its stream in dynamic shared memory: the words it needs are
//   zeroed, then the header bytes, the rows (their extents staged in
//   shared memory 1,024 rows at a time, then four lanes a row; a word
//   whose four bytes lie inside one row, never its first or last byte,
//   belongs to that row alone and is a plain store, any other word a
//   shared-memory atomicOr, as a row's bits are disjoint from every other
//   row's, so OR equals add), the EOB code and, for a non-final block, the
//   SYNC trailer (an empty stored block, 00 00 FF FF byte-aligned). A
//   stream that cannot fit in shared memory (a block size past ~220 KiB)
//   is built the same way in a global scratch row.
// - Its offset in the joined buffer comes from a single-pass chained scan
//   (decoupled look-back): the thread block takes its block index from an
//   atomic ticket, so its predecessors are resident or done; it publishes
//   its size in a status word at once, then, after the build, reads the
//   running sum back from its predecessors (the nearest inclusive sum and
//   the sizes after it, 32 at a time) and publishes its own inclusive sum.
//   The last thread block to finish clears the ticket, the count and the
//   status words, so every launch starts from zeros with no fill.
// - It then writes its stream into the joined buffer at its offset: the
//   words wholly inside its range as aligned 32-bit stores (a funnel shift
//   of two source words), the two edge words byte by byte. A stored block
//   reads its raw row instead and writes stored blocks of at most 65,535
//   bytes.
// The same kernel serves place_rows (each stream to row b of a (B, pitch)
// buffer, no scan) and join_rows (streams already placed in such a buffer,
// joined as above).
//
// What bounds it on this card: bytes. The rows' bytes that hold bits, the
// rows' offsets and bit starts and the stored blocks' raw bytes are read
// once; the joined streams are written once (a few tens of MB for 259
// blocks of 64 KiB). What the design does about it: the streams never
// round-trip through device memory (no (B, pitch) buffer, no zero fill,
// no second launch, no host sync before the launch); the stream is built
// in shared memory, where the boundary atomics are cheap; the output is
// written as whole aligned words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int GROUP = 4;                   // lanes per row
constexpr int CHUNK = 1024;                // rows whose extents are staged
constexpr int64_t MAX_STORED = 65535;
// a status word: its flag in the top two bits, a size or sum below
enum : unsigned long long {
  AGGREGATE = 1ull << 62,
  INCLUSIVE = 2ull << 62,
  VALUE = (1ull << 62) - 1,
};
constexpr unsigned FULL = 0xFFFFFFFFu;

// The launch's arguments; ops/assemble.py's _Args mirrors this layout.
struct Args {
  const uint8_t* rows;           // (nblocks, nrows, width)
  const int64_t* byte_off;       // (nblocks, nrows)
  const int64_t* row_bit0;       // (nblocks, nrows)
  const int64_t* end_bits;       // (nblocks,)
  const uint8_t* hdr;            // (nblocks, hdr_cap)
  const int32_t* hdr_bits;       // (nblocks,)
  const int32_t* eob;            // (nblocks,) code | len << 16, stride below
  const uint8_t* finals;         // (nblocks,)
  const uint8_t* placed;         // join_rows: row b at b * placed_pitch
  const int64_t* placed_nbytes;  // join_rows: byte counts, -1 past out_cap
  const uint8_t* raw;            // row b at b * raw_stride
  const int32_t* raw_len;        // (nblocks,)
  uint32_t* scratch;             // global build rows of buf_words, or null
  uint8_t* out;                  // place_rows: (nblocks, out_pitch)
  uint8_t* joined;               // join: the joined streams, or null (place)
  unsigned long long* scan;      // join: ticket, count, nblocks status words
  int64_t* info;                 // (2, nblocks): byte counts, joined sizes
  int64_t out_cap;
  int64_t placed_pitch;
  int64_t raw_stride;
  int64_t buf_words;             // words of a block's build buffer
  int64_t out_pitch;
  int64_t eob_stride;            // in elements
  int nblocks;
  int nrows;
  int width;
  int hdr_cap;
};

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t stored_cost(int64_t v) {
  const int64_t chunks = (v + MAX_STORED - 1) / MAX_STORED;
  return v + 5 * (chunks < 1 ? 1 : chunks);
}

__device__ __forceinline__ void or_byte(uint32_t* buf, int64_t x,
                                        uint32_t v) {
  if (v) atomicOr(&buf[x >> 2], v << (8 * (x & 3)));
}

// Byte t of the stored form of raw bytes src[0, v): chunks of at most
// 65,535 bytes, each behind BFINAL|BTYPE=00, LEN and NLEN.
__device__ __forceinline__ uint32_t stored_byte(const uint8_t* src,
                                                int64_t v, bool final,
                                                int64_t t) {
  const int64_t c = t / (MAX_STORED + 5);
  const int64_t q = t - c * (MAX_STORED + 5);
  const int64_t n = imin(v - c * MAX_STORED, MAX_STORED);
  const int64_t nchunks = v > 0 ? (v + MAX_STORED - 1) / MAX_STORED : 1;
  switch (q) {
    case 0: return (final && c == nchunks - 1) ? 1u : 0u;
    case 1: return n & 0xFF;
    case 2: return (n >> 8) & 0xFF;
    case 3: return ~n & 0xFF;
    case 4: return (~n >> 8) & 0xFF;
    default: return src[c * MAX_STORED + q - 5];
  }
}

// joined[off, off + size) = byte(0 .. size): the words wholly inside the
// range as aligned 32-bit stores, the two edge words byte by byte.
template <typename Word, typename Byte>
__device__ __forceinline__ void write_range(uint8_t* joined, int64_t off,
                                            int64_t size, Word word,
                                            Byte byte) {
  if (size <= 0) return;
  const int64_t end = off + size;
  uint32_t* dst = reinterpret_cast<uint32_t*>(joined);
  for (int64_t w = (off >> 2) + threadIdx.x; w <= (end - 1) >> 2;
       w += blockDim.x) {
    const int64_t lo = 4 * w, hi = 4 * w + 4;
    if (lo >= off && hi <= end) {
      dst[w] = word(lo - off);
    } else {
      for (int64_t x = lo > off ? lo : off; x < (hi < end ? hi : end); ++x)
        joined[x] = static_cast<uint8_t>(byte(x - off));
    }
  }
}

// Bytes s .. s + 3 of a word-aligned source, little-endian, as one word.
__device__ __forceinline__ uint32_t word_at(const uint32_t* src, int64_t s) {
  const int sh = static_cast<int>(s & 3);
  const int64_t i = s >> 2;
  return sh ? __funnelshift_r(src[i], src[i + 1], 8 * sh) : src[i];
}

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  return v;
}

// The exclusive sum of the sizes of blocks 0 .. b-1, from their status
// words (warp 0 of the thread block; every status is published, at least
// as an aggregate, as soon as its thread block starts).
__device__ long long look_back(unsigned long long* status, int b) {
  const int lane = threadIdx.x & 31;
  long long excl = 0;
  for (int j = b - 1; j >= 0; j -= 32) {
    const int idx = j - lane;
    unsigned long long s;
    do {
      s = idx >= 0 ? *reinterpret_cast<volatile unsigned long long*>(
                         &status[idx])
                   : INCLUSIVE;
    } while (__any_sync(FULL, (s & ~VALUE) == 0));
    const unsigned incl = __ballot_sync(FULL, (s & ~VALUE) == INCLUSIVE);
    long long v = static_cast<long long>(s & VALUE);
    if (incl) {
      if (lane > __ffs(incl) - 1) v = 0;   // past the nearest inclusive sum
      return excl + warp_sum(v);
    }
    excl += warp_sum(v);
  }
  return excl;
}

__global__ void __launch_bounds__(THREADS)
assemble_kernel(const Args a) {
  extern __shared__ uint32_t smem[];
  __shared__ int s_b, s_over, s_last;
  __shared__ long long s_off;
  __shared__ int64_t s_bit0[CHUNK + 1];    // a chunk's row bit starts,
  __shared__ int32_t s_o[CHUNK];           // then its rows' offsets and
  __shared__ uint16_t s_e[CHUNK];          // extents (0: nothing to place)
  const int tid = threadIdx.x;
  const bool join = a.joined != nullptr;
  if (tid == 0) {
    s_b = join ? static_cast<int>(atomicAdd(&a.scan[0], 1ull))
               : static_cast<int>(blockIdx.x);
    s_over = 0;
  }
  __syncthreads();
  const int b = s_b;

  // the stream's byte count, its stored cost and its joined size
  int64_t nb;
  const bool final = a.finals[b] != 0;
  if (a.placed) {
    nb = a.placed_nbytes[b];
  } else {
    const int64_t total =
        a.end_bits[b] + (static_cast<uint32_t>(a.eob[b * a.eob_stride]) >> 16);
    nb = final ? (total + 7) >> 3 : ((total + 10) >> 3) + 4;
  }
  const int64_t v = join ? a.raw_len[b] : 0;
  const int64_t cost = stored_cost(v);
  const bool past = nb < 0 || nb > a.out_cap;
  const bool stored = join && !past && nb > cost;
  // (a stream longer than the build buffer only comes of a raw length
  // past the raw rows' width, against the wrapper's contract)
  const bool over0 = past || (join && !a.placed && !stored &&
                              ((nb + 3) >> 2) > a.buf_words);
  const int64_t size = over0 ? 0 : (stored ? cost : nb);
  unsigned long long* status = join ? a.scan + 2 : nullptr;
  if (join && tid == 0)
    atomicExch(&status[b], (b == 0 ? INCLUSIVE : AGGREGATE) |
                               static_cast<unsigned long long>(size));

  // the build buffer: shared memory, or a global row past its limit
  uint32_t* buf = a.scratch ? a.scratch + b * a.buf_words : smem;
  const bool build = !a.placed && (join ? !(over0 || stored) : true);
  // words of the buffer in use: the whole row for place_rows, the
  // stream's words for a join
  const int64_t nwords = join ? (nb + 3) >> 2 : a.buf_words;
  if (build)
    for (int64_t w = tid; w < nwords; w += THREADS) buf[w] = 0;
  __syncthreads();

  if (!a.placed && (build || !over0)) {
    // the rows, CHUNK at a time: their extents staged in shared memory
    // (one load round), then GROUP lanes a row place its words
    const int64_t* bit0 = a.row_bit0 + static_cast<int64_t>(b) * a.nrows;
    for (int r0 = 0; r0 < a.nrows; r0 += CHUNK) {
      const int nr = min(CHUNK, a.nrows - r0);
      for (int j = tid; j <= nr; j += THREADS) {   // each bit start once
        const int r = r0 + j;
        s_bit0[j] = r < a.nrows ? bit0[r] : a.end_bits[b];
      }
      __syncthreads();
      for (int j = tid; j < nr; j += THREADS) {
        const int64_t b0 = s_bit0[j];
        int64_t e = imin(a.width, ((b0 & 7) + (s_bit0[j + 1] - b0) + 7) >> 3);
        const int64_t o =
            a.byte_off[static_cast<int64_t>(b) * a.nrows + r0 + j];
        if (e > 0 && o + e > a.out_cap) {
          s_over = 1;
          e = 0;
        }
        s_e[j] = static_cast<uint16_t>(e > 0 ? e : 0);
        s_o[j] = static_cast<int32_t>(o);
      }
      __syncthreads();
      for (int j = tid / GROUP; build && j < nr; j += THREADS / GROUP) {
        const int64_t e = s_e[j], o = s_o[j];
        if (!e) continue;
        const uint8_t* src =
            a.rows + (static_cast<int64_t>(b) * a.nrows + r0 + j) * a.width;
        for (int64_t wi = (o >> 2) + tid % GROUP;
             wi <= (o + e - 1) >> 2 && wi < nwords; wi += GROUP) {
          uint32_t word = 0;
          bool mine = true;
          for (int q = 0; q < 4; ++q) {
            const int64_t k = wi * 4 + q - o;
            if (k >= 0 && k < e) word |= uint32_t(__ldg(src + k)) << (8 * q);
            mine = mine && k >= 1 && k <= e - 2;
          }
          if (mine) buf[wi] = word;
          else if (word) atomicOr(&buf[wi], word);
        }
      }
      __syncthreads();
    }
    if (build) {
      // the header bytes
      const int64_t hb = imin(imin((a.hdr_bits[b] + 7) >> 3, a.hdr_cap),
                              a.out_cap);
      const uint8_t* h = a.hdr + static_cast<int64_t>(b) * a.hdr_cap;
      for (int64_t wi = tid; wi < (hb + 3) >> 2 && wi < nwords;
           wi += THREADS) {
        uint32_t word = 0;
        for (int q = 0; q < 4 && wi * 4 + q < hb; ++q)
          word |= uint32_t(h[wi * 4 + q]) << (8 * q);
        if (word) atomicOr(&buf[wi], word);
      }
      // the EOB code and the SYNC trailer
      if (tid == THREADS - 1 && nb <= a.out_cap) {
        const int64_t end = a.end_bits[b];
        const uint32_t eob = static_cast<uint32_t>(a.eob[b * a.eob_stride]);
        const uint32_t code = eob & 0xFFFFu;
        const int len = eob >> 16;
        const uint64_t ev = uint64_t(code) << (end & 7);
        for (int64_t k = 0; k < (((end & 7) + len + 7) >> 3); ++k)
          or_byte(buf, (end >> 3) + k,
                  static_cast<uint32_t>(ev >> (8 * k)) & 0xFF);
        if (!final) {      // SYNC: empty stored block, LEN 0000 NLEN FFFF
          or_byte(buf, nb - 2, 0xFF);
          or_byte(buf, nb - 1, 0xFF);
        }
      }
    }
  }
  __syncthreads();
  const bool over = over0 || s_over;

  if (!join) {                             // place_rows: row b of out
    uint32_t* row = reinterpret_cast<uint32_t*>(a.out + b * a.out_pitch);
    if (row != buf)
      for (int64_t w = tid; w < a.buf_words; w += THREADS) row[w] = buf[w];
    if (tid == 0) a.info[b] = over ? -1 : nb;
    return;
  }

  if (tid < 32) {
    const long long off = b == 0 ? 0 : look_back(status, b);
    if (tid == 0) {
      if (b)
        atomicExch(&status[b],
                   INCLUSIVE | static_cast<unsigned long long>(off + size));
      s_off = off;
    }
  }
  __syncthreads();
  const int64_t off = s_off;
  if (!over) {
    if (stored) {
      const uint8_t* src = a.raw + b * a.raw_stride;
      auto byte = [&](int64_t t) { return stored_byte(src, v, final, t); };
      write_range(a.joined, off, size,
                  [&](int64_t t) {
                    return byte(t) | byte(t + 1) << 8 | byte(t + 2) << 16 |
                           byte(t + 3) << 24;
                  },
                  byte);
    } else {
      const uint32_t* src =
          a.placed ? reinterpret_cast<const uint32_t*>(a.placed +
                                                       b * a.placed_pitch)
                   : buf;
      write_range(a.joined, off, size,
                  [&](int64_t t) { return word_at(src, t); },
                  [&](int64_t t) {
                    return reinterpret_cast<const uint8_t*>(src)[t];
                  });
    }
  }
  if (tid == 0) {
    a.info[b] = over ? -1 : nb;
    a.info[a.nblocks + b] = size;
  }

  // the last thread block to finish clears the scan state for the next
  // launch: every other one has read its last status word by now
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(&a.scan[1], 1ull) == static_cast<unsigned long long>(
                                               a.nblocks - 1);
  }
  __syncthreads();
  if (s_last) {
    for (int i = tid; i < a.nblocks; i += THREADS) status[i] = 0;
    if (tid == 0) {
      a.scan[0] = 0;
      a.scan[1] = 0;
    }
  }
}

}  // namespace

// Plain C entry points (bound with ctypes).
//
// ldrsx_assemble launches assemble_kernel on `stream` (one thread block
// per block, THREADS threads, buf_words * 4 bytes of dynamic shared
// memory unless `scratch` is given) and returns the launch's CUDA error
// as an int (0 on success). No synchronisation. Modes, by the pointers
// of Args:
// - place_rows (joined null): each block's stream built from its rows
//   into row b of out (nblocks, out_pitch), zero past it; buf_words =
//   out_pitch / 4; scratch may be out itself (built in place); info
//   (nblocks,): byte counts, -1 past out_cap;
// - assemble (joined set, placed null): built from the rows, the stored
//   form where shorter, joined; buf_words >= (the largest non-stored
//   stream + 3) / 4; scan (2 + nblocks) zeros before the first launch,
//   zeros again after each; info (2, nblocks): byte counts (-1 past
//   out_cap) and joined sizes; joined holds at least the sum of the
//   blocks' stored costs;
// - join_rows (joined and placed set): as assemble, from streams placed
//   in rows of placed_pitch bytes (a multiple of 4, 4-byte aligned).
extern "C" int ldrsx_assemble(const void* args, void* stream) {
  const Args a = *static_cast<const Args*>(args);
  if (a.nblocks <= 0) return 0;
  if ((a.out_pitch & 3) || (a.placed_pitch & 3) ||
      (reinterpret_cast<uintptr_t>(a.out) & 3) ||
      (reinterpret_cast<uintptr_t>(a.placed) & 3) ||
      (reinterpret_cast<uintptr_t>(a.joined) & 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t bytes = a.scratch ? 0 : a.buf_words * 4;
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        assemble_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  assemble_kernel<<<a.nblocks, THREADS, static_cast<size_t>(bytes),
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ldrsx_assemble_smem_limit: the dynamic shared memory a thread block of
// assemble_kernel can take on `device` (bytes), or -1 on an error.
extern "C" int ldrsx_assemble_smem_limit(int device) {
  int optin = 0;
  cudaFuncAttributes attr;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, assemble_kernel) != cudaSuccess)
    return -1;
  return optin - static_cast<int>(attr.sharedSizeBytes);
}
