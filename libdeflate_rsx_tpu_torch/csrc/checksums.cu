// CRC-32 (gzip) and Adler-32 (zlib) on NVIDIA Hopper (sm_90a): of the
// zero-padded rows of a batch, or of one buffer continuing from an initial
// value.
//
// Replaces the JAX package's device checksums (libdeflate_rsx_tpu/ops/
// checksums.py: crc32_fixed, crc32_blocks, adler32_fixed, adler32_blocks),
// which formulate both as float matmuls for the TPU's matrix unit: the
// CRC's GF(2) product of the message's bits against an (8 x 1,024, 32) 0/1
// matrix, Adler's sums as a dot product against [ones, arange] over 128-byte
// chunks. This kernel computes the same functions with integer arithmetic
// and carries over none of that formulation. Its plain PyTorch versions are
// ops/checksums.py's crc32_fixed_plain, crc32_blocks_plain,
// adler32_fixed_plain and adler32_blocks_plain.
//
// What bounds it on this card: bytes. The work is a few operations a byte,
// so reading the input once is the least it can take: 0.005056 ms for the
// 16,939,108 bytes of a 16,936,000-byte corpus's 259 rows of 64 KiB (the
// rows, the int32 lengths, the int64 registers) at 3.35 TB/s. What the
// design does about it:
// - every byte is read once, with 16-byte loads wherever the address is
//   aligned, 8 of them in flight a thread, each thread over a contiguous
//   span of its row (a row's width over 256 threads), cut at the row's
//   length: the zero padding past a length is not read, so it needs no
//   correction;
// - CRC-32 by slice-by-8: the register of each 8 bytes from 8 lookups in
//   8 tables of 256 words in shared memory (8 KiB), built at block start;
//   Adler-32 by the running sums s1 += d, s2 += s1 in 32 bits, reduced mod
//   65,521 every 256 16-byte groups (below 2^32 in between: at most
//   4,238 bytes with the head, the last single groups and the tail);
// - the spans' results fold in order, within a warp by shuffles and then
//   across the warps through shared memory: CRC registers by
//   combine(a, b, len_b) = x^(8 len_b) a + b mod P (zlib's multmodp and
//   x2nmodp, with x^(2^k) mod P for k < 32 in constant memory: it repeats
//   with period 32), Adler sums by s1 = s1a + s1b, s2 = s2a + len_b s1a +
//   s2b mod 65,521;
// - a row's initial CRC register starts its first thread's span, so the
//   fold ends at the row's register with no shift past the whole row;
// - one buffer runs as rows of 64 KiB, the last one short, each row's raw
//   register written out; a one-block launch folds them in order and
//   applies the initial value (the CRC's shifted initial register taken
//   on the host) and the final XOR. Sizes and offsets are 64-bit.
// A launch allocates nothing and does not synchronise; each C entry returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW_THREADS = 256;       // threads a row
constexpr int FOLD_THREADS = 256;      // threads of the one-block fold
constexpr int64_t BUFFER_ROW = 65536;  // bytes a row of one buffer
constexpr uint32_t POLY = 0xEDB88320u; // reflected CRC-32 polynomial
constexpr uint32_t MOD = 65521u;       // Adler-32 modulus
constexpr int ADLER_GROUPS = 256;      // 16-byte groups between mod steps
constexpr int BATCH = 8;               // 16-byte loads in flight a thread
constexpr int CRC = 0, ADLER = 1;
constexpr int64_t MAX_ROWS = 0x7FFFFFFF;  // the grid's x limit

// x^(2^k) mod P, reflected (zlib's x2n_table): x^(2^32) = x mod P. One
// copy in constant memory for the kernels, one for the host.
#define X2N_VALUES                                                        \
  0x40000000u, 0x20000000u, 0x08000000u, 0x00800000u, 0x00008000u,        \
      0xedb88320u, 0xb1e6b092u, 0xa06a2517u, 0xed627daeu, 0x88d14467u,    \
      0xd7bbfe6au, 0xec447f11u, 0x8e7ea170u, 0x6427800eu, 0x4d47bae0u,    \
      0x09fe548fu, 0x83852d0fu, 0x30362f1au, 0x7b5a9cc3u, 0x31fec169u,    \
      0x9fec022au, 0x6c8dedc4u, 0x15d6874du, 0x5fde7a4eu, 0xbad90e37u,    \
      0x2e4e5eefu, 0x4eaba214u, 0xa8a472c0u, 0x429a969eu, 0x148d302au,    \
      0xc40ba6d0u, 0xc4e22c3cu
__constant__ uint32_t X2N[32] = {X2N_VALUES};
const uint32_t X2N_HOST[32] = {X2N_VALUES};

__host__ __device__ __forceinline__ uint32_t x2n(int k) {
#ifdef __CUDA_ARCH__
  return X2N[k & 31];
#else
  return X2N_HOST[k & 31];
#endif
}

// a * b mod P, reflected (bit 31 is x^0)
__host__ __device__ __forceinline__ uint32_t multmodp(uint32_t a,
                                                      uint32_t b) {
  uint32_t p = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    p ^= b & (0u - ((a >> (31 - i)) & 1u));
    b = (b >> 1) ^ (POLY & (0u - (b & 1u)));
  }
  return p;
}

// x^(8 n) mod P: the operator that moves a register past n zero bytes;
// a product over n's set bits, the first one taken from the table as it
// is (a power of two costs no multiplication)
__host__ __device__ __forceinline__ uint32_t x8nmodp(int64_t n) {
  uint32_t p = 0x80000000u;
  bool first = true;
  for (int k = 3; n; n >>= 1, ++k) {
#ifdef __CUDA_ARCH__
    const int z = __ffsll(n) - 1;
#else
    const int z = __builtin_ctzll(static_cast<unsigned long long>(n));
#endif
    n >>= z;
    k += z;
    p = first ? x2n(k) : multmodp(x2n(k), p);
    first = false;
  }
  return p;
}

// A piece of a message: CRC (a: zero-init register) or Adler (a: s1,
// b: s2 of a zero start, both reduced), and its length in bytes. The
// empty piece {0, 0, 0} is the fold's identity.
struct Part {
  uint32_t a, b;
  int64_t len;
};

template <int KIND>
__device__ __forceinline__ Part combine(const Part& x, const Part& y) {
  Part r;
  r.len = x.len + y.len;
  if constexpr (KIND == CRC) {
    r.a = (y.len ? multmodp(x8nmodp(y.len), x.a) : x.a) ^ y.a;
    r.b = 0;
  } else {
    r.a = (x.a + y.a) % MOD;
    r.b = static_cast<uint32_t>(
        (static_cast<uint64_t>(x.b) + y.b +
         static_cast<uint64_t>(y.len % MOD) * x.a) % MOD);
  }
  return r;
}

// In order over the warp's lanes; lane 0 holds the result.
template <int KIND>
__device__ __forceinline__ Part warp_fold(Part p) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    Part q;
    q.a = __shfl_down_sync(0xFFFFFFFFu, p.a, off);
    q.b = __shfl_down_sync(0xFFFFFFFFu, p.b, off);
    q.len = __shfl_down_sync(0xFFFFFFFFu, p.len, off);
    if ((lane & (2 * off - 1)) == 0) p = combine<KIND>(p, q);
  }
  return p;
}

// In order over the block's threads; thread 0 holds the result.
template <int KIND, int THREADS>
__device__ __forceinline__ Part block_fold(Part p, Part* warps) {
  p = warp_fold<KIND>(p);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warps[warp] = p;
  __syncthreads();
  if (warp == 0) {
    p = lane < THREADS / 32 ? warps[lane] : Part{0, 0, 0};
    p = warp_fold<KIND>(p);
  }
  return p;
}

__device__ __forceinline__ uint32_t crc_byte(const uint32_t (*t)[256],
                                             uint32_t c, uint32_t d) {
  return t[0][(c ^ d) & 0xFF] ^ (c >> 8);
}

// slice-by-8: the register after the 8 bytes of the words lo, hi
__device__ __forceinline__ uint32_t crc_8(const uint32_t (*t)[256],
                                          uint32_t c, uint32_t lo,
                                          uint32_t hi) {
  c ^= lo;
  return t[7][c & 0xFF] ^ t[6][(c >> 8) & 0xFF] ^ t[5][(c >> 16) & 0xFF] ^
         t[4][c >> 24] ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^
         t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
}

__device__ __forceinline__ void adler_word(uint32_t& s1, uint32_t& s2,
                                           uint32_t w) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s1 += (w >> (8 * k)) & 0xFF;
    s2 += s1;
  }
}

// One 16-byte group into the CRC register or the Adler sums.
template <int KIND>
__device__ __forceinline__ void group(const uint32_t (*t)[256], uint32_t& c,
                                      uint32_t& s1, uint32_t& s2,
                                      const uint4& w) {
  if constexpr (KIND == CRC) {
    c = crc_8(t, c, w.x, w.y);
    c = crc_8(t, c, w.z, w.w);
  } else {
    adler_word(s1, s2, w.x);
    adler_word(s1, s2, w.y);
    adler_word(s1, s2, w.z);
    adler_word(s1, s2, w.w);
  }
}

// The Adler sums reduced once ADLER_GROUPS groups have been added.
template <int KIND>
__device__ __forceinline__ void adler_mod(int& groups, int added,
                                          uint32_t& s1, uint32_t& s2) {
  if constexpr (KIND == ADLER) {
    groups += added;
    if (groups >= ADLER_GROUPS) {
      groups = 0;
      s1 %= MOD;
      s2 %= MOD;
    }
  }
}

// The part of bytes [begin, end) of p, the CRC register starting at c:
// single bytes up to a 16-byte
// boundary, batches of BATCH 16-byte loads issued together, then single
// 16-byte groups, then single bytes.
template <int KIND>
__device__ Part span_part(const uint8_t* __restrict__ p, int64_t begin,
                          int64_t end, const uint32_t (*t)[256],
                          uint32_t c) {
  uint32_t s1 = 0, s2 = 0;
  int64_t i = begin;
  for (; i < end && (reinterpret_cast<uintptr_t>(p + i) & 15); ++i) {
    if constexpr (KIND == CRC) {
      c = crc_byte(t, c, p[i]);
    } else {
      s1 += p[i];
      s2 += s1;
    }
  }
  int groups = 0;
  for (; i + 16 * BATCH <= end; i += 16 * BATCH) {
    uint4 w[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      w[k] = __ldg(reinterpret_cast<const uint4*>(p + i) + k);
#pragma unroll
    for (int k = 0; k < BATCH; ++k) group<KIND>(t, c, s1, s2, w[k]);
    adler_mod<KIND>(groups, BATCH, s1, s2);
  }
  for (; i + 16 <= end; i += 16) {
    group<KIND>(t, c, s1, s2, __ldg(reinterpret_cast<const uint4*>(p + i)));
    adler_mod<KIND>(groups, 1, s1, s2);
  }
  for (; i < end; ++i) {
    if constexpr (KIND == CRC) {
      c = crc_byte(t, c, p[i]);
    } else {
      s1 += p[i];
      s2 += s1;
    }
  }
  const int64_t len = end > begin ? end - begin : 0;
  if constexpr (KIND == CRC) return Part{c, 0, len};
  return Part{s1 % MOD, s2 % MOD, len};
}

// One block a row: row r is data[r * stride ...] and its length
// lengths[r] (else total - r * stride), cut to [0, width]. out[r] is the
// row's CRC-32 (init and final XOR 0xFFFFFFFF) or Adler-32 (init 1); with
// raw, its zero-init register or its (s2 << 16 | s1) from zero.
template <int KIND>
__global__ void __launch_bounds__(ROW_THREADS)
    rows_kernel(const uint8_t* __restrict__ data, int64_t stride,
                int64_t width, const int64_t* __restrict__ lengths,
                int64_t total, int raw, int64_t* __restrict__ out) {
  __shared__ uint32_t tab[KIND == CRC ? 8 : 1][256];
  __shared__ Part warps[ROW_THREADS / 32];
  const int64_t row = blockIdx.x;
  int64_t len = lengths ? lengths[row] : total - row * stride;
  len = len < 0 ? 0 : (len > width ? width : len);
  if constexpr (KIND == CRC) {
    for (int v = threadIdx.x; v < 256; v += ROW_THREADS) {
      uint32_t r = v;
#pragma unroll
      for (int k = 0; k < 8; ++k) r = (r >> 1) ^ (POLY & (0u - (r & 1u)));
      tab[0][v] = r;
    }
    __syncthreads();
    for (int v = threadIdx.x; v < 256; v += ROW_THREADS) {
      uint32_t r = tab[0][v];
#pragma unroll
      for (int k = 1; k < 8; ++k) {
        r = (r >> 8) ^ tab[0][r & 0xFF];
        tab[k][v] = r;
      }
    }
    __syncthreads();
  }
  const int64_t span = (width + ROW_THREADS - 1) / ROW_THREADS;
  const int64_t b0 = threadIdx.x * span;
  const int64_t begin = b0 < len ? b0 : len;
  const int64_t end = b0 + span < len ? b0 + span : len;
  // thread 0's span starts from the row's initial register, so the fold
  // gives the row's register with no shift past the whole row
  const uint32_t c0 = KIND == CRC && !raw && threadIdx.x == 0 ? 0xFFFFFFFFu
                                                              : 0u;
  Part p = span_part<KIND>(data + row * stride, begin, end, tab, c0);
  p = block_fold<KIND, ROW_THREADS>(p, warps);
  if (threadIdx.x != 0) return;
  int64_t v;
  if constexpr (KIND == CRC) {
    v = raw ? p.a : p.a ^ 0xFFFFFFFFu;
  } else if (raw) {
    v = static_cast<int64_t>(p.b) << 16 | p.a;
  } else {
    const uint32_t s1 = (1 + p.a) % MOD;
    const uint32_t s2 = static_cast<uint32_t>((p.b + len % MOD) % MOD);
    v = static_cast<int64_t>(s2) << 16 | s1;
  }
  out[row] = v;
}

// One block: the rows' raw registers of one buffer of `total` bytes
// (rows of BUFFER_ROW bytes, the last one short) folded in order, then
// the initial value applied: out[0] is the buffer's CRC-32 or Adler-32
// continuing from it. `init` is the Adler value, or for the CRC the
// initial register's term, x^(8 total) (init ^ 0xFFFFFFFF) mod P, taken
// on the host.
template <int KIND>
__global__ void __launch_bounds__(FOLD_THREADS)
    fold_kernel(const int64_t* __restrict__ regs, int64_t rows,
                int64_t total, uint32_t init, int64_t* __restrict__ out) {
  __shared__ Part warps[FOLD_THREADS / 32];
  const int64_t per = (rows + FOLD_THREADS - 1) / FOLD_THREADS;
  const int64_t r0 = threadIdx.x * per;
  const int64_t r1 = r0 + per < rows ? r0 + per : rows;
  Part acc{0, 0, 0};
  for (int64_t r = r0; r < r1; ++r) {
    const int64_t left = total - r * BUFFER_ROW;
    const uint32_t v = static_cast<uint32_t>(regs[r]);
    const Part q{KIND == CRC ? v : (v & 0xFFFF), KIND == CRC ? 0 : (v >> 16),
                 left < BUFFER_ROW ? left : BUFFER_ROW};
    acc = r == r0 ? q : combine<KIND>(acc, q);
  }
  acc = block_fold<KIND, FOLD_THREADS>(acc, warps);
  if (threadIdx.x != 0) return;
  if constexpr (KIND == CRC) {
    out[0] = init ^ acc.a ^ 0xFFFFFFFFu;
  } else {
    const uint64_t s1_in = init & 0xFFFF, s2_in = init >> 16;
    const uint64_t s1 = (s1_in + acc.a) % MOD;
    const uint64_t s2 =
        (s2_in + static_cast<uint64_t>(total % MOD) * s1_in + acc.b) % MOD;
    out[0] = static_cast<int64_t>(s2 << 16 | s1);
  }
}

}  // namespace

// kind 0: CRC-32, 1: Adler-32, of each of `rows` rows of `width` bytes,
// row r at data + r * stride, cut at lengths[r] (int64): out (rows,)
// int64.
extern "C" int ldrsx_checksum_rows(int kind, const void* data,
                                   int64_t stride, int64_t rows,
                                   int64_t width, const void* lengths,
                                   void* out, void* stream) {
  if (rows <= 0) return 0;
  if ((kind != CRC && kind != ADLER) || rows > MAX_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const uint8_t*>(data);
  const auto* n = static_cast<const int64_t*>(lengths);
  auto* o = static_cast<int64_t*>(out);
  const dim3 grid(static_cast<unsigned>(rows));
  if (kind == CRC)
    rows_kernel<CRC><<<grid, ROW_THREADS, 0, s>>>(d, stride, width, n, 0, 0, o);
  else
    rows_kernel<ADLER><<<grid, ROW_THREADS, 0, s>>>(d, stride, width, n, 0, 0,
                                                    o);
  return static_cast<int>(cudaGetLastError());
}

// kind 0: CRC-32, 1: Adler-32, of data[:length] continuing from init:
// out () int64; scratch holds ceil(length / 65,536) int64 row registers.
extern "C" int ldrsx_checksum_buffer(int kind, const void* data,
                                     int64_t length, uint32_t init,
                                     void* scratch, void* out, void* stream) {
  const int64_t rows = length > 0 ? (length + BUFFER_ROW - 1) / BUFFER_ROW : 0;
  if ((kind != CRC && kind != ADLER) || rows <= 0 || rows > MAX_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const uint8_t*>(data);
  auto* regs = static_cast<int64_t*>(scratch);
  auto* o = static_cast<int64_t*>(out);
  const dim3 grid(static_cast<unsigned>(rows));
  if (kind == CRC) {
    rows_kernel<CRC><<<grid, ROW_THREADS, 0, s>>>(d, BUFFER_ROW, BUFFER_ROW,
                                                  nullptr, length, 1, regs);
    const uint32_t term = multmodp(x8nmodp(length), init ^ 0xFFFFFFFFu);
    fold_kernel<CRC><<<1, FOLD_THREADS, 0, s>>>(regs, rows, length, term, o);
  } else {
    rows_kernel<ADLER><<<grid, ROW_THREADS, 0, s>>>(
        d, BUFFER_ROW, BUFFER_ROW, nullptr, length, 1, regs);
    fold_kernel<ADLER><<<1, FOLD_THREADS, 0, s>>>(regs, rows, length, init,
                                                  o);
  }
  return static_cast<int>(cudaGetLastError());
}
