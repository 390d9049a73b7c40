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
// rows, the int32 lengths, the int64 registers) at 3.35 TB/s.
//
// CRC-32 (crc_kernel). What the design does about the bound:
// - a persistent grid, one 1,024-thread block an SM (min(work, SMs)
//   blocks), each block taking steps blockIdx.x + k gridDim.x; a step is
//   a tile of 65,536 bytes of one row (a row wider than that takes a step
//   a tile, in order), or as many whole rows of a narrower width as fit
//   1,024 threads at 64 bytes each;
// - every thread hashes one 64-byte span: four 16-byte loads where the
//   span is whole and aligned (else 4-byte words and single bytes), cut
//   at the row's length, so the padding is not read; the first step's
//   loads go out before the tables are built, a later step's as soon as
//   the step before it is hashed, into the same registers (held a step
//   ahead, they spill at the 64 registers a thread of 1,024 threads, and
//   the spills wait for the loads);
// - slice-by-4 with a copy of the four 256-word tables for each lane in
//   dynamic shared memory (128 KiB), laid out so that lane l always
//   reads bank l: one lookup a byte and no bank conflict, each a PRMT, an
//   IMAD and a shared load with the table's offset as its immediate. A
//   block builds its tables once (an entry a thread, stored out with
//   16-byte stores that also meet no conflict);
// - the spans fold with one multiplication each: a row's spans start at
//   multiples of 64, so the shift from the end of whole span j to the end
//   of the row's last whole span (J of them) is x^(512 (J - 1 - j)), taken
//   from a table computed at compile time and copied to shared memory;
//   every thread applies its own at once, the product by 16 integer
//   multiplications of masked operands and the tables' shift by 4 zero
//   bytes (no bit-serial loop), the registers are XORed (shuffles in each
//   half warp, then shared memory atomics), and one thread applies the
//   tail shift x^(8 r) for the r bytes of the row's last, partial span
//   and adds that span's register.
//   The row's initial register 0xFFFFFFFF starts the span that holds byte
//   0. A row wider than a tile carries its register from tile to tile
//   (x^(8 65,536) a tile: one multiplication);
// - one buffer is rows of 65,536 bytes in the same launch: each row but
//   the last is moved to the end of the next-to-last by x^(8 65,536 m)
//   (a product of two table entries for m below 65,536) and XORed into
//   one word by atomicXor, the last row's register into another; the
//   block that finishes last (a __threadfence and a counter) shifts the
//   sum past the last row, adds the initial value's term (taken on the
//   host) and the final XOR, and leaves the three words zeroed for the
//   next launch. XOR is order-free, so the result is exact whatever the
//   order the blocks finish in.
//
// Adler-32 (adler_rows_kernel, adler_fold_kernel): a 256-thread block a
// row, each thread over a contiguous span (a row's width over 256
// threads) with the running sums s1 += d, s2 += s1 in 32 bits, reduced
// mod 65,521 every 256 16-byte groups (below 2^32 in between: at most
// 4,238 bytes with the head, the last single groups and the tail), 16-byte
// loads where aligned, 8 in flight a thread; the spans fold in order
// within a warp by shuffles and across the warps through shared memory by
// s1 = s1a + s1b, s2 = s2a + len_b s1a + s2b mod 65,521. One buffer is
// rows of 64 KiB whose sums a one-block launch folds in order, applying
// the initial value. Sizes and offsets are 64-bit.
//
// A launch allocates nothing and does not synchronise; each C entry returns
// the launch's error code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t POLY = 0xEDB88320u; // reflected CRC-32 polynomial
constexpr uint32_t ONE = 0x80000000u;  // x^0, reflected (bit 31 is x^0)
constexpr uint32_t X8 = 0x00800000u;   // x^8
constexpr int CRC = 0, ADLER = 1;
constexpr int64_t MAX_ROWS = 0x7FFFFFFF;  // the grid's x limit

// -- CRC-32 -----------------------------------------------------------------

constexpr int CRC_THREADS = 1024;           // threads a block, one an SM
constexpr int SPAN = 64;                    // bytes a thread's span
constexpr int TILE = CRC_THREADS * SPAN;    // bytes a step of a wide row
constexpr int HALF = 16;                    // threads a row come in these
constexpr int MAX_GROUP = CRC_THREADS / HALF;  // rows a step, at most
constexpr int CRC_SMEM = 4 * 256 * 32 * 4;  // slice-by-4, a copy a lane

// x^(2^k) mod P, reflected (zlib's x2n_table): x^(2^32) = x mod P. For
// shifts past the tables below and the host's initial-value term.
#define X2N_VALUES                                                        \
  0x40000000u, 0x20000000u, 0x08000000u, 0x00800000u, 0x00008000u,        \
      0xedb88320u, 0xb1e6b092u, 0xa06a2517u, 0xed627daeu, 0x88d14467u,    \
      0xd7bbfe6au, 0xec447f11u, 0x8e7ea170u, 0x6427800eu, 0x4d47bae0u,    \
      0x09fe548fu, 0x83852d0fu, 0x30362f1au, 0x7b5a9cc3u, 0x31fec169u,    \
      0x9fec022au, 0x6c8dedc4u, 0x15d6874du, 0x5fde7a4eu, 0xbad90e37u,    \
      0x2e4e5eefu, 0x4eaba214u, 0xa8a472c0u, 0x429a969eu, 0x148d302au,    \
      0xc40ba6d0u, 0xc4e22c3cu
__constant__ uint32_t X2N[32] = {X2N_VALUES};
#ifndef __CUDA_ARCH__
const uint32_t X2N_HOST[32] = {X2N_VALUES};
#endif

__host__ __device__ __forceinline__ uint32_t x2n(int k) {
#ifdef __CUDA_ARCH__
  return X2N[k & 31];
#else
  return X2N_HOST[k & 31];
#endif
}

// a * b mod P, reflected
__host__ __device__ __forceinline__ constexpr uint32_t multmodp(uint32_t a,
                                                                uint32_t b) {
  uint32_t p = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    p ^= b & (0u - ((a >> (31 - i)) & 1u));
    b = (b >> 1) ^ (POLY & (0u - (b & 1u)));
  }
  return p;
}

// x^(8 n) mod P: the operator that moves a register past n zero bytes, a
// product over n's set bits (the initial value's term, on the host)
uint32_t x8nmodp(int64_t n) {
  uint32_t p = ONE;
  for (int k = 3; n; n >>= 1, ++k)
    if (n & 1) p = multmodp(x2n(k), p);
  return p;
}

// The shift operators, computed at compile time.
struct Ops {
  uint32_t span[TILE / SPAN + 1];  // x^(8 SPAN d), d = 0 .. TILE / SPAN
  uint32_t tail[SPAN];             // x^(8 r), r < SPAN
  uint32_t row_lo[256];            // x^(8 TILE m), m < 256
  uint32_t row_hi[256];            // x^(8 TILE 256 m), m < 256
};

__host__ __device__ constexpr Ops make_ops() {
  Ops o{};
  o.tail[0] = ONE;
  for (int r = 1; r < SPAN; ++r) o.tail[r] = multmodp(o.tail[r - 1], X8);
  o.span[0] = ONE;
  const uint32_t x_span = multmodp(o.tail[SPAN - 1], X8);
  for (int d = 1; d <= TILE / SPAN; ++d)
    o.span[d] = multmodp(o.span[d - 1], x_span);
  o.row_lo[0] = o.row_hi[0] = ONE;
  for (int m = 1; m < 256; ++m)
    o.row_lo[m] = multmodp(o.row_lo[m - 1], o.span[TILE / SPAN]);
  const uint32_t x_hi = multmodp(o.row_lo[255], o.span[TILE / SPAN]);
  for (int m = 1; m < 256; ++m) o.row_hi[m] = multmodp(o.row_hi[m - 1], x_hi);
  return o;
}

constexpr Ops OPS_HOST = make_ops();
static_assert(OPS_HOST.tail[1] == X8, "x^8");
static_assert(OPS_HOST.span[1] == 0x88d14467u, "x^(2^9)");
static_assert(OPS_HOST.span[TILE / SPAN] == 0x31fec169u, "x^(2^19)");
static_assert(OPS_HOST.row_hi[1] == 0xa8a472c0u, "x^(2^27)");
__device__ const Ops OPS = OPS_HOST;

// Lane-private slice-by-4 tables: entry v of table k for lane l is word
// (k * 256 + v) * 32 + l, so lane l reads bank l. lt is the shared
// address of lane l's word of entry 0 of table 0; a lookup is one LEA
// and one shared load with the table's offset as its immediate.
template <int K>
__device__ __forceinline__ uint32_t look(uint32_t lt, uint32_t v) {
  uint32_t r;
  asm volatile("ld.shared.u32 %0, [%1+%2];"
               : "=r"(r)
               : "r"(lt + (v << 7)), "n"(K * 256 * 32 * 4));
  return r;
}

// The register c after the 4 bytes of the word w (c * x^32 for w = 0)
__device__ __forceinline__ uint32_t crc_word(uint32_t lt, uint32_t c,
                                             uint32_t w) {
  c ^= w;
  return look<3>(lt, __byte_perm(c, 0, 0x4440)) ^
         look<2>(lt, __byte_perm(c, 0, 0x4441)) ^
         look<1>(lt, __byte_perm(c, 0, 0x4442)) ^
         look<0>(lt, __byte_perm(c, 0, 0x4443));
}

__device__ __forceinline__ uint32_t crc_byte(uint32_t lt, uint32_t c,
                                             uint32_t d) {
  return look<0>(lt, (c ^ d) & 0xFF) ^ (c >> 8);
}

// The carry-less product of two 32-bit polynomials (bit i: x^i), by 16
// integer multiplications of operands masked to every fourth bit: each
// sum of terms at a place is at most 8, so it stays in its 4-bit field.
__device__ __forceinline__ uint64_t clmul(uint32_t x, uint32_t y) {
  constexpr uint32_t M[4] = {0x11111111u, 0x22222222u, 0x44444444u,
                             0x88888888u};
  uint64_t z[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      z[(i + k) & 3] ^= static_cast<uint64_t>(x & M[i]) *
                        static_cast<uint64_t>(y & M[k]);
  return (z[0] & 0x1111111111111111ull) | (z[1] & 0x2222222222222222ull) |
         (z[2] & 0x4444444444444444ull) | (z[3] & 0x8888888888888888ull);
}

// a * b mod P, reflected: the carry-less product of the bit-reversed
// operands, its high word moved past 4 zero bytes by the tables (times
// x^32 mod P), its low word added
__device__ __forceinline__ uint32_t mulmod(uint32_t lt, uint32_t a,
                                           uint32_t b) {
  const uint64_t q = clmul(__brev(a), __brev(b));
  return crc_word(lt, __brev(static_cast<uint32_t>(q >> 32)), 0) ^
         __brev(static_cast<uint32_t>(q));
}

// x^(8 TILE m) mod P
__device__ __forceinline__ uint32_t row_shift(uint32_t lt, int64_t m) {
  uint32_t p = mulmod(lt, __ldg(&OPS.row_lo[m & 255]),
                      __ldg(&OPS.row_hi[(m >> 8) & 255]));
  int k = 35;                       // x^(2^(19 + 16 + b)): past 4 GiB
  for (int64_t hi = m >> 16; hi; hi >>= 1, ++k)
    if (hi & 1) p = mulmod(lt, x2n(k), p);
  return p;
}

// n bytes at p, from register c: single bytes up to a 4-byte boundary,
// 4-byte words, single bytes
__device__ uint32_t crc_any(uint32_t lt, uint32_t c,
                            const uint8_t* __restrict__ p, int n) {
  int i = 0;
  for (; i < n && (reinterpret_cast<uintptr_t>(p + i) & 3); ++i)
    c = crc_byte(lt, c, __ldg(p + i));
  for (; i + 4 <= n; i += 4)
    c = crc_word(lt, c, __ldg(reinterpret_cast<const uint32_t*>(p + i)));
  for (; i < n; ++i) c = crc_byte(lt, c, __ldg(p + i));
  return c;
}

struct CrcArgs {
  const uint8_t* data;
  int64_t stride;          // bytes from a row to the next
  int64_t width;           // bytes a row
  const int64_t* lengths;  // a row's length; null: one buffer of `total`
  int64_t rows;            // rows (a buffer's: ceil(total / TILE))
  int64_t total;           // a buffer's bytes
  int tp;                  // threads a row in a step (a multiple of HALF)
  int group;               // rows a step
  int64_t items;           // steps' items: groups of rows, or rows
  int64_t* out;            // (rows,) CRC-32s, or () for a buffer
  uint32_t* state;         // a buffer's sum, last row, counter: zeroed
  uint32_t init_term;      // a buffer's x^(8 total) (init ^ 0xFFFFFFFF)
  long long* stages;       // block 0's clock stamps, or null
};

// A thread's span in a step: item `item` (a group of rows, or a row), the
// tile `chunk` of its row; grp is the row's place in the group, j the
// span's in the row's tile. Its address and its room inside the row's
// width need no length, so its loads are issued before the length is in.
struct Span {
  const uint8_t* p;
  int room;         // bytes of the span inside the row's width
  bool has;         // the thread has a row in this step
};

__device__ __forceinline__ Span span_at(const CrcArgs& a, int64_t item,
                                        int64_t chunk, int grp, int j) {
  const int64_t row = item * a.group + grp;
  Span s;
  s.has = item < a.items && grp < a.group && row < a.rows;
  const int64_t r = s.has ? row : 0;
  const int64_t width =
      a.lengths ? a.width : (a.total - r * TILE < TILE ? a.total - r * TILE
                                                       : TILE);
  const int64_t b = chunk * TILE + j * SPAN;
  const int64_t room = s.has ? width - b : 0;
  s.room = static_cast<int>(room <= 0 ? 0 : (room < SPAN ? room : SPAN));
  s.p = a.data + (a.lengths ? r * a.stride : r * TILE) + b;
  return s;
}

// The length of the step's row (0 without one), cut to [0, width].
__device__ __forceinline__ int64_t row_len(const CrcArgs& a, int64_t item,
                                           int grp) {
  const int64_t row = item * a.group + grp;
  if (item >= a.items || grp >= a.group || row >= a.rows) return 0;
  if (!a.lengths) {
    const int64_t left = a.total - row * TILE;
    return left < TILE ? left : TILE;
  }
  const int64_t n = a.lengths[row];
  return n < 0 ? 0 : (n > a.width ? a.width : n);
}

__device__ __forceinline__ bool aligned_whole(const Span& s) {
  return s.room == SPAN && !(reinterpret_cast<uintptr_t>(s.p) & 15);
}

constexpr int WORDS4 = SPAN / 16;           // 16-byte words a span

__device__ __forceinline__ void load_span(const Span& s,
                                          uint4 (&w)[WORDS4]) {
#pragma unroll
  for (int k = 0; k < WORDS4; ++k)
    w[k] = __ldg(reinterpret_cast<const uint4*>(s.p) + k);
}

__device__ __forceinline__ void stamp(const CrcArgs& a, int k) {
  if (a.stages && blockIdx.x == 0 && threadIdx.x == 0 && k < 64)
    a.stages[k] = clock64();
}

// CRC-32s of rows (BUFFER false: out[r], init 0xFFFFFFFF, final XOR) or of
// one buffer (BUFFER true: out[0], from init_term). With stages, block 0
// stamps clock64() at its start, after the tables, and in each step after
// the hashing, after the fold to the row and after the finish, with a
// barrier before each stamp.
template <bool BUFFER>
__global__ void __launch_bounds__(CRC_THREADS, 1) crc_kernel(CrcArgs a) {
  extern __shared__ uint4 smem[];
  __shared__ uint32_t acc_f[2][MAX_GROUP];  // the whole spans' XOR
  __shared__ uint32_t acc_p[2][MAX_GROUP];  // the partial span's register
  __shared__ int64_t lens[2][MAX_GROUP];    // the rows' lengths
  __shared__ uint32_t span_ops[TILE / SPAN + 1], tail_ops[SPAN];
  const int t = threadIdx.x, lane = t & 31;
  const int grp = t / a.tp, j = t - grp * a.tp;
  const bool timed = a.stages != nullptr;
  const uint32_t tables =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  int ns = 0;
  stamp(a, ns++);

  // the first step's loads and length, in flight while the tables build
  int64_t item = blockIdx.x, chunk = 0;
  Span s = span_at(a, item, chunk, grp, j);
  uint4 w[WORDS4];
  bool fast = aligned_whole(s);
  if (fast) load_span(s, w);
  int64_t len = row_len(a, item, grp);
  // entry v of table k: byte v, then k zero bytes
  for (int x = t; x < 4 * 256; x += CRC_THREADS) {
    const int k = x >> 8, v = x & 255;
    uint32_t r = v;
    for (int i = 0; i < 8 * (k + 1); ++i)
      r = (r >> 1) ^ (POLY & (0u - (r & 1u)));
    const uint4 r4 = make_uint4(r, r, r, r);
    uint4* e = smem + x * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) e[(i + x) & 7] = r4;
  }
  // the shift operators, from global memory once a block
  for (int x = t; x < TILE / SPAN + 1 + SPAN; x += CRC_THREADS) {
    if (x <= TILE / SPAN)
      span_ops[x] = __ldg(&OPS.span[x]);
    else
      tail_ops[x - TILE / SPAN - 1] = __ldg(&OPS.tail[x - TILE / SPAN - 1]);
  }
  if (t < 2 * MAX_GROUP) (&acc_f[0][0])[t] = 0;
  __syncthreads();
  stamp(a, ns++);
  const uint32_t lt = tables + 4 * lane;

  uint32_t carry = 0;   // thread 0: a wide row's register so far
  int slot = 0;
  while (item < a.items) {
    const int64_t left = len - chunk * TILE;
    const int lc = static_cast<int>(left <= 0 ? 0 : (left < TILE ? left
                                                                 : TILE));
    const int b = j * SPAN;
    const int n = b < lc ? (lc - b < SPAN ? lc - b : SPAN) : 0;
    // thread 0: a wide row's carry moved past this tile's whole spans,
    // and a buffer row's shift
    uint32_t v = 0, shift = ONE;
    if (t == 0) {
      if (chunk > 0) v = mulmod(lt, carry, span_ops[lc / SPAN]);
      if (BUFFER && item < a.items - 1)
        shift = row_shift(lt, a.items - 2 - item);
    }
    uint32_t c = !BUFFER && chunk == 0 && j == 0 ? 0xFFFFFFFFu : 0u;
    if (fast && n == SPAN) {
#pragma unroll
      for (int k = 0; k < WORDS4; ++k) {
        c = crc_word(lt, c, w[k].x);
        c = crc_word(lt, c, w[k].y);
        c = crc_word(lt, c, w[k].z);
        c = crc_word(lt, c, w[k].w);
      }
    } else if (n) {
      c = crc_any(lt, c, s.p, n);
    }
    // the next step (a wide row's next tile, else the block's next item:
    // uniform, since a row wider than a tile is alone in its step); its
    // loads go out now, into the registers just hashed
    const bool more = a.width > TILE && (chunk + 1) * TILE < len;
    const int64_t n_item = more ? item : item + gridDim.x;
    const int64_t n_chunk = more ? chunk + 1 : 0;
    const Span s_next = span_at(a, n_item, n_chunk, grp, j);
    const bool f_next = aligned_whole(s_next);
    if (f_next) load_span(s_next, w);
    const int64_t n_len = more ? len : row_len(a, n_item, grp);
    if (timed) {
      __syncthreads();
      stamp(a, ns++);
    }
    if (n == SPAN)
      v ^= mulmod(lt, c, span_ops[lc / SPAN - 1 - j]);
    else if (n)
      acc_p[slot][grp] = c;
    if (j == 0 && s.has) lens[slot][grp] = len;
#pragma unroll
    for (int off = HALF / 2; off; off >>= 1)
      v ^= __shfl_xor_sync(0xFFFFFFFFu, v, off);
    if ((lane & (HALF - 1)) == 0 && v) atomicXor(&acc_f[slot][grp], v);
    __syncthreads();
    if (timed) stamp(a, ns++);
    // the finish: one thread a row
    const int64_t row = item * a.group + t;
    if (t < a.group && row < a.rows) {
      const int64_t f_len = lens[slot][t];
      const int64_t f_left = f_len - chunk * TILE;
      const int r = f_left > 0 && f_left < TILE ? f_left % SPAN : 0;
      uint32_t acc = acc_f[slot][t];
      acc_f[slot][t] = 0;
      if (r) acc = mulmod(lt, acc, tail_ops[r]) ^ acc_p[slot][t];
      if (BUFFER) {
        if (item < a.items - 1)
          atomicXor(&a.state[0], mulmod(lt, acc, shift));
        else
          atomicXor(&a.state[1], acc);
      } else if ((chunk + 1) * TILE < f_len) {
        carry = acc;                       // the row's next tile follows
      } else {
        a.out[row] = f_len ? acc ^ 0xFFFFFFFFu : 0;
      }
    }
    if (timed) {
      __syncthreads();
      stamp(a, ns++);
    }
    item = n_item;
    chunk = n_chunk;
    s = s_next;
    len = n_len;
    fast = f_next;
    slot ^= 1;
  }
  if (!BUFFER || t != 0) return;
  // the block that finishes last ends the buffer and zeroes the state
  __threadfence();
  if (atomicAdd(&a.state[2], 1u) != gridDim.x - 1) return;
  __threadfence();
  const uint32_t sum = atomicExch(&a.state[0], 0u);
  const uint32_t last = atomicExch(&a.state[1], 0u);
  atomicExch(&a.state[2], 0u);
  const int64_t n_last = a.total - (a.items - 1) * TILE;   // 1 .. TILE
  uint32_t moved = mulmod(lt, sum, span_ops[n_last / SPAN]);
  if (n_last % SPAN) moved = mulmod(lt, moved, tail_ops[n_last % SPAN]);
  a.out[0] = a.init_term ^ moved ^ last ^ 0xFFFFFFFFu;
}

// -- Adler-32 ---------------------------------------------------------------

constexpr int ROW_THREADS = 256;       // threads a row
constexpr int64_t BUFFER_ROW = 65536;  // bytes a row of one buffer
constexpr int FOLD_THREADS = 256;      // threads of the one-block fold
constexpr uint32_t MOD = 65521u;       // Adler-32 modulus
constexpr int ADLER_GROUPS = 256;      // 16-byte groups between mod steps
constexpr int BATCH = 8;               // 16-byte loads in flight a thread

// A piece of a message: Adler's s1, s2 of a zero start, both reduced, and
// its length in bytes. The empty piece {0, 0, 0} is the fold's identity.
struct Sums {
  uint32_t a, b;
  int64_t len;
};

__device__ __forceinline__ Sums combine(const Sums& x, const Sums& y) {
  Sums r;
  r.len = x.len + y.len;
  r.a = (x.a + y.a) % MOD;
  r.b = static_cast<uint32_t>((static_cast<uint64_t>(x.b) + y.b +
                               static_cast<uint64_t>(y.len % MOD) * x.a) %
                              MOD);
  return r;
}

// In order over the warp's lanes; lane 0 holds the result.
__device__ __forceinline__ Sums warp_fold(Sums p) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    Sums q;
    q.a = __shfl_down_sync(0xFFFFFFFFu, p.a, off);
    q.b = __shfl_down_sync(0xFFFFFFFFu, p.b, off);
    q.len = __shfl_down_sync(0xFFFFFFFFu, p.len, off);
    if ((lane & (2 * off - 1)) == 0) p = combine(p, q);
  }
  return p;
}

// In order over the block's threads; thread 0 holds the result.
template <int THREADS>
__device__ __forceinline__ Sums block_fold(Sums p, Sums* warps) {
  p = warp_fold(p);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warps[warp] = p;
  __syncthreads();
  if (warp == 0) {
    p = lane < THREADS / 32 ? warps[lane] : Sums{0, 0, 0};
    p = warp_fold(p);
  }
  return p;
}

__device__ __forceinline__ void adler_word(uint32_t& s1, uint32_t& s2,
                                           uint32_t w) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s1 += (w >> (8 * k)) & 0xFF;
    s2 += s1;
  }
}

__device__ __forceinline__ void group(uint32_t& s1, uint32_t& s2,
                                      const uint4& w) {
  adler_word(s1, s2, w.x);
  adler_word(s1, s2, w.y);
  adler_word(s1, s2, w.z);
  adler_word(s1, s2, w.w);
}

// The sums reduced once ADLER_GROUPS groups have been added.
__device__ __forceinline__ void adler_mod(int& groups, int added,
                                          uint32_t& s1, uint32_t& s2) {
  groups += added;
  if (groups >= ADLER_GROUPS) {
    groups = 0;
    s1 %= MOD;
    s2 %= MOD;
  }
}

// The sums of bytes [begin, end) of p: single bytes up to a 16-byte
// boundary, batches of BATCH 16-byte loads issued together, then single
// 16-byte groups, then single bytes.
__device__ Sums span_sums(const uint8_t* __restrict__ p, int64_t begin,
                          int64_t end) {
  uint32_t s1 = 0, s2 = 0;
  int64_t i = begin;
  for (; i < end && (reinterpret_cast<uintptr_t>(p + i) & 15); ++i) {
    s1 += p[i];
    s2 += s1;
  }
  int groups = 0;
  for (; i + 16 * BATCH <= end; i += 16 * BATCH) {
    uint4 w[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      w[k] = __ldg(reinterpret_cast<const uint4*>(p + i) + k);
#pragma unroll
    for (int k = 0; k < BATCH; ++k) group(s1, s2, w[k]);
    adler_mod(groups, BATCH, s1, s2);
  }
  for (; i + 16 <= end; i += 16) {
    group(s1, s2, __ldg(reinterpret_cast<const uint4*>(p + i)));
    adler_mod(groups, 1, s1, s2);
  }
  for (; i < end; ++i) {
    s1 += p[i];
    s2 += s1;
  }
  const int64_t len = end > begin ? end - begin : 0;
  return Sums{s1 % MOD, s2 % MOD, len};
}

// One block a row: row r is data[r * stride ...] and its length
// lengths[r] (else total - r * stride), cut to [0, width]. out[r] is the
// row's Adler-32 (init 1), or with raw its (s2 << 16 | s1) from zero.
__global__ void __launch_bounds__(ROW_THREADS)
    adler_rows_kernel(const uint8_t* __restrict__ data, int64_t stride,
                      int64_t width, const int64_t* __restrict__ lengths,
                      int64_t total, int raw, int64_t* __restrict__ out) {
  __shared__ Sums warps[ROW_THREADS / 32];
  const int64_t row = blockIdx.x;
  int64_t len = lengths ? lengths[row] : total - row * stride;
  len = len < 0 ? 0 : (len > width ? width : len);
  const int64_t span = (width + ROW_THREADS - 1) / ROW_THREADS;
  const int64_t b0 = threadIdx.x * span;
  const int64_t begin = b0 < len ? b0 : len;
  const int64_t end = b0 + span < len ? b0 + span : len;
  Sums p = span_sums(data + row * stride, begin, end);
  p = block_fold<ROW_THREADS>(p, warps);
  if (threadIdx.x != 0) return;
  int64_t v;
  if (raw) {
    v = static_cast<int64_t>(p.b) << 16 | p.a;
  } else {
    const uint32_t s1 = (1 + p.a) % MOD;
    const uint32_t s2 = static_cast<uint32_t>((p.b + len % MOD) % MOD);
    v = static_cast<int64_t>(s2) << 16 | s1;
  }
  out[row] = v;
}

// One block: the rows' raw sums of one buffer of `total` bytes (rows of
// BUFFER_ROW bytes, the last one short) folded in order, then the
// initial value `init` applied: out[0] is the buffer's Adler-32
// continuing from it.
__global__ void __launch_bounds__(FOLD_THREADS)
    adler_fold_kernel(const int64_t* __restrict__ regs, int64_t rows,
                      int64_t total, uint32_t init,
                      int64_t* __restrict__ out) {
  __shared__ Sums warps[FOLD_THREADS / 32];
  const int64_t per = (rows + FOLD_THREADS - 1) / FOLD_THREADS;
  const int64_t r0 = threadIdx.x * per;
  const int64_t r1 = r0 + per < rows ? r0 + per : rows;
  Sums acc{0, 0, 0};
  for (int64_t r = r0; r < r1; ++r) {
    const int64_t left = total - r * BUFFER_ROW;
    const uint32_t v = static_cast<uint32_t>(regs[r]);
    const Sums q{v & 0xFFFF, v >> 16, left < BUFFER_ROW ? left : BUFFER_ROW};
    acc = r == r0 ? q : combine(acc, q);
  }
  acc = block_fold<FOLD_THREADS>(acc, warps);
  if (threadIdx.x != 0) return;
  const uint64_t s1_in = init & 0xFFFF, s2_in = init >> 16;
  const uint64_t s1 = (s1_in + acc.a) % MOD;
  const uint64_t s2 =
      (s2_in + static_cast<uint64_t>(total % MOD) * s1_in + acc.b) % MOD;
  out[0] = static_cast<int64_t>(s2 << 16 | s1);
}

// The CRC kernel's launch: a block an SM at most, its tables' shared
// memory opted into.
template <bool BUFFER>
int launch_crc(CrcArgs a, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(crc_kernel<BUFFER>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             CRC_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t grid = a.items < sms ? a.items : sms;
  crc_kernel<BUFFER><<<static_cast<unsigned>(grid), CRC_THREADS, CRC_SMEM,
                       s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

#ifdef LDRSX_STAGES
__device__ long long g_stages[64];
#endif

long long* stages_ptr() {
#ifdef LDRSX_STAGES
  void* p = nullptr;
  cudaGetSymbolAddress(&p, g_stages);
  return static_cast<long long*>(p);
#else
  return nullptr;
#endif
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
  if ((kind != CRC && kind != ADLER) || rows > MAX_ROWS || width < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const uint8_t*>(data);
  const auto* n = static_cast<const int64_t*>(lengths);
  auto* o = static_cast<int64_t*>(out);
  if (kind == ADLER) {
    adler_rows_kernel<<<dim3(static_cast<unsigned>(rows)), ROW_THREADS, 0,
                        s>>>(d, stride, width, n, 0, 0, o);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t narrow = width < TILE ? width : TILE;
  int tp = static_cast<int>((narrow + SPAN - 1) / SPAN);
  tp = tp < HALF ? HALF : (tp + HALF - 1) / HALF * HALF;
  const int group = width > TILE ? 1 : CRC_THREADS / tp;
  const CrcArgs a{d, stride, width, n, rows, 0, tp, group,
                  (rows + group - 1) / group, o, nullptr, 0, stages_ptr()};
  return launch_crc<false>(a, s);
}

// kind 0: CRC-32, 1: Adler-32, of data[:length] continuing from init:
// out () int64. scratch: for the CRC, 3 uint32 words, zeroed before the
// first launch and left zeroed by each (one set a stream); for Adler,
// ceil(length / 65,536) int64 row sums.
extern "C" int ldrsx_checksum_buffer(int kind, const void* data,
                                     int64_t length, uint32_t init,
                                     void* scratch, void* out, void* stream) {
  const int64_t row = kind == CRC ? TILE : BUFFER_ROW;
  const int64_t rows = length > 0 ? (length + row - 1) / row : 0;
  if ((kind != CRC && kind != ADLER) || rows <= 0 || rows > MAX_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const uint8_t*>(data);
  auto* o = static_cast<int64_t*>(out);
  if (kind == CRC) {
    const uint32_t term = multmodp(x8nmodp(length), init ^ 0xFFFFFFFFu);
    const CrcArgs a{d, TILE, TILE, nullptr, rows, length, TILE / SPAN, 1,
                    rows, o, static_cast<uint32_t*>(scratch), term,
                    stages_ptr()};
    return launch_crc<true>(a, s);
  }
  auto* regs = static_cast<int64_t*>(scratch);
  const dim3 grid(static_cast<unsigned>(rows));
  adler_rows_kernel<<<grid, ROW_THREADS, 0, s>>>(d, BUFFER_ROW, BUFFER_ROW,
                                                 nullptr, length, 1, regs);
  adler_fold_kernel<<<1, FOLD_THREADS, 0, s>>>(regs, rows, length, init, o);
  return static_cast<int>(cudaGetLastError());
}

#ifdef LDRSX_STAGES
// Block 0's clock stamps of the last launch (64 int64), copied to host.
extern "C" int ldrsx_checksum_stages(void* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, g_stages, sizeof(long long) * 64));
}
#endif
