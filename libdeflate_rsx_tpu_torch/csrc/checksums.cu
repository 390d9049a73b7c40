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
// Adler-32 (adler_kernel). Adler's sums are linear in the message: a piece
// of L bytes at offset o of an n-byte message, with the zero-start sums A =
// sum d_i and B = sum (L - i) d_i, adds A to s1 and B + A (n - o - L) to
// s2, mod 65,521, whatever the order the pieces are added in. What the
// design does about the bound:
// - a persistent grid over tiles of 65,536 bytes of a row (as many
//   256-thread blocks as are resident, or a block a tile if fewer), tile
//   blockIdx.x + j gridDim.x in turn; a tile is cut at its row's length,
//   so the padding is not read, and a tile past it is skipped; a row
//   narrower than a tile takes one alone, so the corpus's 64 KiB rows are
//   read at full width;
// - thread t takes groups t + 256 k (k < 16) of 16 bytes: every 16-byte
//   load of the tile in flight at once (single bytes where the rows are
//   not 16-byte aligned, and for the group the length cuts), each warp's
//   loads 512 adjacent bytes;
// - a group's sums are 8 dp4a: its byte sum into s1 (weights 1, 1, 1, 1),
//   its sum weighted 16 .. 1 into w, after r += s1; in 32 bits with one
//   reduction a thread (the bound is stated at A_MAX and B_MAX below);
// - every thread's part is its share of the tile's sum weighted by the
//   bytes to the tile's full end, so the block only adds: shuffles of
//   32-bit values below 2^32, shared memory, one reduction (no 64-bit %
//   in the fold);
// - a row of one tile ends in its block; a longer row's tiles atomicAdd
//   their terms into two 64-bit words of the row, then a __threadfence
//   and a counter in a third, and the tile that finishes last ends the
//   row, applies the initial value and zeroes the words;
// - one buffer is one row of its length in the same launch, the initial
//   value its own (a row's is 1); its words are a set a stream.
// Its bound is the CRC's: the bytes read once, 0.005056 ms for the corpus's
// 259 rows.
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

constexpr uint32_t MOD = 65521u;            // Adler-32 modulus
constexpr int ADLER_THREADS = 256;          // threads a block
constexpr int ADLER_WARPS = ADLER_THREADS / 32;
constexpr int GROUP = 16;                   // bytes a group: one 16-byte load
constexpr int ADLER_TILE = 65536;           // bytes a tile of a row
constexpr int STRIDE = GROUP * ADLER_THREADS;   // bytes from a slot to the next
constexpr int SLOTS = ADLER_TILE / STRIDE;  // groups a thread a tile
constexpr uint32_t ONES = 0x01010101u;
// the weights 16 .. 1 of a group's bytes 0 .. 15, four a word, byte 0 lowest
constexpr uint32_t W0 = 0x0D0E0F10u, W1 = 0x090A0B0Cu, W2 = 0x05060708u,
                   W3 = 0x01020304u;

// The bound that sets the mod schedule: a thread sums a tile's groups in 32
// bits and reduces once, after its last. With every byte 0xFF, its s1 is at
// most SLOTS 16 255 = 65,280 (below the modulus, so it needs no reduction),
// its weighted sum w at most SLOTS 136 255 = 554,880, its running sum r at
// most 16 255 SLOTS (SLOTS - 1) / 2 = 489,600, and its b = w + E s1 +
// STRIDE r + the cut group's term, with E below 16 ADLER_THREADS and that
// term below 15 255 ADLER_TILE + 135 255, at most 2,524,052,985: below 2^32.
// (zlib's NMAX, 5,552 bytes, bounds the running sums of one long span; a
// thread here never sums more than its 16 groups of one tile.)
constexpr uint64_t A_MAX = uint64_t(SLOTS) * GROUP * 255;
constexpr uint64_t B_MAX =
    uint64_t(SLOTS) * 136 * 255 + uint64_t(GROUP) * ADLER_THREADS * A_MAX +
    uint64_t(STRIDE) * GROUP * 255 * SLOTS * (SLOTS - 1) / 2 +
    uint64_t(GROUP - 1) * 255 * ADLER_TILE + 135 * 255;
static_assert(A_MAX < MOD, "a thread's s1 needs no reduction");
static_assert(B_MAX < (1ull << 32), "a thread's b fits 32 bits");
static_assert(uint64_t(ADLER_THREADS) * MOD < (1ull << 32),
              "the block's sums of reduced values fit 32 bits");

struct AdlerArgs {
  const uint8_t* data;
  int64_t stride;            // bytes from a row to the next
  int64_t width;             // bytes a row (one buffer: its length)
  const int64_t* lengths;    // a row's length; null: `width`
  int64_t per_row;           // tiles a row: ceil(width / ADLER_TILE), >= 1
  int64_t tiles;             // rows * per_row
  uint32_t init;             // the initial value: 1 for rows
  unsigned long long* acc;   // 3 words a row (the tiles' sums of A and
                             // of B, the tiles done), zeroed; null if
                             // per_row is 1
  int64_t* out;              // (rows,) Adler-32s
  long long* stages;         // block 0's clock stamps, or null
};

// A group of 16 bytes at p: one 16-byte load, or single bytes (a row view
// that is not 16-byte aligned).
template <bool ALIGNED>
__device__ __forceinline__ uint4 load_group(const uint8_t* __restrict__ p) {
  if constexpr (ALIGNED) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = __ldg(p + 4 * k) | __ldg(p + 4 * k + 1) << 8 |
             __ldg(p + 4 * k + 2) << 16 |
             static_cast<uint32_t>(__ldg(p + 4 * k + 3)) << 24;
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Bytes [0, m) of the group at p, m < GROUP, zero past them.
__device__ __forceinline__ uint4 load_cut(const uint8_t* __restrict__ p,
                                          int m) {
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < GROUP - 1; ++i)
    if (i < m) w[i >> 2] |= static_cast<uint32_t>(__ldg(p + i)) << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// s + the group's byte sum, and s + its sum weighted 16 .. 1
__device__ __forceinline__ uint32_t group_a(const uint4& v, uint32_t s) {
  return __dp4a(v.w, ONES, __dp4a(v.z, ONES, __dp4a(v.y, ONES,
                                                     __dp4a(v.x, ONES, s))));
}

__device__ __forceinline__ uint32_t group_w(const uint4& v, uint32_t s) {
  return __dp4a(v.w, W3, __dp4a(v.z, W2, __dp4a(v.y, W1, __dp4a(v.x, W0, s))));
}

__device__ __forceinline__ void stamp_at(long long* stages, int k) {
  if (k < 64) stages[k] = clock64();
}

// The row's Adler-32 from its sums A = sum d, B = sum (n - i) d_i (each
// reduced) and the initial value.
__device__ __forceinline__ void adler_finish(const AdlerArgs& a, int64_t row,
                                             int64_t n, uint64_t A,
                                             uint64_t B) {
  const uint64_t s1_in = a.init & 0xFFFF, s2_in = a.init >> 16;
  const uint64_t s1 = (s1_in + A) % MOD;
  const uint64_t s2 = (s2_in + static_cast<uint64_t>(n % MOD) * s1_in + B) %
                      MOD;
  a.out[row] = static_cast<int64_t>(s2 << 16 | s1);
}

// Adler-32s of rows (init 1) or of one buffer (a row of `width` bytes from
// init). A persistent grid over tiles of ADLER_TILE bytes of a row, tile
// blockIdx.x + j gridDim.x in turn, each cut at its row's length (a tile
// past it is skipped). Thread t sums groups t + ADLER_THREADS k of its tile
// (every load of the tile in flight at once) with dp4a: s1 the byte sum,
// r += s1 before each group, w the sums weighted 16 .. 1; its part of the
// tile's sum weighted by the bytes to the tile's full end, b = w + E s1 +
// STRIDE r with E the bytes after its last slot, is reduced once and the
// block adds the parts. The tile's term is (A, B + A (n - start -
// ADLER_TILE)): a row of one tile ends there, a longer row's tiles add it
// into the row's words and the last to finish (a counter) ends the row and
// zeroes them. With stages, block 0 stamps each tile's start, its loads'
// arrival, the group sums, the block's sums, the atomics and the finish.
template <bool ALIGNED>
__global__ void __launch_bounds__(ADLER_THREADS) adler_kernel(AdlerArgs a) {
  __shared__ uint32_t parts[2][2][ADLER_WARPS];   // [tile parity][A, B][warp]
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool timed = a.stages != nullptr && blockIdx.x == 0;
  int ns = 0, par = 0;
  for (int64_t tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const int64_t row = tile / a.per_row;
    const int64_t start = (tile - row * a.per_row) * ADLER_TILE;
    int64_t n = a.lengths ? a.lengths[row] : a.width;
    n = n < 0 ? 0 : (n > a.width ? a.width : n);
    if (start > 0 && start >= n) continue;
    const int len =
        static_cast<int>(n - start < ADLER_TILE ? n - start : ADLER_TILE);
    const uint8_t* p = a.data + row * a.stride + start;
    if (timed && t == 0) stamp_at(a.stages, ns++);
    uint4 v[SLOTS];
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      const int o = GROUP * t + STRIDE * k;
      v[k] = o + GROUP <= len ? load_group<ALIGNED>(p + o)
                              : make_uint4(0, 0, 0, 0);
    }
    const int cut = len & ~(GROUP - 1), m = len & (GROUP - 1);
    const bool has_cut = m && (cut / GROUP) % ADLER_THREADS == t;
    const uint4 vc = has_cut ? load_cut(p + cut, m) : make_uint4(0, 0, 0, 0);
    if (timed) {
      uint32_t x = vc.x;
#pragma unroll
      for (int k = 0; k < SLOTS; ++k) x ^= v[k].x ^ v[k].y ^ v[k].z ^ v[k].w;
      asm volatile("" ::"r"(x));
      __syncthreads();
      if (t == 0) stamp_at(a.stages, ns++);
    }
    uint32_t s1 = 0, r = 0, w = 0;
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      r += s1;
      s1 = group_a(v[k], s1);
      w = group_w(v[k], w);
    }
    const uint32_t ac = group_a(vc, 0);
    uint32_t b = (w + GROUP * (ADLER_THREADS - 1 - t) * s1 + STRIDE * r +
                  group_w(vc, 0) + ac * (ADLER_TILE - GROUP - cut)) %
                 MOD;
    uint32_t av = s1 + ac;
    if (timed) {
      __syncthreads();
      if (t == 0) stamp_at(a.stages, ns++);
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      av += __shfl_xor_sync(0xFFFFFFFFu, av, off);
      b += __shfl_xor_sync(0xFFFFFFFFu, b, off);
    }
    if (lane == 0) {
      parts[par][0][warp] = av;
      parts[par][1][warp] = b;
    }
    __syncthreads();
    if (t == 0) {
      uint32_t A = 0, B = 0;
#pragma unroll
      for (int i = 0; i < ADLER_WARPS; ++i) {
        A += parts[par][0][i];
        B += parts[par][1][i];
      }
      A %= MOD;
      // (n - start - ADLER_TILE) mod MOD: the bytes after the tile's full
      // end, negative in a row's last tile
      const uint32_t f = static_cast<uint32_t>(
          ((n - start) % MOD + MOD - ADLER_TILE % MOD) % MOD);
      B = (B % MOD + A * f) % MOD;
      if (timed) stamp_at(a.stages, ns++);
      const int64_t nt = (n + ADLER_TILE - 1) / ADLER_TILE;  // the row's
      unsigned long long* acc = nt > 1 ? a.acc + 3 * row : nullptr;
      uint64_t sa = A, sb = B;
      bool last = true;
      if (nt > 1) {
        atomicAdd(acc, static_cast<unsigned long long>(A));
        atomicAdd(acc + 1, static_cast<unsigned long long>(B));
        __threadfence();
        last = static_cast<int64_t>(atomicAdd(acc + 2, 1ull)) == nt - 1;
        if (last) {
          __threadfence();
          sa = atomicExch(acc, 0ull);
          sb = atomicExch(acc + 1, 0ull);
          atomicExch(acc + 2, 0ull);
        }
      }
      if (timed) stamp_at(a.stages, ns++);
      if (last) adler_finish(a, row, n, sa % MOD, sb % MOD);
      if (timed) stamp_at(a.stages, ns++);
    }
    par ^= 1;
  }
}

// The Adler kernel's launch: as many blocks as are resident (the occupancy
// calculator's count an SM, kept a device), or a block a tile if fewer;
// 16-byte loads where every row starts 16-byte aligned.
template <bool ALIGNED>
int launch_adler_as(const AdlerArgs& a, cudaStream_t s) {
  static int resident[64];   // blocks resident on the card, by device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int slots = dev < 64 ? resident[dev] : 0;
  if (slots == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, adler_kernel<ALIGNED>, ADLER_THREADS, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    slots = per_sm * sms;
    if (dev < 64) resident[dev] = slots;
  }
  const int64_t grid = a.tiles < slots ? a.tiles : slots;
  adler_kernel<ALIGNED><<<static_cast<unsigned>(grid), ADLER_THREADS, 0, s>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

int launch_adler(const AdlerArgs& a, cudaStream_t s) {
  const bool aligned = !(reinterpret_cast<uintptr_t>(a.data) & 15) &&
                       !(a.stride & 15);
  return aligned ? launch_adler_as<true>(a, s) : launch_adler_as<false>(a, s);
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
// int64. scratch: for Adler with `width` past 65,536 bytes, 3 uint64 words
// a row, zeroed before the first launch and left zeroed by each (one set a
// stream); else unused (may be null).
extern "C" int ldrsx_checksum_rows(int kind, const void* data,
                                   int64_t stride, int64_t rows,
                                   int64_t width, const void* lengths,
                                   void* scratch, void* out, void* stream) {
  if (rows <= 0) return 0;
  if ((kind != CRC && kind != ADLER) || rows > MAX_ROWS || width < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const uint8_t*>(data);
  const auto* n = static_cast<const int64_t*>(lengths);
  auto* o = static_cast<int64_t*>(out);
  if (kind == ADLER) {
    const int64_t per_row =
        width > ADLER_TILE ? (width + ADLER_TILE - 1) / ADLER_TILE : 1;
    if (per_row > 1 && scratch == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    const AdlerArgs a{d, stride, width, n, per_row, rows * per_row, 1u,
                      static_cast<unsigned long long*>(scratch), o,
                      stages_ptr()};
    return launch_adler(a, s);
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
// out () int64. scratch: for the CRC 3 uint32 words, for Adler 3 uint64
// words, zeroed before the first launch and left zeroed by each (one set a
// stream). One launch.
extern "C" int ldrsx_checksum_buffer(int kind, const void* data,
                                     int64_t length, uint32_t init,
                                     void* scratch, void* out, void* stream) {
  const int64_t rows = length > 0 ? (length + TILE - 1) / TILE : 0;
  if ((kind != CRC && kind != ADLER) || rows <= 0 || rows > MAX_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const uint8_t*>(data);
  auto* o = static_cast<int64_t*>(out);
  if (kind == ADLER) {
    const int64_t tiles = (length + ADLER_TILE - 1) / ADLER_TILE;
    const AdlerArgs a{d, 0, length, nullptr, tiles, tiles, init,
                      static_cast<unsigned long long*>(scratch), o,
                      stages_ptr()};
    return launch_adler(a, s);
  }
  const uint32_t term = multmodp(x8nmodp(length), init ^ 0xFFFFFFFFu);
  const CrcArgs a{d, TILE, TILE, nullptr, rows, length, TILE / SPAN, 1,
                  rows, o, static_cast<uint32_t*>(scratch), term,
                  stages_ptr()};
  return launch_crc<true>(a, s);
}

#ifdef LDRSX_STAGES
// Block 0's clock stamps of the last launch (64 int64), copied to host,
// then cleared.
extern "C" int ldrsx_checksum_stages(void* host) {
  static const long long zero[64] = {};
  cudaError_t e = cudaMemcpyFromSymbol(host, g_stages, sizeof zero);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_stages, zero, sizeof zero);
  return static_cast<int>(e);
}
#endif
