// Emit of the device encoders on NVIDIA Hopper (sm_90a): every lane's
// token coded and the tokens bit-packed into row buffers, in one launch.
//
// Replaces the XLA graphs that follow the table step in the JAX package:
// ops/encode_dynamic.py emit_pack (:89, levels 4-9) and, in
// ops/encode_v2.py, the static coding of encode_rows_static (:363-370,
// levels 1-3), both of which end in pack_rows (:277). pack_rows is a TPU
// workaround by its own words: a cumsum and a one-hot matmul that places
// each token's bytes as bf16 planes, since a gather or scatter costs the
// TPU 9-19 ms a million elements. The plain PyTorch version of this
// kernel is ops/emit.py's emit_plain (the port's copy of those graphs,
// with a scatter-add of words for the matmul); the kernel gives its four
// outputs exactly, every padding byte of the rows included.
//
// The function, per block of s lanes (R = s / 32 rows) with start_bits:
//  - dynamic mode (tables given, row_out 64): a lane that is sel codes
//    its length symbol through ll_tab (code | len << 16) with the
//    length's extra bits above it, a lit lane its byte, any other lane
//    nothing; a sel lane's offset code through of_tab with its extra
//    bits rides the next lane: ORed into its value, its bit count added;
//  - static mode (row_out 48): a sel lane the fused static match token,
//    a lit lane the static literal code, any other lane nothing;
//  - each lane's bit position is start_bits plus the bit counts of the
//    block's earlier lanes; a row's row_bit0 is its first lane's;
//  - a row's buffer holds the bits of its lanes that fall in the frame
//    [32 * (row_bit0 >> 5), + 8 * row_out): the tokens' low and high
//    words added (mod 2^32) into the frame's words, bits past the frame
//    dropped; then shifted down by delta = (row_bit0 >> 3) - 4 *
//    (row_bit0 >> 5) bytes and zero-padded to row_out + 1 bytes;
//  - byte_off = row_bit0 >> 3; end_bits = start_bits + the block's bits.
// Adding the words (as the plain version's scatter-add does) rather than
// ORing them keeps the two equal even where tokens overlap, which the
// select kernel's tokens never do.
//
// What bounds it on this card: bytes. The function needs every lane's
// sel flag, the lit flag of a lane not sel, the byte of a literal and
// int64 (ml, dist) of a sel lane only, and writes each row's 65 bytes
// and two int64 once: ~0.03 ms for the L6 pass's 259 blocks of the
// Silesia-like corpus at the card's memory rate (chip_smoke.py's
// emit_bytes counts them from the pass's tokens). The kernel reads
// every lane's byte and flags, and (ml, dist) by lane pairs that hold a
// sel lane. The one carry is the running bit count, a prefix sum over a
// whole block.
// The design:
//  - a block of NT = 256 threads per tile of TR = 64 rows (2,048 lanes),
//    every tile of every block at once, taken in ticket order from a
//    global counter; a thread takes K = 8 consecutive lanes (a row is 4
//    threads, a warp 8 rows), loading their sel and lit flags with one
//    8-byte load each, their bytes, and (ml, dist) with 16-byte loads of
//    the lane pairs that hold a sel lane only;
//  - the riding offset passes from lane to lane in the thread, from the
//    thread's last lane to the next thread by a shuffle, and into a
//    warp's first lane by that lane reading the lane before it (a
//    one-lane halo), so no warp waits on another for its tokens; a
//    thread past the block's last row takes none (the last lane's ride
//    is dropped, as the plain version drops it);
//  - each row's bit offsets by a scan over its 4 threads' sums; the
//    tile's 64 row sums by a warp scan (warp 0), and the tile's base by a
//    decoupled look-back over the block's earlier tiles' status words
//    (aggregate or inclusive prefix, one 64-bit word each; the block's
//    first tile starts from start_bits);
//  - each thread adds its tokens into its row's frame words in shared
//    memory (atomics); each warp writes its rows' row_out + 1 bytes into
//    a staging buffer, and the block writes the tile's rows, contiguous
//    in the output, with 16-byte stores, and byte_off and row_bit0.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int ROW = 32;          // lanes a row
constexpr int K = 8;             // lanes a thread
constexpr int TPR = ROW / K;     // threads a row
constexpr int NW = 8;            // warps a block
constexpr int NT = 32 * NW;      // threads a block
constexpr int TR = NT / TPR;     // rows a tile
constexpr int RPW = 32 / TPR;    // rows a warp
constexpr int NUM_LL = 288, NUM_OF = 30;
constexpr int MIN_MATCH = 4, WINDOW = 32768;
constexpr int MAX_ROW_OUT = 64;  // bytes of a row's frame (dynamic mode)
constexpr unsigned FULL = 0xFFFFFFFFu;
// a tile's status word: 0 until written, then a flag and a bit count
constexpr uint64_t AGG = 1ull << 62;   // the tile's own bits
constexpr uint64_t INC = 1ull << 63;   // start_bits + bits up to its end
constexpr uint64_t VALUE = AGG - 1;
static_assert(TR == 64, "warp 0 scans a tile's row sums two a lane");

struct Args {
  const uint8_t* data;
  const int64_t* ml;
  const int64_t* dist;
  const uint8_t* sel;
  const uint8_t* lit;
  long long data_stride, ml_stride, dist_stride, sel_stride, lit_stride;
  const int32_t* ll_tab;         // (b, 288); null: static mode
  const int32_t* of_tab;         // (b, 30)
  const int64_t* start_bits;     // (b,)
  int r, ntiles;
  uint8_t* rows;                 // (b, r, row_out + 1)
  int64_t* byte_off;             // (b, r)
  int64_t* row_bit0;             // (b, r)
  int64_t* end_bits;             // (b,)
  unsigned* ticket;              // the state, cleared per call
  unsigned long long* status;    // (b, ntiles)
};

struct Shared {
  int32_t ll[NUM_LL];
  int32_t of[NUM_OF];
  uint32_t words[TR][MAX_ROW_OUT / 4];
  alignas(16) uint8_t out[TR * (MAX_ROW_OUT + 1)];
  int rowsum[TR];
  long long rowbase[TR];
  int ticket;
};

__device__ __forceinline__ int bsr(int x) { return 31 - __clz(max(x, 1)); }

// The low n (<= 16) bits of v reversed (static_codes.bitrev).
__device__ __forceinline__ unsigned bitrev(unsigned v, int n) {
  return (__brev(v & 0xFFFFu) >> 16) >> (16 - n);
}

// (symbol 257..285, extra value, extra bits) of a length 4..258
// (static_codes.length_sym_fields).
__device__ __forceinline__ void length_sym(int len, int& sym, int& extra,
                                           int& eb) {
  const int n = len - 3;
  if (len == 258) {
    sym = 285, extra = 0, eb = 0;
  } else if (n < 8) {
    sym = 257 + n, extra = 0, eb = 0;
  } else {
    eb = bsr(n) - 2;
    sym = 257 + (eb << 2) + (n >> eb);
    extra = n & ((1 << eb) - 1);
  }
}

// (symbol 0..29, extra value, extra bits) of a distance 1..32,768
// (static_codes.offset_sym_fields).
__device__ __forceinline__ void offset_sym(int d, int& sym, int& extra,
                                           int& eb) {
  const int o = d - 1;
  const int b = bsr(o);
  sym = o < 4 ? o : 2 * b + ((o >> max(b - 1, 0)) & 1);
  eb = max(sym / 2 - 1, 0);
  extra = o - (sym < 4 ? sym : (2 + (sym & 1)) << eb);
}

// The offset part that a sel lane's match hands to the next lane.
__device__ __forceinline__ void ride(const Shared& sh, bool sel, int dist,
                                     unsigned& val, int& nb) {
  val = 0, nb = 0;
  if (!sel) return;
  int sym, extra, eb;
  offset_sym(min(max(dist, 1), WINDOW), sym, extra, eb);
  const int ent = sh.of[sym];
  const int len = ent >> 16;
  val = static_cast<unsigned>(ent & 0xFFFF) |
        (static_cast<unsigned>(extra) << len);
  nb = len + eb;
}

// A lane's own token in dynamic mode, before the ride is added.
__device__ __forceinline__ void dynamic_token(const Shared& sh, bool sel,
                                              bool lit, int ml, int byte,
                                              unsigned& val, int& nb) {
  val = 0, nb = 0;
  if (sel) {
    int sym, extra, eb;
    length_sym(max(ml, MIN_MATCH), sym, extra, eb);
    const int ent = sh.ll[min(sym, NUM_LL - 1)];
    const int len = ent >> 16;
    val = static_cast<unsigned>(ent & 0xFFFF) |
          (static_cast<unsigned>(extra) << len);
    nb = len + eb;
  } else if (lit) {
    const int ent = sh.ll[byte];
    val = static_cast<unsigned>(ent & 0xFFFF);
    nb = ent >> 16;
  }
}

// A lane's token in static mode (static_codes.literal_code and
// match_token).
__device__ __forceinline__ void static_token(bool sel, bool lit, int ml,
                                             int dist, int byte,
                                             unsigned& val, int& nb) {
  val = 0, nb = 0;
  if (sel) {
    int sym, extra, eb;
    length_sym(max(ml, MIN_MATCH), sym, extra, eb);
    const bool sym8 = sym >= 280;
    nb = sym8 ? 8 : 7;
    val = bitrev(sym8 ? 0xC0 + sym - 280 : sym - 256, nb);
    val |= static_cast<unsigned>(extra) << nb;
    nb += eb;
    int dsym, dextra, deb;
    offset_sym(min(max(dist, 1), WINDOW), dsym, dextra, deb);
    val |= bitrev(dsym, 5) << nb;
    nb += 5;
    val |= static_cast<unsigned>(dextra) << nb;
    nb += deb;
  } else if (lit) {
    const bool hi = byte >= 144;
    nb = hi ? 9 : 8;
    val = bitrev(hi ? 0x190 + byte - 144 : 0x30 + byte, nb);
  }
}

// The start bit of tile k of a block: the bits of the block's earlier
// tiles down to the nearest one whose word holds an inclusive prefix,
// read by warp 0, 32 words at a time, nearest first.
__device__ long long look_back(const unsigned long long* status, int k) {
  const int lane = threadIdx.x & 31;
  long long sum = 0;
  for (int j = k - 1;; j -= 32) {
    const int idx = j - lane;
    unsigned long long v;
    unsigned inc, upto;
    do {
      v = idx >= 0 ? *reinterpret_cast<const volatile unsigned long long*>(
                         &status[idx])
                   : INC;
      inc = __ballot_sync(FULL, (v & INC) != 0);
      const int first = __ffs(inc);     // 1 + the nearest INC lane, or 0
      upto = first == 0 || first == 32 ? FULL : (1u << first) - 1;
    } while (__ballot_sync(FULL, v == 0) & upto);
    long long x = (upto >> lane) & 1u ? static_cast<long long>(v & VALUE)
                                      : 0;
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
    sum += x;
    if (inc) return sum;
  }
}

template <bool DYN>
__global__ void __launch_bounds__(NT) emit_kernel(Args a) {
  constexpr int RO = DYN ? MAX_ROW_OUT : 48;    // row_out
  constexpr int NWORDS = RO / 4;
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) sh.ticket = static_cast<int>(atomicAdd(a.ticket, 1u));
  __syncthreads();
  const int ticket = sh.ticket;
  const int bi = ticket / a.ntiles, k = ticket % a.ntiles;
  const int rr = tid / TPR, q = tid % TPR;      // the thread's row, part
  const int row = k * TR + rr;
  const bool live = row < a.r;
  const long long pos0 = static_cast<long long>(row) * ROW + q * K;

  // ---- flags and bytes, then (ml, dist) of the pairs with a sel lane
  unsigned long long selw = 0, litw = 0;        // byte j: lane j's flag
  int byte[K], ml[K], dist[K];
#pragma unroll
  for (int j = 0; j < K; ++j) byte[j] = ml[j] = dist[j] = 0;
  bool prev_sel = false;
  int prev_dist = 0;
  if (live) {
    selw = *reinterpret_cast<const unsigned long long*>(
        a.sel + bi * a.sel_stride + pos0);
    litw = *reinterpret_cast<const unsigned long long*>(
        a.lit + bi * a.lit_stride + pos0);
    const uint8_t* d = a.data + bi * a.data_stride + pos0;
#pragma unroll
    for (int j = 0; j < K; ++j) byte[j] = d[j];
    const longlong2* mp =
        reinterpret_cast<const longlong2*>(a.ml + bi * a.ml_stride + pos0);
    const longlong2* dp = reinterpret_cast<const longlong2*>(
        a.dist + bi * a.dist_stride + pos0);
#pragma unroll
    for (int p = 0; p < K / 2; ++p) {
      if ((selw >> (16 * p)) & 0xFFFFull) {
        const longlong2 m = mp[p], x = dp[p];
        ml[2 * p] = static_cast<int>(m.x);
        ml[2 * p + 1] = static_cast<int>(m.y);
        dist[2 * p] = static_cast<int>(x.x);
        dist[2 * p + 1] = static_cast<int>(x.y);
      }
    }
    if (DYN && lane == 0 && pos0 > 0) {         // the lane before the warp
      prev_sel = a.sel[bi * a.sel_stride + pos0 - 1] != 0;
      if (prev_sel)
        prev_dist = static_cast<int>(a.dist[bi * a.dist_stride + pos0 - 1]);
    }
  }
  if (DYN) {
    for (int i = tid; i < NUM_LL + NUM_OF; i += NT) {
      if (i < NUM_LL)
        sh.ll[i] = a.ll_tab[static_cast<long long>(bi) * NUM_LL + i];
      else
        sh.of[i - NUM_LL] =
            a.of_tab[static_cast<long long>(bi) * NUM_OF + i - NUM_LL];
    }
  }
  for (int i = tid; i < TR * (MAX_ROW_OUT / 4); i += NT)
    (&sh.words[0][0])[i] = 0;
  __syncthreads();

  // ---- tokens, the rides, and the thread's place in its row
  unsigned val[K];
  int nb[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const bool s_ = (selw >> (8 * j)) & 1ull, l_ = (litw >> (8 * j)) & 1ull;
    if (DYN)
      dynamic_token(sh, s_, l_, ml[j], byte[j], val[j], nb[j]);
    else
      static_token(s_, l_, ml[j], dist[j], byte[j], val[j], nb[j]);
  }
  if (DYN) {
    unsigned rv;
    int rn;
#pragma unroll
    for (int j = 0; j < K - 1; ++j) {
      ride(sh, (selw >> (8 * j)) & 1ull, dist[j], rv, rn);
      val[j + 1] |= rv;
      nb[j + 1] += rn;
    }
    ride(sh, (selw >> (8 * (K - 1))) & 1ull, dist[K - 1], rv, rn);
    unsigned pv = __shfl_up_sync(FULL, rv, 1);
    int pn = __shfl_up_sync(FULL, rn, 1);
    if (lane == 0) ride(sh, prev_sel, prev_dist, pv, pn);
    if (live) {          // the block's last lane's ride goes nowhere
      val[0] |= pv;
      nb[0] += pn;
    }
  }
  int sum = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) sum += nb[j];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o, TPR);
    if (q >= o) incl += y;
  }
  if (q == TPR - 1) sh.rowsum[rr] = incl;
  __syncthreads();

  // ---- the tile's base: its row sums scanned, then the look-back
  if (tid < 32) {
    const int v0 = sh.rowsum[2 * lane], v1 = sh.rowsum[2 * lane + 1];
    long long t = v0 + v1;
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(FULL, t, o);
      if (lane >= o) t += y;
    }
    const long long agg = __shfl_sync(FULL, t, 31);
    unsigned long long* status =
        a.status + static_cast<long long>(bi) * a.ntiles;
    long long base;
    if (k == 0) {
      base = a.start_bits[bi];
    } else {
      if (lane == 0)
        *reinterpret_cast<volatile unsigned long long*>(&status[k]) =
            AGG | static_cast<unsigned long long>(agg);
      base = look_back(status, k);
    }
    if (lane == 0) {
      *reinterpret_cast<volatile unsigned long long*>(&status[k]) =
          INC | static_cast<unsigned long long>(base + agg);
      if (k == a.ntiles - 1) a.end_bits[bi] = base + agg;
    }
    const long long e = base + t - v0 - v1;
    sh.rowbase[2 * lane] = e;
    sh.rowbase[2 * lane + 1] = e + v0;
  }
  __syncthreads();

  // ---- the tokens added into their row's frame words
  const long long bit0 = sh.rowbase[rr], word0 = bit0 >> 5;
  long long bit = bit0 + incl - sum;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const long long w = (bit >> 5) - word0;
    const int shift = static_cast<int>(bit & 31);
    const unsigned lo = val[j] << shift;
    const unsigned hi = shift ? val[j] >> (32 - shift) : 0u;
    if (lo && w < NWORDS) atomicAdd(&sh.words[rr][w], lo);
    if (hi && w + 1 < NWORDS) atomicAdd(&sh.words[rr][w + 1], hi);
    bit += nb[j];
  }
  const long long at = static_cast<long long>(bi) * a.r + row;
  if (live && q == 0) {
    a.byte_off[at] = bit0 >> 3;
    a.row_bit0[at] = bit0;
  }
  __syncwarp();                         // a row's threads share a warp

  // ---- each warp stages its rows' bytes; the block writes the tile's
  const int wrow = (tid >> 5) * RPW;
  for (int j = lane; j < RPW * (RO + 1); j += 32) {
    const int i = j / (RO + 1), c = j - i * (RO + 1);
    const long long b0 = sh.rowbase[wrow + i];
    const int src = static_cast<int>((b0 >> 3) - 4 * (b0 >> 5)) + c;
    sh.out[(wrow + i) * (RO + 1) + c] =
        src < RO ? static_cast<uint8_t>(sh.words[wrow + i][src >> 2] >>
                                        (8 * (src & 3)))
                 : 0;
  }
  __syncthreads();
  const int nbytes = min(TR, a.r - k * TR) * (RO + 1);
  uint8_t* dst =
      a.rows + (static_cast<long long>(bi) * a.r + k * TR) * (RO + 1);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    done = nbytes / 16 * 16;
    for (int i = tid; i < nbytes / 16; i += NT)
      reinterpret_cast<uint4*>(dst)[i] =
          reinterpret_cast<const uint4*>(sh.out)[i];
  }
  for (int i = done + tid; i < nbytes; i += NT) dst[i] = sh.out[i];
}

}  // namespace

// ldrsx_emit_scratch: bytes of the state ldrsx_emit needs for b blocks of
// r rows (8-byte aligned: the status words, then the ticket).
extern "C" long long ldrsx_emit_scratch(int b, int r) {
  if (b <= 0 || r <= 0) return 0;
  return 8 * static_cast<long long>(b) * ((r + TR - 1) / TR) + 8;
}

// Code and pack b blocks of r rows of 32 lanes: data uint8, ml and dist
// int64, sel and lit bool, each (b, >= 32 r) with rows of the given
// strides (in elements) and lanes contiguous, the flags' rows 8-byte
// aligned and (ml, dist)'s 16-byte aligned; ll_tab (b, 288) and of_tab
// (b, 30) int32 (code | len << 16, len <= 15) for the dynamic mode, or
// both null for the static mode; start_bits int64 (b,). Outputs: rows
// uint8 (b, r, row_out + 1) with row_out 64 (dynamic) or 48 (static),
// byte_off and row_bit0 int64 (b, r), end_bits int64 (b,); scratch the
// state (ldrsx_emit_scratch bytes, 8-byte aligned; cleared here).
// Returns a CUDA error code (0: launched).
extern "C" int ldrsx_emit(const void* data, long long data_stride,
                          const void* ml, long long ml_stride,
                          const void* dist, long long dist_stride,
                          const void* sel, long long sel_stride,
                          const void* lit, long long lit_stride,
                          const void* ll_tab, const void* of_tab,
                          const void* start_bits, int b, int r, void* rows,
                          void* byte_off, void* row_bit0, void* end_bits,
                          void* scratch, void* stream) {
  if (b <= 0) return 0;
  const bool dyn = ll_tab != nullptr;
  // 8-byte loads of the flags, 16-byte loads of (ml, dist) lane pairs
  const auto misaligned = [](const void* p, long long stride, int align) {
    return (reinterpret_cast<uintptr_t>(p) & (align - 1)) ||
           (stride & (align - 1));
  };
  if (r <= 0 || (dyn != (of_tab != nullptr)) ||
      misaligned(sel, sel_stride, 8) || misaligned(lit, lit_stride, 8) ||
      misaligned(ml, 8 * ml_stride, 16) ||
      misaligned(dist, 8 * dist_stride, 16) ||
      (reinterpret_cast<uintptr_t>(scratch) & 7))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = (r + TR - 1) / TR;
  const long long blocks = static_cast<long long>(b) * ntiles;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.data = static_cast<const uint8_t*>(data);
  a.ml = static_cast<const int64_t*>(ml);
  a.dist = static_cast<const int64_t*>(dist);
  a.sel = static_cast<const uint8_t*>(sel);
  a.lit = static_cast<const uint8_t*>(lit);
  a.data_stride = data_stride;
  a.ml_stride = ml_stride;
  a.dist_stride = dist_stride;
  a.sel_stride = sel_stride;
  a.lit_stride = lit_stride;
  a.ll_tab = static_cast<const int32_t*>(ll_tab);
  a.of_tab = static_cast<const int32_t*>(of_tab);
  a.start_bits = static_cast<const int64_t*>(start_bits);
  a.r = r;
  a.ntiles = ntiles;
  a.rows = static_cast<uint8_t*>(rows);
  a.byte_off = static_cast<int64_t*>(byte_off);
  a.row_bit0 = static_cast<int64_t*>(row_bit0);
  a.end_bits = static_cast<int64_t*>(end_bits);
  a.status = static_cast<unsigned long long*>(scratch);
  a.ticket = reinterpret_cast<unsigned*>(a.status + blocks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(scratch, 0, 8 * blocks + 8, st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (dyn)
    emit_kernel<true><<<static_cast<unsigned>(blocks), NT, 0, st>>>(a);
  else
    emit_kernel<false><<<static_cast<unsigned>(blocks), NT, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
