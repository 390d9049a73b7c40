// Emit of the device encoders on NVIDIA Hopper (sm_90a): every lane's
// token coded and the tokens bit-packed into row buffers, in one launch.
//
// Replaces the XLA graphs that follow the table step in the JAX package:
// ops/encode_dynamic.py emit_pack (:89, levels 4-9) and, in
// ops/encode_v2.py, the static coding of encode_rows_static (:348,
// :363-370, levels 1-3), both of which end in pack_rows (:277). pack_rows
// is a TPU workaround by its own words: a cumsum and a one-hot matmul
// that places each token's bytes as bf16 planes, since a gather or
// scatter costs the TPU 9-19 ms a million elements. The plain PyTorch
// version of this kernel is ops/emit.py's emit_plain (the port's copy of
// those graphs, with a scatter-add of words for the matmul); the kernel
// gives its four outputs exactly, every padding byte of the rows
// included.
//
// The function, per block of s lanes (R = s / 32 rows) with start_bits:
//  - dynamic mode (tables given, row_out 64): a lane that is sel codes
//    its length symbol through ll_tab (code | len << 16, len <= 15) with
//    the length's extra bits above it, a lit lane its byte, any other
//    lane nothing; a sel lane's offset code through of_tab with its extra
//    bits rides the next lane: ORed into its value, its bit count added;
//    the block's last lane's ride goes nowhere;
//  - static mode (row_out 48): a sel lane the fused static match token,
//    a lit lane the static literal code, any other lane nothing; every
//    block starts at bit 3 (the block header);
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
// What bounds it on this card: bytes, in principle. The function needs
// every lane's sel flag, the lit flag of a lane not sel, the byte of a
// literal and (ml, dist) of a sel lane only (~7 % of the lanes on the L6
// pass), and writes each row's 65 bytes and two int64 once: ~0.03 ms for
// the L6 pass's 259 blocks of the Silesia-like corpus at the card's
// memory rate (chip_smoke.py's emit_bytes counts them from the pass's
// tokens). Its arithmetic is a few dozen integer operations a lane, and
// the one carry is the running bit count, a prefix sum over a whole
// block. In practice the time goes to the instructions of each tile's
// coding, gathers and packing and to their chains of dependent
// shared-memory loads, shuffles and barriers, at the 24 warps an SM that
// the registers leave (scripts/emit_probe.py --ablate cuts one stage at a
// time: none takes over a third). What held the first design (a
// thread block a tile of 2,048 lanes, PR 16) back: the fixed cost of each
// of 8,288 thread blocks (a ticket, the block's 318 table entries, four
// barriers, a look-back over up to 31 tiles), loads in series (the
// (ml, dist) pairs waited on the flags) and every lane running the match
// path (a warp's lanes diverge on it).
//
// The design:
//  - a persistent grid, as many 256-thread blocks as are resident on the
//    card at once (three an SM) or as half the tiles, whichever is fewer
//    (a small pass, an L1 item's 512 tiles, then keeps two tiles in each
//    block's pipeline), each walking steps j = 0, 1, ...: a tile
//    of 64 rows (2,048 lanes) of one block a step, the tiles taken in
//    ticket order from a global counter (so a tile waits only on tiles
//    that running blocks hold). A tile's tokens wait in registers for its
//    base; chunks of two to eight tiles a step were slower on every pass
//    measured (two tiles' tokens cost the third block an SM, four and
//    eight spill), so a step is one tile;
//  - a tile's sel, lit and byte rows come into shared memory by 1-D bulk
//    copies (cp.async.bulk, TMA) completing on an mbarrier, in a ring of
//    three, issued two steps ahead; a row that starts off 16 bytes is
//    copied rounded out to 16 bytes where the wrapper finds that inside
//    the tensor's storage, else its aligned middle, its first and last
//    bytes read by the threads that hold them: the wrapper copies nothing;
//  - once a tile's flags land, each thread issues 4-byte cp.async copies
//    of the low words of (ml, dist) of its sel lanes only (the kernel
//    codes from the low 32 bits), which fly while the tile before is
//    coded; the tile's tables, the lane before the tile and the lane
//    before each warp come the same way;
//  - a thread codes 8 consecutive lanes (a row is 4 threads, a warp 8
//    rows): each lane's literal itself, the warp's sel lanes one a lane
//    (their length code and the offset that rides the next lane, written
//    in place of their (ml, dist)), so the match path runs once a match;
//    the ride passes to the next lane in the thread, from the thread
//    before, or into a warp's first lane from the lane before it; a
//    thread past the block's last row takes none;
//  - each row's bit offsets by a shuffle scan of its 4 threads' sums;
//    warp 0 scans the tile's row sums and publishes its aggregate (the
//    block's first tile, its inclusive prefix), and takes the base of
//    the tile this block coded a step earlier by a decoupled look-back
//    over the block's earlier tiles' status words (aggregate or
//    inclusive prefix, one 64-bit word each); so the tiles before it have
//    had a step's time to publish and the wait is short. That tile's
//    tokens wait in a second set of registers;
//  - each warp adds its 8 rows' tokens into the rows' frame words in
//    shared memory (an atomic a touched word, the tokens of a word summed
//    in registers first), builds the rows' bytes and writes them,
//    contiguous in the output, with 16-byte stores, and byte_off and
//    row_bit0; no block barrier in the packing;
//  - the state (the tiles' status words and two counters) is left
//    zeroed by the block that exits last, so a call needs no clear: the
//    wrapper keeps one zeroed buffer per stream.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int ROW = 32;          // lanes a row
constexpr int K = 8;             // lanes a thread
constexpr int TPR = ROW / K;     // threads a row
constexpr int NW = 8;            // warps a block
constexpr int NT = 32 * NW;      // threads a block
constexpr int TR = NT / TPR;     // rows a tile
constexpr int TL = TR * ROW;     // lanes a tile
constexpr int RPW = 32 / TPR;    // rows a warp
constexpr int STAGES = 3;        // tiles of flags and bytes in flight
constexpr int NUM_LL = 288, NUM_OF = 30;
constexpr int MIN_MATCH = 4, WINDOW = 32768;
constexpr int MAX_ROW_OUT = 64;  // bytes of a row's frame (dynamic mode)
constexpr int STAGE_BYTES = TL + 32;
constexpr int OUT_BYTES = (16 + RPW * (MAX_ROW_OUT + 1) + 15) / 16 * 16;
constexpr int N_STAMPS = 11;
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xFFFFFFFFu;
// a tile's status word: 0 until written, then a flag and a bit count
constexpr uint64_t AGG = 1ull << 62;   // the tile's own bits
constexpr uint64_t INC = 1ull << 63;   // start_bits + bits up to its end
constexpr uint64_t VALUE = AGG - 1;
static_assert(RPW == 8 && TR == 64, "the staging and packing layout");

struct Args {
  const uint8_t* data;
  const int64_t* ml;
  const int64_t* dist;
  const uint8_t* sel;
  const uint8_t* lit;
  long long data_stride, ml_stride, dist_stride, sel_stride, lit_stride;
  const int32_t* ll_tab;         // (b, 288); null: static mode
  const int32_t* of_tab;         // (b, 30)
  const int64_t* start_bits;     // (b,); null: every block starts at 3
  int r, tpb, total;             // rows a block, tiles a block, tiles
  int round;                     // bit v: array v's copies may round out
  uint8_t* rows;                 // (b, r, row_out + 1)
  int64_t* byte_off;             // (b, r)
  int64_t* row_bit0;             // (b, r)
  int64_t* end_bits;             // (b,)
  unsigned* ticket;              // the state: zero on entry and on exit
  unsigned* exited;
  unsigned long long* status;    // (b, tpb)
  long long* stamps;             // null, or N_STAMPS words (block 0)
};

// Dynamic shared memory of a block.
struct alignas(16) Smem {
  uint8_t stage[STAGES][3][STAGE_BYTES];     // sel, lit, bytes of a tile
  int32_t gml[2][TL];     // low words of ml, dist of a tile's sel lanes,
  int32_t gdist[2][TL];   // then their match token and offset ride
  uint8_t mnb[TL], rnb[TL];                  // and those tokens' bits
  int32_t ll[2][NUM_LL];                     // a tile's tables, the
  int32_t of[2][NUM_OF];                     // next tile's beside them
  int32_t thalo[2][2];    // the lane before a tile: sel's word, dist
  int32_t whalo[2][NW];   // dist of the lane before each warp
  int rowsum[2][TR];      // two tiles' rows: their bits, and their
  int rowoff[2][TR];      // bits from their tile's start
  long long base[2];      // the tiles' first bits
  int agg[2];             // and their bits
  uint32_t words[NW][RPW][MAX_ROW_OUT / 4];  // each warp's rows' frames
  alignas(16) uint8_t out[NW][OUT_BYTES];    // each warp's rows' bytes
  unsigned long long bar[STAGES];
  long long acc[N_STAMPS];
  int tile[4], tbi[4], tk[4];   // step j's tile, block, tile of the
  int last;                     // block, at j & 3
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ void wait_bar(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (int tries = 0; !done; ++tries) {
    if (tries > (1 << 22)) __trap();     // the copy never landed: fail
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

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
__device__ __forceinline__ void ride(const int32_t* of, bool sel, int dist,
                                     unsigned& val, int& nb) {
  val = 0, nb = 0;
  if (!sel) return;
  int sym, extra, eb;
  offset_sym(min(max(dist, 1), WINDOW), sym, extra, eb);
  const int ent = of[sym];
  const int len = ent >> 16;
  val = static_cast<unsigned>(ent & 0xFFFF) |
        (static_cast<unsigned>(extra) << len);
  nb = len + eb;
}

// A lane's own token in dynamic mode, before the ride is added.
__device__ __forceinline__ void dynamic_token(const int32_t* ll, bool sel,
                                              bool lit, int ml, int byte,
                                              unsigned& val, int& nb) {
  val = 0, nb = 0;
  if (sel) {
    int sym, extra, eb;
    length_sym(max(ml, MIN_MATCH), sym, extra, eb);
    const int ent = ll[min(sym, NUM_LL - 1)];
    const int len = ent >> 16;
    val = static_cast<unsigned>(ent & 0xFFFF) |
          (static_cast<unsigned>(extra) << len);
    nb = len + eb;
  } else if (lit) {
    const int ent = ll[byte];
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

// One tile of one array (sel, lit or bytes) staged: its lanes [0, n) start
// at `g` in device memory; lane i sits at index i + o of the stage buffer
// (o = g & 15), and the bulk copy fills the indices [lo, hi): the lanes
// rounded out to 16 bytes where `round` (the wrapper found that stays in
// the tensor's storage), else the 16-byte aligned middle, the lanes
// outside it read from `g`.
struct Span {
  const uint8_t* g;
  int o, lo, hi;
};

__device__ __forceinline__ Span span_of(const uint8_t* g, int n, bool round) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(g);
  Span s;
  s.g = g;
  s.o = static_cast<int>(a & 15);
  if (round) {
    s.lo = 0;
    s.hi = n > 0 ? (s.o + n + 15) & ~15 : 0;
    return s;
  }
  const uintptr_t lo = (a + 15) & ~static_cast<uintptr_t>(15);
  const uintptr_t hi = (a + n) & ~static_cast<uintptr_t>(15);
  s.lo = static_cast<int>(lo - (a - s.o));
  s.hi = hi > lo ? static_cast<int>(hi - (a - s.o)) : s.lo;
  return s;
}

// Lanes i..i+7 of a staged array as 8 bytes (byte e: lane i + e).
__device__ __forceinline__ uint64_t lanes8(const uint8_t* buf, const Span& s,
                                           int i) {
  const int k = i + s.o;
  if (k >= s.lo && k + 8 <= s.hi) {
    const uint64_t* w = reinterpret_cast<const uint64_t*>(buf);
    const int sh = (k & 7) * 8;
    uint64_t v = w[k >> 3];
    if (sh) v = (v >> sh) | (w[(k >> 3) + 1] << (64 - sh));
    return v;
  }
  uint64_t v = 0;
#pragma unroll
  for (int e = 0; e < K; ++e) {
    const int x = k + e;
    const uint64_t b = x >= s.lo && x < s.hi ? buf[x] : s.g[i + e];
    v |= b << (8 * e);
  }
  return v;
}

__device__ __forceinline__ int lane1(const uint8_t* buf, const Span& s,
                                     int i) {
  const int x = i + s.o;
  return x >= s.lo && x < s.hi ? buf[x] : s.g[i];
}

// One thread: the tile of step j (a new ticket, taken only two steps
// ahead, so that no block holds a tile it will not start for long: the
// tiles after it wait on its aggregate), its block and its place in the
// block.
__device__ __forceinline__ void plan(const Args& a, Smem& sh, int j) {
  const int prev = j > 0 ? sh.tile[(j - 1) & 3] : 0;
  const int t =
      prev < a.total ? static_cast<int>(atomicAdd(a.ticket, 1u)) : prev;
  const int bi = t / a.tpb;
  sh.tile[j & 3] = t;
  sh.tbi[j & 3] = bi;
  sh.tk[j & 3] = t - bi * a.tpb;
}

// Step j's tile: its block, its place in the block, its lanes and its
// first lane.
struct Tile {
  int bi, k, n;
  long long p0;
};

__device__ __forceinline__ Tile tile_of(const Args& a, const Smem& sh,
                                        int j) {
  Tile x;
  x.bi = sh.tbi[j & 3];
  x.k = sh.tk[j & 3];
  x.n = min(max(a.r - x.k * TR, 0), TR) * ROW;
  x.p0 = static_cast<long long>(x.k) * TL;
  return x;
}

// One thread: the bulk copies of step j's sel, lit and byte rows into
// stage j % STAGES, completing on its barrier, which completes its phase
// empty if step j has no tile; the tile's ids written before are seen by
// every thread that waits on the barrier.
__device__ __forceinline__ void issue(const Args& a, Smem& sh, int j) {
  const uint32_t bar = smem_addr(&sh.bar[j % STAGES]);
  if (sh.tile[j & 3] >= a.total) {    // no tile: the phase completes empty
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
                 : "memory");
    return;
  }
  const Tile x = tile_of(a, sh, j);
  const uint8_t* src[3] = {a.sel + x.bi * a.sel_stride + x.p0,
                           a.lit + x.bi * a.lit_stride + x.p0,
                           a.data + x.bi * a.data_stride + x.p0};
  Span sp[3];
  uint32_t bytes = 0;
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    sp[v] = span_of(src[v], x.n, (a.round >> v) & 1);
    bytes += sp[v].hi - sp[v].lo;
  }
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    if (sp[v].hi > sp[v].lo)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];" ::"r"(
              smem_addr(sh.stage[j % STAGES][v] + sp[v].lo)),
          "l"(src[v] - sp[v].o + sp[v].lo), "r"(static_cast<uint32_t>(
                                               sp[v].hi - sp[v].lo)),
          "r"(bar)
          : "memory");
  }
}

// Every thread: the cp.async copies that step j needs beside its bulk
// copies, once its flags have landed: (ml, dist) of the thread's sel
// lanes; in the dynamic mode the lanes before the tile and before each
// warp, and the tile's tables.
template <bool DYN>
__device__ __forceinline__ void gather(const Args& a, Smem& sh, int j) {
  if (sh.tile[j & 3] >= a.total) return;
  const Tile x = tile_of(a, sh, j);
  const int tid = threadIdx.x, i = tid * K, g = j & 1;
  if (i < x.n) {
    const Span sp =
        span_of(a.sel + x.bi * a.sel_stride + x.p0, x.n, a.round & 1);
    const uint64_t selw = lanes8(sh.stage[j % STAGES][0], sp, i);
    if (selw) {
      const int64_t* mp = a.ml + x.bi * a.ml_stride + x.p0 + i;
      const int64_t* dp = a.dist + x.bi * a.dist_stride + x.p0 + i;
#pragma unroll
      for (int e = 0; e < K; ++e) {
        if ((selw >> (8 * e)) & 1) {
          cp4(&sh.gml[g][i + e], mp + e);
          cp4(&sh.gdist[g][i + e], dp + e);
        }
      }
    }
    if (DYN && (tid & 31) == 0 && tid > 0 &&
        lane1(sh.stage[j % STAGES][0], sp, i - 1))
      cp4(&sh.whalo[g][tid >> 5],
          a.dist + x.bi * a.dist_stride + x.p0 + i - 1);
  }
  if (DYN && tid == 0 && x.p0 > 0 && x.n > 0) {
    // the sel flag's aligned word (inside the row: p0 >= TL) and dist's
    // low word of the lane before the tile
    const uint8_t* f = a.sel + x.bi * a.sel_stride + x.p0 - 1;
    cp4(&sh.thalo[g][0], reinterpret_cast<const void*>(
                             reinterpret_cast<uintptr_t>(f) & ~uintptr_t{3}));
    cp4(&sh.thalo[g][1], a.dist + x.bi * a.dist_stride + x.p0 - 1);
  }
  if (DYN) {
    for (int e = tid; e < NUM_LL + NUM_OF; e += NT) {
      if (e < NUM_LL)
        cp4(&sh.ll[g][e],
            a.ll_tab + static_cast<long long>(x.bi) * NUM_LL + e);
      else
        cp4(&sh.of[g][e - NUM_LL],
            a.of_tab + static_cast<long long>(x.bi) * NUM_OF + e - NUM_LL);
    }
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
    int tries = 0;
    do {
      if (++tries > (1 << 24)) __trap();   // a tile never published
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

// Stage times of block 0 (thread 0's view), summed over its tiles.
enum Stage {
  kBulkWait, kGatherWait, kIssue, kCode, kScan, kLookBack, kPack, kStore,
  kTotal, kNanos, kTiles
};

// Blocks resident an SM that the kernel's registers are held to (80).
constexpr int MIN_BLOCKS = 3;

// Code step j's tile: each lane's own literal, the warp's
// matches one a lane, then the rides; the thread's 8 tokens (val, their
// bit counts a byte each in nbp) and its bits before it in its row (excl),
// and the row's bits into rowsum.
template <bool DYN>
__device__ __forceinline__ void code_tile(const Args& a, Smem& sh, int j,
                                          const int32_t* ll,
                                          const int32_t* of, unsigned* val,
                                          uint32_t* nbp, int& excl,
                                          int* rowsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = tid * K, g = j & 1;
  const Tile x = tile_of(a, sh, j);
  const bool live = i0 < x.n;
  const uint8_t* st_sel = sh.stage[j % STAGES][0];
  const Span sp_sel =
      span_of(a.sel + x.bi * a.sel_stride + x.p0, x.n, a.round & 1);
  uint64_t selw = 0, litw = 0, bytew = 0;
  if (live) {
    selw = lanes8(st_sel, sp_sel, i0);
    litw = lanes8(sh.stage[j % STAGES][1],
                  span_of(a.lit + x.bi * a.lit_stride + x.p0, x.n,
                          (a.round >> 1) & 1),
                  i0);
    bytew = lanes8(sh.stage[j % STAGES][2],
                   span_of(a.data + x.bi * a.data_stride + x.p0, x.n,
                           (a.round >> 2) & 1),
                   i0);
  }
  int nb[K];
#pragma unroll
  for (int e = 0; e < K; ++e) {
    const bool l_ = ((litw & ~selw) >> (8 * e)) & 1;
    const int byte = static_cast<int>((bytew >> (8 * e)) & 0xFF);
    if (DYN)
      dynamic_token(ll, false, l_, 0, byte, val[e], nb[e]);
    else
      static_token(false, l_, 0, 0, byte, val[e], nb[e]);
  }
  // the sel lanes: bit e of m8 is lane e's flag; the warp's are coded one
  // a lane, in place of their gathered (ml, dist)
  const uint32_t m8 = static_cast<uint32_t>(
      ((selw & 0x0101010101010101ull) * 0x0102040810204080ull) >> 56);
  unsigned bal[K];
  int pre[K + 1];
  pre[0] = 0;
#pragma unroll
  for (int e = 0; e < K; ++e) {
    bal[e] = __ballot_sync(FULL, (m8 >> e) & 1);
    pre[e + 1] = pre[e] + __popc(bal[e]);
  }
  for (int xx = lane; xx < pre[K]; xx += 32) {
    // the xx-th sel lane of the warp: lane e of a thread in bal[e]
    int e = 0, before = 0;
    unsigned m = bal[0];
#pragma unroll
    for (int u = 1; u < K; ++u) {
      if (xx >= pre[u]) e = u, before = pre[u], m = bal[u];
    }
    for (int rk = xx - before; rk > 0; --rk) m &= m - 1;
    const int p = (warp * 32 + __ffs(m) - 1) * K + e;
    const int mlv = sh.gml[g][p], dv = sh.gdist[g][p];
    unsigned mv;
    int mn;
    if (DYN) {
      dynamic_token(ll, true, false, mlv, 0, mv, mn);
      unsigned rv;
      int rn;
      ride(of, true, dv, rv, rn);
      sh.gdist[g][p] = static_cast<int32_t>(rv);
      sh.rnb[p] = static_cast<uint8_t>(rn);
    } else {
      static_token(true, false, mlv, dv, 0, mv, mn);
    }
    sh.gml[g][p] = static_cast<int32_t>(mv);
    sh.mnb[p] = static_cast<uint8_t>(mn);
  }
  __syncwarp();
#pragma unroll
  for (int e = 0; e < K; ++e) {
    if ((m8 >> e) & 1) {
      val[e] = static_cast<unsigned>(sh.gml[g][i0 + e]);
      nb[e] = sh.mnb[i0 + e];
    }
  }
  if (DYN) {
    // a sel lane's offset rides the next lane: within the thread, from
    // the thread before, or into the warp's first lane from the lane
    // before it (the warp before, or the tile before)
#pragma unroll
    for (int e = 1; e < K; ++e) {
      if ((m8 >> (e - 1)) & 1) {
        val[e] |= static_cast<unsigned>(sh.gdist[g][i0 + e - 1]);
        nb[e] += sh.rnb[i0 + e - 1];
      }
    }
    const uint32_t pm = __shfl_up_sync(FULL, m8, 1);
    if (live) {          // the block's last lane's ride goes nowhere
      if (lane > 0) {
        if ((pm >> (K - 1)) & 1) {
          val[0] |= static_cast<unsigned>(sh.gdist[g][i0 - 1]);
          nb[0] += sh.rnb[i0 - 1];
        }
      } else {
        bool ps = false;
        int pd = 0;
        if (tid > 0) {
          ps = lane1(st_sel, sp_sel, i0 - 1) != 0;
          pd = ps ? sh.whalo[g][warp] : 0;
        } else if (x.p0 > 0) {
          const int at = static_cast<int>(
              reinterpret_cast<uintptr_t>(a.sel + x.bi * a.sel_stride +
                                          x.p0 - 1) &
              3);
          ps = ((static_cast<unsigned>(sh.thalo[g][0]) >> (8 * at)) &
                0xFF) != 0;
          pd = sh.thalo[g][1];
        }
        unsigned pv;
        int pn;
        ride(of, ps, pd, pv, pn);
        val[0] |= pv;
        nb[0] += pn;
      }
    }
  }
  int sum = 0;
#pragma unroll
  for (int e = 0; e < K; ++e) sum += nb[e];
  nbp[0] = static_cast<uint32_t>(nb[0]) | static_cast<uint32_t>(nb[1]) << 8 |
           static_cast<uint32_t>(nb[2]) << 16 |
           static_cast<uint32_t>(nb[3]) << 24;
  nbp[1] = static_cast<uint32_t>(nb[4]) | static_cast<uint32_t>(nb[5]) << 8 |
           static_cast<uint32_t>(nb[6]) << 16 |
           static_cast<uint32_t>(nb[7]) << 24;
  int incl = sum;
  const int q = tid % TPR;
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o, TPR);
    if (q >= o) incl += y;
  }
  if (q == TPR - 1) rowsum[tid / TPR] = incl;
  excl = incl - sum;
}

// Where warp w's rows of a tile whose first row is row0 (nrows rows in the
// tile) go: the first of them, their count, their bytes in the output.
struct WarpRows {
  long long at0;
  int wrows, nbytes, al;
  uint8_t* dst;
};

template <int RO>
__device__ __forceinline__ WarpRows warp_rows(const Args& a, int bi, int row0,
                                              int nrows) {
  WarpRows w;
  const int wr0 = (threadIdx.x >> 5) * RPW;
  w.wrows = min(max(nrows - wr0, 0), RPW);
  w.at0 = static_cast<long long>(bi) * a.r + row0 + wr0;
  w.dst = a.rows + w.at0 * (RO + 1);
  w.nbytes = w.wrows * (RO + 1);
  w.al = static_cast<int>(reinterpret_cast<uintptr_t>(w.dst) & 15);
  return w;
}

// Warp w packs its rows of a tile whose first row is row0 (nrows rows in
// the tile; row i starts at bit base + rowoff[i]): the tokens added into
// the rows' frame words in shared memory, then the rows' bytes built in
// its staging buffer at the output's alignment.
template <bool DYN>
__device__ __forceinline__ void pack_tile(const Args& a, Smem& sh, int bi,
                                          int row0, int nrows,
                                          long long base, const int* rowoff,
                                          const unsigned* val,
                                          const uint32_t* nbp, int excl) {
  constexpr int RO = DYN ? MAX_ROW_OUT : 48;    // row_out
  constexpr int NWORDS = RO / 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rr = tid / TPR;
  uint32_t* wd = &sh.words[warp][0][0];
  for (int v = lane; v < RPW * (MAX_ROW_OUT / 4); v += 32) wd[v] = 0;
  __syncwarp();
  if (rr < nrows) {
    uint32_t* rw = sh.words[warp][lane / TPR];
    // bits from the row's first frame word to the thread's first
    int rel = static_cast<int>((base + rowoff[rr]) & 31) + excl;
    // the tokens of a word summed here, then one atomic a word
    int cw = -1;
    unsigned a0 = 0, a1 = 0;
    const auto flush = [&](bool go, int w, unsigned v) {
      if (go && v && w >= 0 && w < NWORDS) atomicAdd(&rw[w], v);
    };
#pragma unroll
    for (int e = 0; e < K; ++e) {
      const int w = rel >> 5, shift = rel & 31;
      const unsigned lo = val[e] << shift;
      const unsigned hi = shift ? val[e] >> (32 - shift) : 0u;
      const int d = w - cw;
      flush(d >= 1, cw, a0);
      flush(d >= 2, cw + 1, a1);
      a0 = (d == 0 ? a0 : d == 1 ? a1 : 0u) + lo;
      a1 = (d == 0 ? a1 : 0u) + hi;
      cw = w;
      rel += (nbp[e >> 2] >> (8 * (e & 3))) & 0xFF;
    }
    flush(true, cw, a0);
    flush(true, cw + 1, a1);
  }
  __syncwarp();
  // the rows' bytes: byte c of a row is its frame's byte delta + c
  const WarpRows w = warp_rows<RO>(a, bi, row0, nrows);
  rowoff += warp * RPW;
  uint8_t* ob = sh.out[warp] + w.al;
  for (int u = lane; u < w.wrows * NWORDS; u += 32) {
    const int i = u / NWORDS, m = u - i * NWORDS;
    const uint32_t* fw = sh.words[warp][i];
    const int d8 = static_cast<int>((base + rowoff[i]) & 24);
    const uint32_t v =
        __funnelshift_r(fw[m], m + 1 < NWORDS ? fw[m + 1] : 0u, d8);
    uint8_t* o = ob + i * (RO + 1) + 4 * m;
    o[0] = static_cast<uint8_t>(v);
    o[1] = static_cast<uint8_t>(v >> 8);
    o[2] = static_cast<uint8_t>(v >> 16);
    o[3] = static_cast<uint8_t>(v >> 24);
  }
  if (lane < w.wrows) ob[lane * (RO + 1) + RO] = 0;
  __syncwarp();
}

// Warp w writes its packed rows of the tile, contiguous in the output,
// with 16-byte stores, and their byte_off and row_bit0.
template <bool DYN>
__device__ __forceinline__ void store_tile(const Args& a, const Smem& sh,
                                           int bi, int row0, int nrows,
                                           long long base,
                                           const int* rowoff) {
  constexpr int RO = DYN ? MAX_ROW_OUT : 48;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const WarpRows w = warp_rows<RO>(a, bi, row0, nrows);
  rowoff += warp * RPW;
  const uint8_t* ob = sh.out[warp] + w.al;
  if (lane < w.wrows)
    a.byte_off[w.at0 + lane] = (base + rowoff[lane]) >> 3;
  else if (lane >= RPW && lane - RPW < w.wrows)
    a.row_bit0[w.at0 + lane - RPW] = base + rowoff[lane - RPW];
  const int head = min((16 - w.al) & 15, w.nbytes);
  if (lane < head) w.dst[lane] = ob[lane];
  const int body = (w.nbytes - head) / 16;
  for (int m = lane; m < body; m += 32)
    reinterpret_cast<uint4*>(w.dst + head)[m] =
        reinterpret_cast<const uint4*>(ob + head)[m];
  const int tail = head + body * 16;
  if (lane < w.nbytes - tail) w.dst[tail + lane] = ob[tail + lane];
  __syncwarp();
}

// The kernel: a persistent block walks steps j = 0, 1, ..., a tile taken
// in ticket order each; tile j is coded while tile j - 1 waits with its
// tokens in registers, then warp 0 publishes tile j's aggregate and takes
// tile j - 1's base by a look-back, and tile j - 1 is packed. STAMP: block
// 0's stage times into a.stamps (an instance of its own, so the others
// carry no clock reads).
template <bool DYN, bool STAMP>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) emit_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  Smem& sh = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool stamped = STAMP && blockIdx.x == 0 && tid == 0;
  long long clk = 0, t_tile = 0, ns_tile = 0;
  const auto tick = [&](int stage) {
    if (!stamped) return;
    const long long now = clock64();
    sh.acc[stage] += now - clk;
    clk = now;
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
          smem_addr(&sh.bar[s])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < N_STAMPS; ++s) sh.acc[s] = 0;
    plan(a, sh, 0);
    issue(a, sh, 0);
    plan(a, sh, 1);
    issue(a, sh, 1);
  }
  __syncthreads();
  wait_bar(smem_addr(&sh.bar[0]), 0);
  gather<DYN>(a, sh, 0);

  unsigned val[K], pval[K];             // this and the pending tile's
  uint32_t nbp[2], pnbp[2];             // tokens, their bits, the bits
  int excl = 0, pexcl = 0;              // before them in their row
  bool pending = false;                 // a tile coded, not packed
  int pbi = 0, pk = 0;                  // its block and place
  for (int j = 0;; ++j) {
    const int h = j & 1;                // this tile's arrays
    const bool valid = sh.tile[j & 3] < a.total;
    if (!valid && !pending) break;
    const int bi = sh.tbi[j & 3], k = sh.tk[j & 3];
    if (stamped) {
      clk = t_tile = clock64();
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns_tile));
    }
    if (valid) {
      cp_wait_all();                    // this step's gathers
      __syncthreads();
      tick(kGatherWait);
      wait_bar(smem_addr(&sh.bar[(j + 1) % STAGES]), ((j + 1) / 3) & 1);
      tick(kBulkWait);
      gather<DYN>(a, sh, j + 1);
      tick(kIssue);
      code_tile<DYN>(a, sh, j, sh.ll[h], sh.of[h], val, nbp, excl,
                     sh.rowsum[h]);
      tick(kCode);
    }
    __syncthreads();

    // ---- warp 0: this tile's rows scanned and its aggregate (or, the
    // block's first tile, its inclusive prefix) published; the pending
    // tile's base by the look-back. Meanwhile warp 1 takes the step after
    // next (waited at that one) and issues its copies.
    if (valid && tid == 32) {
      plan(a, sh, j + 2);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(a, sh, j + 2);
    }
    if (warp == 0) {
      if (valid) {
        const int s = sh.rowsum[h][2 * lane] + sh.rowsum[h][2 * lane + 1];
        int incl = s;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(FULL, incl, o);
          if (lane >= o) incl += y;
        }
        const int agg = __shfl_sync(FULL, incl, 31);
        sh.rowoff[h][2 * lane] = incl - s;
        sh.rowoff[h][2 * lane + 1] = incl - s + sh.rowsum[h][2 * lane];
        if (lane == 0) {
          unsigned long long* w =
              a.status + static_cast<long long>(bi) * a.tpb + k;
          if (k == 0) {
            const long long base = a.start_bits ? a.start_bits[bi] : 3;
            *reinterpret_cast<volatile unsigned long long*>(w) =
                INC | static_cast<unsigned long long>(base + agg);
            sh.base[h] = base;
            if (k == a.tpb - 1) a.end_bits[bi] = base + agg;
          } else {
            *reinterpret_cast<volatile unsigned long long*>(w) =
                AGG | static_cast<unsigned long long>(agg);
          }
          sh.agg[h] = agg;
        }
      }
      tick(kScan);
      if (pending && pk > 0) {
        unsigned long long* status =
            a.status + static_cast<long long>(pbi) * a.tpb;
        const long long base = look_back(status, pk);
        if (lane == 0) {
          const long long end = base + sh.agg[h ^ 1];
          *reinterpret_cast<volatile unsigned long long*>(&status[pk]) =
              INC | static_cast<unsigned long long>(end);
          sh.base[h ^ 1] = base;
          if (pk == a.tpb - 1) a.end_bits[pbi] = end;
        }
      }
    }
    __syncthreads();
    tick(kLookBack);

    // ---- the pending tile packed
    if (pending) {
      const long long base = sh.base[h ^ 1];
      const int row0 = pk * TR;         // the tile's first row
      const int nrows = min(a.r - row0, TR);
      pack_tile<DYN>(a, sh, pbi, row0, nrows, base, sh.rowoff[h ^ 1], pval,
                     pnbp, pexcl);
      tick(kPack);
      store_tile<DYN>(a, sh, pbi, row0, nrows, base, sh.rowoff[h ^ 1]);
      tick(kStore);
    }
    if (stamped) {
      long long ns;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
      sh.acc[kTotal] += clock64() - t_tile;
      sh.acc[kNanos] += ns - ns_tile;
      sh.acc[kTiles] += 1;
    }
    if (!valid) break;                  // the last tile packed: none follows
    pending = true;
    pbi = bi;
    pk = k;
#pragma unroll
    for (int e = 0; e < K; ++e) pval[e] = val[e];
    pnbp[0] = nbp[0];
    pnbp[1] = nbp[1];
    pexcl = excl;
  }

  // ---- the state zeroed for the next call by the block that exits last
  cp_wait_all();
  if (tid == 0) {
    __threadfence();
    sh.last = atomicAdd(a.exited, 1u) == gridDim.x - 1;
    if (stamped)
      for (int s = 0; s < N_STAMPS; ++s) a.stamps[s] = sh.acc[s];
  }
  __syncthreads();
  if (sh.last) {
    __threadfence();
    for (int v = tid; v < a.total; v += NT) a.status[v] = 0;
    if (tid == 0) *a.ticket = 0, *a.exited = 0;
  }
}

// The launch of one instance: resident blocks an SM and registers, from
// the card once per device.
struct Config {
  int resident, regs, smem;
};

template <bool DYN, bool STAMP>
cudaError_t configure(int dev, Config& cfg) {
  static Config cache[MAX_DEVICES];
  if (dev < 0 || dev >= MAX_DEVICES)
    return cudaErrorInvalidDevice;
  if (cache[dev].resident > 0) {
    cfg = cache[dev];
    return cudaSuccess;
  }
  const auto kernel = emit_kernel<DYN, STAMP>;
  constexpr int smem = static_cast<int>(sizeof(Smem));
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return rc;
  int n = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, NT, smem);
  if (rc != cudaSuccess) return rc;
  cudaFuncAttributes fa;
  rc = cudaFuncGetAttributes(&fa, kernel);
  if (rc != cudaSuccess) return rc;
  if (n <= 0) return cudaErrorInvalidConfiguration;
  cache[dev] = {n, fa.numRegs, smem};
  cfg = cache[dev];
  return cudaSuccess;
}

int sm_count(int dev) {
  static int cache[MAX_DEVICES];
  if (dev < 0 || dev >= MAX_DEVICES) return 0;
  if (cache[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return 0;
    cache[dev] = n;
  }
  return cache[dev];
}

// The launch of b blocks of r rows: as many thread blocks as are resident
// at once, but no more than half the tiles, so that a block takes two
// tiles or more and the next tile's copies fly while it codes one (an L1
// pass's 512 tiles take 256 blocks, not 396: 0.0161 ms against 0.0183 on
// an H100, scripts/emit_probe.py; four tiles a block were slower).
struct Shape {
  int tpb, grid;
  long long total;
  Config cfg;
};

cudaError_t choose(int b, int r, bool dyn, bool stamp, Shape& sh) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  const int sms = sm_count(dev);
  if (sms <= 0) return cudaErrorInvalidDevice;
  rc = dyn ? (stamp ? configure<true, true>(dev, sh.cfg)
                    : configure<true, false>(dev, sh.cfg))
           : (stamp ? configure<false, true>(dev, sh.cfg)
                    : configure<false, false>(dev, sh.cfg));
  if (rc != cudaSuccess) return rc;
  sh.tpb = (r + TR - 1) / TR;
  sh.total = static_cast<long long>(b) * sh.tpb;
  const long long resident = static_cast<long long>(sh.cfg.resident) * sms;
  const long long half = (sh.total + 1) / 2;
  sh.grid = static_cast<int>(half < resident ? half : resident);
  return cudaSuccess;
}

}  // namespace

// ldrsx_emit_scratch: bytes of the state ldrsx_emit needs for b blocks of
// r rows (8-byte aligned: two counters, then a status word a tile).
extern "C" long long ldrsx_emit_scratch(int b, int r) {
  if (b <= 0 || r <= 0) return 0;
  return 8 + 8 * static_cast<long long>(b) * ((r + TR - 1) / TR);
}

// The launch shape of b blocks of r rows in a mode: out[0..4] = lanes a
// tile, blocks launched, blocks resident an SM, registers a thread,
// dynamic shared memory of a block in bytes. Returns a CUDA error code
// (0: the kernel takes it).
extern "C" int ldrsx_emit_shape(int b, int r, int dyn, int* out) {
  if (b <= 0 || r <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Shape sh = {};
  const cudaError_t rc = choose(b, r, dyn != 0, false, sh);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  out[0] = TL;
  out[1] = sh.grid;
  out[2] = sh.cfg.resident;
  out[3] = sh.cfg.regs;
  out[4] = sh.cfg.smem;
  return 0;
}

// The names of the stamped entry's N_STAMPS words: cycles (clock64) of
// block 0's thread 0 in each stage, summed over its tiles, then the
// tiles' cycles, their nanoseconds (globaltimer) and their count.
extern "C" const char* ldrsx_emit_stage_names() {
  return "bulk wait,gather wait,issue,coding,scan,look-back,packing,store,"
         "tile cycles,tile ns,tiles";
}

// ldrsx_emit with round bit v (sel, lit, data) set where that array's rows
// may be read rounded out to 16 bytes (its first row's start rounded down
// and its last row's end rounded up stay inside its storage), and, when
// stamps is not null, block 0's stage times in its N_STAMPS int64 words
// (an instance of its own, for the probe).
extern "C" int ldrsx_emit_shaped(const void* data, long long data_stride,
                                 const void* ml, long long ml_stride,
                                 const void* dist, long long dist_stride,
                                 const void* sel, long long sel_stride,
                                 const void* lit, long long lit_stride,
                                 const void* ll_tab, const void* of_tab,
                                 const void* start_bits, int b, int r,
                                 void* rows, void* byte_off, void* row_bit0,
                                 void* end_bits, void* scratch, int round,
                                 void* stamps, void* stream) {
  if (b <= 0) return 0;
  const bool dyn = ll_tab != nullptr;
  if (r <= 0 || (dyn != (of_tab != nullptr)) ||
      (reinterpret_cast<uintptr_t>(ml) & 7) ||
      (reinterpret_cast<uintptr_t>(dist) & 7) ||
      (reinterpret_cast<uintptr_t>(scratch) & 7) ||
      (reinterpret_cast<uintptr_t>(ll_tab) & 3) ||
      (reinterpret_cast<uintptr_t>(of_tab) & 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool stamp = stamps != nullptr;
  Shape sh = {};
  cudaError_t rc = choose(b, r, dyn, stamp, sh);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (sh.total > INT32_MAX / 2) return static_cast<int>(cudaErrorInvalidValue);
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
  a.tpb = sh.tpb;
  a.total = static_cast<int>(sh.total);
  a.round = round;
  a.rows = static_cast<uint8_t*>(rows);
  a.byte_off = static_cast<int64_t*>(byte_off);
  a.row_bit0 = static_cast<int64_t*>(row_bit0);
  a.end_bits = static_cast<int64_t*>(end_bits);
  a.ticket = static_cast<unsigned*>(scratch);
  a.exited = a.ticket + 1;
  a.status = static_cast<unsigned long long*>(scratch) + 1;
  a.stamps = static_cast<long long*>(stamps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(sh.cfg.smem);
  const unsigned grid = static_cast<unsigned>(sh.grid);
  if (dyn && stamp)
    emit_kernel<true, true><<<grid, NT, smem, st>>>(a);
  else if (dyn)
    emit_kernel<true, false><<<grid, NT, smem, st>>>(a);
  else if (stamp)
    emit_kernel<false, true><<<grid, NT, smem, st>>>(a);
  else
    emit_kernel<false, false><<<grid, NT, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Code and pack b blocks of r rows of 32 lanes: data uint8, ml and dist
// int64, sel and lit bool, each (b, >= 32 r) with rows of the given
// strides (in elements, any) and lanes contiguous; ll_tab (b, 288) and
// of_tab (b, 30) int32 (code | len << 16, len <= 15) for the dynamic
// mode, or both null for the static mode; start_bits int64 (b,), or null:
// every block starts at bit 3. Outputs: rows uint8 (b, r, row_out + 1)
// with row_out 64 (dynamic) or 48 (static), byte_off and row_bit0 int64
// (b, r), end_bits int64 (b,); scratch the state (ldrsx_emit_scratch
// bytes, 8-byte aligned), zero on entry and left zero (the kernel clears
// what it used; a call on another stream needs its own). Returns a CUDA
// error code (0: launched).
extern "C" int ldrsx_emit(const void* data, long long data_stride,
                          const void* ml, long long ml_stride,
                          const void* dist, long long dist_stride,
                          const void* sel, long long sel_stride,
                          const void* lit, long long lit_stride,
                          const void* ll_tab, const void* of_tab,
                          const void* start_bits, int b, int r, void* rows,
                          void* byte_off, void* row_bit0, void* end_bits,
                          void* scratch, void* stream) {
  return ldrsx_emit_shaped(data, data_stride, ml, ml_stride, dist,
                           dist_stride, sel, sel_stride, lit, lit_stride,
                           ll_tab, of_tab, start_bits, b, r, rows, byte_off,
                           row_bit0, end_bits, scratch, 0, nullptr, stream);
}
