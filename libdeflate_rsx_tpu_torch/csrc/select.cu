// Token selection of the device encoders on NVIDIA Hopper (sm_90a): run
// extension, the L6 tier's history mask and lazy demotion, greedy token
// selection and the per-block litlen / offset histograms, in one launch.
//
// Replaces the XLA graphs that follow the match finder in the JAX
// package: ops/encode_v2.py extend_runs (:112) and select_tokens (:168),
// and, in ops/encode_dynamic.py, analyze_block_l6's history mask and
// lazy demotion (:356-365) and the histograms (_hist :55, :368-379).
// There they are Hillis-Steele doubling loops over the whole window, a
// 65-step loop over one-hot lane masks per cell and a histogram by sort
// and search: workarounds for the TPU. The plain PyTorch version of this
// kernel is ops/select.py's select_plain (the port's copy of those
// graphs); the kernel gives its outputs exactly.
//
// The function, per window of s positions (row of ml, dist), with
// `start` (the history length at L6, else 0), cell width W (64 or 256)
// and valid_len:
//  - run extension: ext[t] = the max of ml[u] + u over the same-distance
//    chain from t (u = t.. while ml[u], ml[u + 1] >= 4 and dist[u + 1] ==
//    dist[u]), minus t, capped at 258 and at valid_len - t, for matched t;
//  - ml = 0 below start; lazy (L6): ml[t] = 0 where ml[t + 1] > ml[t]
//    and both are >= 4, reading the values before the demotion;
//  - phase 1: run starts (rs), each match capped at the next 256-byte
//    grid point of its run (ml_run); matches of >= 32 selected when no
//    earlier long match's raw end passes them (sel1); a position inside a
//    selected long match is covered;
//  - phase 2: matches capped at their cell's end and at the next sel1
//    start in their cell (ml_short); the exact greedy walk of each cell
//    over the uncovered ones of >= 4 (sel2); lit: the lanes the walk
//    steps over, in range, neither covered nor selected;
//  - out, for t in [start, s): ml_emit (ml_run where sel1, else
//    ml_short), sel, lit; histograms of the selected lengths and
//    distances and the literal bytes, saturated at 65,535.
//
// Positions below start need no output: ml is 0 there, so the run
// boundary at start is set, and start is a multiple of W.
//
// Three of the four scans reach a bounded distance, so halos replace
// their carries:
//  - run extension: a chain member has ml >= 4, so a chain from t that
//    reaches t + 254 gives ext[t] >= 258 (the cap): ext[t] needs (ml,
//    dist) on [t, t + 255) alone;
//  - raw ends: ml_run <= 256, so only long matches in (p - 256, p) can
//    pass p, and sel1 at p needs raw ends from (p - 256, p) alone;
//  - selected ends: covered at p needs sel1 on (p - 256, p), and so raw
//    ends from (p - 512, p).
// A tile of TS payload positions at T is therefore exact from (ml, dist)
// on [T - 512, T + TS + 256) (the demotion reads ext one position on),
// with one carry left: the run start, unbounded (a zeros block is one
// run). It is the last boundary at or before a position, a max-scan
// whose only state is one int: each tile publishes X, the last boundary
// at or before T + TS - 513 (the position before the next tile's halo),
// in a status word as soon as its own positions show one, and a tile
// that needs the run start at its halo's start (no boundary at
// T - 512 .. T - 510) takes it from the nearest earlier tile whose word
// holds an X (a decoupled look-back; tile 0 always holds one: the
// boundary at start).
//
// What bounds it on this card: bytes at the ideal (16 B of (ml, dist)
// and one data byte in, 10 B out per position: ~0.14 ms for the L6
// pass's 259 windows at the card's memory rate); in practice the latency
// of a tile's chain of barriers, with two tiles resident an SM. The
// design:
//  - one block of NT = 512 threads per (window, tile of TS = 3,328
//    positions): 512 x 8 positions cover the tile and its 768 positions
//    of halo, and 64 registers a thread keep two blocks on each SM.
//    Blocks take tiles in ticket order from a global counter (so every
//    earlier tile of a window has started, and a look-back's wait
//    ends); every tile of every window runs at once, and no block walks
//    a window's tiles in turn. Each thread takes K consecutive positions,
//    loaded straight into registers with 16-byte loads (the neighbours'
//    first and last by warp shuffles);
//  - run extension by a block-wide segmented suffix max, the three
//    phase-1 maxima by block-wide prefix maxima, one barrier each;
//  - phase 2 inside each warp (a cell is 8 or 32 threads): the next sel1
//    and the next candidate by segmented warp scans; a jump table in
//    shared memory (from each candidate, the first candidate past its
//    span), walked by one thread a cell, every cell at once, one shared
//    load a step; the lanes stepped over are those outside the selected
//    spans, a warp scan after the walk;
//  - the histograms counted in shared memory by atomics and added into a
//    per-window uint32 sum; the window's last tile to finish writes the
//    saturated uint16 values.
// A small state (the ticket, the status words, the sums and the tiles
// done per window) is cleared before the launch, in the same C call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TS = 3328;                // payload positions a tile
constexpr int LEFT = 512;               // halo before the tile
constexpr int RIGHT = 256;              // halo after it
constexpr int K = 8;                    // consecutive positions a thread
constexpr int NT = (LEFT + TS + RIGHT) / K;   // threads a block
constexpr int NWARP = NT / 32;
constexpr int T0 = LEFT / K;            // the tile's first thread
constexpr int PUB = (TS - 1) / K;       // the thread holding T + TS - 513
constexpr int MIN_MATCH = 4;
constexpr int MAX_MATCH = 258;
constexpr int GRID = 256;               // run-relative emission grid
constexpr int LONG = 32;                // phase 1's length threshold
constexpr int NEG = -(1 << 20);
constexpr int NOB = -(1 << 30);         // no run boundary yet
constexpr int NUM_LL = 288;
constexpr int NUM_OF = 30;
constexpr int NHIST = NUM_LL + NUM_OF;
constexpr unsigned FULL = 0xFFFFFFFFu;
// a status word: 0 not yet written, NONE no boundary of the tile's own
// at or before T + TS - 513, X + XOFF the run start there
constexpr unsigned NONE = 1u, XOFF = 2u;
constexpr int kStages = 11;
static_assert(NT % 32 == 0 && TS % GRID == 0, "whole warps, whole cells");
static_assert(LEFT == 2 * GRID && RIGHT == GRID && T0 % 32 == 0,
              "the halos the scans' reach needs, in whole warps");
static_assert(PUB >= T0 && (TS - 1) % K == K - 1, "the status position");

struct Shared {
  int ext_v[NWARP];
  int ext_c[NWARP];
  int scan[3][NWARP];                   // run starts, raw ends, sel ends
  int ticket, need, carry;
  // 16-byte stores of a thread's 8 values
  __align__(16) uint16_t dclip[TS];     // clip(dist, 1, 32768) - 1
  __align__(16) uint16_t nc[TS];        // next candidate, then jumps
  uint32_t sel2[TS / 32];
  uint32_t ll[NUM_LL], of[NUM_OF];
};

struct Args {
  const int64_t* ml;
  const int64_t* dist;
  const int32_t* valid;
  const uint8_t* data;                  // null: no histograms
  int64_t data_stride;
  int b, s, start, lazy, ntiles;
  int64_t* ml_out;
  uint64_t* sel_out;                    // 8 bools a word
  uint64_t* lit_out;
  uint16_t* ll_out;
  uint16_t* of_out;
  unsigned* ticket;                     // the state, cleared per call
  unsigned* done;                       // (B,) tiles finished
  unsigned* status;                     // (B, ntiles)
  unsigned* sums;                       // (B, NHIST), with histograms
  uint64_t* stamps;                     // null, or the probe's stage ends
};

__device__ __forceinline__ void stamp(uint64_t* st, int k) {
  if (st != nullptr) {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    st[k] = t;
  }
}

// ml as the kernel keeps it: 0 unless >= MIN_MATCH, at most MAX_MATCH
// (a longer one reaches the cap all the same).
__device__ __forceinline__ int clamp_ml(int64_t m) {
  return m < MIN_MATCH ? 0 : static_cast<int>(m < MAX_MATCH ? m : MAX_MATCH);
}

__device__ __forceinline__ int ext_of(bool matched, int r, int p,
                                      int valid) {
  return matched ? max(0, min(min(r - p, MAX_MATCH), valid - p)) : 0;
}

// R just past this thread's last position, for the segmented suffix
// max of run extension: each thread's aggregate (v, c) of its positions
// (the max over its chain from its first position, and whether the
// chain runs through all of them and on); NEG past the block's range.
__device__ int suffix_after(int v, bool c, Shared& sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int ic = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int ov = __shfl_down_sync(FULL, v, o);
    const int oc = __shfl_down_sync(FULL, ic, o);
    if (lane + o < 32) {
      v = max(v, ic ? ov : NEG);
      ic = ic && oc;
    }
  }
  int ev = __shfl_down_sync(FULL, v, 1);
  int ec = __shfl_down_sync(FULL, ic, 1);
  if (lane == 31) {
    ev = NEG;
    ec = 1;
  }
  if (lane == 0) {
    sh.ext_v[w] = v;
    sh.ext_c[w] = ic;
  }
  __syncthreads();
  int r = NEG;
  for (int i = NWARP - 1; i > w; --i)
    r = max(sh.ext_v[i], sh.ext_c[i] ? r : NEG);
  return max(ev, ec ? r : NEG);
}

// The max of x over the block's threads before this one (`init` for
// the first); one barrier, slots[] a scan's own.
__device__ int prefix_before(int x, int init, int* slots) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl = max(incl, y);
  }
  const int ex = __shfl_up_sync(FULL, incl, 1);
  if (lane == 31) slots[w] = incl;
  __syncthreads();
  int pre = init;
  for (int i = 0; i < w; ++i) pre = max(pre, slots[i]);
  return lane > 0 ? max(pre, ex) : pre;
}

// The min of x over the threads of this thread's cell (SEG threads)
// after this one; `none` for the cell's last thread.
template <int SEG>
__device__ __forceinline__ int cell_min_after(int x, int none) {
  const int sl = threadIdx.x & (SEG - 1);
  int incl = x;
#pragma unroll
  for (int o = 1; o < SEG; o <<= 1) {
    const int y = __shfl_down_sync(FULL, incl, o);
    if (sl + o < SEG) incl = min(incl, y);
  }
  const int after = __shfl_down_sync(FULL, incl, 1);
  return sl + 1 < SEG ? after : none;
}

// The max of x over the threads of this thread's cell before this one;
// `none` for the cell's first thread.
template <int SEG>
__device__ __forceinline__ int cell_max_before(int x, int none) {
  const int sl = threadIdx.x & (SEG - 1);
  int incl = x;
#pragma unroll
  for (int o = 1; o < SEG; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (sl >= o) incl = max(incl, y);
  }
  const int before = __shfl_up_sync(FULL, incl, 1);
  return sl > 0 ? before : none;
}

__device__ int bsr(int x) { return 31 - __clz(x); }

// DEFLATE length symbol 257..285 of a length 4..258 (ops/static_codes.py
// length_sym_fields).
__device__ int length_sym(int len) {
  if (len == 258) return 285;
  const int n = len - 3;
  if (n < 8) return 257 + n;
  const int eb = bsr(n) - 2;
  return 257 + (eb << 2) + (n >> eb);
}

// DEFLATE offset symbol 0..29 of a distance 1..32,768 (offset_sym_fields).
__device__ int offset_sym(int d) {
  const int o = d - 1;
  if (o < 4) return o;
  const int b = bsr(o);
  return 2 * b + ((o >> (b - 1)) & 1);
}

// The run start X before tile k of a window (its row of status words):
// warp 0 reads 32 earlier tiles' words at a time, nearest first, until
// the nearest word that is not NONE holds an X (tile 0's always does).
__device__ int look_back(const unsigned* status, int k) {
  const int lane = threadIdx.x & 31;
  for (int j = k - 1;; j -= 32) {
    const int idx = j - lane;
    unsigned v, hit;
    do {
      v = idx >= 0 ? *reinterpret_cast<const volatile unsigned*>(
                         &status[idx])
                   : NONE;
      hit = __ballot_sync(FULL, v != NONE);
      // the nearest word that is not NONE: not yet written, or an X
    } while (hit && __shfl_sync(FULL, v, __ffs(hit) - 1) == 0);
    if (hit) return static_cast<int>(__shfl_sync(FULL, v, __ffs(hit) - 1) -
                                     XOFF);
  }
}

template <int W>
__global__ void __launch_bounds__(NT, 2) select_kernel(Args a) {
  static_assert(TS % W == 0 && W % 32 == 0 && W <= GRID, "cell width");
  constexpr int SEG = W / K;            // threads a cell
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31;
  const bool hist = a.data != nullptr;

  uint64_t t_start = 0;
  if (tid == T0 && a.stamps != nullptr)
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_start));
  if (tid == 0) sh.ticket = static_cast<int>(atomicAdd(a.ticket, 1u));
  if (hist)
    for (int i = tid; i < NHIST; i += NT) {
      if (i < NUM_LL) sh.ll[i] = 0;
      else sh.of[i - NUM_LL] = 0;
    }
  __syncthreads();
  const int ticket = sh.ticket;
  const int row = ticket / a.ntiles, k = ticket % a.ntiles;
  const int s = a.s, start = a.start;
  const int T = start + k * TS;
  const int P0 = T - LEFT + tid * K;    // this thread's first position
  const int l0 = P0 - T;                // and its place in the tile
  const bool tile = tid >= T0 && tid < T0 + TS / K && P0 < s;
  // the probe's stamps: the first tile's, and a tile's halfway through
  // the launch, when every SM is busy
  const int mid = a.b * a.ntiles / 2;
  uint64_t* st = tid != T0 || a.stamps == nullptr ? nullptr
                 : ticket == 0                     ? a.stamps
                 : ticket == mid && mid > 0        ? a.stamps + kStages + 1
                                                   : nullptr;
  if (st != nullptr) st[0] = t_start;
  stamp(st, 1);
  const int64_t* mlr = a.ml + static_cast<int64_t>(row) * s;
  const int64_t* dr = a.dist + static_cast<int64_t>(row) * s;
  const int valid = a.valid[row];

  // ---- loads: positions P0 - 1 .. P0 + K (a group of K lies wholly
  // inside [start, s) or outside it)
  int m[K];
  int64_t d[K];
  const bool in = P0 >= start && P0 < s;
  if (in) {
#pragma unroll
    for (int j = 0; j < K; j += 2) {
      const longlong2 x = __ldg(reinterpret_cast<const longlong2*>(mlr + P0 + j));
      const longlong2 y = __ldg(reinterpret_cast<const longlong2*>(dr + P0 + j));
      m[j] = clamp_ml(x.x);
      m[j + 1] = clamp_ml(x.y);
      d[j] = y.x;
      d[j + 1] = y.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      m[j] = 0;
      d[j] = 0;
    }
  }
  uint64_t bytes = 0;                   // the tile's data bytes
  if (hist && tile) {
    const uint8_t* row_bytes = a.data + row * a.data_stride + P0;
#pragma unroll
    for (int j = 0; j < K; ++j)
      bytes |= static_cast<uint64_t>(__ldg(row_bytes + j)) << (8 * j);
  }
  int m_next = __shfl_down_sync(FULL, m[0], 1);
  int64_t d_next = __shfl_down_sync(FULL, d[0], 1);
  int m_prev = __shfl_up_sync(FULL, m[K - 1], 1);
  int64_t d_prev = __shfl_up_sync(FULL, d[K - 1], 1);
  if (lane == 31) {                     // P0 + K, unmatched past the range
    const int p = P0 + K;
    const bool ok = tid < NT - 1 && p >= start && p < s;
    m_next = ok ? clamp_ml(__ldg(mlr + p)) : 0;
    d_next = ok ? __ldg(dr + p) : 0;
  }
  if (lane == 0) {
    const int p = P0 - 1;
    const bool ok = p >= start && p < s;
    m_prev = ok ? clamp_ml(__ldg(mlr + p)) : 0;
    d_prev = ok ? __ldg(dr + p) : 0;
  }
  if (hist && tile) {
    uint16_t dc[K];
#pragma unroll
    for (int j = 0; j < K; ++j)
      dc[j] = static_cast<uint16_t>(
          (d[j] < 1 ? 1 : (d[j] > 32768 ? 32768 : d[j])) - 1);
    *reinterpret_cast<uint4*>(&sh.dclip[l0]) =
        *reinterpret_cast<const uint4*>(dc);
  }
  // bit j: position P0 + j; eq: dist[p + 1] == dist[p]; c: the chain
  // runs from p to p + 1
  unsigned eq = 0, c = 0;
  const bool eq_prev = P0 < s && d[0] == d_prev;   // at P0 - 1
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int64_t dn = j + 1 < K ? d[j + 1] : d_next;
    const int mn = j + 1 < K ? m[j + 1] : m_next;
    const bool e = P0 + j + 1 < s && dn == d[j];
    eq |= static_cast<unsigned>(e) << j;
    c |= static_cast<unsigned>(e && m[j] && mn) << j;
  }
  const bool c_prev = eq_prev && m_prev && m[0];
  stamp(st, 2);

  // ---- run extension: the segmented suffix max over the block's range
  int av = NEG;
  bool ac = true;
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    const bool cj = (c >> j) & 1u;
    av = max(m[j] ? m[j] + P0 + j : NEG, cj ? av : NEG);
    ac = cj && ac;
  }
  int r = suffix_after(av, ac, sh);
  // ext at P0 - 1 .. P0 + K
  int e[K + 2];
  e[K + 1] = ext_of(m_next != 0, r, P0 + K, valid);
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    r = max(m[j] ? m[j] + P0 + j : NEG, ((c >> j) & 1u) ? r : NEG);
    e[j + 1] = ext_of(m[j] != 0, r, P0 + j, valid);
  }
  r = max(m_prev ? m_prev + P0 - 1 : NEG, c_prev ? r : NEG);
  e[0] = ext_of(m_prev != 0, r, P0 - 1, valid);
  // lazy demotion; mt bit i: position P0 - 1 + i is matched
  int dm[K];
  unsigned mt = 0;
#pragma unroll
  for (int i = 0; i <= K; ++i) {
    const bool demote = a.lazy && e[i + 1] > e[i] && e[i] >= MIN_MATCH &&
                        e[i + 1] >= MIN_MATCH;
    const int v = demote ? 0 : e[i];
    if (i > 0) dm[i - 1] = v;
    const int p = P0 - 1 + i;
    mt |= static_cast<unsigned>(v >= MIN_MATCH && p < valid && p >= start)
          << i;
  }
  stamp(st, 3);

  // ---- phase 1: run starts, with the carry where the range needs it
  const unsigned eqp = (eq << 1) | static_cast<unsigned>(eq_prev);
  const unsigned bnd = ~(mt & (mt >> 1) & eqp) & 0xFFu;   // bit j: P0 + j
  if (tid == 0) sh.need = (bnd & 7u) == 0;   // none at T - 512 .. T - 510
  const int last_b = bnd ? P0 + bsr(static_cast<int>(bnd)) : NOB;
  const int rs_pre = prefix_before(last_b, NOB, sh.scan[0]);
  unsigned* status = a.status + static_cast<int64_t>(row) * a.ntiles;
  if (tid == PUB) {                     // X from the tile's own boundaries
    const int x = max(rs_pre, last_b);
    __threadfence();
    *reinterpret_cast<volatile unsigned*>(&status[k]) =
        x == NOB ? NONE : static_cast<unsigned>(x) + XOFF;
  }
  stamp(st, 4);
  int carry = -1;
  if (sh.need) {                        // the same in every thread
    if (tid < 32) {
      const int x = look_back(status, k);
      if (tid == 0) sh.carry = x;
    }
    __syncthreads();
    carry = sh.carry;
    if (tid == PUB && max(rs_pre, last_b) == NOB)
      *reinterpret_cast<volatile unsigned*>(&status[k]) =
          static_cast<unsigned>(carry) + XOFF;
  }
  stamp(st, 5);
  int ml_run[K];
  unsigned long_ok = 0;
  int x = 0;
  {
    int rs = rs_pre;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int p = P0 + j;
      if ((bnd >> j) & 1u) rs = p;
      const int rr = rs == NOB ? carry : rs;
      ml_run[j] = min(dm[j], GRID - ((p - rr) & (GRID - 1)));
      const bool ok = ((mt >> (j + 1)) & 1u) && ml_run[j] >= LONG;
      long_ok |= static_cast<unsigned>(ok) << j;
      if (ok) x = max(x, p + ml_run[j]);
    }
  }
  // raw ends -> sel1
  int run = prefix_before(x, 0, sh.scan[1]);
  unsigned sel1 = 0;
  x = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int p = P0 + j;
    if ((long_ok >> j) & 1u) {
      if (run <= p) {
        sel1 |= 1u << j;
        x = max(x, p + ml_run[j]);
      }
      run = max(run, p + ml_run[j]);
    }
  }
  // selected ends -> covered
  run = prefix_before(x, 0, sh.scan[2]);
  unsigned covered = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int p = P0 + j;
    covered |= static_cast<unsigned>(run > p) << j;
    if ((sel1 >> j) & 1u) run = max(run, p + ml_run[j]);
  }
  stamp(st, 6);

  // ---- phase 2, in the tile's warps (a cell is SEG threads of a warp)
  if ((tid >> 5) >= T0 / 32 && (tid >> 5) < (T0 + TS / K) / 32) {
    if (!tile) sel1 = 0;
    const int ce = (l0 | (W - 1)) + 1;  // the cell's end in the tile
    // the next sel1 after each position, within the cell
    const int n1 = cell_min_after<SEG>(
        sel1 ? l0 + __ffs(static_cast<int>(sel1)) - 1 : ce, ce);
    // me: ml_run where sel1, else ml_short
    int me[K];
    unsigned cand = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int l = l0 + j;
      const unsigned above = sel1 >> (j + 1);
      const int nxt = above ? l + __ffs(static_cast<int>(above)) : n1;
      const int ms = min(min(dm[j], ce - l), nxt - l);
      me[j] = ((sel1 >> j) & 1u) ? ml_run[j] : ms;
      const bool ok = ((mt >> (j + 1)) & 1u) && !((sel1 >> j) & 1u) &&
                      !((covered >> j) & 1u) && ms >= MIN_MATCH;
      cand |= static_cast<unsigned>(ok && tile) << j;
    }
    // the first candidate at or after each position, within the cell
    const int nca = cell_min_after<SEG>(
        cand ? l0 + __ffs(static_cast<int>(cand)) - 1 : ce, ce);
    uint16_t nc[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const unsigned from = cand >> j;
      nc[j] = static_cast<uint16_t>(
          from ? l0 + j + __ffs(static_cast<int>(from)) - 1 : nca);
    }
    *reinterpret_cast<uint4*>(&sh.nc[l0]) =
        *reinterpret_cast<const uint4*>(nc);
    if ((tid & 3) == 0) sh.sel2[l0 >> 5] = 0;
    __syncwarp();
    // jumps: from each candidate, the first candidate past its span
    int jump[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int to = l0 + j + me[j];
      jump[j] = ((cand >> j) & 1u) && to < ce ? sh.nc[to] : ce;
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < K; ++j)
      if ((cand >> j) & 1u) sh.nc[l0 + j] = static_cast<uint16_t>(jump[j]);
    __syncwarp();
    stamp(st, 7);
    // the walk: one thread a cell, from the cell's first candidate
    if ((tid & (SEG - 1)) == 0) {
      int at = nc[0];
      int wi = -1;
      uint32_t bits = 0;
      while (at < ce) {
        if ((at >> 5) != wi) {
          if (wi >= 0) sh.sel2[wi] = bits;
          wi = at >> 5;
          bits = 0;
        }
        bits |= 1u << (at & 31);
        at = sh.nc[at];
      }
      if (wi >= 0) sh.sel2[wi] = bits;
    }
    __syncwarp();
    stamp(st, 8);
    const unsigned sel2 = (sh.sel2[l0 >> 5] >> (l0 & 31)) & 0xFFu;
    // the lanes stepped over: outside every selected span
    int span = 0;
#pragma unroll
    for (int j = 0; j < K; ++j)
      if ((sel2 >> j) & 1u) span = max(span, l0 + j + me[j]);
    span = cell_max_before<SEG>(span, 0);
    unsigned selb = 0, litb = 0;
    uint64_t selw = 0, litw = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int l = l0 + j;
      const bool s2 = (sel2 >> j) & 1u;
      const bool vis = span <= l;
      if (s2) span = max(span, l + me[j]);
      const bool sj = ((sel1 >> j) & 1u) || s2;
      const bool lit = vis && T + l < valid && !((covered >> j) & 1u) &&
                       !((sel1 >> j) & 1u) && !s2;
      selb |= static_cast<unsigned>(sj) << j;
      litb |= static_cast<unsigned>(lit) << j;
      selw |= static_cast<uint64_t>(sj) << (8 * j);
      litw |= static_cast<uint64_t>(lit) << (8 * j);
    }
    if (tile) {
      const int64_t o = static_cast<int64_t>(row) * (s - start) + (P0 - start);
      longlong2* mo = reinterpret_cast<longlong2*>(a.ml_out + o);
#pragma unroll
      for (int j = 0; j < K; j += 2) mo[j / 2] = make_longlong2(me[j], me[j + 1]);
      a.sel_out[o / K] = selw;
      a.lit_out[o / K] = litw;
    }
    stamp(st, 9);
    if (hist) {                         // selb, litb are 0 outside the tile
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if ((selb >> j) & 1u) {
          atomicAdd(&sh.ll[length_sym(max(me[j], MIN_MATCH))], 1u);
          atomicAdd(&sh.of[offset_sym(sh.dclip[l0 + j] + 1)], 1u);
        } else if ((litb >> j) & 1u) {
          atomicAdd(&sh.ll[(bytes >> (8 * j)) & 0xFF], 1u);
        }
      }
    }
  }

  // ---- the window's histograms: this tile's counts into its sums; the
  // window's last tile to finish writes the saturated values (warp 0).
  // Thread 0's fence and count after the barrier release every thread's
  // sums (the barrier orders them before it), as a split-K reduction
  // releases its partial tiles.
  stamp(st, 10);
  if (hist) {
    __syncthreads();
    unsigned* sums = a.sums + static_cast<int64_t>(row) * NHIST;
    for (int i = tid; i < NHIST; i += NT) {
      const unsigned v = i < NUM_LL ? sh.ll[i] : sh.of[i - NUM_LL];
      if (v) atomicAdd(&sums[i], v);
    }
    __syncthreads();
    if (tid < 32) {
      bool last = false;
      if (tid == 0) {
        __threadfence();
        last = atomicAdd(&a.done[row], 1u) ==
               static_cast<unsigned>(a.ntiles - 1);
      }
      if (__shfl_sync(FULL, last, 0)) {
        __threadfence();
        for (int i = tid; i < NHIST; i += 32) {
          const unsigned v =
              min(*reinterpret_cast<const volatile unsigned*>(&sums[i]),
                  65535u);
          if (i < NUM_LL)
            a.ll_out[static_cast<int64_t>(row) * NUM_LL + i] =
                static_cast<uint16_t>(v);
          else
            a.of_out[static_cast<int64_t>(row) * NUM_OF + i - NUM_LL] =
                static_cast<uint16_t>(v);
        }
      }
    }
  }
  stamp(st, 11);
}

// The state's layout, in 32-bit words: the ticket, the tiles done per
// window, the status words, the histogram sums.
struct Layout {
  int64_t done, status, sums, words;
};

Layout layout(int b, int s, int start, bool hist) {
  Layout l;
  const int64_t ntiles = (s - start + TS - 1) / TS;
  l.done = 1;
  l.status = l.done + b;
  l.sums = l.status + static_cast<int64_t>(b) * ntiles;
  l.words = l.sums + (hist ? static_cast<int64_t>(b) * NHIST : 0);
  return l;
}

}  // namespace

// ldrsx_select_scratch: bytes of the state ldrsx_select needs for b
// windows of s positions from start, with (hist) or without histograms.
extern "C" long long ldrsx_select_scratch(int b, int s, int start,
                                          int hist) {
  if (b <= 0 || s <= start) return 0;
  return 4 * layout(b, s, start, hist != 0).words;
}

// ldrsx_select_stamped: ldrsx_select, and thread T0 of the block of the
// first tile (ticket 0) and of the tile halfway through the launch writes
// the global timer (ns) at its start and each stage end into stamps
// (2 x (kStages + 1) uint64, the first tile's, then the other's).
extern "C" int ldrsx_select_stamped(
    const void* ml, const void* dist, const void* valid, const void* data,
    long long data_stride, int b, int s, int start, int wtile, int lazy,
    void* ml_out, void* sel_out, void* lit_out, void* ll_out, void* of_out,
    void* scratch, void* stamps, void* stream) {
  if (b <= 0) return 0;
  if ((wtile != 64 && wtile != 256) || start < 0 || s < start ||
      (s - start) % wtile || start % wtile ||
      (reinterpret_cast<uintptr_t>(sel_out) & 7) ||
      (reinterpret_cast<uintptr_t>(lit_out) & 7) ||
      (reinterpret_cast<uintptr_t>(ml_out) & 15) ||
      (reinterpret_cast<uintptr_t>(ml) & 15) ||
      (reinterpret_cast<uintptr_t>(dist) & 15) ||
      (reinterpret_cast<uintptr_t>(scratch) & 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool hist = data != nullptr;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s == start) {                     // no payload: empty histograms
    if (!hist) return 0;
    cudaError_t rc = cudaMemsetAsync(ll_out, 0, 2 * NUM_LL * b, st);
    if (rc == cudaSuccess) rc = cudaMemsetAsync(of_out, 0, 2 * NUM_OF * b, st);
    return static_cast<int>(rc);
  }
  const Layout l = layout(b, s, start, hist);
  const int64_t blocks = static_cast<int64_t>(b) * ((s - start + TS - 1) / TS);
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.b = b;
  a.ml = static_cast<const int64_t*>(ml);
  a.dist = static_cast<const int64_t*>(dist);
  a.valid = static_cast<const int32_t*>(valid);
  a.data = static_cast<const uint8_t*>(data);
  a.data_stride = data_stride;
  a.s = s;
  a.start = start;
  a.lazy = lazy;
  a.ntiles = (s - start + TS - 1) / TS;
  a.ml_out = static_cast<int64_t*>(ml_out);
  a.sel_out = static_cast<uint64_t*>(sel_out);
  a.lit_out = static_cast<uint64_t*>(lit_out);
  a.ll_out = static_cast<uint16_t*>(ll_out);
  a.of_out = static_cast<uint16_t*>(of_out);
  unsigned* state = static_cast<unsigned*>(scratch);
  a.ticket = state;
  a.done = state + l.done;
  a.status = state + l.status;
  a.sums = state + l.sums;
  a.stamps = static_cast<uint64_t*>(stamps);
  cudaError_t rc = cudaMemsetAsync(state, 0, 4 * l.words, st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (wtile == 64)
    select_kernel<64><<<static_cast<unsigned>(blocks), NT, 0, st>>>(a);
  else
    select_kernel<256><<<static_cast<unsigned>(blocks), NT, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Run the selection on b windows of s positions: ml, dist int64 (b, s);
// valid int32 (b,); data uint8 rows of data_stride bytes whose byte p is
// position p's (null: no histograms); outputs for positions [start, s):
// ml_out int64 (b, s - start), sel and lit bool (b, s - start), ll_out
// uint16 (b, 288) and of_out uint16 (b, 30) when data is given; scratch
// the state (ldrsx_select_scratch bytes, 4-byte aligned; cleared here).
// W (64 or 256) and start must divide s - start and start; ml, dist and
// ml_out 16-byte aligned, the bool outputs 8-byte aligned. Returns a
// CUDA error code (0: launched).
extern "C" int ldrsx_select(const void* ml, const void* dist,
                            const void* valid, const void* data,
                            long long data_stride, int b, int s, int start,
                            int wtile, int lazy, void* ml_out, void* sel_out,
                            void* lit_out, void* ll_out, void* of_out,
                            void* scratch, void* stream) {
  return ldrsx_select_stamped(ml, dist, valid, data, data_stride, b, s,
                              start, wtile, lazy, ml_out, sel_out, lit_out,
                              ll_out, of_out, scratch, nullptr, stream);
}
