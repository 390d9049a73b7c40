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
//  - phase 1: run starts, each match capped at the next 256-byte grid
//    point of its run (ml_run); matches of >= 32 selected when no earlier
//    long match's raw end passes them (sel1); a position inside a
//    selected long match is covered;
//  - phase 2: matches capped at their cell's end and at the next sel1
//    start in their cell (ml_short); the exact greedy walk of each cell
//    over the uncovered ones of >= 4 (sel2); lit: the lanes the walk
//    steps over, in range, neither covered nor selected;
//  - out, for t in [start, s): ml_emit (ml_run where sel1, else
//    ml_short), sel, lit; histograms of the selected lengths and
//    distances and the literal bytes, saturated at 65,535.
//
// Positions below start need no work: ml is 0 there, so the run boundary
// at start is set, both prefix maxima start at 0 there, start is a
// multiple of W (the cells line up), and run extension at t >= start
// reads only forward. So the kernel reads the payload alone.
//
// What bounds it on this card: latency. Its bytes (16 B of (ml, dist) and
// one data byte in, 10 B out per position) take ~0.14 ms for the L6
// pass's 259 windows at the card's memory rate; the work is three scans
// and a serial walk per cell, carried along the window. The design:
//  - one block of 512 threads per window, each thread 8 consecutive
//    positions, tiles of 4,096 positions walked in order with the carries
//    in shared memory: pass 1 backward (the segmented suffix max of run
//    extension, by warp shuffles and the warps' aggregates), writing ext
//    and the distance-equality bit as one uint16 per position into a
//    global scratch row (it stays in L2); pass 2 forward (demotion with a
//    one-position halo, the three prefix maxima: run start, raw ends,
//    selected ends);
//  - each cell's sel1 and candidate bits as words in shared memory; one
//    thread per cell walks it candidate to candidate with find-first-set,
//    marking the lanes it steps over as words;
//  - histograms by shared-memory atomics, written once per window.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 512;                 // threads a block
constexpr int NWARP = NT / 32;
constexpr int K = 8;                    // consecutive positions a thread
constexpr int TS = NT * K;              // positions a tile
constexpr int TW = TS / 32;             // bit words a tile
constexpr int MIN_MATCH = 4;
constexpr int MAX_MATCH = 258;
constexpr int GRID = 256;               // run-relative emission grid
constexpr int LONG = 32;                // phase 1's length threshold
constexpr int NEG = -(1 << 20);
constexpr int NUM_LL = 288;
constexpr int NUM_OF = 30;
constexpr unsigned FULL = 0xFFFFFFFFu;
static_assert(K == 8, "put_bits packs 8 bits a thread, 4 threads a word");

struct Shared {
  int warp_v[NWARP];
  int warp_c[NWARP];
  // 0: the suffix value past the tile (pass 1); 1: run start; 2: the
  // raw ends' max; 3: the selected ends' max (pass 2)
  int carry[4];
  uint32_t sel1[TW], cand[TW], vis[TW], sel2[TW];
  uint16_t ml_short[TS];
  uint32_t ll[NUM_LL], of[NUM_OF];
};

struct Args {
  const int64_t* ml;
  const int64_t* dist;
  const int32_t* valid;
  const uint8_t* data;                  // null: no histograms
  int64_t data_stride;
  int s, start, lazy;
  int64_t* ml_out;
  uint64_t* sel_out;                    // 8 bools a word
  uint64_t* lit_out;
  uint16_t* ll_out;
  uint16_t* of_out;
  uint16_t* scratch;                    // (B, s - start)
};

// R just past this thread's last position, for the segmented suffix max
// of pass 1: each thread's aggregate (v, c) of its positions (the max
// over its chain from its first position, and whether the chain runs
// through all of them), `after` the value past the tile's end.
__device__ int suffix_after(int v, bool c, int after, Shared& sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int ic = c;
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
    sh.warp_v[w] = v;
    sh.warp_c[w] = ic;
  }
  __syncthreads();
  int r = after;
  for (int i = NWARP - 1; i > w; --i)
    r = max(sh.warp_v[i], sh.warp_c[i] ? r : NEG);
  return max(ev, ec ? r : NEG);
}

// The max of *carry and of x over the threads before this one; *carry
// becomes the max over all of them once every thread has read it.
__device__ int prefix_before(int x, int* carry, Shared& sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int incl = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl = max(incl, y);
  }
  const int ex = __shfl_up_sync(FULL, incl, 1);
  if (lane == 31) sh.warp_v[w] = incl;
  __syncthreads();
  int pre = *carry;
  for (int i = 0; i < w; ++i) pre = max(pre, sh.warp_v[i]);
  if (lane > 0) pre = max(pre, ex);
  __syncthreads();
  if (threadIdx.x == NT - 1) *carry = max(pre, x);
  return pre;
}

// Each thread's 8 bits into the tile's words (4 threads a word).
__device__ void put_bits(uint32_t* words, unsigned bits8) {
  unsigned v = bits8 << (8 * (threadIdx.x & 3));
  v |= __shfl_xor_sync(FULL, v, 1);
  v |= __shfl_xor_sync(FULL, v, 2);
  if ((threadIdx.x & 3) == 0) words[threadIdx.x >> 2] = v;
}

__device__ bool bit(const uint32_t* words, int i) {
  return (words[i >> 5] >> (i & 31)) & 1u;
}

// The first set bit in [from, to) of the tile's words, or `to`.
__device__ int next_bit(const uint32_t* words, int from, int to) {
  while (from < to) {
    const uint32_t w = words[from >> 5] >> (from & 31);
    if (w) {
      const int q = from + __ffs(w) - 1;
      return q < to ? q : to;
    }
    from = (from | 31) + 1;
  }
  return to;
}

// Set bits [a, b) of the tile's words.
__device__ void set_range(uint32_t* words, int a, int b) {
  while (a < b) {
    const int wi = a >> 5, lo = a & 31;
    const int hi = min(b - (wi << 5), 32);
    const uint32_t upto = hi == 32 ? FULL : ((1u << hi) - 1u);
    words[wi] |= upto & (FULL << lo);
    a = (wi + 1) << 5;
  }
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

template <int W>
__global__ void __launch_bounds__(NT, 2) select_kernel(Args a) {
  static_assert(TS % W == 0 && W % 32 == 0 && W <= GRID, "cell width");
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const int s = a.s, start = a.start, n = s - start;
  const int64_t* ml = a.ml + static_cast<int64_t>(row) * s;
  const int64_t* dist = a.dist + static_cast<int64_t>(row) * s;
  uint16_t* scr = a.scratch + static_cast<int64_t>(row) * n;
  const int valid = a.valid[row];
  const bool hist = a.data != nullptr;
  const int ntiles = (n + TS - 1) / TS;

  for (int i = tid; i < NUM_LL + NUM_OF; i += NT) {
    if (i < NUM_LL) sh.ll[i] = 0;
    else sh.of[i - NUM_LL] = 0;
  }
  if (tid == 0) {
    sh.carry[0] = NEG;
    sh.carry[1] = start;
    sh.carry[2] = 0;
    sh.carry[3] = 0;
  }
  __syncthreads();

  // ---- pass 1, backward: run extension -> scratch (ext | eq << 15)
  for (int k = ntiles - 1; k >= 0; --k) {
    const int p0 = start + k * TS + tid * K;
    const int after = sh.carry[0];
    int v[K];
    unsigned cbits = 0, eqbits = 0, mbits = 0;
    int m_next = 0;
    int64_t d_next = 0;
    if (p0 + K < s) {
      m_next = static_cast<int>(ml[p0 + K]);
      d_next = dist[p0 + K];
    }
#pragma unroll
    for (int j = K - 1; j >= 0; --j) {
      const int p = p0 + j;
      int m = 0;
      int64_t d = 0;
      if (p < s) {
        m = static_cast<int>(ml[p]);
        d = dist[p];
      }
      const bool matched = m >= MIN_MATCH;
      const bool eq = p + 1 < s && d_next == d;
      const bool c = matched && m_next >= MIN_MATCH && eq;
      v[j] = matched ? m + p : NEG;
      cbits |= static_cast<unsigned>(c) << j;
      eqbits |= static_cast<unsigned>(eq) << j;
      mbits |= static_cast<unsigned>(matched) << j;
      m_next = m;
      d_next = d;
    }
    int av = NEG;
    bool ac = true;
#pragma unroll
    for (int j = K - 1; j >= 0; --j) {
      const bool c = (cbits >> j) & 1u;
      av = max(v[j], c ? av : NEG);
      ac = c && ac;
    }
    int r = suffix_after(av, ac, after, sh);
    uint16_t out[K];
#pragma unroll
    for (int j = K - 1; j >= 0; --j) {
      const int p = p0 + j;
      r = max(v[j], ((cbits >> j) & 1u) ? r : NEG);
      int ext = 0;
      if ((mbits >> j) & 1u)
        ext = max(0, min(min(r - p, MAX_MATCH), valid - p));
      out[j] = static_cast<uint16_t>(ext | (((eqbits >> j) & 1u) << 15));
    }
    if (p0 < s) {
#pragma unroll
      for (int j = 0; j < K; ++j) scr[p0 - start + j] = out[j];
    }
    __syncthreads();                    // every thread has read carry[0]
    if (tid == 0) sh.carry[0] = r;      // the value at the tile's start
    __syncthreads();
  }

  // ---- pass 2, forward: demotion, phase 1, phase 2, outputs
  for (int k = 0; k < ntiles; ++k) {
    const int base = start + k * TS;
    const int lo = tid * K;             // the thread's first lane in the tile
    const int p0 = base + lo;
    const bool live = p0 < s;           // all K positions, or none (8 | W | s)
    // ext and the equality bit at p0 - 1 .. p0 + K
    int e[K + 2];
    unsigned eqprev = 0;                // bit j: dist[p - 1] == dist[p]
#pragma unroll
    for (int i = 0; i < K + 2; ++i) {
      const int p = p0 - 1 + i;
      uint16_t u = 0;
      if (live && p >= start && p < s) u = scr[p - start];
      e[i] = u & 0x1FF;
      if (i < K) eqprev |= static_cast<unsigned>(u >> 15) << i;
    }
    // demoted ml at p0 - 1 .. p0 + K - 1, and whether each is matched
    int dm[K + 1];
    unsigned mt = 0;
#pragma unroll
    for (int i = 0; i <= K; ++i) {
      const bool demote = a.lazy && e[i + 1] > e[i] && e[i] >= MIN_MATCH &&
                          e[i + 1] >= MIN_MATCH;
      dm[i] = demote ? 0 : e[i];
      const bool m = dm[i] >= MIN_MATCH && p0 - 1 + i < valid;
      mt |= static_cast<unsigned>(m) << i;
    }
    // phase 1: run starts
    int x = -1;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool boundary = !(((mt >> (j + 1)) & 1u) && ((mt >> j) & 1u) &&
                              ((eqprev >> j) & 1u));
      if (boundary) x = p0 + j;
    }
    int rs = prefix_before(x, &sh.carry[1], sh);
    int ml_run[K];
    unsigned long_ok = 0;
    x = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int p = p0 + j;
      const bool boundary = !(((mt >> (j + 1)) & 1u) && ((mt >> j) & 1u) &&
                              ((eqprev >> j) & 1u));
      if (boundary) rs = p;
      ml_run[j] = min(dm[j + 1], GRID - ((p - rs) & (GRID - 1)));
      const bool ok = ((mt >> (j + 1)) & 1u) && ml_run[j] >= LONG;
      long_ok |= static_cast<unsigned>(ok) << j;
      if (ok) x = max(x, p + ml_run[j]);
    }
    // raw ends -> sel1
    int run = prefix_before(x, &sh.carry[2], sh);
    unsigned sel1 = 0;
    x = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int p = p0 + j;
      if ((long_ok >> j) & 1u) {
        if (run <= p) {
          sel1 |= 1u << j;
          x = max(x, p + ml_run[j]);
        }
        run = max(run, p + ml_run[j]);
      }
    }
    // selected ends -> covered
    run = prefix_before(x, &sh.carry[3], sh);
    unsigned covered = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int p = p0 + j;
      covered |= static_cast<unsigned>(run > p) << j;
      if ((sel1 >> j) & 1u) run = max(run, p + ml_run[j]);
    }
    if (!live) sel1 = 0;
    put_bits(sh.sel1, sel1);
    __syncthreads();

    // phase 2: ml_short and the walk's candidates
    int ml_short[K];
    unsigned cand = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int l = lo + j;
      const int cell_end = (l | (W - 1)) + 1;
      int m = min(dm[j + 1], W - (l & (W - 1)));
      const int nxt = next_bit(sh.sel1, l + 1, cell_end);
      if (nxt < cell_end) m = min(m, nxt - l);
      ml_short[j] = m;
      const bool ok = ((mt >> (j + 1)) & 1u) && !((sel1 >> j) & 1u) &&
                      !((covered >> j) & 1u) && m >= MIN_MATCH;
      cand |= static_cast<unsigned>(ok && live) << j;
      sh.ml_short[l] = static_cast<uint16_t>(m);
    }
    put_bits(sh.cand, cand);
    __syncthreads();
    if (tid < TS / W && base + tid * W < s) {
      const int cb = tid * W;
      for (int i = cb >> 5; i < (cb + W) >> 5; ++i) sh.vis[i] = sh.sel2[i] = 0;
      int cur = 0;
      for (;;) {
        const int c = next_bit(sh.cand, cb + cur, cb + W) - cb;
        set_range(sh.vis, cb + cur, cb + c);
        if (c >= W) break;
        sh.sel2[(cb + c) >> 5] |= 1u << ((cb + c) & 31);
        cur = c + sh.ml_short[cb + c];
      }
    }
    __syncthreads();

    if (live) {
      uint64_t selw = 0, litw = 0;
      int64_t* mo = a.ml_out + static_cast<int64_t>(row) * n + (p0 - start);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int l = lo + j;
        const int p = p0 + j;
        const bool s1 = (sel1 >> j) & 1u;
        const bool s2 = bit(sh.sel2, l) && ((cand >> j) & 1u);
        const bool lit = bit(sh.vis, l) && p < valid &&
                         !((covered >> j) & 1u) && !s1 && !s2;
        const int me = s1 ? ml_run[j] : ml_short[j];
        mo[j] = me;
        selw |= static_cast<uint64_t>(s1 || s2) << (8 * j);
        litw |= static_cast<uint64_t>(lit) << (8 * j);
        if (hist) {
          if (s1 || s2) {
            const int64_t d = dist[p];
            const int dc =
                static_cast<int>(d < 1 ? 1 : (d > 32768 ? 32768 : d));
            atomicAdd(&sh.ll[length_sym(max(me, MIN_MATCH))], 1u);
            atomicAdd(&sh.of[offset_sym(dc)], 1u);
          } else if (lit) {
            atomicAdd(&sh.ll[a.data[row * a.data_stride + p]], 1u);
          }
        }
      }
      const int64_t w = (static_cast<int64_t>(row) * n + (p0 - start)) / K;
      a.sel_out[w] = selw;
      a.lit_out[w] = litw;
    }
  }

  if (hist) {
    __syncthreads();
    for (int i = tid; i < NUM_LL + NUM_OF; i += NT) {
      if (i < NUM_LL)
        a.ll_out[static_cast<int64_t>(row) * NUM_LL + i] =
            static_cast<uint16_t>(min(sh.ll[i], 65535u));
      else
        a.of_out[static_cast<int64_t>(row) * NUM_OF + i - NUM_LL] =
            static_cast<uint16_t>(min(sh.of[i - NUM_LL], 65535u));
    }
  }
}

}  // namespace

// Run the selection on b windows of s positions: ml, dist int64 (b, s);
// valid int32 (b,); data uint8 rows of data_stride bytes whose byte p is
// position p's (null: no histograms); outputs for positions [start, s):
// ml_out int64 (b, s - start), sel and lit bool (b, s - start), ll_out
// uint16 (b, 288) and of_out uint16 (b, 30) when data is given; scratch
// uint16 (b, s - start). W (64 or 256) and start must divide s - start and
// start, and s - start must be a multiple of 8; the bool outputs must be
// 8-byte aligned. Returns a CUDA error code (0: launched).
extern "C" int ldrsx_select(const void* ml, const void* dist,
                            const void* valid, const void* data,
                            long long data_stride, int b, int s, int start,
                            int wtile, int lazy, void* ml_out, void* sel_out,
                            void* lit_out, void* ll_out, void* of_out,
                            void* scratch, void* stream) {
  if (b <= 0) return 0;
  if ((wtile != 64 && wtile != 256) || start < 0 || s < start ||
      (s - start) % wtile || start % wtile ||
      (reinterpret_cast<uintptr_t>(sel_out) & 7) ||
      (reinterpret_cast<uintptr_t>(lit_out) & 7))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.ml = static_cast<const int64_t*>(ml);
  a.dist = static_cast<const int64_t*>(dist);
  a.valid = static_cast<const int32_t*>(valid);
  a.data = static_cast<const uint8_t*>(data);
  a.data_stride = data_stride;
  a.s = s;
  a.start = start;
  a.lazy = lazy;
  a.ml_out = static_cast<int64_t*>(ml_out);
  a.sel_out = static_cast<uint64_t*>(sel_out);
  a.lit_out = static_cast<uint64_t*>(lit_out);
  a.ll_out = static_cast<uint16_t*>(ll_out);
  a.of_out = static_cast<uint16_t*>(of_out);
  a.scratch = static_cast<uint16_t*>(scratch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wtile == 64)
    select_kernel<64><<<b, NT, 0, st>>>(a);
  else
    select_kernel<256><<<b, NT, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
