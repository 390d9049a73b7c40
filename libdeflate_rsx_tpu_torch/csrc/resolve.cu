// LZ copy resolution, pass 2 of the two-pass decoder, on NVIDIA Hopper
// (sm_90a): a batch of pass-1 token columns -> each stream's bytes.
//
// Replaces the JAX package's device resolver,
// libdeflate_rsx_tpu/ops/resolve.py:47 resolve_batch_jax (a binary-search
// covering map and pointer doubling, a shape the TPU forced: any scatter
// cost minutes of XLA compile there), whose host counterpart is
// libdeflate_rsx_tpu/native/codec.c:2735 resolve_tokens_c. It computes the
// JAX graph's function: token kinds 0 and 3 emit nothing, outlen is
// min(sum of the extents, out_cap), and ok is false when the sum passes
// out_cap or a match starts closer to the start of the output than its
// distance. Tokens at or past a stream's count (when counts are given)
// are not read and emit nothing. Only the bytes [0, outlen) of ok rows
// are written. The plain PyTorch version is ops/resolve.py
// resolve_batch_plain.
//
// One C call clears a small scan state and launches three kernels:
//
// scan_kernel: a single-pass chained scan of the token extents. A thread
//   block takes a tile of SCAN_TOKENS tokens of one stream from an atomic
//   ticket (stream-major, so every earlier tile of its stream is resident
//   or done), reads each token once (none past the stream's count), and
//   publishes its tile's sum at once; a tile that emits takes its carry
//   from a decoupled look-back over the earlier tiles' status words (the
//   nearest inclusive sum and the sums after it). With the starts it
//   flags a match that starts closer to the start than its distance and
//   records, for every window of WIN output bytes whose first byte one of
//   its tokens covers, that token's index and start. Each stream's sum,
//   flag and last emitting token gather in atomics; the stream's last
//   tile to finish writes outlen and ok.
// window_kernel: a thread block of WIN_THREADS threads per (stream,
//   window), every window of every stream at once. It reads the window's
//   tokens (from the one that covers its first byte to the one that
//   covers the next window's), scans their extents in chunks and writes
//   each token's code at its start in a covering map in shared memory
//   (the first token at 0, its real start kept apart). A block-wide
//   max-scan gives every byte its covering token, and with it its
//   parent: itself for a literal; inside a match that starts at s with
//   distance d, position s - d + ((p - s) mod d), which lies before s and
//   holds the same byte; a marker that names the source when that lies
//   before the window. Parents are resolved by pointer jumping in shared
//   memory, in place (a byte takes its parent's value: a further
//   ancestor, a byte or a marker), one barrier a round, until no pointer
//   is left: at most ceil(log2(WIN)) + 1 rounds, however long a chain of
//   matches that read each other. The window's 16-bit values (byte or
//   marker) go out.
// finish_kernel: a thread block per stream walks its windows in order
//   through a ring of the last RING final bytes in shared memory: every
//   marker's source lies in the MAX_BACK bytes before its window, so a
//   window is one gather, FIN_SPAN neighbouring bytes a thread, with the
//   next FIN_AHEAD windows' values in flight. Its steps are the stream's
//   windows, ceil(outlen / WIN), whatever its chains: the 1 MiB run of
//   one byte takes 128 steps of one gather each.
//
// Why the finish walks. After the windows most bytes of the main path's
// data are markers (a chain of copies leaves an 8 KiB window far more
// often than not), so a finish that follows markers in parallel across
// windows moves several bytes of pointer per marker and step; on the
// main path's sets it was slower than this walk, and so was a walk in
// segments joined by a chain of fix-ups (PERF.md, section 6).
//
// What bounds it on this card: bytes, at the ideal (each real token read
// once, each output byte written once). The call reads the tokens twice
// (the scan, and the windows their own; with `counts` no token past a
// stream's count), writes and reads 2 bytes of value per output byte and
// writes each output byte once. In practice it is latency: the
// window blocks' barriers and rounds, and the finish, which runs a
// stream's windows on one SM, so a batch of few long streams (the 17 L6
// items) leaves most SMs idle there. What the design does about it: one
// scan launch that reads each token once; windows that cost rounds, not
// steps per match; a finish step that is a shared-memory gather.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int KIND_SHIFT = 29;
constexpr int64_t MAX_CAP = 1 << 30;     // int positions stay in range

constexpr int SCAN_THREADS = 128;
constexpr int SCAN_ITEMS = 16;
static_assert(SCAN_ITEMS % 4 == 0, "a scan thread's tokens are 16-byte words");
constexpr int SCAN_TOKENS = SCAN_THREADS * SCAN_ITEMS;   // a scan tile

constexpr int WIN = 8192;                // output bytes per window
constexpr int WIN_THREADS = 512;
constexpr int WIN_BLOCKS = 4;            // window blocks an SM holds
constexpr int BPT = WIN / WIN_THREADS;   // bytes a window thread owns
constexpr int CHUNK_ITEMS = 4;           // tokens a thread reads a chunk
constexpr int CHUNK = WIN_THREADS * CHUNK_ITEMS;
constexpr int MAX_BACK = 257 + 32768;    // farthest a marker reaches back
// the covering map's codes: 0 no token starts here, 0x100 | byte a
// literal, 0x8000 | (distance - 1) a match
constexpr uint16_t HEAD_LIT = 0x100, HEAD_MATCH = 0x8000;
// a window byte's value: v < WIN points at position v of the window;
// BYTE0 + c is the byte c; MARK0 + k (k >= 1) the marker of the source k
// bytes before the window
constexpr int BYTE0 = WIN;
constexpr int MARK0 = WIN + 255;
static_assert(MARK0 + MAX_BACK < 65536, "values fit 16 bits");
static_assert(BPT % 8 == 0, "a window thread's values are 16-byte words");

constexpr int FIN_THREADS = 1024;
constexpr int FIN_SPAN = WIN / FIN_THREADS;  // positions a finish thread owns
constexpr int FIN_BLOCKS = 2;            // finish blocks an SM holds
constexpr int FIN_AHEAD = 2;             // windows of values in flight
constexpr int RING = 65536;              // finish_kernel's ring, bytes
static_assert(WIN + MAX_BACK <= RING, "a window and its reach fit the ring");
static_assert(FIN_SPAN == 8, "a finish thread's values are one 16-byte word");

// a scan status word: its flag in the top two bits, a sum below
enum : unsigned long long {
  AGGREGATE = 1ull << 62,
  INCLUSIVE = 2ull << 62,
  VALUE = (1ull << 62) - 1,
};

// per stream, cleared before each call
struct StreamState {
  unsigned long long total;   // sum of the extents
  unsigned bad;               // a match reaches before the start
  unsigned done;              // tiles finished
  int tend;                   // 1 + index of the last emitting token
  int pad;
};

__device__ __forceinline__ int kind_of(int32_t tok) {
  return (tok >> KIND_SHIFT) & 3;
}

// output bytes a token emits: a match its length, a literal 1, else 0
__device__ __forceinline__ int extent(int32_t tok) {
  const int k = kind_of(tok);
  return k == 2 ? (tok & 0xFF) + 3 : (k == 1 ? 1 : 0);
}

__device__ __forceinline__ int dist_of(int32_t tok) {
  return ((tok >> 8) & 0x7FFF) + 1;
}

template <typename T>
__device__ __forceinline__ T warp_inclusive(T x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

__device__ __forceinline__ int warp_max_inclusive(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x = max(x, y);
  }
  return x;
}

// Exclusive sum of the per-thread values x over a block of NT threads;
// `tot` gets the block's sum. red holds NT / 32 + 1 values. Ends with a
// barrier, after which red may be reused.
template <int NT, typename T>
__device__ __forceinline__ T block_exclusive(T x, T* red, T& tot) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const T incl = warp_inclusive(x, lane);
  if (lane == 31) red[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    const T v = lane < NT / 32 ? red[lane] : T(0);
    const T s = warp_inclusive(v, lane);
    if (lane < NT / 32) red[lane] = s - v;
    if (lane == NT / 32 - 1) red[NT / 32] = s;
  }
  __syncthreads();
  const T out = red[wid] + incl - x;
  tot = red[NT / 32];
  __syncthreads();
  return out;
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  return v;
}

// The exclusive sum of the extents of tiles 0 .. t-1 of a stream, from
// their status words (warp 0 of the thread block; every earlier tile
// publishes at least its aggregate as soon as it has read its tokens).
__device__ long long look_back(const unsigned long long* status, int t) {
  const int lane = threadIdx.x & 31;
  long long excl = 0;
  for (int j = t - 1; j >= 0; j -= 32) {
    const int idx = j - lane;
    unsigned long long s;
    do {
      s = idx >= 0 ? *reinterpret_cast<const volatile unsigned long long*>(
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

__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(const int32_t* __restrict__ tokens, int64_t ld, int ntok,
            const int32_t* __restrict__ counts, int ntiles, int64_t out_cap,
            int nwin, unsigned long long* ticket, StreamState* state,
            unsigned long long* status, int2* __restrict__ win,
            int32_t* __restrict__ outlen, uint8_t* __restrict__ ok) {
  __shared__ int s_ticket, s_last;
  __shared__ long long s_excl;
  __shared__ int red[SCAN_THREADS / 32 + 1];
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) s_ticket = static_cast<int>(atomicAdd(ticket, 1ull));
  __syncthreads();
  const int b = s_ticket / ntiles, tile = s_ticket % ntiles;
  const int n = counts ? min(max(counts[b], 0), ntok) : ntok;
  // the stream's tiles: a tile past its count takes no part (no later
  // tile of the stream reads its status word)
  const int mine = n > 0 ? (n + SCAN_TOKENS - 1) / SCAN_TOKENS : 1;
  if (tile >= mine) return;
  const int32_t* row = tokens + static_cast<int64_t>(b) * ld;
  const int first = tile * SCAN_TOKENS + tid * SCAN_ITEMS;
  int32_t tok[SCAN_ITEMS];
  if (first + SCAN_ITEMS <= n &&
      (reinterpret_cast<uintptr_t>(row + first) & 15) == 0) {
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; j += 4) {
      const int4 q = *reinterpret_cast<const int4*>(row + first + j);
      tok[j] = q.x, tok[j + 1] = q.y, tok[j + 2] = q.z, tok[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j)
      tok[j] = first + j < n ? row[first + j] : 0;
  }
  int sum = 0, last = -1;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    const int e = extent(tok[j]);
    sum += e;
    if (e) last = first + j;
  }
  // the tile's last emitting token
#pragma unroll
  for (int o = 16; o; o >>= 1) last = max(last, __shfl_xor_sync(FULL, last, o));
  if (tid == 0) s_last = -1;
  __syncthreads();
  if (lane == 0 && last >= 0) atomicMax(&s_last, last);
  int tile_sum;
  const int excl_in_tile = block_exclusive<SCAN_THREADS>(sum, red, tile_sum);

  unsigned long long* srow = status + static_cast<int64_t>(b) * ntiles;
  StreamState* ss = state + b;
  if (tid == 0) {
    atomicExch(&srow[tile], (tile == 0 ? INCLUSIVE : AGGREGATE) |
                                static_cast<unsigned long long>(tile_sum));
    if (tile_sum) atomicAdd(&ss->total, static_cast<unsigned long long>(tile_sum));
    if (s_last >= 0) atomicMax(&ss->tend, s_last + 1);
  }
  // the carry: only a tile that emits needs it
  if (tile_sum && tid < 32) {
    const long long excl = tile == 0 ? 0 : look_back(srow, tile);
    if (tid == 0) {
      if (tile)
        atomicExch(&srow[tile], INCLUSIVE | static_cast<unsigned long long>(
                                                excl + tile_sum));
      s_excl = excl;
    }
  }
  __syncthreads();
  int bad = 0;
  if (tile_sum) {
    long long start = s_excl + excl_in_tile;
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      const int e = extent(tok[j]);
      if (kind_of(tok[j]) == 2 && start < dist_of(tok[j])) bad = 1;
      if (e > 0) {
        // the first window boundary at or after start, if this token
        // covers it (a token covers at most one: e <= 258 <= WIN)
        const long long w = (start + WIN - 1) / WIN;
        if (w < nwin && w * WIN < start + e)
          win[static_cast<int64_t>(b) * nwin + w] =
              make_int2(first + j, static_cast<int>(start));
      }
      start += e;
    }
  }
  bad = __syncthreads_or(bad);
  if (tid == 0) {
    if (bad) atomicOr(&ss->bad, 1u);
    __threadfence();
    if (atomicAdd(&ss->done, 1u) == static_cast<unsigned>(mine - 1)) {
      __threadfence();
      const unsigned long long total = atomicAdd(&ss->total, 0ull);
      const unsigned anybad = atomicOr(&ss->bad, 0u);
      outlen[b] = static_cast<int32_t>(
          total < static_cast<unsigned long long>(out_cap) ? total : out_cap);
      ok[b] = total <= static_cast<unsigned long long>(out_cap) && !anybad;
    }
  }
}

// A window thread's run of BPT 16-bit values in shared memory (run
// `tid` of `a`), as BPT / 2 words, and back.
__device__ __forceinline__ void load_run(const uint16_t* a, int tid,
                                         uint32_t (&w)[BPT / 2]) {
  const uint4* a4 = reinterpret_cast<const uint4*>(a) + tid * (BPT / 8);
#pragma unroll
  for (int i = 0; i < BPT / 8; ++i) {
    const uint4 v = a4[i];
    w[4 * i] = v.x, w[4 * i + 1] = v.y, w[4 * i + 2] = v.z, w[4 * i + 3] = v.w;
  }
}

__device__ __forceinline__ void store_run(uint16_t* a, int tid,
                                          const uint32_t (&w)[BPT / 2]) {
  uint4* a4 = reinterpret_cast<uint4*>(a) + tid * (BPT / 8);
#pragma unroll
  for (int i = 0; i < BPT / 8; ++i)
    a4[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
}

__global__ void __launch_bounds__(WIN_THREADS, WIN_BLOCKS)
window_kernel(const int32_t* __restrict__ tokens, int64_t ld, int nwin,
              const int2* __restrict__ win,
              const StreamState* __restrict__ state,
              const int32_t* __restrict__ outlen,
              const uint8_t* __restrict__ ok,
              uint16_t* __restrict__ vals) {
  __shared__ __align__(16) uint16_t head[WIN];
  __shared__ __align__(16) uint16_t x[WIN];
  __shared__ int red[WIN_THREADS / 32 + 1];
  const int64_t g = blockIdx.x;
  const int b = static_cast<int>(g / nwin);
  const int w = static_cast<int>(g % nwin);
  if (!ok[b]) return;
  const int len = outlen[b];
  const int ws = w * WIN;
  if (ws >= len) return;
  const int wlen = min(len - ws, WIN);
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int32_t* row = tokens + static_cast<int64_t>(b) * ld;
  const int2 f = win[g];
  const int t0 = f.x;
  const int s0 = f.y - ws;                 // in [-257, 0]
  // the token that covers the next window's first byte, or the last
  // emitting one
  const int t1 = ws + WIN < len ? win[g + 1].x : state[b].tend - 1;

  uint4* h4 = reinterpret_cast<uint4*>(head);
  for (int k = tid; k < WIN / 8; k += WIN_THREADS) h4[k] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // the covering map: each emitting token's code at its start
  int base = s0;                           // start of the chunk's first token
  for (int c0 = t0; c0 <= t1; c0 += CHUNK) {
    int32_t tk[CHUNK_ITEMS];
    int sum = 0;
#pragma unroll
    for (int j = 0; j < CHUNK_ITEMS; ++j) {
      const int i = c0 + tid * CHUNK_ITEMS + j;
      tk[j] = i <= t1 ? row[i] : 0;
      sum += extent(tk[j]);
    }
    int tot;
    int s = base + block_exclusive<WIN_THREADS>(sum, red, tot);
#pragma unroll
    for (int j = 0; j < CHUNK_ITEMS; ++j) {
      const int e = extent(tk[j]);
      if (e > 0) {
        const int k = kind_of(tk[j]);
        const uint16_t code =
            k == 1 ? static_cast<uint16_t>(HEAD_LIT | (tk[j] & 0xFF))
                   : static_cast<uint16_t>(HEAD_MATCH | ((tk[j] >> 8) & 0x7FFF));
        if (c0 + tid * CHUNK_ITEMS + j == t0)
          head[0] = code;
        else if (s < wlen)
          head[s] = code;
      }
      s += e;
    }
    base += tot;
  }
  __syncthreads();

  // every byte's covering token (a block max-scan of head positions),
  // then its parent
  const int p0 = tid * BPT;
  uint32_t hw[BPT / 2];
  load_run(head, tid, hw);
  auto hv = [&](int j) { return (hw[j >> 1] >> (16 * (j & 1))) & 0xFFFF; };
  int lasth = -1;
#pragma unroll
  for (int j = 0; j < BPT; ++j)
    if (hv(j)) lasth = p0 + j;
  const int wincl = warp_max_inclusive(lasth, lane);
  if (lane == 31) red[wid] = wincl;
  __syncthreads();
  if (wid == 0) {
    const int v = lane < WIN_THREADS / 32 ? red[lane] : -1;
    const int s = warp_max_inclusive(v, lane);
    const int e = __shfl_up_sync(FULL, s, 1);
    if (lane < WIN_THREADS / 32) red[lane] = lane ? e : -1;
  }
  __syncthreads();
  const int wexcl = __shfl_up_sync(FULL, wincl, 1);
  int cur = max(red[wid], lane ? wexcl : -1);
  int code = cur >= 0 ? head[cur] : 0;     // position 0 always holds one
  int xr[BPT];
#pragma unroll
  for (int j = 0; j < BPT; ++j) {
    const int p = p0 + j;
    if (hv(j)) cur = p, code = hv(j);
    int v;
    if (code & HEAD_MATCH) {
      const int s = cur == 0 ? s0 : cur;
      const int d = (code & 0x7FFF) + 1;
      int off = p - s;
      if (off >= d) off %= d;
      const int q = s - d + off;
      v = q >= 0 ? q : MARK0 - q;
    } else {
      v = BYTE0 + (code & 0xFF);
    }
    xr[j] = v;
  }
  {
    uint32_t xw[BPT / 2];
#pragma unroll
    for (int j = 0; j < BPT / 2; ++j)
      xw[j] = static_cast<uint32_t>(xr[2 * j]) |
              static_cast<uint32_t>(xr[2 * j + 1]) << 16;
    store_run(x, tid, xw);
  }
  __syncthreads();

  // pointer jumping, in place: a byte takes its parent's value. Here
  // thread tid holds positions tid + k * WIN_THREADS, so that a warp's
  // writes fall in distinct banks.
  int yr[BPT];
  unsigned pend = 0;
#pragma unroll
  for (int k = 0; k < BPT; ++k) {
    const int p = tid + k * WIN_THREADS;
    yr[k] = x[p];
    if (p < wlen && yr[k] < WIN) pend |= 1u << k;
  }
  while (__syncthreads_or(pend != 0)) {
#pragma unroll
    for (int k = 0; k < BPT; ++k) {
      if (pend >> k & 1) {
        const int v = x[yr[k]];
        yr[k] = v;
        x[tid + k * WIN_THREADS] = static_cast<uint16_t>(v);
        if (v >= WIN) pend &= ~(1u << k);
      }
    }
  }

  // the values, 16-bit, as the thread's own run of BPT
  uint32_t vw[BPT / 2];
  load_run(x, tid, vw);
  uint4* vrow = reinterpret_cast<uint4*>(vals + g * WIN) + tid * (BPT / 8);
#pragma unroll
  for (int i = 0; i < BPT / 8; ++i)
    vrow[i] = make_uint4(vw[4 * i], vw[4 * i + 1], vw[4 * i + 2], vw[4 * i + 3]);
}

// A finish thread's FIN_SPAN values of a window.
__device__ __forceinline__ uint4 load_span(const uint16_t* v, bool live) {
  return live ? *reinterpret_cast<const uint4*>(v) : make_uint4(0, 0, 0, 0);
}

__global__ void __launch_bounds__(FIN_THREADS, FIN_BLOCKS)
finish_kernel(int nwin, const uint16_t* __restrict__ vals,
              const int32_t* __restrict__ outlen,
              const uint8_t* __restrict__ ok, uint8_t* __restrict__ out,
              int64_t pitch) {
  extern __shared__ __align__(16) uint8_t ring[];
  const int b = blockIdx.x;
  if (!ok[b]) return;
  const int len = outlen[b];
  const int tid = threadIdx.x;
  const uint16_t* vrow = vals + static_cast<int64_t>(b) * nwin * WIN;
  uint8_t* orow = out + static_cast<int64_t>(b) * pitch;
  const bool words = (pitch & 7) == 0;     // every row starts 8-aligned
  const int nw = (len + WIN - 1) / WIN;
  const int q0 = tid * FIN_SPAN;           // the thread's first position
  // the values of the next FIN_AHEAD windows are in flight
  uint4 pre[FIN_AHEAD];
#pragma unroll
  for (int a = 0; a < FIN_AHEAD; ++a)
    pre[a] = load_span(vrow + a * WIN + q0, a * WIN + q0 < len);
  for (int w0 = 0; w0 < nw; w0 += FIN_AHEAD) {
#pragma unroll
    for (int a = 0; a < FIN_AHEAD; ++a) {
      const int w = w0 + a;
      if (w >= nw) break;
      const int ws = w * WIN;
      const int p = ws + q0;
      const uint4 cur = pre[a];
      const int nxt = p + FIN_AHEAD * WIN;
      pre[a] = load_span(vrow + nxt, nxt < len);
      if (p < len) {
        // a byte code is the byte; a marker reads its source's final
        // byte in the ring
        const uint32_t vw[4] = {cur.x, cur.y, cur.z, cur.w};
        uint32_t bw[2] = {0, 0};
#pragma unroll
        for (int i = 0; i < FIN_SPAN; ++i) {
          const int v = (vw[i >> 1] >> (16 * (i & 1))) & 0xFFFF;
          const uint32_t byte = v <= MARK0
                                    ? static_cast<uint32_t>(v - BYTE0)
                                    : ring[(ws - (v - MARK0)) & (RING - 1)];
          bw[i >> 2] |= byte << (8 * (i & 3));
        }
        *reinterpret_cast<uint2*>(ring + (p & (RING - 1))) =
            make_uint2(bw[0], bw[1]);
        if (words && p + FIN_SPAN <= len) {
          *reinterpret_cast<uint2*>(orow + p) = make_uint2(bw[0], bw[1]);
        } else {
          for (int i = 0; i < FIN_SPAN && p + i < len; ++i)
            orow[p + i] = static_cast<uint8_t>(bw[i >> 2] >> (8 * (i & 3)));
        }
      }
      __syncthreads();
    }
  }
}

// Scratch of ldrsx_resolve, carved from one buffer, each part 16-byte
// aligned: the scan state (ticket, per-stream state, status words; cleared
// by each call), win (nstreams, nwin) int2 and vals (nstreams, nwin * WIN)
// uint16.
struct Scratch {
  int64_t ntiles, nwin, state, status, clear, win, vals, bytes;
};

int64_t up16(int64_t n) { return (n + 15) & ~int64_t{15}; }

Scratch layout(int64_t nstreams, int64_t ntok, int64_t out_cap) {
  Scratch l;
  l.ntiles = ntok > 0 ? (ntok + SCAN_TOKENS - 1) / SCAN_TOKENS : 1;
  l.nwin = (out_cap + WIN - 1) / WIN;
  l.state = 16;
  l.status = up16(l.state + nstreams * int64_t{sizeof(StreamState)});
  l.clear = l.status + nstreams * l.ntiles * 8;
  l.win = up16(l.clear);
  l.vals = up16(l.win + nstreams * l.nwin * 8);
  l.bytes = l.vals + nstreams * l.nwin * WIN * 2;
  return l;
}

}  // namespace

// ldrsx_resolve_scratch: bytes of scratch that ldrsx_resolve needs.
extern "C" int64_t ldrsx_resolve_scratch(int nstreams, int ntok,
                                         int64_t out_cap) {
  return layout(nstreams, ntok, out_cap).bytes;
}

// ldrsx_resolve: tokens (nstreams rows of ntok int32, row b at
// tokens + b * ld elements); counts (nstreams,) int32 or null: tokens of
// row b at or past counts[b] are not read; scratch (ldrsx_resolve_scratch
// bytes, 16-byte aligned); out (nstreams, pitch) uint8, outlen
// (nstreams,) int32, ok (nstreams,) uint8; out_cap at most MAX_CAP.
// Returns a CUDA error code, 0 on success. No synchronisation.
extern "C" int ldrsx_resolve(const void* tokens, int64_t ld, int ntok,
                             const void* counts, int nstreams,
                             int64_t out_cap, void* scratch, void* out,
                             int64_t pitch, void* outlen, void* ok,
                             void* stream) {
  if (nstreams <= 0) return 0;
  const Scratch l = layout(nstreams, ntok, out_cap);
  if (ntok < 0 || out_cap < 0 || out_cap > MAX_CAP ||
      nstreams * l.ntiles > INT32_MAX || nstreams * l.nwin > INT32_MAX ||
      (reinterpret_cast<uintptr_t>(scratch) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* base = static_cast<uint8_t*>(scratch);
  auto* ticket = reinterpret_cast<unsigned long long*>(base);
  auto* state = reinterpret_cast<StreamState*>(base + l.state);
  auto* status = reinterpret_cast<unsigned long long*>(base + l.status);
  auto* win = reinterpret_cast<int2*>(base + l.win);
  auto* vals = reinterpret_cast<uint16_t*>(base + l.vals);
  const auto* tok = static_cast<const int32_t*>(tokens);
  auto* len = static_cast<int32_t*>(outlen);
  auto* good = static_cast<uint8_t*>(ok);
  const int ntiles = static_cast<int>(l.ntiles);
  const int nwin = static_cast<int>(l.nwin);
  cudaError_t rc = cudaMemsetAsync(base, 0, static_cast<size_t>(l.clear), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  scan_kernel<<<static_cast<unsigned>(nstreams * l.ntiles), SCAN_THREADS, 0,
                s>>>(tok, ld, ntok, static_cast<const int32_t*>(counts),
                     ntiles, out_cap, nwin, ticket, state, status, win, len,
                     good);
  rc = cudaGetLastError();
  if (rc != cudaSuccess || nwin == 0) return static_cast<int>(rc);
  window_kernel<<<static_cast<unsigned>(nstreams * l.nwin), WIN_THREADS, 0,
                  s>>>(tok, ld, nwin, win, state, len, good, vals);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaFuncSetAttribute(finish_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize, RING);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  finish_kernel<<<nstreams, FIN_THREADS, RING, s>>>(
      nwin, vals, len, good, static_cast<uint8_t*>(out), pitch);
  return static_cast<int>(cudaGetLastError());
}
