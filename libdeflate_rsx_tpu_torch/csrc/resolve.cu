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
// distance. Only the bytes [0, outlen) of ok rows are written. The plain
// PyTorch version is ops/resolve.py resolve_batch_plain.
//
// One C call launches five kernels:
//
// tile_sums_kernel, scan_kernel, verdict_kernel: the tokens' output
//   starts. A block per (stream, tile of SCAN_TOKENS tokens) sums the
//   tile's extents; a block per (stream, tile) adds the sums of the
//   earlier tiles for its carry (int64), scans the tile, flags a match
//   that starts closer to the start than its distance, and records, for
//   every window of WIN output bytes whose first byte one of its tokens
//   covers, that token's index and start; a warp per stream writes
//   outlen and ok.
// window_kernel: one warp per (stream, window) resolves the window in
//   shared memory, walking its tokens GROUPS x 32 at a time (the next
//   GROUPS x 32 in flight, their scans interleaved): the lanes' literals
//   are stored at once, and so are the matches of at most SOLO bytes
//   whose source ends before the group's first byte (each by its own
//   lane: they read only final positions); then each other match in turn
//   is spread over the lanes. Byte p of a match that starts at s with
//   distance d copies position s - d + ((p - s) mod d), which lies before
//   s, so no lane reads what the same step writes, whatever d. A position
//   whose source lies before the window holds a marker that names the
//   source; a copy copies markers as it copies bytes. Values are 16 bits:
//   v < 256 is a byte, v >= 256 the marker of source ws - (v - 255) for a
//   window that starts at ws. A match that reaches into the window starts
//   at most 257 bytes before it and reaches at most 32,768 back, so
//   v <= 255 + MAX_BACK.
// finish_kernel: one block per stream walks its windows in order. Every
//   marker's source lies in the MAX_BACK bytes before its window, whose
//   final bytes a ring of RING bytes in shared memory holds, so each
//   window is one parallel gather, four neighbouring bytes a thread (the
//   values of the next FIN_AHEAD windows in flight); the block writes the
//   final bytes in words.
//
// What bounds it on this card: bytes, at the ideal (each real token read
// once, each output byte written once). In practice it is instruction
// issue and latency: a window's walk is a chain of warp steps, one per 32
// tokens, per match that must wait for an earlier one of its group and
// per 32 bytes of such a match; the finish walks a stream's windows one
// after another; the scan reads the padded columns twice. What the design
// does about it: every tile and every window of every stream runs at
// once, so a stream's serial walk is cut into out_cap / WIN pieces, and
// windows of 4 KiB take 8 KiB of shared memory, so some 25 window warps
// share an SM; most matches are copied by their own lane beside the
// others; the finish's step is a shared-memory gather.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int KIND_SHIFT = 29;
constexpr int WIN = 4096;                // output bytes per window
constexpr int MAX_BACK = 257 + 32768;    // farthest a marker reaches back
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 8;
constexpr int SCAN_TOKENS = SCAN_THREADS * SCAN_ITEMS;   // a scan tile
constexpr int GROUPS = 8;                // token groups a window warp holds
constexpr int SOLO = 32;                 // longest match a lane copies alone
constexpr int SOLO_UNROLL = 8;           // bytes a lane reads before writing
constexpr int RING = 65536;              // finish_kernel's ring, bytes
constexpr int FIN_THREADS = WIN / 4;     // a finish thread per word
constexpr int FIN_AHEAD = 4;             // windows of values in flight
constexpr int64_t MAX_CAP = 1 << 30;     // int positions stay in range
static_assert(255 + MAX_BACK < 65536, "markers fit 16 bits");
static_assert(WIN + MAX_BACK <= RING, "a window and its reach fit the ring");
static_assert(FIN_THREADS <= 1024 && WIN % 8 == 0, "a block per window");

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

__device__ __forceinline__ int warp_inclusive(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// The tile of SCAN_TOKENS tokens that block x of a stream scans: thread
// tid holds tokens first + j, j < SCAN_ITEMS, and their extents' sum.
struct Tile {
  int32_t tok[SCAN_ITEMS];
  int64_t first;
  int sum;
};

__device__ __forceinline__ Tile load_tile(const int32_t* row, int ntok,
                                          int tile, int tid) {
  Tile t;
  t.first = static_cast<int64_t>(tile) * SCAN_TOKENS +
            static_cast<int64_t>(tid) * SCAN_ITEMS;
  t.sum = 0;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    t.tok[j] = t.first + j < ntok ? row[t.first + j] : 0;
    t.sum += extent(t.tok[j]);
  }
  return t;
}

// Sum of x over the block; every thread gets it. red holds 32 values.
__device__ __forceinline__ int64_t block_sum(int64_t x, int64_t* red,
                                             int tid) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  if ((tid & 31) == 0) red[tid >> 5] = x;
  __syncthreads();
  x = red[tid & 31];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// tile_sums_kernel: block (tile, stream) -> the tile's extent sum.
__global__ void __launch_bounds__(SCAN_THREADS)
tile_sums_kernel(const int32_t* __restrict__ tokens, int64_t ld, int ntok,
                 int ntiles, int32_t* __restrict__ sums) {
  __shared__ int64_t red[32];
  const int b = blockIdx.x, tile = blockIdx.y, tid = threadIdx.x;
  const Tile t = load_tile(tokens + static_cast<int64_t>(b) * ld, ntok,
                           tile, tid);
  const int64_t total = block_sum(t.sum, red, tid);
  if (tid == 0)
    sums[static_cast<int64_t>(b) * ntiles + tile] = static_cast<int32_t>(total);
}

// scan_kernel: block (tile, stream) adds the sums of the stream's earlier
// tiles for its carry, scans its tile, flags a match that starts closer
// to the start than its distance and records, for every window whose
// first byte one of its tokens covers, that token's index and start.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(const int32_t* __restrict__ tokens, int64_t ld, int ntok,
            int ntiles, const int32_t* __restrict__ sums, int nwin,
            int32_t* __restrict__ win, uint8_t* __restrict__ tile_bad) {
  __shared__ int64_t red[32];
  __shared__ int64_t warp_excl[SCAN_THREADS / 32];
  const int b = blockIdx.x, tile = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, wid = tid >> 5;
  const int32_t* srow = sums + static_cast<int64_t>(b) * ntiles;
  int64_t before = 0;
  for (int i = tid; i < tile; i += SCAN_THREADS) before += srow[i];
  const Tile t = load_tile(tokens + static_cast<int64_t>(b) * ld, ntok,
                           tile, tid);
  const int64_t carry = block_sum(before, red, tid);
  const int incl = warp_inclusive(t.sum, lane);
  if (lane == 31) warp_excl[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    const int64_t v = warp_excl[lane];
    int64_t x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    warp_excl[lane] = x - v;
  }
  __syncthreads();
  int64_t start = carry + warp_excl[wid] + (incl - t.sum);
  int32_t* wrow = win + static_cast<int64_t>(b) * nwin * 2;
  int bad = 0;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    const int e = extent(t.tok[j]);
    if (kind_of(t.tok[j]) == 2 && start < dist_of(t.tok[j])) bad = 1;
    if (e > 0) {
      // the first window boundary at or after start, if this token
      // covers it (a token covers at most one: e <= 258 <= WIN)
      const int64_t w = (start + WIN - 1) / WIN;
      if (w < nwin && w * WIN < start + e) {
        wrow[2 * w] = static_cast<int32_t>(t.first + j);
        wrow[2 * w + 1] = static_cast<int32_t>(start);
      }
    }
    start += e;
  }
  bad = __syncthreads_or(bad);
  if (tid == 0) tile_bad[static_cast<int64_t>(b) * ntiles + tile] = bad;
}

// verdict_kernel: one warp per stream: outlen = min(sum, out_cap); ok when
// the sum is within out_cap and no tile flagged a match.
__global__ void __launch_bounds__(32)
verdict_kernel(const int32_t* __restrict__ sums,
               const uint8_t* __restrict__ tile_bad, int ntiles,
               int64_t out_cap, int32_t* __restrict__ outlen,
               uint8_t* __restrict__ ok) {
  const int b = blockIdx.x, lane = threadIdx.x;
  int64_t total = 0;
  int bad = 0;
  for (int i = lane; i < ntiles; i += 32) {
    total += sums[static_cast<int64_t>(b) * ntiles + i];
    bad |= tile_bad[static_cast<int64_t>(b) * ntiles + i];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(FULL, total, o);
  bad = __any_sync(FULL, bad);
  if (lane == 0) {
    outlen[b] = static_cast<int32_t>(total < out_cap ? total : out_cap);
    ok[b] = total <= out_cap && !bad;
  }
}

__global__ void __launch_bounds__(32)
window_kernel(const int32_t* __restrict__ tokens, int64_t ld, int ntok,
              int nwin, const int32_t* __restrict__ win,
              const int32_t* __restrict__ outlen,
              const uint8_t* __restrict__ ok, uint16_t* __restrict__ vals) {
  __shared__ __align__(16) uint16_t buf[WIN];
  const int64_t g = blockIdx.x;
  const int b = static_cast<int>(g / nwin);
  const int w = static_cast<int>(g % nwin);
  if (!ok[b]) return;
  const int64_t ws = static_cast<int64_t>(w) * WIN;
  const int64_t len = outlen[b];
  if (ws >= len) return;
  // positions below are relative to ws; wlen is the window's length
  const int wlen = static_cast<int>(len - ws < WIN ? len - ws : WIN);
  const int lane = threadIdx.x;
  const int32_t* row = tokens + static_cast<int64_t>(b) * ld;
  const int32_t* wp = win + g * 2;
  int64_t t = wp[0];
  int base = static_cast<int>(wp[1] - ws);   // in [-257, 0]
  // GROUPS groups of 32 tokens in registers, the next GROUPS in flight
  int32_t cur[GROUPS], nxt[GROUPS];
#pragma unroll
  for (int j = 0; j < GROUPS; ++j) {
    const int64_t i = t + 32 * j + lane;
    cur[j] = i < ntok ? row[i] : 0;
  }
  while (base < wlen && t < ntok) {
#pragma unroll
    for (int j = 0; j < GROUPS; ++j) {
      const int64_t i = t + 32 * (GROUPS + j) + lane;
      nxt[j] = i < ntok ? row[i] : 0;
    }
    int incl[GROUPS];
#pragma unroll
    for (int j = 0; j < GROUPS; ++j) incl[j] = extent(cur[j]);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
      for (int j = 0; j < GROUPS; ++j) {
        const int y = __shfl_up_sync(FULL, incl[j], o);
        if (lane >= o) incl[j] += y;
      }
    }
#pragma unroll
    for (int j = 0; j < GROUPS; ++j) {
      if (base >= wlen) break;
      const int32_t tok = cur[j];
      const int k = kind_of(tok);
      const int e = extent(tok);
      const int s = base + incl[j] - e;
      const int d = dist_of(tok);
      const bool copy = k == 2 && s < wlen && s + e > 0;
      // a short match whose source ends before the group's first byte
      // reads only final positions: its lane copies it alone
      const bool solo = copy && e <= SOLO && s - d + (e < d ? e : d) <= base;
      if (k == 1 && s >= 0 && s < wlen)
        buf[s] = static_cast<uint16_t>(tok & 0xFF);
      if (solo) {
        const int lo = s > 0 ? s : 0;
        const int hi = s + e < wlen ? s + e : wlen;
        if (d >= e) {
          // a plain copy from s - d; its reads and writes never meet, so
          // SOLO_UNROLL reads go out before their writes
          for (int p0 = lo; p0 < hi; p0 += SOLO_UNROLL) {
            uint16_t v[SOLO_UNROLL];
#pragma unroll
            for (int i = 0; i < SOLO_UNROLL; ++i) {
              const int q = p0 + i - d;
              v[i] = q >= 0 ? (p0 + i < hi ? buf[q] : uint16_t{0})
                            : static_cast<uint16_t>(255 - q);
            }
#pragma unroll
            for (int i = 0; i < SOLO_UNROLL; ++i)
              if (p0 + i < hi) buf[p0 + i] = v[i];
          }
        } else {
          for (int p = lo; p < hi; ++p) {
            const int q = s - d + (p - s) % d;
            buf[p] = q >= 0 ? buf[q] : static_cast<uint16_t>(255 - q);
          }
        }
      }
      __syncwarp();
      unsigned m = __ballot_sync(FULL, copy && !solo);
      while (m) {
        const int i = __ffs(m) - 1;
        m &= m - 1;
        const int ms = __shfl_sync(FULL, s, i);
        const int ml = __shfl_sync(FULL, e, i);
        const int md = dist_of(__shfl_sync(FULL, tok, i));
        const int hi = ms + ml < wlen ? ms + ml : wlen;
        for (int p = (ms > 0 ? ms : 0) + lane; p < hi; p += 32) {
          int off = p - ms;
          if (off >= md) off %= md;
          const int q = ms - md + off;
          buf[p] = q >= 0 ? buf[q] : static_cast<uint16_t>(255 - q);
        }
        __syncwarp();
      }
      base += __shfl_sync(FULL, incl[j], 31);
    }
    t += 32 * GROUPS;
#pragma unroll
    for (int j = 0; j < GROUPS; ++j) cur[j] = nxt[j];
  }
  __syncwarp();
  uint4* dst = reinterpret_cast<uint4*>(
      vals + static_cast<int64_t>(b) * nwin * WIN + ws);
  const uint4* src = reinterpret_cast<const uint4*>(buf);
  for (int i = lane; i < (wlen + 7) >> 3; i += 32) dst[i] = src[i];
}

__device__ __forceinline__ uint2 load_vals(const uint16_t* vrow, int p,
                                           int len) {
  return p < len ? *reinterpret_cast<const uint2*>(vrow + p)
                 : make_uint2(0, 0);
}

__global__ void __launch_bounds__(FIN_THREADS)
finish_kernel(const uint16_t* __restrict__ vals, int nwin,
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
  const bool words = (pitch & 3) == 0;     // every row starts word-aligned
  const int nw = (len + WIN - 1) / WIN;
  // each thread resolves 4 neighbouring positions of a window; the values
  // of the next FIN_AHEAD windows are in flight
  uint2 pre[FIN_AHEAD];
#pragma unroll
  for (int a = 0; a < FIN_AHEAD; ++a)
    pre[a] = load_vals(vrow, a * WIN + 4 * tid, len);
  for (int w0 = 0; w0 < nw; w0 += FIN_AHEAD) {
#pragma unroll
    for (int a = 0; a < FIN_AHEAD; ++a) {
      const int w = w0 + a;
      if (w >= nw) break;
      const int ws = w * WIN;
      const int p = ws + 4 * tid;
      const uint2 cur = pre[a];
      pre[a] = load_vals(vrow, p + FIN_AHEAD * WIN, len);
      if (p < len) {
        uint32_t word;
        if (((cur.x | cur.y) & 0xFF00FF00u) == 0) {   // four bytes
          word = __byte_perm(cur.x, cur.y, 0x6420);
        } else {
          const uint32_t v[4] = {cur.x & 0xFFFF, cur.x >> 16, cur.y & 0xFFFF,
                                 cur.y >> 16};
          word = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t byte =
                v[i] < 256
                    ? v[i]
                    : ring[(ws - static_cast<int>(v[i] - 255)) & (RING - 1)];
            word |= byte << (8 * i);
          }
        }
        *reinterpret_cast<uint32_t*>(ring + (p & (RING - 1))) = word;
        if (words && p + 4 <= len) {
          *reinterpret_cast<uint32_t*>(orow + p) = word;
        } else {
          for (int i = 0; i < 4 && p + i < len; ++i)
            orow[p + i] = static_cast<uint8_t>(word >> (8 * i));
        }
      }
      __syncthreads();
    }
  }
}

// Scratch of ldrsx_resolve, carved from one buffer: vals (nstreams,
// nwin * WIN) uint16 first (16-byte aligned), win (nstreams, nwin, 2)
// int32, sums (nstreams, ntiles) int32, tile_bad (nstreams, ntiles) uint8.
struct Scratch {
  int64_t ntiles, nwin, vals, win, sums, tile_bad, bytes;
};

Scratch layout(int64_t nstreams, int64_t ntok, int64_t out_cap) {
  Scratch l;
  l.ntiles = (ntok + SCAN_TOKENS - 1) / SCAN_TOKENS;
  l.nwin = (out_cap + WIN - 1) / WIN;
  l.vals = 0;
  l.win = l.vals + nstreams * l.nwin * WIN * 2;
  l.sums = l.win + nstreams * l.nwin * 2 * 4;
  l.tile_bad = l.sums + nstreams * l.ntiles * 4;
  l.bytes = l.tile_bad + nstreams * l.ntiles;
  return l;
}

}  // namespace

// ldrsx_resolve_scratch: bytes of scratch that ldrsx_resolve needs.
extern "C" int64_t ldrsx_resolve_scratch(int nstreams, int ntok,
                                         int64_t out_cap) {
  return layout(nstreams, ntok, out_cap).bytes;
}

// ldrsx_resolve: tokens (nstreams rows of ntok int32, row b at
// tokens + b * ld elements); scratch (ldrsx_resolve_scratch bytes, 16-byte
// aligned); out (nstreams, pitch) uint8, outlen (nstreams,) int32, ok
// (nstreams,) uint8; out_cap at most MAX_CAP. Returns a CUDA error code,
// 0 on success.
extern "C" int ldrsx_resolve(const void* tokens, int64_t ld, int ntok,
                             int nstreams, int64_t out_cap, void* scratch,
                             void* out, int64_t pitch, void* outlen,
                             void* ok, void* stream) {
  if (nstreams <= 0) return 0;
  const Scratch l = layout(nstreams, ntok, out_cap);
  if (ntok < 0 || out_cap < 0 || out_cap > MAX_CAP || l.ntiles > 65535 ||
      (reinterpret_cast<uintptr_t>(scratch) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ntiles = static_cast<int>(l.ntiles);
  const int nwin = static_cast<int>(l.nwin);
  auto* base = static_cast<uint8_t*>(scratch);
  auto* vals = reinterpret_cast<uint16_t*>(base + l.vals);
  auto* win = reinterpret_cast<int32_t*>(base + l.win);
  auto* sum = reinterpret_cast<int32_t*>(base + l.sums);
  auto* bad = base + l.tile_bad;
  const auto* tok = static_cast<const int32_t*>(tokens);
  auto* len = static_cast<int32_t*>(outlen);
  auto* good = static_cast<uint8_t*>(ok);
  cudaError_t rc;
  if (ntiles > 0) {
    const dim3 grid(nstreams, ntiles);
    tile_sums_kernel<<<grid, SCAN_THREADS, 0, s>>>(tok, ld, ntok, ntiles,
                                                   sum);
    scan_kernel<<<grid, SCAN_THREADS, 0, s>>>(tok, ld, ntok, ntiles, sum,
                                              nwin, win, bad);
  }
  verdict_kernel<<<nstreams, 32, 0, s>>>(sum, bad, ntiles, out_cap, len,
                                         good);
  rc = cudaGetLastError();
  if (rc != cudaSuccess || nwin == 0) return static_cast<int>(rc);
  // as many window warps on an SM as its shared memory holds
  rc = cudaFuncSetAttribute(window_kernel,
                            cudaFuncAttributePreferredSharedMemoryCarveout,
                            cudaSharedmemCarveoutMaxShared);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  window_kernel<<<static_cast<unsigned>(static_cast<int64_t>(nstreams) * nwin),
                  32, 0, s>>>(tok, ld, ntok, nwin, win, len, good, vals);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaFuncSetAttribute(finish_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize, RING);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  finish_kernel<<<nstreams, FIN_THREADS, RING, s>>>(vals, nwin, len, good,
                                                    static_cast<uint8_t*>(out),
                                                    pitch);
  return static_cast<int>(cudaGetLastError());
}
