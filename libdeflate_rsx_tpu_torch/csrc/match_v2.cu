// L1-5 match finder on NVIDIA Hopper (sm_90a): (ml, dist) for every position
// of a batch of blocks, one thread block cluster per window of a block, the
// window's sort in the cluster's shared memory.
//
// Replaces the JAX package's XLA graph libdeflate_rsx_tpu/ops/encode_v2.py:73
// find_matches_v2 (no Pallas kernel) and computes what its plain PyTorch
// version, ops/encode_v2.py find_matches_v2_plain, computes, for every
// position p < s of a block (positions past valid_len included):
// - q is p's predecessor in the stable sort of the block's positions by
//   w0, the little-endian word of bytes p..p+3 (the nearest earlier
//   position with the same word); the first position of the sorted order
//   has none;
// - where q exists and p - q <= 32,768: dist = p - q and ml = 4 plus the
//   equal low bytes of w1(p) ^ w1(q) (w1: the word of bytes p+4..p+7), 8
//   when they are equal; elsewhere both are 0. Only the nearest copy
//   counts: one 32,769 back gives no match, whatever lies further back;
// - ml = min(ml, clamp(valid_len - p, 0, 8)), then 0 below 4; dist is not
//   zeroed again, so past valid_len a position can keep its dist with ml 0.
// The words read the block's padding as it is (not as zeros).
//
// The TPU form is a whole-block stable sort carrying the next word, then a
// second sort by position in place of a scatter. Here:
// - a window of at most 65,536 positions is one cluster's work: a block of
//   up to 65,536 bytes is one window; a longer block is cut into windows
//   whose outputs are 32,768 positions [o, o + 32,768), each window taking
//   the 32,768 positions before o as well (from max(0, o - 32,768)), so
//   that p's predecessor within 32,768 bytes, when there is one, lies in
//   the window, and none does when the nearest copy is further back: the
//   window's answer is the block's;
// - the window's positions are sorted stably by the 4 bytes of their word
//   (an LSD radix sort, each pass reading its digit from the window's bytes
//   in shared memory; a pass whose digit is the same for every element is
//   skipped, so a block of one repeated byte sorts in no pass);
// - one sweep: each element of the sorted list compares its word with its
//   neighbour's below it, takes ml from the two w1 words in shared memory,
//   applies the cap and stores (ml << 16 | dist) by position into the other
//   list's memory; each block then writes its share of positions out.
//
// The layout on this card: a cluster of 4 thread blocks of 1,024 threads
// (one block per SM) holds one window, persistent over the windows. A TMA
// bulk copy multicast to the cluster puts the window's bytes in every
// block's shared memory; the two lists and the (ml, dist) words are spread
// over the blocks in equal chunks (16,384 elements a block at 65,536
// positions) and read and written through distributed shared memory
// (ld/st.shared::cluster). A radix pass (the code of csrc/match_l6.cu's
// base sort, kept as a copy here): each warp ranks its contiguous share by
// digit with __match_any_sync into 16-bit per-warp counts, a warp scan per
// digit turns them into offsets, the block puts its share in digit order
// in place, the blocks exchange their digit totals over the cluster, and
// each block copies its share out in order, each digit's run to
// consecutive slots. So no element goes through device memory: the kernel
// moves the block rows in and int64 (ml, dist) out, which is its bound.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 4;                  // blocks a window
constexpr int kWindowMax = 65536;            // positions a cluster sorts
constexpr int kSegment = 32768;              // outputs of a longer block's window
constexpr int kReach = 32768;                // WINDOW_SIZE
constexpr int kSteps = kWindowMax / kCluster / kThreads;  // elements a thread
constexpr int kMaxVecMl = 8;
constexpr int kRowPad = 24;                  // bytes a row holds past s at least

__device__ __forceinline__ uint32_t lanemask_lt() {
  uint32_t m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

extern __shared__ __align__(16) unsigned char smem[];

// Loads and stores in a block's shared memory or another block's of the
// cluster, by a 32-bit shared::cluster address.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t r) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(a), "r"(r));
  return a;
}
__device__ __forceinline__ uint32_t ld_cluster(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void st_cluster(uint32_t a, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}

// A list spread over the cluster: element i lives in block i / chunk, at
// i % chunk of the array at byte `off` of that block's shared memory.
struct Spread {
  uint32_t off, chunk;
  uint32_t magic;                 // ceil(2^32 / chunk): i / chunk exactly
                                  // for i * chunk < 2^32

  __device__ void set(uint32_t at, uint32_t count, uint32_t nblocks) {
    off = at;
    chunk = max((count + nblocks - 1) / nblocks, 2u);
    magic = static_cast<uint32_t>(((uint64_t{1} << 32) + chunk - 1) / chunk);
  }
  __device__ uint32_t* local() const {
    return reinterpret_cast<uint32_t*>(smem + off);
  }
  __device__ uint32_t get(uint32_t i) const {
    const uint32_t r = __umulhi(i, magic), at = i - r * chunk;
    if (r == cg::this_cluster().block_rank()) return local()[at];
    return ld_cluster(cluster_addr(local() + at, r));
  }
  __device__ void put(uint32_t i, uint32_t v) const {
    const uint32_t r = __umulhi(i, magic), at = i - r * chunk;
    if (r == cg::this_cluster().block_rank())
      local()[at] = v;
    else
      st_cluster(cluster_addr(local() + at, r), v);
  }
  // this block's share [lo, lo + len) of a list of count elements
  __device__ void share(uint32_t count, uint32_t& lo, uint32_t& len) const {
    lo = min(cg::this_cluster().block_rank() * chunk, count);
    len = min(count - lo, chunk);
  }
};

// The window's bytes, byte p at `at` + p of the block's shared memory
// (at 16-byte aligned less the row's misalignment).
struct Win {
  int at;
  __device__ uint32_t byte(uint32_t p) const { return smem[at + p]; }
  __device__ uint32_t word(uint32_t p) const {
    const int a = at + static_cast<int>(p);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(smem) + (a >> 2);
    return __funnelshift_r(w[0], w[1], (a & 3) * 8);
  }
};

// Dynamic shared memory (smem): the mbarrier at 0, the small arrays at
// fixed offsets, then the two lists and the window (Layout).
constexpr int kHistOff = 16;                 // 2 x 256: a pass's digit totals
constexpr int kOffOff = kHistOff + 2048;     // 256: a pass's first slots
constexpr int kLstOff = kOffOff + 1024;      // 256: first places in a block
constexpr int kWsOff = kLstOff + 1024;       // 8: the digit scan's warp totals
constexpr int kWcOff = kWsOff + 64;          // per-warp digit counts

__device__ __forceinline__ uint16_t* sm_wc() {
  return reinterpret_cast<uint16_t*>(smem + kWcOff);
}
__device__ __forceinline__ uint32_t* sm_words(int off) {
  return reinterpret_cast<uint32_t*>(smem + off);
}

// Exclusive prefix over the 256 digits, thread d holding digit d's value
// x (the other threads pass 0); every thread calls it.
__device__ __forceinline__ uint32_t digit_scan(uint32_t x, uint32_t* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t v = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  if (warp < 8 && lane == 31) ws[warp] = v;
  __syncthreads();
  uint32_t pre = 0;
  if (warp < 8)
    for (int w = 0; w < warp; ++w) pre += ws[w];
  __syncthreads();
  return pre + v - x;
}

// The stable LSD radix sort of the window's positions 0..count-1 (the
// identity list, not stored before the first pass) by the 4 bytes of their
// word, through the lists a and b; returns which one holds the result (0:
// a). Both are spread with the chunk of count elements. `par` is which
// half of the digit totals the next pass uses (a peer may still read the
// other half).
__device__ __forceinline__ int cluster_sort(Spread a, Spread b, uint32_t count,
                                            const Win& win, int& par) {
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t me = cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t lo, len;
  a.share(count, lo, len);
  const int steps = static_cast<int>((len + kThreads - 1) / kThreads);
  const uint32_t w0 = static_cast<uint32_t>(warp * steps * 32);
  int cur = 0;
  bool ident = true;
  for (int k = 0; k < 4; ++k) {
    const Spread src = cur ? b : a;
    const Spread dst = cur ? a : b;
    uint32_t* hist = sm_words(kHistOff) + 256 * par;
    par ^= 1;
    for (int d = lane; d < 256; d += 32) sm_wc()[d * kWarps + warp] = 0;
    __syncwarp();
    // each warp ranks its share by digit: rk, the element's place among
    // the warp's elements of its digit (two 16-bit places a word)
    uint32_t el[kSteps], rk[(kSteps + 1) / 2];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const uint32_t li = w0 + u * 32 + lane;
      el[u] = 0;
      if (u < steps && li < len) el[u] = ident ? lo + li : src.local()[li];
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      if (u >= steps) break;
      const bool ok = w0 + u * 32 + lane < len;
      const uint32_t d = ok ? win.byte(el[u] + k) : 256 + lane;
      const uint32_t peers = __match_any_sync(0xffffffffu, d);
      const uint32_t below = __popc(peers & lanemask_lt());
      uint16_t* c = sm_wc() + (d & 255) * kWarps + warp;
      const uint32_t r = ok ? *c + below : 0;
      if (u & 1)
        rk[u / 2] |= r << 16;
      else
        rk[u / 2] = r;
      __syncwarp();
      if (ok && below == 0) *c += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // per digit, the warps' counts -> each warp's first place; the block's
    // total of each digit to hist
    for (int q0 = 0; q0 < 8; q0 += 4) {
      uint32_t c[4], x[4];
      uint16_t* w = sm_wc() + (warp * 8 + q0) * kWarps + lane;
#pragma unroll
      for (int q = 0; q < 4; ++q) x[q] = c[q] = w[q * kWarps];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t y = __shfl_up_sync(0xffffffffu, x[q], o);
          if (lane >= o) x[q] += y;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        w[q * kWarps] = static_cast<uint16_t>(x[q] - c[q]);
        if (lane == 31) hist[warp * 8 + q0 + q] = x[q];
      }
    }
    __syncthreads();
    const uint32_t first =
        digit_scan(threadIdx.x < 256 ? hist[threadIdx.x] : 0, sm_words(kWsOff));
    if (threadIdx.x < 256) sm_words(kLstOff)[threadIdx.x] = first;
    __syncthreads();
    // the block's share in digit order, in place
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const uint32_t li = w0 + u * 32 + lane;
      if (u < steps && li < len) {
        const uint32_t d = win.byte(el[u] + k);
        src.local()[sm_words(kLstOff)[d] + sm_wc()[d * kWarps + warp] +
                    (rk[u / 2] >> (16 * (u & 1)) & 0xFFFF)] = el[u];
      }
    }
    ident = false;
    cluster.sync();
    // each digit's first slot: the digits below it in the whole list, and
    // this digit in the blocks ranked below this one
    uint32_t tot = 0, before = 0;
    if (threadIdx.x < 256) {
#pragma unroll
      for (int r = 0; r < kCluster; ++r) {
        const uint32_t h = ld_cluster(cluster_addr(hist + threadIdx.x, r));
        tot += h;
        if (r < static_cast<int>(me)) before += h;
      }
    }
    const uint32_t slot0 = digit_scan(tot, sm_words(kWsOff));
    if (threadIdx.x < 256) sm_words(kOffOff)[threadIdx.x] = slot0 + before;
    // a digit that every element has: the pass keeps the order
    if (__syncthreads_or(threadIdx.x < 256 && tot == count)) continue;
    for (uint32_t li = threadIdx.x; li < len; li += kThreads) {
      const uint32_t e = src.local()[li], d = win.byte(e + k);
      dst.put(sm_words(kOffOff)[d] + li - sm_words(kLstOff)[d], e);
    }
    cluster.sync();
    cur ^= 1;
  }
  return cur;
}

__device__ __forceinline__ void wait_window(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (int tries = 0; !done; ++tries) {
    if (tries > (1 << 24)) __trap();     // the copy never landed: fail
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__host__ __device__ inline int up16(long long v) {
  return static_cast<int>((v + 15) & ~15ll);
}

// Windows of a block of s positions, and window k's outputs [o, e) and
// first position w: one window [0, s) up to kWindowMax, else windows of
// kSegment outputs, each with the kReach positions before them.
__host__ __device__ inline long long windows_of(int s) {
  return s <= kWindowMax ? 1 : (s + kSegment - 1) / kSegment;
}
__host__ __device__ inline int window_positions(int s) {
  return s < kWindowMax ? s : kWindowMax;
}

struct Layout {                   // byte offsets in dynamic shared memory
  int x0, x1, win, total;
};

__host__ __device__ inline Layout layout(int s) {
  const long long n = window_positions(s);
  long long chunk = (n + kCluster - 1) / kCluster;
  if (chunk < 2) chunk = 2;
  Layout l;
  l.x0 = kWcOff + up16(256ll * kWarps * 2);
  l.x1 = l.x0 + up16(chunk * 4);
  l.win = l.x1 + up16(chunk * 4);
  l.total = l.win + up16(n + 48);
  return l;
}

__global__ void __launch_bounds__(kThreads, 1)
    match_v2_kernel(const uint8_t* __restrict__ data, int rows, int stride,
                    int s, const int32_t* __restrict__ valid,
                    int64_t* out_ml, int64_t* out_dist) {
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t me = cluster.block_rank();
  const long long clusters = gridDim.x / kCluster, cid = blockIdx.x / kCluster;
  const long long per_row = windows_of(s), windows = per_row * rows;
  const Layout lay = layout(s);
  const uint32_t bar = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  int par = 0;

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  uint32_t it = 0;
  for (long long w = cid; w < windows; w += clusters, ++it) {
    const int row = static_cast<int>(w / per_row);
    const int seg = static_cast<int>(w - static_cast<long long>(row) * per_row);
    const int o = per_row == 1 ? 0 : seg * kSegment;
    const int e = per_row == 1 ? s : min(s, o + kSegment);
    const int first = max(0, o - (per_row == 1 ? 0 : kReach));
    const uint32_t n = static_cast<uint32_t>(e - first);
    const int vl = valid[row];
    // the window's bytes and the 7 after it into every block: one TMA copy
    // multicast to the cluster, from the 16-byte aligned address at or
    // below them
    const uint8_t* src = data + static_cast<size_t>(row) * stride + first;
    const int off = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
    const uint32_t bytes = static_cast<uint32_t>(up16(off + n + 8));
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (threadIdx.x == 0)
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
          "r"(bytes)
          : "memory");
    cluster.sync();               // every block's barrier armed, last window read
    if (me == 0 && threadIdx.x == 0) {
      const uint16_t mask = static_cast<uint16_t>((1u << kCluster) - 1);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(
              static_cast<uint32_t>(__cvta_generic_to_shared(smem + lay.win))),
          "l"(src - off), "r"(bytes), "r"(bar), "h"(mask)
          : "memory");
    }
    wait_window(bar, it & 1);
    const Win win{lay.win + off};

    Spread a, b;
    a.set(lay.x0, n, kCluster);
    b.set(lay.x1, n, kCluster);
    const int pc = cluster_sort(a, b, n, win, par);
    const Spread P = pc ? b : a;
    const Spread best = pc ? a : b;

    // the sweep: each sorted element against its neighbour below
    uint32_t lo, len;
    P.share(n, lo, len);
    for (uint32_t li = threadIdx.x; li < len; li += kThreads) {
      const uint32_t i = lo + li, p = P.local()[li];
      uint32_t v = 0;
      if (i > 0) {
        const uint32_t q = li > 0 ? P.local()[li - 1] : P.get(i - 1);
        if (win.word(p) == win.word(q) && p - q <= kReach) {
          const uint32_t x = win.word(p + 4) ^ win.word(q + 4);
          int ml = x == 0 ? kMaxVecMl : 4 + ((__ffs(x) - 1) >> 3);
          const int cap = min(max(vl - first - static_cast<int>(p), 0), kMaxVecMl);
          ml = min(ml, cap);
          if (ml < 4) ml = 0;
          v = static_cast<uint32_t>(ml) << 16 | (p - q);
        }
      }
      best.put(p, v);
    }
    cluster.sync();
    // this block's share of positions out, those of the window's outputs
    best.share(n, lo, len);
    const size_t at = static_cast<size_t>(row) * s + first;
    for (uint32_t li = threadIdx.x; li < len; li += kThreads) {
      const uint32_t p = lo + li;
      if (first + static_cast<int>(p) < o) continue;
      const uint32_t v = best.local()[li];
      out_ml[at + p] = v >> 16;
      out_dist[at + p] = v & 0xFFFF;
    }
  }
  cluster.sync();                 // no block leaves while others read it
}

cudaError_t configure(int s, int& bytes, int& clusters) {
  int dev = 0, optin = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&optin,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc != cudaSuccess) return rc;
  bytes = layout(s).total;
  if (bytes > optin) return cudaErrorInvalidValue;
  rc = cudaFuncSetAttribute(match_v2_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return rc;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = cudaOccupancyMaxActiveClusters(&clusters, match_v2_kernel, &cfg);
  if (rc == cudaSuccess && clusters <= 0) rc = cudaErrorInvalidConfiguration;
  return rc;
}

bool takes(int s) { return s >= 1 && s <= (1 << 30); }

}  // namespace

// The launch shape at block size s: the cluster size, the dynamic shared
// memory of a block and the clusters resident on the card at once (the
// kernel's persistent clusters, at most one per window). Returns a CUDA
// error code (0: the kernel takes such blocks).
extern "C" int ldrsx_match_v2_shape(int s, int* cluster_size, int* shared,
                                    int* clusters) {
  int bytes = 0, c = 0;
  if (!takes(s)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t rc = configure(s, bytes, c);
  *cluster_size = kCluster;
  *shared = bytes;
  *clusters = c;
  return static_cast<int>(rc);
}

// (ml, dist) int64 (rows, s) of rows blocks of `stride` bytes (stride >=
// s + 24: the words past the block and the aligned copy read into the
// padding), valid int32 (rows,). Returns a CUDA error code (0: launched).
extern "C" int ldrsx_match_v2(const void* data, int rows, int stride, int s,
                              const void* valid, void* ml, void* dist,
                              void* stream) {
  if (rows <= 0) return 0;
  if (!takes(s) || stride < s + kRowPad)
    return static_cast<int>(cudaErrorInvalidValue);
  int bytes = 0, clusters = 0;
  cudaError_t rc = configure(s, bytes, clusters);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long windows = windows_of(s) * rows;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(kCluster * static_cast<unsigned>(
                                    clusters < windows ? clusters : windows),
                     1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = cudaLaunchKernelEx(&cfg, match_v2_kernel,
                          static_cast<const uint8_t*>(data), rows, stride, s,
                          static_cast<const int32_t*>(valid),
                          static_cast<int64_t*>(ml),
                          static_cast<int64_t*>(dist));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}
