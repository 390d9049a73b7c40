// Dynamic-Huffman table step on NVIDIA Hopper (sm_90a): per-block
// litlen/offset histograms -> bit-reversed canonical code tables and the
// serialized dynamic block header, one block of threads per histogram.
//
// Replaces the JAX package's host table step (libdeflate_rsx_tpu/native/
// codec.c dyn_tables_c, bound at native/__init__.py dyn_tables_native),
// computing what the JAX package runs while that library does not build:
// its Python builder _build_tables_py (ops/encode_dynamic.py). That
// builder and this kernel give the same tables and header bytes for every
// histogram; the C builder gives other tables. Steps per histogram: +1 in
// the EOB bin; package-merge code lengths limited to 14 bits (litlen) and
// 15 (offsets); a lone used symbol gets a partner of length 1
// (_ensure_complete); canonical codes, bit-reversed; the header: HLIT and
// HDIST trimmed, the code lengths run-length coded into precode symbols
// (_precode_rle), a 7-bit-limited precode by package-merge, HCLEN trimmed
// in RFC 1951's permutation order, all packed LSB-first behind the 3 bits
// BFINAL | BTYPE=10. The plain PyTorch version of this kernel is
// ops/dyn_tables.py's build_tables_plain.
//
// Tie order. The Python package-merge sorts items as (weight, tuple of
// symbols) at every level. Two items of equal weight never have one tuple
// as a proper prefix of the other (every symbol adds weight > 0), so the
// packages, made by pairing neighbours of a sorted list, are already in
// order, and the sorted level is a merge of the leaves, sorted by
// (frequency, symbol), with the packages keyed by (weight, first symbol);
// a leaf and a package never tie on both keys. The kernel keeps only
// (weight, first symbol) per item and each leaf's place per level, and
// counts a symbol's length as the number of levels whose selected prefix
// holds its leaf: the selected items of a level are a prefix, and the
// packages among them select a prefix of the level below.
//
// What bounds it on this card: latency. Its bytes (318 counts in, 318
// table entries and 512 header bytes out per histogram) take well under
// a microsecond at the card's memory rate; the work is a chain of ~45
// dependent levels and a serial run-length and bit-packing pass. What
// the design does about it: every level's merge is done by all threads
// at once (each item finds its place by binary search in the other
// list), so a level costs a few shared-memory round trips; only the
// header pass (at most 318 lengths) runs in one thread; the blocks of a
// batch run side by side, one per SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NUM_LL = 288;
constexpr int NUM_OF = 30;
constexpr int NUM_PRE = 19;
constexpr int HDR_CAP = 512;
constexpr int MAX_SYM = NUM_LL;
constexpr int MAX_ITEMS = 2 * MAX_SYM;
constexpr int MAX_LEVELS = 15;
constexpr int MAX_RLE = NUM_LL + NUM_OF;
constexpr int THREADS = 512;

__constant__ uint8_t kPerm[NUM_PRE] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                       11, 4, 12, 3, 13, 2, 14, 1, 15};

struct Merge {
  unsigned long long lw[MAX_SYM];          // leaves by (frequency, symbol)
  int16_t ls[MAX_SYM];
  unsigned long long w[2][MAX_ITEMS];      // this level and the one below
  int16_t f[2][MAX_ITEMS];                 // first symbol of each item
  uint16_t posl[MAX_LEVELS][MAX_SYM];      // each leaf's place per level
  int cnt[MAX_LEVELS];                     // items per level
  int take[MAX_LEVELS];                    // selected leaves per level
  int n;
};

struct Smem {
  Merge m;
  uint32_t ll_freq[NUM_LL];
  uint32_t of_freq[NUM_OF];
  uint32_t pre_freq[NUM_PRE];
  uint8_t ll_len[NUM_LL];
  uint8_t of_len[NUM_OF];
  uint8_t pre_len[NUM_PRE];
  uint32_t ll_code[NUM_LL];
  uint32_t of_code[NUM_OF];
  uint32_t pre_code[NUM_PRE];
  uint8_t all_len[MAX_RLE];                // HLIT + HDIST lengths
  uint8_t rle_sym[MAX_RLE];
  uint8_t rle_ev[MAX_RLE];
  uint8_t rle_eb[MAX_RLE];
  int n_rle;
  int next_code[MAX_LEVELS + 1];
  uint8_t hdr[HDR_CAP];
  int hdr_bits;
};

// Package-merge code lengths (<= max_len) of freq[0..nsym), as the
// Python length_limited_lengths gives them. Called by every thread.
__device__ void code_lengths(const uint32_t* freq, int nsym, int max_len,
                             uint8_t* lens, Merge& m) {
  const int tid = threadIdx.x;
  for (int i = tid; i < nsym; i += blockDim.x) lens[i] = 0;
  if (tid == 0) m.n = 0;
  __syncthreads();
  for (int i = tid; i < nsym; i += blockDim.x)
    if (freq[i]) atomicAdd(&m.n, 1);
  __syncthreads();
  const int n = m.n;
  if (n <= 1) {
    for (int i = tid; i < nsym; i += blockDim.x)
      if (freq[i]) lens[i] = 1;
    __syncthreads();
    return;
  }
  // leaves sorted by (frequency, symbol): each finds its rank
  for (int i = tid; i < nsym; i += blockDim.x) {
    const uint32_t fi = freq[i];
    if (!fi) continue;
    int r = 0;
    for (int j = 0; j < nsym; ++j) {
      const uint32_t fj = freq[j];
      r += fj && (fj < fi || (fj == fi && j < i));
    }
    m.lw[r] = fi;
    m.ls[r] = static_cast<int16_t>(i);
  }
  __syncthreads();
  for (int t = tid; t < n; t += blockDim.x) {
    m.w[0][t] = m.lw[t];
    m.f[0][t] = m.ls[t];
    m.posl[0][t] = static_cast<uint16_t>(t);
  }
  if (tid == 0) m.cnt[0] = n;
  __syncthreads();
  int cur = 0;
  for (int k = 1; k < max_len; ++k) {
    const int prev = cur;
    cur ^= 1;
    const int np = m.cnt[k - 1] / 2;       // packages of the level below
    const unsigned long long* pw = m.w[prev];
    const int16_t* pf = m.f[prev];
    for (int t = tid; t < n + np; t += blockDim.x) {
      if (t < n) {
        // leaf t goes after the packages that sort before it
        const unsigned long long lw = m.lw[t];
        const int16_t ls = m.ls[t];
        int lo = 0, hi = np;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          const unsigned long long w = pw[2 * mid] + pw[2 * mid + 1];
          if (w < lw || (w == lw && pf[2 * mid] < ls)) lo = mid + 1;
          else hi = mid;
        }
        m.w[cur][t + lo] = lw;
        m.f[cur][t + lo] = ls;
        m.posl[k][t] = static_cast<uint16_t>(t + lo);
      } else {
        // package p goes after the leaves that sort before it (a leaf
        // goes first on equal keys)
        const int p = t - n;
        const unsigned long long w = pw[2 * p] + pw[2 * p + 1];
        const int16_t fs = pf[2 * p];
        int lo = 0, hi = n;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (m.lw[mid] < w || (m.lw[mid] == w && m.ls[mid] <= fs))
            lo = mid + 1;
          else hi = mid;
        }
        m.w[cur][p + lo] = w;
        m.f[cur][p + lo] = fs;
      }
    }
    if (tid == 0) m.cnt[k] = n + np;
    __syncthreads();
  }
  if (tid == 0) {
    // the first 2n-2 items of the top level are selected; the packages
    // among a level's selected prefix select a prefix of the level below
    int c = min(2 * n - 2, m.cnt[max_len - 1]);
    for (int k = max_len - 1; k >= 0; --k) {
      int lo = 0, hi = n;                  // leaves placed before c
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (m.posl[k][mid] < c) lo = mid + 1;
        else hi = mid;
      }
      m.take[k] = lo;
      c = 2 * (c - lo);
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += blockDim.x) {
    int len = 0;
    for (int k = 0; k < max_len; ++k) len += i < m.take[k];
    lens[m.ls[i]] = static_cast<uint8_t>(len);
  }
  __syncthreads();
}

// A code with one used symbol gets a second symbol of length 1
// (_ensure_complete). Called by every thread.
__device__ void ensure_complete(uint8_t* lens, int nsym, Merge& m) {
  if (threadIdx.x == 0) {
    int used = 0, at = 0;
    for (int i = 0; i < nsym; ++i)
      if (lens[i]) {
        ++used;
        at = i;
      }
    if (used == 1) {
      lens[at == 0 ? 1 : 0] = 1;
      lens[at] = 1;
    }
  }
  __syncthreads();
}

// Canonical codes of lens, bit-reversed for LSB-first emission
// (canonical_codes). Called by every thread.
__device__ void canonical(const uint8_t* lens, int nsym, uint32_t* codes,
                          int* next_code) {
  if (threadIdx.x == 0) {
    int count[MAX_LEVELS + 1] = {0};
    for (int i = 0; i < nsym; ++i) count[lens[i]]++;
    count[0] = 0;
    int code = 0;
    for (int l = 1; l <= MAX_LEVELS; ++l) {
      code = (code + count[l - 1]) << 1;
      next_code[l] = code;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nsym; i += blockDim.x) {
    const int l = lens[i];
    if (!l) {
      codes[i] = 0;
      continue;
    }
    int r = 0;
    for (int j = 0; j < i; ++j) r += lens[j] == l;
    const uint32_t c = static_cast<uint32_t>(next_code[l] + r);
    codes[i] = __brev(c) >> (32 - l);
  }
  __syncthreads();
}

// Run-length coding of the code lengths into precode symbols
// (_precode_rle), in one thread.
__device__ void precode_rle(const uint8_t* lens, int n, Smem& s) {
  int k = 0, i = 0, prev = -1;
  auto put = [&](int sym, int ev, int eb) {
    s.rle_sym[k] = static_cast<uint8_t>(sym);
    s.rle_ev[k] = static_cast<uint8_t>(ev);
    s.rle_eb[k] = static_cast<uint8_t>(eb);
    ++k;
  };
  while (i < n) {
    const int v = lens[i];
    int run = 1;
    while (i + run < n && lens[i + run] == v) ++run;
    int r = run;
    if (v == 0) {
      while (r >= 11) {
        const int take = min(r, 138);
        put(18, take - 11, 7);
        r -= take;
      }
      while (r >= 3) {
        const int take = min(r, 10);
        put(17, take - 3, 3);
        r -= take;
      }
      for (; r > 0; --r) put(0, 0, 0);
    } else {
      if (v != prev) {
        put(v, 0, 0);
        --r;
      }
      while (r >= 3) {
        const int take = min(r, 6);
        put(16, take - 3, 2);
        r -= take;
      }
      for (; r > 0; --r) put(v, 0, 0);
    }
    prev = v;
    i += run;
  }
  s.n_rle = k;
}

// LSB-first bit writer into the shared header buffer, in one thread.
struct BitWriter {
  uint8_t* buf;
  int bits;
  __device__ void put(uint32_t value, int nbits) {
    for (int b = 0; b < nbits; ++b, ++bits)
      if (((value >> b) & 1u) && (bits >> 3) < HDR_CAP)
        buf[bits >> 3] |= static_cast<uint8_t>(1u << (bits & 7));
  }
};

__global__ void __launch_bounds__(THREADS)
dyn_tables_kernel(const int32_t* __restrict__ ll_hist,
                  const int32_t* __restrict__ of_hist,
                  const uint8_t* __restrict__ finals,
                  int32_t* __restrict__ ll_tab, int32_t* __restrict__ of_tab,
                  uint8_t* __restrict__ hdr, int32_t* __restrict__ hdr_bits) {
  __shared__ Smem s;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < NUM_LL; i += blockDim.x)
    s.ll_freq[i] = static_cast<uint32_t>(ll_hist[b * NUM_LL + i]) + (i == 256);
  for (int i = tid; i < NUM_OF; i += blockDim.x)
    s.of_freq[i] = static_cast<uint32_t>(of_hist[b * NUM_OF + i]);
  for (int i = tid; i < HDR_CAP; i += blockDim.x) s.hdr[i] = 0;
  __syncthreads();

  code_lengths(s.ll_freq, NUM_LL, 14, s.ll_len, s.m);
  code_lengths(s.of_freq, NUM_OF, 15, s.of_len, s.m);
  ensure_complete(s.ll_len, NUM_LL, s.m);
  ensure_complete(s.of_len, NUM_OF, s.m);
  canonical(s.ll_len, NUM_LL, s.ll_code, s.next_code);
  canonical(s.of_len, NUM_OF, s.of_code, s.next_code);
  for (int i = tid; i < NUM_LL; i += blockDim.x)
    ll_tab[b * NUM_LL + i] =
        static_cast<int32_t>(s.ll_code[i] | (uint32_t(s.ll_len[i]) << 16));
  for (int i = tid; i < NUM_OF; i += blockDim.x)
    of_tab[b * NUM_OF + i] =
        static_cast<int32_t>(s.of_code[i] | (uint32_t(s.of_len[i]) << 16));

  // the header: HLIT/HDIST trimming and the lengths' run-length coding
  __shared__ int num_ll, num_of;
  if (tid == 0) {
    int last = 0;
    for (int i = 0; i < NUM_LL; ++i)
      if (s.ll_len[i]) last = i;
    num_ll = max(257, last + 1);
    int lo = 0;
    for (int i = 0; i < NUM_OF; ++i)
      if (s.of_len[i]) lo = i + 1;
    num_of = max(1, lo);
    for (int i = 0; i < num_ll; ++i) s.all_len[i] = s.ll_len[i];
    for (int i = 0; i < num_of; ++i) s.all_len[num_ll + i] = s.of_len[i];
    precode_rle(s.all_len, num_ll + num_of, s);
    for (int i = 0; i < NUM_PRE; ++i) s.pre_freq[i] = 0;
    for (int i = 0; i < s.n_rle; ++i) s.pre_freq[s.rle_sym[i]]++;
  }
  __syncthreads();
  code_lengths(s.pre_freq, NUM_PRE, 7, s.pre_len, s.m);
  ensure_complete(s.pre_len, NUM_PRE, s.m);
  canonical(s.pre_len, NUM_PRE, s.pre_code, s.next_code);
  if (tid == 0) {
    int nexp = NUM_PRE;
    while (nexp > 4 && s.pre_len[kPerm[nexp - 1]] == 0) --nexp;
    BitWriter bw{s.hdr, 0};
    bw.put((finals[b] ? 1u : 0u) | 4u, 3);     // BFINAL | BTYPE=10
    bw.put(num_ll - 257, 5);
    bw.put(num_of - 1, 5);
    bw.put(nexp - 4, 4);
    for (int i = 0; i < nexp; ++i) bw.put(s.pre_len[kPerm[i]], 3);
    for (int i = 0; i < s.n_rle; ++i) {
      const int sym = s.rle_sym[i];
      bw.put(s.pre_code[sym], s.pre_len[sym]);
      bw.put(s.rle_ev[i], s.rle_eb[i]);
    }
    s.hdr_bits = bw.bits;
    hdr_bits[b] = bw.bits;
  }
  __syncthreads();
  for (int i = tid; i < HDR_CAP; i += blockDim.x)
    hdr[static_cast<int64_t>(b) * HDR_CAP + i] = s.hdr[i];
}

}  // namespace

// Plain C entry point (bound with ctypes). ll_hist (n, 288) and of_hist
// (n, 30) int32 counts, finals (n,) uint8; ll_tab (n, 288) and of_tab
// (n, 30) int32 entries code | len << 16, hdr (n, 512) uint8 and
// hdr_bits (n,) int32, every element of which the kernel writes. Launches
// on `stream` and returns the launch's CUDA error as an int (0 on
// success). No synchronisation.
extern "C" int ldrsx_dyn_tables(const void* ll_hist, const void* of_hist,
                                const void* finals, int n, void* ll_tab,
                                void* of_tab, void* hdr, void* hdr_bits,
                                void* stream) {
  if (n <= 0) return 0;
  dyn_tables_kernel<<<n, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ll_hist),
      static_cast<const int32_t*>(of_hist),
      static_cast<const uint8_t*>(finals), static_cast<int32_t*>(ll_tab),
      static_cast<int32_t*>(of_tab), static_cast<uint8_t*>(hdr),
      static_cast<int32_t*>(hdr_bits));
  return static_cast<int>(cudaGetLastError());
}
