// Keypoint selection over a batch of response maps, fp32 [N, H, W]: per tile
// the exact count of owned pixels above the threshold, and K slots of
// (y, x, score, valid) holding the owned 3x3-NMS survivors above the
// threshold in lax.top_k's order (score descending, then flat index
// ascending), filled with the smallest flat indices that are not
// candidates.  Bit for bit core/nms.py::select_keypoints, its plain twin.
//
// Replaces no Pallas kernel: the reference selects with two
// lax.reduce_window passes, masks and lax.top_k (repro/core/nms.py), which
// the port ran as torch ops: two max-pools, about ten elementwise passes, the
// ownership and count passes and a stable sort of every pixel of every tile,
// ~40 GB of traffic per 256 tiles of 560^2.  The answer needs one read of
// the owned pixels and a two-pixel ring, ~245 MB there.
//
// Bound on Hopper: bytes (the map read once; a few compares a pixel).
// Design:
//   - pass A (difet_select_scan) streams the map: one warp walks 64 owned
//     rows of 28 owned columns of one tile, with the two-pixel ring (values
//     outside the tile are -inf, the max-pool's padding), in registers
//     and shuffles; it flags the pixels at the max of their 3x3 window,
//     keeps a pixel at its window's max that no smaller flat index of its
//     window also is at the max of its own (the twin's tie-break), counts
//     the dense map above the threshold and compacts the candidates into
//     per-tile scratch as unique 64-bit keys (orderable score bits high,
//     the flat index reversed low) through the tile's atomic cursor, once
//     per 128 keys a warp.  A padding tile, and the halo beyond the ring,
//     are never read;
//   - pass B (difet_select_topk), one block a tile: with more than K
//     candidates a most-significant-digit radix select (12-bit digits,
//     shared-memory histograms) finds the K-th largest key; the keys at or
//     above it (exactly K, keys being unique) are sorted by a bitonic
//     network in shared memory up to SORT_CAP keys and in the tile's
//     scratch above it; then the fill slots;
//   - keys are unique, so the result does not depend on the atomics' order.
// The scratch holds every candidate: with a threshold >= 0 only survivors
// pass, and survivors never touch (at most ceil(h/2) ceil(w/2) in h x w
// owned pixels); otherwise every owned pixel may.  The wrapper sizes it.
#include "common.cuh"

#include <limits.h>

namespace {

constexpr int A_THREADS = 256;
constexpr int BH = 64;                     // owned rows a pass-A warp walks
constexpr int SEG = 28;                    // owned columns a pass-A warp holds
constexpr int KBW = 128;                   // keys a warp buffers

constexpr int B_THREADS = 512;
constexpr int SORT_CAP = 4096;             // keys sorted in shared memory
constexpr int DIGIT = 12;                  // radix-select digit bits
static_assert((1 << DIGIT) * sizeof(int) <= SORT_CAP * sizeof(unsigned long long),
              "the histogram shares the sort buffer");

typedef unsigned long long u64;

// The key of a candidate: its score's bits made orderable as unsigned (a
// -0.0 ranks as +0.0, as torch's sort compares them, and is remembered in
// bit 0), then the flat index reversed, so that a larger key is a higher
// score or, at equal scores, a smaller index.  Flat indices are < 2^31.
__device__ __forceinline__ u64 make_key(float v, int idx) {
  unsigned b = __float_as_uint(v);
  const unsigned neg0 = b == 0x80000000u;
  if (neg0) b = 0u;
  const unsigned ord = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  const unsigned lo = (static_cast<unsigned>(0x7fffffff - idx) << 1) | neg0;
  return (static_cast<u64>(ord) << 32) | lo;
}

__device__ __forceinline__ int key_index(u64 key) {
  return 0x7fffffff - static_cast<int>(static_cast<unsigned>(key) >> 1);
}

__device__ __forceinline__ float key_score(u64 key) {
  const unsigned ord = static_cast<unsigned>(key >> 32);
  unsigned b = (ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord;
  if (key & 1u) b = 0x80000000u;
  return __uint_as_float(b);
}

// Exclusive prefix sum of v over the block (blockDim.x a multiple of 32);
// *total gets the block's sum.  Every thread calls it.
__device__ int block_exclusive_sum(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < warps) warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = warp == 0 ? 0 : warp_sums[warp - 1];
  *total = warp_sums[warps - 1];
  __syncthreads();   // warp_sums free for the next call
  return before + x - v;
}

// ---- pass A ------------------------------------------------------------------
// Each warp walks BH owned rows of SEG owned columns of one tile, top to
// bottom.  Lane l holds column x0 - 2 + l of the rows y - 1 .. y + 2 in
// registers (loaded two rows ahead); the max of a row's three columns comes
// from its neighbours by shuffles (NaN if any is NaN: x >= it is then false,
// as x >= max_pool(x) is), a row's at-max flags make one ballot, and the
// tie-break reads the ballots of this row and the one above as bit masks.
// Lanes 1 .. 30 flag at-max, lanes 2 .. 29 own a column.  A warp buffers
// its candidates' keys in shared memory and writes them out KBW at most at
// a time, at an offset it takes from the tile's cursor.
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float row_max3(float v) {
  const float l = __shfl_up_sync(0xffffffffu, v, 1);
  const float r = __shfl_down_sync(0xffffffffu, v, 1);
  return max_nan(max_nan(l, v), r);
}

__global__ void __launch_bounds__(A_THREADS)
difet_select_scan(const float* __restrict__ resp,
                  const int* __restrict__ headers, int hstride, int h, int w,
                  int halo, float thr, int bands, int segs, long long warps,
                  long long cap, u64* __restrict__ keys,
                  int* __restrict__ count, int* __restrict__ cursor) {
  __shared__ u64 held_keys[A_THREADS / 32][KBW];
  const int lane = threadIdx.x & 31;
  u64* buf = held_keys[threadIdx.x >> 5];
  const long long g =
      static_cast<long long>(blockIdx.x) * (A_THREADS / 32) + (threadIdx.x >> 5);
  if (g >= warps) return;
  const long long per_tile = static_cast<long long>(bands) * segs;
  const long long tile = g / per_tile;
  const int rem = static_cast<int>(g - tile * per_tile);
  const int band = rem / segs, seg = rem - band * segs;
  const int* hd = headers + tile * hstride;
  if (hd[5] != 0) return;                  // a padding tile owns nothing
  const int o0 = max(halo, 0);
  const int oy1 = static_cast<int>(min(static_cast<long long>(h),
                                       static_cast<long long>(halo) + hd[3]));
  const int ox1 = static_cast<int>(min(static_cast<long long>(w),
                                       static_cast<long long>(halo) + hd[4]));
  const int r0 = o0 + band * BH, r1 = min(r0 + BH, oy1);
  const int x0 = o0 + seg * SEG, c1 = min(x0 + SEG, ox1);
  if (r0 >= r1 || x0 >= c1) return;        // the warp owns no pixel

  // values of rows [r0 - 2, r1 + 1) and columns [x0 - 2, c1 + 2) of the
  // tile are read; -inf elsewhere
  const int x = x0 - 2 + lane;
  const bool col_read = x >= 0 && x < w && x < c1 + 2;
  const int ylo = max(r0 - 2, 0), yhi = min(r1 + 1, h);
  const float* img = resp + tile * h * static_cast<long long>(w);
  auto load = [&](int y) {
    return col_read && y >= ylo && y < yhi
               ? __ldg(img + static_cast<long long>(y) * w + x)
               : __uint_as_float(0xff800000u);   // -inf
  };
  const bool flag_col = lane >= 1 && lane <= 30 && x >= 0 && x < w;
  const bool own_col = lane >= 2 && lane <= 29 && x < c1;
  u64* dst = keys + tile * cap;
  int held = 0, dense = 0;
  auto flush = [&]() {
    int base = 0;
    if (lane == 0) base = atomicAdd(cursor + tile, held);
    base = __shfl_sync(0xffffffffu, base, 0);
    for (int j = lane; j < held; j += 32) {
      const long long p = static_cast<long long>(base) + j;
      if (p < cap) dst[p] = buf[j];
    }
    __syncwarp();
    held = 0;
  };

  float ha = row_max3(load(r0 - 2));       // row y - 1
  float vb = load(r0 - 1), hb = row_max3(vb);   // row y
  float vc = load(r0), vd = load(r0 + 1);  // rows y + 1, y + 2
  unsigned above = 0;                      // at-max ballot of row y - 1
  for (int y = r0 - 1; y < r1; ++y) {
    const float ve = load(y + 3);
    const float hc = row_max3(vc);
    const unsigned at = __ballot_sync(
        0xffffffffu, flag_col && y >= 0 && vb >= ha && vb >= hb && vb >= hc);
    if (y >= r0) {
      // kept: at its window's max, and no smaller flat index of the
      // window (the row above, the pixel to the left) at its own
      const unsigned keep =
          at & ~(at << 1) & ~above & ~(above << 1) & ~(above >> 1);
      dense += own_col && vb > thr;
      const float v = (keep >> lane & 1u) ? vb : 0.f;
      const bool cand = own_col && v > thr;
      const unsigned cands = __ballot_sync(0xffffffffu, cand);
      if (cands) {
        if (held + __popc(cands) > KBW) flush();
        if (cand)
          buf[held + __popc(cands & ((1u << lane) - 1u))] =
              make_key(v, y * w + x);
        held += __popc(cands);
        __syncwarp();
      }
    }
    above = at;
    vb = vc; vc = vd; vd = ve;
    ha = hb; hb = hc;
  }
  if (held) flush();
  dense = __reduce_add_sync(0xffffffffu, dense);
  if (lane == 0 && dense) atomicAdd(count + tile, dense);
}

// ---- pass B ------------------------------------------------------------------
// Sorts v[0, n) descending: a bitonic network whose comparators all put the
// larger key at the lower index (each stage opens with a mirrored merge),
// over n padded to a power of two by keys below every real one that are
// never stored: a comparator that reaches one leaves both in place.
__device__ void bitonic_desc(u64* v, int n) {
  int p = 1;
  while (p < n) p <<= 1;
  for (int size = 2; size <= p; size <<= 1) {
    const int half = size >> 1;
    for (int i = threadIdx.x; i < p / 2; i += blockDim.x) {
      const int blk = i / half, off = i - blk * half;
      const int a = blk * size + off, b = blk * size + size - 1 - off;
      if (b < n) {
        const u64 x = v[a], y = v[b];
        if (x < y) { v[a] = y; v[b] = x; }
      }
    }
    __syncthreads();
    for (int stride = size >> 2; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < p / 2; i += blockDim.x) {
        const int blk = i / stride, off = i - blk * stride;
        const int a = 2 * blk * stride + off, b = a + stride;
        if (b < n) {
          const u64 x = v[a], y = v[b];
          if (x < y) { v[a] = y; v[b] = x; }
        }
      }
      __syncthreads();
    }
  }
}

struct Pick {
  int bin, need, count;
};

// The K-th largest of the c unique keys tk[0, c), k < c: a most-significant-
// digit radix select.  Each round histograms the next digit of the keys
// that share the digits chosen so far, and keeps the bin that holds the
// rank still needed; it ends when that bin holds exactly the keys still
// needed, so that the keys >= the returned value are exactly k.
__device__ u64 kth_key(const u64* __restrict__ tk, int c, int k, int* hist,
                       int* warp_sums, Pick* pick) {
  u64 prefix = 0;
  int need = k, shift = 64;
  for (;;) {
    const int bits = shift < DIGIT ? shift : DIGIT;
    shift -= bits;
    const int bins = 1 << bits;
    const u64 hi = shift + bits == 64 ? 0ull : ~0ull << (shift + bits);
    for (int i = threadIdx.x; i < bins; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < c; i += blockDim.x) {
      const u64 key = tk[i];
      if ((key & hi) == prefix)
        atomicAdd(hist + static_cast<int>((key >> shift) & (bins - 1)), 1);
    }
    __syncthreads();
    // thread t sums the bins [top - per, top) counted from the highest;
    // the thread whose run reaches the rank walks it down
    const int per = (bins + blockDim.x - 1) / blockDim.x;
    const int top = bins - threadIdx.x * per;
    const int bottom = max(top - per, 0);
    int mine = 0;
    for (int b = top - 1; b >= bottom; --b) mine += hist[b];
    int all;
    const int above = block_exclusive_sum(mine, warp_sums, &all);
    if (above < need && need <= above + mine) {
      int acc = above;
      for (int b = top - 1; b >= bottom; --b) {
        if (acc + hist[b] >= need) {
          pick->bin = b;
          pick->need = need - acc;
          pick->count = hist[b];
          break;
        }
        acc += hist[b];
      }
    }
    __syncthreads();
    prefix |= static_cast<u64>(pick->bin) << shift;
    need = pick->need;
    const bool done = pick->count == need || shift == 0;
    __syncthreads();   // hist and pick are rewritten by the next round
    if (done) return prefix;
  }
}

__global__ void __launch_bounds__(B_THREADS)
difet_select_topk(u64* __restrict__ keys, const int* __restrict__ cursor,
                  long long cap, int w, int k, int* __restrict__ ys,
                  int* __restrict__ xs, float* __restrict__ scores,
                  unsigned char* __restrict__ valid) {
  __shared__ u64 buf[SORT_CAP];
  __shared__ int warp_sums[32];
  __shared__ Pick pick;
  __shared__ int s_n, s_min;

  const long long tile = blockIdx.x;
  u64* tk = keys + tile * cap;
  const int c = static_cast<int>(min(static_cast<long long>(cursor[tile]), cap));
  const int n = min(c, k);
  u64* v = n <= SORT_CAP ? buf : tk;
  if (threadIdx.x == 0) {
    s_n = 0;
    s_min = INT_MAX;
  }
  if (c > k) {
    const u64 t = kth_key(tk, c, k, reinterpret_cast<int*>(buf), warp_sums,
                          &pick);
    if (v == buf) {
      for (int i = threadIdx.x; i < c; i += blockDim.x) {
        const u64 key = tk[i];
        if (key >= t) buf[atomicAdd(&s_n, 1)] = key;
      }
    } else {
      // in place, in order: a chunk is read whole before any of it is
      // written, and writes land at or below the positions read
      int base = 0;
      for (int s0 = 0; s0 < c; s0 += blockDim.x) {
        const int i = s0 + threadIdx.x;
        const u64 key = i < c ? tk[i] : 0ull;
        const int f = i < c && key >= t;
        int taken;
        const int off = block_exclusive_sum(f, warp_sums, &taken);
        if (f) tk[base + off] = key;
        base += taken;
      }
    }
  } else if (v == buf) {
    for (int i = threadIdx.x; i < c; i += blockDim.x) buf[i] = tk[i];
  }
  __syncthreads();
  bitonic_desc(v, n);

  const long long row = tile * k;
  int lowest = INT_MAX;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const u64 key = v[j];
    const int idx = key_index(key);
    const float sc = key_score(key);
    const bool fin = isfinite(sc);
    ys[row + j] = idx / w;
    xs[row + j] = idx - (idx / w) * w;
    scores[row + j] = fin ? sc : 0.f;
    valid[row + j] = fin;
    lowest = min(lowest, idx);
  }
  if (n == k) return;

  // fill slots: the non-candidates in ascending flat index; where every
  // candidate lies at or above the slots' count, that is 0, 1, 2, ...
  lowest = __reduce_min_sync(0xffffffffu, lowest);
  if ((threadIdx.x & 31) == 0) atomicMin(&s_min, lowest);
  __syncthreads();
  const int nf = k - n;
  if (nf <= s_min) {
    for (int r = threadIdx.x; r < nf; r += blockDim.x) {
      ys[row + n + r] = r / w;
      xs[row + n + r] = r - (r / w) * w;
      scores[row + n + r] = 0.f;
      valid[row + n + r] = 0;
    }
    return;
  }
  // else the candidates by ascending index (a larger key, a smaller
  // index); the non-candidate of rank r is r + #{j : idx_j - j <= r}
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    v[j] = 0x80000000ull - static_cast<unsigned>(key_index(v[j]));
  __syncthreads();
  bitonic_desc(v, n);
  for (int r = threadIdx.x; r < nf; r += blockDim.x) {
    int lo = 0, hi = n;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const int g = static_cast<int>(0x80000000ull - v[mid]) - mid;
      if (g <= r) lo = mid + 1; else hi = mid;
    }
    const int idx = r + lo;
    ys[row + n + r] = idx / w;
    xs[row + n + r] = idx - (idx / w) * w;
    scores[row + n + r] = 0.f;
    valid[row + n + r] = 0;
  }
}

}  // namespace

// headers [n, hstride] int32 (valid_h, valid_w at columns 3 and 4, padding
// flag at 5); keys: n * cap 64-bit words of scratch; counts: 2n int32 (the
// per-tile counts, then the candidate cursors), zeroed here; ys, xs,
// scores, valid: [n, k].  Launches a memset and the two passes on `stream`.
DIFET_EXPORT int difet_select(const float* resp, const int* headers,
                              int hstride, long long n, int h, int w,
                              int halo, float thr, int k, long long cap,
                              void* keys, int* counts, int* ys, int* xs,
                              float* scores, unsigned char* valid,
                              void* stream) {
  const long long hw = static_cast<long long>(h) * w;
  if (n < 0 || h < 1 || w < 1 || hw > 0x7fffffffLL || hstride < 6 || k < 0 ||
      k > hw || cap < 0)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(counts, 0, 2 * n * sizeof(int), s);
  if (e != cudaSuccess) return e;
  const int o0 = halo > 0 ? halo : 0;
  const int rows = h - o0, cols = w - o0;
  if (rows > 0 && cols > 0 && cap > 0) {
    const int bands = ceil_div(rows, BH), segs = ceil_div(cols, SEG);
    const long long warps = n * bands * segs;
    const long long blocks = (warps + A_THREADS / 32 - 1) / (A_THREADS / 32);
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    difet_select_scan<<<static_cast<unsigned>(blocks), A_THREADS, 0, s>>>(
        resp, headers, hstride, h, w, halo, thr, bands, segs, warps, cap,
        static_cast<u64*>(keys), counts, counts + n);
  }
  if (k > 0) {
    if (n > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    difet_select_topk<<<static_cast<unsigned>(n), B_THREADS, 0, s>>>(
        static_cast<u64*>(keys), counts + n, cap, w, k, ys, xs, scores, valid);
  }
  return cudaGetLastError();
}
