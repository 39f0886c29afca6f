// One fused SIFT octave, fp32 base [N, H, W] -> (resp, seed), each [N, H, W].
//
// Replaces the Pallas kernel repro/kernels/scalespace.py::scalespace_kernel.
// Same function: the octave's level 0 is reflect-padded ONCE by
// P = sum(radii) + 1 (34 at sigma0 = 1.6, 3 scales: radii 4, 5, 6, 8, 10);
// S + 2 incremental blurs follow, each a valid separable convolution (W pass,
// then H pass) whose margin shrinks by its radius; DoG_s = level_s -
// level_{s-1}; the level with total sigma 2 * sigma0 (s = S) is written as
// the next octave's seed; the response is the max over mid scales of |DoG|
// where the pixel is a strict 26-neighbour extremum with |DoG| > thr, else 0.
// Sums run left to right with one rounding per multiply and per add, so the
// result is bit for bit that of the plain twin ref.scalespace_octave.
//
// Bound on Hopper: issued instructions.  An exact, uncontracted tap is a
// multiply and an add, ~375 fp32 instructions an output pixel against 12
// bytes of device memory, and the loads, ring indexing and stores around
// them roughly triple that (see PERF.md).
// Design: a row-streaming strip pipeline with one warp per level.
//   - One block owns a column strip of one image: WT output columns (a
//     multiple of 4 chosen here from the radii: 64 for the default octave
//     on 304-wide images) and all rows.  Halo recompute is horizontal
//     only (level s is WT + 2 m_s wide, m_s its margin); the vertical halo is
//     paid once per strip.
//   - Rows flow through the levels K = 4 at a time, one block barrier a
//     step.  In step t, warp s - 1 (level s) W-passes the K rows that level
//     s - 1 made in step t - 1 into a ring of 2 r_s + K rows (rounded up to
//     a multiple of K), then H-passes K rows of level s out of that ring and
//     writes them to its level ring, its DoG rows (against level s - 1 held
//     r_s + K rows back) to its DoG ring and, at s = S, to the seed.  So
//     level s runs d_s - d_{s-1} = K + r_s rows behind level s - 1.  The
//     remaining warps cp.async the next K reflected input rows and compute
//     the extremum of K output rows from DoG rows made in earlier steps.
//     Every ring is sized so that no slot written in a step is read in it
//     by another warp: level rings r_{s+1} + 2K rows, DoG rings
//     d_L - d_s + 2K + 2 rows.
//   - Register blocking: a W-pass item makes 4 outputs of a row from float4
//     loads, an H-pass item the K outputs of a column; each value is added
//     into every output it is a tap of (stream_taps), so every sum keeps the
//     twin's left-to-right order.  The radius is a runtime value and the
//     taps come from shared memory four at a time, so every level runs the
//     same code (one copy per radius, as templates, made the kernel many
//     times larger and measured slower).
//   - The extremum takes a column of KE rows: per DoG level a horizontal
//     3-max/min per row, then the box (3x3) and ring (3x3 without the
//     centre) in registers, combined across the three levels of each mid
//     scale.
// Shared memory (level, W and DoG rings, taps) is laid out on the host from
// the radii and the strip width (layout).  The strip is the widest whose
// rings let two blocks share an SM, else the widest one block can hold,
// evened out over the strips an image needs (geometry).  At the default
// octave a 64-wide strip takes 112,032 bytes, so two blocks share an SM;
// an 8-level octave of radii up to 13 (spo 6 at sigma0 3.6) runs one block
// an SM.
#include <cmath>
#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int K = 4;              // rows per step
constexpr int KE = 2;             // extremum: rows per item (divides K)
constexpr int RW = 4;             // W pass: outputs per item, one float4
constexpr int MAX_LEVELS = 8;
constexpr int MIN_WARPS = 8;      // levels + at least one staging warp
constexpr int MAX_THREADS = 32 * (MAX_LEVELS + 1);
constexpr size_t MAX_SMEM = 232448;   // 227 KB, the most a block may use
// two blocks on an SM: 228 KB an SM, 1 KB of it kept for each block
constexpr size_t TWO_BLOCK_SMEM = 228 * 1024 / 2 - 1024;
constexpr int TAPS_PITCH = 40;    // >= 2 * 16 + 1 + the last chunk's 3 more

struct Strip {
  float t[MAX_LEVELS * MAX_TAPS];  // taps of level s at t[(s - 1) * MAX_TAPS]
  int levels, seed_index, h, w, wt, strips, steps;
  float thr;
  int r[MAX_LEVELS + 1];       // radius of level s (1..levels)
  int m[MAX_LEVELS + 1];       // margin of level s (0..levels)
  int d[MAX_LEVELS + 1];       // level s makes rows [t K - d[s], + K) at step t
  int width[MAX_LEVELS + 1];   // columns of level s: wt + 2 m[s]
  int nq[MAX_LEVELS + 1];      // W-pass items per row of level s
  int lrows[MAX_LEVELS], lpitch[MAX_LEVELS], loff[MAX_LEVELS];  // level rings
  int wrows[MAX_LEVELS + 1], woff[MAX_LEVELS + 1];  // W rings, pitch 4 nq
  int wshift[MAX_LEVELS + 1];  // W-ring row y in slot (y + wshift) mod wrows
  int toff;                    // taps, TAPS_PITCH floats a level
  int grows[MAX_LEVELS + 1], goff[MAX_LEVELS + 1];  // DoG rings, pitch wt + 2
};

__device__ __forceinline__ int ring(int y, int n) {
  const int s = y % n;
  return s < 0 ? s + n : s;
}

// One barrier for all warps of the block, reached from each warp's own code
// path (barrier.sync without .aligned: the warps are at different
// instructions).
__device__ __forceinline__ void block_barrier() {
  asm volatile("barrier.sync 0;\n" ::: "memory");
}

// Four tap-ordered sums acc[k] = t[0] v[k] + t[1] v[k + 1] + ... +
// t[2R] v[k + 2R], k = 0..3, from the stream of 2R + 4 values v that
// load(c) returns four at a time (v[4c .. 4c + 3]): each value is added into
// every output it is a tap of, so each sum keeps the twin's left-to-right
// order, with one rounding per multiply and per add.  The taps come from
// shared memory four at a time (zero past 2R, never used); chunk 0 holds
// each output's first tap (a multiply), the middle chunks every tap in
// range, the last chunks those up to 2R.  R is a runtime value, so all
// levels share this code.
template <typename Load>
__device__ __forceinline__ void stream_taps(const float* taps, int R,
                                            Load load, float (&acc)[4]) {
  const float4* t4 = reinterpret_cast<const float4*>(taps);
  float4 tc = t4[0], tp;
  {
    const float4 v4 = load(0);
    const float v[4] = {v4.x, v4.y, v4.z, v4.w};
    const float t[4] = {tc.x, tc.y, tc.z, tc.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = e - k;
        if (j == 0) acc[k] = __fmul_rn(t[0], v[e]);
        else if (j > 0 && j <= 2 * R)
          acc[k] = __fadd_rn(acc[k], __fmul_rn(t[j], v[e]));
      }
  }
  const int mid_end = (2 * R - 3) / 4;   // chunks 1..mid_end: all in range
  const int last = (2 * R + 3) / 4;
  int c = 1;
#pragma unroll 1
  for (; c <= mid_end; ++c) {
    tp = tc;
    tc = t4[c];
    const float4 v4 = load(c);
    const float v[4] = {v4.x, v4.y, v4.z, v4.w};
    const float t[8] = {tp.x, tp.y, tp.z, tp.w, tc.x, tc.y, tc.z, tc.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        acc[k] = __fadd_rn(acc[k], __fmul_rn(t[e - k + 4], v[e]));
  }
#pragma unroll 1
  for (; c <= last; ++c) {
    tp = tc;
    tc = t4[c];
    const float4 v4 = load(c);
    const float v[4] = {v4.x, v4.y, v4.z, v4.w};
    const float t[8] = {tp.x, tp.y, tp.z, tp.w, tc.x, tc.y, tc.z, tc.w};
    const int lim = 2 * R - 4 * c;        // taps j = 4c + e - k <= 2R
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (e - k <= lim)
          acc[k] = __fadd_rn(acc[k], __fmul_rn(t[e - k + 4], v[e]));
  }
}

// The whole strip for the warp of level s: in step t, W pass of rows
// [(t - 1) K - d[s - 1], + K) of level s - 1 into the W ring, H pass of rows
// [t K - d[s], + K) of level s out of it, with their level, DoG and seed
// rows.  W-ring row y sits in slot (y + w_shift) mod w_rows, a multiple of K
// rows, so that the K rows an H-pass chunk reads never wrap.
__device__ __forceinline__ void level_warp(const Strip& g, float* smem,
                                           float* seed, int x0, int s) {
  static_assert(K == 4, "stream_taps makes four outputs");
  const int lane = threadIdx.x & 31;
  const int R = g.r[s];
  const float* taps = smem + g.toff + (s - 1) * TAPS_PITCH;
  const int h = g.h, wt = g.wt, m = g.m[s], m_in = g.m[s - 1];
  const int nq = g.nq[s], width = g.width[s];
  const float* lin = smem + g.loff[s - 1];          // level s - 1
  const int in_rows = g.lrows[s - 1], in_pitch = g.lpitch[s - 1];
  float* wring = smem + g.woff[s];
  const int w_rows = g.wrows[s], w_pitch = 4 * nq, w_shift = g.wshift[s];
  const bool keep = s < g.levels, is_seed = s == g.seed_index;
  float* lout = smem + (keep ? g.loff[s] : 0);     // level s
  const int out_rows = keep ? g.lrows[s] : K, out_pitch = keep ? g.lpitch[s] : 0;
  float* gring = smem + g.goff[s];                   // DoG of level s
  const int g_rows = g.grows[s], g_pitch = wt + 2;
  const int d_in = g.d[s - 1], d_out = g.d[s];
  // this lane's first W-pass item (row k0, group q0), and the step of 32
  // items between its items (dk rows, dq groups)
  const int k0 = lane / nq, q0 = lane - k0 * nq, dk = 32 / nq,
            dq = 32 - dk * nq;

  for (int t = 0; t < g.steps; ++t) {
    const int yw = (t - 1) * K - d_in;   // first W-pass row
    if (yw + K > -m_in && yw < h + m_in) {
      const int si0 = ring(yw, in_rows), sw0 = ring(yw + w_shift, w_rows);
#pragma unroll 1
      for (int k = k0, q = q0; k < K;) {
        const int y = yw + k;
        if (y >= -m_in && y < h + m_in) {
          const int si = si0 + k < in_rows ? si0 + k : si0 + k - in_rows;
          const int sw = sw0 + k < w_rows ? sw0 + k : sw0 + k - w_rows;
          const float* src = lin + si * in_pitch + 4 * q;
          float acc[4];
          stream_taps(taps, R, [&](int c) {
            return *reinterpret_cast<const float4*>(src + 4 * c);
          }, acc);
          *reinterpret_cast<float4*>(wring + sw * w_pitch + 4 * q) =
              make_float4(acc[0], acc[1], acc[2], acc[3]);
        }
        k += dk;
        q += dq;
        if (q >= nq) { q -= nq; ++k; }
      }
    }
    __syncwarp();
    const int y0 = t * K - d_out;         // first H-pass row
    if (y0 + K > -m && y0 < h + m) {
      // ring offsets of the K output rows (the same for every column)
      int lo[K], po[K], go[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        lo[k] = ring(y0 + k, out_rows) * out_pitch;
        po[k] = ring(y0 + k, in_rows) * in_pitch + R;
        go[k] = ring(y0 + k, g_rows) * g_pitch - (m - 1);
      }
      const int sh = ring(y0 - R + w_shift, w_rows);   // a multiple of K
#pragma unroll 1
      for (int c = lane; c < width; c += 32) {
        float out[4];
        stream_taps(taps, R, [&](int ch) {
          int sb = sh + 4 * ch;
          sb = sb >= w_rows ? sb - w_rows : sb;
          const float* p = wring + sb * w_pitch + c;
          return make_float4(p[0], p[w_pitch], p[2 * w_pitch],
                             p[3 * w_pitch]);
        }, out);
        if (keep) {
#pragma unroll
          for (int k = 0; k < K; ++k) lout[lo[k] + c] = out[k];
        }
        if (c >= m - 1 && c < m + wt + 1) {   // DoG columns: margin 1
#pragma unroll
          for (int k = 0; k < K; ++k)
            gring[go[k] + c] = __fsub_rn(out[k], lin[po[k] + c]);
        }
        const int gx = x0 + c - m;
        if (is_seed && c >= m && c < m + wt && gx < g.w) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int y = y0 + k;
            if (y >= 0 && y < h) seed[static_cast<long long>(y) * g.w + gx] = out[k];
          }
        }
      }
    }
    block_barrier();
  }
}

// Horizontal 3-max/min of KE + 2 DoG rows around column c + 1, then the box
// (3 x 3) and the ring (3 x 3 without the centre) of rows 1..KE.
struct Window {
  float cen[KE], rmax[KE], rmin[KE], bmax[KE], bmin[KE];
};

__device__ __forceinline__ void window(const float* g, int nrows, int pitch,
                                       int y0, int c, Window& o) {
  float hx[KE + 2], hn[KE + 2], lr_max[KE + 2], lr_min[KE + 2], mid[KE + 2];
  int slot = ring(y0, nrows);
#pragma unroll
  for (int i = 0; i < KE + 2; ++i) {
    const float* p = g + slot * pitch + c;
    slot = slot + 1 == nrows ? 0 : slot + 1;
    const float a = p[0], b = p[1], e = p[2];
    lr_max[i] = fmaxf(a, e);
    lr_min[i] = fminf(a, e);
    mid[i] = b;
    hx[i] = fmaxf(lr_max[i], b);
    hn[i] = fminf(lr_min[i], b);
  }
#pragma unroll
  for (int k = 0; k < KE; ++k) {
    o.cen[k] = mid[k + 1];
    o.rmax[k] = fmaxf(fmaxf(hx[k], hx[k + 2]), lr_max[k + 1]);
    o.rmin[k] = fminf(fminf(hn[k], hn[k + 2]), lr_min[k + 1]);
    o.bmax[k] = fmaxf(o.rmax[k], mid[k + 1]);
    o.bmin[k] = fminf(o.rmin[k], mid[k + 1]);
  }
}

// Response of rows [ye, ye + KE) of output column c (strip column).
__device__ __forceinline__ void extremum_item(const Strip& g, const float* smem,
                                              float* resp, int x0, int c,
                                              int ye) {
  const int pitch = g.wt + 2;
  float best[KE] = {};
  Window lo, cur, hi;   // levels d - 2, d - 1, d
  window(smem + g.goff[1], g.grows[1], pitch, ye - 1, c, lo);
  window(smem + g.goff[2], g.grows[2], pitch, ye - 1, c, cur);
  for (int dl = 3; dl <= g.levels; ++dl) {
    window(smem + g.goff[dl], g.grows[dl], pitch, ye - 1, c, hi);
#pragma unroll
    for (int k = 0; k < KE; ++k) {
      const float nmax = fmaxf(fmaxf(lo.bmax[k], hi.bmax[k]), cur.rmax[k]);
      const float nmin = fminf(fminf(lo.bmin[k], hi.bmin[k]), cur.rmin[k]);
      const float v = cur.cen[k], a = fabsf(v);
      const bool hit = (v > nmax || v < nmin) && a > g.thr;
      best[k] = fmaxf(best[k], hit ? a : 0.f);
    }
    lo = cur;
    cur = hi;
  }
  const int gx = x0 + c;
  if (gx >= g.w) return;
#pragma unroll
  for (int k = 0; k < KE; ++k) {
    const int y = ye + k;
    if (y >= 0 && y < g.h) resp[static_cast<long long>(y) * g.w + gx] = best[k];
  }
}

// The warps after the level warps: in step t, cp.async the K input rows
// [t K - P, + K) (level 0, reflected) into their ring, and compute the
// response of rows [(t - 1) K - d_L - 1, + K) from DoG rows of earlier steps.
__device__ __forceinline__ void aux_warps(const Strip& g, float* smem,
                                          const float* src, float* resp,
                                          int x0) {
  const int L = g.levels, P = g.m[0], w0 = g.width[0];
  const int at = threadIdx.x - 32 * L, n_at = blockDim.x - 32 * L;
  const int n_e = g.wt * (K / KE);
  for (int t = 0; t < g.steps; ++t) {
    for (int k = 0; k < K; ++k) {
      const int y = t * K - P + k;
      if (y < -P || y >= g.h + P) continue;
      const float* row = src + static_cast<long long>(reflect_fast(y, g.h)) * g.w;
      float* dst = smem + g.loff[0] + ring(y, g.lrows[0]) * g.lpitch[0];
      for (int j = at; j < w0; j += n_at)
        cp_async4(dst + j, row + reflect_fast(x0 - P + j, g.w));
    }
    cp_async_commit();
    const int ye = (t - 1) * K - g.d[L] - 1;
    if (ye + K > 0 && ye < g.h) {
#pragma unroll 1
      for (int i = at; i < n_e; i += n_at) {
        const int part = i / g.wt;
        extremum_item(g, smem, resp, x0, i - part * g.wt, ye + part * KE);
      }
    }
    cp_async_wait<0>();   // this step's input rows have landed
    block_barrier();
  }
}

__global__ void __launch_bounds__(MAX_THREADS, 2)
scalespace_strip(const float* __restrict__ x, float* __restrict__ resp,
                 float* __restrict__ seed, const Strip g) {
  extern __shared__ __align__(16) float smem[];
  const int img = blockIdx.x / g.strips;
  const int x0 = (blockIdx.x - img * g.strips) * g.wt;
  const long long plane = static_cast<long long>(g.h) * g.w;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < g.levels * TAPS_PITCH; i += blockDim.x) {
    const int s = i / TAPS_PITCH, j = i - s * TAPS_PITCH;
    smem[g.toff + i] = j < 2 * g.r[s + 1] + 1 ? g.t[s * MAX_TAPS + j] : 0.f;
  }
  __syncthreads();
  if (warp < g.levels) {
    level_warp(g, smem, seed + img * plane, x0, warp + 1);
  } else {
    aux_warps(g, smem, x + img * plane, resp + img * plane, x0);
  }
}

// The strip pipeline's layout at strip width wt; returns its shared-memory
// bytes, or 0 where the octave is outside the kernel's limits.
size_t layout(const int* n_taps, int levels, int wt, Strip* g) {
  if (levels < 3 || levels > MAX_LEVELS || wt < 4 || wt % 4 != 0) return 0;
  int pad = 1;
  for (int s = 1; s <= levels; ++s) {
    const int nt = n_taps[s - 1];
    if (nt < 1 || nt > MAX_TAPS || nt % 2 == 0) return 0;
    g->r[s] = (nt - 1) / 2;
    pad += g->r[s];
  }
  g->levels = levels;
  g->wt = wt;
  g->m[0] = pad;
  g->d[0] = pad;
  for (int s = 1; s <= levels; ++s) {
    g->m[s] = g->m[s - 1] - g->r[s];
    g->d[s] = g->d[s - 1] + K + g->r[s];
  }
  for (int s = 0; s <= levels; ++s) {
    g->width[s] = wt + 2 * g->m[s];
    g->nq[s] = (g->width[s] + RW - 1) / RW;
  }
  size_t off = 0;
  for (int s = 0; s < levels; ++s) {   // level s feeds level s + 1
    const int nv = 4 * ((RW + 2 * g->r[s + 1] + 3) / 4);
    const int need = 4 * (g->nq[s + 1] - 1) + nv;
    const int own = 4 * ((g->width[s] + 3) / 4);
    g->lrows[s] = g->r[s + 1] + 2 * K;
    g->lpitch[s] = own > need ? own : need;
    g->loff[s] = static_cast<int>(off);
    off += static_cast<size_t>(g->lrows[s]) * g->lpitch[s];
  }
  for (int s = 1; s <= levels; ++s) {
    // a multiple of K rows, and the H pass's first row y0 - r (y0 = t K -
    // d[s]) on a slot that is a multiple of K
    g->wrows[s] = (2 * g->r[s] + K + K - 1) / K * K;
    g->wshift[s] = ((g->d[s] + g->r[s]) % K + K) % K;
    g->woff[s] = static_cast<int>(off);
    off += static_cast<size_t>(g->wrows[s]) * 4 * g->nq[s];
  }
  for (int s = 1; s <= levels; ++s) {
    g->grows[s] = g->d[levels] - g->d[s] + 2 * K + 2;
    g->goff[s] = static_cast<int>(off);
    off += static_cast<size_t>(g->grows[s]) * (wt + 2);
  }
  off = (off + 3) / 4 * 4;
  g->toff = static_cast<int>(off);
  off += static_cast<size_t>(TAPS_PITCH) * levels;
  return off * sizeof(float);
}

// The launch's layout for images w wide: the widest strip (a multiple of 4,
// at most w rounded up) whose rings let two blocks share an SM, else the
// widest one block can hold, evened out over the strips it needs.  Returns
// its shared-memory bytes, or 0 where the octave is outside the kernel's
// limits or not even 4 columns fit.
size_t geometry(const int* n_taps, int levels, int w, Strip* g) {
  const int cap = 4 * ceil_div(w, 4);
  int widest = 0;
  for (const size_t budget : {TWO_BLOCK_SMEM, MAX_SMEM}) {
    while (widest + 4 <= cap) {
      const size_t bytes = layout(n_taps, levels, widest + 4, g);
      if (bytes == 0 || bytes > budget) break;
      widest += 4;
    }
    if (widest > 0) break;
  }
  if (widest == 0) return 0;
  const int even = ceil_div(w, ceil_div(w, widest));
  return layout(n_taps, levels, 4 * ceil_div(even, 4), g);
}

// One warp per level and the rest (at least one) for staging and the
// extremum.
int block_threads(int levels) {
  return 32 * (levels + 1 > MIN_WARPS ? levels + 1 : MIN_WARPS);
}

}  // namespace

DIFET_EXPORT int difet_scalespace(const float* x, float* resp, float* seed,
                                  long long n, int h, int w,
                                  const float* taps_host,
                                  const int* n_taps_host, int levels,
                                  int seed_index, float thr, void* stream) {
  if (seed_index < 1 || seed_index > levels || h < 1 || w < 1)
    return cudaErrorInvalidValue;
  Strip g = {};
  const size_t smem = geometry(n_taps_host, levels, w, &g);
  if (smem == 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  int off = 0;
  for (int s = 0; s < levels; ++s) {
    for (int j = 0; j < n_taps_host[s]; ++j)
      g.t[s * MAX_TAPS + j] = taps_host[off + j];
    off += n_taps_host[s];
  }
  g.seed_index = seed_index;
  g.thr = thr;
  g.h = h;
  g.w = w;
  g.strips = ceil_div(w, g.wt);
  // the extremum of step t covers rows [(t - 1) K - d_L - 1, + K): the
  // last step's must reach row h - 1
  g.steps = ceil_div(static_cast<long long>(h) + g.d[levels] + 1, K) + 1;
  const long long blocks = n * g.strips;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t e = allow_smem(scalespace_strip, smem);
  if (e != cudaSuccess) return e;
  scalespace_strip<<<static_cast<unsigned>(blocks), block_threads(levels),
                     smem, static_cast<cudaStream_t>(stream)>>>(x, resp, seed,
                                                                 g);
  return cudaGetLastError();
}

// The launch geometry for an octave of `levels` levels (taps per level
// n_taps) on images w wide: strip width, shared-memory bytes a block and
// blocks an SM (registers and shared memory both counted).
DIFET_EXPORT int difet_scalespace_geometry(const int* n_taps, int levels,
                                           int w, int* strip_width,
                                           long long* smem_bytes,
                                           int* blocks_per_sm) {
  Strip g = {};
  const size_t smem = w < 1 ? 0 : geometry(n_taps, levels, w, &g);
  if (smem == 0) return cudaErrorInvalidValue;
  *strip_width = g.wt;
  *smem_bytes = static_cast<long long>(smem);
  cudaError_t e = allow_smem(scalespace_strip, smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, scalespace_strip, block_threads(levels), smem);
}
