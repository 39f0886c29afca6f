// One fused SIFT octave, fp32 base [N, H, W] -> (resp, seed), each [N, H, W].
//
// Replaces the Pallas kernel repro/kernels/scalespace.py::scalespace_kernel.
// Same function: the octave's level 0 is reflect-padded ONCE by
// P = sum(radii) + 1 (34 at sigma0 = 1.6, 3 scales: radii 4, 5, 6, 8, 10);
// S + 2 incremental blurs follow, each a valid separable convolution whose
// margin shrinks by its radius; DoG_s = level_s - level_{s-1}; the level with
// total sigma 2 * sigma0 (s = S) is written as the next octave's seed; the
// response is the max over mid scales of |DoG| where the pixel is a strict
// 26-neighbour extremum with |DoG| > thr, else 0.
//
// Bound on Hopper: arithmetic and shared-memory traffic, not device memory.
// The kernel reads the base once and writes two maps (12 bytes a pixel),
// while each 32x32 output tile recomputes its blur stack on a
// (32 + 2P)^2 = 100^2 slab: about 10x the outputs' own blur work at P = 34.
// Design: one block per 32x32 output tile; two ping-pong level buffers
// (100^2 and 92^2), one W-pass buffer and the five DoG planes, cropped to
// margin 1 (34^2), all in dynamic shared memory (~134 KB, one block per
// SM), so no level, DoG or neighbour stack ever reaches device memory.
// A larger tile would cut the halo recompute; it is left for later work.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 512;
constexpr int MAX_LEVELS = 8;
constexpr int D = TILE + 2;        // DoG plane side: margin 1

struct Octave {
  float t[MAX_LEVELS * MAX_TAPS];  // taps of level s at t[s * MAX_TAPS]
  int n[MAX_LEVELS];               // tap counts
  int levels;                      // S + 2 incremental blurs
  int pad;                         // P = sum of radii + 1
  int seed_index;                  // 1-based level written as the seed
  float thr;                       // contrast threshold
};

__global__ void __launch_bounds__(THREADS)
scalespace_kernel(const float* __restrict__ x, float* __restrict__ resp,
                  float* __restrict__ seed, int h, int w, int tiles_x,
                  int tiles_y, Octave oc) {
  extern __shared__ float smem[];
  __shared__ float st[MAX_LEVELS * MAX_TAPS];
  __shared__ int sn[MAX_LEVELS];
  const int levels = oc.levels;
  const int e0 = TILE + 2 * oc.pad;
  const int e1 = e0 - (oc.n[0] - 1);
  float* buf[2] = {smem, smem + e0 * e0};
  float* rows = buf[1] + e1 * e1;  // e0 x e1: the widest W pass
  float* dogs = rows + e0 * e1;    // levels x D x D
  const TileCoord c = tile_coord(tiles_x, tiles_y, TILE, TILE);
  const long long plane = static_cast<long long>(h) * w;
  load_taps(oc.t, MAX_LEVELS * MAX_TAPS, st);
  if (threadIdx.x < MAX_LEVELS) sn[threadIdx.x] = oc.n[threadIdx.x];
  load_slab(x + c.img * plane, h, w, c.y0, c.x0, oc.pad, e0, e0, buf[0]);
  __syncthreads();

  const float* prev = buf[0];
  int ep = e0;                     // side of prev
  for (int s = 0; s < levels; ++s) {
    const int n = sn[s], r = (n - 1) / 2;
    const float* t = st + s * MAX_TAPS;
    const int ec = ep - 2 * r;     // side of cur
    float* cur = buf[(s + 1) & 1];
    for (int i = threadIdx.x; i < ep * ec; i += blockDim.x) {
      const int yy = i / ec, xx = i - yy * ec;
      rows[i] = tap_sum(t, n, prev + yy * ep + xx, 1);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < ec * ec; i += blockDim.x) {
      const int yy = i / ec, xx = i - yy * ec;
      cur[i] = tap_sum(t, n, rows + yy * ec + xx, ec);
    }
    __syncthreads();
    const int m = (ec - TILE) / 2;  // margin of cur around the output tile
    const int o = m - 1;            // its margin-1 window
    float* dg = dogs + s * D * D;
    for (int i = threadIdx.x; i < D * D; i += blockDim.x) {
      const int yy = i / D, xx = i - yy * D;
      dg[i] = __fsub_rn(cur[(o + yy) * ec + o + xx],
                        prev[(o + r + yy) * ep + o + r + xx]);
    }
    if (s + 1 == oc.seed_index) {
      for (int i = threadIdx.x; i < TILE * TILE; i += blockDim.x) {
        const int oy = i / TILE, ox = i - oy * TILE;
        const int gy = c.y0 + oy, gx = c.x0 + ox;
        if (gy < h && gx < w)
          seed[c.img * plane + static_cast<long long>(gy) * w + gx] =
              cur[(m + oy) * ec + m + ox];
      }
    }
    __syncthreads();
    prev = cur;
    ep = ec;
  }

  for (int i = threadIdx.x; i < TILE * TILE; i += blockDim.x) {
    const int oy = i / TILE, ox = i - oy * TILE;
    const int gy = c.y0 + oy, gx = c.x0 + ox;
    if (gy >= h || gx >= w) continue;
    float best = 0.f;
    for (int s = 1; s + 1 < levels; ++s) {
      const float* mp = dogs + s * D * D + (oy + 1) * D + ox + 1;
      const float mid = mp[0];
      float nmax = -INFINITY, nmin = INFINITY;
      for (int ds = -1; ds <= 1; ++ds)
        for (int dy = -1; dy <= 1; ++dy)
          for (int dx = -1; dx <= 1; ++dx) {
            if (ds == 0 && dy == 0 && dx == 0) continue;
            const float v = mp[ds * D * D + dy * D + dx];
            nmax = fmaxf(nmax, v);
            nmin = fminf(nmin, v);
          }
      const float a = fabsf(mid);
      const bool hit = (mid > nmax || mid < nmin) && a > oc.thr;
      best = fmaxf(best, hit ? a : 0.f);
    }
    resp[c.img * plane + static_cast<long long>(gy) * w + gx] = best;
  }
}

}  // namespace

DIFET_EXPORT int difet_scalespace(const float* x, float* resp, float* seed,
                                  long long n, int h, int w,
                                  const float* taps_host,
                                  const int* n_taps_host, int levels,
                                  int seed_index, float thr, void* stream) {
  if (levels < 3 || levels > MAX_LEVELS || seed_index < 1 ||
      seed_index > levels || h < 1 || w < 1)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  Octave oc = {};
  oc.levels = levels;
  oc.seed_index = seed_index;
  oc.thr = thr;
  int off = 0, pad = 1;
  for (int s = 0; s < levels; ++s) {
    const int nt = n_taps_host[s];
    if (nt < 1 || nt > MAX_TAPS || nt % 2 == 0) return cudaErrorInvalidValue;
    oc.n[s] = nt;
    for (int j = 0; j < nt; ++j) oc.t[s * MAX_TAPS + j] = taps_host[off + j];
    off += nt;
    pad += (nt - 1) / 2;
  }
  oc.pad = pad;
  const int e0 = TILE + 2 * pad, e1 = e0 - (oc.n[0] - 1);
  const size_t smem = sizeof(float) *
      static_cast<size_t>(e0 * e0 + e1 * e1 + e0 * e1 + levels * D * D);
  const int tiles_x = ceil_div(w, TILE), tiles_y = ceil_div(h, TILE);
  const long long blocks = n * tiles_x * tiles_y;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t e = allow_smem(scalespace_kernel, smem);
  if (e != cudaSuccess) return e;
  scalespace_kernel<<<static_cast<unsigned>(blocks), THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      x, resp, seed, h, w, tiles_x, tiles_y, oc);
  return cudaGetLastError();
}
