// FAST-N corner score, fp32 [N, H, W] -> [N, H, W].
//
// Replaces the Pallas kernel repro/kernels/fastscore.py::fast_kernel.  Same
// function: reflect-pad by 3; each of the 16 Bresenham ring pixels is
// flagged brighter (> centre + t) or darker (< centre - t); a pixel is a
// corner if some run of >= arc consecutive ring pixels (circularly) is all
// brighter or all darker; the score is max(sum_brighter(|d| - t),
// sum_darker(|d| - t)) in ring order, 0 elsewhere.
//
// Bound on Hopper: memory.  About 100 simple operations per output against
// 8 bytes of device traffic.  Design: one block per 32x32 output tile with
// its 38x38 slab in shared memory; each thread keeps the two ring flag sets
// as 16-bit masks in a register, so the arc test is a handful of shifts and
// ANDs on the doubled mask instead of the Pallas kernel's 16 x arc boolean
// planes.
#include "common.cuh"

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 256;
constexpr int PAD = 3;
constexpr int S = TILE + 2 * PAD;

// repro/core/detectors.py FAST_OFFSETS, (dy, dx) in ring order
__constant__ int kRingDY[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kRingDX[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                0, -1, -2, -3, -3, -3, -2, -1};

// true if the 16-bit ring mask has a circular run of >= arc set bits
__device__ __forceinline__ bool has_arc(unsigned m, int arc) {
  const unsigned d = m | (m << 16);
  unsigned run = d;
  for (int j = 1; j < arc; ++j) run &= d >> j;
  return (run & 0xFFFFu) != 0;
}

__global__ void __launch_bounds__(THREADS)
fast_kernel(const float* __restrict__ x, float* __restrict__ out, int h,
            int w, int tiles_x, int tiles_y, float t, int arc) {
  __shared__ float slab[S * S];
  const TileCoord c = tile_coord(tiles_x, tiles_y, TILE, TILE);
  const long long plane = static_cast<long long>(h) * w;
  load_slab(x + c.img * plane, h, w, c.y0, c.x0, PAD, S, S, slab);
  __syncthreads();
  for (int i = threadIdx.x; i < TILE * TILE; i += blockDim.x) {
    const int oy = i / TILE, ox = i - oy * TILE;
    const int gy = c.y0 + oy, gx = c.x0 + ox;
    if (gy >= h || gx >= w) continue;
    const float* p = slab + (oy + PAD) * S + ox + PAD;
    const float center = p[0];
    const float hi = __fadd_rn(center, t), lo = __fsub_rn(center, t);
    unsigned bright = 0, dark = 0;
    float sb = 0.f, sd = 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float v = p[kRingDY[k] * S + kRingDX[k]];
      const bool b = v > hi, d = v < lo;
      const float diff = __fsub_rn(fabsf(__fsub_rn(v, center)), t);
      bright |= static_cast<unsigned>(b) << k;
      dark |= static_cast<unsigned>(d) << k;
      sb = __fadd_rn(sb, b ? diff : 0.f);
      sd = __fadd_rn(sd, d ? diff : 0.f);
    }
    const bool corner = has_arc(bright, arc) || has_arc(dark, arc);
    out[c.img * plane + static_cast<long long>(gy) * w + gx] =
        corner ? fmaxf(sb, sd) : 0.f;
  }
}

}  // namespace

DIFET_EXPORT int difet_fast(const float* x, float* out, long long n, int h,
                            int w, float threshold, int arc, void* stream) {
  if (arc < 1 || arc > 16 || h < 1 || w < 1) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int tiles_x = ceil_div(w, TILE), tiles_y = ceil_div(h, TILE);
  const long long blocks = n * tiles_x * tiles_y;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  fast_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(x, out, h, w, tiles_x,
                                                     tiles_y, threshold, arc);
  return cudaGetLastError();
}
