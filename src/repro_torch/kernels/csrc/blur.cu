// Separable Gaussian blur of an fp32 image batch [N, H, W] -> [N, H, W].
//
// Replaces the Pallas kernel repro/kernels/blur.py::blur_kernel (one grid
// program per whole padded tile in VMEM).  Same function: reflect-pad by
// r = (n_taps - 1) / 2, then a valid W pass followed by a valid H pass, taps
// summed left to right.
//
// Bound on Hopper: memory.  Each output costs 2 * (2r + 1) multiply-adds
// against 8 bytes of device traffic (one read, one write), well below the
// card's ~20 flop/byte fp32 balance point.  Design: one block per 32x32
// output tile; the (32 + 2r)^2 input slab is staged once in shared memory
// (reflecting by index, so no padded copy is ever written to device
// memory), the W pass goes to a second shared buffer, and the H pass writes
// the tile.  Images of any size, including the 22x22 descriptor patches,
// map one (image, tile) pair to each block along gridDim.x.
#include "common.cuh"

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
blur_kernel(const float* __restrict__ x, float* __restrict__ y, int h, int w,
            int tiles_x, int tiles_y, Taps taps) {
  extern __shared__ float smem[];
  __shared__ float st[MAX_TAPS];
  const int n = taps.n, r = (n - 1) / 2;
  const int s = TILE + 2 * r;
  float* slab = smem;              // s x s input
  float* rows = smem + s * s;      // s x TILE after the W pass
  const TileCoord c = tile_coord(tiles_x, tiles_y, TILE, TILE);
  const long long plane = static_cast<long long>(h) * w;
  load_taps(taps.t, n, st);
  load_slab(x + c.img * plane, h, w, c.y0, c.x0, r, s, s, slab);
  __syncthreads();
  for (int i = threadIdx.x; i < s * TILE; i += blockDim.x) {
    const int yy = i / TILE, xx = i - yy * TILE;
    rows[i] = tap_sum(st, n, slab + yy * s + xx, 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TILE * TILE; i += blockDim.x) {
    const int oy = i / TILE, ox = i - oy * TILE;
    const int gy = c.y0 + oy, gx = c.x0 + ox;
    if (gy < h && gx < w)
      y[c.img * plane + static_cast<long long>(gy) * w + gx] =
          tap_sum(st, n, rows + oy * TILE + ox, TILE);
  }
}

}  // namespace

DIFET_EXPORT int difet_blur(const float* x, float* y, long long n, int h, int w,
                            const float* taps_host, int n_taps, void* stream) {
  if (n_taps < 1 || n_taps > MAX_TAPS || n_taps % 2 == 0 || h < 1 || w < 1)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  Taps taps;
  taps.n = n_taps;
  for (int i = 0; i < n_taps; ++i) taps.t[i] = taps_host[i];
  const int s = TILE + (n_taps - 1);
  const size_t smem = sizeof(float) * static_cast<size_t>(s * s + s * TILE);
  const int tiles_x = ceil_div(w, TILE), tiles_y = ceil_div(h, TILE);
  const long long blocks = n * tiles_x * tiles_y;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t e = allow_smem(blur_kernel, smem);
  if (e != cudaSuccess) return e;
  blur_kernel<<<static_cast<unsigned>(blocks), THREADS, smem,
                static_cast<cudaStream_t>(stream)>>>(x, y, h, w, tiles_x,
                                                     tiles_y, taps);
  return cudaGetLastError();
}
