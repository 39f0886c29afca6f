// Shared pieces of the DIFET stencil kernels (Hopper, sm_90a).
//
// Every kernel here reads an unpadded fp32 image batch [N, H, W] and
// reflect-pads by index while it stages its slab in shared memory, with the
// semantics of jnp.pad(mode="reflect") (even reflect, multi-bounce when the
// pad is wider than the image).  Arithmetic uses the _rn intrinsics, one
// rounding per multiply and per add in the order of the plain PyTorch twin
// (kernels/ref.py), so nvcc cannot contract it into fused multiply-adds and
// a kernel gives the same bits as its twin on the same card.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define DIFET_EXPORT extern "C" __attribute__((visibility("default")))

constexpr int MAX_TAPS = 33;   // radius <= 16

struct Taps {
  float t[MAX_TAPS];
  int n;
};

__device__ __forceinline__ int reflect_index(int j, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  j = abs(j) % period;
  return j >= n ? period - j : j;
}

// Block index -> (image, tile row, tile column) for a grid that puts every
// (image, tile) pair on blockIdx.x, so N * tiles can exceed 65,535.
struct TileCoord {
  long long img;
  int y0, x0;
};

__device__ __forceinline__ TileCoord tile_coord(int tiles_x, int tiles_y,
                                                int tile_h, int tile_w) {
  long long b = blockIdx.x;
  TileCoord c;
  const int tx = static_cast<int>(b % tiles_x);
  b /= tiles_x;
  const int ty = static_cast<int>(b % tiles_y);
  c.img = b / tiles_y;
  c.y0 = ty * tile_h;
  c.x0 = tx * tile_w;
  return c;
}

// Stage src[img] rows [y0-pad, y0-pad+sh) x cols [x0-pad, x0-pad+sw) into
// shared memory, reflecting out-of-range indices.
__device__ __forceinline__ void load_slab(const float* __restrict__ src,
                                          int h, int w, int y0, int x0,
                                          int pad, int sh, int sw,
                                          float* slab) {
  for (int i = threadIdx.x; i < sh * sw; i += blockDim.x) {
    const int sy = i / sw, sx = i - (i / sw) * sw;
    const int gy = reflect_index(y0 - pad + sy, h);
    const int gx = reflect_index(x0 - pad + sx, w);
    slab[i] = src[static_cast<long long>(gy) * w + gx];
  }
}

// Copy n floats of kernel-parameter taps into shared memory, so that the
// tap loops index shared memory rather than a parameter array.
__device__ __forceinline__ void load_taps(const float* src, int n, float* dst) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// One tap-ordered dot product: t[0]*p[0] + t[1]*p[stride] + ... with one
// rounding per operation, left to right.
__device__ __forceinline__ float tap_sum(const float* t, int n,
                                         const float* p, int stride) {
  float acc = __fmul_rn(t[0], p[0]);
  for (int j = 1; j < n; ++j) acc = __fadd_rn(acc, __fmul_rn(t[j], p[j * stride]));
  return acc;
}

static inline int ceil_div(long long a, int b) {
  return static_cast<int>((a + b - 1) / b);
}

// Dynamic shared memory above 48 KB must be opted into per kernel.
template <typename K>
static inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

DIFET_EXPORT const char* difet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
