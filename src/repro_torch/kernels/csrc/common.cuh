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

// --- staging for the tiled stencils (blur.cu, harris.cu, fastscore.cu) ----
// A slab is SH x SW floats, row pitch SW (a multiple of 4, so every row
// starts 16-byte aligned), holding image rows [ys, ys + SH) and columns
// [xs, xs + SW).  Both stagings copy with cp.async, so a block can stage its
// next tile while it computes on this one.

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `Pending` of this thread's committed groups are in flight.
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// reflect_index with a fast path for an index already inside [0, n).
__device__ __forceinline__ int reflect_fast(int j, int n) {
  return j >= 0 && j < n ? j : reflect_index(j, n);
}

// Tile t of a batch cut into tiles_x columns and `tiles` tiles per image.
struct TileOrigin {
  int img, y0, x0;
};

template <int TH, int TW>
__device__ __forceinline__ TileOrigin tile_origin(int t, int tiles_x,
                                                  int tiles) {
  TileOrigin o;
  o.img = t / tiles;
  const int r = t - o.img * tiles;
  const int ty = r / tiles_x;
  o.y0 = ty * TH;
  o.x0 = (r - ty * tiles_x) * TW;
  return o;
}

// Stage one slab of the image `src` [h, w].  `vec` says that the image rows
// may be read as 16-byte vectors (w % 4 == 0, 16-byte aligned base, xs a
// multiple of 4); a slab that then lies wholly inside the image is copied
// 16 bytes a thread with no index arithmetic but a division by the
// compile-time chunk count.  Any other slab (an edge tile, an unaligned
// image) is copied 4 bytes at a time and reflected: warp k walks rows
// k, k + 8, ... and reflects each row once; a lane reflects its columns
// once per slab and keeps them in registers.  Needs blockDim.x == 256.
template <int SH, int SW>
__device__ __forceinline__ void stage_slab(const float* __restrict__ src,
                                           int h, int w, int ys, int xs,
                                           bool vec, float* slab) {
  static_assert(SW % 4 == 0, "slab rows must be 16-byte aligned");
  constexpr int CPR = SW / 4;            // 16-byte chunks per row
  constexpr int COLS = (SW + 31) / 32;   // columns per lane
  if (vec && ys >= 0 && ys + SH <= h && xs >= 0 && xs + SW <= w) {
    const float* base = src + static_cast<long long>(ys) * w + xs;
    for (int i = threadIdx.x; i < SH * CPR; i += blockDim.x) {
      const int sy = i / CPR, c = i - sy * CPR;
      cp_async16(slab + sy * SW + 4 * c,
                 base + static_cast<long long>(sy) * w + 4 * c);
    }
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int gx[COLS];
#pragma unroll
  for (int k = 0; k < COLS; ++k) gx[k] = reflect_fast(xs + lane + 32 * k, w);
  for (int sy = warp; sy < SH; sy += 8) {
    const float* row = src + static_cast<long long>(reflect_fast(ys + sy, h)) * w;
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      const int sx = lane + 32 * k;
      if (sx < SW) cp_async4(slab + sy * SW + sx, row + gx[k]);
    }
  }
}

// Taps in registers: one multiply-add step of a tap-ordered sum, so that
// acc = t[0]*p[0] + t[1]*p[1] + ... with one rounding per operation, left to
// right, whatever order the outputs of a register block are visited in.
__device__ __forceinline__ float tap_step(float acc, int j, float t, float v) {
  return j == 0 ? __fmul_rn(t, v) : __fadd_rn(acc, __fmul_rn(t, v));
}

// The persistent grid of a tiled stencil: as many blocks as fit on the card
// at once, each walking tiles blockIdx.x, blockIdx.x + gridDim.x, ...
// (tile indices are ints, with room for t + gridDim.x: a batch of 2^30
// tiles of 64 x 64 would not fit the card).
template <typename K>
static inline cudaError_t persistent_blocks(K kernel, int threads, size_t smem,
                                            long long tiles, int* blocks) {
  if (tiles > 0x3fffffffLL) return cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long most = static_cast<long long>(per_sm) * sms;
  *blocks = static_cast<int>(tiles < most ? tiles : most);
  return cudaSuccess;
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
