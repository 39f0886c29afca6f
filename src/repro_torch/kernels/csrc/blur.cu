// Separable Gaussian blur of an fp32 image batch [N, H, W] -> [N, H, W].
//
// Replaces the Pallas kernel repro/kernels/blur.py::blur_kernel (one grid
// program per whole padded tile in VMEM).  Same function: reflect-pad by
// r = (n_taps - 1) / 2, then a valid W pass followed by a valid H pass, taps
// summed left to right with one rounding per multiply and per add, so the
// result is bit for bit that of the plain twin ref.gaussian_blur.
//
// Bound on Hopper: memory, 8 bytes per output pixel (one read, one write).
// Exact uncontracted arithmetic makes compute a near second: a pass costs
// 2r + 1 multiplies and 2r adds per output, 41 instructions at r = 10, and
// the W pass also runs over the tile's 2r halo rows.  Against both:
//   - the radius is a template parameter (0..16), so the tap loops unroll
//     and the taps are read from the parameter bank, uniform across the
//     warp, with no shared-memory load per tap;
//   - register blocking: a W-pass thread makes 4 outputs of a row from 4+2r
//     staged values read as 16-byte vectors, an H-pass thread 16 outputs of
//     a column, so each staged value leaves shared memory about once per
//     run instead of 2r + 1 times;
//   - 64 x 64 output tiles (the W pass recomputes 2r halo rows per 64, not
//     per 32);
//   - a persistent grid (as many blocks as fit on the card) walks the
//     (image, tile) pairs with a two-slab ring, staging the next tile with
//     cp.async while it computes this one.  A slab wholly inside an image
//     whose rows are 16-byte aligned is copied 16 bytes a thread; an edge
//     slab or an unaligned image is copied 4 bytes at a time, reflecting
//     each row and column once (common.cuh stage_slab);
//   - images no larger than 32 x 32 (the 22 x 22 descriptor patches) take
//     one warp each, several to a block, so no thread of a 64 x 64 tile
//     idles on them.
// 98 KB of shared memory per block at r = 16, 66 KB at r = 5.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TH = 64, TW = 64;   // output tile
constexpr int RW = 4;             // W pass: outputs per thread, one float4
constexpr int RH = 16;            // H pass: outputs per thread, one column
constexpr int SMALL_MAX = 32;     // images up to this side take one warp each
static_assert(THREADS == TW * (TH / RH), "one H-pass strip per thread");

template <int R>
struct Geom {
  static constexpr int RA = (R + 3) & ~3;  // column halo, a multiple of 4
  static constexpr int SH = TH + 2 * R;    // slab rows
  static constexpr int SW = TW + 2 * RA;   // slab columns
  static constexpr int OFF = RA - R;       // slab column of a run's first tap
  static constexpr int NV = 2 * RA + RW;   // slab values a W-pass run reads
  static constexpr size_t SMEM = sizeof(float) * (2 * SH * SW + SH * TW);
};

template <int R>
__global__ void __launch_bounds__(THREADS)
blur_tiled(const float* __restrict__ x, float* __restrict__ y, int h, int w,
           int tiles_x, int tiles, int n_tiles, int vec,
           Taps taps) {
  using G = Geom<R>;
  extern __shared__ __align__(16) float smem[];
  float* rows = smem + 2 * G::SH * G::SW;   // SH x TW after the W pass
  const long long plane = static_cast<long long>(h) * w;

  auto stage = [&](TileOrigin o, float* slab) {
    stage_slab<G::SH, G::SW>(x + o.img * plane, h, w, o.y0 - R,
                             o.x0 - G::RA, vec != 0, slab);
  };

  int t = blockIdx.x;
  TileOrigin cur = tile_origin<TH, TW>(t, tiles_x, tiles);
  if (t < n_tiles) stage(cur, smem);
  cp_async_commit();
  for (int it = 0; t < n_tiles; ++it, t += gridDim.x) {
    const float* slab = smem + (it & 1) * G::SH * G::SW;
    const TileOrigin next = tile_origin<TH, TW>(t + gridDim.x, tiles_x, tiles);
    if (t + gridDim.x < n_tiles)
      stage(next, smem + ((it + 1) & 1) * G::SH * G::SW);
    cp_async_commit();
    cp_async_wait<1>();   // this tile's slab has landed
    __syncthreads();

    // W pass: row sy, outputs [RW*q, RW*q + RW) from slab columns
    // [RW*q, RW*q + NV), streamed one float4 at a time.
    for (int i = threadIdx.x; i < G::SH * (TW / RW); i += THREADS) {
      const int sy = i / (TW / RW), q = i % (TW / RW);
      const float* src = slab + sy * G::SW + RW * q;
      float acc[RW] = {};
#pragma unroll
      for (int c = 0; c < G::NV / 4; ++c) {
        const float4 v4 = *reinterpret_cast<const float4*>(src + 4 * c);
        const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int k = 0; k < RW; ++k) {
            const int j = 4 * c + e - G::OFF - k;
            if (j >= 0 && j <= 2 * R)
              acc[k] = tap_step(acc[k], j, taps.t[j], v[e]);
          }
      }
#pragma unroll
      for (int k = 0; k < RW; k += 4)
        *reinterpret_cast<float4*>(rows + sy * TW + RW * q + k) =
            make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
    }
    __syncthreads();

    // H pass: column c, output rows [RH*s, RH*s + RH), streamed one
    // W-pass row at a time.
    const int c = threadIdx.x % TW, s = threadIdx.x / TW;
    float acc[RH] = {};
#pragma unroll
    for (int m = 0; m < RH + 2 * R; ++m) {
      const float v = rows[(RH * s + m) * TW + c];
#pragma unroll
      for (int k = 0; k < RH; ++k) {
        const int j = m - k;
        if (j >= 0 && j <= 2 * R) acc[k] = tap_step(acc[k], j, taps.t[j], v);
      }
    }
    const int gx = cur.x0 + c;
    if (gx < w) {
      float* out = y + cur.img * plane + gx;
#pragma unroll
      for (int k = 0; k < RH; ++k) {
        const int gy = cur.y0 + RH * s + k;
        if (gy < h) out[static_cast<long long>(gy) * w] = acc[k];
      }
    }
    cur = next;
  }
}

// One warp per image of at most SMALL_MAX x SMALL_MAX: the warp stages the
// reflect-padded (h + 2r) x (w + 2r) image in its own slice of shared
// memory, then walks the W-pass and H-pass outputs with all 32 lanes.
template <int R>
__global__ void __launch_bounds__(THREADS)
blur_small(const float* __restrict__ x, float* __restrict__ y, long long n,
           int h, int w, Taps taps) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long img = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5)
                        + warp;
  if (img >= n) return;   // warp-uniform; only __syncwarp below
  const int sh = h + 2 * R, sw = w + 2 * R;
  float* slab = smem + warp * (sh * sw + sh * w);
  float* rows = slab + sh * sw;                  // sh x w after the W pass
  const float* src = x + img * h * w;
  const int gx0 = reflect_fast(lane - R, w);     // sw <= 64: two columns
  const int gx1 = reflect_fast(lane + 32 - R, w);
  for (int sy = 0; sy < sh; ++sy) {
    const float* row = src + reflect_fast(sy - R, h) * w;
    if (lane < sw) slab[sy * sw + lane] = row[gx0];
    if (lane + 32 < sw) slab[sy * sw + lane + 32] = row[gx1];
  }
  __syncwarp();
  // lane-strided walk over (row, column) with no division
  int yy = 0, xx = lane;
  while (xx >= w) { xx -= w; ++yy; }
  while (yy < sh) {
    const float* p = slab + yy * sw + xx;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j <= 2 * R; ++j) acc = tap_step(acc, j, taps.t[j], p[j]);
    rows[yy * w + xx] = acc;
    xx += 32;
    while (xx >= w) { xx -= w; ++yy; }
  }
  __syncwarp();
  float* out = y + img * h * w;
  yy = 0, xx = lane;
  while (xx >= w) { xx -= w; ++yy; }
  while (yy < h) {
    const float* p = rows + yy * w + xx;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j <= 2 * R; ++j)
      acc = tap_step(acc, j, taps.t[j], p[j * w]);
    out[yy * w + xx] = acc;
    xx += 32;
    while (xx >= w) { xx -= w; ++yy; }
  }
}

template <int R>
cudaError_t launch(const float* x, float* y, long long n, int h, int w,
                   const Taps& taps, int vec, cudaStream_t stream) {
  if (h <= SMALL_MAX && w <= SMALL_MAX) {
    const int per_warp = (h + 2 * R) * (w + 2 * R) + (h + 2 * R) * w;
    int warps = (48 * 1024 / 4) / per_warp;
    warps = warps < 1 ? 1 : (warps > THREADS / 32 ? THREADS / 32 : warps);
    const long long blocks = (n + warps - 1) / warps;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    blur_small<R><<<static_cast<unsigned>(blocks), 32 * warps,
                    sizeof(float) * per_warp * warps, stream>>>(x, y, n, h, w,
                                                                taps);
    return cudaGetLastError();
  }
  using G = Geom<R>;
  const int tiles_x = ceil_div(w, TW);
  const long long tiles = static_cast<long long>(tiles_x) * ceil_div(h, TH);
  int blocks = 0;
  cudaError_t e = allow_smem(blur_tiled<R>, G::SMEM);
  if (e == cudaSuccess)
    e = persistent_blocks(blur_tiled<R>, THREADS, G::SMEM, n * tiles, &blocks);
  if (e != cudaSuccess) return e;
  blur_tiled<R><<<blocks, THREADS, G::SMEM, stream>>>(
      x, y, h, w, tiles_x, static_cast<int>(tiles),
      static_cast<int>(n * tiles), vec, taps);
  return cudaGetLastError();
}

}  // namespace

// The tiled form stages with 16-byte copies where x's rows may be read as
// 16-byte vectors (w % 4 == 0 and x 16-byte aligned), else with the scalar
// reflecting staging everywhere (e.g. a view one float into a buffer).
DIFET_EXPORT int difet_blur(const float* x, float* y, long long n, int h, int w,
                            const float* taps_host, int n_taps, void* stream) {
  if (n_taps < 1 || n_taps > MAX_TAPS || n_taps % 2 == 0 || h < 1 || w < 1)
    return cudaErrorInvalidValue;
  const int vec = w % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  if (n == 0) return cudaSuccess;
  Taps taps;
  taps.n = n_taps;
  for (int i = 0; i < MAX_TAPS; ++i) taps.t[i] = i < n_taps ? taps_host[i] : 0.f;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((n_taps - 1) / 2) {
#define DIFET_BLUR_CASE(R) \
  case R: return launch<R>(x, y, n, h, w, taps, vec, s);
    DIFET_BLUR_CASE(0) DIFET_BLUR_CASE(1) DIFET_BLUR_CASE(2)
    DIFET_BLUR_CASE(3)
    DIFET_BLUR_CASE(4) DIFET_BLUR_CASE(5) DIFET_BLUR_CASE(6)
    DIFET_BLUR_CASE(7) DIFET_BLUR_CASE(8) DIFET_BLUR_CASE(9)
    DIFET_BLUR_CASE(10) DIFET_BLUR_CASE(11) DIFET_BLUR_CASE(12)
    DIFET_BLUR_CASE(13) DIFET_BLUR_CASE(14) DIFET_BLUR_CASE(15)
    DIFET_BLUR_CASE(16)
#undef DIFET_BLUR_CASE
    default: return cudaErrorInvalidValue;
  }
}
