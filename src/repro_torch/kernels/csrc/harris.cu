// Harris / Shi-Tomasi structure-tensor response, fp32 [N, H, W] -> [N, H, W].
//
// Replaces the Pallas kernel repro/kernels/harris.py::harris_kernel.  Same
// function: reflect-pad by r + 1; Sobel gradients / 8 on the (H+2r, W+2r)
// extent; products gx^2, gy^2, gx*gy; a separable Gaussian window (W pass,
// then H pass); then det - k * tr^2, or for Shi-Tomasi
// 0.5 * tr - sqrt(max(0.25 * (ixx - iyy)^2 + ixy^2, 0)).  One rounding per
// operation in the plain twin's order (ref.harris), so the two agree bit
// for bit.  The division by 8 is a multiply by 0.125: both round the same
// real number, so they agree on every float32.
//
// Bound on Hopper: memory at 8 bytes per output, with compute close behind:
// about 19 operations per gradient pixel and 3 x (4r + 1) per output and
// pass, ~110 instructions per output at r = 3 once the halo is counted.
// Design, as blur.cu's:
//   - the window radius is a template parameter (0..16), taps in the
//     parameter bank;
//   - the W pass computes the gradients and their products in registers,
//     straight from the staged slab, 8 outputs of a row per thread, and
//     streams them into three tap-ordered accumulators per output; no
//     gradient-product plane is written to shared memory;
//   - the H pass makes 8 outputs of a column per thread from the three
//     W-pass planes, three accumulators each, and the response;
//   - 64 x 64 output tiles, a persistent grid and a two-slab cp.async ring,
//     the same vector or reflecting staging (common.cuh stage_slab).
// 95 KB of shared memory per block at r = 3, 155 KB at r = 16.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TH = 64, TW = 64;   // output tile
constexpr int RW = 8;             // W pass: outputs per thread (one row)
constexpr int RH = 8;             // H pass: outputs per thread (one column)

template <int R>
struct Geom {
  static constexpr int RA = (R + 4) & ~3;  // column halo >= r + 1, multiple of 4
  static constexpr int SH = TH + 2 * R + 2;  // slab rows (pad r + 1)
  static constexpr int SW = TW + 2 * RA;     // slab columns
  static constexpr int GH = TH + 2 * R;      // gradient rows of the W pass
  static constexpr int OFF = RA - R - 1;     // slab column of a run's first
                                             // gradient window
  static constexpr int NV = 2 * RA + RW;     // slab values a W-pass run reads
  static constexpr size_t SMEM =
      sizeof(float) * (2 * SH * SW + 3 * GH * TW);
};

// Sobel / 8 at the 3x3 window whose top-left is column p of rows a, b, c,
// in the twin's order (pyramid.sobel_valid).
__device__ __forceinline__ void sobel(const float* a, const float* b,
                                      const float* c, int p, float* gx,
                                      float* gy) {
  // (sl(-1,1) + 2 sl(0,1) + sl(1,1) - sl(-1,-1) - 2 sl(0,-1) - sl(1,-1)) / 8
  float u = __fadd_rn(a[p + 2], __fmul_rn(2.f, b[p + 2]));
  u = __fadd_rn(u, c[p + 2]);
  u = __fsub_rn(u, a[p]);
  u = __fsub_rn(u, __fmul_rn(2.f, b[p]));
  *gx = __fmul_rn(__fsub_rn(u, c[p]), 0.125f);
  // (sl(1,-1) + 2 sl(1,0) + sl(1,1) - sl(-1,-1) - 2 sl(-1,0) - sl(-1,1)) / 8
  float v = __fadd_rn(c[p], __fmul_rn(2.f, c[p + 1]));
  v = __fadd_rn(v, c[p + 2]);
  v = __fsub_rn(v, a[p]);
  v = __fsub_rn(v, __fmul_rn(2.f, a[p + 1]));
  *gy = __fmul_rn(__fsub_rn(v, a[p + 2]), 0.125f);
}

template <int R>
__global__ void __launch_bounds__(THREADS)
harris_kernel(const float* __restrict__ x, float* __restrict__ out, int h,
              int w, int tiles_x, int tiles, int n_tiles, int vec,
              Taps taps, float k, int shi_tomasi) {
  using G = Geom<R>;
  extern __shared__ __align__(16) float smem[];
  float* rxx = smem + 2 * G::SH * G::SW;   // GH x TW each, after the W pass
  float* ryy = rxx + G::GH * TW;
  float* rxy = ryy + G::GH * TW;
  const long long plane = static_cast<long long>(h) * w;

  auto stage = [&](TileOrigin o, float* slab) {
    stage_slab<G::SH, G::SW>(x + o.img * plane, h, w, o.y0 - R - 1,
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

    // W pass: gradient row gr, outputs [RW*q, RW*q + RW).  Gradient m of
    // the run has its window at slab column RW*q + OFF + m of slab rows
    // gr .. gr + 2; its products go into every output it is a tap of.
    for (int i = threadIdx.x; i < G::GH * (TW / RW); i += THREADS) {
      const int gr = i / (TW / RW), q = i % (TW / RW);
      const float* src = slab + gr * G::SW + RW * q;
      float a[G::NV], b[G::NV], c[G::NV];
      float axx[RW] = {}, ayy[RW] = {}, axy[RW] = {};
#pragma unroll
      for (int m = 0; m < RW + 2 * R; ++m) {
        const int p = G::OFF + m;
        // load the float4 chunks this window reaches first (constant trip
        // count, so the loop unrolls and a, b, c stay in registers)
#pragma unroll
        for (int ch = 0; ch < G::NV / 4; ++ch) {
          const bool first = m == 0 ? ch <= (p + 2) / 4
                                    : (p + 2) % 4 == 0 && ch == (p + 2) / 4;
          if (!first) continue;
          const float4 va = *reinterpret_cast<const float4*>(src + 4 * ch);
          const float4 vb =
              *reinterpret_cast<const float4*>(src + G::SW + 4 * ch);
          const float4 vc =
              *reinterpret_cast<const float4*>(src + 2 * G::SW + 4 * ch);
          a[4 * ch] = va.x; a[4 * ch + 1] = va.y;
          a[4 * ch + 2] = va.z; a[4 * ch + 3] = va.w;
          b[4 * ch] = vb.x; b[4 * ch + 1] = vb.y;
          b[4 * ch + 2] = vb.z; b[4 * ch + 3] = vb.w;
          c[4 * ch] = vc.x; c[4 * ch + 1] = vc.y;
          c[4 * ch + 2] = vc.z; c[4 * ch + 3] = vc.w;
        }
        float gx, gy;
        sobel(a, b, c, p, &gx, &gy);
        const float pxx = __fmul_rn(gx, gx), pyy = __fmul_rn(gy, gy),
                    pxy = __fmul_rn(gx, gy);
#pragma unroll
        for (int o = 0; o < RW; ++o) {
          const int j = m - o;
          if (j >= 0 && j <= 2 * R) {
            axx[o] = tap_step(axx[o], j, taps.t[j], pxx);
            ayy[o] = tap_step(ayy[o], j, taps.t[j], pyy);
            axy[o] = tap_step(axy[o], j, taps.t[j], pxy);
          }
        }
      }
      const int at = gr * TW + RW * q;
#pragma unroll
      for (int o = 0; o < RW; o += 4) {
        *reinterpret_cast<float4*>(rxx + at + o) =
            make_float4(axx[o], axx[o + 1], axx[o + 2], axx[o + 3]);
        *reinterpret_cast<float4*>(ryy + at + o) =
            make_float4(ayy[o], ayy[o + 1], ayy[o + 2], ayy[o + 3]);
        *reinterpret_cast<float4*>(rxy + at + o) =
            make_float4(axy[o], axy[o + 1], axy[o + 2], axy[o + 3]);
      }
    }
    __syncthreads();

    // H pass: column cx, output rows [RH*s, RH*s + RH), then the response.
    for (int i = threadIdx.x; i < TW * (TH / RH); i += THREADS) {
      const int cx = i % TW, s = i / TW;
      float ixx[RH] = {}, iyy[RH] = {}, ixy[RH] = {};
#pragma unroll
      for (int m = 0; m < RH + 2 * R; ++m) {
        const int o = (RH * s + m) * TW + cx;
        const float vxx = rxx[o], vyy = ryy[o], vxy = rxy[o];
#pragma unroll
        for (int e = 0; e < RH; ++e) {
          const int j = m - e;
          if (j >= 0 && j <= 2 * R) {
            ixx[e] = tap_step(ixx[e], j, taps.t[j], vxx);
            iyy[e] = tap_step(iyy[e], j, taps.t[j], vyy);
            ixy[e] = tap_step(ixy[e], j, taps.t[j], vxy);
          }
        }
      }
      const int gx = cur.x0 + cx;
      if (gx >= w) continue;
      float* dst = out + cur.img * plane + gx;
#pragma unroll
      for (int e = 0; e < RH; ++e) {
        const int gy = cur.y0 + RH * s + e;
        if (gy >= h) break;
        float res;
        if (shi_tomasi) {
          const float half_tr = __fmul_rn(0.5f, __fadd_rn(ixx[e], iyy[e]));
          const float d = __fsub_rn(ixx[e], iyy[e]);
          const float q = __fadd_rn(__fmul_rn(0.25f, __fmul_rn(d, d)),
                                    __fmul_rn(ixy[e], ixy[e]));
          res = __fsub_rn(half_tr, __fsqrt_rn(fmaxf(q, 0.f)));
        } else {
          const float det = __fsub_rn(__fmul_rn(ixx[e], iyy[e]),
                                      __fmul_rn(ixy[e], ixy[e]));
          const float tr = __fadd_rn(ixx[e], iyy[e]);
          res = __fsub_rn(det, __fmul_rn(__fmul_rn(k, tr), tr));
        }
        dst[static_cast<long long>(gy) * w] = res;
      }
    }
    cur = next;
  }
}

template <int R>
cudaError_t launch(const float* x, float* out, long long n, int h, int w,
                   const Taps& taps, float k, int shi_tomasi, int vec,
                   cudaStream_t stream) {
  using G = Geom<R>;
  const int tiles_x = ceil_div(w, TW);
  const long long tiles = static_cast<long long>(tiles_x) * ceil_div(h, TH);
  int blocks = 0;
  cudaError_t e = allow_smem(harris_kernel<R>, G::SMEM);
  if (e == cudaSuccess)
    e = persistent_blocks(harris_kernel<R>, THREADS, G::SMEM, n * tiles,
                          &blocks);
  if (e != cudaSuccess) return e;
  harris_kernel<R><<<blocks, THREADS, G::SMEM, stream>>>(
      x, out, h, w, tiles_x, static_cast<int>(tiles),
      static_cast<int>(n * tiles), vec, taps, k, shi_tomasi);
  return cudaGetLastError();
}

}  // namespace

// The staging is chosen as difet_blur's: 16-byte copies where w % 4 == 0
// and x is 16-byte aligned, the scalar reflecting staging otherwise.
DIFET_EXPORT int difet_harris(const float* x, float* out, long long n, int h,
                              int w, const float* taps_host, int n_taps,
                              float k, int shi_tomasi, void* stream) {
  if (n_taps < 1 || n_taps > MAX_TAPS || n_taps % 2 == 0 || h < 1 || w < 1)
    return cudaErrorInvalidValue;
  const int vec = w % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  if (n == 0) return cudaSuccess;
  Taps taps;
  taps.n = n_taps;
  for (int i = 0; i < MAX_TAPS; ++i) taps.t[i] = i < n_taps ? taps_host[i] : 0.f;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((n_taps - 1) / 2) {
#define DIFET_HARRIS_CASE(R) \
  case R: return launch<R>(x, out, n, h, w, taps, k, shi_tomasi, vec, s);
    DIFET_HARRIS_CASE(0) DIFET_HARRIS_CASE(1) DIFET_HARRIS_CASE(2)
    DIFET_HARRIS_CASE(3) DIFET_HARRIS_CASE(4) DIFET_HARRIS_CASE(5)
    DIFET_HARRIS_CASE(6) DIFET_HARRIS_CASE(7) DIFET_HARRIS_CASE(8)
    DIFET_HARRIS_CASE(9) DIFET_HARRIS_CASE(10) DIFET_HARRIS_CASE(11)
    DIFET_HARRIS_CASE(12) DIFET_HARRIS_CASE(13) DIFET_HARRIS_CASE(14)
    DIFET_HARRIS_CASE(15) DIFET_HARRIS_CASE(16)
#undef DIFET_HARRIS_CASE
    default: return cudaErrorInvalidValue;
  }
}
