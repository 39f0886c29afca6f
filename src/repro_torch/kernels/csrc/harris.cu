// Harris / Shi-Tomasi structure-tensor response, fp32 [N, H, W] -> [N, H, W].
//
// Replaces the Pallas kernel repro/kernels/harris.py::harris_kernel.  Same
// function: reflect-pad by r + 1; Sobel gradients / 8 on the (H+2r, W+2r)
// extent; products gx^2, gy^2, gx*gy; a separable Gaussian window (W pass,
// then H pass); then det - k * tr^2, or for Shi-Tomasi
// 0.5 * tr - sqrt(max(0.25 * (ixx - iyy)^2 + ixy^2, 0)).
//
// Bound on Hopper: memory at this size.  About 12 * (2r + 1) + 20 flops per
// output (~100 at r = 3) against 8 bytes of device traffic, a little above
// the fp32 balance point only once the halo recompute is counted.  Design:
// one block per 32x32 output tile; the (32 + 2r + 2)^2 slab, the three
// gradient-product planes and their three W-pass planes all live in shared
// memory (38 KB at r = 3), so the seven intermediate maps the plain version
// writes never reach device memory.
#include "common.cuh"

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
harris_kernel(const float* __restrict__ x, float* __restrict__ out, int h,
              int w, int tiles_x, int tiles_y, Taps taps, float k,
              int shi_tomasi) {
  extern __shared__ float smem[];
  __shared__ float st[MAX_TAPS];
  const int n = taps.n, r = (n - 1) / 2;
  const int s = TILE + 2 * r + 2;  // slab side (pad r + 1)
  const int g = TILE + 2 * r;      // gradient side
  float* slab = smem;
  float* pxx = slab + s * s;
  float* pyy = pxx + g * g;
  float* pxy = pyy + g * g;
  float* rxx = pxy + g * g;        // g x TILE each, after the W pass
  float* ryy = rxx + g * TILE;
  float* rxy = ryy + g * TILE;
  const TileCoord c = tile_coord(tiles_x, tiles_y, TILE, TILE);
  const long long plane = static_cast<long long>(h) * w;
  load_taps(taps.t, n, st);
  load_slab(x + c.img * plane, h, w, c.y0, c.x0, r + 1, s, s, slab);
  __syncthreads();
  for (int i = threadIdx.x; i < g * g; i += blockDim.x) {
    const int yy = i / g, xx = i - yy * g;
    const float* q = slab + yy * s + xx;   // top-left of the 3x3 window
    // (sl(-1,1) + 2 sl(0,1) + sl(1,1) - sl(-1,-1) - 2 sl(0,-1) - sl(1,-1)) / 8
    float gx = __fadd_rn(q[2], __fmul_rn(2.f, q[s + 2]));
    gx = __fadd_rn(gx, q[2 * s + 2]);
    gx = __fsub_rn(gx, q[0]);
    gx = __fsub_rn(gx, __fmul_rn(2.f, q[s]));
    gx = __fdiv_rn(__fsub_rn(gx, q[2 * s]), 8.f);
    // (sl(1,-1) + 2 sl(1,0) + sl(1,1) - sl(-1,-1) - 2 sl(-1,0) - sl(-1,1)) / 8
    float gy = __fadd_rn(q[2 * s], __fmul_rn(2.f, q[2 * s + 1]));
    gy = __fadd_rn(gy, q[2 * s + 2]);
    gy = __fsub_rn(gy, q[0]);
    gy = __fsub_rn(gy, __fmul_rn(2.f, q[1]));
    gy = __fdiv_rn(__fsub_rn(gy, q[2]), 8.f);
    pxx[i] = __fmul_rn(gx, gx);
    pyy[i] = __fmul_rn(gy, gy);
    pxy[i] = __fmul_rn(gx, gy);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < g * TILE; i += blockDim.x) {
    const int yy = i / TILE, xx = i - yy * TILE;
    const int o = yy * g + xx;
    rxx[i] = tap_sum(st, n, pxx + o, 1);
    ryy[i] = tap_sum(st, n, pyy + o, 1);
    rxy[i] = tap_sum(st, n, pxy + o, 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TILE * TILE; i += blockDim.x) {
    const int oy = i / TILE, ox = i - oy * TILE;
    const int gy = c.y0 + oy, gx = c.x0 + ox;
    if (gy >= h || gx >= w) continue;
    const int o = oy * TILE + ox;
    const float ixx = tap_sum(st, n, rxx + o, TILE);
    const float iyy = tap_sum(st, n, ryy + o, TILE);
    const float ixy = tap_sum(st, n, rxy + o, TILE);
    float res;
    if (shi_tomasi) {
      const float half_tr = __fmul_rn(0.5f, __fadd_rn(ixx, iyy));
      const float d = __fsub_rn(ixx, iyy);
      const float q = __fadd_rn(__fmul_rn(0.25f, __fmul_rn(d, d)),
                                __fmul_rn(ixy, ixy));
      res = __fsub_rn(half_tr, __fsqrt_rn(fmaxf(q, 0.f)));
    } else {
      const float det = __fsub_rn(__fmul_rn(ixx, iyy), __fmul_rn(ixy, ixy));
      const float tr = __fadd_rn(ixx, iyy);
      res = __fsub_rn(det, __fmul_rn(__fmul_rn(k, tr), tr));
    }
    out[c.img * plane + static_cast<long long>(gy) * w + gx] = res;
  }
}

}  // namespace

DIFET_EXPORT int difet_harris(const float* x, float* out, long long n, int h,
                              int w, const float* taps_host, int n_taps,
                              float k, int shi_tomasi, void* stream) {
  if (n_taps < 1 || n_taps > MAX_TAPS || n_taps % 2 == 0 || h < 1 || w < 1)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  Taps taps;
  taps.n = n_taps;
  for (int i = 0; i < n_taps; ++i) taps.t[i] = taps_host[i];
  const int r = (n_taps - 1) / 2;
  const int s = TILE + 2 * r + 2, g = TILE + 2 * r;
  const size_t smem =
      sizeof(float) * static_cast<size_t>(s * s + 3 * g * g + 3 * g * TILE);
  const int tiles_x = ceil_div(w, TILE), tiles_y = ceil_div(h, TILE);
  const long long blocks = n * tiles_x * tiles_y;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t e = allow_smem(harris_kernel, smem);
  if (e != cudaSuccess) return e;
  harris_kernel<<<static_cast<unsigned>(blocks), THREADS, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      x, out, h, w, tiles_x, tiles_y, taps, k, shi_tomasi);
  return cudaGetLastError();
}
