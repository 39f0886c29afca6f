// FAST-N corner score, fp32 [N, H, W] -> [N, H, W].
//
// Replaces the Pallas kernel repro/kernels/fastscore.py::fast_kernel.  Same
// function: reflect-pad by 3; each of the 16 Bresenham ring pixels is
// flagged brighter (v > centre + t) or darker (v < centre - t); a pixel is a
// corner if some run of >= arc consecutive ring pixels (circularly) is all
// brighter or all darker; the score is max(sum_brighter(|v - c| - t),
// sum_darker(|v - c| - t)), each sum taken in ring order from +0.0 with one
// rounding per operation, and +0.0 off corners.  Bit for bit the plain twin
// ref.fast_score.
//
// Bound on Hopper: memory, 8 bytes per output (one read, one write).  The
// full segment test is ~190 instructions an output, which would make the
// kernel instruction-bound; almost no pixel of a real scene is a corner, so
// most of it is skipped exactly:
//   - the compass early-out.  A circular run of L ring pixels holds at least
//     floor(L / 4) consecutive compass points (ring indices 0, 4, 8, 12):
//     the compass points are every fourth index, so any L consecutive
//     indices contain floor(L / 4) or ceil(L / 4) of them, and consecutive
//     ones.  So a pixel whose compass points have no circular run of
//     m = floor(arc / 4) brighter or darker ones (the wrapper's
//     compass_run) is no corner, and its score is +0.0.  The pre-test costs
//     5 values and 8 compares an output; only the pixels that pass it run
//     the full test (at arc <= 3, m = 0 and every pixel does);
//   - four outputs a thread along a row: the centre row and the two rows
//     three above and below are read as 16-byte vectors (5 for 4 outputs,
//     the compass points shared between neighbours), and the outputs are
//     stored as one float4 where the image allows;
//   - 64 x 64 output tiles with a 70 x 72 slab (the column halo rounded up
//     to 4, so slab rows stay 16-byte aligned), a persistent grid walking
//     the (image, tile) pairs, and a two-slab ring staged with cp.async, the
//     next tile landing while this one computes (common.cuh stage_slab:
//     16-byte copies inside an aligned image, reflecting 4-byte copies at
//     its edges, on an unaligned view and where W % 4 != 0).
// The flags of the full test are two 16-bit masks; the arc test is shifts
// and ANDs on the doubled mask.  40,320 B of shared memory a block.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TH = 64, TW = 64;              // output tile
constexpr int PAD = 3;                       // ring radius
constexpr int RA = 4;                        // column halo, a multiple of 4
constexpr int SH = TH + 2 * PAD;             // 70 slab rows
constexpr int SW = TW + 2 * RA;              // 72 slab columns
constexpr int RW = 4;                        // outputs of an item, one float4
constexpr int GROUPS = TW / RW;              // items of a tile row
constexpr int ITEMS = TH * GROUPS / THREADS; // items of a thread, per tile
constexpr size_t SMEM = sizeof(float) * 2 * SH * SW;

// repro/core/detectors.py FAST_OFFSETS in ring order, (dy + 3, dx + 3) as
// the k-th hex digit from the right
constexpr unsigned long long kRingDY = 0x0123456665432100ull;
constexpr unsigned long long kRingDX = 0x2100012345666543ull;

__device__ __forceinline__ constexpr int ring_offset(int k) {
  return (static_cast<int>((kRingDY >> (4 * k)) & 15) - PAD) * SW +
         static_cast<int>((kRingDX >> (4 * k)) & 15) - PAD;
}

// true if the circular `bits`-bit mask m has a run of >= len set bits
// (always for len 0)
__device__ __forceinline__ bool has_run(unsigned m, int bits, int len) {
  const unsigned d = m | (m << bits);
  unsigned run = d;
  for (int j = 1; j < len; ++j) run &= d >> j;
  return len == 0 || (run & ((1u << bits) - 1u)) != 0;
}

// The full segment test of the pixel at slab position p, in ring order.
__device__ __forceinline__ float segment_score(const float* p, float t,
                                               int arc) {
  const float c = p[0];
  const float hi = __fadd_rn(c, t), lo = __fsub_rn(c, t);
  unsigned bright = 0, dark = 0;
  float sb = 0.f, sd = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float v = p[ring_offset(k)];
    const bool b = v > hi, d = v < lo;
    const float diff = __fsub_rn(fabsf(__fsub_rn(v, c)), t);
    bright |= static_cast<unsigned>(b) << k;
    dark |= static_cast<unsigned>(d) << k;
    sb = __fadd_rn(sb, b ? diff : 0.f);
    sd = __fadd_rn(sd, d ? diff : 0.f);
  }
  return has_run(bright, 16, arc) || has_run(dark, 16, arc) ? fmaxf(sb, sd)
                                                            : 0.f;
}

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}

__global__ void __launch_bounds__(THREADS)
fast_tiled(const float* __restrict__ x, float* __restrict__ out, int h, int w,
           int tiles_x, int tiles, int n_tiles, int vec, int vec_out,
           float t, int arc, int m) {
  extern __shared__ __align__(16) float smem[];
  const long long plane = static_cast<long long>(h) * w;
  // bit q: the compass flags q (bit j = compass point j) hold a circular run
  // of >= m, so the pixel may be a corner
  unsigned may = 0;
  for (unsigned q = 0; q < 16; ++q)
    may |= static_cast<unsigned>(has_run(q, 4, m)) << q;

  auto stage = [&](TileOrigin o, float* slab) {
    stage_slab<SH, SW>(x + o.img * plane, h, w, o.y0 - PAD, o.x0 - RA,
                       vec != 0, slab);
  };

  int tile = blockIdx.x;
  TileOrigin cur = tile_origin<TH, TW>(tile, tiles_x, tiles);
  if (tile < n_tiles) stage(cur, smem);
  cp_async_commit();
  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    const float* slab = smem + (it & 1) * SH * SW;
    const TileOrigin next =
        tile_origin<TH, TW>(tile + gridDim.x, tiles_x, tiles);
    if (tile + gridDim.x < n_tiles)
      stage(next, smem + ((it + 1) & 1) * SH * SW);
    cp_async_commit();
    cp_async_wait<1>();   // this tile's slab has landed
    __syncthreads();

#pragma unroll 1
    for (int k = 0; k < ITEMS; ++k) {
      const int i = threadIdx.x + k * THREADS;
      const int oy = i / GROUPS, ox = (i % GROUPS) * RW;
      const int gy = cur.y0 + oy, gx = cur.x0 + ox;
      if (gy >= h || gx >= w) continue;
      // r: image columns gx - 4 .. gx + 7 of row gy; up, dn: columns
      // gx .. gx + 3 of rows gy - 3 and gy + 3
      const float* row = slab + (oy + PAD) * SW + ox;
      float r[12], up[4], dn[4];
      load4(row, r);
      load4(row + 4, r + 4);
      load4(row + 8, r + 8);
      load4(row - PAD * SW + RA, up);
      load4(row + PAD * SW + RA, dn);
      unsigned pass = 0;
#pragma unroll
      for (int e = 0; e < RW; ++e) {
        const float c = r[RA + e];
        const float hi = __fadd_rn(c, t), lo = __fsub_rn(c, t);
        // compass points 0, 4, 8, 12: (-3, 0), (0, 3), (3, 0), (0, -3)
        const float n = up[e], east = r[RA + e + 3], s = dn[e],
                    west = r[RA + e - 3];
        const unsigned b = (n > hi) | (east > hi) << 1 | (s > hi) << 2 |
                           (west > hi) << 3;
        const unsigned d = (n < lo) | (east < lo) << 1 | (s < lo) << 2 |
                           (west < lo) << 3;
        pass |= ((may >> b | may >> d) & 1u) << e;
      }
      float score[RW] = {0.f, 0.f, 0.f, 0.f};
      while (pass) {
        const int e = __ffs(pass) - 1;
        pass &= pass - 1;
        const float v = segment_score(row + RA + e, t, arc);
#pragma unroll
        for (int j = 0; j < RW; ++j) score[j] = j == e ? v : score[j];
      }
      float* o = out + cur.img * plane + static_cast<long long>(gy) * w + gx;
      if (vec_out && gx + RW <= w) {
        *reinterpret_cast<float4*>(o) =
            make_float4(score[0], score[1], score[2], score[3]);
      } else {
#pragma unroll
        for (int j = 0; j < RW; ++j)
          if (gx + j < w) o[j] = score[j];
      }
    }
    __syncthreads();   // every thread is done with this slab before the
                       // next iteration stages into it
    cur = next;
  }
}

}  // namespace

// `compass_run` is the wrapper's m = floor(arc / 4) (kernels/fastscore.py
// compass_run); a larger one could zero a corner and is refused.  The slab
// is staged with 16-byte copies where x's rows may be read as 16-byte
// vectors (w % 4 == 0, x 16-byte aligned), and the outputs stored as float4
// where out's rows may be written so.
DIFET_EXPORT int difet_fast(const float* x, float* out, long long n, int h,
                            int w, float threshold, int arc, int compass_run,
                            void* stream) {
  if (arc < 1 || arc > 16 || h < 1 || w < 1 || compass_run < 0 ||
      4 * compass_run > arc)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int vec = w % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int vec_out =
      w % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int tiles_x = ceil_div(w, TW);
  const long long tiles = static_cast<long long>(tiles_x) * ceil_div(h, TH);
  int blocks = 0;
  cudaError_t e = allow_smem(fast_tiled, SMEM);
  if (e == cudaSuccess)
    e = persistent_blocks(fast_tiled, THREADS, SMEM, n * tiles, &blocks);
  if (e != cudaSuccess) return e;
  fast_tiled<<<blocks, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      x, out, h, w, tiles_x, static_cast<int>(tiles),
      static_cast<int>(n * tiles), vec, vec_out, threshold, arc, compass_run);
  return cudaGetLastError();
}
