// Brute-force descriptor matcher: per query, the best and second-best
// distance over a masked database and the index of the best.
//
// difet_match replaces both Pallas matcher kernels of repro/kernels/matcher.py,
// match_kernel (match_pallas) and stream_kernel (match_pallas_stream): one
// scan kernel over a grid of (query tile, database segment) blocks.  With a
// single segment each block scans the whole database for its QT queries and
// writes the final triple itself (the resident form); with more, a second
// launch merges the segments' partial triples.  The caller picks the segment
// count so that the grid fills the card.
//
// The TPU kernels carry (best, second, argbest) across a sequential grid;
// Hopper's blocks run in no order, so the carry lives in registers inside
// one block, and a reduction across blocks is a second pass (merge_kernel),
// which visits the segments in database order with the strictly-less rule
// of the reference's _merge_best2.  Inside a block each thread owns one
// query and walks its rows in increasing database index with
//   if d < best: second = best, best = d, idx = j;  else second = min(second, d)
// which yields the reference's triple exactly, ties and duplicates included
// (a tied minimum makes second == best).
//
// Distances:
//   Hamming: W packed 32-bit words per descriptor (int32 in PyTorch, read as
//     uint32_t), XOR + __popc, an exact int.  Masked rows are 1 << 30.
//   L2: ranks on |k|^2 - 2 q.k and adds |q|^2 once at the end, as the
//     reference does.  |k|^2 is computed once per database row
//     (row_norms); q.k is an fp32 FMA loop over D in this kernel's own
//     body (no TF32, no library product).  Masked rows are +inf.
// The query's words or dimensions sit in registers, zero-padded to the
// template width WP (0 ^ 0 and 0 * 0 add nothing); the ragged edges of the
// query batch and the database are masked here, so no padded copy exists.
//
// Bound on Hopper: operations.  Each (query, row) pair costs W popcounts
// (Hamming) or D FMAs (L2) against 4 W or 4 D bytes of a row that a whole
// query tile shares.  __popc runs at 16 per clock per SM on compute
// capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
// throughput), an eighth of the fp32 FMA rate of 128, so popcounts bound
// Hamming; fp32 FMAs bound L2.  The design feeds those units from shared
// memory by broadcast: every lane of a warp reads the same staged row at the
// same time (one 16-byte load per four words or dimensions), so the chunk
// costs no bank conflicts and each row is read from device memory once per
// query tile.  The streaming launch's segments give a few thousand queries
// enough blocks to fill all SMs.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int QT = 128;                 // queries per block, one per thread
constexpr int CH = 64;                  // database rows staged per chunk
constexpr int BIG_HAMMING = 1 << 30;

template <typename D>
__device__ __forceinline__ void push(D d, int j, D& best, D& second, int& idx) {
  if (d < best) {
    second = best;
    best = d;
    idx = j;
  } else if (d < second) {
    second = d;
  }
}

// Rows [k0, k1) of segment blockIdx.y for queries blockIdx.x * QT + tid.
// Writes (best, second, idx) at [blockIdx.y * nq + query]; with fold set
// (single segment, L2) |q|^2 is added before the write.
template <int WP>
__global__ void __launch_bounds__(QT)
hamming_scan(const uint32_t* __restrict__ q, const uint32_t* __restrict__ db,
             const int* __restrict__ valid, int nq, int nk, int w,
             int seg_rows, int* __restrict__ best_out,
             int* __restrict__ second_out, int* __restrict__ idx_out) {
  __shared__ __align__(16) uint32_t rows[CH * WP];
  __shared__ int ok[CH];
  const int qi = blockIdx.x * QT + threadIdx.x;
  const long long k0 = static_cast<long long>(blockIdx.y) * seg_rows;
  const long long k1 = min(static_cast<long long>(nk), k0 + seg_rows);
  uint32_t qw[WP];
#pragma unroll
  for (int c = 0; c < WP; ++c)
    qw[c] = (qi < nq && c < w) ? q[static_cast<long long>(qi) * w + c] : 0u;
  int best = BIG_HAMMING, second = BIG_HAMMING, idx = 0;
  for (long long c0 = k0; c0 < k1; c0 += CH) {
    const int n = static_cast<int>(min(static_cast<long long>(CH), k1 - c0));
    __syncthreads();
    for (int i = threadIdx.x; i < CH * WP; i += QT) {
      const int r = i / WP, c = i - (i / WP) * WP;
      rows[i] = (r < n && c < w) ? db[(c0 + r) * w + c] : 0u;
    }
    for (int i = threadIdx.x; i < CH; i += QT) ok[i] = i < n ? valid[c0 + i] : 0;
    __syncthreads();
    for (int r = 0; r < n; ++r) {
      const uint4* row = reinterpret_cast<const uint4*>(rows + r * WP);
      int d = 0;
#pragma unroll
      for (int v = 0; v < WP / 4; ++v) {
        const uint4 k = row[v];
        d += __popc(qw[4 * v] ^ k.x) + __popc(qw[4 * v + 1] ^ k.y) +
             __popc(qw[4 * v + 2] ^ k.z) + __popc(qw[4 * v + 3] ^ k.w);
      }
      push(ok[r] != 0 ? d : BIG_HAMMING, static_cast<int>(c0 + r), best,
           second, idx);
    }
  }
  if (qi < nq) {
    const long long o = static_cast<long long>(blockIdx.y) * nq + qi;
    best_out[o] = best;
    second_out[o] = second;
    idx_out[o] = idx;
  }
}

template <int WP>
__global__ void __launch_bounds__(QT)
l2_scan(const float* __restrict__ q, const float* __restrict__ db,
        const int* __restrict__ valid, const float* __restrict__ dn, int nq,
        int nk, int w, int seg_rows, bool fold, float* __restrict__ best_out,
        float* __restrict__ second_out, int* __restrict__ idx_out) {
  __shared__ __align__(16) float rows[CH * WP];
  __shared__ float dns[CH];
  __shared__ int ok[CH];
  const int qi = blockIdx.x * QT + threadIdx.x;
  const long long k0 = static_cast<long long>(blockIdx.y) * seg_rows;
  const long long k1 = min(static_cast<long long>(nk), k0 + seg_rows);
  float qf[WP];
#pragma unroll
  for (int c = 0; c < WP; ++c)
    qf[c] = (qi < nq && c < w) ? q[static_cast<long long>(qi) * w + c] : 0.f;
  float best = INFINITY, second = INFINITY;
  int idx = 0;
  for (long long c0 = k0; c0 < k1; c0 += CH) {
    const int n = static_cast<int>(min(static_cast<long long>(CH), k1 - c0));
    __syncthreads();
    for (int i = threadIdx.x; i < CH * WP; i += QT) {
      const int r = i / WP, c = i - (i / WP) * WP;
      rows[i] = (r < n && c < w) ? db[(c0 + r) * w + c] : 0.f;
    }
    for (int i = threadIdx.x; i < CH; i += QT) {
      ok[i] = i < n ? valid[c0 + i] : 0;
      dns[i] = i < n ? dn[c0 + i] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < n; ++r) {
      const float4* row = reinterpret_cast<const float4*>(rows + r * WP);
      float acc = 0.f;
#pragma unroll
      for (int v = 0; v < WP / 4; ++v) {
        const float4 k = row[v];
        acc = fmaf(qf[4 * v], k.x, acc);
        acc = fmaf(qf[4 * v + 1], k.y, acc);
        acc = fmaf(qf[4 * v + 2], k.z, acc);
        acc = fmaf(qf[4 * v + 3], k.w, acc);
      }
      const float d = ok[r] != 0 ? __fsub_rn(dns[r], __fmul_rn(2.f, acc))
                                 : INFINITY;
      push(d, static_cast<int>(c0 + r), best, second, idx);
    }
  }
  if (fold) {
    float qn = 0.f;
#pragma unroll
    for (int c = 0; c < WP; ++c) qn = fmaf(qf[c], qf[c], qn);
    best = __fadd_rn(best, qn);
    second = __fadd_rn(second, qn);
  }
  if (qi < nq) {
    const long long o = static_cast<long long>(blockIdx.y) * nq + qi;
    best_out[o] = best;
    second_out[o] = second;
    idx_out[o] = idx;
  }
}

// |k|^2 of every database row, one warp per row.
__global__ void __launch_bounds__(256)
row_norms(const float* __restrict__ db, int nk, int w, float* __restrict__ dn) {
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x +
                         threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (row >= nk) return;
  float acc = 0.f;
  for (int c = lane; c < w; c += 32) {
    const float v = db[row * w + c];
    acc = fmaf(v, v, acc);
  }
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) dn[row] = acc;
}

// Segments' partial triples -> the final triple, in database order.
template <typename D>
__global__ void __launch_bounds__(256)
merge_kernel(const D* __restrict__ pbest, const D* __restrict__ psecond,
             const int* __restrict__ pidx, int nq, int n_seg, D big,
             const float* __restrict__ q, int w, D* __restrict__ best_out,
             D* __restrict__ second_out, int* __restrict__ idx_out) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= nq) return;
  D best = big, second = big;
  int idx = 0;
  for (int s = 0; s < n_seg; ++s) {
    const long long o = static_cast<long long>(s) * nq + qi;
    const D cb = pbest[o], cs = psecond[o];
    if (cb < best) {
      second = best < cs ? best : cs;
      best = cb;
      idx = pidx[o];
    } else if (cb < second) {
      second = cb;
    }
  }
  if (q != nullptr) {                    // L2: fold |q|^2 in once
    float qn = 0.f;
    for (int c = 0; c < w; ++c) {
      const float v = q[static_cast<long long>(qi) * w + c];
      qn = fmaf(v, v, qn);
    }
    best = best + qn;
    second = second + qn;
  }
  best_out[qi] = best;
  second_out[qi] = second;
  idx_out[qi] = idx;
}

// One scan launch over grid (query tiles, n_seg), into the given triple.
cudaError_t scan(const void* q, const void* db, const int* valid,
                 const float* dn, int nq, int nk, int w, bool l2, int seg_rows,
                 int n_seg, bool fold, void* best, void* second, int* idx,
                 cudaStream_t s) {
  const dim3 grid(ceil_div(nq, QT), n_seg);
  const auto* qu = static_cast<const uint32_t*>(q);
  const auto* du = static_cast<const uint32_t*>(db);
  const auto* qf = static_cast<const float*>(q);
  const auto* df = static_cast<const float*>(db);
  auto* bi = static_cast<int*>(best);
  auto* si = static_cast<int*>(second);
  auto* bf = static_cast<float*>(best);
  auto* sf = static_cast<float*>(second);
  if (!l2 && w <= 8)
    hamming_scan<8><<<grid, QT, 0, s>>>(qu, du, valid, nq, nk, w, seg_rows, bi, si, idx);
  else if (!l2 && w <= 16)
    hamming_scan<16><<<grid, QT, 0, s>>>(qu, du, valid, nq, nk, w, seg_rows, bi, si, idx);
  else if (l2 && w <= 64)
    l2_scan<64><<<grid, QT, 0, s>>>(qf, df, valid, dn, nq, nk, w, seg_rows, fold, bf, sf, idx);
  else if (l2 && w <= 128)
    l2_scan<128><<<grid, QT, 0, s>>>(qf, df, valid, dn, nq, nk, w, seg_rows, fold, bf, sf, idx);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

cudaError_t norms(const float* db, int nk, int w, float* dn, cudaStream_t s) {
  if (nk == 0) return cudaSuccess;
  row_norms<<<ceil_div(static_cast<long long>(nk) * 32, 256), 256, 0, s>>>(
      db, nk, w, dn);
  return cudaGetLastError();
}

bool bad_args(int nq, int nk, int w, int l2) {
  return nq < 1 || nk < 0 || w < 1 || w > (l2 ? 128 : 16);
}

}  // namespace

DIFET_EXPORT int difet_match(const void* q, const void* db, const int* valid,
                             int nq, int nk, int w, int l2, float* dn,
                             void* best, void* second, int* idx, int seg_rows,
                             int n_seg, void* pbest, void* psecond, int* pidx,
                             void* stream) {
  if (bad_args(nq, nk, w, l2) || seg_rows < 1 || n_seg < 1 || n_seg > 65535 ||
      static_cast<long long>(seg_rows) * n_seg < nk)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (l2) {
    e = norms(static_cast<const float*>(db), nk, w, dn, s);
    if (e != cudaSuccess) return e;
  }
  if (n_seg == 1)                        // one segment: the final triple
    return scan(q, db, valid, dn, nq, nk, w, l2 != 0, seg_rows, 1, l2 != 0,
                best, second, idx, s);
  e = scan(q, db, valid, dn, nq, nk, w, l2 != 0, seg_rows, n_seg, false, pbest,
           psecond, pidx, s);
  if (e != cudaSuccess) return e;
  const int blocks = ceil_div(nq, 256);
  if (l2)
    merge_kernel<float><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(pbest), static_cast<const float*>(psecond),
        pidx, nq, n_seg, INFINITY, static_cast<const float*>(q), w,
        static_cast<float*>(best), static_cast<float*>(second), idx);
  else
    merge_kernel<int><<<blocks, 256, 0, s>>>(
        static_cast<const int*>(pbest), static_cast<const int*>(psecond), pidx,
        nq, n_seg, BIG_HAMMING, nullptr, w, static_cast<int*>(best),
        static_cast<int*>(second), idx);
  return cudaGetLastError();
}
