// Brute-force descriptor matcher: per query, the best and second-best
// distance over a masked database and the index of the best.
//
// difet_match replaces both Pallas matcher kernels of repro/kernels/matcher.py,
// match_kernel (the database resident in VMEM) and stream_kernel (the
// database streamed in chunks), with one kernel launch per call (plus, where
// the database is cut into segments, one memset of the segment tickets).
//
// Layout.  A block takes a tile of BQ = 128 queries and one segment of the
// database: the 64-row windows g, g + n_seg, g + 2 n_seg, ... (the caller's
// launch plan, kernels/matcher.py::plan), dealt round robin so that a
// database whose valid rows come first (a top-K list) still spreads over
// every segment.  Its 256 threads form a 16 x 16 grid: thread (tq, tr) owns
// the TM = 8 queries tq + 16 m and, in every chunk, the TN rows tr + 16 n, a
// register tile of TM x TN (query, row) pairs fed by TM + TN shared loads of
// 16 bytes per four words or dimensions (Cfg: 8 x 8 for L2, 8 x 4 for
// Hamming).  The query tile stays in shared memory for the block's life;
// database chunks of BR = 16 TN rows stream through two shared buffers,
// filled by 16-byte cp.async (4-byte where rows are not 16-byte aligned)
// while the other buffer is computed on.  Shared rows are WP + 4 words
// apart: (WP + 4) / 4 is odd, so the eight rows a quarter warp reads at once
// lie in eight distinct bank quads, and its eight query loads are one
// broadcast.
//
// Masked rows cost no arithmetic.  Before a chunk is staged the block
// compacts its segment's valid rows, in database order, into a ring of row
// indices (compact: a warp ballot over 32 flags, popc for a lane's rank, one
// warp's scan for the offsets of 32 ballots), and a chunk is the ring's next
// BR indices.  Every chunk but a segment's last is full of valid rows; in
// the last, the row slots past its end are skipped (scan_chunk<true>).
//
// Ties.  A thread pushes its rows of each query in increasing database index
// with the reference's strictly-less update (push: keeps the first minimum, a
// tied minimum makes second == best).  Threads, and then segments, merge
// with the lexicographic rule on (distance, index) (merge), which gives the
// reference's in-order result for any partition of the database, so blocks
// may finish in any order.  With one segment a block writes the final
// triple.  With several, each block writes its partial triples; the last
// block of a query tile to finish (an atomic ticket per tile after a
// __threadfence; the C entry zeroes the tickets on the caller's stream)
// merges the tile's partials and writes the final triple.  No state lives
// across calls, so calls on two streams cannot race.
//
// Distances:
//   Hamming: W packed 32-bit words per descriptor (int32 in PyTorch, read as
//     uint32_t), XOR + __popc, an exact int.  Masked rows are 1 << 30.
//   L2: ranks on |k|^2 - 2 q.k and adds |q|^2 once at the end, as the
//     reference does.  q.k is one fp32 fmaf chain over d = 0 .. D - 1 per
//     pair (no TF32, no library product); |k|^2 is one warp per staged row,
//     lane-strided fmaf chains then a butterfly of _rn adds; |q|^2 one fmaf
//     chain.  Masked rows are +inf.
// Words or dimensions past W or D are zero in shared memory and add nothing.
//
// Bound on Hopper: operations.  Each (query, valid row) pair costs W
// popcounts (Hamming) or D FMAs (L2).  __popc runs at 16 per clock per SM on
// compute capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
// throughput), an eighth of the fp32 FMA rate, so popcounts bound Hamming and
// FMAs bound L2.  The Hamming tile needs 1.5 bytes of shared memory per
// popcount, far below what the SM delivers; the L2 tile needs 1 byte per
// FMA, exactly the 128 bytes per clock an SM delivers at 128 FMAs per clock,
// so L2 runs at about half its FMA bound with both units half busy (its
// unrolled loop is 1024 FFMA, 64 LDS.128 and 8 other instructions per four
// dimensions).  Each database row is read from device memory once per query
// tile.
#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int NT = 256;             // threads per block
constexpr int NTR = 16;             // threads along a chunk's rows
constexpr int NTQ = NT / NTR;       // threads along the queries
constexpr int TM = 8;               // queries per thread
constexpr int BQ = TM * NTQ;        // queries per block (matcher.py QBLOCK)
constexpr int WIN = 64;             // rows per window (matcher.py WINDOW)
constexpr int SCAN = 4 * NT;        // validity flags per compaction step
constexpr int RING = 2048;          // compacted row indices held at once
constexpr int BIG_HAMMING = 1 << 30;
static_assert((NT / 32) * (SCAN / NT) == 32,
              "one warp scans the ballot counts of a compaction step");
static_assert(SCAN % WIN == 0 && WIN % 32 == 0,
              "a warp's flags share a window");

// L2 takes 8 rows a thread (128-row chunks): the 8 x 8 tile loads one byte
// of shared memory per FMA, the SM's 128 bytes per clock at its 128 FMAs per
// clock (an 8 x 4 tile would need 1.5).  Hamming takes 4 (64-row chunks): at
// 16 popcounts per clock its 1.5 bytes each are far below the SM's rate, and
// the smaller tile leaves room for two blocks an SM.
template <bool L2, int WP>
struct Cfg {
  using T = typename std::conditional<L2, float, uint32_t>::type;  // element
  using V = typename std::conditional<L2, float4, uint4>::type;    // 16 bytes
  using D = typename std::conditional<L2, float, int>::type;       // distance
  static constexpr int TN = L2 ? 8 : 4;     // rows per thread and chunk
  static constexpr int BR = TN * NTR;       // rows per chunk (matcher.py CHUNK)
  static constexpr int P = WP + 4;          // row pitch
  static_assert(WP % 4 == 0 && (P / 4) % 2 == 1, "odd number of bank quads");
  static_assert(RING >= BR - 1 + SCAN && (RING & (RING - 1)) == 0,
                "the ring holds a chunk's leftovers and one compaction step");
  // queries, two row buffers, |k|^2 and row indices of both buffers, the
  // ring, and the compaction counts (32 counts, 32 offsets, total, flag)
  static constexpr size_t SMEM = sizeof(T) * (BQ + 2 * BR) * P +
                                 sizeof(float) * 2 * BR +
                                 sizeof(int) * (2 * BR + RING + 68);
};

struct Args {
  const void* q;        // [nq, w]
  const void* db;       // [nk, w]
  const int* valid;     // [nk]
  int nq, nk, w;
  int n_seg;            // the launch plan: segment g holds windows g + i n_seg
  bool vec;             // rows may be copied 16 bytes at a time
  int* out;             // [3, nq]: best, second (int, or fp32 bits), idx
  int* tickets;         // [query tiles], zero at launch (n_seg > 1)
  int* part;            // [3, n_seg, nq] partial triples (n_seg > 1)
};

template <typename D>
__device__ __forceinline__ D big_of();
template <>
__device__ __forceinline__ int big_of<int>() { return BIG_HAMMING; }
template <>
__device__ __forceinline__ float big_of<float>() { return INFINITY; }

// One row after the other, in increasing database index: the reference's
// strictly-less running update.
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

// Two triples over disjoint rows, in either order: lexicographic on
// (distance, index), the second the smaller of the loser's best and the
// winner's second.
template <typename D>
__device__ __forceinline__ void merge(D cb, D cs, int ci, D& best, D& second,
                                      int& idx) {
  if (cb < best || (cb == best && ci < idx)) {
    second = best < cs ? best : cs;
    best = cb;
    idx = ci;
  } else if (cb < second) {
    second = cb;
  }
}

// Four words or dimensions of a pair, in order.
__device__ __forceinline__ float step(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ int step(int acc, uint4 a, uint4 b) {
  return acc + (__popc(a.x ^ b.x) + __popc(a.y ^ b.y)) +
         (__popc(a.z ^ b.z) + __popc(a.w ^ b.w));
}

// Rows row_of(0 .. n - 1) of src [., w] into dst (pitch P), columns [0, w).
template <int WP, int P, typename T, typename RowOf>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src,
                                           int w, int n, bool vec,
                                           RowOf row_of) {
  if (vec) {
    constexpr int PR = WP / 4;            // 16-byte pieces of a padded row
    const int pr = w >> 2;
    for (int i = threadIdx.x; i < n * PR; i += NT) {
      const int r = i / PR, c = i - r * PR;
      if (c < pr)
        cp_async16(reinterpret_cast<float*>(dst + r * P + 4 * c),
                   reinterpret_cast<const float*>(
                       src + static_cast<long long>(row_of(r)) * w + 4 * c));
    }
  } else {
    for (int i = threadIdx.x; i < n * WP; i += NT) {
      const int r = i / WP, c = i - r * WP;
      if (c < w)
        cp_async4(reinterpret_cast<float*>(dst + r * P + c),
                  reinterpret_cast<const float*>(
                      src + static_cast<long long>(row_of(r)) * w + c));
    }
  }
}

// Appends the valid rows of the segment's windows i0 .. i0 + SCAN / WIN - 1
// (global windows g + i n_seg of WIN rows) to the ring at position tail, in
// order, and returns how many.  Flag k NT + t is thread t's k-th, so
// (k, warp, lane) order is the segment's row order.  Ends with a barrier: the
// ring is complete for every thread.
__device__ __forceinline__ int compact(const int* __restrict__ valid, int nk,
                                       int g, int n_seg, int i0, int tail,
                                       int* ring, int* cnt) {
  constexpr int K = SCAN / NT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool f[K];
  int row[K];
  unsigned b[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = k * NT + threadIdx.x;
    const long long r =
        (g + static_cast<long long>(i0 + i / WIN) * n_seg) * WIN + i % WIN;
    row[k] = static_cast<int>(r < nk ? r : 0);
    f[k] = r < nk && valid[row[k]] != 0;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    b[k] = __ballot_sync(0xffffffffu, f[k]);
    if (lane == 0) cnt[k * (NT / 32) + warp] = __popc(b[k]);
  }
  __syncthreads();
  if (warp == 0) {
    const int c = cnt[lane];
    int x = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    cnt[32 + lane] = x - c;
    if (lane == 31) cnt[64] = x;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (f[k])
      ring[(tail + cnt[32 + k * (NT / 32) + warp] + __popc(b[k] & below)) &
           (RING - 1)] = row[k];
  const int total = cnt[64];
  __syncthreads();
  return total;
}

// |k|^2 of the n staged rows, one warp a row: lane-strided fmaf chains and a
// butterfly of _rn adds.  A warp takes four rows at once (RN independent
// chains), so the shuffles' latency is paid once per four rows.
template <int WP, int P>
__device__ __forceinline__ void row_norms(const float* rows, int n, float* dn) {
  constexpr int NW = NT / 32, RN = 4;
  const int lane = threadIdx.x & 31;
  for (int r0 = threadIdx.x >> 5; r0 < n; r0 += RN * NW) {
    float acc[RN];
#pragma unroll
    for (int u = 0; u < RN; ++u) {
      acc[u] = 0.f;
      const int r = min(r0 + u * NW, n - 1);
#pragma unroll
      for (int c = lane; c < WP; c += 32) {
        const float v = rows[r * P + c];
        acc[u] = fmaf(v, v, acc[u]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < RN; ++u)
        acc[u] = __fadd_rn(acc[u], __shfl_xor_sync(0xffffffffu, acc[u], off));
    if (lane == 0)
#pragma unroll
      for (int u = 0; u < RN; ++u)
        if (r0 + u * NW < n) dn[r0 + u * NW] = acc[u];
  }
}

// The thread's TM x TN pairs of one staged chunk of n rows, pushed into its
// queries' triples in row order.  PARTIAL skips the row slots past n.
template <bool L2, int WP, bool PARTIAL>
__device__ __forceinline__ void scan_chunk(
    const typename Cfg<L2, WP>::T* qs, const typename Cfg<L2, WP>::T* rows,
    const int* rid, const float* dn, int n, int tq, int tr,
    typename Cfg<L2, WP>::D (&best)[TM], typename Cfg<L2, WP>::D (&second)[TM],
    int (&idx)[TM]) {
  using C = Cfg<L2, WP>;
  using T = typename C::T;
  using V = typename C::V;
  using D = typename C::D;
  constexpr int P = C::P, TN = C::TN;
  const int slots = PARTIAL ? (n + NTR - 1) / NTR : TN;
  D acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[m][j] = D(0);
  const T* qa = qs + tq * P;
  const T* rb = rows + tr * P;
#pragma unroll 4
  for (int v = 0; v < WP / 4; ++v) {
    V b[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j)
      if (!PARTIAL || j < slots)
        b[j] = *reinterpret_cast<const V*>(rb + j * NTR * P + 4 * v);
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const V a = *reinterpret_cast<const V*>(qa + m * NTQ * P + 4 * v);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (!PARTIAL || j < slots) acc[m][j] = step(acc[m][j], a, b[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int r = tr + NTR * j;
    if (r < n) {
      const int k = rid[r];
      float dnr = 0.f;
      if constexpr (L2) dnr = dn[r];
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        D d;
        if constexpr (L2)
          d = __fsub_rn(dnr, __fmul_rn(2.f, acc[m][j]));
        else
          d = acc[m][j];
        push(d, k, best[m], second[m], idx[m]);
      }
    }
  }
}

template <bool L2, int WP>
__global__ void __launch_bounds__(NT, L2 ? 1 : 2) match_kernel(const Args a) {
  using C = Cfg<L2, WP>;
  using T = typename C::T;
  using D = typename C::D;
  constexpr int P = C::P, BR = C::BR;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* rs = qs + BQ * P;                                  // 2 x [BR, P]
  float* dns = reinterpret_cast<float*>(rs + 2 * BR * P);
  int* rid = reinterpret_cast<int*>(dns + 2 * BR);
  int* ring = rid + 2 * BR;
  int* cnt = ring + RING;

  const int tid = threadIdx.x, tq = tid / NTR, tr = tid % NTR;
  const int q0 = blockIdx.x * BQ, nqt = min(BQ, a.nq - q0);
  // segment g = blockIdx.y holds the windows g, g + n_seg, ... of the database
  const int g = blockIdx.y;
  const int nw =
      static_cast<int>((static_cast<long long>(a.nk) + WIN - 1) / WIN);
  const int seg_windows = g < nw ? (nw - g + a.n_seg - 1) / a.n_seg : 0;
  const T* db = static_cast<const T*>(a.db);

  // words or dimensions past w are zero in every staged row, for good
  const int pad = WP - a.w;
  if (pad > 0)
    for (int i = tid; i < (BQ + 2 * BR) * pad; i += NT) {
      const int r = i / pad;
      qs[r * P + a.w + i - r * pad] = T(0);
    }
  const T* q = static_cast<const T*>(a.q) + static_cast<long long>(q0) * a.w;
  stage_rows<WP, P>(qs, q, a.w, nqt, a.vec, [](int r) { return r; });

  int head = 0, tail = 0, scanned = 0;     // windows of the segment compacted
  auto fill = [&] {
    while (tail - head < BR && scanned < seg_windows) {
      tail += compact(a.valid, a.nk, g, a.n_seg, scanned, tail, ring, cnt);
      scanned += SCAN / WIN;
    }
  };
  // stages the ring's next chunk into buffer b (one cp.async group) and
  // returns its row count
  auto next = [&](int b) {
    const int n = min(BR, tail - head);
    if (tid < n) rid[b * BR + tid] = ring[(head + tid) & (RING - 1)];
    const int h = head;
    stage_rows<WP, P>(rs + b * BR * P, db, a.w, n, a.vec,
                      [&](int r) { return ring[(h + r) & (RING - 1)]; });
    cp_async_commit();
    head += n;
    return n;
  };

  D best[TM], second[TM];
  int idx[TM];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    best[m] = second[m] = big_of<D>();
    idx[m] = 0;
  }
  fill();
  int n = next(0);                    // the queries ride in this group too
  int buf = 0;
  while (n > 0) {
    fill();
    const int n_next = next(buf ^ 1);
    cp_async_wait<1>();
    __syncthreads();
    const T* rows = rs + buf * BR * P;
    if constexpr (L2) {
      row_norms<WP, P>(rows, n, dns + buf * BR);
      __syncthreads();
    }
    if (n == BR)
      scan_chunk<L2, WP, false>(qs, rows, rid + buf * BR, dns + buf * BR, n, tq,
                                tr, best, second, idx);
    else
      scan_chunk<L2, WP, true>(qs, rows, rid + buf * BR, dns + buf * BR, n, tq,
                               tr, best, second, idx);
    __syncthreads();
    buf ^= 1;
    n = n_next;
  }
  cp_async_wait<0>();

  // the 16 threads of a query group hold disjoint rows of its queries
#pragma unroll
  for (int o = 1; o < NTR; o <<= 1)
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const D cb = __shfl_xor_sync(0xffffffffu, best[m], o);
      const D cs = __shfl_xor_sync(0xffffffffu, second[m], o);
      const int ci = __shfl_xor_sync(0xffffffffu, idx[m], o);
      merge(cb, cs, ci, best[m], second[m], idx[m]);
    }
  __syncthreads();                    // the row buffers are free
  D* sb = reinterpret_cast<D*>(rs);
  D* ss = sb + BQ;
  int* si = reinterpret_cast<int*>(ss + BQ);
  if (tr == 0)
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const int i = tq + NTQ * m;
      sb[i] = best[m];
      ss[i] = second[m];
      si[i] = idx[m];
    }
  __syncthreads();

  // the final triple of query q0 + i, |q|^2 folded in for L2
  auto finish = [&](int i, D b, D s, int x) {
    if constexpr (L2) {
      float qn = 0.f;
      const float* qr = qs + i * P;
#pragma unroll 8
      for (int v = 0; v < WP / 4; ++v) {
        const float4 t = *reinterpret_cast<const float4*>(qr + 4 * v);
        qn = fmaf(t.x, t.x, qn);
        qn = fmaf(t.y, t.y, qn);
        qn = fmaf(t.z, t.z, qn);
        qn = fmaf(t.w, t.w, qn);
      }
      b = __fadd_rn(b, qn);
      s = __fadd_rn(s, qn);
    }
    const int o = q0 + i;
    reinterpret_cast<D*>(a.out)[o] = b;
    reinterpret_cast<D*>(a.out)[a.nq + o] = s;
    a.out[2LL * a.nq + o] = x;
  };

  if (a.n_seg == 1) {
    for (int i = tid; i < nqt; i += NT) finish(i, sb[i], ss[i], si[i]);
    return;
  }
  const long long plane = static_cast<long long>(a.n_seg) * a.nq;
  D* pb = reinterpret_cast<D*>(a.part);
  D* ps = reinterpret_cast<D*>(a.part + plane);
  int* pi = a.part + 2 * plane;
  for (int i = tid; i < nqt; i += NT) {
    const long long o = static_cast<long long>(blockIdx.y) * a.nq + q0 + i;
    pb[o] = sb[i];
    ps[o] = ss[i];
    pi[o] = si[i];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) cnt[65] = atomicAdd(a.tickets + blockIdx.x, 1) == a.n_seg - 1;
  __syncthreads();
  if (!cnt[65]) return;
  __threadfence();                    // the other segments' partials
  for (int i = tid; i < nqt; i += NT) {
    D b = big_of<D>(), s = big_of<D>();
    int x = 0;
#pragma unroll 4
    for (int g = 0; g < a.n_seg; ++g) {
      const long long o = static_cast<long long>(g) * a.nq + q0 + i;
      merge(__ldcg(pb + o), __ldcg(ps + o), __ldcg(pi + o), b, s, x);
    }
    finish(i, b, s, x);
  }
}

template <bool L2, int WP>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const cudaError_t e = allow_smem(match_kernel<L2, WP>, Cfg<L2, WP>::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid(ceil_div(a.nq, BQ), a.n_seg);
  match_kernel<L2, WP><<<grid, NT, Cfg<L2, WP>::SMEM, s>>>(a);
  return cudaGetLastError();
}

template <bool L2, int WP>
cudaError_t occupancy(int* blocks) {
  const cudaError_t e = allow_smem(match_kernel<L2, WP>, Cfg<L2, WP>::SMEM);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, match_kernel<L2, WP>, NT, Cfg<L2, WP>::SMEM);
}

bool bad_width(int w, int l2) { return w < 1 || w > (l2 ? 128 : 16); }

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// out: [3, nq] int32 (best, second, idx; L2 distances as fp32 bits).
// scratch: with n_seg > 1, ceil(nq / 128) tickets then the [3, n_seg, nq]
// partial triples (int32); unused with one segment.
DIFET_EXPORT int difet_match(const void* q, const void* db, const int* valid,
                             int nq, int nk, int w, int l2, int* out,
                             int n_seg, int* scratch,
                             void* stream) {
  if (nq < 1 || nk < 0 || nk > INT_MAX - SCAN || bad_width(w, l2) ||
      n_seg < 1 || n_seg > 65535 ||
      (n_seg > 1 && scratch == nullptr))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const int tiles = ceil_div(nq, BQ);
  Args a{q, db, valid, nq, nk, w, n_seg,
         w % 4 == 0 && aligned16(q) && aligned16(db), out, scratch,
         scratch == nullptr ? nullptr : scratch + tiles};
  if (n_seg > 1) {
    const cudaError_t e = cudaMemsetAsync(scratch, 0, sizeof(int) * tiles, s);
    if (e != cudaSuccess) return e;
  }
  if (!l2) return w <= 8 ? launch<false, 8>(a, s) : launch<false, 16>(a, s);
  return w <= 64 ? launch<true, 64>(a, s) : launch<true, 128>(a, s);
}

// Blocks of the kernel for (metric, width) that one SM holds at once.
DIFET_EXPORT int difet_match_blocks_per_sm(int l2, int w, int* blocks) {
  if (bad_width(w, l2) || blocks == nullptr) return cudaErrorInvalidValue;
  if (!l2)
    return w <= 8 ? occupancy<false, 8>(blocks) : occupancy<false, 16>(blocks);
  return w <= 64 ? occupancy<true, 64>(blocks) : occupancy<true, 128>(blocks);
}
