// PolyFit two-key whole-log scan kernels for Hopper (sm_90a), float64: the
// buffered two-key corrections of the 'cuda_scan' backend.
//
// K18 delta_count2d_kernel          replaces repro/kernels/delta_scan.py:delta_count2d_pallas
// K19 delta_sum2d_kernel            replaces repro/kernels/delta_scan.py:delta_sum2d_pallas
// K20 delta_dommax2d_kernel + chunk_max_combine_kernel (scan_tile.cuh)
//                                   replaces repro/kernels/delta_scan.py:delta_dommax2d_pallas
//
// Twins of the plain versions in repro_torch/kernels/delta_scan.py.  Where
// K9-K11 (delta2d.cu) walk the log's merge-sort tree, these test the
// queries against the slots of the x-sorted, sentinel-padded point log:
//
//   K18  the number of logged points with lx < x <= ux and ly < y <= uy,
//        counted in float64 (exact below 2^53 slots);
//   K19  the sum of their measures, added in slot order (the plain version
//        adds in the same order, so the two agree bit for bit), from the
//        slots of each rectangle's x range only;
//   K20  the max measure of the logged points with x <= u and y <= v, -inf
//        when none is dominated; a NaN measure among them gives NaN, as
//        the reference's jnp.max does.
//
// Sentinel slots hold the sentinel in both coordinates and measure 0, so
// they fail every membership test below the sentinel.  The reference sums
// a one-hot matmul over tiles of 512 slots; a count and a max are exact in
// any order, and the sum of K19 is held to the plain version in slot
// order.
//
// What bounds them on an H100: operations.  K18 does 4 compares and an add
// a (query, slot) pair: at Q = 65,536 against a 4,096-slot log about
// 1.3e9 f64 operations, about 0.04 ms at the FP64 peak; the bytes (the
// queries, the log once and the answers) about 2.7 MB, under a
// microsecond.  Its design: one thread a query, the log in tiles of 256
// slots staged through shared memory (the log read once a block from L2),
// one compare-and-select chain a thread.
//
// K19 ran K18's design (with an add of the measure) until it was
// redesigned: 7.0 (query, live slot) pairs a clock an SM, 0.108-0.137 ms
// on a 4,096-slot log whatever its fill.  On the x-sorted log the slots
// with lx < x <= ux are one range [a, b) of two binary searches, so only
// the y tests and the add are left on the slots of that range, and the
// OSM-like rectangles of chip_smoke.py's osm_sum_dyn span about 7.5% of a
// log's live slots (tools/k13_k19_rates.py).  Its design
// (delta_sum2d_kernel below):
//   - each query's [a, b) from two searches of the x keys (L1-resident),
//     a = #(x <= lx) (the log's size for a NaN lx: no slot passes it) and
//     b = #(x <= ux), cut at the sentinel tail; the x test becomes the
//     integer test a <= j < b on the slot's index;
//   - the block's 256 queries are bucketed by a in shared memory, so a
//     warp's 32 are neighbours in a and the union of their ranges is
//     narrow (tools/k13_k19_rates.py prints the mean union with and
//     without the buckets); the union's slots are staged once ((y, w), 16
//     bytes a slot, by cp.async) and each warp walks only its own union,
//     every lane reading the same slot;
//   - the walk forms 8 slots' contributions (scan_tile.cuh rank_member:
//     two integer and two f64 compares, a select) before their 8 adds, so
//     the chain of adds is all that is serial.  A predicated add a slot
//     (the first form) tied each slot's loads and compares into that
//     chain: 0.063 ms against 0.033 at the same shape (two calls of the
//     tool);
//   - one query a thread, no chunks: the slot order of each sum allows no
//     split of its range, and a chunked form (sums of 4 slot ranges added
//     in range order, which rounds otherwise) ran slower, 0.045 ms.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/k13_k19_rates.py,
// Q = 65,536): 0.0334 ms on an insert log of 3,072 live slots (0.1079
// before), 0.0172 on a delete log of 1,024 (0.1084), 0.0417 on a full log
// (0.1086); without the buckets 0.079; one rectangle over the whole plane
// among the 65,536 (its warp walks every live slot): 0.0391.
//
// K20 does 3 compares a (query, live slot) pair (two for dominance, one
// for the max): 8.05e8 f64 operations at Q = 65,536 against 4,096 live
// slots, 0.0237 ms at the FP64 peak, which counts an FMA as two (a compare
// issues at one operation a lane a clock, so the FP64 pipe alone needs
// twice that).  Before its redesign it ran K18's design: one query a
// thread, three 8-byte shared loads a slot, jmax's NaN tests on every
// pair (about 10 instructions), every slot of the log, the sentinel tail
// too: 3.8 pairs a clock an SM (0.2736 ms).  Its design now is K17's
// (scan1d.cu):
//   - the tile walker (scan_tile.cuh walk_tiles) stages x, y and the
//     measure as one four-word slot (a word of padding), read back as two
//     16-byte shared loads, kDomTile slots a tile through double-buffered
//     cp.async, 4 queries a thread (one pair of loads serves four);
//   - the log is cut in up to 4 chunks of interleaved tiles along the
//     grid's second dimension, and a combine kernel takes each query's
//     chunk maxima in chunk order (jmax, no atomics: two launches give the
//     same bits);
//   - the loop (scan_tile.cuh dominated_max_step) has no NaN test: 3 f64
//     compares and a predicated move.  Once a tile has landed the block
//     votes (__syncthreads_or) whether its measures hold a NaN, and such a
//     tile runs jmax instead; a NaN acc is never replaced by the
//     compare-only loop, so it stays NaN;
//   - a block stops at its first tile that starts on the sentinel (the log
//     is x-sorted, and from its first sentinel x on every slot is
//     (sentinel, sentinel, 0)).  That is exact only with the tail's 0
//     folded back: a corner with u >= sentinel and v >= sentinel dominates
//     the padding, which the plain version counts as a member (a MIN table
//     runs negated, so its measures lie below 0).  So a block that skipped
//     tiles gives each such query jmax(acc, 0.0); a NaN corner fails that
//     test as it fails every dominance test.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, Q =
// 65,536): 0.0551 ms on a MIN table's insert log of 3,072 live slots in
// 4,096 (0.2736 before the redesign), 14.0 (query, live slot) pairs a
// clock an SM, 32% of the bound over the live slots.  On the same logs K17
// runs 13.9-14.5 pairs a clock an SM and K20 13.3-13.9; a NaN measure in
// every tile (jmax) costs 1.8x (tools/k1_k20_rates.py).
//
// Each launcher takes raw device pointers and the CUDA stream, launches on
// that stream, and returns cudaGetLastError() (0 when the launch was
// taken).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "locate.cuh"
#include "scan_tile.cuh"

namespace polyfit {
namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads;   // log slots staged per tile

inline int blocks_for(int Q) { return (Q + kThreads - 1) / kThreads; }

// K18: count of the logged points in (lx, ux] x (ly, uy]
__global__ void delta_count2d_kernel(const double* __restrict__ lx,
                                     const double* __restrict__ ux,
                                     const double* __restrict__ ly,
                                     const double* __restrict__ uy,
                                     const double* __restrict__ kx,
                                     const double* __restrict__ ky,
                                     double* __restrict__ out, int Q, int D) {
  __shared__ double s_x[kTile], s_y[kTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = i < Q ? i : Q - 1;   // threads past Q still stage tiles
  const double x0 = lx[r], x1 = ux[r], y0 = ly[r], y1 = uy[r];
  double acc = 0.0;
  for (int t0 = 0; t0 < D; t0 += kTile) {
    const int j = t0 + threadIdx.x;
    if (j < D) {
      s_x[threadIdx.x] = kx[j];
      s_y[threadIdx.x] = ky[j];
    }
    __syncthreads();
    const int n = D - t0 < kTile ? D - t0 : kTile;
    for (int k = 0; k < n; ++k) {
      const double x = s_x[k], y = s_y[k];
      const bool in = x0 < x && x <= x1 && y0 < y && y <= y1;
      acc = acc + (in ? 1.0 : 0.0);
    }
    __syncthreads();
  }
  if (i < Q) out[i] = acc;
}

// K19's query groups: a block sorts its queries into this many buckets of
// their first slot a (the last bucket holds the empty ranges)
constexpr int kRankBuckets = 128;

// K19: the sum of the measures ``w`` of the logged points in (lx, ux] x
// (ly, uy], in slot order.  The log is x-sorted (NaN x last), so the slots
// with lx < x <= ux are [a, b), a = #(x <= lx) (no slot for a NaN lx) and
// b = #(x <= ux); block (x, y) takes the slots [c0, c0 + chunk) of grid
// row y, cut at the log's sentinel tail (from the first slot whose x is the
// sentinel on, every slot is (sentinel, sentinel, +0.0)).  A block of
// P = THREADS * R queries:
//   1. ranks each query's [a, b) by two binary searches over ``kx``;
//   2. with SORT, buckets its queries by a (a counting sort in shared
//      memory), so that a thread's R queries and a warp's 32 R are
//      neighbours in a: the union of a warp's ranges is narrow;
//   3. stages (y, w) of the union of its queries' ranges, SLOTS slots at a
//      time, by cp.async into shared memory, and each warp walks the slots
//      of its own union only (warp-uniform bounds: every lane reads the same
//      slot), G slots at a time: the G contributions of each query
//      (rank_member's rank and y tests and select) first, then its chain of
//      G adds.
// Each query adds its walked slots' contributions in slot order, as the
// plain version adds every slot's (a slot the walk skips is no member and
// adds +0.0 there, which changes nothing), so the two agree bit for bit; the
// order in which a block's queries are given to its threads (the bucket
// order, which shared atomics set) moves no bit of any answer.  The answers
// go to row y of ``part`` ((gridDim.y, Q)).
template <int THREADS, int R, int SLOTS, int G, bool SORT>
__global__ void __launch_bounds__(THREADS)
    delta_sum2d_kernel(const double* __restrict__ lx,
                       const double* __restrict__ ux,
                       const double* __restrict__ ly,
                       const double* __restrict__ uy,
                       const double* __restrict__ kx,
                       const double* __restrict__ ky,
                       const double* __restrict__ w,
                       double* __restrict__ part, int Q, int D,
                       double sentinel, int chunk) {
  constexpr int P = THREADS * R;
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ double s_ly[P], s_uy[P];
  __shared__ int s_a[P], s_b[P];
  __shared__ int s_perm[SORT ? P : 1], s_cnt[SORT ? kRankBuckets : 1];
  __shared__ int s_lo, s_hi;
  extern __shared__ double2 s_log[];
  const int first = blockIdx.x * P;
  int tail = bsearch_count_left(kx, D, sentinel);
  if (tail < D && !(kx[tail] == sentinel)) tail = D;
  const int c0 = blockIdx.y * chunk;
  const int c1 = min(min(c0 + chunk, D), tail);
  if (SORT)
    for (int k = threadIdx.x; k < kRankBuckets; k += THREADS) s_cnt[k] = 0;
  if (threadIdx.x == 0) {
    s_lo = INT_MAX;
    s_hi = 0;
  }
  __syncthreads();
  // (a - c0) >> shift < 128, the last bucket (127) is the empty ranges'
  const int shift = max(0, 32 - __clz(c1 > c0 ? c1 - c0 : 1) - 7);
  int key[R], pos[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = threadIdx.x + r * THREADS;
    const int i = first + p;
    int a = INT_MAX, b = 0;   // empty: no slot passes a <= j < b
    double l = 0.0, h = 0.0;
    if (i < Q) {
      const double x0 = lx[i];
      const int ra = isnan(x0) ? D : bsearch_count_right(kx, D, x0);
      const int rb = bsearch_count_right(kx, D, ux[i]);   // 0 for NaN
      if (max(ra, c0) < min(rb, c1)) {
        a = max(ra, c0);
        b = min(rb, c1);
      }
      l = ly[i];
      h = uy[i];
    }
    s_a[p] = a;
    s_b[p] = b;
    s_ly[p] = l;
    s_uy[p] = h;
    if (SORT) {
      key[r] = a < b ? min((a - c0) >> shift, kRankBuckets - 2)
                     : kRankBuckets - 1;
      pos[r] = atomicAdd(&s_cnt[key[r]], 1);
    }
  }
  __syncthreads();
  if (SORT) {
    if (threadIdx.x < 32) {   // warp 0: each bucket's first sorted position
      constexpr int kPer = kRankBuckets / 32;
      const int lane = threadIdx.x;
      int c[kPer], sum = 0;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        c[k] = s_cnt[lane * kPer + k];
        sum += c[k];
      }
      int incl = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(kAll, incl, d);
        if (lane >= d) incl += t;
      }
      int start = incl - sum;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        s_cnt[lane * kPer + k] = start;
        start += c[k];
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r)
      s_perm[s_cnt[key[r]] + pos[r]] = threadIdx.x + r * THREADS;
    __syncthreads();
  }
  int qa[R], qb[R], idx[R];
  double ql[R], qu[R], acc[R];
  int lo = INT_MAX, hi = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p =
        SORT ? s_perm[threadIdx.x * R + r] : threadIdx.x + r * THREADS;
    qa[r] = s_a[p];
    qb[r] = s_b[p];
    ql[r] = s_ly[p];
    qu[r] = s_uy[p];
    idx[r] = first + p;
    acc[r] = 0.0;
    lo = min(lo, qa[r]);
    hi = max(hi, qb[r]);
  }
  // the warp's slots: the union of its queries' ranges
  const int lo_w = __reduce_min_sync(kAll, lo);
  const int hi_w = __reduce_max_sync(kAll, hi);
  if ((threadIdx.x & 31) == 0 && lo_w < hi_w) {
    atomicMin(&s_lo, lo_w);
    atomicMax(&s_hi, hi_w);
  }
  __syncthreads();
  const int lo_b = s_lo, hi_b = s_hi;
  for (int t0 = lo_b; t0 < hi_b; t0 += SLOTS) {
    const int m = min(SLOTS, hi_b - t0);
    for (int k = threadIdx.x; k < m; k += THREADS) {
      cp_async<8>(&s_log[k].x, ky + t0 + k);
      cp_async<8>(&s_log[k].y, w + t0 + k);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // j1 - j, not j + G: lo_w is INT_MAX for a warp with no range
    const int j1 = min(hi_w, t0 + m);
    int j = max(lo_w, t0);
    for (; j1 - j >= G; j += G) {
      double v[R][G];
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const double2 s = s_log[j + k - t0];
#pragma unroll
        for (int r = 0; r < R; ++r)
          v[r][k] = rank_member(j + k, qa[r], qb[r], ql[r], qu[r], s.x,
                                s.y);
      }
#pragma unroll
      for (int k = 0; k < G; ++k)
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = acc[r] + v[r][k];
    }
    for (; j < j1; ++j) {
      const double2 s = s_log[j - t0];
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r] = acc[r] + rank_member(j, qa[r], qb[r], ql[r], qu[r], s.x,
                                      s.y);
    }
    __syncthreads();   // the buffer is restaged
  }
  double* row = part + (size_t)blockIdx.y * Q;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (idx[r] < Q) row[idx[r]] = acc[r];
}

// K19's shape: blocks of 256 threads of one query each, sorted into
// buckets; the log's (y, w) staged 4,096 slots (64 KB) at a time, walked 8
// slots a group
constexpr int kSumThreads = 256, kSumQueries = 1, kSumSlots = 4096,
              kSumGroup = 8;
constexpr bool kSumSort = true;

// K19 over grid rows of ``chunk`` slots (S = ceil(D / chunk) rows): the
// answers of row y go to row y of ``part`` (``out`` itself when S = 1)
template <int THREADS, int R, int SLOTS, int G, bool SORT>
int launch_delta_sum2d(const void* lx, const void* ux, const void* ly,
                       const void* uy, const void* kx, const void* ky,
                       const void* w, void* part, int Q, int D,
                       double sentinel, int chunk, cudaStream_t stream) {
  constexpr int per_block = THREADS * R;
  const int smem = (D < SLOTS ? D : SLOTS) * (int)sizeof(double2);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(
        delta_sum2d_kernel<THREADS, R, SLOTS, G, SORT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((Q + per_block - 1) / per_block, (D + chunk - 1) / chunk);
  delta_sum2d_kernel<THREADS, R, SLOTS, G, SORT>
      <<<grid, THREADS, smem, stream>>>(
      (const double*)lx, (const double*)ux, (const double*)ly,
      (const double*)uy, (const double*)kx, (const double*)ky,
      (const double*)w, (double*)part, Q, D, sentinel, chunk);
  return (int)cudaGetLastError();
}

// K20: max of the measures of the logged points with x <= u, y <= v,
// -inf when none (NaN where a dominated measure is NaN).  A thread holds R
// queries; block (x, y) walks the log's tiles y, y + S, y + 2S, ... (S =
// gridDim.y chunks) in slot order and writes its partial maxima to row y
// of ``part``.  Once a tile has landed the block votes whether its
// measures hold a NaN: a tile that holds none runs dominated_max_step (no
// NaN test), one that does runs jmax, which leaves acc NaN, and
// dominated_max_step never replaces a NaN acc.  Each block stops at its
// first tile that starts on the sentinel; every slot it skips is
// (sentinel, sentinel, 0.0), so a query that dominates the sentinel
// (sentinel <= u and sentinel <= v: false for a NaN corner) takes
// jmax(acc, 0.0) where its block skipped tiles.
template <int THREADS, int R, int TILE>
__global__ void __launch_bounds__(THREADS)
    delta_dommax2d_kernel(const double* __restrict__ u,
                          const double* __restrict__ v,
                          const double* __restrict__ kx,
                          const double* __restrict__ ky,
                          const double* __restrict__ w,
                          double* __restrict__ part, int Q, int D,
                          double sentinel) {
  extern __shared__ double2 s_pts[];
  const int i0 = blockIdx.x * (THREADS * R) + threadIdx.x;
  double qu[R], qv[R], acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // threads past Q still stage tiles
    const int i = i0 + r * THREADS < Q ? i0 + r * THREADS : Q - 1;
    qu[r] = u[i];
    qv[r] = v[i];
    acc[r] = -INFINITY;
  }
  const double* src[3] = {kx, ky, w};
  const bool skipped = walk_tiles<4, TILE, true>(
      src, D, blockIdx.y, gridDim.y, sentinel, (double*)s_pts,
      [&](const double2x2* pts, int m) {
        bool nan = false;
        for (int k = threadIdx.x; k < m; k += THREADS)
          nan |= isnan(pts[k].b.x);
        if (__syncthreads_or(nan)) {
          for (int k = 0; k < m; ++k) {
            const double2x2 p = pts[k];
#pragma unroll
            for (int r = 0; r < R; ++r)
              acc[r] = jmax(acc[r], (p.a.x <= qu[r] && p.a.y <= qv[r])
                                        ? p.b.x : -INFINITY);
          }
        } else if (m == TILE) {
#pragma unroll 8
          for (int k = 0; k < TILE; ++k) {
            const double2x2 p = pts[k];
#pragma unroll
            for (int r = 0; r < R; ++r)
              dominated_max_step(acc[r], p.a.x, p.a.y, p.b.x, qu[r], qv[r]);
          }
        } else {
          for (int k = 0; k < m; ++k) {
            const double2x2 p = pts[k];
#pragma unroll
            for (int r = 0; r < R; ++r)
              dominated_max_step(acc[r], p.a.x, p.a.y, p.b.x, qu[r], qv[r]);
          }
        }
      });
  double* row = part + (size_t)blockIdx.y * Q;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (skipped && sentinel <= qu[r] && sentinel <= qv[r])
      acc[r] = jmax(acc[r], 0.0);
    if (i0 + r * THREADS < Q) row[i0 + r * THREADS] = acc[r];
  }
}

// K20's shape: 4 queries a thread in blocks of 128, 1,024-slot tiles (two
// 32 KB buffers of four-word slots: 3 blocks an SM), the log in up to 4
// chunks.  On an NVIDIA H100 80GB HBM3 at 700 W (tools/k1_k20_rates.py)
// 512-slot tiles ran 9% slower on a log of 3,072 live slots in 4,096 and
// as fast on a full one, 2 queries a thread 13% slower.
constexpr int kDomThreads = 128, kDomQueries = 4, kDomTile = 1024,
              kDomChunks = 4;

// K20 in S chunks: the chunk maxima go to ``part`` ((S, Q), unused when
// S = 1), then the combine writes ``out``
template <int THREADS, int R, int TILE>
int launch_delta_dommax2d(const void* u, const void* v, const void* kx,
                          const void* ky, const void* w, void* out,
                          void* part, int Q, int D, double sentinel, int S,
                          cudaStream_t stream) {
  constexpr int per_block = THREADS * R;
  constexpr int smem = walk_smem_bytes<4, TILE>();
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(delta_dommax2d_kernel<THREADS, R, TILE>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((Q + per_block - 1) / per_block, S);
  delta_dommax2d_kernel<THREADS, R, TILE><<<grid, THREADS, smem, stream>>>(
      (const double*)u, (const double*)v, (const double*)kx,
      (const double*)ky, (const double*)w, (double*)(S > 1 ? part : out), Q,
      D, sentinel);
  if (S > 1)
    chunk_max_combine_kernel<double><<<blocks_for(Q), kThreads, 0, stream>>>(
        (const double*)part, (double*)out, Q, S);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace polyfit

extern "C" {

int polyfit_delta_count2d(const void* lx, const void* ux, const void* ly,
                          const void* uy, const void* kx, const void* ky,
                          void* out, int Q, int D, void* stream) {
  if (Q > 0)
    polyfit::delta_count2d_kernel<<<polyfit::blocks_for(Q),
                                    polyfit::kThreads, 0,
                                    (cudaStream_t)stream>>>(
        (const double*)lx, (const double*)ux, (const double*)ly,
        (const double*)uy, (const double*)kx, (const double*)ky,
        (double*)out, Q, D);
  return (int)cudaGetLastError();
}

int polyfit_delta_sum2d(const void* lx, const void* ux, const void* ly,
                        const void* uy, const void* kx, const void* ky,
                        const void* w, void* out, int Q, int D,
                        double sentinel, void* stream) {
  using namespace polyfit;
  if (Q <= 0) return (int)cudaGetLastError();
  return launch_delta_sum2d<kSumThreads, kSumQueries, kSumSlots, kSumGroup,
                            kSumSort>(lx, ux, ly, uy, kx, ky, w, out, Q, D,
                                      sentinel, D, (cudaStream_t)stream);
}

int polyfit_delta_dommax2d_chunks(int D) {
  return polyfit::walk_chunks<polyfit::kDomTile>(D, polyfit::kDomChunks);
}

// ``part``: an (S, Q) scratch, S = polyfit_delta_dommax2d_chunks(D)
int polyfit_delta_dommax2d(const void* u, const void* v, const void* kx,
                           const void* ky, const void* w, void* out,
                           void* part, int Q, int D, double sentinel,
                           void* stream) {
  using namespace polyfit;
  if (Q <= 0) return (int)cudaGetLastError();
  return launch_delta_dommax2d<kDomThreads, kDomQueries, kDomTile>(
      u, v, kx, ky, w, out, part, Q, D, sentinel,
      walk_chunks<kDomTile>(D, kDomChunks), (cudaStream_t)stream);
}

}  // extern "C"
