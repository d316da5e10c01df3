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
//        counted in int32 and written as float64;
//   K19  the sum of their measures, added in slot order (the plain version
//        adds in the same order, so the two agree bit for bit);
//   K20  the max measure of the logged points with x <= u and y <= v, -inf
//        when none is dominated; a NaN measure among them gives NaN, as
//        the reference's jnp.max does.
//
// Sentinel slots hold the sentinel in both coordinates and measure 0, so
// they fail every membership test below the sentinel.  The reference sums
// a one-hot matmul over tiles of 512 slots; a count and a max are exact in
// any order, and the sum of K19 is held to the plain version in slot
// order.  The log is x-sorted (NaN x last), and from the first slot whose
// x is the sentinel on every slot is (sentinel, sentinel, 0): the
// DeltaBuffer2D layout, which each kernel takes as given.
//
// What bounds them on an H100: operations.  K19 and K18 test only the slots
// of each rectangle's x range.  On the x-sorted log the slots with
// lx < x <= ux are one range [a, b) of two binary searches, so the x test
// becomes the integer test a <= j < b on the slot's index and only the y
// tests (and K19's add) are left in f64; the OSM-like rectangles of
// chip_smoke.py span about 7.6% of a log's live slots
// (tools/k13_k19_rates.py).  Their bound counts the searches' compares and
// the f64 operations a (rectangle, [a, b) slot) pair, 3 for K19 (2 y
// compares and an add) and 2 for K18 (its count adds in int32): about
// 0.0014 and 0.0010 ms at Q = 65,536 on a 3,072-slot insert log; at 5
// operations a pair (the old one-query-a-thread form) 0.030 over every
// live slot, 0.039 over every slot.
// Both run one design (rank_rects below, the rank prologue they share):
//   - each rectangle's [a, b) from two searches of the x keys (L1-resident),
//     a = #(x <= lx) (the log's size for a NaN lx: no slot passes it) and
//     b = #(x <= ux), cut at the sentinel tail (the first slot whose x is
//     the sentinel, so a full log that ends on +inf keeps its last slot);
//   - the block's 256 rectangles are bucketed by a in shared memory, so a
//     warp's 32 are neighbours in a and the union of their ranges is narrow
//     (tools/k13_k19_rates.py prints the mean union with and without the
//     buckets: 19.8% of the live slots against 74.7%); the union's slots
//     are staged once by cp.async and each warp walks only its own union,
//     every lane reading the same slot.
// K19 stages (y, w), 16 bytes a slot, and forms 8 slots' contributions
// (scan_tile.cuh rank_member: two integer and two f64 compares, a select)
// before their 8 adds, so the chain of adds is all that is serial.  A
// predicated add a slot (the first form) tied each slot's loads and
// compares into that chain: 0.063 ms against 0.033 at the same shape.  One
// rectangle a thread, no chunks: the slot order of each sum allows no
// split of its range, and a chunked form (sums of 4 slot ranges added in
// range order, which rounds otherwise) ran slower, 0.045 ms.  Measured on
// an NVIDIA H100 80GB HBM3 at 700 W (tools/k13_k19_rates.py, Q = 65,536):
// 0.0334 ms on an insert log of 3,072 live slots (0.1079 before), 0.0172
// on a delete log of 1,024 (0.1084), 0.0417 on a full log (0.1086);
// without the buckets 0.079; one rectangle over the whole plane among the
// 65,536 (its warp walks every live slot): 0.0391.
//
// K18 used the freedoms a count has and a sum does not.  Before its
// redesign it ran one query a thread over every slot of the log, sentinel
// tail included, in 256-slot tiles staged by plain loads: 4 f64 compares,
// a select and an f64 add a pair, 0.1079 ms on a 4,096-slot log whatever
// its fill.  Its design now (delta_count2d_kernel below) is K19's with:
//   - y staged alone, 8 bytes a slot, and an int32 count: no chain of f64
//     adds to order, since a count is exact in any order;
//   - the rank test a <= j < b once a group of 32 slots, as a mask of the
//     group's slots in [a, b) (scan_tile.cuh rank_count_group); each slot
//     then costs its 2 y compares and a predicated OR of its bit, and the
//     group a popcount.  Testing the rank on every slot (rank_count_step:
//     two integer and two f64 compares, a predicated increment) kept the
//     walk at a quarter of what its 2 FP64 compares allow;
//   - each warp's union split between 2 warps (a block of 512 threads for
//     256 rectangles), the halves' counts added in shared memory: twice
//     the warps to hide latency, and half the walk for a warp that holds a
//     rectangle over the whole plane;
//   - the x keys staged in shared memory before the ranks and searched
//     there (the searches were a third of the kernel's fixed cost);
//   - the sentinel tail's slots, (sentinel, sentinel) each, counted without
//     a walk: each rectangle that holds that point gets their number, as
//     the plain version, which tests every slot, counts them.
// A count may also split the live log along the grid (chunks ranked and
// walked alone, their counts added): each chunk repeats the rank
// prologue, which costs more than it saves, so the shipped launch walks
// the live log in one grid row.  Measured on an NVIDIA H100 80GB HBM3 at
// 700 W (tools/k14_k18_rates.py, Q = 65,536 OSM-like rectangles): 0.0207
// ms on an insert log of 3,072 live slots (0.1066 before; K19 0.0340),
// 0.0120 on a delete log of 1,024, 0.0239 on a full log; the first rank
// form (a rank test a slot, one warp a union, the keys searched in global
// memory) 0.0293, with the live log in 4 chunks 0.0409; the ranks and
// writes alone (every x range empty) 0.0083.
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

inline int blocks_for(int Q) { return (Q + kThreads - 1) / kThreads; }

// The slot where the log's sentinel tail starts: the first slot whose x is
// the sentinel, or D where none is (not #(x < sentinel), which would drop
// an infinite x that ends a full log)
__device__ __forceinline__ int log_tail(const double* __restrict__ kx, int D,
                                        double sentinel) {
  const int tail = bsearch_count_left(kx, D, sentinel);
  return tail < D && kx[tail] == sentinel ? tail : D;
}

// K18's and K19's rectangle groups: a block sorts its rectangles into this
// many buckets of their first slot a (the last bucket holds the empty
// ranges)
constexpr int kRankBuckets = 128;

// The shared memory of the rank prologue for a block of P rectangles:
// their ranks and y bounds, and with SORT their bucket counts and order
template <int P, bool SORT>
struct RankStage {
  double ly[P], uy[P];
  int a[P], b[P];
  int perm[SORT ? P : 1], cnt[SORT ? kRankBuckets : 1];
  int lo, hi;
};

// A thread's R rectangles after the rank prologue (in bucket order with
// SORT): their slot ranges [a, b) (a = INT_MAX, b = 0 when empty), y
// bounds and indices in the batch, and the unions of the ranges of its
// warp [lo_w, hi_w) and of its block [lo_b, hi_b)
template <int R>
struct Ranked {
  int a[R], b[R], idx[R];
  double ly[R], uy[R];
  int lo_w, hi_w, lo_b, hi_b;
};

// The rank prologue of K18 and K19 for the block's P = THREADS * R
// rectangles first, first + 1, ...: each rectangle's x range ranked to the
// slots [a, b) of the x-sorted log by two binary searches over ``kx``
// (a = #(x <= lx), none for a NaN lx; b = #(x <= ux)) and cut to the slots
// [c0, c1); with SORT the rectangles bucketed by a (a counting sort in
// shared memory), so that a thread's R rectangles and a warp's 32 R are
// neighbours in a and the union of a warp's ranges is narrow.  Every
// thread of the block calls it (it holds __syncthreads); the first THREADS
// rank, and a block of more (K18's split walk) gives thread t the
// rectangles of thread t % THREADS.
template <int THREADS, int R, bool SORT>
__device__ __forceinline__ void rank_rects(
    const double* __restrict__ lx, const double* __restrict__ ux,
    const double* __restrict__ ly, const double* __restrict__ uy,
    const double* __restrict__ kx, int Q, int D, int first, int c0, int c1,
    RankStage<THREADS * R, SORT>& s, Ranked<R>& q) {
  constexpr unsigned kAll = 0xffffffffu;
  if (SORT)
    for (int k = threadIdx.x; k < kRankBuckets; k += THREADS) s.cnt[k] = 0;
  if (threadIdx.x == 0) {
    s.lo = INT_MAX;
    s.hi = 0;
  }
  __syncthreads();
  // (a - c0) >> shift < 128, the last bucket (127) is the empty ranges'
  const int shift = max(0, 32 - __clz(c1 > c0 ? c1 - c0 : 1) - 7);
  const bool ranker = threadIdx.x < THREADS;
  const int t = threadIdx.x % THREADS;
  int key[R], pos[R];
#pragma unroll
  for (int r = 0; r < R && ranker; ++r) {
    const int p = t + r * THREADS;
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
    s.a[p] = a;
    s.b[p] = b;
    s.ly[p] = l;
    s.uy[p] = h;
    if (SORT) {
      key[r] = a < b ? min((a - c0) >> shift, kRankBuckets - 2)
                     : kRankBuckets - 1;
      pos[r] = atomicAdd(&s.cnt[key[r]], 1);
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
        c[k] = s.cnt[lane * kPer + k];
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
        s.cnt[lane * kPer + k] = start;
        start += c[k];
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R && ranker; ++r)
      s.perm[s.cnt[key[r]] + pos[r]] = t + r * THREADS;
    __syncthreads();
  }
  int lo = INT_MAX, hi = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = SORT ? s.perm[t * R + r] : t + r * THREADS;
    q.a[r] = s.a[p];
    q.b[r] = s.b[p];
    q.ly[r] = s.ly[p];
    q.uy[r] = s.uy[p];
    q.idx[r] = first + p;
    lo = min(lo, q.a[r]);
    hi = max(hi, q.b[r]);
  }
  // the warp's slots: the union of its rectangles' ranges
  q.lo_w = __reduce_min_sync(kAll, lo);
  q.hi_w = __reduce_max_sync(kAll, hi);
  if ((threadIdx.x & 31) == 0 && q.lo_w < q.hi_w) {
    atomicMin(&s.lo, q.lo_w);
    atomicMax(&s.hi, q.hi_w);
  }
  __syncthreads();
  q.lo_b = s.lo;
  q.hi_b = s.hi;
}

// K18's shape: blocks of kCountRects rectangles of one rectangle each,
// sorted into buckets, 2 threads a rectangle (each warp's union split in
// 2); the x keys searched in shared memory where they fit; y staged
// kCountSlots slots (32 KB) at a time; the rank test once a group of 32
// slots
constexpr int kCountRects = 256, kCountBlock = 2 * kCountRects,
              kCountSlots = 4096, kCountGroup = 32;

// K18: the number of logged points in (lx, ux] x (ly, uy].  A block stages
// the x keys in shared memory (where they fit: D <= kCountSlots, else it
// searches them in global memory) and ranks its kCountRects rectangles
// (rank_rects) against the live log [0, tail), then stages the y of the
// union of their ranges, kCountSlots slots at a time, by cp.async into the
// same buffer.  Warps w and w + kCountRects / 32 hold the same rectangles
// and each walks its half of their union (warp-uniform bounds: every lane
// reads the same slot), kCountGroup slots a group with the rank test once
// a group (rank_count_group) and slot by slot past the last full group
// (rank_count_step); the second half's counts are added in shared memory.
// The tail's slots are (sentinel, sentinel): each rectangle that holds
// that point gets their number, as the plain version, which tests every
// slot, counts them.  The counts go to ``out`` as float64.
__global__ void __launch_bounds__(kCountBlock)
    delta_count2d_kernel(const double* __restrict__ lx,
                         const double* __restrict__ ux,
                         const double* __restrict__ ly,
                         const double* __restrict__ uy,
                         const double* __restrict__ kx,
                         const double* __restrict__ ky,
                         double* __restrict__ out, int Q, int D,
                         double sentinel) {
  __shared__ RankStage<kCountRects, true> s;
  __shared__ int s_half[kCountRects];
  extern __shared__ double s_y[];
  const double* keys = kx;
  if (D <= kCountSlots) {
    for (int k = threadIdx.x; k < D; k += kCountBlock)
      cp_async<8>(&s_y[k], kx + k);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    keys = s_y;
  }
  const int tail = log_tail(keys, D, sentinel);
  Ranked<1> q;
  rank_rects<kCountRects, 1, true>(lx, ux, ly, uy, keys, Q, D,
                                   blockIdx.x * kCountRects, 0, tail, s, q);
  // the tail's (sentinel, sentinel) slots, counted once
  const int n_tail =
      tail < D ? bsearch_count_right(keys, D, sentinel) - tail : 0;
  __syncthreads();   // the keys' buffer is restaged
  // this thread's half of its warp's union (h = 1: the second half)
  const int h = threadIdx.x / kCountRects;
  const int len = max(q.hi_w - q.lo_w, 0);
  const int w_lo = q.lo_w + (h ? len / 2 : 0);
  const int w_hi = q.lo_w + (h ? len : len / 2);
  int cnt = 0;
  for (int t0 = q.lo_b; t0 < q.hi_b; t0 += kCountSlots) {
    const int m = min(kCountSlots, q.hi_b - t0);
    for (int k = threadIdx.x; k < m; k += kCountBlock)
      cp_async<8>(&s_y[k], ky + t0 + k);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // j1 - j, not j + kCountGroup: w_lo is INT_MAX for a warp with no range
    const int j1 = min(w_hi, t0 + m);
    int j = max(w_lo, t0);
    for (; j1 - j >= kCountGroup; j += kCountGroup)
      rank_count_group<kCountGroup>(cnt, j, q.a[0], q.b[0], q.ly[0],
                                    q.uy[0], s_y + (j - t0));
    for (; j < j1; ++j)
      rank_count_step(cnt, j, q.a[0], q.b[0], q.ly[0], q.uy[0],
                      s_y[j - t0]);
    __syncthreads();   // the buffer is restaged
  }
  const int t = threadIdx.x % kCountRects;
  if (h > 0) s_half[t] = cnt;
  __syncthreads();
  const int i = q.idx[0];
  if (h > 0 || i >= Q) return;
  cnt += s_half[t];
  if (n_tail > 0 && q.ly[0] < sentinel && sentinel <= q.uy[0] &&
      lx[i] < sentinel && sentinel <= ux[i])
    cnt += n_tail;
  out[i] = (double)cnt;
}

int launch_delta_count2d(const void* lx, const void* ux, const void* ly,
                         const void* uy, const void* kx, const void* ky,
                         void* out, int Q, int D, double sentinel,
                         cudaStream_t stream) {
  // at most 32 KB: no opt-in above the default 48 KB
  const int smem = (D < kCountSlots ? D : kCountSlots) * (int)sizeof(double);
  delta_count2d_kernel<<<(Q + kCountRects - 1) / kCountRects, kCountBlock,
                         smem, stream>>>(
      (const double*)lx, (const double*)ux, (const double*)ly,
      (const double*)uy, (const double*)kx, (const double*)ky,
      (double*)out, Q, D, sentinel);
  return (int)cudaGetLastError();
}

// K19: the sum of the measures ``w`` of the logged points in (lx, ux] x
// (ly, uy], in slot order.  Block (x, y) ranks its P = THREADS * R
// rectangles (rank_rects) against the slots [c0, c0 + chunk) of grid row
// y, cut at the log's sentinel tail, then stages (y, w) of the union of
// their ranges, SLOTS slots at a time, by cp.async into shared memory, and
// each warp walks the slots of its own union only (warp-uniform bounds:
// every lane reads the same slot), G slots at a time: the G contributions
// of each rectangle (rank_member's rank and y tests and select) first,
// then its chain of G adds.  Each rectangle adds its walked slots'
// contributions in slot order, as the plain version adds every slot's (a
// slot the walk skips is no member and adds +0.0 there, which changes
// nothing), so the two agree bit for bit; the order in which a block's
// rectangles are given to its threads (the bucket order, which shared
// atomics set) moves no bit of any answer.  The answers go to row y of
// ``part`` ((gridDim.y, Q)).
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
  __shared__ RankStage<THREADS * R, SORT> s;
  extern __shared__ double2 s_log[];
  const int tail = log_tail(kx, D, sentinel);
  const int c0 = blockIdx.y * chunk;
  const int c1 = min(min(c0 + chunk, D), tail);
  Ranked<R> q;
  rank_rects<THREADS, R, SORT>(lx, ux, ly, uy, kx, Q, D,
                               blockIdx.x * (THREADS * R), c0, c1, s, q);
  double acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0;
  for (int t0 = q.lo_b; t0 < q.hi_b; t0 += SLOTS) {
    const int m = min(SLOTS, q.hi_b - t0);
    for (int k = threadIdx.x; k < m; k += THREADS) {
      cp_async<8>(&s_log[k].x, ky + t0 + k);
      cp_async<8>(&s_log[k].y, w + t0 + k);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // j1 - j, not j + G: lo_w is INT_MAX for a warp with no range
    const int j1 = min(q.hi_w, t0 + m);
    int j = max(q.lo_w, t0);
    for (; j1 - j >= G; j += G) {
      double v[R][G];
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const double2 sl = s_log[j + k - t0];
#pragma unroll
        for (int r = 0; r < R; ++r)
          v[r][k] = rank_member(j + k, q.a[r], q.b[r], q.ly[r], q.uy[r],
                                sl.x, sl.y);
      }
#pragma unroll
      for (int k = 0; k < G; ++k)
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = acc[r] + v[r][k];
    }
    for (; j < j1; ++j) {
      const double2 sl = s_log[j - t0];
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r] = acc[r] + rank_member(j, q.a[r], q.b[r], q.ly[r], q.uy[r],
                                      sl.x, sl.y);
    }
    __syncthreads();   // the buffer is restaged
  }
  double* row = part + (size_t)blockIdx.y * Q;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (q.idx[r] < Q) row[q.idx[r]] = acc[r];
}

// K19's shape: blocks of 256 threads of one rectangle each, sorted into
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
                          void* out, int Q, int D, double sentinel,
                          void* stream) {
  using namespace polyfit;
  if (Q <= 0) return (int)cudaGetLastError();
  return launch_delta_count2d(lx, ux, ly, uy, kx, ky, out, Q, D, sentinel,
                              (cudaStream_t)stream);
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
