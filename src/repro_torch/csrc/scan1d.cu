// PolyFit one-key scan kernels for Hopper (sm_90a): the 'cuda_scan'
// backend, and K21 (kernels/ops.py poly_eval).
//
// K14 range_sum_scan_kernel
//                       replaces repro/kernels/range_sum.py:range_sum_pallas
// K15 range_max_scan_kernel + range_max_finish_kernel
//                       replaces repro/kernels/range_max.py:range_max_pallas
// K16 delta_sum_kernel  replaces repro/kernels/delta_scan.py:delta_sum_pallas
// K17 delta_max_kernel  replaces repro/kernels/delta_scan.py:delta_max_pallas
// K21 segment_eval_kernel
//                       replaces repro/kernels/poly_eval.py:poly_eval_pallas
//
// Twins of the plain versions in repro_torch/kernels/range_sum.py,
// range_max.py, poly_eval.py and delta_scan.py, in their order of
// operations (compiled with -fmad=false, so every multiply and add rounds
// on its own).  Where the gather kernels K2, K3, K5 and K6
// (polyfit_kernels.cu) search a sorted table, K14-K17 test every query
// against every live entry:
//
//   K14  the segment holding each endpoint, found from #(seg_lo <= q)
//        (below), then its row [coeffs | lo | hi] and Horner at the
//        scaled coordinate: P(uq) - P(lq);
//   K21  the segment holding one key, from #(seg_lo <= q) by a descent of
//        seg_lo's search tree (as K2 finds an endpoint's), then
//        P_{I(q)}(q);
//   K15  the same two boundary rows as K14, the left/right/same-segment
//        rules of the closed-form clipped maxima (deg <= 3), and a dense
//        masked max of seg_agg over the segments with lo > lq and
//        next <= uq;
//   K16  the sum of the buffered measures with key in (lq, uq], over the
//        live slots of the sentinel-padded log;
//   K17  the max of the buffered measures with key in [lq, uq] (-inf when
//        none), over the live slots, the skipped tail's 0 folded back in.
//
// K14, K15 and K21 are templates on the element type: double for the
// engine's plans, and float (the *_f32 launchers) for the float32 plans of
// kernels/ops.py, whose sentinel is finfo(float32).max / 4.  K16 and K17
// are double only.
//
// At most one segment holds a clamped query (the next segment's lo closes
// each one, a sentinel the last; a segment whose lo equals the next one's,
// as two starts rounded to one float can, holds nothing), so the
// reference's one-hot matmul sums one row and exact zeros: the kernels keep
// the first segment that holds the query, and a zero row when none does.
// K14, K15 and K21 count their way there: on a plan's table (seg_lo
// non-decreasing, seg_next[j] = seg_lo[j + 1] with the sentinel last, no
// NaN) the segment holding q can only be the last with seg_lo <= q
// (boundary_row).  K14 and K15 then read the very rows K2 and K3 locate,
// and the interior max is exact, so they agree with the gather kernels bit
// for bit on the queries the engine clamps into the domain.  K16 adds each chunk's
// members in slot order and the chunk sums in chunk order (below); the
// plain version's one-hot product may add them in another order, which
// changes nothing on a COUNT log (integers) and at most a few ulps of the
// lane's sum of |measure| on a SUM log.
//
// What bounds K14-K17 on an H100: operations, on long tables.
//
// K21 walked the whole padded table until its redesign: a block of 256
// keys staged it in tiles of 256 entries through shared memory and each
// thread tested its key's one-hot membership against every entry, 2
// compares a pair, about 90% of them on the padding: 0.01131 ms at lat's
// plan (40 live segments of 512), 0.01113 at float32.  Its design now
// (segment_eval_kernel below): one key a thread; #(seg_lo <= q) by a
// descent of seg_lo's search tree (seg_tree, which every plan carries:
// 4 levels and the leaf at 512 rows), the boundary row (the one-hot first
// hit on a plan's table, as K14 takes it), the row by 16-byte loads and
// Horner at a template degree 0-8 (a runtime-degree form above).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/k4_k21_rates.py,
// 65,536 keys, medians of three runs): 0.003350 ms at a lat-like table
// (the walk 0.01118), 0.003675 at a lat_dyn-like one (0.01147), 0.005079
// at 2,295 live segments of 2,560 (0.04749); float32 0.002892, 0.003131,
// 0.004490; two keys a thread ran 13-24% slower, the binary search
// 8-16% slower.
//
// K14 ran K21's loop on both endpoints (4 compares and 2 selects a
// (range, entry) pair) over every row of the padded table until its
// redesign: 0.0199 ms at lat_dyn (105 live segments of 512 rows), 0.0226
// at float32 on lat (40 of 512), about 80% of its pairs on the padding.
// Its design now (range_sum_scan_kernel below):
//   - the tile walker (scan_tile.cuh walk_slots) stages seg_lo alone, one
//     word a slot, 128 starts a tile, double-buffered, and stops at the
//     table's sentinel tail: one tile at lat_dyn, not four;
//   - the loop (locate.cuh count_le) counts #(seg_lo <= lq) and
//     #(seg_lo <= uq): 2 compares and 2 predicated increments a pair;
//   - the rows in the same kernel: boundary_row on each count, the row's
//     coefficients, lo and hi read once, Horner at scale_unit in the plain
//     version's order: one launch, no finish kernel;
//   - 1 range a thread in blocks of 256: 256 blocks at Q = 65,536 for 132
//     SMs.  At these tables the bytes (queries, answers, the live table:
//     about 1.6 MB, 0.0005 ms at the HBM rate) and the compares (0.0008 ms
//     at lat_dyn) leave the launch and the queries' loads to set the time.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/k14_k18_rates.py,
// Q = 65,536): 0.00540 ms at a lat_dyn-shaped table (0.01955 before), K2
// 0.00533 on the same ranges; 0.00423 at float32 on a lat-shaped one
// (0.02249 before); 2 ranges a thread in blocks of 128 ran 0.00644, 4
// ranges 0.00820.
//
// K15 before its redesign ran K21's design too: 9 compares, selects and a
// NaN-propagating max, about 19 instructions a (query, segment) pair in
// the compiled loop, 4.7-5.1 pairs a clock an SM (tools/scan_rates.py).
// Its bound counts 7 f64 operations a pair at the FP64 peak (which counts
// an FMA as two), 0.0348 ms at hki_dyn's 65,536 x 2,560.  Its design now:
//   - the loop (scan_tile.cuh max_scan_step) does 3 compares, 2 predicated
//     increments and a predicated select a pair, about 7.7 instructions:
//     #(lo <= lq), and the count and max of agg where !(lo <= lq) &&
//     next <= uq.  A plan's table (engine.plan.build_plan) has seg_lo
//     non-decreasing, seg_next[j] = seg_lo[j + 1] with the sentinel last,
//     no NaN, so the interior segments are [#(lo <= lq), #(lo <= uq) - 1)
//     and the counts give both boundary rows after the loop (upper_count,
//     boundary_row: the one-hot first hits) with no select a pair; a NaN
//     lq, for which !(lo <= lq) is no test of lo > lq, gets an empty
//     interior from the finish kernel;
//   - the tile walker (scan_tile.cuh) stages start, next start and
//     aggregate as one four-word slot (two 16-byte shared loads at float64,
//     one at float32), 128 segments a tile, double-buffered, and stops at
//     the table's sentinel tail;
//   - a thread holds 4 queries, and the table is cut in up to 4 chunks of
//     interleaved tiles along the grid's second dimension; each chunk
//     writes its two counts and its interior max, and a finish kernel adds
//     the counts (exact), takes the max (exact) and runs the closed forms,
//     one thread a query: two launches give the same bits.
// The loop alone runs 12.1-13.3 pairs a clock an SM on an NVIDIA H100
// 80GB HBM3 at 700 W (tools/scan_rates.py), the kernel 10.0 at hki_dyn
// (chip_smoke.py, 0.0586 ms): its 3 compares and 2 selects a pair, not
// the walker, hold it (a predicated max.f64 comes back from ptxas as NaN
// tests and selects).
//
// K16 does 2 compares, a select and an add a (query, live slot) pair: at
// Q = 65,536 against 4,096 live slots 8.05e8 f64 operations, 0.0237 ms at
// the FP64 peak of 34 TFLOP/s.  That peak counts an FMA as two operations;
// the compares and the add issue at one f64 operation a lane a clock, so
// half of it (0.047 ms) is already all the FP64 pipe can issue for this
// compare-compare-add, and the select takes the integer pipe besides.  Its
// design:
//   - the log is sorted with a sentinel tail of value 0 (DeltaBuffer), and
//     a block stops at its first tile that starts on the sentinel: the
//     window's open epoch, 4,096 live slots of 131,072, costs 4 tiles, not
//     128 (every live slot is still tested against every query);
//   - the shared tile walker (scan_tile.cuh) stages key and value side by
//     side, 1,024 slots a tile, through double-buffered cp.async copies, so
//     the next tile's copy overlaps this tile's compares, and a full tile
//     runs a loop of compile-time length;
//   - a thread holds 4 queries, so one 16-byte shared load serves four
//     compare pairs;
//   - the log is cut in up to 4 chunks of interleaved tiles along the
//     grid's second dimension (512 blocks at Q = 65,536: R queries a thread
//     alone would leave 128), and a second small kernel adds each query's
//     chunk sums in chunk order: no atomics, so two launches give the same
//     bits.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py,
// Q = 65,536): 0.0656 ms on the window's log (2.31 ms before the
// redesign), 0.0497 ms on a dynamic log of 3,072 live slots in 4,096
// (0.0730 before): 36% of the bound over the live slots.  The loop alone
// reaches 16-18 pairs a clock an SM (tools/scan_rates.py) and the kernel
// 15.5: the loop's three f64 instructions a pair, not the walker, hold it.
//
// K17 does 3 compares a (query, live slot) pair (two for membership, one
// for the max): its bound is K16's, 0.0178 ms at Q = 65,536 against 3,072
// live slots.  Before its redesign it ran one query a thread in 256-slot
// tiles over every slot, sentinel tail included, and paid jmax's NaN tests
// on every pair: about 10.6 instructions a pair, 5.0 pairs a clock an SM
// (0.153 ms).  Its design now is K16's:
//   - the tile walker (scan_tile.cuh walk_tiles, walk_slots with the tile
//     handed over whole), 1,024 slots a tile through double-buffered
//     cp.async, 4 queries a thread, the log in up to 4 chunks and a
//     combine kernel that takes the chunk maxima in chunk order (jmax, no
//     atomics: two launches give the same bits);
//   - the loop (scan_tile.cuh member_max_step) has no NaN test: 3 f64
//     compares and a predicated move, about 5.5 instructions a pair.  Once
//     a tile has landed the block votes (__syncthreads_or) whether its
//     measures hold a NaN, and such a tile runs jmax instead; a NaN acc is
//     never replaced by the compare-only loop, so it stays NaN;
//   - a block stops at its first tile that starts on the sentinel.  That
//     is exact for a sum (the tail's values are 0), not for a max: a range
//     that holds the sentinel (uq = +inf, on a log of negative measures:
//     a MIN table runs in MAX space negated) has the tail's 0 among its
//     members.  Every skipped slot is (sentinel, 0.0), so a block that
//     skipped tiles gives each query with lq <= sentinel <= uq jmax(acc,
//     0.0); a NaN bound fails that test as it fails every membership test.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/k7_k17_rates.py,
// 65,536 ranges): 0.0551 ms on 3,072 live slots of 4,096 (14.0 pairs a
// clock an SM; K16 0.0520 there), 0.0703 on 4,096 (K16 0.0661); 0.0683
// at the smoke's 4,032 (chip_smoke.py, 14.8 pairs a clock an SM, 34% of
// the bound); its loop alone runs 17 pairs a clock an SM, K16's 17-18
// (tools/scan_rates.py).  A tile that holds a NaN measure costs about
// twice a clean one.
//
// Each launcher takes raw device pointers and the CUDA stream, launches on
// that stream, and returns cudaGetLastError() (0 when the launch was
// taken).

#include <cuda_runtime.h>
#include <stdint.h>

#include "locate.cuh"
#include "scan_tile.cuh"

namespace polyfit {
namespace {

constexpr int kThreads = 256;

// K16's shape: 128 threads of 4 queries a block, tiles of 1,024 slots
// (16 KB a buffer), the log split in up to 4 chunks: 512 blocks, about
// four an SM, at Q = 65,536 on a log of four tiles or more
constexpr int kDeltaThreads = 128;
constexpr int kDeltaQueries = 4;
constexpr int kDeltaTile = 1024;
constexpr int kDeltaChunks = 4;

// K15's shape: 128 threads of 4 queries a block, tiles of 128 segments
// (start, next start, aggregate and a word of padding: 4 KB a buffer at
// float64), the table split in up to 4 chunks
constexpr int kMaxThreads = 128;
constexpr int kMaxQueries = 4;
constexpr int kMaxTile = 128;
constexpr int kMaxChunks = 4;

// K14's shape: blocks of 256 threads of one range each (256 blocks at
// Q = 65,536 for 132 SMs), tiles of 128 segment starts (1 KB a buffer at
// float64)
constexpr int kRangeThreads = 256;
constexpr int kRangeTile = 128;

inline int blocks_for(int Q) { return (Q + kThreads - 1) / kThreads; }

// P(u) of segment row ``row``, or of a zero row when row < 0, by Horner
// from the top coefficient (core/poly.py horner on the gathered row)
template <typename T>
__device__ __forceinline__ T row_horner(const T* __restrict__ coeffs, int row,
                                        int deg, T u) {
  const bool hit = row >= 0;
  const T* c = coeffs + (size_t)(hit ? row : 0) * (deg + 1);
  T acc = hit ? c[deg] : T(0);
  for (int j = deg - 1; j >= 0; --j) acc = acc * u + (hit ? c[j] : T(0));
  return acc;
}

// The segment holding q, from c = #(seg_lo <= q): on a plan's table
// (seg_lo non-decreasing, seg_next[j] = seg_lo[j + 1], the sentinel last)
// no segment before c - 1 can (its next start is <= q) and none from c
// on (its start is > q), and segment c - 1 does when q < seg_next[c - 1]:
// the first (only) segment of the one-hot membership.  -1 when none does.
template <typename T>
__device__ __forceinline__ int boundary_row(int c, T q,
                                            const T* __restrict__ seg_next) {
  return c > 0 && q < seg_next[c - 1] ? c - 1 : -1;
}

// K21: P_{I(q)}(q), one key a thread.  On a plan's table (seg_lo
// non-decreasing, seg_next[j] = seg_lo[j + 1], the sentinel last, no NaN)
// the count #(seg_lo <= q), from a descent of seg_lo's search tree
// (tree_count_right), gives the one-hot first hit by boundary_row; its row
// by 16-byte loads (a zero row, lo = hi = 0, where no segment holds q) and
// Horner at the scaled coordinate at the template degree, in the plain
// version's order.  DEG < 0 is the one runtime-degree form (``deg``, a
// coefficient a load), for plans above the instantiated degrees.
template <typename T, int DEG>
__global__ void __launch_bounds__(kThreads) segment_eval_kernel(
    const T* __restrict__ qs, const T* __restrict__ seg_lo,
    const T* __restrict__ seg_next, const T* __restrict__ seg_hi,
    const T* __restrict__ coeffs, const T* __restrict__ tree,
    TreeShape shape, T* __restrict__ out, int Q, int H, int deg) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= Q) return;
  const T q = qs[i];
  const int row =
      boundary_row(tree_count_right(seg_lo, H, tree, shape, q), q, seg_next);
  const bool hit = row >= 0;
  const T lo = hit ? seg_lo[row] : T(0);
  const T hi = hit ? seg_hi[row] : T(0);
  const T u = scale_unit(q, lo, hi);
  if constexpr (DEG >= 0) {
    T c[DEG + 1];
    load_row_v16<DEG>(coeffs, hit ? row : 0, c);
#pragma unroll
    for (int j = 0; j <= DEG; ++j) c[j] = hit ? c[j] : T(0);
    out[i] = horner_r<DEG>(c, u);
  } else {
    out[i] = row_horner(coeffs, row, deg, u);
  }
}

// K14: A = P_{I(u)}(u) - P_{I(l)}(l), one range a thread.  The block walks
// the tiles of seg_lo alone (one word a slot) up to the table's sentinel
// tail, counting #(seg_lo <= lq) and #(seg_lo <= uq) (count_le), then
// finds each endpoint's row by boundary_row (the one-hot first hit, on a
// plan's table) and runs Horner on it at the scaled coordinate, as
// range_sum_plain does: a zero row where no segment holds the endpoint.
template <typename T>
__global__ void __launch_bounds__(kRangeThreads)
    range_sum_scan_kernel(const T* __restrict__ lq, const T* __restrict__ uq,
                          const T* __restrict__ seg_lo,
                          const T* __restrict__ seg_next,
                          const T* __restrict__ seg_hi,
                          const T* __restrict__ coeffs, T* __restrict__ out,
                          int Q, int H, int deg, double sentinel) {
  extern __shared__ double2 s_lo[];
  const int i = blockIdx.x * kRangeThreads + threadIdx.x;
  const int r = i < Q ? i : Q - 1;   // threads past Q still stage tiles
  const T q[2] = {lq[r], uq[r]};
  int c[2] = {0, 0};
  const T* src[1] = {seg_lo};
  walk_slots<1, kRangeTile, true>(src, H, 0, 1, sentinel, (T*)s_lo,
                                  [&](const T lo) {
                                    count_le(c[0], lo, q[0]);
                                    count_le(c[1], lo, q[1]);
                                  });
  if (i >= Q) return;
  T v[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int hit = boundary_row(c[e], q[e], seg_next);
    const T lo = hit >= 0 ? seg_lo[hit] : T(0);
    const T hi = hit >= 0 ? seg_hi[hit] : T(0);
    v[e] = row_horner(coeffs, hit, deg, scale_unit(q[e], lo, hi));
  }
  out[i] = v[1] - v[0];
}

// K15, the scan: a thread holds R queries (i0 + r * THREADS); block (x, y)
// walks the table's tiles y, y + S, y + 2S, ... (S = gridDim.y chunks) up
// to the sentinel tail, and writes each query's #(seg_lo <= lq) and its
// number of interior segments (lo > lq, next <= uq) to rows 2y and 2y + 1
// of ``cnt`` (int32) and the max of their seg_agg to row y of ``part``
template <typename T, int THREADS, int R, int TILE>
__global__ void __launch_bounds__(THREADS)
    range_max_scan_kernel(const T* __restrict__ lq, const T* __restrict__ uq,
                          const T* __restrict__ seg_lo,
                          const T* __restrict__ seg_next,
                          const T* __restrict__ seg_agg, int* __restrict__ cnt,
                          T* __restrict__ part, int Q, int H,
                          double sentinel) {
  extern __shared__ double2 s_seg[];
  const int i0 = blockIdx.x * (THREADS * R) + threadIdx.x;
  T l[R], u[R], m[R];
  int cl[R], ci[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // threads past Q still stage tiles
    const int i = i0 + r * THREADS < Q ? i0 + r * THREADS : Q - 1;
    l[r] = lq[i];
    u[r] = uq[i];
    m[r] = T(-INFINITY);
    cl[r] = ci[r] = 0;
  }
  const T* src[3] = {seg_lo, seg_next, seg_agg};
  walk_slots<4, TILE, true>(
      src, H, blockIdx.y, gridDim.y, sentinel, (T*)s_seg,
      [&](const typename Slot<T, 4>::type s) {
        T w[4];
        slot_words(s, w);
#pragma unroll
        for (int r = 0; r < R; ++r)
          max_scan_step(cl[r], ci[r], m[r], w[0], w[1], w[2], l[r], u[r]);
      });
  const size_t y = blockIdx.y;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * THREADS;
    if (i >= Q) continue;
    cnt[2 * y * Q + i] = cl[r];
    cnt[(2 * y + 1) * Q + i] = ci[r];
    part[y * Q + i] = m[r];
  }
}

// #(seg_lo <= u) from c_l = #(seg_lo <= l) and the number n of interior
// segments (lo > l, next <= u) on a plan's table: the segments with
// next <= u are [0, #(seg_lo <= u) - 1) and those with lo > l start at
// c_l, so a non-empty interior is [c_l, c_l + n) and the count c_l + n + 1;
// an empty one leaves #(seg_lo <= u) at c_l, or c_l + 1 where
// seg_lo[c_l] <= u.  (For l > u or a NaN u it can miss; boundary_row then
// finds no segment for u, or a row on which both clipped maxima are empty
// since max(lo_u, l) > u.)
template <typename T>
__device__ __forceinline__ int upper_count(int c_l, int n, T u,
                                           const T* __restrict__ seg_lo,
                                           int H) {
  if (n > 0) return c_l + n + 1;
  return c_l < H && seg_lo[c_l] <= u ? c_l + 1 : c_l;
}

// K15, the finish: a thread a query adds the S chunks' counts (integers:
// any order is exact) and takes the max of their interior maxima (exact),
// locates the two boundary rows, and runs the closed-form clipped maxima
// on them (paper Eq. 17)
template <typename T>
__global__ void range_max_finish_kernel(
    const T* __restrict__ lq, const T* __restrict__ uq,
    const T* __restrict__ seg_lo, const T* __restrict__ seg_next,
    const T* __restrict__ seg_hi, const T* __restrict__ coeffs,
    const int* __restrict__ cnt, const T* __restrict__ part,
    T* __restrict__ out, int Q, int H, int deg, int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  const T l = lq[i], u = uq[i];
  int c_l = 0, n_int = 0;
  T m_int = T(-INFINITY);
  for (int s = 0; s < S; ++s) {
    c_l += cnt[(size_t)(2 * s) * Q + i];
    n_int += cnt[(size_t)(2 * s + 1) * Q + i];
    m_int = jmax(m_int, part[(size_t)s * Q + i]);
  }
  const int c_u = upper_count(c_l, n_int, u, seg_lo, H);
  // !(lo <= lq) holds on every segment when lq is NaN: no interior
  m_int = isnan(l) ? T(-INFINITY) : m_int;
  const int hit_l = boundary_row(c_l, l, seg_next);
  const int hit_u = boundary_row(c_u, u, seg_next);
  const T zero[4] = {T(0), T(0), T(0), T(0)};
  const T* cl = hit_l >= 0 ? coeffs + (size_t)hit_l * (deg + 1) : zero;
  const T* cu = hit_u >= 0 ? coeffs + (size_t)hit_u * (deg + 1) : zero;
  const T lo_l = hit_l >= 0 ? seg_lo[hit_l] : T(0);
  const T hi_l = hit_l >= 0 ? seg_hi[hit_l] : T(0);
  const T lo_u = hit_u >= 0 ? seg_lo[hit_u] : T(0);
  const T hi_u = hit_u >= 0 ? seg_hi[hit_u] : T(0);
  const bool same = lo_l == lo_u && hi_l == hi_u;
  // left boundary: [lq, min(hi_l, uq)], suppressed when lq is past hi_l
  T m_left = clipped_poly_max(cl, deg, lo_l, hi_l, l, jmin(hi_l, u));
  m_left = l <= hi_l ? m_left : T(-INFINITY);
  // right boundary: [max(lo_u, lq), uq], suppressed when the same segment
  T m_right = clipped_poly_max(cu, deg, lo_u, hi_u, jmax(lo_u, l), u);
  m_right = same ? T(-INFINITY) : m_right;
  out[i] = jmax(jmax(m_left, m_right), m_int);
}

// K16: sum of the buffered measures with key in (lq, uq].  A thread adds
// its R queries' members; block (x, y) walks the log's tiles y, y + S,
// y + 2S, ... (S = gridDim.y chunks) in slot order and writes its partial
// sums to row y of ``part``.  The log is sorted with a sentinel tail of
// value 0 (DeltaBuffer): each block stops at its first tile that starts
// on the sentinel.
template <int THREADS, int R, int TILE>
__global__ void __launch_bounds__(THREADS)
    delta_sum_kernel(const double* __restrict__ lq,
                     const double* __restrict__ uq,
                     const double* __restrict__ keys,
                     const double* __restrict__ vals,
                     double* __restrict__ part, int Q, int D,
                     double sentinel) {
  extern __shared__ double2 s_kv[];
  const int i0 = blockIdx.x * (THREADS * R) + threadIdx.x;
  double l[R], u[R], acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // threads past Q still stage tiles
    const int i = i0 + r * THREADS < Q ? i0 + r * THREADS : Q - 1;
    l[r] = lq[i];
    u[r] = uq[i];
    acc[r] = 0.0;
  }
  const double* src[2] = {keys, vals};
  walk_slots<2, TILE, true>(
      src, D, blockIdx.y, gridDim.y, sentinel, (double*)s_kv,
      [&](const double2 kv) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[r] = acc[r] + ((l[r] < kv.x && kv.x <= u[r]) ? kv.y : 0.0);
      });
  double* row = part + (size_t)blockIdx.y * Q;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (i0 + r * THREADS < Q) row[i0 + r * THREADS] = acc[r];
}

// K16's combine: the S chunk sums of each query added in chunk order
__global__ void delta_sum_combine_kernel(const double* __restrict__ part,
                                         double* __restrict__ out, int Q,
                                         int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  double acc = part[i];
  for (int s = 1; s < S; ++s) acc = acc + part[(size_t)s * Q + i];
  out[i] = acc;
}

// K16 in S chunks: the chunk sums go to ``part`` ((S, Q), unused when
// S = 1), then the combine writes ``out``
template <int THREADS, int R, int TILE>
int launch_delta_sum(const void* lq, const void* uq, const void* keys,
                     const void* vals, void* out, void* part, int Q, int D,
                     double sentinel, int S, cudaStream_t stream) {
  constexpr int per_block = THREADS * R;
  const dim3 grid((Q + per_block - 1) / per_block, S);
  delta_sum_kernel<THREADS, R, TILE>
      <<<grid, THREADS, walk_smem_bytes<2, TILE>(), stream>>>(
          (const double*)lq, (const double*)uq, (const double*)keys,
          (const double*)vals, (double*)(S > 1 ? part : out), Q, D,
          sentinel);
  if (S > 1)
    delta_sum_combine_kernel<<<blocks_for(Q), kThreads, 0, stream>>>(
        (const double*)part, (double*)out, Q, S);
  return (int)cudaGetLastError();
}

// K17: max of the buffered measures with key in [lq, uq], -inf when none
// (NaN where a member's measure is NaN).  A thread holds R queries; block
// (x, y) walks the log's tiles y, y + S, y + 2S, ... (S = gridDim.y chunks)
// in slot order and writes its partial maxima to row y of ``part``.  Once a
// tile has landed the block votes whether its measures hold a NaN: a tile
// that holds none runs member_max_step (no NaN test), one that does runs
// jmax, which leaves acc NaN, and member_max_step never replaces a NaN acc,
// so a NaN stays.  The log is sorted with a sentinel tail of value 0
// (DeltaBuffer): each block stops at its first tile that starts on the
// sentinel, and every slot it skips is (sentinel, 0.0), so a query whose
// range holds the sentinel (lq <= sentinel <= uq: false for a NaN bound)
// takes jmax(acc, 0.0) where its block skipped tiles.
template <int THREADS, int R, int TILE>
__global__ void __launch_bounds__(THREADS)
    delta_max_kernel(const double* __restrict__ lq,
                     const double* __restrict__ uq,
                     const double* __restrict__ keys,
                     const double* __restrict__ vals,
                     double* __restrict__ part, int Q, int D,
                     double sentinel) {
  extern __shared__ double2 s_kv[];
  const int i0 = blockIdx.x * (THREADS * R) + threadIdx.x;
  double l[R], u[R], acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // threads past Q still stage tiles
    const int i = i0 + r * THREADS < Q ? i0 + r * THREADS : Q - 1;
    l[r] = lq[i];
    u[r] = uq[i];
    acc[r] = -INFINITY;
  }
  const double* src[2] = {keys, vals};
  const bool skipped = walk_tiles<2, TILE, true>(
      src, D, blockIdx.y, gridDim.y, sentinel, (double*)s_kv,
      [&](const double2* kv, int m) {
        bool nan = false;
        for (int k = threadIdx.x; k < m; k += THREADS) nan |= isnan(kv[k].y);
        if (__syncthreads_or(nan)) {
          for (int k = 0; k < m; ++k) {
            const double2 s = kv[k];
#pragma unroll
            for (int r = 0; r < R; ++r)
              acc[r] = jmax(acc[r], (l[r] <= s.x && s.x <= u[r])
                                        ? s.y : -INFINITY);
          }
        } else if (m == TILE) {
#pragma unroll 8
          for (int k = 0; k < TILE; ++k) {
            const double2 s = kv[k];
#pragma unroll
            for (int r = 0; r < R; ++r)
              member_max_step(acc[r], s.x, s.y, l[r], u[r]);
          }
        } else {
          for (int k = 0; k < m; ++k) {
            const double2 s = kv[k];
#pragma unroll
            for (int r = 0; r < R; ++r)
              member_max_step(acc[r], s.x, s.y, l[r], u[r]);
          }
        }
      });
  double* row = part + (size_t)blockIdx.y * Q;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (skipped && l[r] <= sentinel && sentinel <= u[r])
      acc[r] = jmax(acc[r], 0.0);
    if (i0 + r * THREADS < Q) row[i0 + r * THREADS] = acc[r];
  }
}

// K17 in S chunks: the chunk maxima go to ``part`` ((S, Q), unused when
// S = 1), then the combine writes ``out``
template <int THREADS, int R, int TILE>
int launch_delta_max(const void* lq, const void* uq, const void* keys,
                     const void* vals, void* out, void* part, int Q, int D,
                     double sentinel, int S, cudaStream_t stream) {
  constexpr int per_block = THREADS * R;
  const dim3 grid((Q + per_block - 1) / per_block, S);
  delta_max_kernel<THREADS, R, TILE>
      <<<grid, THREADS, walk_smem_bytes<2, TILE>(), stream>>>(
          (const double*)lq, (const double*)uq, (const double*)keys,
          (const double*)vals, (double*)(S > 1 ? part : out), Q, D,
          sentinel);
  if (S > 1)
    chunk_max_combine_kernel<double><<<blocks_for(Q), kThreads, 0, stream>>>(
        (const double*)part, (double*)out, Q, S);
  return (int)cudaGetLastError();
}

// K21 at one instantiation a degree 0-8 (K2's range), the runtime-degree
// form above them, one key a thread
template <typename T>
int launch_segment_eval(const void* q, const void* seg_lo,
                        const void* seg_next, const void* seg_hi,
                        const void* coeffs, const void* tree, void* out, int Q,
                        int H, int deg, void* stream) {
  if (Q > 0) {
    const TreeShape shape = tree_shape(H);
#define K21_LAUNCH(D)                                                       \
  segment_eval_kernel<T, D><<<blocks_for(Q), kThreads, 0,                   \
                              (cudaStream_t)stream>>>(                      \
      (const T*)q, (const T*)seg_lo, (const T*)seg_next, (const T*)seg_hi,  \
      (const T*)coeffs, (const T*)tree, shape, (T*)out, Q, H, deg)
    switch (deg) {
      case 0: K21_LAUNCH(0); break;
      case 1: K21_LAUNCH(1); break;
      case 2: K21_LAUNCH(2); break;
      case 3: K21_LAUNCH(3); break;
      case 4: K21_LAUNCH(4); break;
      case 5: K21_LAUNCH(5); break;
      case 6: K21_LAUNCH(6); break;
      case 7: K21_LAUNCH(7); break;
      case 8: K21_LAUNCH(8); break;
      default: K21_LAUNCH(-1); break;
    }
#undef K21_LAUNCH
  }
  return (int)cudaGetLastError();
}

// K14 in one launch: the walk and the rows
template <typename T>
int launch_range_sum(const void* lq, const void* uq, const void* seg_lo,
                     const void* seg_next, const void* seg_hi,
                     const void* coeffs, void* out, int Q, int H, int deg,
                     double sentinel, void* stream) {
  if (Q > 0)
    range_sum_scan_kernel<T>
        <<<(Q + kRangeThreads - 1) / kRangeThreads, kRangeThreads,
           walk_smem_bytes<1, kRangeTile, T>(), (cudaStream_t)stream>>>(
            (const T*)lq, (const T*)uq, (const T*)seg_lo, (const T*)seg_next,
            (const T*)seg_hi, (const T*)coeffs, (T*)out, Q, H, deg, sentinel);
  return (int)cudaGetLastError();
}

// K15 in S chunks: the scan kernel's partials go to ``cnt`` ((2S, Q)
// int32) and ``part`` ((S, Q)), then the finish kernel writes ``out``
template <typename T>
int launch_range_max(const void* lq, const void* uq, const void* seg_lo,
                     const void* seg_next, const void* seg_hi,
                     const void* coeffs, const void* seg_agg, void* out,
                     void* cnt, void* part, int Q, int H, int deg,
                     double sentinel, void* stream) {
  if (deg > 3) return (int)cudaErrorInvalidValue;
  if (Q <= 0) return (int)cudaGetLastError();
  constexpr int per_block = kMaxThreads * kMaxQueries;
  const int S = walk_chunks<kMaxTile>(H, kMaxChunks);
  const dim3 grid((Q + per_block - 1) / per_block, S);
  range_max_scan_kernel<T, kMaxThreads, kMaxQueries, kMaxTile>
      <<<grid, kMaxThreads, walk_smem_bytes<4, kMaxTile, T>(),
         (cudaStream_t)stream>>>((const T*)lq, (const T*)uq,
                                 (const T*)seg_lo, (const T*)seg_next,
                                 (const T*)seg_agg, (int*)cnt, (T*)part, Q, H,
                                 sentinel);
  range_max_finish_kernel<T>
      <<<blocks_for(Q), kThreads, 0, (cudaStream_t)stream>>>(
          (const T*)lq, (const T*)uq, (const T*)seg_lo, (const T*)seg_next,
          (const T*)seg_hi, (const T*)coeffs, (const int*)cnt,
          (const T*)part, (T*)out, Q, H, deg, S);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace polyfit

extern "C" {

int polyfit_range_sum(const void* lq, const void* uq, const void* seg_lo,
                      const void* seg_next, const void* seg_hi,
                      const void* coeffs, void* out, int Q, int H, int deg,
                      double sentinel, void* stream) {
  return polyfit::launch_range_sum<double>(lq, uq, seg_lo, seg_next, seg_hi,
                                          coeffs, out, Q, H, deg, sentinel,
                                          stream);
}

int polyfit_range_sum_f32(const void* lq, const void* uq, const void* seg_lo,
                          const void* seg_next, const void* seg_hi,
                          const void* coeffs, void* out, int Q, int H, int deg,
                          double sentinel, void* stream) {
  return polyfit::launch_range_sum<float>(lq, uq, seg_lo, seg_next, seg_hi,
                                          coeffs, out, Q, H, deg, sentinel,
                                          stream);
}

// ``tree``: seg_lo's search tree (kernels/locate.py search_tree); seg_lo,
// coeffs and tree 16-byte aligned; the table in a plan's layout
int polyfit_poly_eval(const void* q, const void* seg_lo, const void* seg_next,
                      const void* seg_hi, const void* coeffs, const void* tree,
                      void* out, int Q, int H, int deg, void* stream) {
  return polyfit::launch_segment_eval<double>(q, seg_lo, seg_next, seg_hi,
                                              coeffs, tree, out, Q, H, deg,
                                              stream);
}

int polyfit_poly_eval_f32(const void* q, const void* seg_lo,
                          const void* seg_next, const void* seg_hi,
                          const void* coeffs, const void* tree, void* out,
                          int Q, int H, int deg, void* stream) {
  return polyfit::launch_segment_eval<float>(q, seg_lo, seg_next, seg_hi,
                                             coeffs, tree, out, Q, H, deg,
                                             stream);
}

int polyfit_range_max_chunks(int H) {
  return polyfit::walk_chunks<polyfit::kMaxTile>(H, polyfit::kMaxChunks);
}

// ``cnt``: (2S, Q) int32 and ``part``: (S, Q) scratch of the table's type,
// S = polyfit_range_max_chunks(H)
int polyfit_range_max(const void* lq, const void* uq, const void* seg_lo,
                      const void* seg_next, const void* seg_hi,
                      const void* coeffs, const void* seg_agg, void* out,
                      void* cnt, void* part, int Q, int H, int deg,
                      double sentinel, void* stream) {
  return polyfit::launch_range_max<double>(lq, uq, seg_lo, seg_next, seg_hi,
                                           coeffs, seg_agg, out, cnt, part, Q,
                                           H, deg, sentinel, stream);
}

int polyfit_range_max_f32(const void* lq, const void* uq, const void* seg_lo,
                          const void* seg_next, const void* seg_hi,
                          const void* coeffs, const void* seg_agg, void* out,
                          void* cnt, void* part, int Q, int H, int deg,
                          double sentinel, void* stream) {
  return polyfit::launch_range_max<float>(lq, uq, seg_lo, seg_next, seg_hi,
                                          coeffs, seg_agg, out, cnt, part, Q,
                                          H, deg, sentinel, stream);
}

int polyfit_delta_sum_chunks(int D) {
  return polyfit::walk_chunks<polyfit::kDeltaTile>(D, polyfit::kDeltaChunks);
}

int polyfit_delta_sum(const void* lq, const void* uq, const void* keys,
                      const void* vals, void* out, void* part, int Q, int D,
                      double sentinel, void* stream) {
  using namespace polyfit;
  if (Q <= 0) return (int)cudaGetLastError();
  return launch_delta_sum<kDeltaThreads, kDeltaQueries, kDeltaTile>(
      lq, uq, keys, vals, out, part, Q, D, sentinel,
      walk_chunks<kDeltaTile>(D, kDeltaChunks), (cudaStream_t)stream);
}

int polyfit_delta_max_chunks(int D) {
  return polyfit::walk_chunks<polyfit::kDeltaTile>(D, polyfit::kDeltaChunks);
}

int polyfit_delta_max(const void* lq, const void* uq, const void* keys,
                      const void* vals, void* out, void* part, int Q, int D,
                      double sentinel, void* stream) {
  using namespace polyfit;
  if (Q <= 0) return (int)cudaGetLastError();
  return launch_delta_max<kDeltaThreads, kDeltaQueries, kDeltaTile>(
      lq, uq, keys, vals, out, part, Q, D, sentinel,
      walk_chunks<kDeltaTile>(D, kDeltaChunks), (cudaStream_t)stream);
}

}  // extern "C"
