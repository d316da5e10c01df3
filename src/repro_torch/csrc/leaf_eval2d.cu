// PolyFit two-key leaf evaluation for Hopper (sm_90a), float64.
//
// K7  corner_count2d_gather_kernel  replaces repro/kernels/leaf_eval2d.py:corner_count2d_gather_pallas
// K8  corner_eval2d_gather_kernel   replaces repro/kernels/leaf_eval2d.py:corner_eval2d_gather_pallas
// K12 corner_count2d_scan_kernel + corner_count2d_finish_kernel
//                                   replaces repro/kernels/leaf_eval2d.py:corner_count2d_pallas
// K13 corner_eval2d_scan_kernel + corner_eval2d_finish_kernel
//                                   replaces repro/kernels/leaf_eval2d.py:corner_eval2d_pallas
//
// Twins of repro_torch/kernels/leaf_eval2d.py's plain versions, in their
// order of operations (compiled with -fmad=false, so every multiply and add
// rounds on its own as torch's do).  A corner (qx, qy) is answered by the
// fitted surface of the quadtree leaf holding it: span = b1 > b0 ? b1 - b0
// : 1, u = clip((2 qx - b0 - b1) / span, -1, 1) (v likewise), then Horner in
// v inside Horner in u, both from 0, inner = inner * v + c[i (deg+1) + j].
// K7 and K12 combine the corners (ux,uy), (lx,uy), (ux,ly), (lx,ly) with
// signs + - - + (paper Eq. 19); K8 and K13 evaluate one corner (dominance
// MAX/MIN).  The degree is a template parameter up to kMaxDeg2d, so a
// leaf's (deg+1)^2 coefficients (16 at deg 3) sit in registers.
//
// Gather (K7, K8): a corner's leaf is its cell (the number of x cuts and
// of y cuts at or below it), then a branch-free binary search of the
// cell's int32 Morton code in the z-sorted table, then one row.  Both rank
// a coordinate by a checked guess (locate.cuh cut_rank_guess), build the
// code by bit tricks (morton2) and read rows by 16-byte loads; K7 runs
// four threads a rectangle, K8 two a corner (below).
//
// Scan (K12, K13), the path of plans deeper than 15 levels (no int32 Morton
// codes): every corner is tested against the flat leaf table's membership
// boxes, mx0 <= qx < mx1 and my0 <= qy < my1, and takes the leaf that
// holds it.  Leaves partition the root, so that row is the one the
// reference's one-hot matmul sums up (its other terms are 0 * x with x
// finite), and no leaf gives a zero row.  Both run the tile walker
// (scan_tile.cuh) over the table in chunks, then a finish kernel that
// takes each corner's leaf and evaluates its row (below).
//
// What bounds them on an H100.  K7 at osm's Q = 65,536 and 2,560 leaves
// must move 5 x 8 B a query plus the table (cut grids, codes, bounds and
// 16 coefficients a leaf) once, about 0.6 MB: 0.93 us at 3.35 TB/s.  What
// it does instead is scattered loads from L1 and L2.  Before its redesign
// it ran one thread a rectangle and located each of its four corners in
// sequence: three binary searches (13 rounds each over 4,095 x cuts, 4,095
// y cuts and the codes) and a row of 20 8-byte loads, 236 loads a
// rectangle, at 1.4 a clock an SM (0.0413 ms).  Its design now:
//   - four threads a rectangle, one a corner: four times the warps in
//     flight, a leaf-code search and a row each, and the four values
//     combined in the plain order by shuffles;
//   - each of the two x and two y values is ranked once, by one of the
//     four lanes (locate.cuh cut_rank_guess): a guess from the end cuts,
//     checked against the cuts around it, exact on sorted cuts, about 4
//     loads instead of 13;
//   - rows by 16-byte loads (leaf_value_v16): 10 a corner at deg 3, not
//     20; the wrapper refuses tables that do not start on 16 bytes;
//   - the Morton code from bit tricks (morton2), not a loop a bit.
// That is 108 loads a rectangle at osm, served at about 1.5 a clock an SM
// (tools/k7_k17_rates.py on an OSM-like table, which adds each step alone,
// three calls on an NVIDIA H100 80GB HBM3 at 700 W: 0.0426-0.0428 ms
// before, 0.0184-0.0187 now; chip_smoke.py at osm: 0.0173 ms, 1.56 loads
// a clock an SM).  The same steps at one thread a rectangle, the four
// code searches in lockstep, ran 2-4% slower (104 registers), at two
// threads 4-28% slower; staging the codes in shared memory by cp.async
// gained at most 2% at one thread and lost 5-8% at four (each block
// stages all 10 KB); capping the registers at 40 or 32 for occupancy
// spilled and lost 24-30%.  The rows (40 of the 108 loads, 640 bytes a
// rectangle) come mostly from L2; at 8 x the rectangles the rate reaches
// 1.9 a clock, so about a fifth of the time is the grid's ramp and tail.
// K8 at osm's Q = 65,536 must move 3 x 8 B a corner plus the same table,
// about 2.1 MB, 0.61 us.  Before its redesign it ran one thread a corner:
// three binary searches (13 rounds each) and a row of 20 8-byte loads, 59
// loads a corner at 1.1 a clock an SM (0.0136 ms).  Its design now is
// K7's steps (about 31 loads a corner at deg 3) at two threads a corner:
//   - lane e ranks coordinate e (cut_rank_guess), and shuffles give both
//     lanes the corner and its cell;
//   - both lanes search the leaf codes (one address: a load serves both)
//     and split the row (leaf_value_pair): each reads and evaluates the
//     inner Horner of every other coefficient row, and lane 0 runs the
//     outer Horner in the plain order, the odd rows' values shuffled in,
//     so the answer is leaf_value's bit for bit.
// tools/k5_k8_rates.py on an OSM-like table (NVIDIA H100 80GB HBM3 at 700
// W): 0.0065 ms, 2.1x the old kernel; one thread a corner ran 0.0080-
// 0.0083, two threads with lane 0 alone searching and evaluating 0.0076;
// a search tree over the codes (5 sector loads for 13 rounds) saved
// nothing at deg 3 and 6-7% at deg 2, under the 15% that would pay for a
// plan field.
// K12 on the same table must move the same bytes but compares every corner
// with every leaf: its bound counts 4 compares a corner, 16 f64
// operations a (query, leaf) pair at the FP64 peak (which counts an FMA as
// two), 0.0793 ms at osm's 65,536 x 2,560: the 8 compares a pair its four
// corners need on two x and two y coordinates, at one a lane a clock.
// Before its redesign it ran K13's loop over four corners, first hit kept:
// 12 compares and 4 tests and selects a pair, about 22 instructions in the
// compiled loop, 4.0-4.1 pairs a clock an SM (tools/scan_rates.py).  Its
// design now:
//   - the loop (scan_tile.cuh corner_hits_step) tests the query's two x
//     coordinates against the leaf's x bounds and its two y coordinates
//     against the y bounds once, 8 compares, and each corner takes the
//     leaf's index under the AND of its x and y tests: no first-hit test,
//     since a plan's leaves partition the root and the corners are clamped
//     into it, so at most one leaf holds a corner
//     (tests/test_torch_scan2d.py holds the partition);
//   - the tile walker (scan_tile.cuh) stages the four bounds of a leaf as
//     one slot (two 16-byte shared loads), 128 leaves a tile,
//     double-buffered, and stops at the table's sentinel-padded tail;
//   - a thread holds 2 queries (8 corners), and the table is cut in up to
//     4 chunks of interleaved tiles along the grid's second dimension;
//     each chunk writes each corner's leaf (-1 for none), and a finish
//     kernel takes the lowest index over the chunks (exact, independent of
//     order), evaluates the four rows and combines them, one thread a
//     query.
// The loop alone runs 4.6-4.8 (query, leaf) pairs a clock an SM at 2
// queries a thread on an NVIDIA H100 80GB HBM3 at 700 W (5.2-5.4 at one;
// tools/scan_rates.py): about 19.7 instructions a pair, 8 of them f64
// compares, 4 predicate ANDs, 4 selects and predicate moves, issued at
// about 3 a clock; half the bound needs 4.  The kernel runs 4.3 at osm
// (chip_smoke.py, 0.1438 ms).
// K13 must do 4 compares a (corner, live leaf) pair, 0.0193 ms at the FP64
// peak for 65,536 corners against 2,467 live leaves.  Before its redesign
// it ran one corner a thread in 256-leaf tiles of four 8-byte shared loads
// a leaf, a first-hit test on every pair, every leaf of the table: 6.6
// pairs a clock an SM (0.094 ms).  It now runs K12's design with one
// corner a query:
//   - the loop (scan_tile.cuh corner_hit_step): 4 f64 compares, each
//     ANDing the one before in, and a predicated move of the leaf index;
//   - the tile walker over the four bounds (two 16-byte shared loads a
//     leaf, 128 leaves a tile), 8 corners a thread, the table in up to 4
//     chunks, a stop at the sentinel tail;
//   - a finish kernel, one thread a corner, takes the lowest leaf over the
//     chunks and evaluates its row by 16-byte loads (leaf_value_v16), the
//     zero row where no leaf holds the corner (a NaN corner, or one past
//     the root), as the plain version does.
// On an NVIDIA H100 80GB HBM3 at 700 W (tools/k13_k19_rates.py, on an
// OSM-like table of 2,467 leaves): 0.0564 ms, 11.0 pairs a clock an SM;
// 4 corners a thread 4% slower, rows by 8-byte loads 3%, one chunk 1.9x.
//
// Each launcher takes raw device pointers and the CUDA stream, launches on
// that stream, and returns cudaGetLastError() (0 when the launch was
// taken); a degree above kMaxDeg2d returns cudaErrorInvalidValue.

#include <cuda_runtime.h>
#include <stdint.h>

#include "locate.cuh"
#include "scan_tile.cuh"

namespace polyfit {
namespace {

constexpr int kThreads = 256;
// kernels/leaf_eval2d.py MAX_DEG_2D: one instantiation per degree
constexpr int kMaxDeg2d = 5;
// K12's shape: 128 threads of 2 queries (8 corners) a block, tiles of 128
// leaves (four membership bounds: 4 KB a buffer), the table split in up
// to 4 chunks
constexpr int kCountThreads = 128;
constexpr int kCountQueries = 2;
constexpr int kCountTile = 128;
constexpr int kCountChunks = 4;

// q scaled to a leaf's box [lo, hi] on one axis: (2q - lo - hi) / span
// clipped to [-1, 1], span 1 for a box of no width (core/poly.py)
__device__ __forceinline__ double unit_coord(double q, double lo, double hi) {
  const double span = hi > lo ? hi - lo : 1.0;
  return jclip((2.0 * q - lo - hi) / span, -1.0, 1.0);
}

// P_leaf(u(qx), v(qy)) of a leaf row held in registers: bounds b0..b3,
// coefficients c
template <int DEG>
__device__ __forceinline__ double row_value(
    double qx, double qy, const double (&b)[4],
    const double (&c)[(DEG + 1) * (DEG + 1)]) {
  const double us = unit_coord(qx, b[0], b[1]);
  const double vs = unit_coord(qy, b[2], b[3]);
  double acc = 0.0;
#pragma unroll
  for (int i = DEG; i >= 0; --i) {
    double inner = 0.0;
#pragma unroll
    for (int j = DEG; j >= 0; --j) inner = inner * vs + c[i * (DEG + 1) + j];
    acc = acc * us + inner;
  }
  return acc;
}

// P_leaf(u(qx), v(qy)) of one leaf row (bounds b0..b3, coefficients c);
// hit false evaluates a zero row (a scan corner no leaf holds)
template <int DEG>
__device__ __forceinline__ double leaf_value(double qx, double qy, int leaf,
                                             bool hit,
                                             const double* __restrict__ bounds,
                                             const double* __restrict__ coeffs) {
  constexpr int K = (DEG + 1) * (DEG + 1);
  double b[4], c[K];
#pragma unroll
  for (int e = 0; e < 4; ++e) b[e] = hit ? bounds[(size_t)leaf * 4 + e] : 0.0;
#pragma unroll
  for (int e = 0; e < K; ++e) c[e] = hit ? coeffs[(size_t)leaf * K + e] : 0.0;
  return row_value<DEG>(qx, qy, b, c);
}

// leaf_value of a row that a leaf holds, read by 16-byte loads: the bounds
// as two, and the coefficients as (DEG + 1)^2 / 2 where that count is even
// (deg 1, 3, 5; a row of an odd count starts 8 bytes off 16 every other
// leaf, so deg 0, 2 and 4 read them 8 bytes at a time).  ``bounds`` and
// ``coeffs`` must be 16-byte aligned (kernels/leaf_eval2d.py checks).
template <int DEG>
__device__ __forceinline__ double leaf_value_v16(
    double qx, double qy, int leaf, const double* __restrict__ bounds,
    const double* __restrict__ coeffs) {
  constexpr int K = (DEG + 1) * (DEG + 1);
  double b[4], c[K];
  load_row_v16<3>(bounds, leaf, b);
  load_row_v16<K - 1>(coeffs, leaf, c);
  return row_value<DEG>(qx, qy, b, c);
}

// K7: 4-corner COUNT/SUM over (lx, ux] x (ly, uy], one thread a corner:
// lanes 4q .. 4q + 3 of the grid answer rectangle q.  Lane e first ranks
// value e of (ux, lx, uy, ly) against its axis' cuts (cut_rank_guess), so
// each of the two x and two y values is ranked once; then it takes corner
// e = (x[e & 1], y[e >> 1]), x = (ux, lx), y = (uy, ly), in the plain
// version's sign order, with its coordinates and cell from the lanes that
// ranked them (shuffles), searches the leaf codes for the cell's Morton
// code and evaluates the leaf's row (16-byte loads); lane 0 combines the
// four values in the plain order, v0 - v1 - v2 + v3.
template <int DEG>
__global__ void __launch_bounds__(kThreads) corner_count2d_gather_kernel(
    const double* __restrict__ lx, const double* __restrict__ ux,
    const double* __restrict__ ly, const double* __restrict__ uy,
    const double* __restrict__ xcuts, const double* __restrict__ ycuts,
    const int32_t* __restrict__ leaf_z, const double* __restrict__ bounds,
    const double* __restrict__ coeffs, double* __restrict__ out, int Q,
    int nx, int ny, int L, int depth) {
  constexpr unsigned kAll = 0xffffffffu;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int e = threadIdx.x & 3;
  // lanes past Q still join the shuffles
  const int q = t / 4 < Q ? (int)(t / 4) : Q - 1;
  const double* src = e == 0 ? ux : (e == 1 ? lx : (e == 2 ? uy : ly));
  const double val = src[q];
  // one inlined search for both axes: the lanes do not split on it
  const int rank =
      cut_rank_guess(e < 2 ? xcuts : ycuts, e < 2 ? nx : ny, val);
  const int xl = e & 1, yl = 2 + (e >> 1);
  const double qx = __shfl_sync(kAll, val, xl, 4);
  const double qy = __shfl_sync(kAll, val, yl, 4);
  const int32_t z = morton2(__shfl_sync(kAll, rank, xl, 4),
                            __shfl_sync(kAll, rank, yl, 4), depth);
  const int c = bsearch_count_right(leaf_z, L, z) - 1;
  const double v = leaf_value_v16<DEG>(qx, qy, c > 0 ? c : 0, bounds, coeffs);
  const double v1 = __shfl_sync(kAll, v, 1, 4);
  const double v2 = __shfl_sync(kAll, v, 2, 4);
  const double v3 = __shfl_sync(kAll, v, 3, 4);
  if (e == 0 && t / 4 < Q) out[q] = v - v1 - v2 + v3;
}

// leaf_value_v16 of corner (qx, qy) split over a pair of lanes (e = 0, 1,
// both holding the corner and its leaf): lane e takes the rows i = e, e +
// 2, ... of the coefficient block, each's inner Horner in v from 0 (16
// bytes a load where a row's length is even: deg 1, 3, 5), and lane 0
// runs the outer Horner in u in the plain order, acc = acc * us + inner_i
// for i = DEG down to 0, the odd rows' inner values shuffled from lane 1.
// Each inner value is computed as leaf_value computes it, so lane 0's
// result is leaf_value's bit for bit; lane 1's is not used.  Both lanes of
// every pair of the warp must call it (the shuffles).  ``bounds`` and
// ``coeffs`` must be 16-byte aligned (kernels/leaf_eval2d.py checks).
template <int DEG>
__device__ __forceinline__ double leaf_value_pair(
    double qx, double qy, int leaf, int e, const double* __restrict__ bounds,
    const double* __restrict__ coeffs) {
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int D1 = DEG + 1, R = (DEG + 2) / 2;
  double b[4];
  load_row_v16<3>(bounds, leaf, b);
  const double us = unit_coord(qx, b[0], b[1]);
  const double vs = unit_coord(qy, b[2], b[3]);
  double in[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = 2 * k + e;
    double inner = 0.0;
    if (i <= DEG) {
      // row i of the leaf's block is row leaf * D1 + i of D1 values
      double c[D1];
      load_row_v16<DEG>(coeffs, leaf * D1 + i, c);
#pragma unroll
      for (int j = DEG; j >= 0; --j) inner = inner * vs + c[j];
    }
    in[k] = inner;
  }
  double acc = 0.0;
#pragma unroll
  for (int i = DEG; i >= 0; --i) {
    double inner = in[i >> 1];
    if (i & 1) inner = __shfl_sync(kAll, inner, 1, 2);
    acc = acc * us + inner;
  }
  return acc;
}

// K8: single-corner P_leaf(u, v), two threads a corner: lanes 2q and 2q + 1
// of the grid answer corner q.  Lane e ranks coordinate e of (u, v) against
// its axis' cuts (cut_rank_guess); shuffles give both lanes the corner and
// its cell; both search the leaf codes for the cell's Morton code (the
// same search: a load serves both lanes), then split the leaf's row
// (leaf_value_pair), and lane 0 writes it.
template <int DEG>
__global__ void __launch_bounds__(kThreads) corner_eval2d_gather_kernel(
    const double* __restrict__ u, const double* __restrict__ v,
    const double* __restrict__ xcuts, const double* __restrict__ ycuts,
    const int32_t* __restrict__ leaf_z, const double* __restrict__ bounds,
    const double* __restrict__ coeffs, double* __restrict__ out, int Q,
    int nx, int ny, int L, int depth) {
  constexpr unsigned kAll = 0xffffffffu;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int e = threadIdx.x & 1;
  // lanes past Q still join the shuffles
  const int q = t / 2 < Q ? (int)(t / 2) : Q - 1;
  const double val = (e ? v : u)[q];
  // one inlined search for both axes: the lanes do not split on it
  const int rank = cut_rank_guess(e ? ycuts : xcuts, e ? ny : nx, val);
  const double qx = __shfl_sync(kAll, val, 0, 2);
  const double qy = __shfl_sync(kAll, val, 1, 2);
  const int32_t z = morton2(__shfl_sync(kAll, rank, 0, 2),
                            __shfl_sync(kAll, rank, 1, 2), depth);
  const int c = bsearch_count_right(leaf_z, L, z) - 1;
  const double a =
      leaf_value_pair<DEG>(qx, qy, c > 0 ? c : 0, e, bounds, coeffs);
  if (e == 0 && t / 2 < Q) out[q] = a;
}

// K12, the scan: a thread holds R queries (i0 + r * THREADS), 4R corners
// on two x and two y coordinates each; block (x, y) walks the leaf
// table's tiles y, y + S, y + 2S, ... (S = gridDim.y chunks) up to the
// sentinel tail, tests each leaf's x bounds against the two x coordinates
// and its y bounds against the two y coordinates once, and keeps for each
// corner the leaf whose box holds both of its coordinates (leaves
// partition the root and the corners are clamped into it: at most one
// leaf holds a corner).  It writes corner e's leaf, -1 for none, to row
// 4y + e of ``hits`` (int32), in sign order (ux,uy), (lx,uy), (ux,ly),
// (lx,ly).
template <int THREADS, int R, int TILE>
__global__ void __launch_bounds__(THREADS) corner_count2d_scan_kernel(
    const double* __restrict__ lx, const double* __restrict__ ux,
    const double* __restrict__ ly, const double* __restrict__ uy,
    const double* __restrict__ mx0, const double* __restrict__ mx1,
    const double* __restrict__ my0, const double* __restrict__ my1,
    int* __restrict__ hits, int Q, int L, double sentinel) {
  extern __shared__ double2 s_box[];
  const int i0 = blockIdx.x * (THREADS * R) + threadIdx.x;
  double x[R][2], y[R][2];
  int hit[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // threads past Q still stage tiles
    const int i = i0 + r * THREADS < Q ? i0 + r * THREADS : Q - 1;
    x[r][0] = ux[i];
    x[r][1] = lx[i];
    y[r][0] = uy[i];
    y[r][1] = ly[i];
#pragma unroll
    for (int e = 0; e < 4; ++e) hit[r][e] = -1;
  }
  const double* src[4] = {mx0, mx1, my0, my1};
  walk_slots<4, TILE, true>(
      src, L, blockIdx.y, gridDim.y, sentinel, (double*)s_box,
      [&](const double2x2 box, int j) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          corner_hits_step(hit[r], x[r], y[r], box, j);
      });
  const size_t row = 4 * (size_t)blockIdx.y;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * THREADS;
    if (i >= Q) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) hits[(row + e) * Q + i] = hit[r][e];
  }
}

// K12, the finish: a thread a query takes each corner's leaf from the S
// chunks (the lowest index found; at most one chunk finds one), evaluates
// the four rows (zeros where no leaf holds a corner) and combines them
// + - - + (paper Eq. 19)
template <int DEG>
__global__ void corner_count2d_finish_kernel(
    const double* __restrict__ lx, const double* __restrict__ ux,
    const double* __restrict__ ly, const double* __restrict__ uy,
    const int* __restrict__ hits, const double* __restrict__ bounds,
    const double* __restrict__ coeffs, double* __restrict__ out, int Q,
    int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  const double qx[4] = {ux[i], lx[i], ux[i], lx[i]};
  const double qy[4] = {uy[i], uy[i], ly[i], ly[i]};
  double v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    // -1 (none) is the largest unsigned value: the min keeps any hit
    unsigned leaf = (unsigned)hits[(size_t)e * Q + i];
    for (int s = 1; s < S; ++s)
      leaf = min(leaf, (unsigned)hits[(size_t)(4 * s + e) * Q + i]);
    const int h = (int)leaf;
    v[e] = leaf_value<DEG>(qx[e], qy[e], h, h >= 0, bounds, coeffs);
  }
  out[i] = v[0] - v[1] - v[2] + v[3];
}

// K13, the scan: a thread holds R corners (i0 + r * THREADS); block (x, y)
// walks the leaf table's tiles y, y + S, y + 2S, ... (S = gridDim.y chunks)
// up to the sentinel tail and keeps for each corner the leaf whose box holds
// it (leaves partition the root and the corners are clamped into it: at
// most one leaf holds a corner; none holds a NaN one).  It writes each
// corner's leaf, -1 for none, to row y of ``hits`` (int32).
template <int THREADS, int R, int TILE>
__global__ void __launch_bounds__(THREADS) corner_eval2d_scan_kernel(
    const double* __restrict__ u, const double* __restrict__ v,
    const double* __restrict__ mx0, const double* __restrict__ mx1,
    const double* __restrict__ my0, const double* __restrict__ my1,
    int* __restrict__ hits, int Q, int L, double sentinel) {
  extern __shared__ double2 s_box[];
  const int i0 = blockIdx.x * (THREADS * R) + threadIdx.x;
  double x[R], y[R];
  int hit[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // threads past Q still stage tiles
    const int i = i0 + r * THREADS < Q ? i0 + r * THREADS : Q - 1;
    x[r] = u[i];
    y[r] = v[i];
    hit[r] = -1;
  }
  const double* src[4] = {mx0, mx1, my0, my1};
  walk_slots<4, TILE, true>(
      src, L, blockIdx.y, gridDim.y, sentinel, (double*)s_box,
      [&](const double2x2 box, int j) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          corner_hit_step(hit[r], x[r], y[r], box, j);
      });
  int* row = hits + (size_t)blockIdx.y * Q;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (i0 + r * THREADS < Q) row[i0 + r * THREADS] = hit[r];
}

// K13, the finish: a thread a corner takes its leaf from the S chunks (the
// lowest index found; at most one chunk finds one) and evaluates the row,
// the zero row where no leaf holds the corner (as the plain version does);
// with V16 a held row by 16-byte loads (leaf_value_v16)
template <int DEG, bool V16>
__global__ void corner_eval2d_finish_kernel(
    const double* __restrict__ u, const double* __restrict__ v,
    const int* __restrict__ hits, const double* __restrict__ bounds,
    const double* __restrict__ coeffs, double* __restrict__ out, int Q,
    int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  // -1 (none) is the largest unsigned value: the min keeps any hit
  unsigned leaf = (unsigned)hits[i];
  for (int s = 1; s < S; ++s)
    leaf = min(leaf, (unsigned)hits[(size_t)s * Q + i]);
  const int h = (int)leaf;
  if (V16 && h >= 0)
    out[i] = leaf_value_v16<DEG>(u[i], v[i], h, bounds, coeffs);
  else
    out[i] = leaf_value<DEG>(u[i], v[i], h, h >= 0, bounds, coeffs);
}

// K13's shape: 128 threads of 8 corners a block, tiles of 128 leaves (4 KB
// a buffer), the table split in up to 4 chunks, rows by 16-byte loads
constexpr int kEvalThreads = 128;
constexpr int kEvalQueries = 8;
constexpr int kEvalTile = 128;
constexpr int kEvalChunks = 4;
constexpr bool kEvalV16 = true;

inline int blocks_for(int Q) { return (Q + kThreads - 1) / kThreads; }

// K13 at a given shape in S chunks: the scan writes each chunk's leaves to
// ``hits`` ((S, Q) int32), the finish evaluates; a refused degree launches
// nothing and returns cudaErrorInvalidValue
template <int THREADS, int R, int TILE, bool V16>
int launch_corner_eval2d(const void* u, const void* v, const void* mx0,
                         const void* mx1, const void* my0, const void* my1,
                         const void* bounds, const void* coeffs, void* out,
                         void* hits, int Q, int L, int deg, double sentinel,
                         int S, cudaStream_t stream) {
  static_assert(kMaxDeg2d == 5, "one finish case per degree below");
  if (deg < 0 || deg > kMaxDeg2d) return (int)cudaErrorInvalidValue;
  constexpr int per_block = THREADS * R;
  const dim3 grid((Q + per_block - 1) / per_block, S);
  corner_eval2d_scan_kernel<THREADS, R, TILE>
      <<<grid, THREADS, walk_smem_bytes<4, TILE>(), stream>>>(
          (const double*)u, (const double*)v, (const double*)mx0,
          (const double*)mx1, (const double*)my0, (const double*)my1,
          (int*)hits, Q, L, sentinel);
#define K13_FINISH(D)                                                        \
  corner_eval2d_finish_kernel<D, V16>                                        \
      <<<blocks_for(Q), kThreads, 0, stream>>>(                              \
          (const double*)u, (const double*)v, (const int*)hits,              \
          (const double*)bounds, (const double*)coeffs, (double*)out, Q, S)
  switch (deg) {
    case 0: K13_FINISH(0); break;
    case 1: K13_FINISH(1); break;
    case 2: K13_FINISH(2); break;
    case 3: K13_FINISH(3); break;
    case 4: K13_FINISH(4); break;
    case 5: K13_FINISH(5); break;
  }
#undef K13_FINISH
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace polyfit

// one case per degree 0..kMaxDeg2d, the launch statement given as LAUNCH(D)
#define POLYFIT_2D_DISPATCH(deg, LAUNCH)                 \
  static_assert(polyfit::kMaxDeg2d == 5, "one case per degree below"); \
  switch (deg) {                                         \
    case 0: LAUNCH(0); break;                            \
    case 1: LAUNCH(1); break;                            \
    case 2: LAUNCH(2); break;                            \
    case 3: LAUNCH(3); break;                            \
    case 4: LAUNCH(4); break;                            \
    case 5: LAUNCH(5); break;                            \
    default: return (int)cudaErrorInvalidValue;          \
  }

extern "C" {

int polyfit_corner_count2d_gather(const void* lx, const void* ux,
                                  const void* ly, const void* uy,
                                  const void* xcuts, const void* ycuts,
                                  const void* leaf_z, const void* bounds,
                                  const void* coeffs, void* out, int Q, int nx,
                                  int ny, int L, int deg, int depth,
                                  void* stream) {
  if (Q <= 0) return (int)cudaGetLastError();
  // four threads a rectangle
  const int blocks =
      (int)((4LL * Q + polyfit::kThreads - 1) / polyfit::kThreads);
#define K7_LAUNCH(D)                                                         \
  polyfit::corner_count2d_gather_kernel<D>                                   \
      <<<blocks, polyfit::kThreads, 0, (cudaStream_t)stream>>>(              \
          (const double*)lx, (const double*)ux, (const double*)ly,           \
          (const double*)uy, (const double*)xcuts, (const double*)ycuts,     \
          (const int32_t*)leaf_z, (const double*)bounds,                     \
          (const double*)coeffs, (double*)out, Q, nx, ny, L, depth)
  POLYFIT_2D_DISPATCH(deg, K7_LAUNCH)
#undef K7_LAUNCH
  return (int)cudaGetLastError();
}

int polyfit_corner_eval2d_gather(const void* u, const void* v,
                                 const void* xcuts, const void* ycuts,
                                 const void* leaf_z, const void* bounds,
                                 const void* coeffs, void* out, int Q, int nx,
                                 int ny, int L, int deg, int depth,
                                 void* stream) {
  if (Q <= 0) return (int)cudaGetLastError();
  // two threads a corner
  const int blocks =
      (int)((2LL * Q + polyfit::kThreads - 1) / polyfit::kThreads);
#define K8_LAUNCH(D)                                                         \
  polyfit::corner_eval2d_gather_kernel<D>                                    \
      <<<blocks, polyfit::kThreads, 0, (cudaStream_t)stream>>>(              \
          (const double*)u, (const double*)v, (const double*)xcuts,          \
          (const double*)ycuts, (const int32_t*)leaf_z,                      \
          (const double*)bounds, (const double*)coeffs, (double*)out, Q, nx, \
          ny, L, depth)
  POLYFIT_2D_DISPATCH(deg, K8_LAUNCH)
#undef K8_LAUNCH
  return (int)cudaGetLastError();
}

int polyfit_corner_count2d_chunks(int L) {
  return polyfit::walk_chunks<polyfit::kCountTile>(L, polyfit::kCountChunks);
}

// ``hits``: (4S, Q) int32 scratch, S = polyfit_corner_count2d_chunks(L)
int polyfit_corner_count2d(const void* lx, const void* ux, const void* ly,
                           const void* uy, const void* mx0, const void* mx1,
                           const void* my0, const void* my1,
                           const void* bounds, const void* coeffs, void* out,
                           void* hits, int Q, int L, int deg, double sentinel,
                           void* stream) {
  using namespace polyfit;
  if (Q <= 0) return (int)cudaGetLastError();
  constexpr int per_block = kCountThreads * kCountQueries;
  const int S = walk_chunks<kCountTile>(L, kCountChunks);
  const dim3 grid((Q + per_block - 1) / per_block, S);
  // the degree first: a refused degree launches nothing
#define K12_LAUNCH(D)                                                        \
  corner_count2d_scan_kernel<kCountThreads, kCountQueries, kCountTile>       \
      <<<grid, kCountThreads, walk_smem_bytes<4, kCountTile>(),              \
         (cudaStream_t)stream>>>(                                            \
          (const double*)lx, (const double*)ux, (const double*)ly,           \
          (const double*)uy, (const double*)mx0, (const double*)mx1,         \
          (const double*)my0, (const double*)my1, (int*)hits, Q, L,          \
          sentinel);                                                         \
  corner_count2d_finish_kernel<D>                                            \
      <<<blocks_for(Q), kThreads, 0, (cudaStream_t)stream>>>(                \
          (const double*)lx, (const double*)ux, (const double*)ly,           \
          (const double*)uy, (const int*)hits, (const double*)bounds,        \
          (const double*)coeffs, (double*)out, Q, S)
  POLYFIT_2D_DISPATCH(deg, K12_LAUNCH)
#undef K12_LAUNCH
  return (int)cudaGetLastError();
}

int polyfit_corner_eval2d_chunks(int L) {
  return polyfit::walk_chunks<polyfit::kEvalTile>(L, polyfit::kEvalChunks);
}

// ``hits``: (S, Q) int32 scratch, S = polyfit_corner_eval2d_chunks(L)
int polyfit_corner_eval2d(const void* u, const void* v, const void* mx0,
                          const void* mx1, const void* my0, const void* my1,
                          const void* bounds, const void* coeffs, void* out,
                          void* hits, int Q, int L, int deg, double sentinel,
                          void* stream) {
  using namespace polyfit;
  if (Q <= 0) return (int)cudaGetLastError();
  return launch_corner_eval2d<kEvalThreads, kEvalQueries, kEvalTile,
                              kEvalV16>(
      u, v, mx0, mx1, my0, my1, bounds, coeffs, out, hits, Q, L, deg,
      sentinel, walk_chunks<kEvalTile>(L, kEvalChunks),
      (cudaStream_t)stream);
}

}  // extern "C"
