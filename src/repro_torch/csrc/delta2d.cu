// PolyFit buffered two-key corrections for Hopper (sm_90a), float64.
//
// K9  delta_count2d_gather_kernel   replaces repro/kernels/delta_scan.py:delta_count2d_gather_pallas
// K10 delta_sum2d_gather_kernel     replaces repro/kernels/delta_scan.py:delta_sum2d_gather_pallas
// K11 delta_dommax2d_gather_kernel  replaces repro/kernels/delta_scan.py:delta_dommax2d_gather_pallas
//
// Twins of repro_torch/kernels/delta_scan.py's plain versions, in their
// order of operations (compiled with -fmad=false).  A dynamic two-key table
// (engine/dynamic.py DynamicEngine2D) keeps its buffered inserts and
// deletes in x-sorted, sentinel-padded logs of cap slots (a power of two),
// and rebuilds on append the merge-sort-tree levels of each log: ylv
// (levels = log2(cap) + 1, cap), level l holding y sorted within blocks of
// 2^l, and for measure-carrying tables the per-block inclusive prefix sums
// wcum and prefix maxima wpmax of the measures carried through the same
// sorts.  A corner (x, y) is answered by the x-rank #(kx <= x)
// (locate.cuh bsearch_count_right) and the merge-sort-tree prefix over it
// (locate.cuh mst_prefix_bits): at most one block a level, one binary
// search in each, so O(log^2 cap) probes.
//
// K9 counts buffered points in (lx, ux] x (ly, uy]: cf(ux, uy) - cf(lx, uy)
// - cf(ux, ly) + cf(lx, ly), each corner's count cast to f64 before the
// combination, as the reference casts to the plan dtype.  K10 is the same
// over wcum (sums of measures); K11 takes one corner, the dominance max
// over wpmax, -inf when no buffered point is dominated.  Sentinel slots
// hold huge coordinates and measure 0, so they fall outside every finite
// corner: no kernel needs the fill level.
//
// What bounds them on an H100.  At Q = 65,536 and cap = 4,096 (13 levels)
// K9 must move four f64 endpoints in and one out a query (2.6 MB) plus the
// log's x keys and levels once (0.46 MB): about 0.9 us at 3.35 TB/s.  K10
// adds wcum (0.43 MB), K11 reads two endpoints and wpmax instead.  The
// byte bound is about 1 us; the loads set the time.  Walking every level
// (the plain version's order), a corner takes 13 x-rank probes and 91 tree
// probes (13 levels, l + 1 rounds each, an untaken level's search masked
// off): 416 scattered 8-byte loads a query for K9 (468 for K10, 117 a
// corner for K11), served by L1 and L2
// (the log's structures are under 1 MB).  tools/mst_rates.py measures the
// rates behind the design on the card: a dependent chain alone waits about
// 72 clocks a step in L1 and 360 in L2, but at full occupancy an SM serves
// only about 3 scattered loads a clock from L1 and 0.6 from L2, and the
// walks run near 2 loads a clock an SM whatever their shape.  So the
// number of loads sets the time, then the registers that decide how many
// threads keep loads in flight.
//
// What the design of K9, K10 and K11 does about it.
//  * Only the taken levels are searched (locate.cuh mst_prefix_bits): a
//    level is taken exactly when its bit is set in the x-rank, and its
//    block is then known from the x-rank alone, so an untaken level costs
//    no load (34 tree loads a corner for OSM-like rectangles over a
//    3,072-point log, against 91).  The note there shows that skipping
//    the untaken levels' +0.0 leaves K10's sum bit for bit.
//  * Two x-ranks a query, not four: the corners (ux, uy), (lx, uy),
//    (ux, ly) and (lx, ly) have two distinct x values, and the corners on
//    one x search the same blocks.  Two threads serve a query, one an x;
//    each searches its blocks for uy and ly, and a shuffle brings the lx
//    thread's two corners to the ux thread, which combines a - b - c + d
//    in the plain version's order.
//  * Two taken levels at a time: their four searches run in lockstep, a
//    round issuing its loads before its compares, on 48 registers (five
//    blocks an SM, one wave at Q = 65,536).  Every taken level in lockstep
//    needs 140-170 registers and ran 2-3x slower; staging the x keys in
//    shared memory took the L1 the tree's rows live in.
// About 163 loads a rectangle for K9 (185 for K10) instead of 416 (468).
//  * K11 takes one corner a query, so a thread has one search a round in
//    flight where K9's have two, and 65,536 corners fill only 16 warps an
//    SM: its walk is a chain of dependent L2 loads (about 1 load a clock
//    an SM, tools/k3_k11_rates.py).  Two threads serve a corner, each a
//    contiguous group of the taken levels of near-equal rounds, two levels
//    at a time (31 registers); a shuffle folds the groups in level order.
//    The max mode of mst_prefix_bits skips the untaken levels' jmax with
//    -inf, which leaves the fold's bits (the note there).  About 52 loads
//    a corner on an OSM-like 3,072-point log instead of 117.
//
// Each launcher takes raw device pointers and the CUDA stream, launches on
// that stream, and returns cudaGetLastError() (0 when the launch was
// taken).

#include <cuda_runtime.h>
#include <stdint.h>

#include "locate.cuh"

namespace polyfit {
namespace {

constexpr int kThreads = 256;

// taken levels a thread searches in lockstep (mst_prefix_bits' G)
constexpr int kLevelsAtOnce = 2;

// K9 (M = kCount) and K10 (kSum): the buffered COUNT or SUM of measures
// over (lx, ux] x (ly, uy].  Two threads serve a query, one an x: thread
// bit 0 picks it (0: ux, 1: lx), and the thread searches its x-rank's
// blocks for uy and ly together.
template <MstMode M>
__device__ __forceinline__ void rect2d(
    const double* __restrict__ lx, const double* __restrict__ ux,
    const double* __restrict__ ly, const double* __restrict__ uy,
    const double* __restrict__ kx, const double* __restrict__ ylv,
    const double* __restrict__ wcum, double* __restrict__ out, int Q,
    int cap) {
  const long long q = ((long long)blockIdx.x * kThreads + threadIdx.x) / 2;
  const bool low = threadIdx.x & 1;
  // lanes past Q redo the last query: every lane reaches the shuffles
  const int qq = q < Q ? (int)q : Q - 1;
  const int i = bsearch_count_right(kx, cap, low ? lx[qq] : ux[qq]);
  const double v[2] = {uy[qq], ly[qq]};
  MstTotal<M> total[2];
  mst_prefix_bits<M, 2, kLevelsAtOnce>(ylv, wcum, cap, i, v, total);
  // a = cf(ux, uy), b = cf(lx, uy), c = cf(ux, ly), d = cf(lx, ly), each
  // count cast to f64 as the reference casts it to the plan dtype
  const double a = (double)total[0];
  const double c = (double)total[1];
  const double b = __shfl_xor_sync(0xffffffffu, a, 1);
  const double d = __shfl_xor_sync(0xffffffffu, c, 1);
  if (q < Q && !low) out[q] = a - b - c + d;
}

// K9: buffered COUNT over (lx, ux] x (ly, uy]
__global__ void __launch_bounds__(kThreads) delta_count2d_gather_kernel(
    const double* __restrict__ lx, const double* __restrict__ ux,
    const double* __restrict__ ly, const double* __restrict__ uy,
    const double* __restrict__ kx, const double* __restrict__ ylv,
    double* __restrict__ out, int Q, int cap) {
  rect2d<MstMode::kCount>(lx, ux, ly, uy, kx, ylv, nullptr, out, Q, cap);
}

// K10: buffered SUM of measures over (lx, ux] x (ly, uy]
__global__ void __launch_bounds__(kThreads) delta_sum2d_gather_kernel(
    const double* __restrict__ lx, const double* __restrict__ ux,
    const double* __restrict__ ly, const double* __restrict__ uy,
    const double* __restrict__ kx, const double* __restrict__ ylv,
    const double* __restrict__ wcum, double* __restrict__ out, int Q,
    int cap) {
  rect2d<MstMode::kSum>(lx, ux, ly, uy, kx, ylv, wcum, out, Q, cap);
}

// blocks of K9 and K10 for Q queries, two threads each
inline int rect_blocks(int Q) {
  return (int)((2LL * Q + kThreads - 1) / kThreads);
}

// The set bits of the x-rank i that thread t (0 or 1) of a K11 corner
// walks: the bits, high to low, fall in two contiguous groups of
// near-equal rounds (l + 1 rounds a level), each level in the half of the
// total rounds its own rounds' midpoint falls in; thread 0 takes the high
// group.  Any split into contiguous groups folds to the same bits: the
// whole fold is jmax over the levels high to low, and jmax of the groups'
// folds, high to low, equals it (on a tie jmax returns its second operand,
// the later one, either way; a NaN gives NaN).
__device__ __forceinline__ unsigned part_bits(unsigned i, int t) {
  int total = 0;
  for (unsigned r = i; r; r &= r - 1) total += __ffs(r);
  unsigned mine = 0;
  int cum = 0;
  for (unsigned r = i; r;) {
    const int l = 31 - __clz(r);
    r &= ~(1u << l);
    mine |= (2 * cum + l + 1 >= total) == (t == 1) ? 1u << l : 0u;
    cum += l + 1;
  }
  return mine;
}

// K11: buffered dominance MAX over {x <= u, y <= v}; -inf when empty.  Two
// threads serve a corner: both take its x-rank i (the same loads), thread
// t walks group t of i's set bits (part_bits: thread 0 the high levels,
// thread 1 the low ones) two levels at a time, and a shuffle brings
// thread 1's maximum to thread 0, which folds it last.  A group's blocks
// start at the bits of i above the group plus what its own bits give, so
// thread t walks from ylv + A and wpmax + A, A the bits above its group.
__global__ void __launch_bounds__(kThreads) delta_dommax2d_gather_kernel(
    const double* __restrict__ u, const double* __restrict__ v,
    const double* __restrict__ kx, const double* __restrict__ ylv,
    const double* __restrict__ wpmax, double* __restrict__ out, int Q,
    int cap) {
  const long long q = ((long long)blockIdx.x * kThreads + threadIdx.x) / 2;
  const int t = threadIdx.x & 1;
  // lanes past Q redo the last corner: every lane reaches the shuffle
  const int qq = q < Q ? (int)q : Q - 1;
  const unsigned i = (unsigned)bsearch_count_right(kx, cap, u[qq]);
  const unsigned mine = part_bits(i, t);
  const unsigned above = mine ? i & ~((2u << (31 - __clz(mine))) - 1u) : 0u;
  const double vq[1] = {v[qq]};
  double total[1];
  mst_prefix_bits<MstMode::kMax, 1, kLevelsAtOnce>(
      ylv + above, wpmax + above, cap, (int)mine, vq, total);
  const double low = __shfl_xor_sync(0xffffffffu, total[0], 1);
  if (q < Q && t == 0) out[q] = jmax(total[0], low);
}

}  // namespace
}  // namespace polyfit

extern "C" {

// levels is implied by cap (the x-rank's set bits are the levels taken)
int polyfit_delta_count2d_gather(const void* lx, const void* ux,
                                 const void* ly, const void* uy,
                                 const void* kx, const void* ylv, void* out,
                                 int Q, int cap, int levels, void* stream) {
  (void)levels;
  if (Q > 0)
    polyfit::delta_count2d_gather_kernel<<<polyfit::rect_blocks(Q),
                                           polyfit::kThreads, 0,
                                           (cudaStream_t)stream>>>(
        (const double*)lx, (const double*)ux, (const double*)ly,
        (const double*)uy, (const double*)kx, (const double*)ylv,
        (double*)out, Q, cap);
  return (int)cudaGetLastError();
}

int polyfit_delta_sum2d_gather(const void* lx, const void* ux, const void* ly,
                               const void* uy, const void* kx,
                               const void* ylv, const void* wcum, void* out,
                               int Q, int cap, int levels, void* stream) {
  (void)levels;
  if (Q > 0)
    polyfit::delta_sum2d_gather_kernel<<<polyfit::rect_blocks(Q),
                                         polyfit::kThreads, 0,
                                         (cudaStream_t)stream>>>(
        (const double*)lx, (const double*)ux, (const double*)ly,
        (const double*)uy, (const double*)kx, (const double*)ylv,
        (const double*)wcum, (double*)out, Q, cap);
  return (int)cudaGetLastError();
}

int polyfit_delta_dommax2d_gather(const void* u, const void* v,
                                  const void* kx, const void* ylv,
                                  const void* wpmax, void* out, int Q,
                                  int cap, int levels, void* stream) {
  (void)levels;
  if (Q > 0)
    polyfit::delta_dommax2d_gather_kernel<<<polyfit::rect_blocks(Q),
                                            polyfit::kThreads, 0,
                                            (cudaStream_t)stream>>>(
        (const double*)u, (const double*)v, (const double*)kx,
        (const double*)ylv, (const double*)wpmax, (double*)out, Q, cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
