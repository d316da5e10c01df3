// PolyFit certified quantile inversion for Hopper (sm_90a), float64.
//
// K4 quantile_invert_kernel  replaces repro/kernels/quantile_invert.py:quantile_invert_pallas
//    (the 'cuda' backend; quantile_scan_count_kernel and
//    quantile_scan_finish_kernel are its scan=True mode, the 'cuda_scan'
//    backend)
//
// The twin of repro_torch/core/quantile.py:certified_quantile_shifted, in
// its order of operations (compiled with -fmad=false, as the plain torch
// version rounds every multiply and add on its own).  Each target inverts
// the fitted CF three times (invert_side):
//
//   hi   against seg_err: locate the first segment whose running-max
//        endpoint value B clears t_hi + delta, take the largest root of
//        P = t_hi + err inside it, snap up to the exact key grid;
//   lo   against seg_err: locate past every segment with B <= t_lo - delta,
//        take the smallest root of P = t_lo - err, no snap;
//   mid  the raw fitted crossing of t_mid (zero error), clipped into
//        [lo, hi].
//
// Roots are closed form through deg 3 (the solvers of core/queries.py:
// acos, cos and pow(|x|, 1/3) as torch computes them on the card, the cubes
// as explicit products, the divisions by 3 and 27 as multiplies by the
// reciprocal), each solve computing only the branch whose roots it keeps
// (the plain version's torch.where discards the others, so the kept roots
// have the same bits), and 40 safeguarded Newton/bisection steps above,
// whose Horner steps are emulated fused multiply-adds (fma_emul, as the
// plain version's horner_fma and the reference's XLA contraction round
// them), where only the mid inversion solves (the certified sides keep
// segment endpoint granularity, as the plain version does).  The degree
// is a template parameter up to kMaxQuantileDeg, so each coefficient row
// lives in registers, read by 16-byte loads.
//
// The gather mode ran one thread a target until its redesign: three
// binary searches over B, three solves with every root branch computed
// (at deg 3 six transcendentals a solve, of which four or two are
// kept), the rows a value a load, and the snap by a binary search over the
// padded key grid (19-21 dependent probes over 1.6-8 MB that miss L1):
// 0.0139 ms at the merged lat_dyn plan (deg 2, about 1M keys), 0.02436 at
// hki_sum's (deg 3, 200k keys), 16 warps an SM at Q = 65,536 each with one
// long chain.  Its design now (quantile_invert_kernel below):
//   - three lanes a target, one inversion a lane, in one code path: the
//     count over B by one binary search with the compare picked per lane
//     (bsearch_count_side), one solve with the target and the sign picked
//     per lane; ten targets a warp;
//   - the hi lane's snap by a descent of the key grid's search tree over
//     its n live keys (locate.cuh tree_count_left; a plan's ref_tree, K1's
//     tree): 9 sector loads at 1M keys in place of 21 probes; the count
//     equals the binary search's over the padded grid once clamped;
//   - shuffles bring the upper and lower ends to the mid lane.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/k4_k21_rates.py,
// 65,536 targets on fitted tables of lat_dyn's and hki_sum's shapes,
// medians of three runs): 0.01307 ms at deg 2 over 1M keys (0.01347
// before), 0.01823 at deg 3 over 200k (0.02383).  The tree snap took
// 19% (deg 2) and 14% (deg 3) off the binary search's; the solves that
// skip the branches they do not keep 22% at deg 3 (nothing at deg 2);
// four lanes a target ran 5% faster at deg 2 and 9% slower at deg 3.
// At deg 2 one thread a target with the tree snap and the skipped
// branches ran 0.01085: there the snap's descent, a chain of L2 loads,
// is the longest link (0.0053 ms of the split form's time, 0.0037 of one
// thread's), and three lanes a target put 3.2 times the warps in flight,
// about 1.5 waves at the kernel's 59 registers; at deg 3 the split
// form's shorter solves win.
//
// The scan mode (polyfit_quantile_invert_scan) takes every count as the
// one-hot comparison sum of the reference's scan=True: #(B < t + delta),
// #(B <= t - delta), #(B < t) and #(ref_keys < x), each over the whole
// array.  On sorted arrays the summed predicate is the binary search's, so
// both modes return the same keys bit for bit.  It is bound by operations,
// 2 (3 Hp + nk) compares and adds a target: at Q = 65,536 on hki_sum's plan
// (Hp 1,024, a 200,064-key grid) 2.67e10, 0.784 ms at the FP64 peak of 34
// TFLOP/s, which counts an FMA as two operations.  Its design:
//   - two kernels: a count kernel for the four counts, then a finish
//     kernel that runs the three inversions, one thread a target;
//   - the count kernel walks B and the key grid through the shared tile
//     walker (scan_tile.cuh): 2,048 entries a tile, double-buffered
//     cp.async copies, a full tile's loop of compile-time length;
//   - a thread holds 4 targets, so one shared load serves four compares,
//     each an f64 compare and an increment under its predicate (count_lt,
//     count_le: the C++ `c += x < q` costs a select more);
//   - the key grid, 99% of the work, is cut in up to 4 chunks of
//     interleaved tiles along the grid's second dimension (512 blocks at
//     Q = 65,536), each block walking all of B for the root it snaps; the
//     finish kernel adds the integer partial counts (exact in any order).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py): 1.232 ms
// at hki_sum's plan (2.370 ms before the redesign), 64% of the bound; its
// compare-and-increment loop alone reaches 44-46 pairs a clock an SM at 4
// targets a thread (tools/scan_rates.py), the kernel about 42.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "locate.cuh"
#include "scan_tile.cuh"

namespace polyfit {
namespace {

constexpr int kThreads = 256;
// the scan mode's shape: 128 threads of 4 targets a block, tiles of 2,048
// entries (16 KB a buffer), the key grid split in up to 4 chunks: 512
// blocks, about four an SM, at Q = 65,536
constexpr int kScanThreads = 128;
constexpr int kScanTargets = 4;
constexpr int kScanTile = 2048;
constexpr int kScanChunks = 4;
// the largest plan degree K4 takes (kernels/quantile_invert.py MAX_DEG):
// one instantiation per degree, the wrapper raises above it
constexpr int kMaxQuantileDeg = 8;
constexpr int kNewtonIters = 40;

// 2 * math.pi / 3 and 4 * math.pi / 3 as Python computes them
constexpr double kTwoPiThirds = 0x1.0c152382d7365p+1;
constexpr double kFourPiThirds = 0x1.0c152382d7365p+2;

// torch.sign(x) * torch.abs(x) ** (1/3): sign gives 0 for 0 and NaN
__device__ __forceinline__ double signed_cbrt(double x) {
  const double sgn = (double)((0.0 < x) - (x < 0.0));
  return sgn * pow(fabs(x), 1.0 / 3.0);
}

// a u + b = 0 (NaN if degenerate)
__device__ __forceinline__ double root_linear(double b, double a) {
  return fabs(a) > 0 ? -b / (a == 0 ? 1.0 : a) : NAN;
}

// a u^2 + b u + c = 0, NaN-padded.  Only the branch whose value is kept
// is computed: the plain version's torch.where discards the other, so the
// kept value has the same bits.
__device__ __forceinline__ void roots_quadratic(double c, double b, double a,
                                                double* r1, double* r2) {
  if (fabs(a) > 0) {
    const double disc = b * b - 4.0 * a * c;
    const double sq = sqrt(jmax(disc, 0.0));
    const double denom = 2.0 * a;
    const bool quad_ok = disc >= 0;
    *r1 = quad_ok ? (-b - sq) / denom : NAN;
    *r2 = quad_ok ? (-b + sq) / denom : NAN;
  } else {
    *r1 = root_linear(c, b);
    *r2 = NAN;
  }
}

// a u^3 + b u^2 + c u + d = 0, NaN-padded: the quadratic when a == 0 (or
// NaN), else the trigonometric roots for three real roots (disc <= 0),
// Cardano's for one (disc > 0 or NaN).  Only the branch whose roots are
// kept is computed, as in roots_quadratic.
__device__ __forceinline__ void roots_cubic(double d, double c, double b,
                                            double a, double* r) {
  if (!(fabs(a) > 0)) {
    roots_quadratic(d, c, b, &r[0], &r[1]);
    r[2] = NAN;
    return;
  }
  const double shift = b / (3.0 * a);
  const double p = (3.0 * a * c - b * b) / (3.0 * a * a);
  const double q = (2.0 * (b * b * b) - 9.0 * a * b * c + 27.0 * a * a * d) /
                   (27.0 * (a * a * a));
  const double disc = (q * q) * 0.25 + (p * p * p) * (1.0 / 27.0);
  if (disc <= 0) {
    const double pm = jmin(p, -1e-300);
    const double m = 2.0 * sqrt(-pm * (1.0 / 3.0));
    const double arg = jclip(3.0 * q / (pm * m), -1.0, 1.0);
    const double theta = acos(arg) * (1.0 / 3.0);
    r[0] = m * cos(theta) - shift;
    r[1] = m * cos(theta - kTwoPiThirds) - shift;
    r[2] = m * cos(theta - kFourPiThirds) - shift;
  } else {
    const double sq = sqrt(jmax(disc, 0.0));
    r[0] = (signed_cbrt(-q / 2.0 + sq) + signed_cbrt(-q / 2.0 - sq)) - shift;
    r[1] = NAN;
    r[2] = NAN;
  }
}

// Horner with each step fma_emul(acc, u, c[j]) (core/poly.py horner_fma)
template <int DEG>
__device__ __forceinline__ double horner_fma_r(const double (&c)[DEG + 1],
                                               double u) {
  double acc = c[DEG];
#pragma unroll
  for (int j = DEG - 1; j >= 0; --j) acc = fma_emul(acc, u, c[j]);
  return acc;
}

// P'(u) by horner_fma_r over the weights c[j] * j
template <int DEG>
__device__ __forceinline__ double dhorner_fma_r(const double (&c)[DEG + 1],
                                                double u) {
  double acc = c[DEG] * (double)DEG;
#pragma unroll
  for (int j = DEG - 1; j >= 1; --j) acc = fma_emul(acc, u, c[j] * (double)j);
  return acc;
}

// one root of P(u) = t on [-1, 1]: safeguarded Newton + bisection, P and
// P' evaluated with emulated fused multiply-adds (core/quantile.py
// _newton_root: the reference's XLA Horner runs with FMAs)
template <int DEG>
__device__ double newton_root(const double (&c)[DEG + 1], double t) {
  double a = -1.0, b = 1.0;
  double fa = horner_fma_r<DEG>(c, a) - t;
  double u = 0.5 * (a + b);
  for (int it = 0; it < kNewtonIters; ++it) {
    const double fu = horner_fma_r<DEG>(c, u) - t;
    const bool same = (fu > 0) == (fa > 0);
    a = same ? u : a;
    fa = same ? fu : fa;
    b = same ? b : u;
    const double du = dhorner_fma_r<DEG>(c, u);
    const double step = u - fu / (du == 0 ? 1.0 : du);
    const double lo = jmin(a, b);
    const double hi = jmax(a, b);
    const bool bad = du == 0 || !isfinite(step) || step <= lo || step >= hi;
    u = bad ? 0.5 * (a + b) : step;
  }
  return u;
}

// largest (sign 1) or smallest (sign -1) root of P(u) = T in [-1, 1];
// *found is false when none lies there
template <int DEG>
__device__ double extreme_root(const double (&c)[DEG + 1], double T,
                               double sign, bool* found) {
  double r[3];
  int nr = 1;
  if constexpr (DEG <= 1) {
    r[0] = root_linear(c[0] - T, c[1]);
  } else if constexpr (DEG == 2) {
    roots_quadratic(c[0] - T, c[1], c[2], &r[0], &r[1]);
    nr = 2;
  } else if constexpr (DEG == 3) {
    roots_cubic(c[0] - T, c[1], c[2], c[3], r);
    nr = 3;
  } else {
    r[0] = newton_root<DEG>(c, T);
  }
  double best = -INFINITY;
  for (int j = 0; j < nr; ++j) {
    const bool valid = isfinite(r[j]) && fabs(r[j]) <= 1.0 + 1e-9;
    best = valid ? jmax(best, sign * jclip(r[j], -1.0, 1.0)) : best;
  }
  *found = isfinite(best);
  return *found ? sign * best : 0.0;
}

// inverse of scale_unit (degenerate span -> lo)
__device__ __forceinline__ double unscale(double u, double lo, double hi) {
  return hi > lo ? 0.5 * (u * (hi - lo) + lo + hi) : lo;
}

// The three inversions of a target, one a call, the side picked per lane
// (both modes run them; only the counts are taken differently):
//   kHi   the first segment whose running-max endpoint value clears
//         t + delta (cnt = #(B < t + delta)); the largest root of
//         P = t + seg_err inside it (the segment's end above deg 3): the
//         point the upper end snaps up to the key grid (upper_end);
//   kLo   past every segment at or below t - delta (cnt = #(B <= t -
//         delta)); where P starts at or below T = t - seg_err, the
//         smallest root of P = T, else the previous segment's end (that
//         end alone above deg 3): the lower end, not snapped;
//   kMid  the segment of the raw crossing (cnt = #(B < t)); the largest
//         root of P = t (zero error), which the caller clips into
//         [lower, upper].
enum Side : int { kHi = 0, kLo = 1, kMid = 2 };

template <int DEG>
__device__ __forceinline__ double invert_side(
    int side, int cnt, double t, const double* __restrict__ seg_lo,
    const double* __restrict__ seg_hi, const double* __restrict__ coeffs,
    const double* __restrict__ seg_err, int h) {
  const int s = cnt < h - 1 ? cnt : h - 1;
  const double lo = seg_lo[s], hi = seg_hi[s];
  const double below = s > 0 ? seg_hi[s - 1] : seg_lo[0];
  if constexpr (DEG > 3) {
    if (side != kMid) return side == kHi ? hi : below;
  }
  double c[DEG + 1];
  load_row_v16<DEG>(coeffs, s, c);
  const double T = side == kMid ? t
                   : side == kHi ? t + seg_err[s]
                                 : t - seg_err[s];
  bool found;
  const double root =
      extreme_root<DEG>(c, T, side == kLo ? -1.0 : 1.0, &found);
  const double x = unscale(found ? root : (side == kLo ? 1.0 : -1.0), lo, hi);
  if (side != kLo) return x;
  const double tiny = 1e-9 * (fabs(T) + 1.0);
  return horner_r<DEG>(c, -1.0) <= T + tiny ? x : below;
}

// the upper end: the kHi point snapped up to the key grid from the key
// count k = #(ref_keys < x), or the domain's top for a target past the
// fitted mass
__device__ __forceinline__ double upper_end(int k, double th, double delta,
                                            double b_top, double dom_hi,
                                            const double* __restrict__ ref_keys,
                                            int n) {
  k = k < n - 1 ? k : n - 1;
  return th + delta <= b_top ? ref_keys[k] : dom_hi;
}

// K4, gather mode: (answer, lower, upper) per slack-shifted rank target.
// kLanes lanes serve a target, one inversion a lane (lane e of the group
// runs side e), in one code path: the lane's count over B by one binary
// search with the compare picked per lane (bsearch_count_side), its
// segment's row by 16-byte loads, one extreme_root with the target and
// the sign picked per lane.  The kHi lane snaps its point to the key grid
// by a descent of the grid's search tree (tree_count_left over the n live
// keys); shuffles bring the upper and lower ends to the kMid lane, which
// clips the answer into them.  A warp serves kTargets targets; its spare
// lanes and lanes past Q redo the last target and write nothing.
constexpr int kLanes = 3;
constexpr int kTargets = 32 / kLanes;

template <int DEG>
__global__ void __launch_bounds__(kThreads) quantile_invert_kernel(
    const double* __restrict__ t_mid, const double* __restrict__ t_lo,
    const double* __restrict__ t_hi, const double* __restrict__ B,
    const double* __restrict__ seg_lo, const double* __restrict__ seg_hi,
    const double* __restrict__ coeffs, const double* __restrict__ seg_err,
    const double* __restrict__ ref_keys, const double* __restrict__ tree,
    TreeShape shape, double* __restrict__ out_mid,
    double* __restrict__ out_lo, double* __restrict__ out_hi, int Q, int H,
    int h, int n, double delta) {
  const int lane = threadIdx.x & 31;
  const int g = lane / kLanes;
  const int side = lane - g * kLanes;
  const long long tgt =
      ((long long)blockIdx.x * kThreads + threadIdx.x) / 32 * kTargets + g;
  const int i = tgt < Q ? (int)tgt : Q - 1;
  const bool hi_side = side == kHi, lo_side = side == kLo;
  const double t = (hi_side ? t_hi : lo_side ? t_lo : t_mid)[i];
  const double b_top = B[h - 1];
  const double dom_hi = seg_hi[h - 1];
  const int cnt = bsearch_count_side(
      B, H, hi_side ? t + delta : lo_side ? t - delta : t, lo_side);
  double x = invert_side<DEG>(side, cnt, t, seg_lo, seg_hi, coeffs, seg_err,
                              h);
  if (hi_side)
    x = upper_end(tree_count_left(ref_keys, n, tree, shape, x), t, delta,
                  b_top, dom_hi, ref_keys, n);
  const int first = lane - side;
  const double x_hi = __shfl_sync(0xffffffffu, x, first + kHi);
  const double x_lo = __shfl_sync(0xffffffffu, x, first + kLo);
  if (tgt >= Q || g >= kTargets) return;
  if (side == kMid) {
    out_mid[i] = jclip(t <= b_top ? x : dom_hi, x_lo, x_hi);
  } else {
    (hi_side ? out_hi : out_lo)[i] = x;
  }
}

// K4, scan mode: the same inversions, every count a one-hot comparison sum
// over the whole array, in two kernels.  The count kernel gives a thread R
// targets (i0 + r * THREADS); block (x, y) walks all of B for their counts
// (row 0: #(B < th + delta), #(B <= tl - delta) and #(B < tm); the other
// rows need only the first, for the root they snap), then the key grid's
// tiles y, y + S, ... (S = gridDim.y chunks) for #(ref_keys < root), and
// writes that partial count to row y of ``part`` ((S + 2, Q) int32; rows S
// and S + 1 keep row 0's lower and answer counts).  The finish kernel adds
// the S partial counts (integers: any order is exact) and runs the three
// inversions, one thread a target.
template <int DEG, int THREADS, int R, int TILE>
__global__ void __launch_bounds__(THREADS) quantile_scan_count_kernel(
    const double* __restrict__ t_mid, const double* __restrict__ t_lo,
    const double* __restrict__ t_hi, const double* __restrict__ B,
    const double* __restrict__ seg_lo, const double* __restrict__ seg_hi,
    const double* __restrict__ coeffs, const double* __restrict__ seg_err,
    const double* __restrict__ ref_keys, int* __restrict__ part, int Q,
    int H, int h, int nk, double delta) {
  extern __shared__ double2 s_tile[];
  double* smem = (double*)s_tile;
  const int i0 = blockIdx.x * (THREADS * R) + threadIdx.x;
  const bool row0 = blockIdx.y == 0;
  double th[R], q_hi[R], q_lo[R], q_mid[R];
  int s_hi[R], s_lo[R], s_mid[R], k[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // threads past Q still stage tiles
    const int i = i0 + r * THREADS < Q ? i0 + r * THREADS : Q - 1;
    th[r] = t_hi[i];
    q_hi[r] = th[r] + delta;
    q_lo[r] = t_lo[i] - delta;
    q_mid[r] = t_mid[i];
    s_hi[r] = s_lo[r] = s_mid[r] = k[r] = 0;
  }
  const double* b_src[1] = {B};
  if (row0) {
    walk_slots<1, TILE, false>(b_src, H, 0, 1, 0.0, smem, [&](const double b) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        count_lt(s_hi[r], b, q_hi[r]);
        count_le(s_lo[r], b, q_lo[r]);
        count_lt(s_mid[r], b, q_mid[r]);
      }
    });
  } else {
    walk_slots<1, TILE, false>(b_src, H, 0, 1, 0.0, smem, [&](const double b) {
#pragma unroll
      for (int r = 0; r < R; ++r) count_lt(s_hi[r], b, q_hi[r]);
    });
  }
  double x[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    x[r] = invert_side<DEG>(kHi, s_hi[r], th[r], seg_lo, seg_hi, coeffs,
                            seg_err, h);
  const double* k_src[1] = {ref_keys};
  walk_slots<1, TILE, false>(k_src, nk, blockIdx.y, gridDim.y, 0.0, smem,
                             [&](const double key) {
#pragma unroll
                               for (int r = 0; r < R; ++r)
                                 count_lt(k[r], key, x[r]);
                             });
  const int S = gridDim.y;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * THREADS;
    if (i >= Q) continue;
    part[(size_t)blockIdx.y * Q + i] = k[r];
    if (row0) {
      part[(size_t)S * Q + i] = s_lo[r];
      part[(size_t)(S + 1) * Q + i] = s_mid[r];
    }
  }
}

template <int DEG>
__global__ void quantile_scan_finish_kernel(
    const double* __restrict__ t_mid, const double* __restrict__ t_lo,
    const double* __restrict__ t_hi, const double* __restrict__ B,
    const double* __restrict__ seg_lo, const double* __restrict__ seg_hi,
    const double* __restrict__ coeffs, const double* __restrict__ seg_err,
    const double* __restrict__ ref_keys, const int* __restrict__ part,
    double* __restrict__ out_mid, double* __restrict__ out_lo,
    double* __restrict__ out_hi, int Q, int h, int n, int S, double delta) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  const double b_top = B[h - 1];
  const double dom_hi = seg_hi[h - 1];
  int k = 0;
  for (int s = 0; s < S; ++s) k += part[(size_t)s * Q + i];
  const double x_hi = upper_end(k, t_hi[i], delta, b_top, dom_hi, ref_keys,
                                n);
  const double x_lo = invert_side<DEG>(kLo, part[(size_t)S * Q + i],
                                      t_lo[i], seg_lo, seg_hi, coeffs,
                                      seg_err, h);
  const double tm = t_mid[i];
  const double x = invert_side<DEG>(kMid, part[(size_t)(S + 1) * Q + i], tm,
                                    seg_lo, seg_hi, coeffs, seg_err, h);
  out_mid[i] = jclip(tm <= b_top ? x : dom_hi, x_lo, x_hi);
  out_lo[i] = x_lo;
  out_hi[i] = x_hi;
}

// K4's scan mode in S chunks of the key grid: the count kernel, then the
// finish kernel
template <int DEG, int THREADS, int R, int TILE>
void launch_scan(const double* t_mid, const double* t_lo, const double* t_hi,
                 const double* B, const double* seg_lo, const double* seg_hi,
                 const double* coeffs, const double* seg_err,
                 const double* ref_keys, double* out_mid, double* out_lo,
                 double* out_hi, int* part, int Q, int H, int h, int nk, int n,
                 double delta, int S, cudaStream_t stream) {
  constexpr int per_block = THREADS * R;
  const dim3 grid((Q + per_block - 1) / per_block, S);
  quantile_scan_count_kernel<DEG, THREADS, R, TILE>
      <<<grid, THREADS, walk_smem_bytes<1, TILE>(), stream>>>(
          t_mid, t_lo, t_hi, B, seg_lo, seg_hi, coeffs, seg_err, ref_keys,
          part, Q, H, h, nk, delta);
  quantile_scan_finish_kernel<DEG>
      <<<(Q + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          t_mid, t_lo, t_hi, B, seg_lo, seg_hi, coeffs, seg_err, ref_keys,
          part, out_mid, out_lo, out_hi, Q, h, n, S, delta);
}

// run f(std::integral_constant<int, DEG>()) for the plan's degree: one
// instantiation per degree 1..kMaxQuantileDeg
template <typename F>
int with_degree(int deg, F&& f) {
  static_assert(kMaxQuantileDeg == 8, "one case per degree below");
  switch (deg) {
    case 1: f(std::integral_constant<int, 1>()); break;
    case 2: f(std::integral_constant<int, 2>()); break;
    case 3: f(std::integral_constant<int, 3>()); break;
    case 4: f(std::integral_constant<int, 4>()); break;
    case 5: f(std::integral_constant<int, 5>()); break;
    case 6: f(std::integral_constant<int, 6>()); break;
    case 7: f(std::integral_constant<int, 7>()); break;
    case 8: f(std::integral_constant<int, 8>()); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace polyfit

extern "C" {

// ``ref_keys``: the key grid, its first n keys live; ``tree``: their
// search tree (kernels/locate.py search_tree of ref_keys[:n]); coeffs,
// ref_keys and tree 16-byte aligned
int polyfit_quantile_invert(const void* t_mid, const void* t_lo,
                            const void* t_hi, const void* B,
                            const void* seg_lo, const void* seg_hi,
                            const void* coeffs, const void* seg_err,
                            const void* ref_keys, const void* tree,
                            void* out_mid, void* out_lo, void* out_hi, int Q,
                            int H, int deg, int h, int n, double delta,
                            void* stream) {
  using namespace polyfit;
  if (Q <= 0) return (int)cudaGetLastError();
  const long long warps = ((long long)Q + kTargets - 1) / kTargets;
  const int blocks = (int)((warps * 32 + kThreads - 1) / kThreads);
  const TreeShape shape = tree_shape(n);
  return with_degree(deg, [&](auto d) {
    quantile_invert_kernel<decltype(d)::value>
        <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
            (const double*)t_mid, (const double*)t_lo, (const double*)t_hi,
            (const double*)B, (const double*)seg_lo, (const double*)seg_hi,
            (const double*)coeffs, (const double*)seg_err,
            (const double*)ref_keys, (const double*)tree, shape,
            (double*)out_mid, (double*)out_lo, (double*)out_hi, Q, H, h, n,
            delta);
  });
}

int polyfit_quantile_scan_chunks(int nk) {
  return polyfit::walk_chunks<polyfit::kScanTile>(nk, polyfit::kScanChunks);
}

// ``part``: (S + 2, Q) int32 scratch, S = polyfit_quantile_scan_chunks(nk)
int polyfit_quantile_invert_scan(const void* t_mid, const void* t_lo,
                                 const void* t_hi, const void* B,
                                 const void* seg_lo, const void* seg_hi,
                                 const void* coeffs, const void* seg_err,
                                 const void* ref_keys, void* out_mid,
                                 void* out_lo, void* out_hi, void* part, int Q,
                                 int H, int deg, int h, int nk, int n,
                                 double delta, void* stream) {
  using namespace polyfit;
  if (Q <= 0) return (int)cudaGetLastError();
  return with_degree(deg, [&](auto d) {
    launch_scan<decltype(d)::value, kScanThreads, kScanTargets, kScanTile>(
        (const double*)t_mid, (const double*)t_lo, (const double*)t_hi,
        (const double*)B, (const double*)seg_lo, (const double*)seg_hi,
        (const double*)coeffs, (const double*)seg_err,
        (const double*)ref_keys, (double*)out_mid, (double*)out_lo,
        (double*)out_hi, (int*)part, Q, H, h, nk, n, delta,
        walk_chunks<kScanTile>(nk, kScanChunks), (cudaStream_t)stream);
  });
}

}  // extern "C"
