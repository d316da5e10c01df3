// PolyFit certified quantile inversion for Hopper (sm_90a), float64, one
// thread per rank target.
//
// K4 quantile_invert_kernel  replaces repro/kernels/quantile_invert.py:quantile_invert_pallas
//    (the 'cuda' backend; quantile_scan_count_kernel and
//    quantile_scan_finish_kernel are its scan=True mode, the 'cuda_scan'
//    backend)
//
// The twin of repro_torch/core/quantile.py:certified_quantile_shifted, in
// its order of operations (compiled with -fmad=false, as the plain torch
// version rounds every multiply and add on its own).  Each thread inverts
// the fitted CF three times:
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
// reciprocal) and 40 safeguarded Newton/bisection steps above, whose
// Horner steps are emulated fused multiply-adds (fma_emul, as the plain
// version's horner_fma and the reference's XLA contraction round them),
// where only the mid inversion solves (the certified sides keep segment
// endpoint granularity, as the plain version does).  The degree is a
// template parameter up to kMaxQuantileDeg, so each coefficient row lives
// in registers.
//
// What bounds it on an H100: per target it reads three f64 targets and
// writes three f64 answers (48 B), and runs three binary searches over B
// (ceil(log2 Hp) + 1 dependent loads each) and one over the key grid
// (ceil(log2 nk) + 1, the grid is megabytes and misses L1), plus the root
// solves: about 100 f64 operations and four transcendentals a side at deg
// 3, some 2,000 for the Newton loop at deg 5.  At Q = 65,536 the bytes
// (3.1 MB plus the tables once) take about 1 us at 3.35 TB/s and the
// operations (about 0.05 GFLOP at deg 3) under 2 us at the FP64 peak, so
// the dependent key-grid probes and the launch set the time.  What the
// design does about it: nothing yet; one thread per target, the tables read
// through L1/L2.
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

// a u^2 + b u + c = 0, NaN-padded
__device__ __forceinline__ void roots_quadratic(double c, double b, double a,
                                                double* r1, double* r2) {
  const double lin = root_linear(c, b);
  const double disc = b * b - 4.0 * a * c;
  const double sq = sqrt(jmax(disc, 0.0));
  const double denom = a == 0 ? 1.0 : 2.0 * a;
  const double q1 = (-b - sq) / denom;
  const double q2 = (-b + sq) / denom;
  const bool quad_ok = fabs(a) > 0 && disc >= 0;
  *r1 = quad_ok ? q1 : (fabs(a) > 0 ? NAN : lin);
  *r2 = quad_ok ? q2 : NAN;
}

// a u^3 + b u^2 + c u + d = 0, NaN-padded: trigonometric for three real
// roots, Cardano for one, the quadratic when a == 0
__device__ __forceinline__ void roots_cubic(double d, double c, double b,
                                            double a, double* r) {
  double q1, q2;
  roots_quadratic(d, c, b, &q1, &q2);
  const double safe_a = fabs(a) > 0 ? a : 1.0;
  const double shift = b / (3.0 * safe_a);
  const double p = (3.0 * safe_a * c - b * b) / (3.0 * safe_a * safe_a);
  const double q = (2.0 * (b * b * b) - 9.0 * safe_a * b * c +
                    27.0 * safe_a * safe_a * d) /
                   (27.0 * (safe_a * safe_a * safe_a));
  const double disc = (q * q) * 0.25 + (p * p * p) * (1.0 / 27.0);
  const double pm = jmin(p, -1e-300);
  const double m = 2.0 * sqrt(-pm * (1.0 / 3.0));
  const double arg = jclip(3.0 * q / (pm * m), -1.0, 1.0);
  const double theta = acos(arg) * (1.0 / 3.0);
  const double t0 = m * cos(theta);
  const double t1 = m * cos(theta - kTwoPiThirds);
  const double t2 = m * cos(theta - kFourPiThirds);
  const double sq = sqrt(jmax(disc, 0.0));
  const double t_single = signed_cbrt(-q / 2.0 + sq) + signed_cbrt(-q / 2.0 - sq);
  const bool three = disc <= 0;
  const double r0 = (three ? t0 : t_single) - shift;
  const double r1 = (three ? t1 : NAN) - shift;
  const double r2 = (three ? t2 : NAN) - shift;
  const bool is_cubic = fabs(a) > 0;
  r[0] = is_cubic ? r0 : q1;
  r[1] = is_cubic ? r1 : q2;
  r[2] = is_cubic ? r2 : NAN;
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

template <int DEG>
__device__ __forceinline__ void load_row(const double* __restrict__ coeffs,
                                         int s, double (&c)[DEG + 1]) {
  const double* row = coeffs + (size_t)s * (DEG + 1);
#pragma unroll
  for (int j = 0; j <= DEG; ++j) c[j] = row[j];
}

// The three inversions of one target, given its counts: the upper end's
// root (the point snapped up to the key grid), the snapped upper end from
// the key count k = #(ref_keys < root), the lower end, and the answer.
// Both modes run them; only the counts are taken differently.

// upper end: certified against seg_err, the point to snap to the key grid
template <int DEG>
__device__ __forceinline__ double upper_root(
    int s_hi, double th, const double* __restrict__ seg_lo,
    const double* __restrict__ seg_hi, const double* __restrict__ coeffs,
    const double* __restrict__ seg_err, int h) {
  const int s = s_hi < h - 1 ? s_hi : h - 1;
  const double lo = seg_lo[s], hi = seg_hi[s];
  double x = hi;
  if constexpr (DEG <= 3) {
    double c[DEG + 1];
    bool found;
    load_row<DEG>(coeffs, s, c);
    const double root = extreme_root<DEG>(c, th + seg_err[s], 1.0, &found);
    x = unscale(found ? root : -1.0, lo, hi);
  }
  return x;
}

// the upper end snapped up to the key grid
__device__ __forceinline__ double upper_end(int k, double th, double delta,
                                            double b_top, double dom_hi,
                                            const double* __restrict__ ref_keys,
                                            int n) {
  k = k < n - 1 ? k : n - 1;
  return th + delta <= b_top ? ref_keys[k] : dom_hi;
}

// lower end: certified against seg_err, no snap
template <int DEG>
__device__ __forceinline__ double lower_end(
    int s_lo, double tl, const double* __restrict__ seg_lo,
    const double* __restrict__ seg_hi, const double* __restrict__ coeffs,
    const double* __restrict__ seg_err, int h) {
  int s = s_lo > 0 ? s_lo : 0;
  s = s < h - 1 ? s : h - 1;
  const double below = s > 0 ? seg_hi[s - 1] : seg_lo[0];
  double x_lo = below;
  if constexpr (DEG <= 3) {
    double c[DEG + 1];
    bool found;
    load_row<DEG>(coeffs, s, c);
    const double T = tl - seg_err[s];
    const double tiny = 1e-9 * (fabs(T) + 1.0);
    const double root = extreme_root<DEG>(c, T, -1.0, &found);
    const bool start_ok = horner_r<DEG>(c, -1.0) <= T + tiny;
    const double u = found ? root : 1.0;
    x_lo = start_ok ? unscale(u, seg_lo[s], seg_hi[s]) : below;
  }
  return x_lo;
}

// answer: the raw fitted crossing (zero error), clipped into [lo, hi]
template <int DEG>
__device__ __forceinline__ double answer(
    int s_mid, double tm, double x_lo, double x_hi, double b_top,
    double dom_hi, const double* __restrict__ seg_lo,
    const double* __restrict__ seg_hi, const double* __restrict__ coeffs,
    int h) {
  const int s = s_mid < h - 1 ? s_mid : h - 1;
  double c[DEG + 1];
  bool found;
  load_row<DEG>(coeffs, s, c);
  const double root = extreme_root<DEG>(c, tm, 1.0, &found);
  const double x = unscale(found ? root : -1.0, seg_lo[s], seg_hi[s]);
  return jclip(tm <= b_top ? x : dom_hi, x_lo, x_hi);
}

// K4, gather mode: (answer, lower, upper) per slack-shifted rank target,
// every count by a binary search
template <int DEG>
__global__ void quantile_invert_kernel(
    const double* __restrict__ t_mid, const double* __restrict__ t_lo,
    const double* __restrict__ t_hi, const double* __restrict__ B,
    const double* __restrict__ seg_lo, const double* __restrict__ seg_hi,
    const double* __restrict__ coeffs, const double* __restrict__ seg_err,
    const double* __restrict__ ref_keys, double* __restrict__ out_mid,
    double* __restrict__ out_lo, double* __restrict__ out_hi, int Q, int H,
    int h, int nk, int n, double delta) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  const double b_top = B[h - 1];
  const double dom_hi = seg_hi[h - 1];
  const double th = t_hi[i], tl = t_lo[i], tm = t_mid[i];
  // the segment of each inversion: the first whose running-max endpoint
  // value clears the target (hi, mid), past every one at or below it (lo)
  const int s_hi = bsearch_count_left(B, H, th + delta);
  const int s_lo = bsearch_count_right(B, H, tl - delta);
  const int s_mid = bsearch_count_left(B, H, tm);
  const double x = upper_root<DEG>(s_hi, th, seg_lo, seg_hi, coeffs,
                                   seg_err, h);
  const double x_hi = upper_end(bsearch_count_left(ref_keys, nk, x), th,
                                delta, b_top, dom_hi, ref_keys, n);
  const double x_lo = lower_end<DEG>(s_lo, tl, seg_lo, seg_hi, coeffs,
                                     seg_err, h);
  out_mid[i] = answer<DEG>(s_mid, tm, x_lo, x_hi, b_top, dom_hi, seg_lo,
                           seg_hi, coeffs, h);
  out_lo[i] = x_lo;
  out_hi[i] = x_hi;
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
    x[r] = upper_root<DEG>(s_hi[r], th[r], seg_lo, seg_hi, coeffs, seg_err,
                           h);
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
  const double x_lo = lower_end<DEG>(part[(size_t)S * Q + i], t_lo[i],
                                     seg_lo, seg_hi, coeffs, seg_err, h);
  out_mid[i] = answer<DEG>(part[(size_t)(S + 1) * Q + i], t_mid[i], x_lo,
                           x_hi, b_top, dom_hi, seg_lo, seg_hi, coeffs, h);
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

int polyfit_quantile_invert(const void* t_mid, const void* t_lo,
                            const void* t_hi, const void* B,
                            const void* seg_lo, const void* seg_hi,
                            const void* coeffs, const void* seg_err,
                            const void* ref_keys, void* out_mid, void* out_lo,
                            void* out_hi, int Q, int H, int deg, int h, int nk,
                            int n, double delta, void* stream) {
  using namespace polyfit;
  if (Q <= 0) return (int)cudaGetLastError();
  return with_degree(deg, [&](auto d) {
    quantile_invert_kernel<decltype(d)::value>
        <<<(Q + kThreads - 1) / kThreads, kThreads, 0,
           (cudaStream_t)stream>>>(
            (const double*)t_mid, (const double*)t_lo, (const double*)t_hi,
            (const double*)B, (const double*)seg_lo, (const double*)seg_hi,
            (const double*)coeffs, (const double*)seg_err,
            (const double*)ref_keys, (double*)out_mid, (double*)out_lo,
            (double*)out_hi, Q, H, h, nk, n, delta);
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
