// PolyFit certified quantile inversion for Hopper (sm_90a), float64, one
// thread per rank target.
//
// K4 quantile_invert_kernel  replaces repro/kernels/quantile_invert.py:quantile_invert_pallas
//    (SCAN = false: the 'cuda' backend; SCAN = true: the reference's
//    scan=True mode, the 'cuda_scan' backend)
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
// The scan mode (SCAN = true) takes every count as the one-hot comparison
// sum of the reference's scan=True: #(B < t + delta), #(B <= t - delta),
// #(B < t) and #(ref_keys < x), each over the whole array.  On sorted
// arrays the summed predicate is the binary search's, so both modes return
// the same keys bit for bit.  The block's 256 targets walk each array in
// tiles of 256 entries staged through shared memory (the three B counts in
// one pass); that makes it bound by operations, 2 (3 Hp + nk) compares and
// adds a target: at Q = 65,536 and a 200,000-key grid about 2.6e10, about
// 0.8 ms at the FP64 peak, where the gather mode takes microseconds.

#include <cuda_runtime.h>
#include <stdint.h>

#include "locate.cuh"

namespace polyfit {
namespace {

constexpr int kThreads = 256;
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

template <int DEG>
__device__ __forceinline__ double horner_r(const double (&c)[DEG + 1], double u) {
  double acc = c[DEG];
#pragma unroll
  for (int j = DEG - 1; j >= 0; --j) acc = acc * u + c[j];
  return acc;
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

// #(keys[0:n] < q[e]) where left[e], else #(keys[0:n] <= q[e]), for each of
// a thread's NC targets: one-hot comparison sums over tiles of the array
// staged through shared memory, every thread of the block taking part
template <int NC>
__device__ void scan_counts(const double* __restrict__ keys, int n,
                            const double (&q)[NC], const bool (&left)[NC],
                            int (&c)[NC]) {
  __shared__ double s_k[kThreads];
#pragma unroll
  for (int e = 0; e < NC; ++e) c[e] = 0;
  for (int t0 = 0; t0 < n; t0 += kThreads) {
    const int j = t0 + threadIdx.x;
    if (j < n) s_k[threadIdx.x] = keys[j];
    __syncthreads();
    const int m = n - t0 < kThreads ? n - t0 : kThreads;
    for (int k = 0; k < m; ++k) {
      const double key = s_k[k];
#pragma unroll
      for (int e = 0; e < NC; ++e)
        c[e] += left[e] ? (key < q[e] ? 1 : 0) : (key <= q[e] ? 1 : 0);
    }
    __syncthreads();
  }
}

// K4: (answer, lower, upper) per slack-shifted rank target; SCAN takes
// every count by one-hot comparison sums instead of binary searches
template <int DEG, bool SCAN>
__global__ void quantile_invert_kernel(
    const double* __restrict__ t_mid, const double* __restrict__ t_lo,
    const double* __restrict__ t_hi, const double* __restrict__ B,
    const double* __restrict__ seg_lo, const double* __restrict__ seg_hi,
    const double* __restrict__ coeffs, const double* __restrict__ seg_err,
    const double* __restrict__ ref_keys, double* __restrict__ out_mid,
    double* __restrict__ out_lo, double* __restrict__ out_hi, int Q, int H,
    int h, int nk, int n, double delta) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (!SCAN && i >= Q) return;
  const int r = i < Q ? i : Q - 1;   // scan: threads past Q still stage tiles
  constexpr bool tight = DEG <= 3;
  const double b_top = B[h - 1];
  const double dom_hi = seg_hi[h - 1];
  const double th = t_hi[r], tl = t_lo[r], tm = t_mid[r];
  double c[DEG + 1];
  bool found;

  // the segment of each inversion: the first whose running-max endpoint
  // value clears the target (hi, mid), past every one at or below it (lo)
  int s_hi, s_lo, s_mid;
  if constexpr (SCAN) {
    const double q[3] = {th + delta, tl - delta, tm};
    const bool left[3] = {true, false, true};
    int cnt[3];
    scan_counts<3>(B, H, q, left, cnt);
    s_hi = cnt[0], s_lo = cnt[1], s_mid = cnt[2];
  } else {
    s_hi = bsearch_count_left(B, H, th + delta);
    s_lo = bsearch_count_right(B, H, tl - delta);
    s_mid = bsearch_count_left(B, H, tm);
  }

  // upper end: certified against seg_err, snapped up to the key grid
  double x_hi;
  {
    const int s = s_hi < h - 1 ? s_hi : h - 1;
    const double lo = seg_lo[s], hi = seg_hi[s];
    double x = hi;
    if constexpr (tight) {
      load_row<DEG>(coeffs, s, c);
      const double root = extreme_root<DEG>(c, th + seg_err[s], 1.0, &found);
      x = unscale(found ? root : -1.0, lo, hi);
    }
    int k;
    if constexpr (SCAN) {
      const double q[1] = {x};
      const bool left[1] = {true};
      int cnt[1];
      scan_counts<1>(ref_keys, nk, q, left, cnt);
      k = cnt[0];
    } else {
      k = bsearch_count_left(ref_keys, nk, x);
    }
    k = k < n - 1 ? k : n - 1;
    x_hi = th + delta <= b_top ? ref_keys[k] : dom_hi;
  }

  // lower end: certified against seg_err, no snap
  double x_lo;
  {
    int s = s_lo > 0 ? s_lo : 0;
    s = s < h - 1 ? s : h - 1;
    const double below = s > 0 ? seg_hi[s - 1] : seg_lo[0];
    x_lo = below;
    if constexpr (tight) {
      load_row<DEG>(coeffs, s, c);
      const double T = tl - seg_err[s];
      const double tiny = 1e-9 * (fabs(T) + 1.0);
      const double root = extreme_root<DEG>(c, T, -1.0, &found);
      const bool start_ok = horner_r<DEG>(c, -1.0) <= T + tiny;
      const double u = found ? root : 1.0;
      x_lo = start_ok ? unscale(u, seg_lo[s], seg_hi[s]) : below;
    }
  }

  // answer: the raw fitted crossing (zero error), clipped into [lo, hi]
  double x_mid;
  {
    const int s = s_mid < h - 1 ? s_mid : h - 1;
    load_row<DEG>(coeffs, s, c);
    const double root = extreme_root<DEG>(c, tm, 1.0, &found);
    const double x = unscale(found ? root : -1.0, seg_lo[s], seg_hi[s]);
    x_mid = jclip(tm <= b_top ? x : dom_hi, x_lo, x_hi);
  }

  if (i >= Q) return;
  out_mid[i] = x_mid;
  out_lo[i] = x_lo;
  out_hi[i] = x_hi;
}

template <int DEG, bool SCAN>
void launch(const void* t_mid, const void* t_lo, const void* t_hi,
            const void* B, const void* seg_lo, const void* seg_hi,
            const void* coeffs, const void* seg_err, const void* ref_keys,
            void* out_mid, void* out_lo, void* out_hi, int Q, int H, int h,
            int nk, int n, double delta, cudaStream_t stream) {
  quantile_invert_kernel<DEG, SCAN><<<(Q + kThreads - 1) / kThreads, kThreads,
                                      0, stream>>>(
      (const double*)t_mid, (const double*)t_lo, (const double*)t_hi,
      (const double*)B, (const double*)seg_lo, (const double*)seg_hi,
      (const double*)coeffs, (const double*)seg_err, (const double*)ref_keys,
      (double*)out_mid, (double*)out_lo, (double*)out_hi, Q, H, h, nk, n,
      delta);
}

// one instantiation per degree 1..kMaxQuantileDeg
template <bool SCAN>
int dispatch(const void* t_mid, const void* t_lo, const void* t_hi,
             const void* B, const void* seg_lo, const void* seg_hi,
             const void* coeffs, const void* seg_err, const void* ref_keys,
             void* out_mid, void* out_lo, void* out_hi, int Q, int H, int deg,
             int h, int nk, int n, double delta, void* stream) {
  if (Q <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  static_assert(kMaxQuantileDeg == 8, "one case per degree below");
#define POLYFIT_K4_CASE(D)                                                   \
  case D:                                                                    \
    launch<D, SCAN>(t_mid, t_lo, t_hi, B, seg_lo, seg_hi, coeffs, seg_err,   \
                    ref_keys, out_mid, out_lo, out_hi, Q, H, h, nk, n, delta, \
                    s);                                                      \
    break;
  switch (deg) {
    POLYFIT_K4_CASE(1)
    POLYFIT_K4_CASE(2)
    POLYFIT_K4_CASE(3)
    POLYFIT_K4_CASE(4)
    POLYFIT_K4_CASE(5)
    POLYFIT_K4_CASE(6)
    POLYFIT_K4_CASE(7)
    POLYFIT_K4_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef POLYFIT_K4_CASE
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
  return polyfit::dispatch<false>(t_mid, t_lo, t_hi, B, seg_lo, seg_hi,
                                  coeffs, seg_err, ref_keys, out_mid, out_lo,
                                  out_hi, Q, H, deg, h, nk, n, delta, stream);
}

int polyfit_quantile_invert_scan(const void* t_mid, const void* t_lo,
                                 const void* t_hi, const void* B,
                                 const void* seg_lo, const void* seg_hi,
                                 const void* coeffs, const void* seg_err,
                                 const void* ref_keys, void* out_mid,
                                 void* out_lo, void* out_hi, int Q, int H,
                                 int deg, int h, int nk, int n, double delta,
                                 void* stream) {
  return polyfit::dispatch<true>(t_mid, t_lo, t_hi, B, seg_lo, seg_hi,
                                 coeffs, seg_err, ref_keys, out_mid, out_lo,
                                 out_hi, Q, H, deg, h, nk, n, delta, stream);
}

}  // extern "C"
