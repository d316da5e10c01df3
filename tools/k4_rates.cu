// K4's gather mode (quantile_invert, csrc/quantile.cu) before and after its
// redesign, and the forms the redesign was chosen from, on the card:
//
//   k4_old      K4 before: one thread a target, three binary searches over
//               B, the three inversions in sequence, each root solve with
//               every branch computed and one selected, the rows a value a
//               load, the snap by a binary search over the padded key grid;
//   shipped     K4 as quantile.cu launches it (included below);
//   k4_variant  the inversions with other options: LANES lanes a target
//               (1: one thread runs the three in sequence; 3: one
//               inversion a lane, as shipped; 4: the same with a fourth
//               lane that repeats the answer's inversion and writes
//               nothing); TREE, the snap by a descent of the grid's search
//               tree over its n live keys (locate.cuh tree_count_left),
//               else by the binary search over the padded grid; SKIP, each
//               root solve computes only the branch it keeps, else every
//               branch (the quadratic, the trigonometric and Cardano's
//               roots) and selects.  The rows by 16-byte loads;
//   k4_shape    the shipped body (tree, skip) at other shapes: two targets
//               a lane in lockstep, at least 6 or 7 blocks an SM (fewer
//               registers: the grid in one wave), B staged in shared
//               memory, and without the snap (a breakdown of the time,
//               not held).
//
// The probes count instructions only (their SASS, read by
// tools/k4_k21_rates.py): the cubic's solve as shipped, its trigonometric
// and its Cardano branch alone, the quadratic's solve and its quadratic
// branch alone, the binary search over B, and the descent of the key
// grid's tree.
//
// Built and timed by tools/k4_k21_rates.py, which holds each whole kernel
// to the plain version (kernels/quantile_invert.py quantile_invert_plain).
#include "../src/repro_torch/csrc/quantile.cu"

namespace {

using polyfit::bsearch_count_left;
using polyfit::bsearch_count_right;
using polyfit::bsearch_count_side;
using polyfit::horner_r;
using polyfit::jclip;
using polyfit::jmax;
using polyfit::jmin;
using polyfit::kFourPiThirds;
using polyfit::kHi;
using polyfit::kLo;
using polyfit::kMid;
using polyfit::kTwoPiThirds;
using polyfit::load_row_v16;
using polyfit::root_linear;
using polyfit::signed_cbrt;
using polyfit::tree_count_left;
using polyfit::TreeShape;
using polyfit::unscale;
using polyfit::upper_end;

constexpr int kBlock = 256;

// The solvers before the redesign: every branch computed, one selected
// (the shipped ones compute only the branch they keep)

__device__ __forceinline__ void quadratic_all(double c, double b, double a,
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

__device__ __forceinline__ void cubic_all(double d, double c, double b,
                                          double a, double* r) {
  double q1, q2;
  quadratic_all(d, c, b, &q1, &q2);
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
  const double t_single =
      signed_cbrt(-q / 2.0 + sq) + signed_cbrt(-q / 2.0 - sq);
  const bool three = disc <= 0;
  const double r0 = (three ? t0 : t_single) - shift;
  const double r1 = (three ? t1 : NAN) - shift;
  const double r2 = (three ? t2 : NAN) - shift;
  const bool is_cubic = fabs(a) > 0;
  r[0] = is_cubic ? r0 : q1;
  r[1] = is_cubic ? r1 : q2;
  r[2] = is_cubic ? r2 : NAN;
}

// One branch of quantile.cu roots_cubic forced (probes only): the
// trigonometric roots (TRIG) or Cardano's
template <bool TRIG>
__device__ __forceinline__ void cubic_branch(double d, double c, double b,
                                             double a, double* r) {
  const double shift = b / (3.0 * a);
  const double p = (3.0 * a * c - b * b) / (3.0 * a * a);
  const double q = (2.0 * (b * b * b) - 9.0 * a * b * c + 27.0 * a * a * d) /
                   (27.0 * (a * a * a));
  const double disc = (q * q) * 0.25 + (p * p * p) * (1.0 / 27.0);
  if constexpr (TRIG) {
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

// quantile.cu extreme_root on the solvers before the redesign, or (SKIP)
// extreme_root itself
template <int DEG, bool SKIP>
__device__ double extreme_root_v(const double (&c)[DEG + 1], double T,
                                 double sign, bool* found) {
  if constexpr (SKIP || DEG <= 1 || DEG > 3) {
    return polyfit::extreme_root<DEG>(c, T, sign, found);
  } else {
    double r[3];
    int nr = 2;
    if constexpr (DEG == 2) {
      quadratic_all(c[0] - T, c[1], c[2], &r[0], &r[1]);
    } else {
      cubic_all(c[0] - T, c[1], c[2], c[3], r);
      nr = 3;
    }
    double best = -INFINITY;
    for (int j = 0; j < nr; ++j) {
      const bool valid = isfinite(r[j]) && fabs(r[j]) <= 1.0 + 1e-9;
      best = valid ? jmax(best, sign * jclip(r[j], -1.0, 1.0)) : best;
    }
    *found = isfinite(best);
    return *found ? sign * best : 0.0;
  }
}

// ---------------------------------------------------------------------------
// K4 before its redesign
// ---------------------------------------------------------------------------

template <int DEG>
__device__ __forceinline__ void load_row(const double* __restrict__ coeffs,
                                         int s, double (&c)[DEG + 1]) {
  const double* row = coeffs + (size_t)s * (DEG + 1);
#pragma unroll
  for (int j = 0; j <= DEG; ++j) c[j] = row[j];
}

template <int DEG>
__global__ void k4_old(const double* __restrict__ t_mid,
                       const double* __restrict__ t_lo,
                       const double* __restrict__ t_hi,
                       const double* __restrict__ B,
                       const double* __restrict__ seg_lo,
                       const double* __restrict__ seg_hi,
                       const double* __restrict__ coeffs,
                       const double* __restrict__ seg_err,
                       const double* __restrict__ ref_keys,
                       double* __restrict__ out_mid,
                       double* __restrict__ out_lo,
                       double* __restrict__ out_hi, int Q, int H, int h,
                       int nk, int n, double delta) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  const double b_top = B[h - 1];
  const double dom_hi = seg_hi[h - 1];
  const double th = t_hi[i], tl = t_lo[i], tm = t_mid[i];
  const int s_hi = bsearch_count_left(B, H, th + delta);
  const int s_lo = bsearch_count_right(B, H, tl - delta);
  const int s_mid = bsearch_count_left(B, H, tm);
  bool found;
  // upper end: the root, snapped by a binary search over the padded grid
  int s = s_hi < h - 1 ? s_hi : h - 1;
  double x = seg_hi[s];
  if constexpr (DEG <= 3) {
    double c[DEG + 1];
    load_row<DEG>(coeffs, s, c);
    const double root =
        extreme_root_v<DEG, false>(c, th + seg_err[s], 1.0, &found);
    x = unscale(found ? root : -1.0, seg_lo[s], seg_hi[s]);
  }
  const double x_hi = upper_end(bsearch_count_left(ref_keys, nk, x), th,
                                delta, b_top, dom_hi, ref_keys, n);
  // lower end
  s = s_lo < h - 1 ? s_lo : h - 1;
  const double below = s > 0 ? seg_hi[s - 1] : seg_lo[0];
  double x_lo = below;
  if constexpr (DEG <= 3) {
    double c[DEG + 1];
    load_row<DEG>(coeffs, s, c);
    const double T = tl - seg_err[s];
    const double tiny = 1e-9 * (fabs(T) + 1.0);
    const double root = extreme_root_v<DEG, false>(c, T, -1.0, &found);
    const bool start_ok = horner_r<DEG>(c, -1.0) <= T + tiny;
    x_lo = start_ok ? unscale(found ? root : 1.0, seg_lo[s], seg_hi[s])
                    : below;
  }
  // answer
  s = s_mid < h - 1 ? s_mid : h - 1;
  double c[DEG + 1];
  load_row<DEG>(coeffs, s, c);
  const double root = extreme_root_v<DEG, false>(c, tm, 1.0, &found);
  const double xm = unscale(found ? root : -1.0, seg_lo[s], seg_hi[s]);
  out_mid[i] = jclip(tm <= b_top ? xm : dom_hi, x_lo, x_hi);
  out_lo[i] = x_lo;
  out_hi[i] = x_hi;
}

// ---------------------------------------------------------------------------
// the variants
// ---------------------------------------------------------------------------

// quantile.cu invert_side on the chosen solvers
template <int DEG, bool SKIP>
__device__ __forceinline__ double side_v(
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
      extreme_root_v<DEG, SKIP>(c, T, side == kLo ? -1.0 : 1.0, &found);
  const double x = unscale(found ? root : (side == kLo ? 1.0 : -1.0), lo, hi);
  if (side != kLo) return x;
  const double tiny = 1e-9 * (fabs(T) + 1.0);
  return horner_r<DEG>(c, -1.0) <= T + tiny ? x : below;
}

struct Args {
  const double *t_mid, *t_lo, *t_hi, *B, *seg_lo, *seg_hi, *coeffs,
      *seg_err, *ref_keys, *tree;
  double *out_mid, *out_lo, *out_hi;
  int Q, H, h, nk, n;
  double delta;
  TreeShape shape;
};

template <bool TREE>
__device__ __forceinline__ int snap_count(const Args& a, double x) {
  if constexpr (TREE) {
    return tree_count_left(a.ref_keys, a.n, a.tree, a.shape, x);
  } else {
    return bsearch_count_left(a.ref_keys, a.nk, x);
  }
}

template <int DEG, int LANES, bool TREE, bool SKIP>
__global__ void __launch_bounds__(kBlock) k4_variant(Args a) {
  const double b_top = a.B[a.h - 1];
  const double dom_hi = a.seg_hi[a.h - 1];
  if constexpr (LANES == 1) {
    const int i = blockIdx.x * kBlock + threadIdx.x;
    if (i >= a.Q) return;
    const double th = a.t_hi[i], tl = a.t_lo[i], tm = a.t_mid[i];
    const int c_hi = bsearch_count_left(a.B, a.H, th + a.delta);
    const int c_lo = bsearch_count_right(a.B, a.H, tl - a.delta);
    const int c_mid = bsearch_count_left(a.B, a.H, tm);
    const double x = side_v<DEG, SKIP>(kHi, c_hi, th, a.seg_lo, a.seg_hi,
                                       a.coeffs, a.seg_err, a.h);
    const double x_hi = upper_end(snap_count<TREE>(a, x), th, a.delta, b_top,
                                  dom_hi, a.ref_keys, a.n);
    const double x_lo = side_v<DEG, SKIP>(kLo, c_lo, tl, a.seg_lo, a.seg_hi,
                                          a.coeffs, a.seg_err, a.h);
    const double xm = side_v<DEG, SKIP>(kMid, c_mid, tm, a.seg_lo, a.seg_hi,
                                        a.coeffs, a.seg_err, a.h);
    a.out_mid[i] = jclip(tm <= b_top ? xm : dom_hi, x_lo, x_hi);
    a.out_lo[i] = x_lo;
    a.out_hi[i] = x_hi;
  } else {
    constexpr int kPerWarp = 32 / LANES;
    const int lane = threadIdx.x & 31;
    const int g = lane / LANES;
    const int role = lane - g * LANES;
    const int side = role < 3 ? role : kMid;
    const long long tgt =
        ((long long)blockIdx.x * kBlock + threadIdx.x) / 32 * kPerWarp + g;
    const int i = tgt < a.Q ? (int)tgt : a.Q - 1;
    const bool hi_side = side == kHi, lo_side = side == kLo;
    const double t = (hi_side ? a.t_hi : lo_side ? a.t_lo : a.t_mid)[i];
    const int cnt = bsearch_count_side(
        a.B, a.H, hi_side ? t + a.delta : lo_side ? t - a.delta : t, lo_side);
    double x = side_v<DEG, SKIP>(side, cnt, t, a.seg_lo, a.seg_hi, a.coeffs,
                                 a.seg_err, a.h);
    if (hi_side)
      x = upper_end(snap_count<TREE>(a, x), t, a.delta, b_top, dom_hi,
                    a.ref_keys, a.n);
    const int first = lane - role;
    const double x_hi = __shfl_sync(0xffffffffu, x, first + kHi);
    const double x_lo = __shfl_sync(0xffffffffu, x, first + kLo);
    if (tgt >= a.Q || g >= kPerWarp || role > 2) return;
    if (side == kMid) {
      a.out_mid[i] = jclip(t <= b_top ? x : dom_hi, x_lo, x_hi);
    } else {
      (hi_side ? a.out_hi : a.out_lo)[i] = x;
    }
  }
}

template <int DEG, int LANES>
void launch_lanes(int tree, int skip, const Args& a, cudaStream_t s) {
  const long long threads =
      LANES == 1 ? a.Q
                 : ((long long)a.Q + 32 / LANES - 1) / (32 / LANES) * 32;
  const int blocks = (int)((threads + kBlock - 1) / kBlock);
  auto k = k4_variant<DEG, LANES, false, false>;
  if (tree && skip) k = k4_variant<DEG, LANES, true, true>;
  if (tree && !skip) k = k4_variant<DEG, LANES, true, false>;
  if (!tree && skip) k = k4_variant<DEG, LANES, false, true>;
  k<<<blocks, kBlock, 0, s>>>(a);
}

template <int DEG>
void launch_variant(int opts, const Args& a, cudaStream_t s) {
  const int tree = opts & 1, skip = (opts >> 1) & 1;
  switch (opts >> 2) {
    case 0: launch_lanes<DEG, 1>(tree, skip, a, s); break;
    case 1: launch_lanes<DEG, 3>(tree, skip, a, s); break;
    case 2: launch_lanes<DEG, 4>(tree, skip, a, s); break;
  }
}

// ---------------------------------------------------------------------------
// the shipped body (tree, skip) at other shapes
// ---------------------------------------------------------------------------

// R searches over B in lockstep, the compare picked per lane
// (bsearch_count_side R wide)
template <int R>
__device__ __forceinline__ void search_side_r(const double* __restrict__ B,
                                              int n, const double (&q)[R],
                                              bool right, int (&c)[R]) {
#pragma unroll
  for (int k = 0; k < R; ++k) c[k] = 0;
  for (int step = polyfit::bit_ceil(n); step >= 1; step >>= 1) {
    double pv[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int probe = c[k] + step - 1;
      pv[k] = B[probe < n - 1 ? probe : n - 1];
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int probe = c[k] + step - 1;
      c[k] = (probe <= n - 1 && (pv[k] < q[k] || (right && pv[k] == q[k])))
                 ? c[k] + step
                 : c[k];
    }
  }
}

// R descents of the key grid's tree in lockstep (tree_count_left R wide)
template <int R>
__device__ __forceinline__ void tree_left_r(const double* __restrict__ keys,
                                            int n,
                                            const double* __restrict__ tree,
                                            const TreeShape& shape,
                                            const double (&q)[R],
                                            int (&out)[R]) {
  int node[R];
  double sep[R][4];
#pragma unroll
  for (int k = 0; k < R; ++k) node[k] = 0;
  for (int l = 0; l < shape.levels; ++l) {
#pragma unroll
    for (int k = 0; k < R; ++k)
      load_row_v16<3>(tree, shape.first[l] + node[k], sep[k]);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      int c = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) polyfit::count_lt(c, sep[k][e], q[k]);
      node[k] = polyfit::kTreeFanout * node[k] + c;
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int base = 4 * node[k];
    int c = base;
    for (int j = base; j < (base + 4 < n ? base + 4 : n); ++j)
      polyfit::count_lt(c, __ldg(keys + j), q[k]);
    out[k] = c;
  }
}

// LANES 3: TPL targets a lane (target w 10 TPL + 10 r + g for r < TPL),
// their searches, solves and descents in lockstep; LANES 1: one thread a
// target (TPL 1).  At least MINB blocks an SM.  SNAP false leaves the hi
// point unsnapped (a breakdown of the time: not held).
template <int DEG, int LANES, int TPL, int MINB, bool SNAP, bool SMEM>
__global__ void __launch_bounds__(kBlock, MINB) k4_shape(Args a) {
  extern __shared__ double s_B[];
  if constexpr (SMEM) {
    for (int j = threadIdx.x; j < a.H; j += kBlock) s_B[j] = a.B[j];
    __syncthreads();
    a.B = s_B;
  }
  const double b_top = a.B[a.h - 1];
  const double dom_hi = a.seg_hi[a.h - 1];
  if constexpr (LANES == 1) {
    const int i = blockIdx.x * kBlock + threadIdx.x;
    if (i >= a.Q) return;
    const double th = a.t_hi[i], tl = a.t_lo[i], tm = a.t_mid[i];
    const int c_hi = bsearch_count_left(a.B, a.H, th + a.delta);
    const int c_lo = bsearch_count_right(a.B, a.H, tl - a.delta);
    const int c_mid = bsearch_count_left(a.B, a.H, tm);
    double x_hi = side_v<DEG, true>(kHi, c_hi, th, a.seg_lo, a.seg_hi,
                                    a.coeffs, a.seg_err, a.h);
    if constexpr (SNAP)
      x_hi = upper_end(tree_count_left(a.ref_keys, a.n, a.tree, a.shape,
                                       x_hi),
                       th, a.delta, b_top, dom_hi, a.ref_keys, a.n);
    const double x_lo = side_v<DEG, true>(kLo, c_lo, tl, a.seg_lo, a.seg_hi,
                                          a.coeffs, a.seg_err, a.h);
    const double xm = side_v<DEG, true>(kMid, c_mid, tm, a.seg_lo, a.seg_hi,
                                        a.coeffs, a.seg_err, a.h);
    a.out_mid[i] = jclip(tm <= b_top ? xm : dom_hi, x_lo, x_hi);
    a.out_lo[i] = x_lo;
    a.out_hi[i] = x_hi;
  } else {
    constexpr int kPerWarp = 10 * TPL;
    const int lane = threadIdx.x & 31;
    const int g = lane / 3;
    const int side = lane - g * 3;
    const long long w = ((long long)blockIdx.x * kBlock + threadIdx.x) / 32;
    const bool hi_side = side == kHi, lo_side = side == kLo;
    const double* ts = hi_side ? a.t_hi : lo_side ? a.t_lo : a.t_mid;
    long long tgt[TPL];
    int i[TPL], cnt[TPL];
    double t[TPL], key[TPL], x[TPL];
#pragma unroll
    for (int r = 0; r < TPL; ++r) {
      tgt[r] = w * kPerWarp + 10 * r + g;
      i[r] = tgt[r] < a.Q ? (int)tgt[r] : a.Q - 1;
      t[r] = ts[i[r]];
      key[r] = hi_side ? t[r] + a.delta : lo_side ? t[r] - a.delta : t[r];
    }
    if constexpr (TPL == 1) {
      cnt[0] = bsearch_count_side(a.B, a.H, key[0], lo_side);
    } else {
      search_side_r<TPL>(a.B, a.H, key, lo_side, cnt);
    }
#pragma unroll
    for (int r = 0; r < TPL; ++r)
      x[r] = side_v<DEG, true>(side, cnt[r], t[r], a.seg_lo, a.seg_hi,
                               a.coeffs, a.seg_err, a.h);
    if (SNAP && hi_side) {
      int k[TPL];
      if constexpr (TPL == 1) {
        k[0] = tree_count_left(a.ref_keys, a.n, a.tree, a.shape, x[0]);
      } else {
        tree_left_r<TPL>(a.ref_keys, a.n, a.tree, a.shape, x, k);
      }
#pragma unroll
      for (int r = 0; r < TPL; ++r)
        x[r] = upper_end(k[r], t[r], a.delta, b_top, dom_hi, a.ref_keys,
                         a.n);
    }
    const int first = lane - side;
#pragma unroll
    for (int r = 0; r < TPL; ++r) {
      const double x_hi = __shfl_sync(0xffffffffu, x[r], first + kHi);
      const double x_lo = __shfl_sync(0xffffffffu, x[r], first + kLo);
      if (tgt[r] >= a.Q || g >= 10) continue;
      if (side == kMid) {
        a.out_mid[i[r]] = jclip(t[r] <= b_top ? x[r] : dom_hi, x_lo, x_hi);
      } else {
        (hi_side ? a.out_hi : a.out_lo)[i[r]] = x[r];
      }
    }
  }
}

// which - 14: 0 three lanes, two targets a lane; 1 and 2 three lanes, at
// least 6 and 7 blocks an SM; 3 one lane, no snap; 4 three lanes, no snap;
// 5 three lanes, 6 one lane, B staged in shared memory
template <int DEG>
void launch_shape(int which, const Args& a, cudaStream_t s) {
  const long long warps10 = ((long long)a.Q + 9) / 10;
  const long long warps20 = ((long long)a.Q + 19) / 20;
  const auto blocks = [](long long threads) {
    return (int)((threads + kBlock - 1) / kBlock);
  };
  const size_t smem = (size_t)a.H * sizeof(double);
  switch (which) {
    case 0:
      k4_shape<DEG, 3, 2, 1, true, false>
          <<<blocks(warps20 * 32), kBlock, 0, s>>>(a);
      break;
    case 1:
      k4_shape<DEG, 3, 1, 6, true, false>
          <<<blocks(warps10 * 32), kBlock, 0, s>>>(a);
      break;
    case 2:
      k4_shape<DEG, 3, 1, 7, true, false>
          <<<blocks(warps10 * 32), kBlock, 0, s>>>(a);
      break;
    case 3:
      k4_shape<DEG, 1, 1, 1, false, false><<<blocks(a.Q), kBlock, 0, s>>>(a);
      break;
    case 4:
      k4_shape<DEG, 3, 1, 1, false, false>
          <<<blocks(warps10 * 32), kBlock, 0, s>>>(a);
      break;
    case 5:
      k4_shape<DEG, 3, 1, 1, true, true>
          <<<blocks(warps10 * 32), kBlock, smem, s>>>(a);
      break;
    case 6:
      k4_shape<DEG, 1, 1, 1, true, true><<<blocks(a.Q), kBlock, smem, s>>>(a);
      break;
  }
}

// ---------------------------------------------------------------------------
// instruction-count probes (never launched for their results)
// ---------------------------------------------------------------------------

// which: 0 the cubic as shipped, 1 its trigonometric branch, 2 its
// Cardano branch, 3 the quadratic as shipped, 4 its quadratic branch
template <int WHICH>
__global__ void k4_probe_roots(const double4* __restrict__ in,
                               double* __restrict__ out, int Q) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= Q) return;
  const double4 v = in[i];
  double r[3] = {0.0, 0.0, 0.0};
  if constexpr (WHICH == 0) {
    polyfit::roots_cubic(v.x, v.y, v.z, v.w, r);
  } else if constexpr (WHICH <= 2) {
    cubic_branch<WHICH == 1>(v.x, v.y, v.z, v.w, r);
  } else if constexpr (WHICH == 3) {
    polyfit::roots_quadratic(v.x, v.y, v.z, &r[0], &r[1]);
  } else {
    const double disc = v.y * v.y - 4.0 * v.z * v.x;
    const double sq = sqrt(jmax(disc, 0.0));
    const double denom = 2.0 * v.z;
    r[0] = disc >= 0 ? (-v.y - sq) / denom : NAN;
    r[1] = disc >= 0 ? (-v.y + sq) / denom : NAN;
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) out[3 * i + j] = r[j];
}

// the binary search over B (side picked per lane) and the tree's descent
__global__ void k4_probe_search(const double* __restrict__ B,
                                const double* __restrict__ q,
                                int* __restrict__ out, int Q, int H) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= Q) return;
  out[i] = bsearch_count_side(B, H, q[i], i & 1);
}

__global__ void k4_probe_descent(const double* __restrict__ keys,
                                 const double* __restrict__ tree,
                                 TreeShape shape, const double* __restrict__ q,
                                 int* __restrict__ out, int Q, int n) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= Q) return;
  out[i] = tree_count_left(keys, n, tree, shape, q[i]);
}

template <int DEG>
void run_old(const Args& a, cudaStream_t s) {
  k4_old<DEG><<<(a.Q + kBlock - 1) / kBlock, kBlock, 0, s>>>(
      a.t_mid, a.t_lo, a.t_hi, a.B, a.seg_lo, a.seg_hi, a.coeffs, a.seg_err,
      a.ref_keys, a.out_mid, a.out_lo, a.out_hi, a.Q, a.H, a.h, a.nk, a.n,
      a.delta);
}

}  // namespace

// which: 0 k4_old, 1 the shipped launcher, 2-13 k4_variant (which - 2:
// bit 0 the tree snap, bit 1 the solves that skip the branches they do not
// keep, bits 2-3 the lanes a target: 0 one, 1 three, 2 four), 14-18
// k4_shape (launch_shape; deg 2 and 3 only); ``tree`` the search tree of
// ref_keys[:n]
extern "C" int k4_run(int which, const void* t_mid, const void* t_lo,
                      const void* t_hi, const void* B, const void* seg_lo,
                      const void* seg_hi, const void* coeffs,
                      const void* seg_err, const void* ref_keys,
                      const void* tree, void* out_mid, void* out_lo,
                      void* out_hi, int Q, int H, int deg, int h, int nk,
                      int n, double delta, void* stream) {
  if (Q <= 0) return (int)cudaGetLastError();
  if (which == 1)
    return polyfit_quantile_invert(t_mid, t_lo, t_hi, B, seg_lo, seg_hi,
                                   coeffs, seg_err, ref_keys, tree, out_mid,
                                   out_lo, out_hi, Q, H, deg, h, n, delta,
                                   stream);
  const Args a{(const double*)t_mid, (const double*)t_lo,
               (const double*)t_hi, (const double*)B,
               (const double*)seg_lo, (const double*)seg_hi,
               (const double*)coeffs, (const double*)seg_err,
               (const double*)ref_keys, (const double*)tree,
               (double*)out_mid, (double*)out_lo, (double*)out_hi, Q, H, h,
               nk, n, delta, polyfit::tree_shape(n)};
  const cudaStream_t s = (cudaStream_t)stream;
  if (which < 0 || which > 20) return (int)cudaErrorInvalidValue;
  if (which == 0)
    return polyfit::with_degree(
        deg, [&](auto d) { run_old<decltype(d)::value>(a, s); });
  if (deg != 2 && deg != 3) return (int)cudaErrorInvalidValue;
  if (which >= 14) {
    if (deg == 2) launch_shape<2>(which - 14, a, s);
    else launch_shape<3>(which - 14, a, s);
  } else if (deg == 2) {
    launch_variant<2>(which - 2, a, s);
  } else {
    launch_variant<3>(which - 2, a, s);
  }
  return (int)cudaGetLastError();
}

// keeps the probes' instantiations in the library for cuobjdump
extern "C" void* k4_probes(int k) {
  void* p[] = {(void*)k4_probe_roots<0>, (void*)k4_probe_roots<1>,
               (void*)k4_probe_roots<2>, (void*)k4_probe_roots<3>,
               (void*)k4_probe_roots<4>, (void*)k4_probe_search,
               (void*)k4_probe_descent};
  return p[k];
}
