// Device functions shared by the PolyFit query kernels (polyfit_kernels.cu,
// quantile.cu, leaf_eval2d.cu, delta2d.cu, scan1d.cu, scan2d.cu).
//
// Twins of the plain torch functions in repro_torch/kernels/locate.py,
// repro_torch/core/poly.py and repro_torch/core/index2d.py, written to the
// same order of operations so
// that a kernel and its plain version agree bit for bit when the file is
// compiled with -fmad=false (no multiply-add contraction):
//
//   bsearch_count_right  #(keys <= q) in ceil(log2 n) + 1 probe rounds
//   bsearch_count_left   #(keys < q), the same probe order
//   bsearch_count_side   either of the two, picked per lane (K6's pair)
//   locate_segment       max(#(seg_lo <= q) - 1, 0)
//   count_lt, count_le   c += x < q, c += x <= q (PTX: a compare and a
//                        predicated increment; count_le also on float)
//   tree_shape, tree_count_right, tree_count_left
//                        #(keys <= q) and #(keys < q) by a descent of the
//                        keys' search tree (K1, K2, K3, K21; K4's snap;
//                        double or float)
//   load_row_v16         a table's row into registers by 16-byte loads
//   cut_rank_guess       #(cuts <= q) on sorted cuts by a checked guess
//                        (K7, K8)
//   morton2              Morton code of a quadtree cell from bit tricks
//                        (K7, K8)
//   floor_log2           floor(log2(len)) for len >= 1
//   rmq_gather           max over [i0, i1) of a (levels, n) sparse table
//   mst_prefix_bits      merge-sort-tree count / sum / max over an x prefix,
//                        searching the x-rank's set bits only, G taken
//                        levels' searches in lockstep (K9-K11)
//   scale_unit, horner, fma_emul, clipped_poly_max   (core/poly.py)
//   horner_r, clipped_poly_max_r
//                        the same on a row held in registers, the degree a
//                        template argument (K3; horner_r also K2, K4); the
//                        runtime-degree clipped_poly_max (K15) loads the
//                        row and dispatches to clipped_poly_max_r
//
// jmax / jmin / jclip follow torch.maximum / torch.minimum / torch.clamp:
// a NaN operand gives NaN.  CUDA's fmax / fmin would drop it instead.
//
// The functions of the one-key range kernels (jmax, jmin, jclip,
// locate_segment, rmq_gather, scale_unit, horner, clipped_poly_max,
// horner_r, clipped_poly_max_r) are
// templates on the element type T, double or float, so that K2, K3, K14,
// K15 and K21 have float instantiations for float32 plans; every constant
// among them is written T(...), so a float instantiation rounds each step
// to float as the plain torch version does on float32 tensors.  The other
// functions are double only.
#pragma once

#include <math.h>
#include <stdint.h>

#include <cuda_runtime.h>

#include <type_traits>

namespace polyfit {

template <typename T>
__device__ __forceinline__ T jmax(T a, T b) {
  return (isnan(a) || isnan(b)) ? a + b : (a > b ? a : b);
}

template <typename T>
__device__ __forceinline__ T jmin(T a, T b) {
  return (isnan(a) || isnan(b)) ? a + b : (a < b ? a : b);
}

// min(max(x, lo), hi), NaN-propagating in x (torch.clamp)
template <typename T>
__device__ __forceinline__ T jclip(T x, T lo, T hi) {
  return isnan(x) ? x : jmin(jmax(x, lo), hi);
}

// smallest power of two >= n (1 for n <= 1): the first probe step, equal
// to 1 << (n - 1).bit_length() in the plain version
__device__ __forceinline__ int bit_ceil(int n) {
  return n <= 1 ? 1 : 1 << (32 - __clz(n - 1));
}

// Number of keys[0:n] that are <= q; keys sorted ascending (float64, or
// int32 Morton codes).  Each round probes index c + step - 1 (clamped) and
// advances the count when the probe is in range and satisfies the
// predicate: one load and one select.
template <typename T>
__device__ __forceinline__ int bsearch_count_right(const T* __restrict__ keys,
                                                   int n, T q) {
  int c = 0;
  for (int step = bit_ceil(n); step >= 1; step >>= 1) {
    const int probe = c + step - 1;
    const T pv = keys[probe < n - 1 ? probe : n - 1];
    c = (probe <= n - 1 && pv <= q) ? c + step : c;
  }
  return c;
}

// Number of keys[0:n] that are < q: the probe order of bsearch_count_right
// with a strict compare (the plain version's side="left").
template <typename T>
__device__ __forceinline__ int bsearch_count_left(const T* __restrict__ keys,
                                                  int n, T q) {
  int c = 0;
  for (int step = bit_ceil(n); step >= 1; step >>= 1) {
    const int probe = c + step - 1;
    const T pv = keys[probe < n - 1 ? probe : n - 1];
    c = (probe <= n - 1 && pv < q) ? c + step : c;
  }
  return c;
}

// #(keys[0:n] <= q) where ``right``, else #(keys[0:n] < q): the probe order
// of bsearch_count_right with the compare picked per lane, so that the two
// endpoints of a pair of lanes (K6: lq counts left, uq right) run one loop
// without diverging.  Equal to bsearch_count_right / bsearch_count_left.
template <typename T>
__device__ __forceinline__ int bsearch_count_side(const T* __restrict__ keys,
                                                  int n, T q, bool right) {
  int c = 0;
  for (int step = bit_ceil(n); step >= 1; step >>= 1) {
    const int probe = c + step - 1;
    const T pv = keys[probe < n - 1 ? probe : n - 1];
    c = (probe <= n - 1 && (pv < q || (right && pv == q))) ? c + step : c;
  }
  return c;
}

template <typename T>
__device__ __forceinline__ int locate_segment(const T* __restrict__ seg_lo,
                                              int n, T q) {
  const int c = bsearch_count_right(seg_lo, n, q) - 1;
  return c > 0 ? c : 0;
}

// c += (x < q) and c += (x <= q): an f64 compare and an increment under
// its predicate, written in PTX (the C++ `c += x < q` becomes a compare, a
// select and an add)
__device__ __forceinline__ void count_lt(int& c, double x, double q) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.lt.f64 p, %1, %2;\n\t"
      "@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(c)
      : "d"(x), "d"(q));
}

__device__ __forceinline__ void count_le(int& c, double x, double q) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.le.f64 p, %1, %2;\n\t"
      "@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(c)
      : "d"(x), "d"(q));
}

__device__ __forceinline__ void count_le(int& c, float x, float q) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.le.f32 p, %1, %2;\n\t"
      "@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(c)
      : "f"(x), "f"(q));
}

// K1's search tree over n sorted keys (kernels/locate.py search_tree): a
// static 5-ary B+ tree whose leaf level is the keys array itself (leaf j
// is keys[4j : 4j + 4]) and whose internal nodes are one 32-byte sector of
// four separators each: the first key of children 1-4, NaN where the
// child does not exist (NaN <= q is never true).  The levels are stored
// root first, level l's nodes from node first[l] on; node i's children are
// nodes 5i .. 5i + 4 of the level below (leaves below the last level).
constexpr int kTreeFanout = 5;
constexpr int kMaxTreeLevels = 13;   // 4 x 5^13 keys > 2^31

struct TreeShape {
  int levels;                   // internal levels (0 when n <= 4)
  int first[kMaxTreeLevels];    // each level's first node, root first
};

// the shape of the search tree over n keys
__host__ __device__ inline TreeShape tree_shape(int n) {
  int count[kMaxTreeLevels];
  int levels = 0;
  for (int c = n > 0 ? (n - 1) / 4 + 1 : 0; c > 1;) {
    c = (c + kTreeFanout - 1) / kTreeFanout;
    count[levels++] = c;
  }
  TreeShape s;
  s.levels = levels;
  int off = 0;
  for (int l = 0; l < levels; ++l) {
    s.first[l] = off;
    off += count[levels - 1 - l];
  }
  return s;
}

// Row idx of a row-major table of DEG + 1 values a row, into registers, 16
// bytes a load where the row's length allows it (DEG + 1 even at double:
// K3's deg 1 and 3 rows and a search-tree node; 4 at float), 8 bytes a
// load for a float row of 2, else a value a load: a row of another length
// starts off 16 bytes every other row.  ``p`` is 16-byte aligned.
template <int DEG, typename T>
__device__ __forceinline__ void load_row_v16(const T* __restrict__ p,
                                             int idx, T (&c)[DEG + 1]) {
  constexpr int K = DEG + 1;
  if constexpr (sizeof(T) == 8 && K % 2 == 0) {
    const double2* r =
        reinterpret_cast<const double2*>(p) + (size_t)idx * (K / 2);
#pragma unroll
    for (int e = 0; e < K / 2; ++e) {
      const double2 w = __ldg(r + e);
      c[2 * e] = w.x;
      c[2 * e + 1] = w.y;
    }
  } else if constexpr (sizeof(T) == 4 && K == 4) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p) + idx);
    c[0] = w.x;
    c[1] = w.y;
    c[2] = w.z;
    c[3] = w.w;
  } else if constexpr (sizeof(T) == 4 && K == 2) {
    const float2 w = __ldg(reinterpret_cast<const float2*>(p) + idx);
    c[0] = w.x;
    c[1] = w.y;
  } else {
#pragma unroll
    for (int e = 0; e < K; ++e) c[e] = __ldg(p + (size_t)idx * K + e);
  }
}

// #(keys[0:n] <= q) (RIGHT) or #(keys[0:n] < q) on sorted keys by a
// descent of their search tree: at each level the child is #(separators
// <= q), or < q (one node, a row of four values: load_row_v16, four
// count_le or count_lt), at the leaf the count is 4 leaf + #(keys[4 leaf +
// k] <= q), or < q, over the keys that exist (the last leaf may be
// partial: read key by key, never past keys[n - 1]).  Exact with
// duplicates: every key of an earlier child is <= the chosen child's first
// key, which is <= q (< q), and every key of a later child is >= the next
// separator, which is > q (>= q).  A NaN q goes left at every level and
// counts 0; so does a NaN separator (a child that does not exist).
// ``keys`` and ``tree`` (double or float, the keys' type) are 16-byte
// aligned.
template <bool RIGHT, typename T>
__device__ __forceinline__ int tree_count(const T* __restrict__ keys, int n,
                                          const T* __restrict__ tree,
                                          const TreeShape& shape, T q) {
  const auto count4 = [q](int& c, const T (&s)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (RIGHT) {
        count_le(c, s[e], q);
      } else {
        count_lt(c, s[e], q);
      }
    }
  };
  int node = 0;
  T s[4];
#pragma unroll
  for (int l = 0; l < kMaxTreeLevels; ++l) {
    if (l >= shape.levels) break;
    load_row_v16<3>(tree, shape.first[l] + node, s);
    int c = 0;
    count4(c, s);
    node = kTreeFanout * node + c;
  }
  const int base = 4 * node;
  int c = base;
  if (base + 4 <= n) {
    load_row_v16<3>(keys, node, s);
    count4(c, s);
  } else {
    for (int k = base; k < n; ++k) {
      if constexpr (RIGHT) {
        count_le(c, __ldg(keys + k), q);
      } else {
        count_lt(c, __ldg(keys + k), q);
      }
    }
  }
  return c;
}

// #(keys[0:n] <= q) by the descent (K1, K2, K3, K21)
template <typename T>
__device__ __forceinline__ int tree_count_right(const T* __restrict__ keys,
                                                int n,
                                                const T* __restrict__ tree,
                                                const TreeShape& shape, T q) {
  return tree_count<true>(keys, n, tree, shape, q);
}

// #(keys[0:n] < q) by the descent, the strict twin (K4's snap to the key
// grid: the tree of the grid's n live keys counts, for every q, what the
// binary search over the sentinel-padded grid counts once both are
// clamped to n - 1)
template <typename T>
__device__ __forceinline__ int tree_count_left(const T* __restrict__ keys,
                                               int n,
                                               const T* __restrict__ tree,
                                               const TreeShape& shape, T q) {
  return tree_count<false>(keys, n, tree, shape, q);
}

// #(c[0:n] <= q) for sorted cuts c (K7's and K8's cells), equal to
// bsearch_count_right in every lane.  The plan's cuts (dyadic_cuts) are
// nearly uniform, so g = floor((q - c[0]) / (c[n-1] - c[0]) (n - 1)) + 1,
// clamped to [0, n], is the count or one off.  For sorted cuts the count is
// the unique g in [0, n] with c[g - 1] <= q (or g = 0) and q < c[g] (or
// g = n): every cut below g is <= q and none from g on is.  So a guess that
// passes that check is exact whatever its arithmetic; a failed check steps
// g toward q (down when c[g - 1] > q, else up), at most twice, and a guess
// still unchecked after that (a NaN q passes no check) takes the binary
// search.  n <= 2 (the depth-0 and depth-1 grids) takes it at once.
__device__ __forceinline__ int cut_rank_guess(const double* __restrict__ c,
                                              int n, double q) {
  if (n <= 2) return bsearch_count_right(c, n, q);
  const double c0 = c[0];
  // NaN or infinite for a NaN q, an infinite one or equal end cuts: the
  // check decides
  const double t = (q - c0) * ((double)(n - 1) / (c[n - 1] - c0));
  int g = t >= 0.0 ? (t < (double)(n - 1) ? (int)t + 1 : n) : 0;
  for (int check = 0; check < 3; ++check) {
    const bool lo_ok = g == 0 || c[g - 1] <= q;
    const bool hi_ok = g == n || q < c[g];
    if (lo_ok && hi_ok) return g;
    g += lo_ok ? 1 : -1;
  }
  return bsearch_count_right(c, n, q);
}

// bits 0..15 of v spread to the even bits
__device__ __forceinline__ uint32_t spread_bits(uint32_t v) {
  v &= 0x0000ffffu;
  v = (v | (v << 8)) & 0x00ff00ffu;
  v = (v | (v << 4)) & 0x0f0f0f0fu;
  v = (v | (v << 2)) & 0x33333333u;
  v = (v | (v << 1)) & 0x55555555u;
  return v;
}

// Morton (Z-order) code of cell (ix, iy) at depth bits per axis, for ix,
// iy >= 0 and depth <= 15: the bits of each below depth, x on the even
// bits and y on the odd ones (kernels/locate.py interleave2)
__device__ __forceinline__ int32_t morton2(int32_t ix, int32_t iy, int depth) {
  const uint32_t mask = (1u << depth) - 1u;
  return (int32_t)(spread_bits((uint32_t)ix & mask) |
                   (spread_bits((uint32_t)iy & mask) << 1));
}

__device__ __forceinline__ int floor_log2(int len) { return 31 - __clz(len); }

// max over [i0, i1) against st (levels, n), row-major; empty -> -inf
template <typename T>
__device__ __forceinline__ T rmq_gather(const T* __restrict__ st, int n,
                                        int i0, int i1) {
  const int length = i1 - i0 > 0 ? i1 - i0 : 0;
  const int lvl = floor_log2(length > 1 ? length : 1);
  const int pow2 = 1 << lvl;
  const size_t row = (size_t)lvl * (size_t)n;
  const int a = i0 < n - 1 ? i0 : n - 1;
  int b = i1 - pow2;
  b = b > 0 ? b : 0;
  b = b < n - 1 ? b : n - 1;
  return length > 0 ? jmax(st[row + a], st[row + b]) : T(-INFINITY);
}

template <typename T>
__device__ __forceinline__ T scale_unit(T q, T lo, T hi) {
  const T span = hi > lo ? hi - lo : T(1);
  return jclip((T(2) * q - lo - hi) / span, T(-1), T(1));
}

// a * b + c rounded as a fused multiply-add rounds it, in plain IEEE
// operations (core/poly.py fma): Dekker's exact product error over a
// Veltkamp split, a TwoSum of p + c, then s + (t + e).  With -fmad=false
// every step rounds on its own, as the plain torch version's do.
__device__ __forceinline__ double fma_emul(double a, double b, double c) {
  constexpr double kSplit = 134217729.0;  // 2^27 + 1
  const double p = a * b;
  const double ta = kSplit * a;
  const double ah = ta - (ta - a);
  const double al = a - ah;
  const double tb = kSplit * b;
  const double bh = tb - (tb - b);
  const double bl = b - bh;
  const double e = ((ah * bh - p) + ah * bl + al * bh) + al * bl;
  const double s = p + c;
  const double bb = s - p;
  const double t = (p - (s - bb)) + (c - bb);
  return s + (t + e);
}

// P(u) for ascending coefficients c[0..deg]: c a pointer, or a row held in
// registers (horner_r), whose compile-time degree unrolls the loop
template <typename C, typename T>
__device__ __forceinline__ T horner(const C& c, int deg, T u) {
  T acc = c[deg];
#pragma unroll
  for (int j = deg - 1; j >= 0; --j) acc = acc * u + c[j];
  return acc;
}

template <int DEG, typename T>
__device__ __forceinline__ T horner_r(const T (&c)[DEG + 1], T u) {
  return horner(c, DEG, u);
}

// max over k in [a, b] of P(u(k)) for a row held in registers, its degree a
// compile-time constant: both clamped endpoints plus the real
// zero-derivative points of P (deg 2: one linear root, deg 3: the two
// quadratic roots), each clamped into [u(a), u(b)].  a > b gives -inf.
template <int DEG, typename T>
__device__ __forceinline__ T clipped_poly_max_r(const T (&c)[DEG + 1], T slo,
                                                T shi, T a, T b) {
  static_assert(DEG >= 0 && DEG <= 3, "the closed forms cover deg <= 3");
  const T ua = scale_unit(a, slo, shi);
  const T ub = scale_unit(b, slo, shi);
  T best = jmax(horner_r<DEG>(c, ua), horner_r<DEG>(c, ub));
  if constexpr (DEG >= 2) {
    const T c1 = c[1];
    const T c2 = T(2) * c[2];
    const T lin = fabs(c2) > T(0) ? -c1 / (c2 == T(0) ? T(1) : c2) : ua;
    if constexpr (DEG == 2) {
      best = jmax(best, horner_r<DEG>(c, jclip(lin, ua, ub)));
    } else {  // P' = c1 + 2 c2 u + 3 c3 u^2
      const T c3 = T(3) * c[3];
      const T disc = c2 * c2 - T(4) * c3 * c1;
      const T sq = sqrt(jmax(disc, T(0)));
      const T den = fabs(c3) > T(0) ? T(2) * c3 : T(1);
      const bool quad_ok = fabs(c3) > T(0) && disc >= T(0);
      const T r1 = quad_ok ? (-c2 - sq) / den : lin;
      const T r2 = quad_ok ? (-c2 + sq) / den : lin;
      best = jmax(best, horner_r<DEG>(c, jclip(r1, ua, ub)));
      best = jmax(best, horner_r<DEG>(c, jclip(r2, ua, ub)));
    }
  }
  return a <= b ? best : T(-INFINITY);
}

template <int DEG, typename T>
__device__ __forceinline__ T clipped_poly_max_at(const T* __restrict__ c,
                                                 T slo, T shi, T a, T b) {
  T r[DEG + 1];
#pragma unroll
  for (int j = 0; j <= DEG; ++j) r[j] = c[j];
  return clipped_poly_max_r<DEG>(r, slo, shi, a, b);
}

// clipped_poly_max_r on the row c[0..deg] in memory, the degree a runtime
// argument (K15's finish); the wrappers admit deg 0-3, NaN past them
template <typename T>
__device__ __forceinline__ T clipped_poly_max(const T* __restrict__ c,
                                              int deg, T slo, T shi, T a,
                                              T b) {
  switch (deg) {
    case 0: return clipped_poly_max_at<0>(c, slo, shi, a, b);
    case 1: return clipped_poly_max_at<1>(c, slo, shi, a, b);
    case 2: return clipped_poly_max_at<2>(c, slo, shi, a, b);
    case 3: return clipped_poly_max_at<3>(c, slo, shi, a, b);
  }
  return T(NAN);
}

enum class MstMode { kCount, kSum, kMax };

// ---------------------------------------------------------------------------
// The merge-sort-tree prefix over the set bits of the x-rank (K9-K11)
// ---------------------------------------------------------------------------
//
// The reduction over x-rank [0, i) with y <= v (the twin of
// core/index2d.py mst_count_prefix, and of mst_weighted_prefix over the
// per-block inclusive prefix sums or prefix maxima) walks the levels of
// ylv and wacc, (levels, n) row-major, level l holding y sorted within
// blocks of 2^l.  The plain version walks every level, high to low, and
// takes block [pos, pos + 2^l) at level l when it fits in [0, i); that is
// exactly when bit l of i is set, and pos is then i with bits l and below
// cleared: the levels taken and their blocks are known from i alone.
// mst_prefix_bits searches only those blocks, so an untaken level costs no
// probe (at cap 4,096 a corner's 91 tree probes become l + 1 for each set
// bit l: 34 on average for OSM-like rectangles over a 3,072-point log).
// Any exact search of a sorted block counts the same y values <= v, so
// each block is searched by a branch-free power-of-two search: l halving
// rounds, then one compare.  The count mode sums the block counts
// (integers, any order).  The weighted modes read wacc[l][pos + lo - 1]
// for the taken levels with lo > 0 and fold it in descending level order,
// as the plain version does; the plain version folds the identity for
// every other level, and that is an exact no-op:
//  * kSum adds +0.0: the total starts at +0.0, and under round-to-nearest
//    a sum is -0.0 only when both addends are, so the total is never -0.0,
//    and x + (+0.0) == x for every other x, NaN and inf included.
//  * kMax folds jmax(total, -inf): the total starts at -inf; for a total
//    that is not NaN, jmax returns the total where it is above -inf and
//    -inf (the second operand, the same bits) where it is -inf; a NaN
//    total stays NaN (its payload may change, and the tests compare NaN
//    lanes as NaN).
// So the walk equals the plain version bit for bit (kMax up to a NaN's
// payload).

// *a when p, else 0.0: a predicated read-only load that issues no memory
// access when p is false
__device__ __forceinline__ double ldg_if(bool p, const double* a) {
  double v = 0.0;
  asm("{\n\t.reg .pred q;\n\t"
      "setp.ne.b32 q, %2, 0;\n\t"
      "@q ld.global.nc.f64 %0, [%1];\n\t}"
      : "+d"(v)
      : "l"(a), "r"((int)p));
  return v;
}

template <MstMode M>
using MstTotal = std::conditional_t<M == MstMode::kCount, int, double>;

// The count (kCount), sum (kSum) or max (kMax) over x-rank [0, i) with
// y <= v[k] for NY y values that share i, G taken levels at a time: the
// next G set bits of i, high to low, form a group whose G x NY block
// searches run in lockstep, each round issuing the group's loads before
// its compares, so a thread keeps G x NY loads in flight on a few
// registers.  A group runs the halving rounds of its largest level (the
// others' loads are predicated off once theirs are done), then the last
// compare of every search.  The weighted modes fold each group in
// descending level order, so the whole fold is in the plain version's
// order.  Any number of levels.
template <MstMode M, int NY, int G>
__device__ __forceinline__ void mst_prefix_bits(
    const double* __restrict__ ylv, const double* __restrict__ wacc, int n,
    int i, const double (&v)[NY], MstTotal<M> (&total)[NY]) {
#pragma unroll
  for (int k = 0; k < NY; ++k) {
    if constexpr (M == MstMode::kMax) {
      total[k] = -INFINITY;
    } else {
      total[k] = 0;
    }
  }
  unsigned rest = (unsigned)i;
  while (rest) {
    bool on[G];
    int lv[G], c[G][NY];
    const double* blk[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      on[g] = rest != 0u;
      lv[g] = on[g] ? 31 - __clz(rest) : 0;
      rest &= on[g] ? ~(1u << lv[g]) : ~0u;
      const unsigned pos = (unsigned)i & ~((2u << lv[g]) - 1u);
      blk[g] = ylv + (size_t)lv[g] * n + pos;
#pragma unroll
      for (int k = 0; k < NY; ++k) c[g][k] = 0;
    }
    double y[G][NY];
    for (int r = 0; r < lv[0]; ++r) {
      int half[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        half[g] = on[g] && r < lv[g] ? 1 << (lv[g] - 1 - r) : 0;
#pragma unroll
        for (int k = 0; k < NY; ++k)
          y[g][k] = ldg_if(half[g] != 0, blk[g] + c[g][k] + half[g] - 1);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int k = 0; k < NY; ++k)
          c[g][k] += y[g][k] <= v[k] ? half[g] : 0;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int k = 0; k < NY; ++k) y[g][k] = ldg_if(on[g], blk[g] + c[g][k]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int k = 0; k < NY; ++k) {
        c[g][k] += on[g] && y[g][k] <= v[k] ? 1 : 0;
        if constexpr (M == MstMode::kCount) total[k] += c[g][k];
      }
    }
    if constexpr (M != MstMode::kCount) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int k = 0; k < NY; ++k)
          y[g][k] = ldg_if(c[g][k] > 0, wacc + (blk[g] - ylv) + c[g][k] - 1);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int k = 0; k < NY; ++k) {
          if constexpr (M == MstMode::kSum) {
            total[k] = c[g][k] > 0 ? total[k] + y[g][k] : total[k];
          } else {
            total[k] = c[g][k] > 0 ? jmax(total[k], y[g][k]) : total[k];
          }
        }
      }
    }
  }
}

}  // namespace polyfit
