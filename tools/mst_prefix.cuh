// The merge-sort-tree walk over every level, as K9, K10 and K11 ran it
// before the set-bits walk (locate.cuh mst_prefix_bits) replaced it: kept
// for the tools that time the old kernels beside the shipped ones
// (tools/mst_rates.cu, tools/k11_rates.cu).
#pragma once

#include "../src/repro_torch/csrc/locate.cuh"

namespace polyfit {

// The merge-sort-tree reduction over x-rank [0, i) with y <= v: the twin
// of core/index2d.py mst_count_prefix (kCount, an int count) and
// mst_weighted_prefix (kSum over the per-block inclusive prefix sums, kMax
// over the prefix maxima; identities 0 and -inf).  ylv and wacc are
// (levels, n) row-major; level l holds y sorted within blocks of 2^l.
// Levels descend; block [pos, pos + 2^l) is taken when it fits in [0, i),
// and an (l + 1)-round binary search counts its y values <= v, every probe
// clamped as the plain version clamps it.  The weighted modes read one
// more entry a level, wacc[l][clip(pos + lo - 1, 0, n - 1)], masked to the
// identity unless the block was taken and lo > 0, and fold it in level
// order (jmax for NaN parity).  wacc is not read in kCount.
template <MstMode M>
__device__ __forceinline__
    std::conditional_t<M == MstMode::kCount, int, double>
    mst_prefix(const double* __restrict__ ylv, const double* __restrict__ wacc,
               int n, int levels, int i, double v) {
  std::conditional_t<M == MstMode::kCount, int, double> total;
  if constexpr (M == MstMode::kMax) {
    total = -INFINITY;
  } else {
    total = 0;
  }
  int pos = 0;
  for (int l = levels - 1; l >= 0; --l) {
    const int b = 1 << l;
    const bool take = pos + b <= i;
    const size_t row = (size_t)l * (size_t)n;
    int lo = 0;
    int hi = b;
    for (int r = 0; r <= l; ++r) {
      const bool active = lo < hi;
      const int mid = (lo + hi) / 2;
      int idx = pos + (mid < b - 1 ? mid : b - 1);
      idx = idx < 0 ? 0 : (idx < n - 1 ? idx : n - 1);
      const bool go_right = active && ylv[row + idx] <= v;
      lo = go_right ? mid + 1 : lo;
      hi = (active && !go_right) ? mid : hi;
    }
    if constexpr (M == MstMode::kCount) {
      total = total + (take ? lo : 0);
    } else {
      int j = pos + lo - 1;
      j = j < 0 ? 0 : (j < n - 1 ? j : n - 1);
      const bool hit = take && lo > 0;
      if constexpr (M == MstMode::kSum) {
        total = total + (hit ? wacc[row + j] : 0.0);
      } else {
        total = jmax(total, hit ? wacc[row + j] : -INFINITY);
      }
    }
    pos = take ? pos + b : pos;
  }
  return total;
}

}  // namespace polyfit
