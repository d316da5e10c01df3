// The 2-D corner locate that K7 and K8 ran before their redesigns (three
// binary searches and a Morton code built a bit at a time), which
// locate.cuh cut_rank_guess and morton2 replaced: kept for the tools that
// time the old kernels beside the shipped ones (tools/k7_rates.cu,
// tools/k8_rates.cu).
#pragma once

#include "../src/repro_torch/csrc/locate.cuh"

namespace polyfit {

// Morton (Z-order) code of cell (ix, iy) at depth bits per axis, a loop a
// bit
__device__ __forceinline__ int32_t interleave2(int32_t ix, int32_t iy,
                                               int depth) {
  int32_t z = 0;
  for (int b = 0; b < depth; ++b)
    z = z | (((ix >> b) & 1) << (2 * b)) | (((iy >> b) & 1) << (2 * b + 1));
  return z;
}

// Row of the z-sorted leaf table holding corner (qx, qy): cell x = #xcuts
// <= qx, cell y = #ycuts <= qy (a corner on a split line lands in the
// higher cell), then max(#leaf_z <= z - 1, 0) over the int32 codes,
// padded with INT_SENTINEL
__device__ __forceinline__ int locate_leaf2d(
    double qx, double qy, const double* __restrict__ xcuts, int nx,
    const double* __restrict__ ycuts, int ny,
    const int32_t* __restrict__ leaf_z, int L, int depth) {
  const int32_t ix = bsearch_count_right(xcuts, nx, qx);
  const int32_t iy = bsearch_count_right(ycuts, ny, qy);
  const int c = bsearch_count_right(leaf_z, L, interleave2(ix, iy, depth)) - 1;
  return c > 0 ? c : 0;
}

}  // namespace polyfit
