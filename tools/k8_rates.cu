// K8 (corner_eval2d_gather, csrc/leaf_eval2d.cu) before and after its
// redesign, and the shapes the redesign was chosen from, on the card:
//
//   k8_old      K8 before: one thread a corner, three binary searches
//               (leaf2d_locate.cuh locate_leaf2d: x cut, y cut, leaf code)
//               and a row of 8-byte loads (leaf_value);
//   shipped     K8 as leaf_eval2d.cu launches it (included below): two
//               threads a corner, one a coordinate's rank, both searching
//               the leaf code, the row split between them
//               (leaf_value_pair);
//   k8_variant  the steps of the redesign in other shapes: TPC threads a
//               corner (1: one thread ranks both coordinates; 2: lane e
//               ranks coordinate e); FORM at two threads (0: lane 0 alone
//               searches the code and evaluates the row by 16-byte loads,
//               leaf_value_v16; 1: both search and split the row,
//               leaf_value_pair); LOCK at one thread, both checked guesses
//               issued before either check is decided (cut_ranks_lockstep;
//               else two cut_rank_guess calls); TREE, the leaf code found
//               by a descent of a search tree over the codes (K1's,
//               kernels/locate.py search_tree over the codes as float64,
//               locate.cuh tree_count_right) in place of the binary
//               search; PART, the steps kept (0: the two ranks alone, 1:
//               and the code search, 2: and the row, the whole kernel).
//
// Built and timed by tools/k5_k8_rates.py, which holds each whole kernel to
// the plain version (kernels/leaf_eval2d.py corner_eval2d_gather_plain).
#include "../src/repro_torch/csrc/leaf_eval2d.cu"
#include "leaf2d_locate.cuh"

namespace {

using polyfit::bsearch_count_right;
using polyfit::cut_rank_guess;
using polyfit::leaf_value;
using polyfit::leaf_value_pair;
using polyfit::leaf_value_v16;
using polyfit::morton2;
using polyfit::tree_count_right;
using polyfit::TreeShape;

constexpr int kBlock = 256;
constexpr unsigned kAll = 0xffffffffu;

using Kernel = void (*)(const double*, const double*, const double*,
                        const double*, const int32_t*, const double*,
                        const double*, TreeShape, const double*,
                        const double*, double*, int, int, int, int, int);

// K8 before its redesign
template <int DEG>
__global__ void __launch_bounds__(kBlock)
    k8_old(const double* __restrict__ u, const double* __restrict__ v,
           const double* __restrict__ xcuts, const double* __restrict__ ycuts,
           const int32_t* __restrict__ leaf_z, const double* __restrict__,
           const double* __restrict__, TreeShape,
           const double* __restrict__ bounds,
           const double* __restrict__ coeffs, double* __restrict__ out, int Q,
           int nx, int ny, int L, int depth) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  const double qx = u[i], qy = v[i];
  const int leaf = polyfit::locate_leaf2d(qx, qy, xcuts, nx, ycuts, ny,
                                          leaf_z, L, depth);
  out[i] = leaf_value<DEG>(qx, qy, leaf, true, bounds, coeffs);
}

// cut_rank_guess of an x and a y value in lockstep: both guesses, then
// each round's four neighbouring cuts loaded before either check is
// decided; a value still unchecked after three rounds (or on a grid of two
// cuts or fewer) takes the binary search, as cut_rank_guess does
__device__ __forceinline__ void cut_ranks_lockstep(
    const double* __restrict__ xc, int nx, double qx,
    const double* __restrict__ yc, int ny, double qy, int& rx, int& ry) {
  const double* c[2] = {xc, yc};
  const int n[2] = {nx, ny};
  const double q[2] = {qx, qy};
  int g[2], r[2];
  bool done[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const double c0 = c[k][0];
    const double t = (q[k] - c0) * ((double)(n[k] - 1) / (c[k][n[k] - 1] - c0));
    g[k] = t >= 0.0 ? (t < (double)(n[k] - 1) ? (int)t + 1 : n[k]) : 0;
    done[k] = n[k] <= 2;
    r[k] = -1;
  }
#pragma unroll
  for (int check = 0; check < 3; ++check) {
    if (done[0] && done[1]) break;
    double lo[2], hi[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      lo[k] = c[k][g[k] > 0 ? g[k] - 1 : 0];
      hi[k] = c[k][g[k] < n[k] - 1 ? g[k] : n[k] - 1];
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (done[k]) continue;
      const bool lo_ok = g[k] == 0 || lo[k] <= q[k];
      const bool hi_ok = g[k] == n[k] || q[k] < hi[k];
      if (lo_ok && hi_ok) {
        r[k] = g[k];
        done[k] = true;
      } else {
        g[k] += lo_ok ? 1 : -1;
      }
    }
  }
  rx = r[0] >= 0 ? r[0] : bsearch_count_right(xc, nx, qx);
  ry = r[1] >= 0 ? r[1] : bsearch_count_right(yc, ny, qy);
}

template <bool TREE>
__device__ __forceinline__ int leaf_of(const int32_t* __restrict__ leaf_z,
                                       const double* __restrict__ codes,
                                       const double* __restrict__ tree,
                                       const TreeShape& shape, int L,
                                       int32_t z) {
  int c;
  if constexpr (TREE) {
    c = tree_count_right(codes, L, tree, shape, (double)z) - 1;
  } else {
    c = bsearch_count_right(leaf_z, L, z) - 1;
  }
  return c > 0 ? c : 0;
}

template <int DEG, int TPC, int FORM, bool LOCK, bool TREE, int PART>
__global__ void __launch_bounds__(kBlock)
    k8_variant(const double* __restrict__ u, const double* __restrict__ v,
               const double* __restrict__ xcuts,
               const double* __restrict__ ycuts,
               const int32_t* __restrict__ leaf_z,
               const double* __restrict__ codes,
               const double* __restrict__ tree, TreeShape shape,
               const double* __restrict__ bounds,
               const double* __restrict__ coeffs, double* __restrict__ out,
               int Q, int nx, int ny, int L, int depth) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (TPC == 1) {
    if (t >= Q) return;
    const int i = (int)t;
    const double qx = u[i], qy = v[i];
    int rx, ry;
    if constexpr (LOCK) {
      cut_ranks_lockstep(xcuts, nx, qx, ycuts, ny, qy, rx, ry);
    } else {
      rx = cut_rank_guess(xcuts, nx, qx);
      ry = cut_rank_guess(ycuts, ny, qy);
    }
    if constexpr (PART == 0) {
      out[i] = (double)rx * 65536.0 + (double)ry;
      return;
    }
    const int leaf = leaf_of<TREE>(leaf_z, codes, tree, shape, L,
                                   morton2(rx, ry, depth));
    if constexpr (PART == 1) {
      out[i] = (double)leaf;
      return;
    }
    out[i] = leaf_value_v16<DEG>(qx, qy, leaf, bounds, coeffs);
  } else {
    const int e = threadIdx.x & 1;
    const int q = t / 2 < Q ? (int)(t / 2) : Q - 1;
    const bool writes = e == 0 && t / 2 < Q;
    const double val = (e ? v : u)[q];
    const int rank = cut_rank_guess(e ? ycuts : xcuts, e ? ny : nx, val);
    const double qx = __shfl_sync(kAll, val, 0, 2);
    const double qy = __shfl_sync(kAll, val, 1, 2);
    const int rx = __shfl_sync(kAll, rank, 0, 2);
    const int ry = __shfl_sync(kAll, rank, 1, 2);
    if constexpr (PART == 0) {
      if (writes) out[q] = (double)rx * 65536.0 + (double)ry;
      return;
    }
    const int32_t z = morton2(rx, ry, depth);
    if constexpr (FORM == 0) {
      if (e) return;
      const int leaf = leaf_of<TREE>(leaf_z, codes, tree, shape, L, z);
      if constexpr (PART == 1) {
        if (writes) out[q] = (double)leaf;
        return;
      }
      const double a = leaf_value_v16<DEG>(qx, qy, leaf, bounds, coeffs);
      if (writes) out[q] = a;
    } else {
      const int leaf = leaf_of<TREE>(leaf_z, codes, tree, shape, L, z);
      if constexpr (PART == 1) {
        if (writes) out[q] = (double)leaf;
        return;
      }
      const double a = leaf_value_pair<DEG>(qx, qy, leaf, e, bounds, coeffs);
      if (writes) out[q] = a;
    }
  }
}

struct Variant {
  Kernel kernel;
  int tpc;
};

// tools/k5_k8_rates.py K8_VARIANTS, in this order; the shipped launcher is
// number kCount
#define K8_TABLE(D)                                                 \
  {                                                                 \
    {k8_old<D>, 1},                                                 \
    {k8_variant<D, 1, 0, false, false, 2>, 1},                      \
    {k8_variant<D, 1, 0, true, false, 2>, 1},                       \
    {k8_variant<D, 2, 0, false, false, 2>, 2},                      \
    {k8_variant<D, 2, 1, false, false, 2>, 2},                      \
    {k8_variant<D, 1, 0, true, true, 2>, 1},                        \
    {k8_variant<D, 2, 0, false, true, 2>, 2},                       \
    {k8_variant<D, 2, 1, false, true, 2>, 2},                       \
    {k8_variant<D, 1, 0, true, false, 0>, 1},                       \
    {k8_variant<D, 1, 0, true, false, 1>, 1},                       \
    {k8_variant<D, 2, 1, false, false, 0>, 2},                      \
    {k8_variant<D, 2, 1, false, false, 1>, 2},                      \
  }
const Variant kDeg2[] = K8_TABLE(2);
const Variant kDeg3[] = K8_TABLE(3);
#undef K8_TABLE
constexpr int kCount = sizeof(kDeg3) / sizeof(kDeg3[0]);

}  // namespace

// variant 0 .. kCount - 1 at deg 2 or 3, kCount the shipped launcher;
// ``codes`` the leaf codes as float64 and ``tree`` their search tree (the
// TREE variants read them)
extern "C" int k8_run(int which, int deg, const void* u, const void* v,
                      const void* xcuts, const void* ycuts,
                      const void* leaf_z, const void* codes,
                      const void* tree, const void* bounds,
                      const void* coeffs, void* out, int Q, int nx, int ny,
                      int L, int depth, void* stream) {
  if (which == kCount)
    return polyfit_corner_eval2d_gather(u, v, xcuts, ycuts, leaf_z, bounds,
                                        coeffs, out, Q, nx, ny, L, deg, depth,
                                        stream);
  if (which < 0 || which > kCount || (deg != 2 && deg != 3))
    return (int)cudaErrorInvalidValue;
  const Variant& var = (deg == 2 ? kDeg2 : kDeg3)[which];
  const long long threads = (long long)Q * var.tpc;
  const int blocks = (int)((threads + kBlock - 1) / kBlock);
  var.kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      (const double*)u, (const double*)v, (const double*)xcuts,
      (const double*)ycuts, (const int32_t*)leaf_z, (const double*)codes,
      (const double*)tree, polyfit::tree_shape(L), (const double*)bounds,
      (const double*)coeffs, (double*)out, Q, nx, ny, L, depth);
  return (int)cudaGetLastError();
}

extern "C" int k8_variants() { return kCount; }
