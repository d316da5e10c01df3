// PolyFit two-key leaf evaluation for Hopper (sm_90a), float64.
//
// K7  corner_count2d_gather_kernel  replaces repro/kernels/leaf_eval2d.py:corner_count2d_gather_pallas
// K8  corner_eval2d_gather_kernel   replaces repro/kernels/leaf_eval2d.py:corner_eval2d_gather_pallas
// K12 corner_count2d_kernel         replaces repro/kernels/leaf_eval2d.py:corner_count2d_pallas
// K13 corner_eval2d_kernel          replaces repro/kernels/leaf_eval2d.py:corner_eval2d_pallas
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
// Gather (K7, K8), one thread per query: a corner's leaf is three
// branch-free binary searches (locate.cuh locate_leaf2d: the x cut, the y
// cut, the int32 Morton code in the z-sorted table), then one row.
//
// Scan (K12, K13), the path of plans deeper than 15 levels (no int32 Morton
// codes): a block of 256 queries walks the flat leaf table in tiles of 256
// leaves staged through shared memory (the four membership bounds, 8 KB);
// each thread tests mx0 <= qx < mx1 and my0 <= qy < my1 for each of its
// corners and keeps the first leaf that holds it.  Leaves partition the
// root, so that row is the one the reference's one-hot matmul sums up
// (its other terms are 0 * x with x finite), and no leaf gives a zero row.
//
// What bounds them on an H100.  K7 at Q = 65,536 and about 4,000 leaves
// must move 5 x 8 B a query plus the table (cut grids, codes, bounds and
// 16 coefficients a leaf) once, about 3 MB: about 1 us at 3.35 TB/s; its
// four corners take 3 binary searches each (16 + 16 + 13 dependent loads,
// L1/L2 hits) and about 50 f64 operations of Horner and scaling.  K12 on
// the same table must move the same bytes but compares every corner with
// every leaf: 65,536 x 4 x 4,096 x 4 compares, about 4.3 G f64 operations,
// about 0.13 ms at the FP64 peak, so operations bound it.  What the design
// does about it: nothing yet; one thread per query, the gather tables read
// through L1/L2, the scan's tile broadcast from shared memory.
//
// Each launcher takes raw device pointers and the CUDA stream, launches on
// that stream, and returns cudaGetLastError() (0 when the launch was
// taken); a degree above kMaxDeg2d returns cudaErrorInvalidValue.

#include <cuda_runtime.h>
#include <stdint.h>

#include "locate.cuh"

namespace polyfit {
namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads;   // leaves staged per shared-memory tile
// kernels/leaf_eval2d.py MAX_DEG_2D: one instantiation per degree
constexpr int kMaxDeg2d = 5;

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
  const double span_x = b[1] > b[0] ? b[1] - b[0] : 1.0;
  const double span_y = b[3] > b[2] ? b[3] - b[2] : 1.0;
  const double us = jclip((2.0 * qx - b[0] - b[1]) / span_x, -1.0, 1.0);
  const double vs = jclip((2.0 * qy - b[2] - b[3]) / span_y, -1.0, 1.0);
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

// K7: 4-corner COUNT/SUM over (lx, ux] x (ly, uy], located by binary search
template <int DEG>
__global__ void corner_count2d_gather_kernel(
    const double* __restrict__ lx, const double* __restrict__ ux,
    const double* __restrict__ ly, const double* __restrict__ uy,
    const double* __restrict__ xcuts, const double* __restrict__ ycuts,
    const int32_t* __restrict__ leaf_z, const double* __restrict__ bounds,
    const double* __restrict__ coeffs, double* __restrict__ out, int Q,
    int nx, int ny, int L, int depth) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  const double qx[4] = {ux[i], lx[i], ux[i], lx[i]};
  const double qy[4] = {uy[i], uy[i], ly[i], ly[i]};
  double v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int leaf = locate_leaf2d(qx[e], qy[e], xcuts, nx, ycuts, ny,
                                   leaf_z, L, depth);
    v[e] = leaf_value<DEG>(qx[e], qy[e], leaf, true, bounds, coeffs);
  }
  out[i] = v[0] - v[1] - v[2] + v[3];
}

// K8: single-corner P_leaf(u, v), located by binary search
template <int DEG>
__global__ void corner_eval2d_gather_kernel(
    const double* __restrict__ u, const double* __restrict__ v,
    const double* __restrict__ xcuts, const double* __restrict__ ycuts,
    const int32_t* __restrict__ leaf_z, const double* __restrict__ bounds,
    const double* __restrict__ coeffs, double* __restrict__ out, int Q,
    int nx, int ny, int L, int depth) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  const double qx = u[i], qy = v[i];
  const int leaf = locate_leaf2d(qx, qy, xcuts, nx, ycuts, ny, leaf_z, L,
                                 depth);
  out[i] = leaf_value<DEG>(qx, qy, leaf, true, bounds, coeffs);
}

// The first leaf whose membership box holds each of a thread's NC corners
// (-1 when none does): the block walks the table tile by tile, every
// thread of the block loading one leaf's bounds into shared memory.
template <int NC>
__device__ __forceinline__ void scan_leaves(
    const double (&qx)[NC], const double (&qy)[NC],
    const double* __restrict__ mx0, const double* __restrict__ mx1,
    const double* __restrict__ my0, const double* __restrict__ my1, int L,
    int (&hit)[NC]) {
  __shared__ double s_mx0[kTile], s_mx1[kTile], s_my0[kTile], s_my1[kTile];
#pragma unroll
  for (int e = 0; e < NC; ++e) hit[e] = -1;
  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int j = t0 + threadIdx.x;
    if (j < L) {
      s_mx0[threadIdx.x] = mx0[j];
      s_mx1[threadIdx.x] = mx1[j];
      s_my0[threadIdx.x] = my0[j];
      s_my1[threadIdx.x] = my1[j];
    }
    __syncthreads();
    const int n = L - t0 < kTile ? L - t0 : kTile;
    for (int k = 0; k < n; ++k) {
      const double a0 = s_mx0[k], a1 = s_mx1[k], c0 = s_my0[k], c1 = s_my1[k];
#pragma unroll
      for (int e = 0; e < NC; ++e) {
        const bool in = a0 <= qx[e] && qx[e] < a1 && c0 <= qy[e] && qy[e] < c1;
        hit[e] = (hit[e] < 0 && in) ? t0 + k : hit[e];
      }
    }
    __syncthreads();
  }
}

// K12: 4-corner COUNT/SUM by one-hot membership over the flat leaf table
template <int DEG>
__global__ void corner_count2d_kernel(
    const double* __restrict__ lx, const double* __restrict__ ux,
    const double* __restrict__ ly, const double* __restrict__ uy,
    const double* __restrict__ mx0, const double* __restrict__ mx1,
    const double* __restrict__ my0, const double* __restrict__ my1,
    const double* __restrict__ bounds, const double* __restrict__ coeffs,
    double* __restrict__ out, int Q, int L) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = i < Q ? i : Q - 1;   // threads past Q still stage tiles
  const double qx[4] = {ux[r], lx[r], ux[r], lx[r]};
  const double qy[4] = {uy[r], uy[r], ly[r], ly[r]};
  int hit[4];
  scan_leaves<4>(qx, qy, mx0, mx1, my0, my1, L, hit);
  if (i >= Q) return;
  double v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = leaf_value<DEG>(qx[e], qy[e], hit[e], hit[e] >= 0, bounds, coeffs);
  out[i] = v[0] - v[1] - v[2] + v[3];
}

// K13: single-corner evaluation by one-hot membership
template <int DEG>
__global__ void corner_eval2d_kernel(
    const double* __restrict__ u, const double* __restrict__ v,
    const double* __restrict__ mx0, const double* __restrict__ mx1,
    const double* __restrict__ my0, const double* __restrict__ my1,
    const double* __restrict__ bounds, const double* __restrict__ coeffs,
    double* __restrict__ out, int Q, int L) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = i < Q ? i : Q - 1;
  const double qx[1] = {u[r]};
  const double qy[1] = {v[r]};
  int hit[1];
  scan_leaves<1>(qx, qy, mx0, mx1, my0, my1, L, hit);
  if (i >= Q) return;
  out[i] = leaf_value<DEG>(qx[0], qy[0], hit[0], hit[0] >= 0, bounds, coeffs);
}

inline int blocks_for(int Q) { return (Q + kThreads - 1) / kThreads; }

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
#define K7_LAUNCH(D)                                                         \
  polyfit::corner_count2d_gather_kernel<D>                                   \
      <<<polyfit::blocks_for(Q), polyfit::kThreads, 0,                       \
         (cudaStream_t)stream>>>(                                            \
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
#define K8_LAUNCH(D)                                                         \
  polyfit::corner_eval2d_gather_kernel<D>                                    \
      <<<polyfit::blocks_for(Q), polyfit::kThreads, 0,                       \
         (cudaStream_t)stream>>>(                                            \
          (const double*)u, (const double*)v, (const double*)xcuts,          \
          (const double*)ycuts, (const int32_t*)leaf_z,                      \
          (const double*)bounds, (const double*)coeffs, (double*)out, Q, nx, \
          ny, L, depth)
  POLYFIT_2D_DISPATCH(deg, K8_LAUNCH)
#undef K8_LAUNCH
  return (int)cudaGetLastError();
}

int polyfit_corner_count2d(const void* lx, const void* ux, const void* ly,
                           const void* uy, const void* mx0, const void* mx1,
                           const void* my0, const void* my1,
                           const void* bounds, const void* coeffs, void* out,
                           int Q, int L, int deg, void* stream) {
  if (Q <= 0) return (int)cudaGetLastError();
#define K12_LAUNCH(D)                                                        \
  polyfit::corner_count2d_kernel<D>                                          \
      <<<polyfit::blocks_for(Q), polyfit::kThreads, 0,                       \
         (cudaStream_t)stream>>>(                                            \
          (const double*)lx, (const double*)ux, (const double*)ly,           \
          (const double*)uy, (const double*)mx0, (const double*)mx1,         \
          (const double*)my0, (const double*)my1, (const double*)bounds,     \
          (const double*)coeffs, (double*)out, Q, L)
  POLYFIT_2D_DISPATCH(deg, K12_LAUNCH)
#undef K12_LAUNCH
  return (int)cudaGetLastError();
}

int polyfit_corner_eval2d(const void* u, const void* v, const void* mx0,
                          const void* mx1, const void* my0, const void* my1,
                          const void* bounds, const void* coeffs, void* out,
                          int Q, int L, int deg, void* stream) {
  if (Q <= 0) return (int)cudaGetLastError();
#define K13_LAUNCH(D)                                                        \
  polyfit::corner_eval2d_kernel<D>                                           \
      <<<polyfit::blocks_for(Q), polyfit::kThreads, 0,                       \
         (cudaStream_t)stream>>>(                                            \
          (const double*)u, (const double*)v, (const double*)mx0,            \
          (const double*)mx1, (const double*)my0, (const double*)my1,        \
          (const double*)bounds, (const double*)coeffs, (double*)out, Q, L)
  POLYFIT_2D_DISPATCH(deg, K13_LAUNCH)
#undef K13_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
