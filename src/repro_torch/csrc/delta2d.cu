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
// (locate.cuh mst_prefix): at most one block a level, one binary search in
// each, so O(log^2 cap) dependent probes.
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
// adds wcum (0.43 MB), K11 reads two endpoints and wpmax instead.  Each
// corner walks 13 probes for the x-rank and 91 in the tree, dependent loads
// that hit L1/L2 (the log's structures are under 1 MB); K9 and K10 run four
// corners a query, K11 one.  So the byte bound is about 1 us and the
// dependent probe chains set the time.  What the design does about it:
// nothing yet; one thread per query, the four corners of K9/K10 in
// sequence so their chains can overlap only across threads, the tables read
// through L1/L2.  Staging the upper levels in shared memory is later work.
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

inline int blocks_for(int Q) { return (Q + kThreads - 1) / kThreads; }

// f64 dominance count #(kx <= x, y_j <= y) over the log (one K9 corner)
__device__ __forceinline__ double corner_count(const double* __restrict__ kx,
                                               const double* __restrict__ ylv,
                                               int cap, int levels, double x,
                                               double y) {
  const int i = bsearch_count_right(kx, cap, x);
  return (double)mst_prefix<MstMode::kCount>(ylv, nullptr, cap, levels, i, y);
}

// dominance sum of the logged measures (one K10 corner)
__device__ __forceinline__ double corner_sum(const double* __restrict__ kx,
                                             const double* __restrict__ ylv,
                                             const double* __restrict__ wcum,
                                             int cap, int levels, double x,
                                             double y) {
  const int i = bsearch_count_right(kx, cap, x);
  return mst_prefix<MstMode::kSum>(ylv, wcum, cap, levels, i, y);
}

// K9: buffered COUNT over (lx, ux] x (ly, uy]
__global__ void delta_count2d_gather_kernel(
    const double* __restrict__ lx, const double* __restrict__ ux,
    const double* __restrict__ ly, const double* __restrict__ uy,
    const double* __restrict__ kx, const double* __restrict__ ylv,
    double* __restrict__ out, int Q, int cap, int levels) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  const double a = corner_count(kx, ylv, cap, levels, ux[q], uy[q]);
  const double b = corner_count(kx, ylv, cap, levels, lx[q], uy[q]);
  const double c = corner_count(kx, ylv, cap, levels, ux[q], ly[q]);
  const double d = corner_count(kx, ylv, cap, levels, lx[q], ly[q]);
  out[q] = a - b - c + d;
}

// K10: buffered SUM of measures over (lx, ux] x (ly, uy]
__global__ void delta_sum2d_gather_kernel(
    const double* __restrict__ lx, const double* __restrict__ ux,
    const double* __restrict__ ly, const double* __restrict__ uy,
    const double* __restrict__ kx, const double* __restrict__ ylv,
    const double* __restrict__ wcum, double* __restrict__ out, int Q,
    int cap, int levels) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  const double a = corner_sum(kx, ylv, wcum, cap, levels, ux[q], uy[q]);
  const double b = corner_sum(kx, ylv, wcum, cap, levels, lx[q], uy[q]);
  const double c = corner_sum(kx, ylv, wcum, cap, levels, ux[q], ly[q]);
  const double d = corner_sum(kx, ylv, wcum, cap, levels, lx[q], ly[q]);
  out[q] = a - b - c + d;
}

// K11: buffered dominance MAX over {x <= u, y <= v}; -inf when empty
__global__ void delta_dommax2d_gather_kernel(
    const double* __restrict__ u, const double* __restrict__ v,
    const double* __restrict__ kx, const double* __restrict__ ylv,
    const double* __restrict__ wpmax, double* __restrict__ out, int Q,
    int cap, int levels) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  const int i = bsearch_count_right(kx, cap, u[q]);
  out[q] = mst_prefix<MstMode::kMax>(ylv, wpmax, cap, levels, i, v[q]);
}

}  // namespace
}  // namespace polyfit

extern "C" {

int polyfit_delta_count2d_gather(const void* lx, const void* ux,
                                 const void* ly, const void* uy,
                                 const void* kx, const void* ylv, void* out,
                                 int Q, int cap, int levels, void* stream) {
  if (Q > 0)
    polyfit::delta_count2d_gather_kernel<<<polyfit::blocks_for(Q),
                                           polyfit::kThreads, 0,
                                           (cudaStream_t)stream>>>(
        (const double*)lx, (const double*)ux, (const double*)ly,
        (const double*)uy, (const double*)kx, (const double*)ylv,
        (double*)out, Q, cap, levels);
  return (int)cudaGetLastError();
}

int polyfit_delta_sum2d_gather(const void* lx, const void* ux, const void* ly,
                               const void* uy, const void* kx,
                               const void* ylv, const void* wcum, void* out,
                               int Q, int cap, int levels, void* stream) {
  if (Q > 0)
    polyfit::delta_sum2d_gather_kernel<<<polyfit::blocks_for(Q),
                                         polyfit::kThreads, 0,
                                         (cudaStream_t)stream>>>(
        (const double*)lx, (const double*)ux, (const double*)ly,
        (const double*)uy, (const double*)kx, (const double*)ylv,
        (const double*)wcum, (double*)out, Q, cap, levels);
  return (int)cudaGetLastError();
}

int polyfit_delta_dommax2d_gather(const void* u, const void* v,
                                  const void* kx, const void* ylv,
                                  const void* wpmax, void* out, int Q,
                                  int cap, int levels, void* stream) {
  if (Q > 0)
    polyfit::delta_dommax2d_gather_kernel<<<polyfit::blocks_for(Q),
                                            polyfit::kThreads, 0,
                                            (cudaStream_t)stream>>>(
        (const double*)u, (const double*)v, (const double*)kx,
        (const double*)ylv, (const double*)wpmax, (double*)out, Q, cap,
        levels);
  return (int)cudaGetLastError();
}

}  // extern "C"
