// PolyFit two-key whole-log scan kernels for Hopper (sm_90a), float64, one
// thread per query: the buffered two-key corrections of the 'cuda_scan'
// backend.
//
// K18 delta_count2d_kernel   replaces repro/kernels/delta_scan.py:delta_count2d_pallas
// K19 delta_sum2d_kernel     replaces repro/kernels/delta_scan.py:delta_sum2d_pallas
// K20 delta_dommax2d_kernel  replaces repro/kernels/delta_scan.py:delta_dommax2d_pallas
//
// Twins of the plain versions in repro_torch/kernels/delta_scan.py.  Where
// K9-K11 (delta2d.cu) walk the log's merge-sort tree, these test every
// query against every slot of the x-sorted, sentinel-padded point log:
//
//   K18  the number of logged points with lx < x <= ux and ly < y <= uy,
//        counted in float64 (exact below 2^53 slots);
//   K19  the sum of their measures, added in slot order (the plain version
//        adds in the same order, so the two agree bit for bit);
//   K20  the max measure of the logged points with x <= u and y <= v, -inf
//        when none is dominated; jmax keeps a NaN measure, as the
//        reference's jnp.max does.
//
// Sentinel slots hold the sentinel in both coordinates and measure 0, so
// they fail every membership test.  The reference sums a one-hot matmul
// over tiles of 512 slots; a count and a max are exact in any order, and
// the sum of K19 is held to the plain version in slot order.
//
// What bounds them on an H100: operations.  A block of 256 queries walks
// the log in tiles of 256 slots staged through shared memory (the log read
// once a block from L2), and each thread tests its query against every
// slot: 4 compares and an add (K18, K19) or 2 compares and a max (K20) a
// (query, slot) pair.  At Q = 65,536 against a 4,096-slot log that is
// about 1.3e9 f64 operations for K18, about 0.04 ms at the FP64 peak; the
// bytes (the queries, the log once and the answers) about 2.7 MB, under a
// microsecond.  What the design does about it: nothing more yet; the
// tile's slots are broadcast from shared memory, one compare-and-select
// chain a thread.
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
constexpr int kTile = kThreads;   // log slots staged per tile

// K18 (WEIGHTED false): count of the logged points in (lx, ux] x (ly, uy];
// K19 (WEIGHTED true): the sum of their measures ``w``, in slot order
template <bool WEIGHTED>
__global__ void delta_rect2d_kernel(const double* __restrict__ lx,
                                    const double* __restrict__ ux,
                                    const double* __restrict__ ly,
                                    const double* __restrict__ uy,
                                    const double* __restrict__ kx,
                                    const double* __restrict__ ky,
                                    const double* __restrict__ w,
                                    double* __restrict__ out, int Q, int D) {
  __shared__ double s_x[kTile], s_y[kTile], s_w[WEIGHTED ? kTile : 1];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = i < Q ? i : Q - 1;   // threads past Q still stage tiles
  const double x0 = lx[r], x1 = ux[r], y0 = ly[r], y1 = uy[r];
  double acc = 0.0;
  for (int t0 = 0; t0 < D; t0 += kTile) {
    const int j = t0 + threadIdx.x;
    if (j < D) {
      s_x[threadIdx.x] = kx[j];
      s_y[threadIdx.x] = ky[j];
      if (WEIGHTED) s_w[threadIdx.x] = w[j];
    }
    __syncthreads();
    const int n = D - t0 < kTile ? D - t0 : kTile;
    for (int k = 0; k < n; ++k) {
      const double x = s_x[k], y = s_y[k];
      const bool in = x0 < x && x <= x1 && y0 < y && y <= y1;
      acc = acc + (in ? (WEIGHTED ? s_w[k] : 1.0) : 0.0);
    }
    __syncthreads();
  }
  if (i < Q) out[i] = acc;
}

// K20: max of the measures of the logged points with x <= u, y <= v;
// -inf when none is dominated
__global__ void delta_dommax2d_kernel(const double* __restrict__ u,
                                      const double* __restrict__ v,
                                      const double* __restrict__ kx,
                                      const double* __restrict__ ky,
                                      const double* __restrict__ w,
                                      double* __restrict__ out, int Q, int D) {
  __shared__ double s_x[kTile], s_y[kTile], s_w[kTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = i < Q ? i : Q - 1;
  const double qu = u[r], qv = v[r];
  double acc = -INFINITY;
  for (int t0 = 0; t0 < D; t0 += kTile) {
    const int j = t0 + threadIdx.x;
    if (j < D) {
      s_x[threadIdx.x] = kx[j];
      s_y[threadIdx.x] = ky[j];
      s_w[threadIdx.x] = w[j];
    }
    __syncthreads();
    const int n = D - t0 < kTile ? D - t0 : kTile;
    for (int k = 0; k < n; ++k) {
      const bool in = s_x[k] <= qu && s_y[k] <= qv;
      acc = jmax(acc, in ? s_w[k] : -INFINITY);
    }
    __syncthreads();
  }
  if (i < Q) out[i] = acc;
}

inline int blocks_for(int Q) { return (Q + kThreads - 1) / kThreads; }

}  // namespace
}  // namespace polyfit

extern "C" {

int polyfit_delta_count2d(const void* lx, const void* ux, const void* ly,
                          const void* uy, const void* kx, const void* ky,
                          void* out, int Q, int D, void* stream) {
  if (Q > 0)
    polyfit::delta_rect2d_kernel<false><<<polyfit::blocks_for(Q),
                                          polyfit::kThreads, 0,
                                          (cudaStream_t)stream>>>(
        (const double*)lx, (const double*)ux, (const double*)ly,
        (const double*)uy, (const double*)kx, (const double*)ky, nullptr,
        (double*)out, Q, D);
  return (int)cudaGetLastError();
}

int polyfit_delta_sum2d(const void* lx, const void* ux, const void* ly,
                        const void* uy, const void* kx, const void* ky,
                        const void* w, void* out, int Q, int D, void* stream) {
  if (Q > 0)
    polyfit::delta_rect2d_kernel<true><<<polyfit::blocks_for(Q),
                                         polyfit::kThreads, 0,
                                         (cudaStream_t)stream>>>(
        (const double*)lx, (const double*)ux, (const double*)ly,
        (const double*)uy, (const double*)kx, (const double*)ky,
        (const double*)w, (double*)out, Q, D);
  return (int)cudaGetLastError();
}

int polyfit_delta_dommax2d(const void* u, const void* v, const void* kx,
                           const void* ky, const void* w, void* out, int Q,
                           int D, void* stream) {
  if (Q > 0)
    polyfit::delta_dommax2d_kernel<<<polyfit::blocks_for(Q),
                                     polyfit::kThreads, 0,
                                     (cudaStream_t)stream>>>(
        (const double*)u, (const double*)v, (const double*)kx,
        (const double*)ky, (const double*)w, (double*)out, Q, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
