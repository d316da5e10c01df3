// K19 (csrc/scan2d.cu delta_sum2d) on the card, before and after its
// redesign, and the rank form at other shapes:
//
//   k19_old   one thread a rectangle in blocks of 256, 256-slot tiles staged
//             by plain loads into three shared arrays, 4 compares and an add
//             on every (rectangle, slot) pair, every slot of the log (the
//             sentinel tail too);
//   shipped   K19 as scan2d.cu launches it (included below): each
//             rectangle's x range ranked to slots [a, b) by two binary
//             searches, the block's 256 rectangles bucketed by a, the (y,
//             w) of the block's slots staged once, each warp walking the
//             union of its rectangles' ranges 8 slots a group
//             (rank_member's contributions, then the adds);
//   variants  the rank form without the buckets (the block's union only:
//             1,024-slot stages at 4 rectangles a thread, or the whole log
//             at one), with the buckets at 1 and 2 rectangles a thread in
//             blocks of 128 and 256, in 2,048-slot stages, in groups of 4
//             and 16 slots, and two chunked forms (the log cut in 4 grid
//             rows whose sums are added in row order by chunk_sum_combine,
//             which changes the rounding).
//
// Built and timed by tools/k13_k19_rates.py.
#include "../src/repro_torch/csrc/scan2d.cu"

namespace {

constexpr int kOldTile = 256;

__global__ void __launch_bounds__(kOldTile)
    k19_old(const double* __restrict__ lx, const double* __restrict__ ux,
            const double* __restrict__ ly, const double* __restrict__ uy,
            const double* __restrict__ kx, const double* __restrict__ ky,
            const double* __restrict__ w, double* __restrict__ out, int Q,
            int D) {
  __shared__ double s_x[kOldTile], s_y[kOldTile], s_w[kOldTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = i < Q ? i : Q - 1;
  const double x0 = lx[r], x1 = ux[r], y0 = ly[r], y1 = uy[r];
  double acc = 0.0;
  for (int t0 = 0; t0 < D; t0 += kOldTile) {
    const int j = t0 + threadIdx.x;
    if (j < D) {
      s_x[threadIdx.x] = kx[j];
      s_y[threadIdx.x] = ky[j];
      s_w[threadIdx.x] = w[j];
    }
    __syncthreads();
    const int n = D - t0 < kOldTile ? D - t0 : kOldTile;
    for (int k = 0; k < n; ++k) {
      const double x = s_x[k], y = s_y[k];
      const bool in = x0 < x && x <= x1 && y0 < y && y <= y1;
      acc = acc + (in ? s_w[k] : 0.0);
    }
    __syncthreads();
  }
  if (i < Q) out[i] = acc;
}

// the chunked forms' combine: each rectangle's row sums added in row order
__global__ void chunk_sum_combine(const double* __restrict__ part,
                                  double* __restrict__ out, int Q, int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  double acc = part[i];
  for (int s = 1; s < S; ++s) acc = acc + part[(size_t)s * Q + i];
  out[i] = acc;
}

constexpr int kChunks = 4;

}  // namespace

// which: 0 k19_old, 1 K19 (polyfit_delta_sum2d), 2 no buckets, 128 x 4,
// 1,024-slot stages, 3 no buckets, 256 x 1, the whole log, 4 buckets 128 x
// 2, 5 buckets 256 x 2, 6 buckets 256 x 1 in 2,048-slot stages, 7 buckets
// 128 x 1, 8 groups of 4 slots, 9 groups of 16, 11 chunked, buckets 256 x
// 1, 12 chunked, no buckets 128 x 4 in 1,024-slot stages; ``part`` a (4, Q)
// scratch
extern "C" int k19_run(int which, const void* lx, const void* ux,
                       const void* ly, const void* uy, const void* kx,
                       const void* ky, const void* w, void* out, void* part,
                       int Q, int D, double sentinel) {
  using namespace polyfit;
  const cudaStream_t s = 0;
  const int chunk = (D + kChunks - 1) / kChunks;
  int rc = 0;
  switch (which) {
    case 0:
      k19_old<<<(Q + kOldTile - 1) / kOldTile, kOldTile, 0, s>>>(
          (const double*)lx, (const double*)ux, (const double*)ly,
          (const double*)uy, (const double*)kx, (const double*)ky,
          (const double*)w, (double*)out, Q, D);
      return (int)cudaGetLastError();
    case 1:
      return polyfit_delta_sum2d(lx, ux, ly, uy, kx, ky, w, out, Q, D,
                                 sentinel, nullptr);
    case 2:
      return launch_delta_sum2d<128, 4, 1024, 8, false>(
          lx, ux, ly, uy, kx, ky, w, out, Q, D, sentinel, D, s);
    case 3:
      return launch_delta_sum2d<256, 1, 4096, 8, false>(
          lx, ux, ly, uy, kx, ky, w, out, Q, D, sentinel, D, s);
    case 4:
      return launch_delta_sum2d<128, 2, 4096, 8, true>(
          lx, ux, ly, uy, kx, ky, w, out, Q, D, sentinel, D, s);
    case 5:
      return launch_delta_sum2d<256, 2, 4096, 8, true>(
          lx, ux, ly, uy, kx, ky, w, out, Q, D, sentinel, D, s);
    case 6:
      return launch_delta_sum2d<256, 1, 2048, 8, true>(
          lx, ux, ly, uy, kx, ky, w, out, Q, D, sentinel, D, s);
    case 7:
      return launch_delta_sum2d<128, 1, 4096, 8, true>(
          lx, ux, ly, uy, kx, ky, w, out, Q, D, sentinel, D, s);
    case 8:
      return launch_delta_sum2d<256, 1, 4096, 4, true>(
          lx, ux, ly, uy, kx, ky, w, out, Q, D, sentinel, D, s);
    case 9:
      return launch_delta_sum2d<256, 1, 4096, 16, true>(
          lx, ux, ly, uy, kx, ky, w, out, Q, D, sentinel, D, s);
    case 11:
      rc = launch_delta_sum2d<256, 1, 4096, 8, true>(
          lx, ux, ly, uy, kx, ky, w, part, Q, D, sentinel, chunk, s);
      break;
    case 12:
      rc = launch_delta_sum2d<128, 4, 1024, 8, false>(
          lx, ux, ly, uy, kx, ky, w, part, Q, D, sentinel, chunk, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  chunk_sum_combine<<<(Q + 255) / 256, 256, 0, s>>>(
      (const double*)part, (double*)out, Q, (D + chunk - 1) / chunk);
  return (int)cudaGetLastError();
}
