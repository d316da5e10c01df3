// K20 (csrc/scan2d.cu delta_dommax2d) on the card, before and after its
// redesign, and the shipped kernel at other shapes:
//
//   k20_old  one thread a query, 256-slot tiles staged by plain loads into
//            three shared arrays, two __syncthreads a tile, every slot of
//            the log scanned (the sentinel tail too), jmax on every pair;
//   shipped  K20 as scan2d.cu launches it (included below): the tile
//            walker over four-word slots, 4 queries a thread, 1,024-slot
//            tiles (64 KB of shared memory a block), the log in up to 4
//            chunks and a combine kernel, stopping at the sentinel tail
//            (the tail's 0 folded back in);
//   variants the shipped kernel with 512-slot tiles (32 KB a block), and
//            with 2 queries a thread.
//
// Built and timed by tools/k1_k20_rates.py.
#include "../src/repro_torch/csrc/scan2d.cu"

namespace {

constexpr int kOldTile = 256;

__global__ void __launch_bounds__(kOldTile)
    k20_old(const double* __restrict__ u, const double* __restrict__ v,
            const double* __restrict__ kx, const double* __restrict__ ky,
            const double* __restrict__ w, double* __restrict__ out, int Q,
            int D) {
  __shared__ double s_x[kOldTile], s_y[kOldTile], s_w[kOldTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = i < Q ? i : Q - 1;
  const double qu = u[r], qv = v[r];
  double acc = -INFINITY;
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
      const bool in = s_x[k] <= qu && s_y[k] <= qv;
      acc = polyfit::jmax(acc, in ? s_w[k] : -INFINITY);
    }
    __syncthreads();
  }
  if (i < Q) out[i] = acc;
}

}  // namespace

// which: 0 k20_old, 1 K20 (polyfit_delta_dommax2d), 2 512-slot tiles,
// 3 two queries a thread; ``part`` a (4, Q) scratch
extern "C" int k20_run(int which, const void* u, const void* v,
                       const void* kx, const void* ky, const void* w,
                       void* out, void* part, int Q, int D, double sentinel,
                       void* stream) {
  using namespace polyfit;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (which) {
    case 0:
      k20_old<<<(Q + kOldTile - 1) / kOldTile, kOldTile, 0, s>>>(
          (const double*)u, (const double*)v, (const double*)kx,
          (const double*)ky, (const double*)w, (double*)out, Q, D);
      return (int)cudaGetLastError();
    case 1:
      return polyfit_delta_dommax2d(u, v, kx, ky, w, out, part, Q, D,
                                    sentinel, stream);
    case 2:
      return launch_delta_dommax2d<128, 4, 512>(
          u, v, kx, ky, w, out, part, Q, D, sentinel,
          walk_chunks<512>(D, kDomChunks), s);
    case 3:
      return launch_delta_dommax2d<128, 2, 1024>(
          u, v, kx, ky, w, out, part, Q, D, sentinel,
          walk_chunks<1024>(D, kDomChunks), s);
  }
  return (int)cudaErrorInvalidValue;
}
