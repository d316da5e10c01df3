// K17 (csrc/scan1d.cu delta_max) on the card beside K16 (delta_sum) on the
// same log, and K17 as it was before its redesign:
//
//   k17_old  one thread a query, 256-slot tiles staged by plain loads, two
//            __syncthreads a tile, every slot of the log scanned (the
//            sentinel tail too), jmax on every pair;
//   shipped  K17 and K16 as scan1d.cu launches them (included below): the
//            tile walker, 4 queries a thread, 1,024-slot tiles, the log in
//            up to 4 chunks and a combine kernel, stopping at the sentinel
//            tail (K17 then folds the tail's 0 back in).
//
// Built and timed by tools/k7_k17_rates.py.
#include "../src/repro_torch/csrc/scan1d.cu"

namespace {

constexpr int kOldTile = 256;

__global__ void __launch_bounds__(kOldTile)
    k17_old(const double* __restrict__ lq, const double* __restrict__ uq,
            const double* __restrict__ keys, const double* __restrict__ vals,
            double* __restrict__ out, int Q, int D) {
  __shared__ double s_k[kOldTile], s_v[kOldTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = i < Q ? i : Q - 1;
  const double l = lq[r], u = uq[r];
  double acc = -INFINITY;
  for (int t0 = 0; t0 < D; t0 += kOldTile) {
    const int j = t0 + threadIdx.x;
    if (j < D) {
      s_k[threadIdx.x] = keys[j];
      s_v[threadIdx.x] = vals[j];
    }
    __syncthreads();
    const int n = D - t0 < kOldTile ? D - t0 : kOldTile;
    for (int k = 0; k < n; ++k) {
      const double key = s_k[k];
      acc = polyfit::jmax(acc, (l <= key && key <= u) ? s_v[k] : -INFINITY);
    }
    __syncthreads();
  }
  if (i < Q) out[i] = acc;
}

}  // namespace

// which: 0 k17_old, 1 K17 (delta_max), 2 K16 (delta_sum); ``part`` an
// (S, Q) scratch, S = polyfit_delta_max_chunks(D)
extern "C" int k17_run(int which, const void* lq, const void* uq,
                       const void* keys, const void* vals, void* out,
                       void* part, int Q, int D, double sentinel) {
  if (which == 0) {
    k17_old<<<(Q + kOldTile - 1) / kOldTile, kOldTile>>>(
        (const double*)lq, (const double*)uq, (const double*)keys,
        (const double*)vals, (double*)out, Q, D);
    return (int)cudaGetLastError();
  }
  if (which == 1)
    return polyfit_delta_max(lq, uq, keys, vals, out, part, Q, D, sentinel,
                             nullptr);
  if (which == 2)
    return polyfit_delta_sum(lq, uq, keys, vals, out, part, Q, D, sentinel,
                             nullptr);
  return (int)cudaErrorInvalidValue;
}
