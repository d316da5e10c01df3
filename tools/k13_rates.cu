// K13 (csrc/leaf_eval2d.cu corner_eval2d) on the card, before and after its
// redesign, and the shipped kernels at other shapes:
//
//   k13_old  one corner a thread in blocks of 256, 256-leaf tiles staged by
//            plain loads into four shared arrays (four 8-byte shared loads
//            a leaf), the first hit kept by a test on every pair, every
//            leaf of the table scanned (the sentinel tail too), then the row;
//   shipped  K13 as leaf_eval2d.cu launches it (included below): the tile
//            walker over the four membership bounds (two 16-byte shared
//            loads a leaf), corner_hit_step (four compares and a predicated
//            move) at 8 corners a thread, the table in up to 4 chunks, a
//            stop at the sentinel tail, and the finish kernel (rows by
//            16-byte loads);
//   variants the shipped design at 4 and 16 corners a thread, with rows by
//            8-byte loads, 256 threads a block, 256-leaf tiles, 1 and 8
//            chunks, and the finish alone.
//
// Built and timed by tools/k13_k19_rates.py.
#include "../src/repro_torch/csrc/leaf_eval2d.cu"

namespace {

constexpr int kOldTile = 256;

template <int DEG>
__global__ void __launch_bounds__(kOldTile)
    k13_old(const double* __restrict__ u, const double* __restrict__ v,
            const double* __restrict__ mx0, const double* __restrict__ mx1,
            const double* __restrict__ my0, const double* __restrict__ my1,
            const double* __restrict__ bounds,
            const double* __restrict__ coeffs, double* __restrict__ out,
            int Q, int L) {
  __shared__ double s_mx0[kOldTile], s_mx1[kOldTile], s_my0[kOldTile],
      s_my1[kOldTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = i < Q ? i : Q - 1;
  const double qx = u[r], qy = v[r];
  int hit = -1;
  for (int t0 = 0; t0 < L; t0 += kOldTile) {
    const int j = t0 + threadIdx.x;
    if (j < L) {
      s_mx0[threadIdx.x] = mx0[j];
      s_mx1[threadIdx.x] = mx1[j];
      s_my0[threadIdx.x] = my0[j];
      s_my1[threadIdx.x] = my1[j];
    }
    __syncthreads();
    const int n = L - t0 < kOldTile ? L - t0 : kOldTile;
    for (int k = 0; k < n; ++k) {
      const double a0 = s_mx0[k], a1 = s_mx1[k], c0 = s_my0[k],
                   c1 = s_my1[k];
      const bool in = a0 <= qx && qx < a1 && c0 <= qy && qy < c1;
      hit = (hit < 0 && in) ? t0 + k : hit;
    }
    __syncthreads();
  }
  if (i >= Q) return;
  out[i] = polyfit::leaf_value<DEG>(qx, qy, hit, hit >= 0, bounds, coeffs);
}

}  // namespace

// which: 0 k13_old, 1 K13 (polyfit_corner_eval2d), 2 four corners a
// thread, 3 rows by 8-byte loads, 4 four corners a thread and 8-byte rows
// (the redesign's first shape), 5 sixteen corners a thread, 6 256 threads
// a block, 7 256-leaf tiles, 8 one chunk, 9 up to 8 chunks, 10 the shipped
// finish alone; ``hits`` an (8, Q) int32 scratch; deg 2 or 3
extern "C" int k13_run(int which, const void* u, const void* v,
                       const void* mx0, const void* mx1, const void* my0,
                       const void* my1, const void* bounds,
                       const void* coeffs, void* out, void* hits, int Q,
                       int L, int D, double sentinel) {
  using namespace polyfit;
  const cudaStream_t s = 0;
  if (D != 2 && D != 3) return (int)cudaErrorInvalidValue;
  const int old_blocks = (Q + kOldTile - 1) / kOldTile;
  const int S = walk_chunks<128>(L, 4);
  switch (which) {
    case 0:
      if (D == 2)
        k13_old<2><<<old_blocks, kOldTile, 0, s>>>(
            (const double*)u, (const double*)v, (const double*)mx0,
            (const double*)mx1, (const double*)my0, (const double*)my1,
            (const double*)bounds, (const double*)coeffs, (double*)out, Q,
            L);
      else
        k13_old<3><<<old_blocks, kOldTile, 0, s>>>(
            (const double*)u, (const double*)v, (const double*)mx0,
            (const double*)mx1, (const double*)my0, (const double*)my1,
            (const double*)bounds, (const double*)coeffs, (double*)out, Q,
            L);
      return (int)cudaGetLastError();
    case 1:
      return polyfit_corner_eval2d(u, v, mx0, mx1, my0, my1, bounds, coeffs,
                                   out, hits, Q, L, D, sentinel, nullptr);
    case 2:
      return launch_corner_eval2d<128, 4, 128, true>(
          u, v, mx0, mx1, my0, my1, bounds, coeffs, out, hits, Q, L, D,
          sentinel, S, s);
    case 3:
      return launch_corner_eval2d<128, 8, 128, false>(
          u, v, mx0, mx1, my0, my1, bounds, coeffs, out, hits, Q, L, D,
          sentinel, S, s);
    case 4:
      return launch_corner_eval2d<128, 4, 128, false>(
          u, v, mx0, mx1, my0, my1, bounds, coeffs, out, hits, Q, L, D,
          sentinel, S, s);
    case 5:
      return launch_corner_eval2d<128, 16, 128, true>(
          u, v, mx0, mx1, my0, my1, bounds, coeffs, out, hits, Q, L, D,
          sentinel, S, s);
    case 6:
      return launch_corner_eval2d<256, 8, 128, true>(
          u, v, mx0, mx1, my0, my1, bounds, coeffs, out, hits, Q, L, D,
          sentinel, S, s);
    case 7:
      return launch_corner_eval2d<128, 8, 256, true>(
          u, v, mx0, mx1, my0, my1, bounds, coeffs, out, hits, Q, L, D,
          sentinel, walk_chunks<256>(L, 4), s);
    case 8:
      return launch_corner_eval2d<128, 8, 128, true>(
          u, v, mx0, mx1, my0, my1, bounds, coeffs, out, hits, Q, L, D,
          sentinel, 1, s);
    case 9:
      return launch_corner_eval2d<128, 8, 128, true>(
          u, v, mx0, mx1, my0, my1, bounds, coeffs, out, hits, Q, L, D,
          sentinel, walk_chunks<128>(L, 8), s);
    case 10: {   // the shipped finish alone, on the hits the last run left
      if (D == 2)
        corner_eval2d_finish_kernel<2, kEvalV16>
            <<<blocks_for(Q), kThreads, 0, s>>>(
                (const double*)u, (const double*)v, (const int*)hits,
                (const double*)bounds, (const double*)coeffs, (double*)out,
                Q, S);
      else
        corner_eval2d_finish_kernel<3, kEvalV16>
            <<<blocks_for(Q), kThreads, 0, s>>>(
                (const double*)u, (const double*)v, (const int*)hits,
                (const double*)bounds, (const double*)coeffs, (double*)out,
                Q, S);
      return (int)cudaGetLastError();
    }
  }
  return (int)cudaErrorInvalidValue;
}
