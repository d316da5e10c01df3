// K14 (csrc/scan1d.cu range_sum) on the card, before and after its
// redesign, and at other shapes:
//
//   old       k14_old below: one thread a range in blocks of 256, 256-entry
//             tiles of (seg_lo, seg_next) staged by plain loads, one-hot
//             membership of both endpoints (4 compares and 2 selects a
//             pair) over every row of the padded table (K21's loop, on two
//             endpoints);
//   shipped   K14 as scan1d.cu launches it (included below): the tile
//             walker over seg_lo alone, 128 starts a tile, stopping at the
//             sentinel tail, #(seg_lo <= q) of both endpoints (count_le),
//             boundary_row and Horner in the same kernel, 1 range a thread
//             in blocks of 256;
//   variants  k14_variant below, the shipped walk with R ranges a thread
//             in blocks of THREADS and TILE-start tiles: 1, 2 and 4 ranges
//             a thread in blocks of 128, 256-start tiles, and the shipped
//             shape.
//
// Built and timed by tools/k14_k18_rates.py.
#include "../src/repro_torch/csrc/scan1d.cu"

namespace {

using polyfit::boundary_row;
using polyfit::count_le;
using polyfit::row_horner;
using polyfit::scale_unit;

// K14 before its redesign: P_{I(u)}(u) - P_{I(l)}(l), each endpoint's
// segment by one-hot membership over the whole table
template <typename T>
__global__ void k14_old(const T* __restrict__ lq, const T* __restrict__ uq,
                        const T* __restrict__ seg_lo,
                        const T* __restrict__ seg_next,
                        const T* __restrict__ seg_hi,
                        const T* __restrict__ coeffs, T* __restrict__ out,
                        int Q, int H, int deg) {
  constexpr int kTile = 256;
  __shared__ T s_lo[kTile], s_nx[kTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = i < Q ? i : Q - 1;   // threads past Q still stage tiles
  const T q[2] = {lq[r], uq[r]};
  int hit[2] = {-1, -1};
  for (int t0 = 0; t0 < H; t0 += kTile) {
    const int j = t0 + threadIdx.x;
    if (j < H) {
      s_lo[threadIdx.x] = seg_lo[j];
      s_nx[threadIdx.x] = seg_next[j];
    }
    __syncthreads();
    const int n = H - t0 < kTile ? H - t0 : kTile;
    for (int k = 0; k < n; ++k) {
      const T lo = s_lo[k], nx = s_nx[k];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = lo <= q[e] && q[e] < nx;
        hit[e] = (hit[e] < 0 && in) ? t0 + k : hit[e];
      }
    }
    __syncthreads();
  }
  if (i >= Q) return;
  T v[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const bool h = hit[e] >= 0;
    const T lo = h ? seg_lo[hit[e]] : T(0);
    const T hi = h ? seg_hi[hit[e]] : T(0);
    v[e] = row_horner(coeffs, hit[e], deg, scale_unit(q[e], lo, hi));
  }
  out[i] = v[1] - v[0];
}

// K14's count walk at another shape: a thread holds R ranges
// (i0 + r * THREADS), TILE segment starts a tile
template <typename T, int THREADS, int R, int TILE>
__global__ void __launch_bounds__(THREADS)
    k14_variant(const T* __restrict__ lq, const T* __restrict__ uq,
                const T* __restrict__ seg_lo, const T* __restrict__ seg_next,
                const T* __restrict__ seg_hi, const T* __restrict__ coeffs,
                T* __restrict__ out, int Q, int H, int deg,
                double sentinel) {
  extern __shared__ double2 s_lo[];
  const int i0 = blockIdx.x * (THREADS * R) + threadIdx.x;
  T q[R][2];
  int c[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // threads past Q still stage tiles
    const int i = i0 + r * THREADS < Q ? i0 + r * THREADS : Q - 1;
    q[r][0] = lq[i];
    q[r][1] = uq[i];
    c[r][0] = c[r][1] = 0;
  }
  const T* src[1] = {seg_lo};
  polyfit::walk_slots<1, TILE, true>(src, H, 0, 1, sentinel, (T*)s_lo,
                                     [&](const T lo) {
#pragma unroll
                                       for (int r = 0; r < R; ++r) {
                                         count_le(c[r][0], lo, q[r][0]);
                                         count_le(c[r][1], lo, q[r][1]);
                                       }
                                     });
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * THREADS;
    if (i >= Q) continue;
    T v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int hit = boundary_row(c[r][e], q[r][e], seg_next);
      const T lo = hit >= 0 ? seg_lo[hit] : T(0);
      const T hi = hit >= 0 ? seg_hi[hit] : T(0);
      v[e] = row_horner(coeffs, hit, deg, scale_unit(q[r][e], lo, hi));
    }
    out[i] = v[1] - v[0];
  }
}

template <typename T>
int k14_launch(int which, const void* lq, const void* uq, const void* lo,
               const void* nx, const void* hi, const void* cf, void* out,
               int Q, int H, int deg, double sentinel, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define K14(THREADS, R, TILE)                                                \
  k14_variant<T, THREADS, R, TILE>                                           \
      <<<(Q + THREADS * R - 1) / (THREADS * R), THREADS,                     \
         polyfit::walk_smem_bytes<1, TILE, T>(), s>>>(                       \
          (const T*)lq, (const T*)uq, (const T*)lo, (const T*)nx,            \
          (const T*)hi, (const T*)cf, (T*)out, Q, H, deg, sentinel);         \
  return (int)cudaGetLastError()
  if (Q <= 0) return (int)cudaGetLastError();
  switch (which) {
    case 0:
      k14_old<T><<<(Q + 255) / 256, 256, 0, s>>>(
          (const T*)lq, (const T*)uq, (const T*)lo, (const T*)nx,
          (const T*)hi, (const T*)cf, (T*)out, Q, H, deg);
      return (int)cudaGetLastError();
    case 1:
      return polyfit::launch_range_sum<T>(lq, uq, lo, nx, hi, cf, out, Q, H,
                                          deg, sentinel, stream);
    case 2: K14(128, 1, 128);
    case 3: K14(128, 4, 128);
    case 4: K14(128, 2, 128);
    case 5: K14(256, 1, 256);
    case 6: K14(256, 1, 128);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef K14
}

}  // namespace

// which: 0 the kernel before its redesign, 1 K14 (the shipped launcher),
// 2 128 x 1, 3 128 x 4, 4 128 x 2, 5 256-start tiles, 6 k14_variant at the
// shipped shape, on ``stream``; ``f32`` picks the float instantiation
extern "C" int k14_run(int which, int f32, const void* lq, const void* uq,
                       const void* lo, const void* nx, const void* hi,
                       const void* cf, void* out, int Q, int H, int deg,
                       double sentinel, void* stream) {
  return f32 ? k14_launch<float>(which, lq, uq, lo, nx, hi, cf, out, Q, H,
                                 deg, sentinel, stream)
             : k14_launch<double>(which, lq, uq, lo, nx, hi, cf, out, Q, H,
                                  deg, sentinel, stream);
}
