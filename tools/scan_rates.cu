// Inner-loop rates of the whole-array scans on the card, apart from their
// kernels: a block of 256 threads stages a 1,024-slot tile in shared
// memory once, then each thread walks it `reps` times against R queries of
// its own with the loop body of
//
//   k16      K16 (csrc/scan1d.cu): two f64 compares, a select, an f64 add;
//   k4       K4's scan mode (csrc/quantile.cu): an f64 compare and a
//            predicated increment (scan_tile.cuh count_lt);
//   k15_old  K15 before its redesign: the one-hot membership of both
//            endpoints (first hit kept), the interior test and jmax;
//   k15      K15 (csrc/scan1d.cu, scan_tile.cuh max_scan_step): three
//            compares, two predicated increments, a predicated select;
//   k12_old  K12 before its redesign: four corners, each tested against
//            the box with the first hit kept;
//   k12      K12 (csrc/leaf_eval2d.cu, scan_tile.cuh corner_hits_step):
//            the two x and two y coordinates tested once, a select a
//            corner;
//   k17_old  K17 before its redesign: two compares, a select of the value
//            or -inf, and jmax (its NaN tests);
//   k17      K17 (csrc/scan1d.cu, scan_tile.cuh member_max_step): three
//            compares and a predicated move, no NaN test;
//   dadd     an f64 add alone, the FP64 pipe's reference rate.
//
// A slot holds four doubles (a K16, K17 or K4 key in word 0 and a K16 or
// K17 value in word 2; K15's start, next start and aggregate in words 0-2; K12's box
// x0, x1, y0, y1), a query four (K15's lq, uq in words 0-1; K12's lx, ux,
// ly, uy).  Built and timed by tools/scan_rates.py.
#include <cuda_runtime.h>

#include "locate.cuh"
#include "scan_tile.cuh"

namespace {

using polyfit::double2x2;

constexpr int kTile = 1024;
constexpr int kThreads = 256;

enum Loop {
  kK16, kK4, kK15Old, kK15, kK12Old, kK12, kK17Old, kK17, kDadd, kLoops
};

template <int L>
struct Stage;   // the words of a slot the loop reads, as it reads them
template <>
struct Stage<kK16> {
  using type = double2;
  __device__ static type of(const double2x2& g) { return {g.a.x, g.b.x}; }
};
template <>
struct Stage<kK17Old> : Stage<kK16> {};
template <>
struct Stage<kK17> : Stage<kK16> {};
template <>
struct Stage<kK4> {
  using type = double;
  __device__ static type of(const double2x2& g) { return g.a.x; }
};
template <>
struct Stage<kDadd> : Stage<kK4> {};
template <int L>
struct Stage {
  using type = double2x2;
  __device__ static type of(const double2x2& g) { return g; }
};

template <int L, int R>
__global__ void __launch_bounds__(kThreads)
    loop_kernel(const double2x2* g, const double2x2* q, double* out,
                int reps) {
  using S = typename Stage<L>::type;
  __shared__ S s[kTile];
  for (int j = threadIdx.x; j < kTile; j += kThreads)
    s[j] = Stage<L>::of(g[j]);
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  double x[R][4], acc[R];
  int c[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const double2x2 v = q[i * R + r];
    x[r][0] = v.a.x;
    x[r][1] = v.a.y;
    x[r][2] = v.b.x;
    x[r][3] = v.b.y;
    acc[r] = L == kK15 || L == kK15Old || L == kK17 || L == kK17Old
                 ? -INFINITY : 0.0;
#pragma unroll
    for (int e = 0; e < 4; ++e) c[r][e] = L == kK16 || L == kK4 ? 0 : -1;
  }
  for (int t = 0; t < reps; ++t) {
#pragma unroll 8
    for (int k = 0; k < kTile; ++k) {
      const S w = s[k];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if constexpr (L == kK16) {
          acc[r] = acc[r] +
                   ((x[r][0] < w.x && w.x <= x[r][1]) ? w.y : 0.0);
        } else if constexpr (L == kK4) {
          polyfit::count_lt(c[r][0], w, x[r][0]);
        } else if constexpr (L == kK15Old) {
          const double lo = w.a.x, nx = w.a.y, l = x[r][0], u = x[r][1];
          c[r][0] = (c[r][0] < 0 && lo <= l && l < nx) ? k : c[r][0];
          c[r][1] = (c[r][1] < 0 && lo <= u && u < nx) ? k : c[r][1];
          const bool interior = lo > l && nx <= u;
          acc[r] = polyfit::jmax(acc[r], interior ? w.b.x : -INFINITY);
        } else if constexpr (L == kK15) {
          polyfit::max_scan_step(c[r][0], c[r][1], acc[r], w.a.x, w.a.y,
                                 w.b.x, x[r][0], x[r][1]);
        } else if constexpr (L == kK12Old) {
          const double qx[4] = {x[r][1], x[r][0], x[r][1], x[r][0]};
          const double qy[4] = {x[r][3], x[r][3], x[r][2], x[r][2]};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool in = w.a.x <= qx[e] && qx[e] < w.a.y &&
                            w.b.x <= qy[e] && qy[e] < w.b.y;
            c[r][e] = (c[r][e] < 0 && in) ? k : c[r][e];
          }
        } else if constexpr (L == kK12) {
          const double qx[2] = {x[r][1], x[r][0]};
          const double qy[2] = {x[r][3], x[r][2]};
          polyfit::corner_hits_step(c[r], qx, qy, w, k);
        } else if constexpr (L == kK17Old) {
          acc[r] = polyfit::jmax(
              acc[r], (x[r][0] <= w.x && w.x <= x[r][1]) ? w.y : -INFINITY);
        } else if constexpr (L == kK17) {
          polyfit::member_max_step(acc[r], w.x, w.y, x[r][0], x[r][1]);
        } else {
          x[r][0] = x[r][0] + w;
        }
      }
    }
  }
  double a = 0.0;
#pragma unroll
  for (int r = 0; r < R; ++r)
    a = a + acc[r] + x[r][0] + c[r][0] + c[r][1] + c[r][2] + c[r][3];
  out[i] = a;
}

template <int R>
void run(int loop, const double2x2* g, const double2x2* q, double* out,
         int blocks, int reps) {
  using Kernel = void (*)(const double2x2*, const double2x2*, double*, int);
  const Kernel kernels[kLoops] = {
      loop_kernel<kK16, R>,  loop_kernel<kK4, R>,     loop_kernel<kK15Old, R>,
      loop_kernel<kK15, R>,  loop_kernel<kK12Old, R>, loop_kernel<kK12, R>,
      loop_kernel<kK17Old, R>, loop_kernel<kK17, R>, loop_kernel<kDadd, R>};
  kernels[loop]<<<blocks, kThreads>>>(g, q, out, reps);
}

}  // namespace

// loop 0 k16, 1 k4, 2 k15_old, 3 k15, 4 k12_old, 5 k12, 6 k17_old, 7 k17,
// 8 dadd; r 1, 2, 4
// or 8 queries a thread; ``g`` the tile (1,024 four-word slots), ``q``
// R four-word queries a thread, ``out`` one value a thread
extern "C" int scan_rates(int loop, int r, const void* g, const void* q,
                          void* out, int blocks, int reps) {
  if (loop < 0 || loop >= kLoops) return (int)cudaErrorInvalidValue;
  const auto* gs = (const double2x2*)g;
  const auto* qs = (const double2x2*)q;
  switch (r) {
    case 1: run<1>(loop, gs, qs, (double*)out, blocks, reps); break;
    case 2: run<2>(loop, gs, qs, (double*)out, blocks, reps); break;
    case 4: run<4>(loop, gs, qs, (double*)out, blocks, reps); break;
    case 8: run<8>(loop, gs, qs, (double*)out, blocks, reps); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
