// Rates behind the design of K9 and K10 (csrc/delta2d.cu) on the card:
//
//   k9_old   K9 before its redesign: one thread a query, four corners in
//            sequence, each an x-rank (bsearch_count_right) and mst_prefix
//            over every level (13 + 91 dependent probes a corner at cap
//            4,096);
//   shipped  K9 and K10 as delta2d.cu launches them (included below): two
//            threads a query, one an x, each searching its x-rank's set
//            bits for uy and ly, two levels at a time (locate.cuh
//            mst_prefix_bits, NY = 2, G = 2);
//   walk     the same set-bits walk with other shapes: NY y values a thread
//            (NY = 1: four threads a query, one a corner), G taken levels
//            at a time (G = 1: one level after another; G = 13: every
//            taken level in lockstep), and with kStage the x keys staged in
//            shared memory (cap <= 4,096, 32 KB a block, cp.async);
//   chase    R interleaved dependent chains a thread, j = next[j], over a
//            table of 8-byte entries: R = 1 at one warp an SM is the load
//            latency of the table's level of the hierarchy, many warps the
//            rate at which an SM serves scattered 8-byte loads.
//
// Built and timed by tools/mst_rates.py.
#include "../src/repro_torch/csrc/delta2d.cu"
#include "../src/repro_torch/csrc/scan_tile.cuh"
#include "mst_prefix.cuh"

namespace {

using polyfit::MstMode;
using polyfit::MstTotal;

__global__ void __launch_bounds__(256)
    k9_old(const double* __restrict__ lx, const double* __restrict__ ux,
           const double* __restrict__ ly, const double* __restrict__ uy,
           const double* __restrict__ kx, const double* __restrict__ ylv,
           double* __restrict__ out, int Q, int cap, int levels) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  auto cf = [&](double x, double y) {
    const int i = polyfit::bsearch_count_right(kx, cap, x);
    return (double)polyfit::mst_prefix<MstMode::kCount>(ylv, nullptr, cap,
                                                        levels, i, y);
  };
  const double a = cf(ux[q], uy[q]);
  const double b = cf(lx[q], uy[q]);
  const double c = cf(ux[q], ly[q]);
  const double d = cf(lx[q], ly[q]);
  out[q] = a - b - c + d;
}

template <MstMode M, int NY, int G, bool kStage>
__global__ void __launch_bounds__(256)
    walk(const double* __restrict__ lx, const double* __restrict__ ux,
         const double* __restrict__ ly, const double* __restrict__ uy,
         const double* __restrict__ kx, const double* __restrict__ ylv,
         const double* __restrict__ wcum, double* __restrict__ out, int Q,
         int cap) {
  constexpr int kTpq = 4 / NY;
  __shared__ __align__(16) double skx[kStage ? 4096 : 1];
  const double* keys = kx;
  if constexpr (kStage) {
    for (int j = threadIdx.x; j < cap; j += blockDim.x)
      polyfit::cp_async<8>(skx + j, kx + j);
    polyfit::cp_async_commit();
    polyfit::cp_async_wait<0>();
    __syncthreads();
    keys = skx;
  }
  const long long q = ((long long)blockIdx.x * blockDim.x + threadIdx.x) /
                      kTpq;
  const int sub = threadIdx.x % kTpq;
  const int qq = q < Q ? (int)q : Q - 1;
  const double x = sub & 1 ? lx[qq] : ux[qq];
  double v[NY];
  if constexpr (NY == 2) {
    v[0] = uy[qq];
    v[1] = ly[qq];
  } else {
    v[0] = sub & 2 ? ly[qq] : uy[qq];
  }
  const int i = polyfit::bsearch_count_right(keys, cap, x);
  MstTotal<M> tot[NY];
  polyfit::mst_prefix_bits<M, NY, G>(ylv, wcum, cap, i, v, tot);
  const double a = (double)tot[0];
  const double c =
      NY == 2 ? (double)tot[NY - 1] : __shfl_xor_sync(0xffffffffu, a, 2);
  const double b = __shfl_xor_sync(0xffffffffu, a, 1);
  const double d = __shfl_xor_sync(0xffffffffu, c, 1);
  if (q < Q && sub == 0) out[q] = a - b - c + d;
}

template <MstMode M, int NY, int G, bool kStage>
int launch_walk(const double* lx, const double* ux, const double* ly,
                const double* uy, const double* kx, const double* ylv,
                const double* wcum, double* out, int Q, int cap) {
  if (kStage && cap > 4096) return -1;
  const long long threads = (long long)Q * (4 / NY);
  walk<M, NY, G, kStage><<<(int)((threads + 255) / 256), 256>>>(
      lx, ux, ly, uy, kx, ylv, wcum, out, Q, cap);
  return (int)cudaGetLastError();
}

template <int R>
__global__ void chase(const long long* __restrict__ next,
                      long long* __restrict__ out, int span, int steps) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long j[R];
#pragma unroll
  for (int r = 0; r < R; ++r) j[r] = (t * R + r) * 7919 % span;
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int r = 0; r < R; ++r) j[r] = __ldg(next + j[r]);
  }
  long long acc = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) acc += j[r];
  if (acc == -1) out[0] = acc;   // keeps the chains live
}

template <int R>
int launch_chase(const void* next, void* out, int span, int steps, int blocks,
                 int threads) {
  chase<R><<<blocks, threads>>>((const long long*)next, (long long*)out,
                                span, steps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// walk: 0 k9_old, 1 shipped K9, 11 shipped K10; else 10 * m + v, m 0 for
// K9 and 1 for K10, v a variant below (WALKS in mst_rates.py)
int mst_walk(int walk, const void* lx, const void* ux, const void* ly,
             const void* uy, const void* kx, const void* ylv,
             const void* wcum, void* out, int Q, int cap, int levels) {
  const auto* a = (const double*)lx;
  const auto* b = (const double*)ux;
  const auto* c = (const double*)ly;
  const auto* d = (const double*)uy;
  const auto* k = (const double*)kx;
  const auto* y = (const double*)ylv;
  const auto* w = (const double*)wcum;
  auto* o = (double*)out;
  switch (walk) {
    case 0:
      k9_old<<<(Q + 255) / 256, 256>>>(a, b, c, d, k, y, o, Q, cap, levels);
      return (int)cudaGetLastError();
    case 1:
      return polyfit_delta_count2d_gather(lx, ux, ly, uy, kx, ylv, out, Q,
                                          cap, levels, nullptr);
    case 11:
      return polyfit_delta_sum2d_gather(lx, ux, ly, uy, kx, ylv, wcum, out,
                                        Q, cap, levels, nullptr);
  }
#define VARIANT(V, NY, G, STAGE)                                            \
  case V:                                                                   \
    return launch_walk<MstMode::kCount, NY, G, STAGE>(a, b, c, d, k, y,     \
                                                      nullptr, o, Q, cap);  \
  case 10 + V:                                                              \
    return launch_walk<MstMode::kSum, NY, G, STAGE>(a, b, c, d, k, y, w, o, \
                                                    Q, cap);
  switch (walk) {
    VARIANT(2, 1, 2, false)
    VARIANT(3, 1, 1, false)
    VARIANT(4, 2, 1, false)
    VARIANT(5, 2, 3, false)
    VARIANT(6, 1, 13, false)
    VARIANT(7, 2, 13, true)
  }
#undef VARIANT
  return -1;
}

int mst_chase(int r, const void* next, void* out, int span, int steps,
              int blocks, int threads) {
  switch (r) {
    case 1: return launch_chase<1>(next, out, span, steps, blocks, threads);
    case 4: return launch_chase<4>(next, out, span, steps, blocks, threads);
    case 16: return launch_chase<16>(next, out, span, steps, blocks, threads);
  }
  return -1;
}

}  // extern "C"
