// Rates behind the design of K7 (csrc/leaf_eval2d.cu) on the card, deg 3:
//
//   k7_old   K7 before its redesign: one thread a rectangle, four corners
//            in sequence, each three binary searches (leaf2d_locate.cuh
//            locate_leaf2d: x cut, y cut, leaf code) and a row of 20
//            8-byte loads (leaf_value);
//   variant  the redesign's steps one at a time, one thread a rectangle
//            (TPQ = 1), two (one an x value) or four (one a corner):
//              GUESS     each of the two x and two y values ranked once by
//                        cut_rank_guess (else by bsearch_count_right);
//              LOCKSTEP  a thread's leaf-code searches advanced together,
//                        one load each a round (else one after another);
//              VEC       rows by 16-byte loads (leaf_value_v16);
//              STAGE     the leaf codes staged in shared memory by
//                        cp.async, once a block;
//            MINB caps the registers so that MINB blocks of 256 fit an SM
//            (1: 255 registers, no cap in effect);
//   shipped  K7 as leaf_eval2d.cu launches it (included below): four
//            threads a rectangle, GUESS and VEC.
//
// Built and timed by tools/k7_k17_rates.py.
#include "../src/repro_torch/csrc/leaf_eval2d.cu"
#include "leaf2d_locate.cuh"

namespace {

using polyfit::bsearch_count_right;
using polyfit::cut_rank_guess;
using polyfit::leaf_value;
using polyfit::leaf_value_v16;
using polyfit::morton2;

constexpr int kDeg = 3;
constexpr int kBlock = 256;
constexpr unsigned kAll = 0xffffffffu;

__global__ void __launch_bounds__(kBlock)
    k7_old(const double* __restrict__ lx, const double* __restrict__ ux,
           const double* __restrict__ ly, const double* __restrict__ uy,
           const double* __restrict__ xcuts, const double* __restrict__ ycuts,
           const int32_t* __restrict__ leaf_z,
           const double* __restrict__ bounds,
           const double* __restrict__ coeffs, double* __restrict__ out, int Q,
           int nx, int ny, int L, int depth) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  const double qx[4] = {ux[i], lx[i], ux[i], lx[i]};
  const double qy[4] = {uy[i], uy[i], ly[i], ly[i]};
  double v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int leaf = polyfit::locate_leaf2d(qx[e], qy[e], xcuts, nx, ycuts,
                                            ny, leaf_z, L, depth);
    v[e] = leaf_value<kDeg>(qx[e], qy[e], leaf, true, bounds, coeffs);
  }
  out[i] = v[0] - v[1] - v[2] + v[3];
}

// #(keys <= q[k]) for N codes, the rounds of bsearch_count_right advanced
// together: each round issues its N loads before its compares
template <int N>
__device__ __forceinline__ void bsearch_lockstep(
    const int32_t* __restrict__ keys, int n, const int32_t (&q)[N],
    int (&c)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) c[k] = 0;
  for (int step = polyfit::bit_ceil(n); step >= 1; step >>= 1) {
    int32_t pv[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int probe = c[k] + step - 1;
      pv[k] = keys[probe < n - 1 ? probe : n - 1];
    }
#pragma unroll
    for (int k = 0; k < N; ++k)
      c[k] = (c[k] + step - 1 <= n - 1 && pv[k] <= q[k]) ? c[k] + step : c[k];
  }
}

template <bool GUESS>
__device__ __forceinline__ int rank_of(const double* __restrict__ cuts, int n,
                                       double v) {
  if constexpr (GUESS) {
    return cut_rank_guess(cuts, n, v);
  } else {
    return bsearch_count_right(cuts, n, v);
  }
}

// corner e = (x[e & 1], y[e >> 1]), x = (ux, lx), y = (uy, ly); a thread
// holds corners sub, sub + TPQ, ... of its rectangle
template <int TPQ, bool GUESS, bool LOCKSTEP, bool VEC, bool STAGE,
          int MINB = 1>
__global__ void __launch_bounds__(kBlock, MINB)
    variant(const double* __restrict__ lx, const double* __restrict__ ux,
            const double* __restrict__ ly, const double* __restrict__ uy,
            const double* __restrict__ xcuts, const double* __restrict__ ycuts,
            const int32_t* __restrict__ leaf_z,
            const double* __restrict__ bounds,
            const double* __restrict__ coeffs, double* __restrict__ out,
            int Q, int nx, int ny, int L, int depth) {
  constexpr int NC = 4 / TPQ;
  extern __shared__ int32_t s_z[];
  const int32_t* codes = leaf_z;
  if constexpr (STAGE) {
    for (int j = threadIdx.x; j < L; j += blockDim.x)
      polyfit::cp_async<4>(s_z + j, leaf_z + j);
    polyfit::cp_async_commit();
    polyfit::cp_async_wait<0>();
    __syncthreads();
    codes = s_z;
  }
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int sub = threadIdx.x % TPQ;
  const int q = t / TPQ < Q ? (int)(t / TPQ) : Q - 1;
  double qx[NC], qy[NC];
  int32_t z[NC];
  if constexpr (TPQ == 1) {
    const double x[2] = {ux[q], lx[q]}, y[2] = {uy[q], ly[q]};
    int ix[2], iy[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      ix[k] = rank_of<GUESS>(xcuts, nx, x[k]);
      iy[k] = rank_of<GUESS>(ycuts, ny, y[k]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qx[e] = x[e & 1];
      qy[e] = y[e >> 1];
      z[e] = morton2(ix[e & 1], iy[e >> 1], depth);
    }
  } else if constexpr (TPQ == 2) {
    // lane sub holds x value sub and ranks y value sub
    const double x = sub ? lx[q] : ux[q];
    const double y = sub ? ly[q] : uy[q];
    const int ix = rank_of<GUESS>(xcuts, nx, x);
    const int iy = rank_of<GUESS>(ycuts, ny, y);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      qx[k] = x;
      qy[k] = __shfl_sync(kAll, y, k, 2);
      z[k] = morton2(ix, __shfl_sync(kAll, iy, k, 2), depth);
    }
  } else {
    const double* src = sub == 0 ? ux : (sub == 1 ? lx : (sub == 2 ? uy : ly));
    const double val = src[q];
    const int rank = rank_of<GUESS>(sub < 2 ? xcuts : ycuts,
                                    sub < 2 ? nx : ny, val);
    const int xl = sub & 1, yl = 2 + (sub >> 1);
    qx[0] = __shfl_sync(kAll, val, xl, 4);
    qy[0] = __shfl_sync(kAll, val, yl, 4);
    z[0] = morton2(__shfl_sync(kAll, rank, xl, 4),
                   __shfl_sync(kAll, rank, yl, 4), depth);
  }
  int c[NC];
  if constexpr (LOCKSTEP) {
    bsearch_lockstep<NC>(codes, L, z, c);
  } else {
#pragma unroll
    for (int k = 0; k < NC; ++k) c[k] = bsearch_count_right(codes, L, z[k]);
  }
  double v[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int leaf = c[k] - 1 > 0 ? c[k] - 1 : 0;
    if constexpr (VEC) {
      v[k] = leaf_value_v16<kDeg>(qx[k], qy[k], leaf, bounds, coeffs);
    } else {
      v[k] = leaf_value<kDeg>(qx[k], qy[k], leaf, true, bounds, coeffs);
    }
  }
  double a;
  if constexpr (TPQ == 1) {
    a = v[0] - v[1] - v[2] + v[3];
  } else if constexpr (TPQ == 2) {
    // lane 0 holds corners 0 and 2, lane 1 corners 1 and 3
    const double v1 = __shfl_sync(kAll, v[0], 1, 2);
    const double v3 = __shfl_sync(kAll, v[1], 1, 2);
    a = v[0] - v1 - v[1] + v3;
  } else {
    const double v1 = __shfl_sync(kAll, v[0], 1, 4);
    const double v2 = __shfl_sync(kAll, v[0], 2, 4);
    const double v3 = __shfl_sync(kAll, v[0], 3, 4);
    a = v[0] - v1 - v2 + v3;
  }
  if (sub == 0 && t / TPQ < Q) out[q] = a;
}

using Kernel = void (*)(const double*, const double*, const double*,
                        const double*, const double*, const double*,
                        const int32_t*, const double*, const double*, double*,
                        int, int, int, int, int);

struct Variant {
  Kernel kernel;
  int tpq;
  bool stage;
};

// tools/k7_k17_rates.py VARIANTS, in this order (0: k7_old, then the
// shipped launcher last)
const Variant kVariants[] = {
    {k7_old, 1, false},
    {variant<1, false, false, false, false>, 1, false},
    {variant<1, true, false, false, false>, 1, false},
    {variant<1, true, true, false, false>, 1, false},
    {variant<1, true, true, true, false>, 1, false},
    {variant<1, true, true, true, true>, 1, true},
    {variant<2, true, true, true, false>, 2, false},
    {variant<4, true, false, false, false>, 4, false},
    {variant<4, true, false, true, true>, 4, true},
    {variant<4, true, false, true, false, 6>, 4, false},
    {variant<4, true, false, true, false, 8>, 4, false},
};
constexpr int kCount = sizeof(kVariants) / sizeof(kVariants[0]);

}  // namespace

// variant 0 .. kCount - 1 as kVariants, kCount the shipped launcher
extern "C" int k7_variant(int which, const void* lx, const void* ux,
                          const void* ly, const void* uy, const void* xcuts,
                          const void* ycuts, const void* leaf_z,
                          const void* bounds, const void* coeffs, void* out,
                          int Q, int nx, int ny, int L, int depth) {
  if (which == kCount)
    return polyfit_corner_count2d_gather(lx, ux, ly, uy, xcuts, ycuts, leaf_z,
                                         bounds, coeffs, out, Q, nx, ny, L,
                                         kDeg, depth, nullptr);
  if (which < 0 || which > kCount) return (int)cudaErrorInvalidValue;
  const Variant& v = kVariants[which];
  const long long threads = (long long)Q * v.tpq;
  const int blocks = (int)((threads + kBlock - 1) / kBlock);
  const size_t smem = v.stage ? (size_t)L * 4 : 0;
  v.kernel<<<blocks, kBlock, smem>>>(
      (const double*)lx, (const double*)ux, (const double*)ly,
      (const double*)uy, (const double*)xcuts, (const double*)ycuts,
      (const int32_t*)leaf_z, (const double*)bounds, (const double*)coeffs,
      (double*)out, Q, nx, ny, L, depth);
  return (int)cudaGetLastError();
}

extern "C" int k7_variants() { return kCount; }
