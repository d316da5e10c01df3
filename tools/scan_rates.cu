// Inner-loop rates of the one-key whole-array scans on the card, apart
// from their kernels: a block of 256 threads stages a sorted 1,024-slot
// tile in shared memory once, then each thread walks it `reps` times
// against R queries of its own with the loop body of
//
//   k16  K16 (csrc/scan1d.cu): two f64 compares, a select, an f64 add;
//   k4   K4's scan mode (csrc/quantile.cu): an f64 compare and a
//        predicated increment (scan_tile.cuh count_lt);
//   dadd an f64 add alone, the FP64 pipe's reference rate.
//
// Built and timed by tools/scan_rates.py.
#include <cuda_runtime.h>

#include "scan_tile.cuh"

namespace {

constexpr int kTile = 1024;
constexpr int kThreads = 256;

template <int R>
__global__ void __launch_bounds__(kThreads)
    k16_loop(const double2* g, const double* q, double* out, int reps) {
  __shared__ double2 s[kTile];
  for (int j = threadIdx.x; j < kTile; j += kThreads) s[j] = g[j];
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  double l[R], u[R], acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    l[r] = q[2 * (i * R + r)];
    u[r] = q[2 * (i * R + r) + 1];
    acc[r] = 0.0;
  }
  for (int t = 0; t < reps; ++t) {
#pragma unroll 8
    for (int k = 0; k < kTile; ++k) {
      const double2 kv = s[k];
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r] = acc[r] + ((l[r] < kv.x && kv.x <= u[r]) ? kv.y : 0.0);
    }
  }
  double a = 0.0;
#pragma unroll
  for (int r = 0; r < R; ++r) a = a + acc[r];
  out[i] = a;
}

template <int R>
__global__ void __launch_bounds__(kThreads)
    k4_loop(const double2* g, const double* q, double* out, int reps) {
  __shared__ double s[kTile];
  for (int j = threadIdx.x; j < kTile; j += kThreads) s[j] = g[j].x;
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  double x[R];
  int c[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    x[r] = q[2 * (i * R + r)];
    c[r] = 0;
  }
  for (int t = 0; t < reps; ++t) {
#pragma unroll 8
    for (int k = 0; k < kTile; ++k) {
      const double key = s[k];
#pragma unroll
      for (int r = 0; r < R; ++r) polyfit::count_lt(c[r], key, x[r]);
    }
  }
  int a = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) a += c[r];
  out[i] = a;
}

template <int R>
__global__ void __launch_bounds__(kThreads)
    dadd_loop(const double2* g, const double* q, double* out, int reps) {
  __shared__ double s[kTile];
  for (int j = threadIdx.x; j < kTile; j += kThreads) s[j] = g[j].x;
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  double x[R];
#pragma unroll
  for (int r = 0; r < R; ++r) x[r] = q[2 * (i * R + r)];
  for (int t = 0; t < reps; ++t) {
#pragma unroll 8
    for (int k = 0; k < kTile; ++k) {
      const double key = s[k];
#pragma unroll
      for (int r = 0; r < R; ++r) x[r] = x[r] + key;
    }
  }
  double a = 0.0;
#pragma unroll
  for (int r = 0; r < R; ++r) a = a + x[r];
  out[i] = a;
}

template <int R>
void run(int loop, const double2* g, const double* q, double* out, int blocks,
         int reps) {
  if (loop == 0) k16_loop<R><<<blocks, kThreads>>>(g, q, out, reps);
  if (loop == 1) k4_loop<R><<<blocks, kThreads>>>(g, q, out, reps);
  if (loop == 2) dadd_loop<R><<<blocks, kThreads>>>(g, q, out, reps);
}

}  // namespace

// loop 0 k16, 1 k4, 2 dadd; r 4 or 8 queries a thread; ``g`` the tile
// (1,024 key/value pairs), ``q`` 2 * R values a thread, ``out`` one a
// thread
extern "C" int scan_rates(int loop, int r, const void* g, const void* q,
                          void* out, int blocks, int reps) {
  if (r == 4)
    run<4>(loop, (const double2*)g, (const double*)q, (double*)out, blocks,
           reps);
  else if (r == 8)
    run<8>(loop, (const double2*)g, (const double*)q, (double*)out, blocks,
           reps);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
