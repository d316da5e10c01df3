// K2 (range_sum_gather, csrc/polyfit_kernels.cu) before and after its
// redesign, and the shapes the redesign was chosen from, on the card:
//
//   k2_old      K2 before: one thread a query, both endpoints' binary
//               searches in sequence, the degree a runtime argument
//               (locate.cuh horner on the row in memory, a coefficient a
//               load);
//   shipped     K2 as polyfit_kernels.cu launches it (included below): two
//               threads a query, one an endpoint, each endpoint's segment
//               by a descent of seg_lo's search tree, the row in registers
//               by 16-byte loads, Horner at the template degree, a shuffle
//               to the uq thread;
//   k2_variant  the same body with other options: TPQ threads a query (1:
//               one thread evaluates both endpoints and writes); TREE, each
//               endpoint's segment by the descent of seg_lo's search tree
//               (K1's, kernels/locate.py search_tree, locate.cuh
//               tree_count_right), else by the branch-free binary search
//               (locate.cuh locate_segment); DEG >= 0 the row in registers
//               and Horner unrolled at that degree, DEG < 0 the degree at
//               run time, a coefficient a load.
//
// Built and timed by tools/k2_k6_rates.py, which holds each one to the
// plain version (kernels/range_sum.py range_sum_gather_plain).
#include "../src/repro_torch/csrc/polyfit_kernels.cu"

namespace {

using polyfit::horner;
using polyfit::horner_r;
using polyfit::load_row_v16;
using polyfit::locate_segment;
using polyfit::scale_unit;
using polyfit::tree_count_right;
using polyfit::TreeShape;

constexpr int kBlock = 256;

// K2 before its redesign
template <typename T>
__global__ void k2_old(const T* __restrict__ lq, const T* __restrict__ uq,
                       const T* __restrict__ seg_lo,
                       const T* __restrict__ seg_hi,
                       const T* __restrict__ coeffs, T* __restrict__ out,
                       int Q, int H, int deg) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  T v[2];
  const T qs[2] = {lq[i], uq[i]};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int idx = locate_segment(seg_lo, H, qs[e]);
    const T u = scale_unit(qs[e], seg_lo[idx], seg_hi[idx]);
    v[e] = horner(coeffs + (size_t)idx * (deg + 1), deg, u);
  }
  out[i] = v[1] - v[0];
}

// P_{I(x)}(x) for one endpoint x
template <typename T, int DEG, bool TREE>
__device__ __forceinline__ T endpoint_value(
    const T* __restrict__ seg_lo, const T* __restrict__ seg_hi,
    const T* __restrict__ coeffs, const T* __restrict__ tree,
    const TreeShape& shape, int H, int deg, T x) {
  int idx;
  if constexpr (TREE) {
    idx = tree_count_right(seg_lo, H, tree, shape, x) - 1;
    idx = idx > 0 ? idx : 0;
  } else {
    idx = locate_segment(seg_lo, H, x);
  }
  const T u = scale_unit(x, seg_lo[idx], seg_hi[idx]);
  if constexpr (DEG >= 0) {
    T c[DEG + 1];
    load_row_v16<DEG>(coeffs, idx, c);
    return horner_r<DEG>(c, u);
  } else {
    return horner(coeffs + (size_t)idx * (deg + 1), deg, u);
  }
}

template <typename T, int DEG, int TPQ, bool TREE>
__global__ void __launch_bounds__(kBlock)
    k2_variant(const T* __restrict__ lq, const T* __restrict__ uq,
               const T* __restrict__ seg_lo, const T* __restrict__ seg_hi,
               const T* __restrict__ coeffs, const T* __restrict__ tree,
               TreeShape shape, T* __restrict__ out, int Q, int H, int deg) {
  const long long t = (long long)blockIdx.x * kBlock + threadIdx.x;
  if constexpr (TPQ == 1) {
    if (t >= Q) return;
    const int i = (int)t;
    const T v_l = endpoint_value<T, DEG, TREE>(seg_lo, seg_hi, coeffs, tree,
                                               shape, H, deg, lq[i]);
    const T v_u = endpoint_value<T, DEG, TREE>(seg_lo, seg_hi, coeffs, tree,
                                               shape, H, deg, uq[i]);
    out[i] = v_u - v_l;
  } else {
    const long long q = t / 2;
    const bool upper = threadIdx.x & 1;
    const int qq = q < Q ? (int)q : Q - 1;
    const T v = endpoint_value<T, DEG, TREE>(seg_lo, seg_hi, coeffs, tree,
                                             shape, H, deg,
                                             (upper ? uq : lq)[qq]);
    const T v_l = __shfl_xor_sync(0xffffffffu, v, 1);
    if (q < Q && upper) out[q] = v - v_l;
  }
}

template <typename T, int DEG>
int launch_variant(int opts, const T* lq, const T* uq, const T* lo,
                   const T* hi, const T* cf, const T* tree, T* out, int Q,
                   int H, int deg, cudaStream_t s) {
  const TreeShape shape = polyfit::tree_shape(H);
  const int tpq = opts & 1 ? 2 : 1;
  const int blocks = (int)(((long long)Q * tpq + kBlock - 1) / kBlock);
  auto k = k2_variant<T, DEG, 1, false>;
  switch (opts & 3) {
    case 0: k = k2_variant<T, DEG, 1, false>; break;
    case 1: k = k2_variant<T, DEG, 2, false>; break;
    case 2: k = k2_variant<T, DEG, 1, true>; break;
    case 3: k = k2_variant<T, DEG, 2, true>; break;
  }
  k<<<blocks, kBlock, 0, s>>>(lq, uq, lo, hi, cf, tree, shape, out, Q, H,
                              deg);
  return (int)cudaGetLastError();
}

template <typename T>
int run(int which, const void* lq, const void* uq, const void* seg_lo,
        const void* seg_hi, const void* coeffs, const void* tree, void* out,
        int Q, int H, int deg, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const T *l = (const T*)lq, *u = (const T*)uq, *lo = (const T*)seg_lo,
          *hi = (const T*)seg_hi, *cf = (const T*)coeffs,
          *tr = (const T*)tree;
  if (which == 0) {
    k2_old<T><<<(Q + kBlock - 1) / kBlock, kBlock, 0, s>>>(
        l, u, lo, hi, cf, (T*)out, Q, H, deg);
    return (int)cudaGetLastError();
  }
  if (which == 1)
    return polyfit::launch_range_sum_gather<T>(lq, uq, seg_lo, seg_hi, coeffs,
                                               tree, out, Q, H, deg, stream);
  // 2..9: bit 0 two threads a query, bit 1 the tree, bit 2 the template
  // degree (2 and 3 only; the runtime form otherwise)
  const int opts = which - 2;
  if (opts < 0 || opts > 7) return (int)cudaErrorInvalidValue;
  if (!(opts & 4))
    return launch_variant<T, -1>(opts, l, u, lo, hi, cf, tr, (T*)out, Q, H,
                                 deg, s);
  switch (deg) {
    case 2: return launch_variant<T, 2>(opts, l, u, lo, hi, cf, tr, (T*)out,
                                        Q, H, deg, s);
    case 3: return launch_variant<T, 3>(opts, l, u, lo, hi, cf, tr, (T*)out,
                                        Q, H, deg, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// which: 0 k2_old, 1 the shipped launcher, 2-9 k2_variant (which - 2: bit
// 0 two threads a query, bit 1 seg_lo's search tree, bit 2 the template
// degree); ``f32`` the float instantiations; ``tree`` seg_lo's search
// tree (read by the tree forms only)
extern "C" int k2_run(int which, int f32, const void* lq, const void* uq,
                      const void* seg_lo, const void* seg_hi,
                      const void* coeffs, const void* tree, void* out, int Q,
                      int H, int deg, void* stream) {
  if (Q <= 0) return (int)cudaGetLastError();
  return f32 ? run<float>(which, lq, uq, seg_lo, seg_hi, coeffs, tree, out,
                          Q, H, deg, stream)
             : run<double>(which, lq, uq, seg_lo, seg_hi, coeffs, tree, out,
                           Q, H, deg, stream);
}
