// K5 (delta_sum_gather, csrc/polyfit_kernels.cu) before and after its
// redesign, and the shapes the redesign was chosen from, on the card:
//
//   k5_old      K5 before: one thread a query, the two binary searches of
//               the log in sequence, then both prefix sums;
//   shipped     K5 as polyfit_kernels.cu launches it (included below): two
//               threads a query, one an endpoint, each a binary search and a
//               prefix sum, a shuffle to the uq thread;
//   k5_variant  TPQ threads a query (1, or 2 as shipped) with each
//               endpoint's count by a descent of the log's search tree
//               (K1's, kernels/locate.py search_tree, locate.cuh
//               tree_count_right) in place of the binary search; no log
//               keeps that tree, which an append would have to rebuild;
//   k5_both     the insert and the delete log of a dynamic SUM batch in
//               one launch: four threads a query (the insert log's uq and
//               lq, the delete log's uq and lq), the four prefix sums
//               shuffled to the first, which writes the engine's
//               correction (ins[uq] - ins[lq]) - (del[uq] - del[lq]) in
//               its order (engine/dynamic.py _exec_dyn_sum); with TREE,
//               each count by the log's search tree.
//
// Built and timed by tools/k5_k8_rates.py, which holds each one to the
// plain version (kernels/delta_scan.py delta_sum_gather_plain).
#include "../src/repro_torch/csrc/polyfit_kernels.cu"

namespace {

using polyfit::bsearch_count_right;
using polyfit::tree_count_right;
using polyfit::TreeShape;

constexpr int kBlock = 256;
constexpr unsigned kAll = 0xffffffffu;

// K5 before its redesign
__global__ void __launch_bounds__(kBlock)
    k5_old(const double* __restrict__ lq, const double* __restrict__ uq,
           const double* __restrict__ keys, const double* __restrict__ cf,
           double* __restrict__ out, int Q, int cap) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  const int cu = bsearch_count_right(keys, cap, uq[i]);
  const int cl = bsearch_count_right(keys, cap, lq[i]);
  out[i] = cf[cu] - cf[cl];
}

template <bool TREE>
__device__ __forceinline__ int count_right(const double* __restrict__ keys,
                                           const double* __restrict__ tree,
                                           const TreeShape& shape, int cap,
                                           double q) {
  if constexpr (TREE) {
    return tree_count_right(keys, cap, tree, shape, q);
  } else {
    return bsearch_count_right(keys, cap, q);
  }
}

template <int TPQ>
__global__ void __launch_bounds__(kBlock)
    k5_variant(const double* __restrict__ lq, const double* __restrict__ uq,
               const double* __restrict__ keys, const double* __restrict__ cf,
               const double* __restrict__ tree, TreeShape shape,
               double* __restrict__ out, int Q, int cap) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (TPQ == 1) {
    if (t >= Q) return;
    const int i = (int)t;
    const int cu = tree_count_right(keys, cap, tree, shape, uq[i]);
    const int cl = tree_count_right(keys, cap, tree, shape, lq[i]);
    out[i] = cf[cu] - cf[cl];
  } else {
    const long long q = t / 2;
    const bool low = threadIdx.x & 1;
    const int qq = q < Q ? (int)q : Q - 1;
    const double c =
        cf[tree_count_right(keys, cap, tree, shape, (low ? lq : uq)[qq])];
    const double c_low = __shfl_xor_sync(kAll, c, 1);
    if (q < Q && !low) out[q] = c - c_low;
  }
}

template <bool TREE>
__global__ void __launch_bounds__(kBlock)
    k5_both(const double* __restrict__ lq, const double* __restrict__ uq,
            const double* __restrict__ ikeys, const double* __restrict__ icf,
            const double* __restrict__ itree,
            const double* __restrict__ dkeys, const double* __restrict__ dcf,
            const double* __restrict__ dtree, TreeShape shape,
            double* __restrict__ out, int Q, int cap) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long q = t / 4;
  const int e = threadIdx.x & 3;
  const int qq = q < Q ? (int)q : Q - 1;
  const bool del = e >= 2;
  const double* keys = del ? dkeys : ikeys;
  const double c = (del ? dcf : icf)[count_right<TREE>(
      keys, del ? dtree : itree, shape, cap, ((e & 1) ? lq : uq)[qq])];
  const double c1 = __shfl_sync(kAll, c, 1, 4);
  const double c2 = __shfl_sync(kAll, c, 2, 4);
  const double c3 = __shfl_sync(kAll, c, 3, 4);
  if (q < Q && e == 0) out[q] = (c - c1) - (c2 - c3);
}

}  // namespace

// which: 0 k5_old, 1 one thread with the tree, 2 two threads with the
// tree, 3 the shipped launcher, 4 both logs in one launch, 5 both logs in
// one launch with the trees; ``tree`` the log's search tree, ``dkeys``,
// ``dcf`` and ``dtree`` the delete log's (read by 4 and 5 only)
extern "C" int k5_run(int which, const void* lq, const void* uq,
                      const void* keys, const void* cf, const void* tree,
                      const void* dkeys, const void* dcf, const void* dtree,
                      void* out, int Q, int cap, void* stream) {
  if (Q <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const TreeShape shape = polyfit::tree_shape(cap);
  auto blocks = [&](int tpq) {
    return (int)(((long long)Q * tpq + kBlock - 1) / kBlock);
  };
  const double* l = (const double*)lq;
  const double* u = (const double*)uq;
  switch (which) {
    case 0:
      k5_old<<<blocks(1), kBlock, 0, s>>>(l, u, (const double*)keys,
                                          (const double*)cf, (double*)out, Q,
                                          cap);
      break;
    case 1:
    case 2: {
      auto k = which == 1 ? k5_variant<1> : k5_variant<2>;
      k<<<blocks(which), kBlock, 0, s>>>(l, u, (const double*)keys,
                                         (const double*)cf,
                                         (const double*)tree, shape,
                                         (double*)out, Q, cap);
      break;
    }
    case 3:
      return polyfit_delta_sum_gather(lq, uq, keys, cf, out, Q, cap, stream);
    case 4:
    case 5: {
      auto k = which == 4 ? k5_both<false> : k5_both<true>;
      k<<<blocks(4), kBlock, 0, s>>>(
          l, u, (const double*)keys, (const double*)cf, (const double*)tree,
          (const double*)dkeys, (const double*)dcf, (const double*)dtree,
          shape, (double*)out, Q, cap);
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
