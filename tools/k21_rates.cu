// K21 (poly_eval, csrc/scan1d.cu) before and after its redesign, and the
// forms the redesign was chosen from, on the card:
//
//   k21_old      K21 before: a block of 256 keys walks the whole padded
//                table in tiles of 256 entries staged through shared
//                memory, each thread testing its key's one-hot membership
//                seg_lo <= q < seg_next against every entry, then the first
//                hit's row by Horner, a coefficient a load;
//   shipped      K21 as scan1d.cu launches it (included below);
//   k21_variant  the same body with other options: KPT keys a thread (1 as
//                shipped, or 2: keys i and i + Q/2 of a thread in
//                lockstep); TREE, #(seg_lo <= q) by the descent of seg_lo's
//                search tree (locate.cuh tree_count_right), else by the
//                branch-free binary search (bsearch_count_right); the row
//                by 16-byte loads and Horner at the template degree.
//
// Built and timed by tools/k4_k21_rates.py, which holds each one to the
// plain version (kernels/poly_eval.py poly_eval_plain).
#include "../src/repro_torch/csrc/scan1d.cu"

namespace {

using polyfit::boundary_row;
using polyfit::bsearch_count_right;
using polyfit::horner_r;
using polyfit::load_row_v16;
using polyfit::row_horner;
using polyfit::scale_unit;
using polyfit::tree_count_right;
using polyfit::TreeShape;

constexpr int kBlock = 256;

// K21 before its redesign
template <typename T>
__global__ void k21_old(const T* __restrict__ qs, const T* __restrict__ seg_lo,
                        const T* __restrict__ seg_next,
                        const T* __restrict__ seg_hi,
                        const T* __restrict__ coeffs, T* __restrict__ out,
                        int Q, int H, int deg) {
  __shared__ T s_lo[kBlock], s_nx[kBlock];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const T q = qs[i < Q ? i : Q - 1];   // threads past Q still stage tiles
  int hit = -1;
  for (int t0 = 0; t0 < H; t0 += kBlock) {
    const int j = t0 + threadIdx.x;
    if (j < H) {
      s_lo[threadIdx.x] = seg_lo[j];
      s_nx[threadIdx.x] = seg_next[j];
    }
    __syncthreads();
    const int n = H - t0 < kBlock ? H - t0 : kBlock;
    for (int k = 0; k < n; ++k) {
      const T lo = s_lo[k], nx = s_nx[k];
      const bool in = lo <= q && q < nx;
      hit = (hit < 0 && in) ? t0 + k : hit;
    }
    __syncthreads();
  }
  if (i >= Q) return;
  const bool h = hit >= 0;
  const T lo = h ? seg_lo[hit] : T(0);
  const T hi = h ? seg_hi[hit] : T(0);
  out[i] = row_horner(coeffs, hit, deg, scale_unit(q, lo, hi));
}

template <typename T, int DEG, bool TREE>
__device__ __forceinline__ T key_value(const T* __restrict__ seg_lo,
                                       const T* __restrict__ seg_next,
                                       const T* __restrict__ seg_hi,
                                       const T* __restrict__ coeffs,
                                       const T* __restrict__ tree,
                                       const TreeShape& shape, int H, T q) {
  int c;
  if constexpr (TREE) {
    c = tree_count_right(seg_lo, H, tree, shape, q);
  } else {
    c = bsearch_count_right(seg_lo, H, q);
  }
  const int row = boundary_row(c, q, seg_next);
  const bool hit = row >= 0;
  const T lo = hit ? seg_lo[row] : T(0);
  const T hi = hit ? seg_hi[row] : T(0);
  T cf[DEG + 1];
  load_row_v16<DEG>(coeffs, hit ? row : 0, cf);
#pragma unroll
  for (int j = 0; j <= DEG; ++j) cf[j] = hit ? cf[j] : T(0);
  return horner_r<DEG>(cf, scale_unit(q, lo, hi));
}

template <typename T, int DEG, int KPT, bool TREE>
__global__ void __launch_bounds__(kBlock)
    k21_variant(const T* __restrict__ qs, const T* __restrict__ seg_lo,
                const T* __restrict__ seg_next, const T* __restrict__ seg_hi,
                const T* __restrict__ coeffs, const T* __restrict__ tree,
                TreeShape shape, T* __restrict__ out, int Q, int H) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const int per = (Q + KPT - 1) / KPT;
  if (i >= per) return;
  T v[KPT];
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    const int j = i + k * per < Q ? i + k * per : Q - 1;
    v[k] = key_value<T, DEG, TREE>(seg_lo, seg_next, seg_hi, coeffs, tree,
                                   shape, H, qs[j]);
  }
#pragma unroll
  for (int k = 0; k < KPT; ++k)
    if (i + k * per < Q) out[i + k * per] = v[k];
}

template <typename T, int DEG>
int launch_variant(int opts, const T* q, const T* lo, const T* nx,
                   const T* hi, const T* cf, const T* tree, T* out, int Q,
                   int H, cudaStream_t s) {
  const TreeShape shape = polyfit::tree_shape(H);
  const int kpt = opts & 1 ? 2 : 1;
  const int blocks = ((Q + kpt - 1) / kpt + kBlock - 1) / kBlock;
  auto k = k21_variant<T, DEG, 1, false>;
  switch (opts & 3) {
    case 0: k = k21_variant<T, DEG, 1, false>; break;
    case 1: k = k21_variant<T, DEG, 2, false>; break;
    case 2: k = k21_variant<T, DEG, 1, true>; break;
    case 3: k = k21_variant<T, DEG, 2, true>; break;
  }
  k<<<blocks, kBlock, 0, s>>>(q, lo, nx, hi, cf, tree, shape, out, Q, H);
  return (int)cudaGetLastError();
}

template <typename T>
int run(int which, const void* q, const void* seg_lo, const void* seg_next,
        const void* seg_hi, const void* coeffs, const void* tree, void* out,
        int Q, int H, int deg, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const T *qq = (const T*)q, *lo = (const T*)seg_lo,
          *nx = (const T*)seg_next, *hi = (const T*)seg_hi,
          *cf = (const T*)coeffs, *tr = (const T*)tree;
  if (which == 0) {
    k21_old<T><<<(Q + kBlock - 1) / kBlock, kBlock, 0, s>>>(
        qq, lo, nx, hi, cf, (T*)out, Q, H, deg);
    return (int)cudaGetLastError();
  }
  if (which == 1)
    return polyfit::launch_segment_eval<T>(q, seg_lo, seg_next, seg_hi,
                                           coeffs, tree, out, Q, H, deg,
                                           stream);
  // 2..5: bit 0 two keys a thread, bit 1 the tree (deg 2 and 3)
  const int opts = which - 2;
  if (opts < 0 || opts > 3) return (int)cudaErrorInvalidValue;
  switch (deg) {
    case 2: return launch_variant<T, 2>(opts, qq, lo, nx, hi, cf, tr,
                                        (T*)out, Q, H, s);
    case 3: return launch_variant<T, 3>(opts, qq, lo, nx, hi, cf, tr,
                                        (T*)out, Q, H, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// which: 0 k21_old, 1 the shipped launcher, 2-5 k21_variant (which - 2:
// bit 0 two keys a thread, bit 1 seg_lo's search tree); ``f32`` the float
// instantiations; ``tree`` seg_lo's search tree (read by the tree forms
// only)
extern "C" int k21_run(int which, int f32, const void* q, const void* seg_lo,
                       const void* seg_next, const void* seg_hi,
                       const void* coeffs, const void* tree, void* out, int Q,
                       int H, int deg, void* stream) {
  if (Q <= 0) return (int)cudaGetLastError();
  return f32 ? run<float>(which, q, seg_lo, seg_next, seg_hi, coeffs, tree,
                          out, Q, H, deg, stream)
             : run<double>(which, q, seg_lo, seg_next, seg_hi, coeffs, tree,
                           out, Q, H, deg, stream);
}
