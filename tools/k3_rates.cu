// K3 (range_max_gather, csrc/polyfit_kernels.cu) before and after its
// redesign, and the shapes the redesign was chosen from, on the card:
//
//   k3_old      K3 before: one thread a query, the degree a runtime
//               argument (clipped_poly_max_old below and locate.cuh horner
//               loop and branch on it, a coefficient a load), both
//               searches, rows and boundary maxima in one thread;
//   shipped     K3 as polyfit_kernels.cu launches it (included below): two
//               threads a query, one a boundary, each endpoint's segment
//               by a descent of seg_lo's search tree, the degree a template
//               argument, rows by 16-byte loads, a shuffle to the right
//               boundary's thread, which takes the sparse table;
//   k3_variant  the same body with other options: TPQ threads a query (1:
//               one thread takes both boundaries, then the sparse table);
//               PART, the steps of the kernel kept (3: the endpoints'
//               loads and the answers' writes alone, no search; 0: the two
//               searches alone, 1: and the rows and boundary maxima, 2: and
//               the sparse table, the whole kernel); kTable, the stationary
//               points of each segment read from a table (``sp``, one
//               4-value row a segment: lin, r1, r2 and a code, bit 0 set
//               where lin holds, bit 1 where r1 and r2 do) in place of the
//               three divisions and the square root a boundary takes
//               inline; kStage, seg_lo staged in shared memory before the
//               searches (dynamic shared memory of H values); kTree, each
//               endpoint's segment by a descent of seg_lo's search tree
//               (K1's, kernels/locate.py search_tree, locate.cuh
//               tree_count_right) in place of the binary search.
//
// Built and timed by tools/k3_k11_rates.py, which holds each one to the
// plain version (kernels/range_max.py range_max_gather_plain).
#include "../src/repro_torch/csrc/polyfit_kernels.cu"

namespace {

using polyfit::clipped_poly_max_r;
using polyfit::horner;
using polyfit::horner_r;
using polyfit::jclip;
using polyfit::jmax;
using polyfit::jmin;
using polyfit::load_row_v16;
using polyfit::locate_segment;
using polyfit::rmq_gather;
using polyfit::scale_unit;

// K3's clipped maximum before its redesign, the degree a runtime argument:
// the candidates of locate.cuh clipped_poly_max_r, with loops and
// branches on deg
template <typename T>
__device__ __forceinline__ T clipped_poly_max_old(const T* __restrict__ c,
                                                  int deg, T slo, T shi, T a,
                                                  T b) {
  const T ua = scale_unit(a, slo, shi);
  const T ub = scale_unit(b, slo, shi);
  T best = jmax(horner(c, deg, ua), horner(c, deg, ub));
  if (deg >= 2) {
    const T c1 = c[1];
    const T c2 = T(2) * c[2];
    const T lin = fabs(c2) > T(0) ? -c1 / (c2 == T(0) ? T(1) : c2) : ua;
    if (deg == 2) {
      best = jmax(best, horner(c, deg, jclip(lin, ua, ub)));
    } else {
      const T c3 = T(3) * c[3];
      const T disc = c2 * c2 - T(4) * c3 * c1;
      const T sq = sqrt(jmax(disc, T(0)));
      const T den = fabs(c3) > T(0) ? T(2) * c3 : T(1);
      const bool quad_ok = fabs(c3) > T(0) && disc >= T(0);
      const T r1 = quad_ok ? (-c2 - sq) / den : lin;
      const T r2 = quad_ok ? (-c2 + sq) / den : lin;
      best = jmax(best, horner(c, deg, jclip(r1, ua, ub)));
      best = jmax(best, horner(c, deg, jclip(r2, ua, ub)));
    }
  }
  return a <= b ? best : T(-INFINITY);
}

// K3 before its redesign
template <typename T>
__global__ void k3_old(const T* __restrict__ lq, const T* __restrict__ uq,
                       const T* __restrict__ seg_lo,
                       const T* __restrict__ seg_hi,
                       const T* __restrict__ coeffs, const T* __restrict__ st,
                       T* __restrict__ out, int Q, int H, int deg, int h) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  const T l = lq[i], u = uq[i];
  const int il = locate_segment(seg_lo, H, l);
  const int iu = locate_segment(seg_lo, H, u);
  const T lo_l = seg_lo[il], hi_l = seg_hi[il];
  const T lo_u = seg_lo[iu], hi_u = seg_hi[iu];
  const T* cl = coeffs + (size_t)il * (deg + 1);
  const T* cu = coeffs + (size_t)iu * (deg + 1);
  T m_left = clipped_poly_max_old(cl, deg, lo_l, hi_l, l, jmin(hi_l, u));
  m_left = l <= hi_l ? m_left : T(-INFINITY);
  T m_right = clipped_poly_max_old(cu, deg, lo_u, hi_u, jmax(lo_u, l), u);
  m_right = il == iu ? T(-INFINITY) : m_right;
  const T m_int = rmq_gather(st, h, il + 1, iu);
  out[i] = jmax(jmax(m_left, m_right), m_int);
}

// clipped_poly_max_r with the stationary points read from the segment's
// table row: the inline expressions' values where they hold, ua where the
// plain version falls back to it
template <int DEG, typename T>
__device__ __forceinline__ T clipped_max_tab(const T (&c)[DEG + 1],
                                             const T (&sp)[4], T slo, T shi,
                                             T a, T b) {
  const T ua = scale_unit(a, slo, shi);
  const T ub = scale_unit(b, slo, shi);
  T best = jmax(horner_r<DEG>(c, ua), horner_r<DEG>(c, ub));
  if constexpr (DEG >= 2) {
    const int code = (int)sp[3];
    const T lin = code & 1 ? sp[0] : ua;
    if constexpr (DEG == 2) {
      best = jmax(best, horner_r<DEG>(c, jclip(lin, ua, ub)));
    } else {
      const T r1 = code & 2 ? sp[1] : lin;
      const T r2 = code & 2 ? sp[2] : lin;
      best = jmax(best, horner_r<DEG>(c, jclip(r1, ua, ub)));
      best = jmax(best, horner_r<DEG>(c, jclip(r2, ua, ub)));
    }
  }
  return a <= b ? best : T(-INFINITY);
}

// one boundary's clipped maximum: the left one over [l, min(hi, u)]
// (suppressed when l is past hi), the right one over [max(lo, l), u]
template <typename T, int DEG, bool kTable>
__device__ __forceinline__ T boundary_max(bool right, int idx, T l, T u,
                                          const T* __restrict__ seg_lo,
                                          const T* __restrict__ seg_hi,
                                          const T* __restrict__ coeffs,
                                          const T* __restrict__ sp) {
  const T lo = seg_lo[idx], hi = seg_hi[idx];
  T c[DEG + 1];
  load_row_v16<DEG>(coeffs, idx, c);
  const T a = right ? jmax(lo, l) : l;
  const T b = right ? u : jmin(hi, u);
  T m;
  if constexpr (kTable) {
    T r[4];
    load_row_v16<3>(sp, idx, r);
    m = clipped_max_tab<DEG>(c, r, lo, hi, a, b);
  } else {
    m = clipped_poly_max_r<DEG>(c, lo, hi, a, b);
  }
  return right || l <= hi ? m : T(-INFINITY);
}

template <typename T, int DEG, int TPQ, int PART, bool kTable, bool kStage,
          bool kTree>
__global__ void __launch_bounds__(256) k3_variant(
    const T* __restrict__ lq, const T* __restrict__ uq,
    const T* __restrict__ seg_lo, const T* __restrict__ seg_hi,
    const T* __restrict__ coeffs, const T* __restrict__ st,
    const T* __restrict__ sp, const T* __restrict__ tree,
    polyfit::TreeShape shape, T* __restrict__ out, int Q, int H, int h) {
  extern __shared__ __align__(16) unsigned char k3_smem[];
  const T* keys = seg_lo;
  if constexpr (kStage) {
    T* s = reinterpret_cast<T*>(k3_smem);
    for (int j = threadIdx.x; j < H; j += blockDim.x) s[j] = seg_lo[j];
    __syncthreads();
    keys = s;
  }
  auto find = [&](T x) {
    if constexpr (kTree) {
      const int c = polyfit::tree_count_right(seg_lo, H, tree, shape, x) - 1;
      return c > 0 ? c : 0;
    } else {
      return locate_segment(keys, H, x);
    }
  };
  const long long q = ((long long)blockIdx.x * blockDim.x + threadIdx.x) /
                      TPQ;
  const int qq = q < Q ? (int)q : Q - 1;
  const T l = lq[qq], u = uq[qq];
  if constexpr (TPQ == 1) {
    if (q >= Q) return;
    const int il = find(l);
    const int iu = find(u);
    if constexpr (PART == 0) {
      out[q] = (T)(il + iu);
    } else {
      const T m_left =
          boundary_max<T, DEG, kTable>(false, il, l, u, seg_lo, seg_hi,
                                       coeffs, sp);
      T m_right = boundary_max<T, DEG, kTable>(true, iu, l, u, seg_lo, seg_hi,
                                               coeffs, sp);
      m_right = il == iu ? T(-INFINITY) : m_right;
      const T m_int = PART == 2 ? rmq_gather(st, h, il + 1, iu)
                                : T(-INFINITY);
      out[q] = jmax(jmax(m_left, m_right), m_int);
    }
  } else if constexpr (PART == 3) {
    const bool right = threadIdx.x & 1;
    const T other = __shfl_xor_sync(0xffffffffu, right ? u : l, 1);
    if (q < Q && right) out[q] = other + u;
  } else {
    const bool right = threadIdx.x & 1;
    const int idx = find(right ? u : l);
    if constexpr (PART == 0) {
      const int il = __shfl_xor_sync(0xffffffffu, idx, 1);
      if (q < Q && right) out[q] = (T)(il + idx);
    } else {
      const T m = boundary_max<T, DEG, kTable>(right, idx, l, u, seg_lo,
                                               seg_hi, coeffs, sp);
      const int il = __shfl_xor_sync(0xffffffffu, idx, 1);
      const T m_left = __shfl_xor_sync(0xffffffffu, m, 1);
      if (q < Q && right) {
        const T m_right = il == idx ? T(-INFINITY) : m;
        const T m_int = PART == 2 ? rmq_gather(st, h, il + 1, idx)
                                  : T(-INFINITY);
        out[q] = jmax(jmax(m_left, m_right), m_int);
      }
    }
  }
}

template <typename T, int DEG, int TPQ, int PART, bool kTable, bool kStage,
          bool kTree>
int launch_variant(const void* lq, const void* uq, const void* seg_lo,
                   const void* seg_hi, const void* coeffs, const void* st,
                   const void* sp, const void* tree, void* out, int Q, int H,
                   int h, cudaStream_t stream) {
  const int smem = kStage ? H * (int)sizeof(T) : 0;
  auto* kernel = k3_variant<T, DEG, TPQ, PART, kTable, kStage, kTree>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  const int blocks = (int)(((long long)TPQ * Q + 255) / 256);
  kernel<<<blocks, 256, smem, stream>>>((const T*)lq, (const T*)uq,
                                (const T*)seg_lo, (const T*)seg_hi,
                                (const T*)coeffs, (const T*)st, (const T*)sp,
                                (const T*)tree, polyfit::tree_shape(H),
                                (T*)out, Q, H, h);
  return (int)cudaGetLastError();
}

// variant v of K3 at degree DEG (K3_VARIANTS in tools/k3_k11_rates.py)
template <typename T, int DEG>
int run_variant(int v, const void* lq, const void* uq, const void* seg_lo,
                const void* seg_hi, const void* coeffs, const void* st,
                const void* sp, const void* tree, void* out, int Q, int H,
                int h, cudaStream_t stream) {
#define K3_V(V, TPQ, PART, TABLE, STAGE, TREE)                             \
  case V:                                                                  \
    return launch_variant<T, DEG, TPQ, PART, TABLE, STAGE, TREE>(          \
        lq, uq, seg_lo, seg_hi, coeffs, st, sp, tree, out, Q, H, h, stream);
  switch (v) {
    K3_V(2, 1, 2, false, false, false)   // one thread a query
    K3_V(3, 2, 0, false, false, false)   // the two searches alone
    K3_V(4, 2, 1, false, false, false)   // and the rows and boundary maxima
    K3_V(5, 2, 2, false, false, false)   // the variant at the shipped shape
    K3_V(6, 2, 2, true, false, false)    // stationary points from a table
    K3_V(7, 2, 2, false, true, false)    // seg_lo staged in shared memory
    K3_V(8, 2, 0, false, true, false)    // the searches alone, seg_lo staged
    K3_V(9, 1, 0, false, false, false)   // the searches alone, one thread
    K3_V(10, 2, 3, false, false, false)  // the loads and writes, no search
    K3_V(11, 2, 2, false, false, true)   // seg_lo's search tree
    K3_V(12, 2, 0, false, false, true)   // the searches alone, by the tree
    K3_V(13, 2, 2, true, false, true)    // the tree and the stationary table
    K3_V(14, 2, 1, false, false, true)   // the tree, rows and maxima
  }
#undef K3_V
  return -1;
}

template <typename T>
int run(int v, const void* lq, const void* uq, const void* seg_lo,
        const void* seg_hi, const void* coeffs, const void* st,
        const void* sp, const void* tree, void* out, int Q, int H, int deg,
        int h, void* stream) {
  const auto s = (cudaStream_t)stream;
  if (v == 0) {
    k3_old<T><<<(Q + 255) / 256, 256, 0, s>>>(
        (const T*)lq, (const T*)uq, (const T*)seg_lo, (const T*)seg_hi,
        (const T*)coeffs, (const T*)st, (T*)out, Q, H, deg, h);
    return (int)cudaGetLastError();
  }
  if (v == 1)
    return polyfit::launch_range_max_gather<T>(lq, uq, seg_lo, seg_hi, coeffs,
                                               st, tree, out, Q, H, deg, h,
                                               stream);
  switch (deg) {
    case 0: return run_variant<T, 0>(v, lq, uq, seg_lo, seg_hi, coeffs, st,
                                     sp, tree, out, Q, H, h, s);
    case 1: return run_variant<T, 1>(v, lq, uq, seg_lo, seg_hi, coeffs, st,
                                     sp, tree, out, Q, H, h, s);
    case 2: return run_variant<T, 2>(v, lq, uq, seg_lo, seg_hi, coeffs, st,
                                     sp, tree, out, Q, H, h, s);
    case 3: return run_variant<T, 3>(v, lq, uq, seg_lo, seg_hi, coeffs, st,
                                     sp, tree, out, Q, H, h, s);
  }
  return -1;
}

}  // namespace

extern "C" {

// v: 0 K3 before, 1 shipped, else a k3_variant (run_variant); ``sp`` the
// stationary-point table (H, 4) of the table's type (kTable variants),
// ``tree`` seg_lo's search tree (kTree variants); every launch on
// ``stream``
int k3_run(int v, int f32, const void* lq, const void* uq, const void* seg_lo,
           const void* seg_hi, const void* coeffs, const void* st,
           const void* sp, const void* tree, void* out, int Q, int H, int deg,
           int h, void* stream) {
  if (f32)
    return run<float>(v, lq, uq, seg_lo, seg_hi, coeffs, st, sp, tree, out, Q,
                      H, deg, h, stream);
  return run<double>(v, lq, uq, seg_lo, seg_hi, coeffs, st, sp, tree, out, Q,
                     H, deg, h, stream);
}

}  // extern "C"
