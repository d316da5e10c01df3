// K6 (delta_max_gather, csrc/polyfit_kernels.cu) before and after its
// redesign, and the shapes the redesign was chosen from, on the card:
//
//   k6_old      K6 before: one thread a query, the two binary searches of
//               the log in sequence (#(keys < lq), then #(keys <= uq)),
//               then rmq_gather's two sparse-table loads;
//   shipped     K6 as polyfit_kernels.cu launches it (included below): two
//               threads a query, one an endpoint, one search loop for both
//               (locate.cuh bsearch_count_side), a shuffle of #(keys < lq)
//               to the uq thread, which alone runs rmq_gather (unsplit);
//   k6_variant  FORM 1: the shipped body (unsplit); 2: split, the counts
//               exchanged by a shuffle, each thread one of rmq_gather's two
//               entries (its level, clamps and indices), a shuffle of the
//               left entry to the uq thread; 3: split, with the lq thread
//               running bsearch_count_left and the uq thread
//               bsearch_count_right (the two loops diverge in a warp); 4:
//               one thread a query, the two searches in lockstep (each
//               round issues both probes), then rmq_gather.
//
// Built and timed by tools/k2_k6_rates.py, which holds each one to the
// plain version (kernels/delta_scan.py delta_max_gather_plain).
#include "../src/repro_torch/csrc/polyfit_kernels.cu"

namespace {

using polyfit::bit_ceil;
using polyfit::bsearch_count_left;
using polyfit::bsearch_count_right;
using polyfit::bsearch_count_side;
using polyfit::floor_log2;
using polyfit::jmax;
using polyfit::rmq_gather;

constexpr int kBlock = 256;
constexpr unsigned kAll = 0xffffffffu;

// K6 before its redesign
__global__ void k6_old(const double* __restrict__ lq,
                       const double* __restrict__ uq,
                       const double* __restrict__ keys,
                       const double* __restrict__ st,
                       double* __restrict__ out, int Q, int cap) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  const int i0 = bsearch_count_left(keys, cap, lq[i]);
  const int i1 = bsearch_count_right(keys, cap, uq[i]);
  out[i] = rmq_gather(st, cap, i0, i1);
}

template <int FORM>
__global__ void __launch_bounds__(kBlock)
    k6_variant(const double* __restrict__ lq, const double* __restrict__ uq,
               const double* __restrict__ keys, const double* __restrict__ st,
               double* __restrict__ out, int Q, int cap) {
  const long long t = (long long)blockIdx.x * kBlock + threadIdx.x;
  if constexpr (FORM == 4) {
    if (t >= Q) return;
    const int i = (int)t;
    const double l = lq[i], u = uq[i];
    int c0 = 0, c1 = 0;
    for (int step = bit_ceil(cap); step >= 1; step >>= 1) {
      const int p0 = c0 + step - 1, p1 = c1 + step - 1;
      const double v0 = keys[p0 < cap - 1 ? p0 : cap - 1];
      const double v1 = keys[p1 < cap - 1 ? p1 : cap - 1];
      c0 = (p0 <= cap - 1 && v0 < l) ? c0 + step : c0;
      c1 = (p1 <= cap - 1 && v1 <= u) ? c1 + step : c1;
    }
    out[i] = rmq_gather(st, cap, c0, c1);
  } else {
    const long long q = t / 2;
    const bool upper = threadIdx.x & 1;
    const int qq = q < Q ? (int)q : Q - 1;
    int c;
    if constexpr (FORM == 3) {
      c = upper ? bsearch_count_right(keys, cap, uq[qq])
                : bsearch_count_left(keys, cap, lq[qq]);
    } else {
      c = bsearch_count_side(keys, cap, (upper ? uq : lq)[qq], upper);
    }
    const int other = __shfl_xor_sync(kAll, c, 1);
    const int i0 = upper ? other : c;
    const int i1 = upper ? c : other;
    if constexpr (FORM == 1) {
      if (q < Q && upper) out[q] = rmq_gather(st, cap, i0, i1);
    } else {
      const int length = i1 - i0 > 0 ? i1 - i0 : 0;
      const int lvl = floor_log2(length > 1 ? length : 1);
      int b = i1 - (1 << lvl);
      b = b > 0 ? b : 0;
      b = b < cap - 1 ? b : cap - 1;
      const int a = i0 < cap - 1 ? i0 : cap - 1;
      const double e = st[(size_t)lvl * (size_t)cap + (upper ? b : a)];
      const double left = __shfl_xor_sync(kAll, e, 1);
      if (q < Q && upper) out[q] = length > 0 ? jmax(left, e) : -INFINITY;
    }
  }
}

}  // namespace

// which: 0 k6_old, 1 the shipped launcher, 2-5 k6_variant<which - 1>
extern "C" int k6_run(int which, const void* lq, const void* uq,
                      const void* keys, const void* st, void* out, int Q,
                      int cap, void* stream) {
  if (Q <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const double* l = (const double*)lq;
  const double* u = (const double*)uq;
  const double* k = (const double*)keys;
  const double* t = (const double*)st;
  double* o = (double*)out;
  auto blocks = [&](int tpq) {
    return (int)(((long long)Q * tpq + kBlock - 1) / kBlock);
  };
  switch (which) {
    case 0: k6_old<<<blocks(1), kBlock, 0, s>>>(l, u, k, t, o, Q, cap); break;
    case 1: return polyfit_delta_max_gather(lq, uq, keys, st, out, Q, cap,
                                            stream);
    case 2: k6_variant<1><<<blocks(2), kBlock, 0, s>>>(l, u, k, t, o, Q, cap);
            break;
    case 3: k6_variant<2><<<blocks(2), kBlock, 0, s>>>(l, u, k, t, o, Q, cap);
            break;
    case 4: k6_variant<3><<<blocks(2), kBlock, 0, s>>>(l, u, k, t, o, Q, cap);
            break;
    case 5: k6_variant<4><<<blocks(1), kBlock, 0, s>>>(l, u, k, t, o, Q, cap);
            break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
