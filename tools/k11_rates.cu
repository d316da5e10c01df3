// K11 (delta_dommax2d_gather, csrc/delta2d.cu) before and after its
// redesign, and the shapes the redesign was chosen from, on the card:
//
//   k11_old      K11 before: one thread a corner, the x-rank, then every
//                level's (l + 1)-round search, taken or not
//                (tools/mst_prefix.cuh mst_prefix);
//   shipped      K11 as delta2d.cu launches it (included below);
//   k11_variant  the set-bits walk (locate.cuh mst_prefix_bits, kMax) with
//                G taken levels in lockstep and TPQ threads a corner.  At
//                TPQ > 1 every thread takes the x-rank i (the same loads);
//                the set bits of i, high to low, fall in TPQ contiguous
//                groups of near-equal rounds (part_bits_n below, the
//                TPQ-way form of delta2d.cu part_bits),
//                thread t walks group t from ylv + A and wpmax + A, A the
//                bits of i above its group, and shuffles bring the groups'
//                maxima to the first thread, which folds them high to low,
//                as the shipped kernel does at TPQ = 2, G = 2.
//
// Built and timed by tools/k3_k11_rates.py, which holds each one to the
// plain version (kernels/delta_scan.py delta_dommax2d_gather_plain).
#include "../src/repro_torch/csrc/delta2d.cu"
#include "mst_prefix.cuh"

namespace {

using polyfit::MstMode;

// The set bits of the x-rank i that thread t of TPQ walks: the bits, high
// to low, fall in TPQ contiguous groups, each level in the group its
// rounds' midpoint falls in (l + 1 rounds a level); at TPQ = 2 the split
// of delta2d.cu part_bits
template <int TPQ>
__device__ __forceinline__ unsigned part_bits_n(unsigned i, int t) {
  int total = 0;
  for (unsigned r = i; r; r &= r - 1) total += __ffs(r);
  unsigned mine = 0;
  int cum = 0;
  for (unsigned r = i; r;) {
    const int l = 31 - __clz(r);
    r &= ~(1u << l);
    const int g = (2 * cum + l + 1) * TPQ / (2 * total);
    mine |= (g < TPQ ? g : TPQ - 1) == t ? 1u << l : 0u;
    cum += l + 1;
  }
  return mine;
}

__global__ void __launch_bounds__(256)
    k11_old(const double* __restrict__ u, const double* __restrict__ v,
            const double* __restrict__ kx, const double* __restrict__ ylv,
            const double* __restrict__ wpmax, double* __restrict__ out,
            int Q, int cap, int levels) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  const int i = polyfit::bsearch_count_right(kx, cap, u[q]);
  out[q] = polyfit::mst_prefix<MstMode::kMax>(ylv, wpmax, cap, levels, i,
                                              v[q]);
}

template <int G, int TPQ>
__global__ void __launch_bounds__(256) k11_variant(
    const double* __restrict__ u, const double* __restrict__ v,
    const double* __restrict__ kx, const double* __restrict__ ylv,
    const double* __restrict__ wpmax, double* __restrict__ out, int Q,
    int cap) {
  const long long q = ((long long)blockIdx.x * blockDim.x + threadIdx.x) /
                      TPQ;
  const int qq = q < Q ? (int)q : Q - 1;
  const int i = polyfit::bsearch_count_right(kx, cap, u[qq]);
  const double vq[1] = {v[qq]};
  double total[1];
  if constexpr (TPQ == 1) {
    if (q >= Q) return;
    polyfit::mst_prefix_bits<MstMode::kMax, 1, G>(ylv, wpmax, cap, i, vq,
                                                  total);
    out[q] = total[0];
  } else {
    // thread t walks its group of set bits from the blocks the higher
    // groups' bits start at
    const int t = threadIdx.x % TPQ;
    const unsigned mine = part_bits_n<TPQ>((unsigned)i, t);
    const unsigned above =
        mine ? (unsigned)i & ~((2u << (31 - __clz(mine))) - 1u) : 0u;
    polyfit::mst_prefix_bits<MstMode::kMax, 1, G>(
        ylv + above, wpmax + above, cap, (int)mine, vq, total);
    // the first thread folds the groups high to low
    double m = total[0];
#pragma unroll
    for (int k = 1; k < TPQ; ++k)
      m = polyfit::jmax(m, __shfl_down_sync(0xffffffffu, total[0], k, TPQ));
    if (q < Q && t == 0) out[q] = m;
  }
}

template <int G, int TPQ>
int launch_variant(const double* u, const double* v, const double* kx,
                   const double* ylv, const double* wpmax, double* out, int Q,
                   int cap, cudaStream_t stream) {
  const int blocks = (int)(((long long)TPQ * Q + 255) / 256);
  k11_variant<G, TPQ><<<blocks, 256, 0, stream>>>(u, v, kx, ylv, wpmax, out,
                                                  Q, cap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// v: 0 K11 before, 1 shipped, else a k11_variant (K11_VARIANTS in
// tools/k3_k11_rates.py); every launch on ``stream``
int k11_run(int v, const void* u, const void* vv, const void* kx,
            const void* ylv, const void* wpmax, void* out, int Q, int cap,
            int levels, void* stream) {
  const auto s = (cudaStream_t)stream;
  const auto* a = (const double*)u;
  const auto* b = (const double*)vv;
  const auto* k = (const double*)kx;
  const auto* y = (const double*)ylv;
  const auto* w = (const double*)wpmax;
  auto* o = (double*)out;
  switch (v) {
    case 0:
      k11_old<<<(Q + 255) / 256, 256, 0, s>>>(a, b, k, y, w, o, Q, cap,
                                              levels);
      return (int)cudaGetLastError();
    case 1:
      return polyfit_delta_dommax2d_gather(u, vv, kx, ylv, wpmax, out, Q, cap,
                                           levels, stream);
    case 2: return launch_variant<1, 1>(a, b, k, y, w, o, Q, cap, s);
    case 3: return launch_variant<2, 1>(a, b, k, y, w, o, Q, cap, s);
    case 4: return launch_variant<4, 1>(a, b, k, y, w, o, Q, cap, s);
    case 5: return launch_variant<1, 2>(a, b, k, y, w, o, Q, cap, s);
    case 6: return launch_variant<2, 2>(a, b, k, y, w, o, Q, cap, s);
    case 7: return launch_variant<4, 2>(a, b, k, y, w, o, Q, cap, s);
    case 8: return launch_variant<1, 4>(a, b, k, y, w, o, Q, cap, s);
    case 9: return launch_variant<2, 4>(a, b, k, y, w, o, Q, cap, s);
  }
  return -1;
}

}  // extern "C"
