// K1 (csrc/polyfit_kernels.cu locate) on the card, before and after its
// redesign:
//
//   k1_old   one thread a query, the branch-free binary search over the
//            sorted keys (locate.cuh locate_segment): ceil(log2 n) + 1
//            dependent probes, one 8-byte load each;
//   shipped  K1 as polyfit_kernels.cu launches it (included below): one
//            thread a query descends the keys' search tree, one 32-byte
//            node (two 16-byte loads) a level, then the leaf's four keys.
//
// Built and timed by tools/k1_k20_rates.py.
#include "../src/repro_torch/csrc/polyfit_kernels.cu"

namespace {

__global__ void k1_old(const double* __restrict__ q,
                       const double* __restrict__ keys,
                       int32_t* __restrict__ out, int Q, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  out[i] = polyfit::locate_segment(keys, n, q[i]);
}

}  // namespace

// which: 0 k1_old, 1 K1 (polyfit_locate); ``tree`` the keys' search tree
extern "C" int k1_run(int which, const void* q, const void* keys,
                      const void* tree, void* out, int Q, int n,
                      void* stream) {
  if (which == 0) {
    k1_old<<<(Q + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        (const double*)q, (const double*)keys, (int32_t*)out, Q, n);
    return (int)cudaGetLastError();
  }
  if (which == 1)
    return polyfit_locate(q, keys, tree, out, Q, n, stream);
  return (int)cudaErrorInvalidValue;
}
