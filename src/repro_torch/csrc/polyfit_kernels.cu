// PolyFit query kernels for Hopper (sm_90a), one thread per query for K1,
// two for K2, K3, K5 and K6: float64, and float32 as well for K2 and K3.
//
// K1 locate_tree_kernel       replaces repro/kernels/locate.py:locate_pallas
// K2 range_sum_gather_kernel  replaces repro/kernels/range_sum.py:range_sum_gather_pallas
// K3 range_max_gather_kernel  replaces repro/kernels/range_max.py:range_max_gather_pallas
// K5 delta_sum_gather_kernel  replaces repro/kernels/delta_scan.py:delta_sum_gather_pallas
// K6 delta_max_gather_kernel  replaces repro/kernels/delta_scan.py:delta_max_gather_pallas
//
// What bounds them on an H100: each is a gather plus a few dozen f64
// flops a query.  Per query K2 reads two f64 endpoints and writes one f64,
// so at Q = 65,536 it must move 2 x 8 B in and 8 B out a query plus the
// segment table once: about 1.6 MB, about 0.5 us at 3.35 TB/s.  Each
// endpoint's search adds a chain of dependent loads, which hit L1/L2 (the
// table is tens of KB).  So the bound is bytes, and at these sizes the
// launch latency and the search chains set the time.
//
// K1 searches a plan's sorted exact keys (200,000 to 1,000,768 on the main
// path: 1.6-8 MB, held in L2).  Its bound is bytes too: the queries, the
// keys once and the answers, 2.6 us at 1M keys.  Before its redesign it
// ran the branch-free binary search, one thread a query: 21 dependent
// probes at 1M keys, of which the top ~9 levels are shared by every query
// and hit L1, and each one below touches another 32-byte sector for each
// query: about 10-12 scattered L2 loads a query, 0.65-0.8 M a launch, which
// L2 serves at about 0.59 a clock an SM (tools/mst_rates.py): 4-5 us of
// its 7.4.  Its design now: a search tree built once per plan
// (kernels/locate.py search_tree, engine/plan.py), a static 5-ary B+ tree
// whose leaves are the keys array itself and whose internal nodes are one
// sector of four separators (locate.cuh tree_count_right).  Each sector
// fetched decides a level: 8 internal levels and the leaf at 1M keys, 9
// sector loads a query in place of 21 probes (7 + 1 at 200,000, in place
// of 19); the top 4-5 levels (5-25 KB) stay in L1, which leaves about 4-5
// L2 sectors a query.  The tree adds n / 4 doubles beside the keys.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, Q =
// 65,536, 20 launches a CUDA graph): 0.00540 ms at 1,000,768 keys (0.00737
// before) and 0.00464 at 200,000 (0.00637), below torch.searchsorted's
// 0.00819 and 0.00692.  At 4,096 keys, all in L1, both searches take
// 0.0039-0.0041 ms (tools/k1_k20_rates.py): that floor, not the L2 loads,
// is most of K1's time now; above it the tree costs 1.0-1.5 us where the
// binary search cost 2.4-3.5.
//
// K5 and K6 are the exact corrections over a dynamic table's delta buffer:
// two searches into the sorted, sentinel-padded log (cap entries), then a
// prefix-sum difference (K5) or an O(1) sparse-table range max (K6).  At
// Q = 65,536 and cap = 4,096 they must move about 1.6 MB (K5: lq, uq, out,
// the log and its prefix sums) and 2.0 MB (K6: the log's 13 x 4,096
// sparse table instead), about 0.5 and 0.6 us at 3.35 TB/s; the log is
// 32 KB and stays in L1/L2 across the 13 dependent probes a search takes.
// What K5 spends instead is the L1's work on scattered loads: a probe
// round of a warp touches up to 32 lines, and 8 of a 13-round search's
// rounds do.  Before its redesign one thread ran both searches (0.0065
// ms at 4,096 slots, 0.0076-0.0085 on the window's 131,072).  Its design
// now (tools/k5_k8_rates.py measures each step):
//  * two threads a query, one an endpoint, a shuffle to the uq thread:
//    twice the warps in flight, each thread's chain half as long (12%
//    off at 4,096 slots, 13% at 131,072).
// A descent of the log's search tree (K1's) in place of the binary search
// took another 14-20% off at 4,096 slots and 22-23% at the window's
// 131,072 (about 1.5 us a call), but a log's tree must be rebuilt on every
// append, 0.18 ms at 4,096 slots and 0.56-0.66 ms at 131,072: that pays
// only where hundreds of query batches run between two appends, so no log
// keeps one.  K6 had the same shape (one thread a query, both 13-round
// searches, then two sparse-table loads: 0.005854 ms in chip_smoke.py) and
// now runs K5's:
//  * two threads a query, one an endpoint, both in one search loop
//    (locate.cuh bsearch_count_side: the lq thread counts keys < lq, the
//    uq thread keys <= uq), a shuffle of #(keys < lq) to the uq thread,
//    which takes the sparse-table max: 0.004353 ms on the dynamic MAX
//    table's full log (chip_smoke.py), 12-14% under the old kernel on
//    tools/k2_k6_rates.py's logs.  Split over the pair (each thread one of
//    the two sparse-table loads) it timed the same; as two diverging
//    search loops 16-18% slower; one thread with the two searches in
//    lockstep also the same.
//
// K3 adds to K2's searches two closed-form boundary maxima (at deg 3 each
// two scale_unit divisions, three divisions and a square root for the
// stationary points, four Horner evaluations and NaN-propagating clips)
// and two sparse-table loads.  Its SASS issues about 184-188 FP64-pipe
// instructions a boundary (chip_smoke.py counts them), so at Q = 65,536
// the FP64 pipe's 17e12 instructions a second bound it at 1.4 us, above
// its byte bound (0.57 us at Hp 2,560).  Before its redesign one thread
// ran both searches, then both boundaries, a chain of dependent loads and
// divisions that 16 warps an SM hid poorly, with the degree a runtime
// argument (a coefficient a load, loops and branches on deg): 0.0115 ms.
// Its design now (tools/k3_k11_rates.py measures each step):
//  * two threads a query, one a boundary: each thread's chain is half as
//    long and twice the warps are in flight; a shuffle brings the left
//    boundary's segment and maximum to the right one's thread, which
//    takes the sparse table and combines in the plain version's order;
//  * the degree a template argument (locate.cuh clipped_poly_max_r): the
//    row in registers, by 16-byte loads where its length allows
//    (locate.cuh load_row_v16; ``coeffs`` 16-byte aligned,
//    kernels/range_max.py checks), Horner unrolled, no branch on the
//    degree;
//  * each endpoint's segment by a descent of seg_lo's search tree (K1's,
//    kept in every plan as seg_tree): with binary searches the two
//    searches took 37-44% of the time above the launch's floor; the tree
//    takes 5-6 sector loads in place of 11-13 probes.  Staging seg_lo in
//    shared memory ran slower, and a per-plan table of each segment's
//    stationary points (three divisions and a square root less a
//    boundary) saved nothing at Hp 2,560.
//
// K2 had K3's old shape (one thread a query, two binary searches of the
// padded seg_lo, the degree a runtime argument): 0.005275 ms at lat_dyn's
// plan, 0.004664 at lat's.  Its design now (tools/k2_k6_rates.py measures
// every mix of the three, on segment tables of the smoke's shapes):
//  * two threads a query, one an endpoint, a shuffle of the lq value to the
//    uq thread, which writes v_u - v_l (10-18% under one thread);
//  * each endpoint's segment by a descent of seg_lo's search tree, which
//    every plan keeps as seg_tree: 4 levels and the leaf in place of 10
//    probes at Hp 512, 5 in place of 13 at 2,560 (13-18% under the binary
//    search with two threads at a template degree, though at Hp 512 the
//    live starts fill a few lines that both searches find in L1: the
//    chain's length, not the lines, set the difference; the tree's build,
//    0.38-0.73 ms a plan, rides on merges of seconds and seals of 19 s);
//  * the row in registers by 16-byte loads, Horner at a template degree
//    (0-8, K4's range; 1-5% under the runtime degree; a runtime-degree form
//    serves the plans above).
// 0.003958 ms at lat_dyn's plan, 0.003297 at lat's, 0.002970 at float32
// (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W).
// Compiled with -fmad=false so that Horner's acc * u + c rounds twice, as
// the plain torch version does.
//
// K2 and K3 are templates on the element type: the float instantiations
// (polyfit_range_sum_gather_f32, polyfit_range_max_gather_f32) serve
// float32 plans (kernels/ops.py), with the same bodies and the same
// order of operations at float precision, and half the bytes.
//
// Each launcher takes raw device pointers and the CUDA stream, launches on
// that stream, and returns cudaGetLastError() (0 when the launch was taken).

#include <cuda_runtime.h>
#include <stdint.h>

#include "locate.cuh"

namespace polyfit {

constexpr int kThreads = 256;

// K1: segment id per query key, max(#(keys <= q) - 1, 0), by a descent of
// the keys' search tree
__global__ void locate_tree_kernel(const double* __restrict__ q,
                                   const double* __restrict__ keys,
                                   const double* __restrict__ tree,
                                   int32_t* __restrict__ out, int Q, int n,
                                   TreeShape shape) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  const int c = tree_count_right(keys, n, tree, shape, q[i]) - 1;
  out[i] = c > 0 ? c : 0;
}

// K2: A = P_{I(u)}(u) - P_{I(l)}(l) (paper Eq. 14).  Two threads serve a
// query, one an endpoint: thread bit 0 picks it (0: lq, 1: uq).  Each
// locates its endpoint by a descent of seg_lo's search tree (K1's), reads
// its segment's row into registers and evaluates it by Horner at the
// template degree; a shuffle brings the lq value to the uq thread, which
// writes v_u - v_l.  DEG < 0 is the one runtime-degree form (``deg``, a
// coefficient a load), for plans above the instantiated degrees.
template <typename T, int DEG>
__global__ void __launch_bounds__(kThreads) range_sum_gather_kernel(
    const T* __restrict__ lq, const T* __restrict__ uq,
    const T* __restrict__ seg_lo, const T* __restrict__ seg_hi,
    const T* __restrict__ coeffs, const T* __restrict__ tree,
    TreeShape shape, T* __restrict__ out, int Q, int H, int deg) {
  const long long q = ((long long)blockIdx.x * kThreads + threadIdx.x) / 2;
  const bool upper = threadIdx.x & 1;
  // lanes past Q redo the last query: every lane reaches the shuffle
  const int qq = q < Q ? (int)q : Q - 1;
  const T x = (upper ? uq : lq)[qq];
  // max(#(seg_lo <= x) - 1, 0): locate_segment's count, from the tree
  int idx = tree_count_right(seg_lo, H, tree, shape, x) - 1;
  idx = idx > 0 ? idx : 0;
  const T u = scale_unit(x, seg_lo[idx], seg_hi[idx]);
  T v;
  if constexpr (DEG >= 0) {
    T c[DEG + 1];
    load_row_v16<DEG>(coeffs, idx, c);
    v = horner_r<DEG>(c, u);
  } else {
    v = horner(coeffs + (size_t)idx * (deg + 1), deg, u);
  }
  const T v_l = __shfl_xor_sync(0xffffffffu, v, 1);
  if (q < Q && upper) out[q] = v - v_l;
}

// K3: MAX over [lq, uq] (paper Eq. 17): closed-form clipped maxima on the
// two boundary segments, sparse-table max over the interior (il, iu).  Two
// threads serve a query, one a boundary: thread bit 0 picks it (0: lq's
// segment, 1: uq's).  Each locates its endpoint by a descent of seg_lo's
// search tree (K1's), reads its segment's row into registers and takes the
// clipped maximum over its part of the segment; a shuffle brings il and
// the left maximum to the right thread, which suppresses its own maximum
// when il == iu, takes the interior's sparse-table max and combines the
// three in the plain version's order.
template <typename T, int DEG>
__global__ void __launch_bounds__(kThreads) range_max_gather_kernel(
    const T* __restrict__ lq, const T* __restrict__ uq,
    const T* __restrict__ seg_lo, const T* __restrict__ seg_hi,
    const T* __restrict__ coeffs, const T* __restrict__ st,
    const T* __restrict__ tree, TreeShape shape, T* __restrict__ out, int Q,
    int H, int h) {
  const long long q = ((long long)blockIdx.x * kThreads + threadIdx.x) / 2;
  const bool right = threadIdx.x & 1;
  // lanes past Q redo the last query: every lane reaches the shuffles
  const int qq = q < Q ? (int)q : Q - 1;
  const T l = lq[qq], u = uq[qq];
  // max(#(seg_lo <= q) - 1, 0): locate_segment's count, from the tree
  int idx = tree_count_right(seg_lo, H, tree, shape, right ? u : l) - 1;
  idx = idx > 0 ? idx : 0;
  const T lo = seg_lo[idx], hi = seg_hi[idx];
  T c[DEG + 1];
  load_row_v16<DEG>(coeffs, idx, c);
  // left boundary: [lq, min(hi_l, uq)], suppressed when lq is past hi_l;
  // right boundary: [max(lo_u, lq), uq]
  T m = clipped_poly_max_r<DEG>(c, lo, hi, right ? jmax(lo, l) : l,
                                right ? u : jmin(hi, u));
  m = right || l <= hi ? m : T(-INFINITY);
  const int il = __shfl_xor_sync(0xffffffffu, idx, 1);
  const T m_left = __shfl_xor_sync(0xffffffffu, m, 1);
  if (q < Q && right) {
    // the right boundary is suppressed when it is the left one's segment
    const T m_right = il == idx ? T(-INFINITY) : m;
    // interior segments are exactly (il, iu): an O(1) sparse-table range max
    const T m_int = rmq_gather(st, h, il + 1, idx);
    out[q] = jmax(jmax(m_left, m_right), m_int);
  }
}

// K5: sum of buffered measures with key in (lq, uq]: cf[#(keys <= uq)] -
// cf[#(keys <= lq)] against the log's exclusive prefix sums cf (cap + 1).
// Two threads serve a query, one an endpoint: thread bit 0 picks it (0:
// uq, 1: lq).  Each counts the log's keys <= its endpoint by the
// branch-free binary search and reads that prefix sum; a shuffle brings
// cf[#(keys <= lq)] to the uq thread, which writes the difference.
__global__ void __launch_bounds__(kThreads) delta_sum_gather_kernel(
    const double* __restrict__ lq, const double* __restrict__ uq,
    const double* __restrict__ keys, const double* __restrict__ cf,
    double* __restrict__ out, int Q, int cap) {
  const long long q = ((long long)blockIdx.x * kThreads + threadIdx.x) / 2;
  const bool low = threadIdx.x & 1;
  // lanes past Q redo the last query: every lane reaches the shuffle
  const int qq = q < Q ? (int)q : Q - 1;
  const double v = cf[bsearch_count_right(keys, cap, (low ? lq : uq)[qq])];
  const double v_low = __shfl_xor_sync(0xffffffffu, v, 1);
  if (q < Q && !low) out[q] = v - v_low;
}

// K6: max of buffered measures with key in [lq, uq]: the log's covered span
// [#(keys < lq), #(keys <= uq)) against its (levels, cap) sparse table;
// an empty span gives -inf.  Two threads serve a query, one an endpoint:
// thread bit 0 picks it (0: lq, counting keys < lq; 1: uq, counting keys
// <= uq), one search loop for both (bsearch_count_side).  A shuffle brings
// #(keys < lq) to the uq thread, which takes the O(1) sparse-table max.
__global__ void __launch_bounds__(kThreads) delta_max_gather_kernel(
    const double* __restrict__ lq, const double* __restrict__ uq,
    const double* __restrict__ keys, const double* __restrict__ st,
    double* __restrict__ out, int Q, int cap) {
  const long long q = ((long long)blockIdx.x * kThreads + threadIdx.x) / 2;
  const bool upper = threadIdx.x & 1;
  // lanes past Q redo the last query: every lane reaches the shuffle
  const int qq = q < Q ? (int)q : Q - 1;
  const int c = bsearch_count_side(keys, cap, (upper ? uq : lq)[qq], upper);
  const int i0 = __shfl_xor_sync(0xffffffffu, c, 1);
  if (q < Q && upper) out[q] = rmq_gather(st, cap, i0, c);
}

inline int blocks_for(int Q) { return (Q + kThreads - 1) / kThreads; }

// K2 at one instantiation a degree 0-8 (K4's range), the runtime-degree
// form above them, two threads a query
template <typename T>
int launch_range_sum_gather(const void* lq, const void* uq, const void* seg_lo,
                            const void* seg_hi, const void* coeffs,
                            const void* tree, void* out, int Q, int H,
                            int deg, void* stream) {
  if (Q > 0) {
    const int blocks = (int)((2LL * Q + kThreads - 1) / kThreads);
    const TreeShape shape = tree_shape(H);
#define K2_LAUNCH(D)                                                        \
  range_sum_gather_kernel<T, D><<<blocks, kThreads, 0,                      \
                                  (cudaStream_t)stream>>>(                  \
      (const T*)lq, (const T*)uq, (const T*)seg_lo, (const T*)seg_hi,       \
      (const T*)coeffs, (const T*)tree, shape, (T*)out, Q, H, deg)
    switch (deg) {
      case 0: K2_LAUNCH(0); break;
      case 1: K2_LAUNCH(1); break;
      case 2: K2_LAUNCH(2); break;
      case 3: K2_LAUNCH(3); break;
      case 4: K2_LAUNCH(4); break;
      case 5: K2_LAUNCH(5); break;
      case 6: K2_LAUNCH(6); break;
      case 7: K2_LAUNCH(7); break;
      case 8: K2_LAUNCH(8); break;
      default: K2_LAUNCH(-1); break;
    }
#undef K2_LAUNCH
  }
  return (int)cudaGetLastError();
}

// K3 at one instantiation a degree (the wrapper admits deg 0-3), two
// threads a query
template <typename T>
int launch_range_max_gather(const void* lq, const void* uq, const void* seg_lo,
                            const void* seg_hi, const void* coeffs,
                            const void* st, const void* tree, void* out,
                            int Q, int H, int deg, int h, void* stream) {
  if (Q > 0) {
    const int blocks = (int)((2LL * Q + kThreads - 1) / kThreads);
    const TreeShape shape = tree_shape(H);
#define K3_LAUNCH(D)                                                       \
  range_max_gather_kernel<T, D><<<blocks, kThreads, 0,                      \
                                  (cudaStream_t)stream>>>(                  \
      (const T*)lq, (const T*)uq, (const T*)seg_lo, (const T*)seg_hi,       \
      (const T*)coeffs, (const T*)st, (const T*)tree, shape, (T*)out, Q, H, \
      h)
    switch (deg) {
      case 0: K3_LAUNCH(0); break;
      case 1: K3_LAUNCH(1); break;
      case 2: K3_LAUNCH(2); break;
      case 3: K3_LAUNCH(3); break;
      default: return (int)cudaErrorInvalidValue;
    }
#undef K3_LAUNCH
  }
  return (int)cudaGetLastError();
}

}  // namespace polyfit

extern "C" {

// ``keys``: n sorted keys, ``tree`` their search tree
// (kernels/locate.py search_tree), both 16-byte aligned
int polyfit_locate(const void* q, const void* keys, const void* tree,
                   void* out, int Q, int n, void* stream) {
  if (Q > 0)
    polyfit::locate_tree_kernel<<<polyfit::blocks_for(Q), polyfit::kThreads,
                                  0, (cudaStream_t)stream>>>(
        (const double*)q, (const double*)keys, (const double*)tree,
        (int32_t*)out, Q, n, polyfit::tree_shape(n));
  return (int)cudaGetLastError();
}

// ``tree``: seg_lo's search tree (kernels/locate.py search_tree); seg_lo,
// coeffs and tree 16-byte aligned
int polyfit_range_sum_gather(const void* lq, const void* uq, const void* seg_lo,
                             const void* seg_hi, const void* coeffs,
                             const void* tree, void* out, int Q, int H,
                             int deg, void* stream) {
  return polyfit::launch_range_sum_gather<double>(lq, uq, seg_lo, seg_hi,
                                                  coeffs, tree, out, Q, H,
                                                  deg, stream);
}

int polyfit_range_sum_gather_f32(const void* lq, const void* uq,
                                 const void* seg_lo, const void* seg_hi,
                                 const void* coeffs, const void* tree,
                                 void* out, int Q, int H, int deg,
                                 void* stream) {
  return polyfit::launch_range_sum_gather<float>(lq, uq, seg_lo, seg_hi,
                                                 coeffs, tree, out, Q, H,
                                                 deg, stream);
}

// ``tree``: seg_lo's search tree (kernels/locate.py search_tree); seg_lo,
// coeffs and tree 16-byte aligned
int polyfit_range_max_gather(const void* lq, const void* uq, const void* seg_lo,
                             const void* seg_hi, const void* coeffs,
                             const void* st, const void* tree, void* out,
                             int Q, int H, int deg, int h, void* stream) {
  return polyfit::launch_range_max_gather<double>(lq, uq, seg_lo, seg_hi,
                                                  coeffs, st, tree, out, Q, H,
                                                  deg, h, stream);
}

int polyfit_range_max_gather_f32(const void* lq, const void* uq,
                                 const void* seg_lo, const void* seg_hi,
                                 const void* coeffs, const void* st,
                                 const void* tree, void* out, int Q, int H,
                                 int deg, int h, void* stream) {
  return polyfit::launch_range_max_gather<float>(lq, uq, seg_lo, seg_hi,
                                                 coeffs, st, tree, out, Q, H,
                                                 deg, h, stream);
}

int polyfit_delta_sum_gather(const void* lq, const void* uq, const void* keys,
                             const void* cf, void* out, int Q, int cap,
                             void* stream) {
  if (Q > 0)
    // two threads a query
    polyfit::delta_sum_gather_kernel<<<
        (int)((2LL * Q + polyfit::kThreads - 1) / polyfit::kThreads),
        polyfit::kThreads, 0, (cudaStream_t)stream>>>(
        (const double*)lq, (const double*)uq, (const double*)keys,
        (const double*)cf, (double*)out, Q, cap);
  return (int)cudaGetLastError();
}

int polyfit_delta_max_gather(const void* lq, const void* uq, const void* keys,
                             const void* st, void* out, int Q, int cap,
                             void* stream) {
  if (Q > 0)
    // two threads a query
    polyfit::delta_max_gather_kernel<<<
        (int)((2LL * Q + polyfit::kThreads - 1) / polyfit::kThreads),
        polyfit::kThreads, 0, (cudaStream_t)stream>>>(
        (const double*)lq, (const double*)uq, (const double*)keys,
        (const double*)st, (double*)out, Q, cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
