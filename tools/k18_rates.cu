// K18 (csrc/scan2d.cu delta_count2d) on the card, before and after its
// redesign, and the rank form at other shapes:
//
//   k18_old   one thread a rectangle in blocks of 256, 256-slot tiles staged
//             by plain loads into two shared arrays, 4 f64 compares, a
//             select and an f64 add on every (rectangle, slot) pair, every
//             slot of the log (the sentinel tail too);
//   shipped   K18 as scan2d.cu launches it (included below): each block's
//             256 rectangles ranked to slot ranges [a, b) of the live log
//             by two binary searches over the x keys staged in shared
//             memory, bucketed by a, y staged alone, each warp's union of
//             ranges split between 2 warps, the rank test once a group of
//             32 slots (rank_count_group);
//   first     the first rank form: the keys searched in global memory, one
//             warp a union, the rank test on every slot (rank_count_step),
//             8 slots a group;
//   variants  the first form with the live log in 2 and 4 chunks along the
//             grid's second dimension (each ranked and walked alone, the
//             chunk counts added by count_combine), without buckets, at 2
//             rectangles a thread in blocks of 128 and 1 in blocks of 128,
//             in groups of 16 slots, with the keys in shared memory, split
//             in 2 or 4; the rank test once a group of 8, 16 or 32 slots;
//             and K19 (delta_sum2d) as shipped, on the same log.  The first
//             form and the variants are k18_variant below, a template on
//             each of these choices; its shape <256, 1, 4096, 32, true, 2,
//             true, true> is the shipped kernel's.
//
// Built and timed by tools/k14_k18_rates.py.
#include "../src/repro_torch/csrc/scan2d.cu"

namespace {

constexpr int kOldTile = 256;

__global__ void __launch_bounds__(kOldTile)
    k18_old(const double* __restrict__ lx, const double* __restrict__ ux,
            const double* __restrict__ ly, const double* __restrict__ uy,
            const double* __restrict__ kx, const double* __restrict__ ky,
            double* __restrict__ out, int Q, int D) {
  __shared__ double s_x[kOldTile], s_y[kOldTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = i < Q ? i : Q - 1;   // threads past Q still stage tiles
  const double x0 = lx[r], x1 = ux[r], y0 = ly[r], y1 = uy[r];
  double acc = 0.0;
  for (int t0 = 0; t0 < D; t0 += kOldTile) {
    const int j = t0 + threadIdx.x;
    if (j < D) {
      s_x[threadIdx.x] = kx[j];
      s_y[threadIdx.x] = ky[j];
    }
    __syncthreads();
    const int n = D - t0 < kOldTile ? D - t0 : kOldTile;
    for (int k = 0; k < n; ++k) {
      const double x = s_x[k], y = s_y[k];
      const bool in = x0 < x && x <= x1 && y0 < y && y <= y1;
      acc = acc + (in ? 1.0 : 0.0);
    }
    __syncthreads();
  }
  if (i < Q) out[i] = acc;
}

// K18's rank form with each design choice a template option: blocks of
// THREADS threads of R rectangles (P = THREADS * R a block), ranked
// (rank_rects) against chunk y of the live log, with SORT bucketed by a;
// STAGE_X: the x keys staged in shared memory first and searched there
// (where they fit); SPLIT threads a rectangle slot, each walking its
// 1 / SPLIT of its warp's union, the parts added in shared memory; G slots
// an unrolled group, with MASK the rank test once a group
// (rank_count_group), else on every slot (rank_count_step).  With one grid
// row the counts go to ``out`` as float64, with more to row y of ``part``
// ((gridDim.y, Q) int32).
template <int THREADS, int R, int SLOTS, int G, bool SORT, int SPLIT,
          bool STAGE_X, bool MASK>
__global__ void __launch_bounds__(THREADS * SPLIT)
    k18_variant(const double* __restrict__ lx, const double* __restrict__ ux,
                const double* __restrict__ ly, const double* __restrict__ uy,
                const double* __restrict__ kx, const double* __restrict__ ky,
                double* __restrict__ out, int* __restrict__ part, int Q,
                int D, double sentinel) {
  using namespace polyfit;
  constexpr int P = THREADS * R, BLOCK = THREADS * SPLIT;
  __shared__ RankStage<P, SORT> s;
  __shared__ int s_part[SPLIT > 1 ? (SPLIT - 1) * P : 1];
  extern __shared__ double s_y[];
  const double* keys = kx;
  if (STAGE_X && D <= SLOTS) {
    for (int k = threadIdx.x; k < D; k += BLOCK) cp_async<8>(&s_y[k], kx + k);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    keys = s_y;
  }
  const int tail = log_tail(keys, D, sentinel);
  const int chunk = (tail + gridDim.y - 1) / gridDim.y;
  const int c0 = min((int)blockIdx.y * chunk, tail);
  const int c1 = min(c0 + chunk, tail);
  Ranked<R> q;
  rank_rects<THREADS, R, SORT>(lx, ux, ly, uy, keys, Q, D,
                               blockIdx.x * P, c0, c1, s, q);
  const int n_tail = blockIdx.y == 0 && tail < D
                         ? bsearch_count_right(keys, D, sentinel) - tail
                         : 0;
  if (STAGE_X) __syncthreads();   // the keys' buffer is restaged
  const int h = threadIdx.x / THREADS;
  const long long len = max(q.hi_w - q.lo_w, 0);
  const int w_lo = q.lo_w + (int)(len * h / SPLIT);
  const int w_hi = q.lo_w + (int)(len * (h + 1) / SPLIT);
  int cnt[R];
#pragma unroll
  for (int r = 0; r < R; ++r) cnt[r] = 0;
  for (int t0 = q.lo_b; t0 < q.hi_b; t0 += SLOTS) {
    const int m = min(SLOTS, q.hi_b - t0);
    for (int k = threadIdx.x; k < m; k += BLOCK)
      cp_async<8>(&s_y[k], ky + t0 + k);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int j1 = min(w_hi, t0 + m);
    int j = max(w_lo, t0);
    for (; j1 - j >= G; j += G) {
      if (MASK) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          rank_count_group<G>(cnt[r], j, q.a[r], q.b[r], q.ly[r], q.uy[r],
                              s_y + (j - t0));
        continue;
      }
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const double y = s_y[j + k - t0];
#pragma unroll
        for (int r = 0; r < R; ++r)
          rank_count_step(cnt[r], j + k, q.a[r], q.b[r], q.ly[r], q.uy[r], y);
      }
    }
    for (; j < j1; ++j) {
      const double y = s_y[j - t0];
#pragma unroll
      for (int r = 0; r < R; ++r)
        rank_count_step(cnt[r], j, q.a[r], q.b[r], q.ly[r], q.uy[r], y);
    }
    __syncthreads();
  }
  if (SPLIT > 1) {
    const int t = threadIdx.x % THREADS;
    if (h > 0)
#pragma unroll
      for (int r = 0; r < R; ++r) s_part[(h - 1) * P + t * R + r] = cnt[r];
    __syncthreads();
    if (h > 0) return;
#pragma unroll
    for (int r = 0; r < R; ++r)
      for (int k = 1; k < SPLIT; ++k) cnt[r] += s_part[(k - 1) * P + t * R + r];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = q.idx[r];
    if (i >= Q) continue;
    if (n_tail > 0 && q.ly[r] < sentinel && sentinel <= q.uy[r] &&
        lx[i] < sentinel && sentinel <= ux[i])
      cnt[r] += n_tail;
    if (gridDim.y == 1)
      out[i] = (double)cnt[r];
    else
      part[(size_t)blockIdx.y * Q + i] = cnt[r];
  }
}

// the chunked forms' combine: each rectangle's S chunk counts added
// (integers: exact) and written as float64
__global__ void count_combine(const int* __restrict__ part,
                              double* __restrict__ out, int Q, int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  int acc = part[i];
  for (int s = 1; s < S; ++s) acc += part[(size_t)s * Q + i];
  out[i] = (double)acc;
}

// k18_variant over S grid rows (the live log in S chunks, S = 1 writing
// ``out`` itself), then, for S > 1, the combine of ``part``
template <int THREADS, int R, int G, bool SORT, int SPLIT, bool STAGE_X,
          bool MASK, int S>
int launch_variant(const void* lx, const void* ux, const void* ly,
                   const void* uy, const void* kx, const void* ky, void* out,
                   void* part, int Q, int D, double sentinel,
                   cudaStream_t stream) {
  constexpr int SLOTS = 4096, per_block = THREADS * R;
  const int smem = (D < SLOTS ? D : SLOTS) * (int)sizeof(double);
  k18_variant<THREADS, R, SLOTS, G, SORT, SPLIT, STAGE_X, MASK>
      <<<dim3((Q + per_block - 1) / per_block, S), THREADS * SPLIT, smem,
         stream>>>((const double*)lx, (const double*)ux, (const double*)ly,
                   (const double*)uy, (const double*)kx, (const double*)ky,
                   (double*)out, (int*)part, Q, D, sentinel);
  if (S > 1)
    count_combine<<<(Q + 255) / 256, 256, 0, stream>>>((const int*)part,
                                                       (double*)out, Q, S);
  return (int)cudaGetLastError();
}

}  // namespace

// which: 0 k18_old, 1 K18 (polyfit_delta_count2d), 22 the first rank form
// (256 x 1, a rank test a slot, 8-slot groups, the keys searched in global
// memory), and variants of it: 2 and 3 the live log in 4 and 2 chunks, 5
// no buckets, 6 128 x 2, 14 128 x 1, 7 groups of 16 slots, 10 the x keys
// searched in shared memory, 11 the walk split in 2, 12 split in 2 and the
// keys in shared memory, 13 split in 4 and the keys in shared memory, 15
// 128 x 1 split in 2; 16-18 the rank test once a group of 8, 16 or 32
// slots (rank_count_group) with the keys in shared memory, 21 a group of
// 16 split in 2 with the keys in global memory, 20 a group of 16 split in
// 2 with the keys in shared memory, 19 k18_variant at the shipped shape;
// 9 K19 (polyfit_delta_sum2d, ``w`` its
// measures); ``part`` an (8, Q) int32 scratch; each on ``stream``
extern "C" int k18_run(int which, const void* lx, const void* ux,
                       const void* ly, const void* uy, const void* kx,
                       const void* ky, const void* w, void* out, void* part,
                       int Q, int D, double sentinel, void* stream) {
  using namespace polyfit;
  const cudaStream_t s = (cudaStream_t)stream;
#define K18(T, R, G, SORT, SPLIT, STAGE, MASK, S)                         \
  return launch_variant<T, R, G, SORT, SPLIT, STAGE, MASK, S>(              \
      lx, ux, ly, uy, kx, ky, out, part, Q, D, sentinel, s)
  switch (which) {
    case 0:
      k18_old<<<(Q + kOldTile - 1) / kOldTile, kOldTile, 0, s>>>(
          (const double*)lx, (const double*)ux, (const double*)ly,
          (const double*)uy, (const double*)kx, (const double*)ky,
          (double*)out, Q, D);
      return (int)cudaGetLastError();
    case 1:
      return polyfit_delta_count2d(lx, ux, ly, uy, kx, ky, out, Q, D,
                                   sentinel, stream);
    case 2: K18(256, 1, 8, true, 1, false, false, 4);
    case 3: K18(256, 1, 8, true, 1, false, false, 2);
    case 5: K18(256, 1, 8, false, 1, false, false, 1);
    case 6: K18(128, 2, 8, true, 1, false, false, 1);
    case 7: K18(256, 1, 16, true, 1, false, false, 1);
    case 10: K18(256, 1, 8, true, 1, true, false, 1);
    case 11: K18(256, 1, 8, true, 2, false, false, 1);
    case 12: K18(256, 1, 8, true, 2, true, false, 1);
    case 13: K18(256, 1, 8, true, 4, true, false, 1);
    case 14: K18(128, 1, 8, true, 1, false, false, 1);
    case 15: K18(128, 1, 8, true, 2, false, false, 1);
    case 16: K18(256, 1, 8, true, 1, true, true, 1);
    case 17: K18(256, 1, 16, true, 1, true, true, 1);
    case 18: K18(256, 1, 32, true, 1, true, true, 1);
    case 20: K18(256, 1, 16, true, 2, true, true, 1);
    case 21: K18(256, 1, 16, true, 2, false, true, 1);
    case 22: K18(256, 1, 8, true, 1, false, false, 1);
    case 19: K18(256, 1, 32, true, 2, true, true, 1);
    case 9:
      return polyfit_delta_sum2d(lx, ux, ly, uy, kx, ky, w, out, Q, D,
                                 sentinel, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef K18
}
