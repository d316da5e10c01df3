// PolyFit two-key whole-log scan kernels for Hopper (sm_90a), float64: the
// buffered two-key corrections of the 'cuda_scan' backend.
//
// K18 delta_rect2d_kernel<false>    replaces repro/kernels/delta_scan.py:delta_count2d_pallas
// K19 delta_rect2d_kernel<true>     replaces repro/kernels/delta_scan.py:delta_sum2d_pallas
// K20 delta_dommax2d_kernel + chunk_max_combine_kernel (scan_tile.cuh)
//                                   replaces repro/kernels/delta_scan.py:delta_dommax2d_pallas
//
// Twins of the plain versions in repro_torch/kernels/delta_scan.py.  Where
// K9-K11 (delta2d.cu) walk the log's merge-sort tree, these test every
// query against every slot of the x-sorted, sentinel-padded point log:
//
//   K18  the number of logged points with lx < x <= ux and ly < y <= uy,
//        counted in float64 (exact below 2^53 slots);
//   K19  the sum of their measures, added in slot order (the plain version
//        adds in the same order, so the two agree bit for bit);
//   K20  the max measure of the logged points with x <= u and y <= v, -inf
//        when none is dominated; a NaN measure among them gives NaN, as
//        the reference's jnp.max does.
//
// Sentinel slots hold the sentinel in both coordinates and measure 0, so
// they fail every membership test below the sentinel.  The reference sums
// a one-hot matmul over tiles of 512 slots; a count and a max are exact in
// any order, and the sum of K19 is held to the plain version in slot
// order.
//
// What bounds them on an H100: operations.  K18 and K19 do 4 compares and
// an add a (query, slot) pair: at Q = 65,536 against a 4,096-slot log
// about 1.3e9 f64 operations, about 0.04 ms at the FP64 peak; the bytes
// (the queries, the log once and the answers) about 2.7 MB, under a
// microsecond.  Their design: one thread a query, the log in tiles of 256
// slots staged through shared memory (the log read once a block from L2),
// one compare-and-select chain a thread.
//
// K20 does 3 compares a (query, live slot) pair (two for dominance, one
// for the max): 8.05e8 f64 operations at Q = 65,536 against 4,096 live
// slots, 0.0237 ms at the FP64 peak, which counts an FMA as two (a compare
// issues at one operation a lane a clock, so the FP64 pipe alone needs
// twice that).  Before its redesign it ran K18's design: one query a
// thread, three 8-byte shared loads a slot, jmax's NaN tests on every
// pair (about 10 instructions), every slot of the log, the sentinel tail
// too: 3.8 pairs a clock an SM (0.2736 ms).  Its design now is K17's
// (scan1d.cu):
//   - the tile walker (scan_tile.cuh walk_tiles) stages x, y and the
//     measure as one four-word slot (a word of padding), read back as two
//     16-byte shared loads, kDomTile slots a tile through double-buffered
//     cp.async, 4 queries a thread (one pair of loads serves four);
//   - the log is cut in up to 4 chunks of interleaved tiles along the
//     grid's second dimension, and a combine kernel takes each query's
//     chunk maxima in chunk order (jmax, no atomics: two launches give the
//     same bits);
//   - the loop (scan_tile.cuh dominated_max_step) has no NaN test: 3 f64
//     compares and a predicated move.  Once a tile has landed the block
//     votes (__syncthreads_or) whether its measures hold a NaN, and such a
//     tile runs jmax instead; a NaN acc is never replaced by the
//     compare-only loop, so it stays NaN;
//   - a block stops at its first tile that starts on the sentinel (the log
//     is x-sorted, and from its first sentinel x on every slot is
//     (sentinel, sentinel, 0)).  That is exact only with the tail's 0
//     folded back: a corner with u >= sentinel and v >= sentinel dominates
//     the padding, which the plain version counts as a member (a MIN table
//     runs negated, so its measures lie below 0).  So a block that skipped
//     tiles gives each such query jmax(acc, 0.0); a NaN corner fails that
//     test as it fails every dominance test.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, Q =
// 65,536): 0.0551 ms on a MIN table's insert log of 3,072 live slots in
// 4,096 (0.2736 before the redesign), 14.0 (query, live slot) pairs a
// clock an SM, 32% of the bound over the live slots.  On the same logs K17
// runs 13.9-14.5 pairs a clock an SM and K20 13.3-13.9; a NaN measure in
// every tile (jmax) costs 1.8x (tools/k1_k20_rates.py).
//
// Each launcher takes raw device pointers and the CUDA stream, launches on
// that stream, and returns cudaGetLastError() (0 when the launch was
// taken).

#include <cuda_runtime.h>
#include <stdint.h>

#include "locate.cuh"
#include "scan_tile.cuh"

namespace polyfit {
namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads;   // log slots staged per tile

inline int blocks_for(int Q) { return (Q + kThreads - 1) / kThreads; }

// K18 (WEIGHTED false): count of the logged points in (lx, ux] x (ly, uy];
// K19 (WEIGHTED true): the sum of their measures ``w``, in slot order
template <bool WEIGHTED>
__global__ void delta_rect2d_kernel(const double* __restrict__ lx,
                                    const double* __restrict__ ux,
                                    const double* __restrict__ ly,
                                    const double* __restrict__ uy,
                                    const double* __restrict__ kx,
                                    const double* __restrict__ ky,
                                    const double* __restrict__ w,
                                    double* __restrict__ out, int Q, int D) {
  __shared__ double s_x[kTile], s_y[kTile], s_w[WEIGHTED ? kTile : 1];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = i < Q ? i : Q - 1;   // threads past Q still stage tiles
  const double x0 = lx[r], x1 = ux[r], y0 = ly[r], y1 = uy[r];
  double acc = 0.0;
  for (int t0 = 0; t0 < D; t0 += kTile) {
    const int j = t0 + threadIdx.x;
    if (j < D) {
      s_x[threadIdx.x] = kx[j];
      s_y[threadIdx.x] = ky[j];
      if (WEIGHTED) s_w[threadIdx.x] = w[j];
    }
    __syncthreads();
    const int n = D - t0 < kTile ? D - t0 : kTile;
    for (int k = 0; k < n; ++k) {
      const double x = s_x[k], y = s_y[k];
      const bool in = x0 < x && x <= x1 && y0 < y && y <= y1;
      acc = acc + (in ? (WEIGHTED ? s_w[k] : 1.0) : 0.0);
    }
    __syncthreads();
  }
  if (i < Q) out[i] = acc;
}

// K20: max of the measures of the logged points with x <= u, y <= v,
// -inf when none (NaN where a dominated measure is NaN).  A thread holds R
// queries; block (x, y) walks the log's tiles y, y + S, y + 2S, ... (S =
// gridDim.y chunks) in slot order and writes its partial maxima to row y
// of ``part``.  Once a tile has landed the block votes whether its
// measures hold a NaN: a tile that holds none runs dominated_max_step (no
// NaN test), one that does runs jmax, which leaves acc NaN, and
// dominated_max_step never replaces a NaN acc.  Each block stops at its
// first tile that starts on the sentinel; every slot it skips is
// (sentinel, sentinel, 0.0), so a query that dominates the sentinel
// (sentinel <= u and sentinel <= v: false for a NaN corner) takes
// jmax(acc, 0.0) where its block skipped tiles.
template <int THREADS, int R, int TILE>
__global__ void __launch_bounds__(THREADS)
    delta_dommax2d_kernel(const double* __restrict__ u,
                          const double* __restrict__ v,
                          const double* __restrict__ kx,
                          const double* __restrict__ ky,
                          const double* __restrict__ w,
                          double* __restrict__ part, int Q, int D,
                          double sentinel) {
  extern __shared__ double2 s_pts[];
  const int i0 = blockIdx.x * (THREADS * R) + threadIdx.x;
  double qu[R], qv[R], acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // threads past Q still stage tiles
    const int i = i0 + r * THREADS < Q ? i0 + r * THREADS : Q - 1;
    qu[r] = u[i];
    qv[r] = v[i];
    acc[r] = -INFINITY;
  }
  const double* src[3] = {kx, ky, w};
  const bool skipped = walk_tiles<4, TILE, true>(
      src, D, blockIdx.y, gridDim.y, sentinel, (double*)s_pts,
      [&](const double2x2* pts, int m) {
        bool nan = false;
        for (int k = threadIdx.x; k < m; k += THREADS)
          nan |= isnan(pts[k].b.x);
        if (__syncthreads_or(nan)) {
          for (int k = 0; k < m; ++k) {
            const double2x2 p = pts[k];
#pragma unroll
            for (int r = 0; r < R; ++r)
              acc[r] = jmax(acc[r], (p.a.x <= qu[r] && p.a.y <= qv[r])
                                        ? p.b.x : -INFINITY);
          }
        } else if (m == TILE) {
#pragma unroll 8
          for (int k = 0; k < TILE; ++k) {
            const double2x2 p = pts[k];
#pragma unroll
            for (int r = 0; r < R; ++r)
              dominated_max_step(acc[r], p.a.x, p.a.y, p.b.x, qu[r], qv[r]);
          }
        } else {
          for (int k = 0; k < m; ++k) {
            const double2x2 p = pts[k];
#pragma unroll
            for (int r = 0; r < R; ++r)
              dominated_max_step(acc[r], p.a.x, p.a.y, p.b.x, qu[r], qv[r]);
          }
        }
      });
  double* row = part + (size_t)blockIdx.y * Q;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (skipped && sentinel <= qu[r] && sentinel <= qv[r])
      acc[r] = jmax(acc[r], 0.0);
    if (i0 + r * THREADS < Q) row[i0 + r * THREADS] = acc[r];
  }
}

// K20's shape: 4 queries a thread in blocks of 128, 1,024-slot tiles (two
// 32 KB buffers of four-word slots: 3 blocks an SM), the log in up to 4
// chunks.  On an NVIDIA H100 80GB HBM3 at 700 W (tools/k1_k20_rates.py)
// 512-slot tiles ran 9% slower on a log of 3,072 live slots in 4,096 and
// as fast on a full one, 2 queries a thread 13% slower.
constexpr int kDomThreads = 128, kDomQueries = 4, kDomTile = 1024,
              kDomChunks = 4;

// K20 in S chunks: the chunk maxima go to ``part`` ((S, Q), unused when
// S = 1), then the combine writes ``out``
template <int THREADS, int R, int TILE>
int launch_delta_dommax2d(const void* u, const void* v, const void* kx,
                          const void* ky, const void* w, void* out,
                          void* part, int Q, int D, double sentinel, int S,
                          cudaStream_t stream) {
  constexpr int per_block = THREADS * R;
  constexpr int smem = walk_smem_bytes<4, TILE>();
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(delta_dommax2d_kernel<THREADS, R, TILE>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((Q + per_block - 1) / per_block, S);
  delta_dommax2d_kernel<THREADS, R, TILE><<<grid, THREADS, smem, stream>>>(
      (const double*)u, (const double*)v, (const double*)kx,
      (const double*)ky, (const double*)w, (double*)(S > 1 ? part : out), Q,
      D, sentinel);
  if (S > 1)
    chunk_max_combine_kernel<double><<<blocks_for(Q), kThreads, 0, stream>>>(
        (const double*)part, (double*)out, Q, S);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace polyfit

extern "C" {

int polyfit_delta_count2d(const void* lx, const void* ux, const void* ly,
                          const void* uy, const void* kx, const void* ky,
                          void* out, int Q, int D, void* stream) {
  if (Q > 0)
    polyfit::delta_rect2d_kernel<false><<<polyfit::blocks_for(Q),
                                          polyfit::kThreads, 0,
                                          (cudaStream_t)stream>>>(
        (const double*)lx, (const double*)ux, (const double*)ly,
        (const double*)uy, (const double*)kx, (const double*)ky, nullptr,
        (double*)out, Q, D);
  return (int)cudaGetLastError();
}

int polyfit_delta_sum2d(const void* lx, const void* ux, const void* ly,
                        const void* uy, const void* kx, const void* ky,
                        const void* w, void* out, int Q, int D, void* stream) {
  if (Q > 0)
    polyfit::delta_rect2d_kernel<true><<<polyfit::blocks_for(Q),
                                         polyfit::kThreads, 0,
                                         (cudaStream_t)stream>>>(
        (const double*)lx, (const double*)ux, (const double*)ly,
        (const double*)uy, (const double*)kx, (const double*)ky,
        (const double*)w, (double*)out, Q, D);
  return (int)cudaGetLastError();
}

int polyfit_delta_dommax2d_chunks(int D) {
  return polyfit::walk_chunks<polyfit::kDomTile>(D, polyfit::kDomChunks);
}

// ``part``: an (S, Q) scratch, S = polyfit_delta_dommax2d_chunks(D)
int polyfit_delta_dommax2d(const void* u, const void* v, const void* kx,
                           const void* ky, const void* w, void* out,
                           void* part, int Q, int D, double sentinel,
                           void* stream) {
  using namespace polyfit;
  if (Q <= 0) return (int)cudaGetLastError();
  return launch_delta_dommax2d<kDomThreads, kDomQueries, kDomTile>(
      u, v, kx, ky, w, out, part, Q, D, sentinel,
      walk_chunks<kDomTile>(D, kDomChunks), (cudaStream_t)stream);
}

}  // extern "C"
