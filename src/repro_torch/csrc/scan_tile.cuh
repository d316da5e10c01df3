// The tile walker of the whole-array scans (scan1d.cu K14, K15, K16 and
// K17, quantile.cu K4's scan mode, leaf_eval2d.cu K12 and K13, scan2d.cu
// K20): every slot of an array is compared with every query, from shared
// memory; and the PTX loop bodies of those scans and of K18 and K19.
//
//   walk_slots<W, TILE, STOP>(src, n, first, step, stop, smem, f)
//
// stages the tiles first, first + step, first + 2 step, ... of slots
// [0, n) of N <= W parallel arrays of type T (double, or float for K14's
// and K15's float32 plans) into shared memory (a block's share when
// ``step`` blocks split the array along the grid's second dimension), slot
// j's N words side by side in a W-word slot (W = 1: K14's segment starts;
// W = 2: a log's key and value, read back as one 16-byte shared load a
// slot; W = 4: K15's segment start, next start and aggregate and a word of
// padding, or K12's four membership bounds, read back as one or two
// 16-byte loads), TILE slots a tile.  The
// copies are asynchronous (cp.async, one word each) and double-buffered:
// the copy of the block's next tile is in flight while its threads compare
// against this one.  f(slot) runs on every staged slot in order (or
// f(slot, j), with the slot's index j in the array, where f takes it); a
// full tile runs a loop of compile-time length, the ragged last tile a
// loop of its own.  With STOP the walk ends before the first of its tiles
// whose word 0 equals ``stop``: on an array whose word 0 is sorted, or
// equal to the sentinel on a tail of padding only, no slot from there on
// can match a query below the sentinel (the DeltaBuffer log, whose tail
// holds value 0; a plan's segment table and flat leaf table).
//
// Every thread of the block must call it with the same arguments (it
// holds __syncthreads); ``smem`` holds 2 * TILE * W words, 16-byte
// aligned.  On return every copy has landed and the buffers are free.
//
//   walk_tiles<W, TILE, STOP>(src, n, first, step, stop, smem, f)
//
// is the same walk with each tile handed to f whole (K17 and K20, which
// vote on a tile before they pick its loop), and returns whether it
// stopped at the sentinel.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "locate.cuh"

namespace polyfit {

// one asynchronous copy of BYTES (4 or 8), global -> shared (through L1:
// every block of the grid reads the same array)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(gmem), "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four doubles read back as two 16-byte shared loads
struct double2x2 {
  double2 a, b;
};

// the type f receives: one slot of W words of T
template <typename T, int W>
struct Slot;
template <>
struct Slot<double, 1> {
  using type = double;
};
template <>
struct Slot<float, 1> {
  using type = float;
};
template <>
struct Slot<double, 2> {
  using type = double2;
};
template <>
struct Slot<double, 4> {
  using type = double2x2;
};
template <>
struct Slot<float, 4> {
  using type = float4;
};

// the words of a four-word slot
__device__ __forceinline__ void slot_words(const double2x2& s,
                                           double (&w)[4]) {
  w[0] = s.a.x;
  w[1] = s.a.y;
  w[2] = s.b.x;
  w[3] = s.b.y;
}

__device__ __forceinline__ void slot_words(const float4& s, float (&w)[4]) {
  w[0] = s.x;
  w[1] = s.y;
  w[2] = s.z;
  w[3] = s.w;
}

// K15's loop body (scan1d.cu) for one (query, segment) pair, in PTX:
// cl += lo <= l; where !(lo <= l) && nx <= u (the interior test
// lo > l && nx <= u for every l but NaN: the finish kernel empties a NaN
// lane's interior), ci += 1 and m = agg if agg > m.  Three compares (the
// second and third AND a predicate in), two predicated increments and a
// predicated move, which ptxas issues as two selects; a predicated
// max.f64 comes back from ptxas as NaN tests and selects.  A plan's
// aggregates hold no NaN, and of equal aggregates the first is kept
// (-0.0 against +0.0 included).
__device__ __forceinline__ void max_scan_step(int& cl, int& ci, double& m,
                                              double lo, double nx,
                                              double agg, double l,
                                              double u) {
  asm("{\n\t.reg .pred p, r, s;\n\t"
      "setp.le.f64 p, %3, %6;\n\t"
      "@p add.s32 %0, %0, 1;\n\t"
      "setp.le.and.f64 r, %4, %7, !p;\n\t"
      "@r add.s32 %1, %1, 1;\n\t"
      "setp.gt.and.f64 s, %5, %2, r;\n\t"
      "@s mov.f64 %2, %5;\n\t}"
      : "+r"(cl), "+r"(ci), "+d"(m)
      : "d"(lo), "d"(nx), "d"(agg), "d"(l), "d"(u));
}

__device__ __forceinline__ void max_scan_step(int& cl, int& ci, float& m,
                                              float lo, float nx, float agg,
                                              float l, float u) {
  asm("{\n\t.reg .pred p, r, s;\n\t"
      "setp.le.f32 p, %3, %6;\n\t"
      "@p add.s32 %0, %0, 1;\n\t"
      "setp.le.and.f32 r, %4, %7, !p;\n\t"
      "@r add.s32 %1, %1, 1;\n\t"
      "setp.gt.and.f32 s, %5, %2, r;\n\t"
      "@s mov.f32 %2, %5;\n\t}"
      : "+r"(cl), "+r"(ci), "+f"(m)
      : "f"(lo), "f"(nx), "f"(agg), "f"(l), "f"(u));
}

// K12's loop body (leaf_eval2d.cu) for one query and one leaf box
// [x0, x1) x [y0, y1), in PTX: the query's two x coordinates (ux, lx) and
// two y coordinates (uy, ly) are tested once each (8 compares, the second
// of each pair ANDing the first in), and corner e = (x[e & 1], y[e >> 1])
// takes the leaf's index j under the AND of its two tests (4 predicate
// ANDs and 4 predicated moves).  No first-hit test: at most one leaf of a
// plan's table holds a clamped corner.
__device__ __forceinline__ void corner_hits_step(int (&hit)[4],
                                                 const double (&x)[2],
                                                 const double (&y)[2],
                                                 const double2x2& box,
                                                 int j) {
  asm("{\n\t.reg .pred a, b, c, d, x0, x1, y0, y1, e0, e1, e2, e3;\n\t"
      "setp.le.f64 a, %5, %9;\n\t"
      "setp.lt.and.f64 x0, %9, %6, a;\n\t"
      "setp.le.f64 b, %5, %10;\n\t"
      "setp.lt.and.f64 x1, %10, %6, b;\n\t"
      "setp.le.f64 c, %7, %11;\n\t"
      "setp.lt.and.f64 y0, %11, %8, c;\n\t"
      "setp.le.f64 d, %7, %12;\n\t"
      "setp.lt.and.f64 y1, %12, %8, d;\n\t"
      "and.pred e0, x0, y0;\n\t"
      "and.pred e1, x1, y0;\n\t"
      "and.pred e2, x0, y1;\n\t"
      "and.pred e3, x1, y1;\n\t"
      "@e0 mov.b32 %0, %4;\n\t"
      "@e1 mov.b32 %1, %4;\n\t"
      "@e2 mov.b32 %2, %4;\n\t"
      "@e3 mov.b32 %3, %4;\n\t}"
      : "+r"(hit[0]), "+r"(hit[1]), "+r"(hit[2]), "+r"(hit[3])
      : "r"(j), "d"(box.a.x), "d"(box.a.y), "d"(box.b.x), "d"(box.b.y),
        "d"(x[0]), "d"(x[1]), "d"(y[0]), "d"(y[1]));
}

// K13's loop body (leaf_eval2d.cu) for one corner (x, y) and one leaf box
// [x0, x1) x [y0, y1), in PTX: four compares, each ANDing the one before
// in, and the leaf's index j moved under their AND.  No first-hit test: at
// most one leaf of a plan's table holds a clamped corner, and a NaN corner
// fails every compare.
__device__ __forceinline__ void corner_hit_step(int& hit, double x, double y,
                                                const double2x2& box, int j) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.le.f64 p, %2, %6;\n\t"
      "setp.lt.and.f64 p, %6, %3, p;\n\t"
      "setp.le.and.f64 p, %4, %7, p;\n\t"
      "setp.lt.and.f64 p, %7, %5, p;\n\t"
      "@p mov.b32 %0, %1;\n\t}"
      : "+r"(hit)
      : "r"(j), "d"(box.a.x), "d"(box.a.y), "d"(box.b.x), "d"(box.b.y),
        "d"(x), "d"(y));
}

// K17's loop body (scan1d.cu) for one (query, log slot) pair, in PTX:
// acc = v where l <= key && key <= u && v > acc.  Three compares, the
// second and third ANDing the one before in, and a predicated move; no NaN
// test (a NaN v fails v > acc, and a NaN acc is never replaced: K17 runs
// tiles that hold a NaN measure through jmax instead).  Of equal maxima
// the first is kept (-0.0 against +0.0 included).
__device__ __forceinline__ void member_max_step(double& acc, double key,
                                                double v, double l,
                                                double u) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.le.f64 p, %2, %1;\n\t"
      "setp.le.and.f64 p, %1, %3, p;\n\t"
      "setp.gt.and.f64 p, %4, %0, p;\n\t"
      "@p mov.f64 %0, %4;\n\t}"
      : "+d"(acc)
      : "d"(key), "d"(l), "d"(u), "d"(v));
}

// K20's loop body (scan2d.cu) for one (query, logged point) pair, in PTX:
// acc = w where x <= u && y <= v && w > acc.  member_max_step's three
// compares and predicated move on a dominance test: no NaN test (K20 runs
// tiles that hold a NaN measure through jmax), and a NaN acc is never
// replaced.  Of equal maxima the first is kept (-0.0 against +0.0
// included).
__device__ __forceinline__ void dominated_max_step(double& acc, double x,
                                                   double y, double w,
                                                   double u, double v) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.le.f64 p, %1, %4;\n\t"
      "setp.le.and.f64 p, %2, %5, p;\n\t"
      "setp.gt.and.f64 p, %3, %0, p;\n\t"
      "@p mov.f64 %0, %3;\n\t}"
      : "+d"(acc)
      : "d"(x), "d"(y), "d"(w), "d"(u), "d"(v));
}

// K19's loop body (scan2d.cu) for one (query, log slot) pair, in PTX: the
// slot's contribution, w where a <= j < b && ly < y && y <= uy, else +0.0.
// The slot's x test is the rank test a <= j < b on its index j (two
// integer compares: on the x-sorted log the slots with lx < x <= ux are
// [a, b)), then the two y compares, each ANDing the one before in, and a
// select: two f64 instructions, the add (the caller's) a third.  Nothing
// here reads the sum, so a group of slots' contributions can be formed
// ahead of its chain of adds; adding +0.0 changes no sum that starts at
// +0.0, so the adds equal the plain version's, which adds where(member, w,
// 0.0) for every slot in slot order.
__device__ __forceinline__ double rank_member(int j, int a, int b, double ly,
                                              double uy, double y, double w) {
  double v;
  asm("{\n\t.reg .pred p;\n\t"
      "setp.ge.s32 p, %1, %2;\n\t"
      "setp.lt.and.s32 p, %1, %3, p;\n\t"
      "setp.lt.and.f64 p, %4, %6, p;\n\t"
      "setp.le.and.f64 p, %6, %5, p;\n\t"
      "selp.f64 %0, %7, 0d0000000000000000, p;\n\t}"
      : "=d"(v)
      : "r"(j), "r"(a), "r"(b), "d"(ly), "d"(uy), "d"(y), "d"(w));
  return v;
}

// K18's loop body (scan2d.cu) for one (rectangle, log slot) pair, in PTX:
// c += 1 where a <= j < b && ly < y && y <= uy.  rank_member's two integer
// and two f64 compares, each ANDing the one before in, and an increment
// under their AND: the FP64 pipe does the two y compares only.  A count is
// exact in any order, so nothing orders the increments but the counter.
__device__ __forceinline__ void rank_count_step(int& c, int j, int a, int b,
                                                double ly, double uy,
                                                double y) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.ge.s32 p, %1, %2;\n\t"
      "setp.lt.and.s32 p, %1, %3, p;\n\t"
      "setp.lt.and.f64 p, %4, %6, p;\n\t"
      "setp.le.and.f64 p, %6, %5, p;\n\t"
      "@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(c)
      : "r"(j), "r"(a), "r"(b), "d"(ly), "d"(uy), "d"(y));
}

// K18's loop body in groups (scan2d.cu): one rectangle against the G <= 32
// consecutive log slots j0 .. j0 + G - 1 whose y are ``y[0 .. G)``.  The
// rank test a <= j < b runs once for the group, as the mask of its slots
// in [a, b) (a few integer operations; a = INT_MAX, b = 0 for an empty
// range give an empty mask); each slot then costs its two y compares (in
// PTX, the second ANDing the first in) and its bit set under their AND;
// c += the popcount of the two masks' AND.
template <int G>
__device__ __forceinline__ void rank_count_group(int& c, int j0, int a, int b,
                                                 double ly, double uy,
                                                 const double* y) {
  static_assert(G >= 1 && G <= 32, "a group's slots are bits of a word");
  const int lo = min(max(a - j0, 0), G), hi = min(max(b - j0, 0), G);
  const unsigned in =
      (unsigned)(((1ull << hi) - 1ull) & ~((1ull << lo) - 1ull));
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < G; ++k)
    asm("{\n\t.reg .pred p;\n\t"
        "setp.lt.f64 p, %2, %4;\n\t"
        "setp.le.and.f64 p, %4, %3, p;\n\t"
        "@p or.b32 %0, %0, %1;\n\t}"
        : "+r"(m)
        : "r"(1u << k), "d"(ly), "d"(uy), "d"(y[k]));
  c += __popc(m & in);
}

// The combine of K17 and K20: the S chunk maxima of each query (rows of an
// (S, Q) ``part``) taken in chunk order by jmax (a NaN chunk gives NaN), so
// two launches give the same bits
template <typename T>
__global__ void chunk_max_combine_kernel(const T* __restrict__ part,
                                         T* __restrict__ out, int Q, int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  T acc = part[i];
  for (int s = 1; s < S; ++s) acc = jmax(acc, part[(size_t)s * Q + i]);
  out[i] = acc;
}

// f(s, j) where f takes the slot's index, else f(s)
template <typename F, typename S>
__device__ __forceinline__ void visit_slot(F& f, const S& s, int j) {
  if constexpr (std::is_invocable_v<F&, const S&, int>) {
    f(s, j);
  } else {
    f(s);
  }
}

// bytes of dynamic shared memory walk_slots<W, TILE> needs over T
template <int W, int TILE, typename T = double>
constexpr int walk_smem_bytes() {
  return 2 * TILE * W * (int)sizeof(T);
}

// the chunks (grid rows) that split an n-slot array of TILE-slot tiles:
// at most ``most``, and no more than there are tiles
template <int TILE>
inline int walk_chunks(int n, int most) {
  const int tiles = (n + TILE - 1) / TILE;
  return tiles < most ? (tiles > 0 ? tiles : 1) : most;
}

template <int W, int TILE, bool STOP, typename T, int N, typename F>
__device__ __forceinline__ void walk_slots(const T* const (&src)[N], int n,
                                           int first, int step, double stop,
                                           T* smem, F&& f) {
  static_assert(N <= W, "a slot holds a word of each array");
  using S = typename Slot<T, W>::type;
  const int tiles = (n + TILE - 1) / TILE;
  auto stage = [&](int t, int buf) {
    T* dst = smem + buf * (TILE * W);
    const int base = t * TILE;
    const int m = n - base < TILE ? n - base : TILE;
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
#pragma unroll
      for (int w = 0; w < N; ++w)
        cp_async<sizeof(T)>(dst + j * W + w, src[w] + base + j);
    }
    cp_async_commit();
  };
  if (first < tiles) stage(first, 0);
  for (int t = first, it = 0; t < tiles; t += step, ++it) {
    // an empty group past the last tile keeps wait_group<1> exact
    if (t + step < tiles) stage(t + step, (it + 1) & 1);
    else cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* tile = smem + (it & 1) * (TILE * W);
    if (STOP && tile[0] == (T)stop) break;   // the same word for every thread
    const S* slots = reinterpret_cast<const S*>(tile);
    const int base = t * TILE;
    const int m = n - base;
    if (m >= TILE) {
#pragma unroll 8
      for (int k = 0; k < TILE; ++k) visit_slot(f, slots[k], base + k);
    } else {
      for (int k = 0; k < m; ++k) visit_slot(f, slots[k], base + k);
    }
    __syncthreads();   // this buffer is restaged two tiles on
  }
  cp_async_wait<0>();
  __syncthreads();
}

// walk_slots with the tile handed to f whole: f(tile, m) runs once a tile
// on every thread of the block, with the tile's first slot in shared
// memory and its slot count m (TILE, or fewer on the ragged last tile),
// and may hold __syncthreads.  Returns whether the walk ended at a tile
// that starts on ``stop`` (with STOP), that is whether it skipped tiles.
template <int W, int TILE, bool STOP, typename T, int N, typename F>
__device__ __forceinline__ bool walk_tiles(const T* const (&src)[N], int n,
                                           int first, int step, double stop,
                                           T* smem, F&& f) {
  static_assert(N <= W, "a slot holds a word of each array");
  using S = typename Slot<T, W>::type;
  const int tiles = (n + TILE - 1) / TILE;
  auto stage = [&](int t, int buf) {
    T* dst = smem + buf * (TILE * W);
    const int base = t * TILE;
    const int m = n - base < TILE ? n - base : TILE;
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
#pragma unroll
      for (int w = 0; w < N; ++w)
        cp_async<sizeof(T)>(dst + j * W + w, src[w] + base + j);
    }
    cp_async_commit();
  };
  bool stopped = false;
  if (first < tiles) stage(first, 0);
  for (int t = first, it = 0; t < tiles; t += step, ++it) {
    // an empty group past the last tile keeps wait_group<1> exact
    if (t + step < tiles) stage(t + step, (it + 1) & 1);
    else cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* tile = smem + (it & 1) * (TILE * W);
    if (STOP && tile[0] == (T)stop) {   // the same word for every thread
      stopped = true;
      break;
    }
    const int m = n - t * TILE;
    f(reinterpret_cast<const S*>(tile), m < TILE ? m : TILE);
    __syncthreads();   // this buffer is restaged two tiles on
  }
  cp_async_wait<0>();
  __syncthreads();
  return stopped;
}

}  // namespace polyfit
