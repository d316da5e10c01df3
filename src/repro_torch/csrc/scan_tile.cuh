// The tile walker of the one-key whole-array scans (scan1d.cu K16,
// quantile.cu K4's scan mode): every slot of a sorted one-key array is
// compared with every query, from shared memory.
//
//   walk_slots<W, TILE, STOP>(src, n, first, step, stop, smem, f)
//
// stages the tiles first, first + step, first + 2 step, ... of slots
// [0, n) of W parallel double arrays into shared memory (a block's share
// when ``step`` blocks split the array along the grid's second dimension),
// slot j's W words side by side (W = 2: a log's key and value, read back
// as one 16-byte shared load a slot), TILE slots a tile.  The copies are
// asynchronous (cp.async, 8 bytes each) and double-buffered: the copy of
// the block's next tile is in flight while its threads compare against
// this one.  f(slot) runs on every staged slot in order, on a double
// (W = 1) or a double2 (W = 2); a full tile runs a loop of compile-time
// length, the ragged last tile a loop of its own.  With STOP the walk ends
// before the first of its tiles whose first key (word 0) equals ``stop``:
// on a sorted log whose tail holds the sentinel key with value 0 (the
// DeltaBuffer layout) no slot from there on can add anything.
//
// Every thread of the block must call it with the same arguments (it
// holds __syncthreads); ``smem`` holds 2 * TILE * W doubles, 16-byte
// aligned.  On return every copy has landed and the buffers are free.
#pragma once

#include <cuda_runtime.h>

namespace polyfit {

// one 8-byte asynchronous copy, global -> shared (through L1: every block
// of the grid reads the same array)
__device__ __forceinline__ void cp_async_8(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(gmem)
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

// c += (x < q) and c += (x <= q): an f64 compare and an increment under
// its predicate, written in PTX (the C++ `c += x < q` becomes a compare, a
// select and an add)
__device__ __forceinline__ void count_lt(int& c, double x, double q) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.lt.f64 p, %1, %2;\n\t"
      "@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(c)
      : "d"(x), "d"(q));
}

__device__ __forceinline__ void count_le(int& c, double x, double q) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.le.f64 p, %1, %2;\n\t"
      "@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(c)
      : "d"(x), "d"(q));
}

template <int W>
struct Slot;
template <>
struct Slot<1> {
  using type = double;
};
template <>
struct Slot<2> {
  using type = double2;
};

// bytes of dynamic shared memory walk_slots<W, TILE> needs
template <int W, int TILE>
constexpr int walk_smem_bytes() {
  return 2 * TILE * W * (int)sizeof(double);
}

// the chunks (grid rows) that split an n-slot array of TILE-slot tiles:
// at most ``most``, and no more than there are tiles
template <int TILE>
inline int walk_chunks(int n, int most) {
  const int tiles = (n + TILE - 1) / TILE;
  return tiles < most ? (tiles > 0 ? tiles : 1) : most;
}

template <int W, int TILE, bool STOP, typename F>
__device__ __forceinline__ void walk_slots(const double* const (&src)[W],
                                           int n, int first, int step,
                                           double stop, double* smem, F&& f) {
  using S = typename Slot<W>::type;
  const int tiles = (n + TILE - 1) / TILE;
  auto stage = [&](int t, int buf) {
    double* dst = smem + buf * (TILE * W);
    const int base = t * TILE;
    const int m = n - base < TILE ? n - base : TILE;
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
#pragma unroll
      for (int w = 0; w < W; ++w) cp_async_8(dst + j * W + w, src[w] + base + j);
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
    const double* tile = smem + (it & 1) * (TILE * W);
    if (STOP && tile[0] == stop) break;   // the same word for every thread
    const S* slots = reinterpret_cast<const S*>(tile);
    const int m = n - t * TILE;
    if (m >= TILE) {
#pragma unroll 8
      for (int k = 0; k < TILE; ++k) f(slots[k]);
    } else {
      for (int k = 0; k < m; ++k) f(slots[k]);
    }
    __syncthreads();   // this buffer is restaged two tiles on
  }
  cp_async_wait<0>();
  __syncthreads();
}

}  // namespace polyfit
