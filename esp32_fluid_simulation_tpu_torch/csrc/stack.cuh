// An ensemble's member stack as the tiled-domain modes (K6) of K1 and K2
// address it in place.  The stack holds n = gh * gw members of mh x mw
// cells, row-major over a gh x gw tiling, each member's C channel planes
// together: [n, C, mh, mw].  The kernels keep every coordinate, wall,
// clamp and colour on the supergrid of the tiles, [C, gh*mh, gw*mw], and
// only the address of a cell moves: supergrid cell (i, j) of channel ch
// lies at row(i) + col(j) + ch * plane, where (W = gw * mw)
//   row(i) = (i / mh) * C * mh * W + (i % mh) * mw,
//   col(j) = (j / mw) * C * mh * mw + j % mw,
//   plane  = mh * mw;
// on the supergrid itself (STACK false) row(i) = i * W, col(j) = j and
// plane = H * W, so a kernel with the flag off compiles to the code it had
// without it.  A row of a member is mw contiguous values in either layout,
// so a warp's loads and stores along a row stay coalesced.  The kernels
// keep divisions off their loads' paths: K2 walks each member's own rows
// and columns, K1's trapezoid reads its window's offsets from tables.  The
// two layouts hold the same cells: a kernel on the stack writes, bit for
// bit, the supergrid kernel's output laid out as a stack.

#pragma once

namespace {

template <bool STACK>
__device__ __forceinline__ long plane_of(int H, int W, int mh, int mw) {
  return STACK ? (long)mh * mw : (long)H * W;
}

// A tile's window in a member stack (K1's trapezoid), kept in shared
// memory so that its loops take an address from a table instead of a
// division a row: window row a (array row ai0 + a, clamped into the array)
// lies at C * rq[a] + rr[a] for C channels, window column b (array column
// aj0 + b, clamped) at C * cq[b] + cr[b].  The offsets are ints: the
// wrappers keep a stack under 2^31 values.
struct StackWindow {
  int* rq;
  int* rr;
  int* cq;
  int* cr;

  __device__ __forceinline__ int row(int a, int C) const {
    return C * rq[a] + rr[a];
  }
  __device__ __forceinline__ int col(int b, int C) const {
    return C * cq[b] + cr[b];
  }
};

// Fill w's tables for `rows` window rows and `cols` window columns of an H x
// W supergrid of mh x mw members, by every thread of the block; the caller
// synchronises.
__device__ void stack_window_init(const StackWindow& w, int rows, int cols,
                                  int ai0, int aj0, int H, int W, int mh,
                                  int mw) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int a = tid; a < rows; a += nthreads) {
    const int i = min(max(ai0 + a, 0), H - 1), q = i / mh;
    w.rq[a] = q * mh * W;
    w.rr[a] = (i - q * mh) * mw;
  }
  for (int b = tid; b < cols; b += nthreads) {
    const int j = min(max(aj0 + b, 0), W - 1), q = j / mw;
    w.cq[b] = q * mh * mw;
    w.cr[b] = j - q * mw;
  }
}

// The bytes a window of `rows` x `cols` adds to a block's shared memory
// for its tables (and 4-byte alignment).
inline int stack_window_bytes(int rows, int cols) {
  return 3 + 8 * (rows + cols);
}

}  // namespace
