// The 2D red-black SOR cell update shared by K1 (csrc/project.cu) and K4
// (csrc/sor.cu), so the two solves cannot drift apart, the wall test both
// use, and the two ways they run the half-sweeps: one launch per
// half-sweep over a field in device memory (sor_half_sweep_kernel, the
// routes above 15 iters), or all of them inside one block on a tile's
// window in shared memory (rb_window_half_sweeps, the window routes).
//
// Semantics of ops/poisson.py (poisson.cpp:63-112): neighbours summed
// ((up + dn) + lf) + rt with zero ghosts, the Neumann diagonal through the
// -1/a_ii LUT of double divisions rounded to float (a_ii = in-bounds
// neighbour count), update (1-w) p + w (neg_inv (dxd - nb)).  In place is
// exact red-black Gauss-Seidel: a half-sweep updates only one colour, and
// same-colour cells never read each other.
//
// Tiled-domain mode (K6, the member= argument of the TPU kernels,
// rb_common.py:145-176): every mh x mw member tile of the grid is a domain
// of its own.  Its walls are where the grid's are without a member: the
// neighbour sums read 0 across them and a_ii counts member-local
// neighbours.  The colour stays the parity of the whole grid, (i + j) % 2,
// as in the TPU kernel: a member whose origin has odd oi + oj sweeps its
// colours in the other order than it would alone.
//
// Block mode (K11, the global_offset= argument of the TPU kernels,
// sor.py:61-76, project.py:103-120): the array is one shard's block with a
// halo, whose cell (0, 0) sits at global (oi, oj) of a GH x GW domain (oi,
// oj < 0 on an edge shard).  Walls, a_ii and the colour (gi + gj) & 1 come
// from the global coordinates; the "read 0" test and a_ii come apart: a
// neighbour beyond the array reads 0 (the TPU window's zero padding), a_ii
// counts only the global walls, and cells outside the domain are never
// updated (they hold the fill's 0).  Wrong values in the outer ring travel
// one cell per half-sweep and never reach the owned block while the halo
// is at least the number of half-sweeps.
//
// The window (K1's and K4's route for iters <= 15, the TPU kernel's
// trapezoid, project.py:35-191): a block owns a tile of the output and
// holds p and dx*d on the tile +- R in shared memory, R = 2*iters + 1 for
// K1 and 2*iters for K4.  Half-sweep k (1-based) updates only the tile +-
// (R - k): the cells whose value still reaches the tile +- (R - 2*iters)
// (K1's gradient reads the tile +- 1), so the cells it leaves behind never
// matter.  The window is stored split by colour, the
// packed layout of rb_common.py:55-107: plane c holds the colour-c cells of
// window row a at column b >> 1, so a half-sweep reads its four neighbours
// from the other plane at consecutive words, without bank conflicts.
//
// The modes are template flags; without them the kernels compile to the
// code they had before.  The kernels sit in an anonymous namespace: each
// .cu file that includes this header compiles its own copy, and the copies
// do not clash at link.

#pragma once

#include <cuda_runtime.h>

namespace {

// Where an array lies in its domain: its rows x cols, the global position
// of its cell (0, 0) and the domain's extent (oi = oj = 0 and GH, GW = H, W
// without block mode), and the member tile (mh = 0: none).
struct Geom {
  int H, W, oi, oj, GH, GW, mh, mw;
};

// The four walls around cell (i, j): those of the H x W grid, or with
// MEMBER those of the cell's mh x mw member tile (mh, mw divide H, W).
struct Walls {
  bool i_lo, i_hi, j_lo, j_hi;
};

template <bool MEMBER>
__device__ __forceinline__ Walls walls(int i, int j, int H, int W, int mh,
                                       int mw) {
  if constexpr (MEMBER) {
    const int im = i % mh;
    const int jm = j % mw;
    return {im == 0, im == mh - 1, jm == 0, jm == mw - 1};
  } else {
    return {i == 0, i == H - 1, j == 0, j == W - 1};
  }
}

__device__ __forceinline__ bool in_domain(int gi, int gj, const Geom& g) {
  return gi >= 0 && gi < g.GH && gj >= 0 && gj < g.GW;
}

// -1/a_ii for a cell with n_walls walls: a_ii = 4 - n_walls is the
// in-bounds neighbour count, and the LUT holds double divisions rounded to
// float (poisson.cpp:67).
__device__ __forceinline__ float rb_neg_inv(int n_walls) {
  const int aii = 4 - n_walls;
  return aii == 4   ? (float)(-1.0 / 4.0)
         : aii == 3 ? (float)(-1.0 / 3.0)
         : aii == 2 ? (float)(-1.0 / 2.0)
                    : -1.f;
}

// The SOR update of one cell from its four neighbours (0 beyond a wall),
// its dx*d and its -1/a_ii: the sum ((up + dn) + lf) + rt, then (1-w) p +
// w (neg_inv (dx*d - nb)).
__device__ __forceinline__ float rb_cell(float pc, float up, float dn,
                                         float lf, float rt, float dxd,
                                         float neg_inv, float omega,
                                         float one_m_w) {
  const float nb = ((up + dn) + lf) + rt;
  return one_m_w * pc + omega * (neg_inv * (dxd - nb));
}

// One half-sweep over the cells with (gi + gj) % 2 == color; thread (m, i)
// owns column j = 2m + ((i + oi + oj + color) & 1).  dxd holds dx * d.
template <bool MEMBER, bool BLOCK>
__global__ void sor_half_sweep_kernel(float* __restrict__ p,
                                      const float* __restrict__ dxd,
                                      const Geom g, int color, float omega,
                                      float one_m_w) {
  const int W = g.W;
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  // & 1, not %: oi + oj is negative on an edge shard
  const int j = 2 * m + ((BLOCK ? i + g.oi + g.oj + color : i + color) & 1);
  if (i >= g.H || j >= W) return;
  const int gi = BLOCK ? i + g.oi : i;
  const int gj = BLOCK ? j + g.oj : j;
  if (BLOCK && !in_domain(gi, gj, g)) return;  // held at 0
  const long c = (long)i * W + j;
  const Walls w = walls<MEMBER>(gi, gj, g.GH, g.GW, g.mh, g.mw);
  // zero ghosts beyond the walls (and beyond the array in block mode)
  const float up = (w.i_lo || (BLOCK && i == 0)) ? 0.f : p[c - W];
  const float dn = (w.i_hi || (BLOCK && i == g.H - 1)) ? 0.f : p[c + W];
  const float lf = (w.j_lo || (BLOCK && j == 0)) ? 0.f : p[c - 1];
  const float rt = (w.j_hi || (BLOCK && j == W - 1)) ? 0.f : p[c + 1];
  p[c] = rb_cell(p[c], up, dn, lf, rt, dxd[c],
                 rb_neg_inv(w.i_lo + w.i_hi + w.j_lo + w.j_hi), omega,
                 one_m_w);
}

template <bool MEMBER, bool BLOCK>
cudaError_t half_sweeps(float* p, const float* dxd, const Geom& g, int iters,
                        float omega, float one_m_w, cudaStream_t s) {
  const dim3 block(32, 8);
  // a row's cells of one colour: at most (W + 1) / 2 of them
  const dim3 grid(((g.W + 1) / 2 + 31) / 32, (g.H + 7) / 8);
  for (int half = 0; half < 2 * iters; ++half) {
    sor_half_sweep_kernel<MEMBER, BLOCK><<<grid, block, 0, s>>>(
        p, dxd, g, half % 2, omega, one_m_w);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// 2*iters half-sweeps, even parity first, in place on p (blocks of 32x8
// threads, half a row's width each), in the modes g asks for.  Returns the
// first launch error.
template <bool BLOCK>
cudaError_t sor_half_sweeps(float* p, const float* dxd, const Geom& g,
                            int iters, float omega, float one_m_w,
                            cudaStream_t s) {
  if (g.mh > 0)
    return half_sweeps<true, BLOCK>(p, dxd, g, iters, omega, one_m_w, s);
  return half_sweeps<false, BLOCK>(p, dxd, g, iters, omega, one_m_w, s);
}

// Flags of a window row (or column): its walls and whether it lies outside
// the domain or the array (its cells hold p = 0 and are never updated).
constexpr unsigned char kWallLo = 1, kWallHi = 2, kOutside = 4;

// A window's planes are kWindowPitch words wide: 32 plane columns per lane
// and chunk, kChunks chunks (windows of at most 2 * kWindowPitch columns).
constexpr int kChunks = 3;
constexpr int kWindowPitch = 32 * kChunks;

// A tile's window in shared memory: rows x cols cells split by colour
// ((a + b + base) & 1 for window cell (a, b)), plane c of p at p + c *
// stride holding window row a's colour-c cells at a * kWindowPitch +
// (b >> 1); dx*d likewise at dxd.  row_flags[a] and col_flags[b] hold the
// flags above.
struct RbWindow {
  float* p;
  float* dxd;
  const unsigned char* row_flags;
  const unsigned char* col_flags;
  int rows, cols, stride, base;
};

// The window's row and column flags (walls from the global coordinates,
// or the member tiles'; kOutside outside the domain or the array) into
// row_flags and col_flags (w's, writable), and p = 0.  Window cell (a, b)
// is array cell (ai0 + a, aj0 + b).  The caller synchronises.
template <bool MEMBER>
__device__ void rb_window_init(const RbWindow& w, unsigned char* row_flags,
                               unsigned char* col_flags, const Geom& g,
                               int ai0, int aj0) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int a = tid; a < w.rows; a += nthreads) {
    const int i = ai0 + a, gi = g.oi + i;
    unsigned char f = kOutside;
    if (i >= 0 && i < g.H && gi >= 0 && gi < g.GH) {
      const Walls wl = walls<MEMBER>(gi, 0, g.GH, g.GW, g.mh, g.mw);
      f = (wl.i_lo ? kWallLo : 0) | (wl.i_hi ? kWallHi : 0);
    }
    row_flags[a] = f;
  }
  for (int b = tid; b < w.cols; b += nthreads) {
    const int j = aj0 + b, gj = g.oj + j;
    unsigned char f = kOutside;
    if (j >= 0 && j < g.W && gj >= 0 && gj < g.GW) {
      const Walls wl = walls<MEMBER>(0, gj, g.GH, g.GW, g.mh, g.mw);
      f = (wl.j_lo ? kWallLo : 0) | (wl.j_hi ? kWallHi : 0);
    }
    col_flags[b] = f;
  }
  for (int q = tid; q < 2 * w.stride; q += nthreads) w.p[q] = 0.f;
}

// A window route's plane stride (planes 16 banks apart) and its
// shared-memory bytes (p and dx*d, then the flags) for TH x TW tiles with a
// window of the tile +- R; cols = 0 if the window is wider than the planes.
struct WindowShape {
  int cols, stride, bytes;
};

inline WindowShape window_shape(int TH, int TW, int R) {
  const int rows = TH + 2 * R;
  const int cols = TW + 2 * R;
  const int stride = rows * kWindowPitch + 16;
  return {cols <= 2 * kWindowPitch ? cols : 0, stride,
          (int)(4 * stride * sizeof(float)) + rows + cols};
}

// The window's cell (a, b) of p, and of dx*d.
__device__ __forceinline__ float& rb_at(const RbWindow& w, int a, int b) {
  return w.p[((a + b + w.base) & 1) * w.stride + a * kWindowPitch +
             (b >> 1)];
}

__device__ __forceinline__ float& rb_dxd_at(const RbWindow& w, int a, int b) {
  return w.dxd[((a + b + w.base) & 1) * w.stride + a * kWindowPitch +
               (b >> 1)];
}

// One row's colour-c cells for rb_window_half_sweeps: row a's cells sit
// at b = 2m + S, their other horizontal neighbour at m - 1 (S = 0) or
// m + 1 (S = 1).  ROW_WALLS: the row has a wall; COL_WALLS: some column of
// the window has one.  po, pc and dc point at column `lane` of row a of
// the other plane, this plane and dx*d; above and here hold the other
// plane's rows a - 1 and a of the lane's columns and move down a row.
// col[j] holds column chunk j's wall flags for S = 0 in bits 0-3 and S = 1
// in bits 4-7, neg[j][S] its -1/a_ii without row walls; only m in [lo,
// hi) is updated.
template <int S, bool ROW_WALLS, bool COL_WALLS>
__device__ __forceinline__ void rb_window_row(
    const float* po, float* pc, const float* dc, int lane, int lo, int hi,
    int rf, const int (&col)[kChunks], const float (&neg)[kChunks][2],
    float (&above)[kChunks], float (&here)[kChunks], float omega,
    float one_m_w) {
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int m = lane + 32 * j;
    const float below = po[kWindowPitch + 32 * j];
    const float side = po[32 * j + 2 * S - 1];
    const int cf = (col[j] >> (4 * S)) & 15;
    float lf = S ? here[j] : side;
    float rt = S ? side : here[j];
    if (COL_WALLS) {
      lf = (cf & kWallLo) ? 0.f : lf;
      rt = (cf & kWallHi) ? 0.f : rt;
    }
    const float up = (ROW_WALLS && (rf & kWallLo)) ? 0.f : above[j];
    const float dn = (ROW_WALLS && (rf & kWallHi)) ? 0.f : below;
    float neg_inv = (float)(-1.0 / 4.0);
    if (ROW_WALLS)
      neg_inv = rb_neg_inv((rf & kWallLo) + ((rf & kWallHi) >> 1) +
                           (cf & kWallLo) + ((cf & kWallHi) >> 1));
    else if (COL_WALLS)
      neg_inv = neg[j][S];
    const float v = rb_cell(pc[32 * j], up, dn, lf, rt, dc[32 * j], neg_inv,
                            omega, one_m_w);
    if (m >= lo && m < hi) pc[32 * j] = v;
    above[j] = here[j];
    here[j] = below;
  }
}

// The rows [a0, a1) of half-sweep k (colour c) for one warp: a row's
// colour-c cells are b = 2m + s, s = (c + a + base) & 1, and m runs over
// [lo[s], hi[s]).
template <bool COL_WALLS>
__device__ __forceinline__ void rb_window_rows(
    const RbWindow& w, int c, int a0, int a1, const int (&lo)[2],
    const int (&hi)[2], const int (&col)[kChunks],
    const float (&neg)[kChunks][2], float omega, float one_m_w) {
  const int lane = threadIdx.x;
  const int first = a0 * kWindowPitch + lane;
  const float* po = w.p + (1 - c) * w.stride + first;
  float* pc = w.p + c * w.stride + first;
  const float* dc = w.dxd + c * w.stride + first;
  float above[kChunks], here[kChunks];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    above[j] = po[32 * j - kWindowPitch];
    here[j] = po[32 * j];
  }
  int s = (c + a0 + w.base) & 1;
  for (int a = a0; a < a1; ++a) {
    const int rf = w.row_flags[a];
    if (rf == 0) {  // no wall, inside: the common row
      if (s == 0)
        rb_window_row<0, false, COL_WALLS>(po, pc, dc, lane, lo[0], hi[0],
                                           rf, col, neg, above, here, omega,
                                           one_m_w);
      else
        rb_window_row<1, false, COL_WALLS>(po, pc, dc, lane, lo[1], hi[1],
                                           rf, col, neg, above, here, omega,
                                           one_m_w);
    } else {
      // an outside row updates nothing and only moves down
      const int h = (rf & kOutside) ? 0 : hi[s];
      if (s == 0)
        rb_window_row<0, true, COL_WALLS>(po, pc, dc, lane, lo[0], h, rf,
                                          col, neg, above, here, omega,
                                          one_m_w);
      else
        rb_window_row<1, true, COL_WALLS>(po, pc, dc, lane, lo[1], h, rf,
                                          col, neg, above, here, omega,
                                          one_m_w);
    }
    s ^= 1;
    po += kWindowPitch;
    pc += kWindowPitch;
    dc += kWindowPitch;
  }
}

// `sweeps` half-sweeps on the window, even global parity first, by every
// thread of the block (blockDim.x = 32); half-sweep k (1-based) updates
// rows and columns [k, rows - k) x [k, cols - k).  Lane l owns plane
// columns m = l + 32 j for the whole solve, and each warp walks a run of
// the half-sweep's rows down those columns, keeping the other plane's
// cells above, beside and below in registers: per cell it reads the cell
// below, one horizontal neighbour, p and dx*d, and writes p.  Rows and
// windows without walls take code without the wall tests.  Ends with the
// block synchronised.
__device__ void rb_window_half_sweeps(const RbWindow& w, int sweeps,
                                      float omega, float one_m_w) {
  const int lane = threadIdx.x;
  // the columns inside the domain and the array, [b_lo, b_hi), and
  // whether any has a wall
  __shared__ int b_range[3];
  if (threadIdx.y == 0) {
    int lo = w.cols, hi = 0, walled = 0;
    for (int b = lane; b < w.cols; b += 32) {
      const int f = w.col_flags[b];
      if (!(f & kOutside)) {
        lo = min(lo, b);
        hi = max(hi, b + 1);
        walled |= f & (kWallLo | kWallHi);
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
      walled |= __shfl_xor_sync(0xffffffffu, walled, o);
    }
    if (lane == 0) {
      b_range[0] = lo;
      b_range[1] = hi;
      b_range[2] = walled;
    }
  }
  int col[kChunks];
  float neg[kChunks][2];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int b = 2 * (lane + 32 * j);
    const int f0 = b < w.cols ? w.col_flags[b] : kOutside;
    const int f1 = b + 1 < w.cols ? w.col_flags[b + 1] : kOutside;
    col[j] = f0 | f1 << 4;
    neg[j][0] = rb_neg_inv((f0 & kWallLo) + ((f0 & kWallHi) >> 1));
    neg[j][1] = rb_neg_inv((f1 & kWallLo) + ((f1 & kWallHi) >> 1));
  }
  __syncthreads();
  const int b_lo = b_range[0], b_hi = b_range[1];
  const bool col_walls = b_range[2] != 0;
  for (int k = 1; k <= sweeps; ++k) {
    const int c = (k - 1) & 1;
    // the warps share the rows [k, rows - k) evenly
    const int n = w.rows - 2 * k;
    const int a0 = k + n * (int)threadIdx.y / (int)blockDim.y;
    const int a1 = k + n * ((int)threadIdx.y + 1) / (int)blockDim.y;
    // b = 2m + s in [max(k, b_lo), min(cols - k, b_hi))
    const int lo[2] = {(max(k, b_lo) + 1) >> 1, max(k, b_lo) >> 1};
    const int hi[2] = {(min(w.cols - k, b_hi) + 1) >> 1,
                       min(w.cols - k, b_hi) >> 1};
    if (a0 < a1) {
      if (col_walls)
        rb_window_rows<true>(w, c, a0, a1, lo, hi, col, neg, omega,
                             one_m_w);
      else
        rb_window_rows<false>(w, c, a0, a1, lo, hi, col, neg, omega,
                              one_m_w);
    }
    __syncthreads();
  }
}

}  // namespace
