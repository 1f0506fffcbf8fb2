// The 2D red-black SOR half-sweep shared by K1 (csrc/project.cu) and K4
// (csrc/sor.cu), so the two solves cannot drift apart, and the wall test
// both use.
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
  const float nb = ((up + dn) + lf) + rt;
  // -1/a_ii with a_ii the in-bounds neighbour count, a LUT of double
  // divisions rounded to float (poisson.cpp:67)
  const int aii = 4 - w.i_lo - w.i_hi - w.j_lo - w.j_hi;
  const float neg_inv = aii == 4   ? (float)(-1.0 / 4.0)
                        : aii == 3 ? (float)(-1.0 / 3.0)
                        : aii == 2 ? (float)(-1.0 / 2.0)
                                   : -1.f;
  p[c] = one_m_w * p[c] + omega * (neg_inv * (dxd[c] - nb));
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

}  // namespace
