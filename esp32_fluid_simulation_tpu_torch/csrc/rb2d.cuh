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
// colours in the other order than it would alone.  The mode is a template
// flag; without it the kernels compile to the code they had before.
//
// The kernels sit in an anonymous namespace: each .cu file that includes
// this header compiles its own copy, and the copies do not clash at link.

#pragma once

#include <cuda_runtime.h>

namespace {

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

// One half-sweep over the cells with (i + j) % 2 == color; thread (m, i)
// owns column j = 2m + ((i + color) & 1).  dxd holds dx * d.
template <bool MEMBER>
__global__ void sor_half_sweep_kernel(float* __restrict__ p,
                                      const float* __restrict__ dxd, int H,
                                      int W, int mh, int mw, int color,
                                      float omega, float one_m_w) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int j = 2 * m + ((i + color) & 1);
  if (i >= H || j >= W) return;
  const long c = (long)i * W + j;
  const Walls w = walls<MEMBER>(i, j, H, W, mh, mw);
  // zero ghosts beyond the walls
  const float up = w.i_lo ? 0.f : p[c - W];
  const float dn = w.i_hi ? 0.f : p[c + W];
  const float lf = w.j_lo ? 0.f : p[c - 1];
  const float rt = w.j_hi ? 0.f : p[c + 1];
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

// 2*iters half-sweeps, even parity first, in place on p (blocks of 32x8
// threads, half a row's width each); mh = 0 means no member tiling.
// Returns the first launch error.
inline cudaError_t sor_half_sweeps(float* p, const float* dxd, int H, int W,
                                   int mh, int mw, int iters, float omega,
                                   float one_m_w, cudaStream_t s) {
  const dim3 block(32, 8);
  const dim3 grid(((W + 1) / 2 + 31) / 32, (H + 7) / 8);
  for (int half = 0; half < 2 * iters; ++half) {
    if (mh > 0)
      sor_half_sweep_kernel<true><<<grid, block, 0, s>>>(
          p, dxd, H, W, mh, mw, half % 2, omega, one_m_w);
    else
      sor_half_sweep_kernel<false><<<grid, block, 0, s>>>(
          p, dxd, H, W, mh, mw, half % 2, omega, one_m_w);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
