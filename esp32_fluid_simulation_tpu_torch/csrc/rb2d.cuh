// The 2D red-black SOR half-sweep shared by K1 (csrc/project.cu) and K4
// (csrc/sor.cu), so the two solves cannot drift apart.
//
// Semantics of ops/poisson.py (poisson.cpp:63-112): neighbours summed
// ((up + dn) + lf) + rt with zero ghosts, the Neumann diagonal through the
// -1/a_ii LUT of double divisions rounded to float (a_ii = in-bounds
// neighbour count), update (1-w) p + w (neg_inv (dxd - nb)).  In place is
// exact red-black Gauss-Seidel: a half-sweep updates only one colour, and
// same-colour cells never read each other.
//
// The kernel sits in an anonymous namespace: each .cu file that includes
// this header compiles its own copy, and the copies do not clash at link.

#pragma once

#include <cuda_runtime.h>

namespace {

// One half-sweep over the cells with (i + j) % 2 == color; thread (m, i)
// owns column j = 2m + ((i + color) & 1).  dxd holds dx * d.
__global__ void sor_half_sweep_kernel(float* __restrict__ p,
                                      const float* __restrict__ dxd, int H,
                                      int W, int color, float omega,
                                      float one_m_w) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int j = 2 * m + ((i + color) & 1);
  if (i >= H || j >= W) return;
  const long c = (long)i * W + j;
  // zero ghosts outside the domain
  const float up = i > 0 ? p[c - W] : 0.f;
  const float dn = i < H - 1 ? p[c + W] : 0.f;
  const float lf = j > 0 ? p[c - 1] : 0.f;
  const float rt = j < W - 1 ? p[c + 1] : 0.f;
  const float nb = ((up + dn) + lf) + rt;
  // -1/a_ii with a_ii the in-bounds neighbour count, a LUT of double
  // divisions rounded to float (poisson.cpp:67)
  const int aii = 4 - (i == 0) - (i == H - 1) - (j == 0) - (j == W - 1);
  const float neg_inv = aii == 4   ? (float)(-1.0 / 4.0)
                        : aii == 3 ? (float)(-1.0 / 3.0)
                        : aii == 2 ? (float)(-1.0 / 2.0)
                                   : -1.f;
  p[c] = one_m_w * p[c] + omega * (neg_inv * (dxd[c] - nb));
}

// 2*iters half-sweeps, even parity first, in place on p (blocks of 32x8
// threads, half a row's width each).  Returns the first launch error.
inline cudaError_t sor_half_sweeps(float* p, const float* dxd, int H, int W,
                                   int iters, float omega, float one_m_w,
                                   cudaStream_t s) {
  const dim3 block(32, 8);
  const dim3 grid(((W + 1) / 2 + 31) / 32, (H + 7) / 8);
  for (int half = 0; half < 2 * iters; ++half) {
    sor_half_sweep_kernel<<<grid, block, 0, s>>>(p, dxd, H, W, half % 2,
                                                 omega, one_m_w);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
