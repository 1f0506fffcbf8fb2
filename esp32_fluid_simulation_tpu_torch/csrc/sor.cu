// 2D red-black SOR pressure solve from zero, given the divergence: a fill,
// then 2*iters in-place parity half-sweeps.
//
// Replaces the TPU kernel esp32_fluid_simulation_tpu/ops/pallas/sor.py
// (sor_solve_pallas / _sor_kernel, with the packed red-black solve of
// ops/pallas/rb_common.py:packed_rb_solve_full, whose semantics only are
// taken: a plain parity-masked update).  The TPU kernel DMAs a tile of d
// with a 2*iters halo and runs all half-sweeps in VMEM on a packed
// half-width checkerboard.  A Hopper block has far less fast memory and
// blocks cannot wait for each other, so this first version launches:
//   1. a fill: dxd = dx * d, p = 0 (the solve starts from zero pressure,
//      poisson.cpp:117-119);
//   2. 2*iters in-place half-sweeps, even parity first: the same kernel K1
//      runs (csrc/rb2d.cuh), so K1 and K4 cannot drift apart.
//
// Bound on the H100: device-memory bytes.  The solve needs d read once and
// p written once (8 B per cell, 134 MB at 4096^2: 0.040 ms at 3.35 TB/s),
// but each half-sweep reads the pressure field and half of dxd and writes
// half of p; at 4096^2 the 64 MiB fields do not stay in the 50 MB L2, so
// the 20 half-sweeps stream ~2.7 GB.  Keeping several sweeps on chip
// (temporal blocking in shared memory, the TPU kernel's trapezoid) is a
// later change, as for K1 and K9.
//
// Tiled-domain mode (K6, the member= argument of sor_solve_pallas,
// sor.py:83): the half-sweeps' member walls, as in K1 (csrc/rb2d.cuh).
//
// Block mode (K11, the global_offset= argument of sor_solve_pallas,
// sor.py:101-110, called per shard by parallel/sharded.py): d is one
// shard's block with a halo of at least 2*iters exchanged cells per side.
// The fill and the half-sweeps run over the whole haloed block with the
// global walls, parity and domain of csrc/rb2d.cuh, and a last launch
// writes the owned cells into the output.  It streams the haloed block's
// bytes per half-sweep, as the whole-grid solve does; with 4096^2 blocks of
// an 8192^2 grid (halo 20) that is 2% more cells than the block.
//
// Built with --fmad=false, bit-equal to the plain PyTorch version
// (ops.poisson.sor_solve: dx * d, then ((up + dn) + lf) + rt and
// (1-w) p + w (neg_inv (dx d - nb))).

#include <cuda_runtime.h>

#include "rb2d.cuh"

namespace {

__global__ void sor_fill_kernel(const float* __restrict__ d,
                                float* __restrict__ dxd,
                                float* __restrict__ p, long n, float dx) {
  const long c = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  dxd[c] = dx * d[c];
  p[c] = 0.f;
}

// The owned bh x bw cells of the haloed block p (halo g per side).
__global__ void owned_copy_kernel(const float* __restrict__ p,
                                  float* __restrict__ out, int W, int g,
                                  int bh, int bw) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= bh || j >= bw) return;
  out[(long)i * bw + j] = p[(long)(i + g) * W + (j + g)];
}

}  // namespace

// d, p, dxd: [H, W] float32 (p is the output, dxd scratch; H, W >= 2);
// mh, mw: the member tile (mh = 0: none; else mh, mw >= 2 dividing the
// domain).  Block mode when halo > 0: d, p and dxd are the haloed block,
// whose cell (0, 0) sits at global (oi, oj) of a GH x GW domain, and the
// owned (H - 2 halo) x (W - 2 halo) cells of the solve go to p_out.
extern "C" int fluid_sor(const void* d, void* p, void* dxd, int H, int W,
                         int mh, int mw, int oi, int oj, int GH, int GW,
                         int halo, void* p_out, float dx, int iters,
                         float omega, float one_m_w, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(p);
  float* dd = static_cast<float*>(dxd);
  const long n = (long)H * W;
  const int threads = 256;
  sor_fill_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(
      static_cast<const float*>(d), dd, pp, n, dx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (halo == 0)
    return (int)sor_half_sweeps<false>(pp, dd, Geom{H, W, 0, 0, H, W, mh, mw},
                                       iters, omega, one_m_w, s);
  err = sor_half_sweeps<true>(pp, dd, Geom{H, W, oi, oj, GH, GW, mh, mw},
                              iters, omega, one_m_w, s);
  if (err != cudaSuccess) return (int)err;
  const int bh = H - 2 * halo;
  const int bw = W - 2 * halo;
  const dim3 block(32, 8);
  const dim3 grid((bw + 31) / 32, (bh + 7) / 8);
  owned_copy_kernel<<<grid, block, 0, s>>>(pp, static_cast<float*>(p_out), W,
                                           halo, bh, bw);
  return (int)cudaGetLastError();
}
