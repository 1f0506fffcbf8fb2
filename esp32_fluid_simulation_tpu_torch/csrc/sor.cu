// 2D red-black SOR pressure solve from zero, given the divergence.
//
// Replaces the TPU kernel esp32_fluid_simulation_tpu/ops/pallas/sor.py
// (sor_solve_pallas / _sor_kernel, with the packed red-black solve of
// ops/pallas/rb_common.py:packed_rb_solve_full).  The TPU kernel DMAs a tile
// of d with a 2*iters halo and runs all half-sweeps in VMEM on a packed
// half-width checkerboard.  Two routes, chosen by the wrapper:
//
// * The window route (iters <= 15, every config; one launch): K1's window
//   without the divergence and the gradient.  A block owns a TH x TW tile
//   of the output and holds p and dx*d on the tile +- 2*iters in shared
//   memory, split by colour (RbWindow, csrc/rb2d.cuh).  It loads dx*d (0
//   outside the domain or the array), starts from p = 0, runs the 2*iters
//   half-sweeps of rb_window_half_sweeps on the shrinking trapezoid
//   (half-sweep k updates the tile +- (2*iters - k)), and writes the tile's
//   p.  No gradient follows, so the halo is 2*iters, not K1's 2*iters + 1.
// * The sequence route (more iters): a fill (dxd = dx * d, p = 0,
//   poisson.cpp:117-119), then 2*iters in-place half-sweeps, even parity
//   first, one launch each (the half-sweep of csrc/rb2d.cuh).
//
// Bound on the H100: device-memory bytes.  The solve needs d read once and
// p written once (8 B per cell, 134 MB at 4096^2: 0.040 ms at 3.35 TB/s).
// The window route reads d about 1.4 times (the windows overlap; the
// second read mostly from L2) and writes p once; its half-sweeps run in
// shared memory.  The sequence route streams the 64 MiB fields through
// device memory in each of its 20 half-sweeps (~2.7 GB).
//
// Tiled-domain mode (K6, the member= argument of sor_solve_pallas,
// sor.py:83): the half-sweeps' member walls, as in K1 (csrc/rb2d.cuh).
//
// Block mode (K11, the global_offset= argument of sor_solve_pallas,
// sor.py:101-110, called per shard by parallel/sharded.py): d is one
// shard's block with a halo of at least 2*iters exchanged cells per side,
// with the global walls, parity and domain of csrc/rb2d.cuh; only the
// owned cells are written.  The window route tiles the owned block, and
// its windows reach into the halo; the sequence route runs over the whole
// haloed block and a last launch copies the owned cells out.
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

// The window route: one block per TH x TW tile of the owned cells (all
// cells without block mode), which are the array's [halo, H - halo) x
// [halo, W - halo).  The window is the tile +- R, R = 2*iters, in shared
// memory: p and dx*d split by colour (RbWindow), then the row and column
// flags.  Window cell (a, b) is array cell (ai0 + a, aj0 + b).
template <bool MEMBER>
__global__ void __launch_bounds__(1024)
    sor_tile_kernel(const float* __restrict__ d, float* __restrict__ p_out,
                    const Geom g, int halo, int TH, int TW, int stride,
                    float dx, int iters, float omega, float one_m_w) {
  extern __shared__ float4 smem[];
  const int R = 2 * iters;
  const int bh = g.H - 2 * halo;
  const int bw = g.W - 2 * halo;
  const int t0 = blockIdx.y * TH;  // the tile's first owned row and column
  const int u0 = blockIdx.x * TW;
  const int th = min(TH, bh - t0);
  const int tw = min(TW, bw - u0);
  const int rows = th + 2 * R;
  const int cols = tw + 2 * R;
  const int ai0 = halo + t0 - R;
  const int aj0 = halo + u0 - R;
  float* sp = reinterpret_cast<float*>(smem);
  float* sd = sp + 2 * stride;
  unsigned char* row_flags = reinterpret_cast<unsigned char*>(sd + 2 * stride);
  unsigned char* col_flags = row_flags + TH + 2 * R;
  const RbWindow win{sp, sd, row_flags, col_flags, rows, cols, stride,
                     (ai0 + g.oi + aj0 + g.oj) & 1};

  // 1. the flags and p = 0
  rb_window_init<MEMBER>(win, row_flags, col_flags, g, ai0, aj0);
  __syncthreads();

  // 2. dx * d on the window's rows and columns [1, rows - 1) x [1, cols -
  // 1), 0 outside the domain or the array: lanes along a row, each warp a
  // run of rows, a row's loads issued together
  const int lane = threadIdx.x;
  if (iters > 0) {
    const int n = rows - 2;
    const int a0 = 1 + n * (int)threadIdx.y / (int)blockDim.y;
    const int a1 = 1 + n * ((int)threadIdx.y + 1) / (int)blockDim.y;
    for (int a = a0; a < a1; ++a) {
      const bool row_in = !(row_flags[a] & kOutside);
      const float* row = d + (long)(ai0 + a) * g.W + aj0;
      float v[2 * kChunks];
#pragma unroll
      for (int u = 0; u < 2 * kChunks; ++u) {
        const int b = 1 + lane + 32 * u;
        v[u] = (row_in && b < cols - 1 && !(col_flags[b] & kOutside))
                   ? dx * row[b]
                   : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 2 * kChunks; ++u) {
        const int b = 1 + lane + 32 * u;
        if (b < cols - 1) rb_dxd_at(win, a, b) = v[u];
      }
    }
    __syncthreads();
  }

  // 3. the half-sweeps on the shrinking window
  rb_window_half_sweeps(win, 2 * iters, omega, one_m_w);

  // 4. the tile's p into the owned cells
  for (int a = R + threadIdx.y; a < R + th; a += blockDim.y) {
    float* out = p_out + (long)(t0 + a - R) * bw + (u0 - R);
    for (int b = R + lane; b < R + tw; b += 32) out[b] = rb_at(win, a, b);
  }
}

template <bool MEMBER>
cudaError_t sor_window(const float* d, float* po, const Geom& g, int halo,
                       int TH, int TW, int threads_y, float dx, int iters,
                       float omega, float one_m_w, cudaStream_t s) {
  const WindowShape ws = window_shape(TH, TW, 2 * iters);
  if (ws.cols == 0) return cudaErrorInvalidValue;
  // above 48 KB a block's shared memory must be asked for
  cudaError_t err =
      cudaFuncSetAttribute(sor_tile_kernel<MEMBER>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           ws.bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.W - 2 * halo + TW - 1) / TW,
                  (g.H - 2 * halo + TH - 1) / TH);
  sor_tile_kernel<MEMBER><<<grid, dim3(32, threads_y), ws.bytes, s>>>(
      d, po, g, halo, TH, TW, ws.stride, dx, iters, omega, one_m_w);
  return cudaGetLastError();
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

// The window route (one launch): d [H, W] float32; the owned cells' p goes
// to p_out [H - 2 halo, W - 2 halo] (halo = 0 without block mode); TH x TW
// tiles, blocks of 32 x threads_y threads.  The other arguments as for
// fluid_sor above.
extern "C" int fluid_sor_window(const void* d, void* p_out, int H, int W,
                                int mh, int mw, int oi, int oj, int GH,
                                int GW, int halo, float dx, int iters,
                                float omega, float one_m_w, int tile_h,
                                int tile_w, int threads_y, void* stream) {
  if (iters < 0 || tile_h < 1 || tile_w < 1 || threads_y < 1 ||
      threads_y > 32)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dd = static_cast<const float*>(d);
  float* po = static_cast<float*>(p_out);
  // without block mode the array is its own domain at origin 0
  const Geom g{H, W, oi, oj, GH, GW, mh, mw};
  if (mh > 0)
    return (int)sor_window<true>(dd, po, g, halo, tile_h, tile_w, threads_y,
                                 dx, iters, omega, one_m_w, s);
  return (int)sor_window<false>(dd, po, g, halo, tile_h, tile_w, threads_y,
                                dx, iters, omega, one_m_w, s);
}
