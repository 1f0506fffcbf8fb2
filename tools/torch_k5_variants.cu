// Design variants of K5's window kernel (maccormack_tile_kernel in
// esp32_fluid_simulation_tpu_torch/csrc/advect.cu), for timing beside it.
// Built and driven by tools/torch_k5_variants.py; no path of the package
// calls them.  The kernel's own source is included, so each variant shares
// its stencil, forward pass and tile (TH x TW, kThreads threads).
//
//   kRegisters  each thread keeps its own cells' displacements and the
//               limiter's bounds in registers across the barriers, in
//               place of re-reading the velocity and a bounds array in
//               shared memory;
//   kBands      the ring of the window in four rounds of loads (the bands
//               above and below the tile, then the strips left and right),
//               in place of one sequence over all its cells;
//   kNoRing     the kept kernel without the ring (phi_hat only on the tile:
//               wrong wherever a backward tap leaves it), for the ring's
//               share of the time;
//   kForward    the first phase alone (reach, phi_hat and bounds of the own
//               cells; phi_hat stored as the output), for its share.
// kRegisters and kBands compute what the kernel computes, to the bit.

#include "../esp32_fluid_simulation_tpu_torch/csrc/advect.cu"

namespace {

enum Variant { kRegisters = 1, kBands = 2, kNoRing = 3, kForward = 4 };

constexpr int kCells = TH * TW / kThreads;  // own cells a thread

template <typename T, int C, int V>
__global__ void __launch_bounds__(kThreads)
    variant_kernel(const T* __restrict__ field, const float* __restrict__ vel,
                   T* __restrict__ out, int H, int W, float dt,
                   float max_disp, int no_slip) {
  constexpr int NC = TH * TW;
  constexpr bool REG = V == kRegisters;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int reach[2];
  const int R = (int)max_disp + 1;
  const int pw = TW + 2 * R;
  const int wplane = (TH + 2 * R) * pw;
  T* win = reinterpret_cast<T*>(smem);
  T* bounds = win + C * wplane;
  const int tid = threadIdx.x;
  const int ti0 = blockIdx.y * TH, tj0 = blockIdx.x * TW;
  const int ti1 = min(ti0 + TH, H), tj1 = min(tj0 + TW, W);
  const int wo_i = ti0 - R, wo_j = tj0 - R;
  const long plane = (long)H * W;
  if (tid == 0) reach[0] = reach[1] = 0;

  float rd0[kCells], rd1[kCells], rlo[kCells][C], rhi[kCells][C];
  int ri = 0, rj = 0;
#pragma unroll
  for (int n = 0; n < kCells; ++n) {
    const int k = tid + n * kThreads;
    const int i = ti0 + k / TW, j = tj0 + k % TW;
    if (i >= H || j >= W) continue;
    const long c = (long)i * W + j;
    const float d0 = vel[c] * dt;
    const float d1 = vel[plane + c] * dt;
    ri = max(ri, reach_of(d0, max_disp));
    rj = max(rj, reach_of(d1, max_disp));
    float lo[C], hi[C];
    forward_cell<T, C, false, true>(field, i, j, d0, d1, H, W, 0, 0,
                                    max_disp, no_slip,
                                    win + (i - wo_i) * pw + (j - wo_j),
                                    wplane, lo, hi);
    if constexpr (V == kForward) {
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        store(out, ch * plane + c,
              load(win + ch * wplane, (i - wo_i) * pw + (j - wo_j)) +
                  lo[ch] + hi[ch]);
    }
    if constexpr (REG) {
      rd0[n] = d0;
      rd1[n] = d1;
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        rlo[n][ch] = lo[ch];
        rhi[n][ch] = hi[ch];
      }
    } else {
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        store(bounds, ch * NC + k, lo[ch]);
        store(bounds, (C + ch) * NC + k, hi[ch]);
      }
    }
  }
  if constexpr (V == kForward) return;
  ri = __reduce_max_sync(0xffffffffu, ri);
  rj = __reduce_max_sync(0xffffffffu, rj);
  __syncthreads();
  if (tid % 32 == 0) {
    atomicMax(&reach[0], ri);
    atomicMax(&reach[1], rj);
  }
  __syncthreads();

  const int wi0 = max(ti0 - reach[0] - 1, 0);
  const int wi1 = min(ti1 + reach[0] + 1, H);
  const int wj0 = max(tj0 - reach[1] - 1, 0);
  const int wj1 = min(tj1 + reach[1] + 1, W);
  auto ring_cell = [&](int i, int j) {
    const long c = (long)i * W + j;
    forward_cell<T, C, false, false>(
        field, i, j, vel[c] * dt, vel[plane + c] * dt, H, W, 0, 0, max_disp,
        no_slip, win + (i - wo_i) * pw + (j - wo_j), wplane, nullptr,
        nullptr);
  };
  if constexpr (V == kBands) {
    const int ww = wj1 - wj0;
    for (int k = tid; k < (ti0 - wi0) * ww; k += kThreads)
      ring_cell(wi0 + k / ww, wj0 + k % ww);
    for (int k = tid; k < (wi1 - ti1) * ww; k += kThreads)
      ring_cell(ti1 + k / ww, wj0 + k % ww);
    const int lw = tj0 - wj0, rw = wj1 - tj1;
    for (int k = tid; k < (ti1 - ti0) * lw; k += kThreads)
      ring_cell(ti0 + k / lw, wj0 + k % lw);
    for (int k = tid; k < (ti1 - ti0) * rw; k += kThreads)
      ring_cell(ti0 + k / rw, tj1 + k % rw);
  } else if constexpr (V != kNoRing) {
    // the kept kernel's one sequence over the ring's cells
    const int ww = wj1 - wj0;
    const int n_top = (ti0 - wi0) * ww;
    const int n_rows = n_top + (wi1 - ti1) * ww;
    const int lw = tj0 - wj0, sw = lw + (wj1 - tj1);
    const int n_ring = n_rows + (ti1 - ti0) * sw;
    for (int k = tid; k < n_ring; k += kThreads) {
      if (k < n_rows) {
        const bool top = k < n_top;
        const int q = top ? k : k - n_top;
        ring_cell((top ? wi0 : ti1) + q / ww, wj0 + q % ww);
      } else {
        const int q = k - n_rows;
        const int col = q % sw;
        ring_cell(ti0 + q / sw, col < lw ? wj0 + col : tj1 + (col - lw));
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int n = 0; n < kCells; ++n) {
    const int k = tid + n * kThreads;
    const int i = ti0 + k / TW, j = tj0 + k % TW;
    if (i >= H || j >= W) continue;
    const long c = (long)i * W + j;
    const float e0 = REG ? rd0[n] : vel[c] * dt;
    const float e1 = REG ? rd1[n] : vel[plane + c] * dt;
    const Stencil s = stencil<false>(i, j, (float)i + e0, (float)j + e1, H,
                                     W, max_disp, no_slip, 0, 0);
    const int tap = (s.i0 - wo_i) * pw + (s.j0 - wo_j);
    const int own = (i - wo_i) * pw + (j - wo_j);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      const T* w = win + ch * wplane;
      const float back = round_to<T>(
          bilerp(s, load(w, tap), load(w, tap + 1), load(w, tap + pw),
                 load(w, tap + pw + 1), no_slip));
      const long kk = ch * plane + c;
      const float diff = round_to<T>(load(field, kk) - back);
      const float half = round_to<T>(0.5f * diff);
      const float corr = round_to<T>(load(w, own) + half);
      const float lo = REG ? rlo[n][ch] : load(bounds, ch * NC + k);
      const float hi = REG ? rhi[n][ch] : load(bounds, (C + ch) * NC + k);
      store(out, kk, min_nan(max_nan(corr, lo), hi));
    }
  }
}

template <typename T, int C, int V>
int run(const void* f, const void* v, void* o, int H, int W, float dt,
        int md, int ns, cudaStream_t s) {
  const auto kernel = variant_kernel<T, C, V>;
  const long bytes = window_bytes(C, (int)sizeof(T), md);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  kernel<<<grid, kThreads, bytes, s>>>(static_cast<const T*>(f),
                                       static_cast<const float*>(v),
                                       static_cast<T*>(o), H, W, dt,
                                       (float)md, ns);
  return (int)cudaGetLastError();
}

template <typename T, int C>
int pick(int var, const void* f, const void* v, void* o, int H, int W,
         float dt, int md, int ns, cudaStream_t s) {
  switch (var) {
    case kRegisters:
      return run<T, C, kRegisters>(f, v, o, H, W, dt, md, ns, s);
    case kBands:
      return run<T, C, kBands>(f, v, o, H, W, dt, md, ns, s);
    case kNoRing:
      return run<T, C, kNoRing>(f, v, o, H, W, dt, md, ns, s);
    case kForward:
      return run<T, C, kForward>(f, v, o, H, W, dt, md, ns, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One launch of variant `var` (enum Variant) on the whole grid: field, out
// [C, H, W] (float32 with C = 2, or bfloat16 with C = 3, config 3's
// velocity and dye), vel [2, H, W] float32.
extern "C" int k5_variant(int var, const void* field, const void* vel,
                          void* out, int C, int H, int W, int field_bf16,
                          float dt, int max_disp, int no_slip,
                          void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (field_bf16 && C == 3)
    return pick<__nv_bfloat16, 3>(var, field, vel, out, H, W, dt, max_disp,
                                  no_slip, s);
  if (!field_bf16 && C == 2)
    return pick<float, 2>(var, field, vel, out, H, W, dt, max_disp, no_slip,
                          s);
  return (int)cudaErrorInvalidValue;
}
