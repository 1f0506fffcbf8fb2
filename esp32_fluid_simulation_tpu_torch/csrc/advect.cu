// 2D semi-Lagrangian advection with the CFL clamp, the no-slip discount, the
// fused dye clamp and the RGB565 frame riding the store.
//
// Replaces the TPU kernel esp32_fluid_simulation_tpu/ops/pallas/advect.py
// (advect_pallas, production variant _advect_kernel_panel_sloop).  It
// computes what that kernel computes, not its layout: the TPU kernel walks
// integer row shifts over a DMA'd halo window because a TPU has no fast
// per-element gather; Hopper does, so here one thread owns one output cell
// and gathers its four bilinear taps directly through L1/L2.
//
// Bound on the H100: device-memory bytes.  Per cell it reads the velocity
// (8 B), the four taps of each channel (the backtrace moves at most
// max_disp cells, so neighbouring threads read neighbouring taps and most
// of them hit L1/L2) and writes C channels plus an optional 2-byte frame
// pixel.  The design keeps one pass over the field: the clamp, the dtype
// rounding and the RGB565 pack all happen in registers before the single
// store, so the frame costs 2 B per cell and no second read of the dye.
//
// Arithmetic follows _backtrace (advect.py:81-167) and the sloop
// accumulation: column lerp colv = rv0*(1-dj) + rv1*dj, then
// colv(i0)*(1-di) + colv(i0+1)*di, then the no-slip factor, the clip, the
// store in the field dtype (bf16: round to nearest even).  Built with
// --fmad=false so every product and sum rounds on its own, which makes the
// kernel bit-equal to its plain PyTorch version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load(const float* p, long k) { return p[k]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long k) {
  return __bfloat162float(p[k]);
}

// Store v and return the value as stored (what the frame must quantize).
__device__ __forceinline__ float store(float* p, long k, float v) {
  p[k] = v;
  return v;
}
__device__ __forceinline__ float store(__nv_bfloat16* p, long k, float v) {
  const __nv_bfloat16 b = __float2bfloat16_rn(v);
  p[k] = b;
  return __bfloat162float(b);
}

// advect.h:62-70: a sample past the wall attenuates to zero over half a
// cell of overshoot; raw >= n-1 already counts as the boundary.
__device__ __forceinline__ float noslip_factor(float raw, int n) {
  const float hi = (float)(n - 1);
  const bool under = raw < 0.f;
  const bool over = raw >= hi;
  if (!(under || over)) return 1.f;
  const float overshoot = under ? -raw : raw - hi;
  return overshoot < 0.5f ? 1.f - 2.f * overshoot : 0.f;
}

__device__ __forceinline__ int quant_unit(float v, int bits) {
  // clip01 bounds v to [0, 1], so min() alone bounds the code
  return min((int)(v * (float)(1 << bits)), (1 << bits) - 1);
}

template <typename T, int C>
__global__ void advect_kernel(const T* __restrict__ field,
                              const float* __restrict__ vel,
                              T* __restrict__ out,
                              uint16_t* __restrict__ frame, int H, int W,
                              float dt, float max_disp, int no_slip,
                              int clip01, int bswap) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= H || j >= W) return;
  const long plane = (long)H * W;
  const long c = (long)i * W + j;

  const float fi = (float)i;
  const float fj = (float)j;
  const float si_raw = fi - vel[c] * dt;
  const float sj_raw = fj - vel[plane + c] * dt;
  // CFL clamp to max_disp cells, then the domain clamp (edge lerp)
  float si = fminf(fmaxf(si_raw, fi - max_disp), fi + max_disp);
  float sj = fminf(fmaxf(sj_raw, fj - max_disp), fj + max_disp);
  si = fminf(fmaxf(si, 0.f), (float)(H - 1));
  sj = fminf(fmaxf(sj, 0.f), (float)(W - 1));
  const float i0f = fminf(fmaxf(floorf(si), 0.f), (float)(H - 2));
  const float j0f = fminf(fmaxf(floorf(sj), 0.f), (float)(W - 2));
  const float di = si - i0f;
  const float dj = sj - j0f;
  const float w_i0 = 1.f - di;
  const float one_m_dj = 1.f - dj;
  const long base = (long)i0f * W + (long)j0f;
  const float ns = no_slip ? noslip_factor(si_raw, H) * noslip_factor(sj_raw, W)
                           : 1.f;

  float stored[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    const T* f = field + ch * plane;
    const float colv0 = load(f, base) * one_m_dj + load(f, base + 1) * dj;
    const float colv1 =
        load(f, base + W) * one_m_dj + load(f, base + W + 1) * dj;
    float a = colv0 * w_i0 + colv1 * di;
    if (no_slip) a = a * ns;
    if (clip01) a = fminf(fmaxf(a, 0.f), 1.f);
    stored[ch] = store(out + ch * plane, c, a);
  }

  if (C == 3 && frame != nullptr && i < H - 1 && j < W - 1) {
    int word = (quant_unit(stored[0], 5) << 11) |
               (quant_unit(stored[1 % C], 6) << 5) |
               quant_unit(stored[2 % C], 5);
    if (bswap) word = ((word << 8) | (word >> 8)) & 0xFFFF;
    frame[(long)i * (W - 1) + j] = (uint16_t)word;
  }
}

template <typename T, int C>
cudaError_t launch(const void* field, const void* vel, void* out,
                   void* frame, int H, int W, float dt, float max_disp,
                   int no_slip, int clip01, int bswap, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
  advect_kernel<T, C><<<grid, block, 0, stream>>>(
      static_cast<const T*>(field), static_cast<const float*>(vel),
      static_cast<T*>(out), static_cast<uint16_t*>(frame), H, W, dt,
      max_disp, no_slip, clip01, bswap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_channels(int C, const void* field, const void* vel,
                              void* out, void* frame, int H, int W, float dt,
                              float max_disp, int no_slip, int clip01,
                              int bswap, cudaStream_t stream) {
  switch (C) {
    case 1:
      return launch<T, 1>(field, vel, out, nullptr, H, W, dt, max_disp,
                          no_slip, clip01, bswap, stream);
    case 2:
      return launch<T, 2>(field, vel, out, nullptr, H, W, dt, max_disp,
                          no_slip, clip01, bswap, stream);
    case 3:
      return launch<T, 3>(field, vel, out, frame, H, W, dt, max_disp,
                          no_slip, clip01, bswap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// field, out: [C, H, W] float32 (field_bf16 = 0) or bfloat16 (= 1);
// vel: [2, H, W] float32; frame: [H-1, W-1] uint16 or null (C == 3 only).
extern "C" int fluid_advect(const void* field, const void* vel, void* out,
                            void* frame, int C, int H, int W, int field_bf16,
                            float dt, int max_disp, int no_slip, int clip01,
                            int bswap, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float md = (float)max_disp;
  if (field_bf16)
    return (int)dispatch_channels<__nv_bfloat16>(
        C, field, vel, out, frame, H, W, dt, md, no_slip, clip01, bswap, s);
  return (int)dispatch_channels<float>(C, field, vel, out, frame, H, W, dt,
                                       md, no_slip, clip01, bswap, s);
}
