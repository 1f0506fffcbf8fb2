// s x bilinear upscale of [3, H, W] dye to ((H-1)s, (W-1)s) RGB565 pixels.
//
// Replaces the TPU kernel
// esp32_fluid_simulation_tpu/render/pallas_upscale.py (render_rgb565_pallas,
// _render_kernel_t / _render_kernel_planes).  The TPU kernel stretches
// columns through transposes and phase planes because a TPU lane cannot
// gather; here one thread owns one output pixel and reads its four source
// nodes per channel directly (s*s neighbouring pixels share them, so they
// come from L1).
//
// Bound on the H100: the 2-byte store of every output pixel.  At s = 4 the
// output has 16x the source's nodes, so the write stream (~537 MB at
// 4096^2 -> 16380^2) is nearly all of the traffic; the source (96 MiB as
// f32, 48 MiB as bf16) is read about once.  The design never materializes
// the float image: upscale, quantize and pack stay in registers, and each
// warp writes 64 contiguous bytes.
//
// Arithmetic follows upscale_bilinear (render/upscale.py:25-49): rows first,
// c[i]*(1 - a/s) + c[i+1]*(a/s), then columns with b/s, fractions a/s in
// f32; then 5/6/5-bit quantization int(v * 2^bits) with truncation and the
// clip (min only when unit_range), pack, optional byte swap.  Built with
// --fmad=false, bit-equal to pack_rgb565(upscale_bilinear(...)).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load(const float* p, long k) { return p[k]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long k) {
  return __bfloat162float(p[k]);
}

__device__ __forceinline__ int quant(float v, int bits, int unit_range) {
  const int q = (int)(v * (float)(1 << bits));
  const int top = (1 << bits) - 1;
  return unit_range ? min(q, top) : min(max(q, 0), top);
}

template <typename T>
__global__ void render_rgb565_kernel(const T* __restrict__ color,
                                     uint16_t* __restrict__ out, int H, int W,
                                     int s, int bswap, int unit_range) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int Wo = (W - 1) * s;
  const int Ho = (H - 1) * s;
  if (x >= Wo || y >= Ho) return;
  const int i = y / s;
  const int j = x / s;
  const float ta = (float)(y - i * s) / (float)s;
  const float tb = (float)(x - j * s) / (float)s;
  const float one_m_ta = 1.f - ta;
  const float one_m_tb = 1.f - tb;
  const long plane = (long)H * W;
  const long base = (long)i * W + j;
  const int bits[3] = {5, 6, 5};
  int q[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const T* c = color + ch * plane;
    const float r0 = load(c, base) * one_m_ta + load(c, base + W) * ta;
    const float r1 = load(c, base + 1) * one_m_ta + load(c, base + W + 1) * ta;
    q[ch] = quant(r0 * one_m_tb + r1 * tb, bits[ch], unit_range);
  }
  int word = (q[0] << 11) | (q[1] << 5) | q[2];
  if (bswap) word = ((word << 8) | (word >> 8)) & 0xFFFF;
  out[(long)y * Wo + x] = (uint16_t)word;
}

template <typename T>
cudaError_t launch(const void* color, void* out, int H, int W, int s,
                   int bswap, int unit_range, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid(((W - 1) * s + block.x - 1) / block.x,
                  ((H - 1) * s + block.y - 1) / block.y);
  render_rgb565_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(color), static_cast<uint16_t*>(out), H, W, s,
      bswap, unit_range);
  return cudaGetLastError();
}

}  // namespace

// color: [3, H, W] float32 (color_bf16 = 0) or bfloat16 (= 1);
// out: [(H-1)s, (W-1)s] uint16.
extern "C" int fluid_render_rgb565(const void* color, void* out, int H, int W,
                                   int color_bf16, int s, int bswap,
                                   int unit_range, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (color_bf16)
    return (int)launch<__nv_bfloat16>(color, out, H, W, s, bswap, unit_range,
                                      st);
  return (int)launch<float>(color, out, H, W, s, bswap, unit_range, st);
}
