// s x bilinear upscale of [3, H, W] dye to ((H-1)s, (W-1)s) RGB565 pixels.
//
// Replaces the TPU kernel
// esp32_fluid_simulation_tpu/render/pallas_upscale.py (render_rgb565_pallas,
// _render_kernel_t / _render_kernel_planes).  The TPU kernel stretches
// columns through transposes and phase planes because a TPU lane cannot
// gather; here one thread owns one source cell (i, j) and writes its whole
// s x s patch of output pixels [i s, (i+1) s) x [j s, (j+1) s): it loads the
// cell's four nodes per channel once, takes each row lerp once per output
// row (not once per pixel), and needs no division or modulo per pixel.
//
// Bound on the H100: the 2-byte store of every output pixel.  At s = 4 the
// output has 16x the source's nodes, so the write stream (~537 MB at
// 4096^2 -> 16380^2) is nearly all of the traffic; the source (96 MiB as
// f32, 48 MiB as bf16) is read about once.  The float image never exists:
// upscale, quantize and pack stay in registers.  At s = 4 (a template
// instance, config 0's render) each output row of a patch is one 8-byte
// store, so a warp writes 256 contiguous bytes per row; other s store
// pixel by pixel.  What is left is instruction work: 3 lerps, a quantize
// and a pack per channel and pixel.
//
// Arithmetic follows upscale_bilinear (render/upscale.py:25-49): rows first,
// c[i]*(1 - a/s) + c[i+1]*(a/s), then columns with b/s, fractions a/s the
// f32 divisions (float)a / (float)s (folded at compile time for s = 4, a
// table in shared memory otherwise); then 5/6/5-bit quantization
// int(v * 2^bits) with truncation and the clip (min only when unit_range),
// pack, optional byte swap.  Built with --fmad=false, bit-equal to
// pack_rgb565(upscale_bilinear(...)).

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

// The packed pixel at column fraction tb between the row lerps r0 (column
// j) and r1 (column j + 1).
__device__ __forceinline__ unsigned pixel(const float* r0, const float* r1,
                                          float tb, int bswap,
                                          int unit_range) {
  const float one_m_tb = 1.f - tb;
  const int bits[3] = {5, 6, 5};
  int q[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    q[ch] = quant(r0[ch] * one_m_tb + r1[ch] * tb, bits[ch], unit_range);
  unsigned word = (q[0] << 11) | (q[1] << 5) | q[2];
  if (bswap) word = ((word << 8) | (word >> 8)) & 0xFFFF;
  return word;
}

// S > 0: the scale as a constant (s == S); S == 0: any s, its fractions in
// a table of s floats of dynamic shared memory.
template <typename T, int S>
__global__ void render_rgb565_kernel(const T* __restrict__ color,
                                     uint16_t* __restrict__ out, int H, int W,
                                     int s_arg, int bswap, int unit_range) {
  extern __shared__ float frac_table[];
  const int s = S > 0 ? S : s_arg;
  if (S == 0) {
    for (int a = threadIdx.y * blockDim.x + threadIdx.x; a < s;
         a += blockDim.x * blockDim.y)
      frac_table[a] = (float)a / (float)s;
    __syncthreads();
  }
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= H - 1 || j >= W - 1) return;
  const long plane = (long)H * W;
  const long base = (long)i * W + j;
  float c00[3], c01[3], c10[3], c11[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const T* c = color + ch * plane;
    c00[ch] = load(c, base);
    c01[ch] = load(c, base + 1);
    c10[ch] = load(c, base + W);
    c11[ch] = load(c, base + W + 1);
  }
  const long Wo = (long)(W - 1) * s;
  uint16_t* patch = out + (long)i * s * Wo + (long)j * s;
#pragma unroll
  for (int a = 0; a < (S > 0 ? S : s); ++a) {
    const float ta = S > 0 ? (float)a / (float)S : frac_table[a];
    const float one_m_ta = 1.f - ta;
    float r0[3], r1[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      r0[ch] = c00[ch] * one_m_ta + c10[ch] * ta;
      r1[ch] = c01[ch] * one_m_ta + c11[ch] * ta;
    }
    uint16_t* row = patch + a * Wo;
    if (S == 4) {
      // the row's four pixels as one 8-byte store (row starts at
      // (i s + a) (W-1) 4 + 4 j halfwords: 8-byte aligned)
      unsigned w[4];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        w[b] = pixel(r0, r1, (float)b / 4.f, bswap, unit_range);
      *reinterpret_cast<uint2*>(row) =
          make_uint2(w[0] | (w[1] << 16), w[2] | (w[3] << 16));
    } else {
      for (int b = 0; b < s; ++b)
        row[b] = (uint16_t)pixel(
            r0, r1, S > 0 ? (float)b / (float)S : frac_table[b], bswap,
            unit_range);
    }
  }
}

template <typename T>
cudaError_t launch(const void* color, void* out, int H, int W, int s,
                   int bswap, int unit_range, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((W - 1 + block.x - 1) / block.x,
                  (H - 1 + block.y - 1) / block.y);
  const T* c = static_cast<const T*>(color);
  uint16_t* o = static_cast<uint16_t*>(out);
  if (s == 4)
    render_rgb565_kernel<T, 4><<<grid, block, 0, stream>>>(
        c, o, H, W, s, bswap, unit_range);
  else
    render_rgb565_kernel<T, 0><<<grid, block, s * sizeof(float), stream>>>(
        c, o, H, W, s, bswap, unit_range);
  return cudaGetLastError();
}

}  // namespace

// color: [3, H, W] float32 (color_bf16 = 0) or bfloat16 (= 1);
// out: [(H-1)s, (W-1)s] uint16, 8-byte aligned; 1 <= s <= 4096.
extern "C" int fluid_render_rgb565(const void* color, void* out, int H, int W,
                                   int color_bf16, int s, int bswap,
                                   int unit_range, void* stream) {
  if (s < 1 || s > 4096) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (color_bf16)
    return (int)launch<__nv_bfloat16>(color, out, H, W, s, bswap, unit_range,
                                      st);
  return (int)launch<float>(color, out, H, W, s, bswap, unit_range, st);
}
