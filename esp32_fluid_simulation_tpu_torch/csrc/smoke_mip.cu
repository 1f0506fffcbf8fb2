// Smoke MIP render: max over depth, heat colormap and RGB565 pack in one
// pass over a [D, H, W] density volume.
//
// Replaces the TPU kernel esp32_fluid_simulation_tpu/render/pallas_smoke.py
// (render_smoke_mip_pallas / _mip_kernel), which streams [D, th, tw] column
// blocks through VMEM.  Here one thread owns one output pixel and walks its
// column down the depth axis; neighbouring threads read neighbouring
// addresses of each plane, so every load is coalesced.
//
// Bound on the H100: device-memory bytes (the volume is read once, 2 B per
// voxel as bf16, and only the uint16 pixels are written: ~34 MB at 256^3),
// but at that size the launch and the depth loop's latency dominate.
//
// NaN rule: like jnp.max and torch.amax, the maximum is NaN once any voxel
// of the column is NaN; the colormap clamps then map it to 0 (a black
// pixel), as the plain version's float-to-int conversion does.
//
// Arithmetic follows _mip_kernel (pallas_smoke.py:25-40): t = max * (1/vmax),
// r = clip(3t, 0, 1), g = clip(3t - 1, 0, 1), b = clip(3t - 2, 0, 1), each
// quantized as clip(int(v * 2^bits), 0, 2^bits - 1) (truncation), packed
// 5/6/5 and optionally byte-swapped.  Built with --fmad=false, bit-equal to
// the plain PyTorch version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load(const float* p, long long k) {
  return p[k];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long k) {
  return __bfloat162float(p[k]);
}

__device__ __forceinline__ int quant(float v, int bits) {
  // v is in [0, 1] (or 0 for a NaN column, as the clamps return 0)
  return min(max(__float2int_rz(v * (float)(1 << bits)), 0), (1 << bits) - 1);
}

template <typename T>
__global__ void smoke_mip_kernel(const T* __restrict__ density,
                                 uint16_t* __restrict__ out, int D, int H,
                                 int W, float inv_vmax, int bswap) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= H || j >= W) return;
  const long long plane = (long long)H * W;
  const long long c = (long long)i * W + j;
  float m = load(density, c);
#pragma unroll 8
  for (int z = 1; z < D; ++z) {
    const float v = load(density, z * plane + c);
    // NaN-propagating max: keep m once it is NaN, take v if it is NaN
    m = (m != m || v <= m) ? m : v;
  }
  const float t = m * inv_vmax;
  const float r = fminf(fmaxf(3.f * t, 0.f), 1.f);
  const float g = fminf(fmaxf(3.f * t - 1.f, 0.f), 1.f);
  const float b = fminf(fmaxf(3.f * t - 2.f, 0.f), 1.f);
  unsigned word = (quant(r, 5) << 11) | (quant(g, 6) << 5) | quant(b, 5);
  if (bswap) word = ((word << 8) | (word >> 8)) & 0xFFFFu;
  out[c] = (uint16_t)word;
}

}  // namespace

// density: [D, H, W] float32 (density_bf16 = 0) or bfloat16 (= 1);
// out: [H, W] uint16.
extern "C" int fluid_smoke_mip(const void* density, void* out, int D, int H,
                               int W, int density_bf16, float inv_vmax,
                               int bswap, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(32, 8);
  const dim3 grid((W + 31) / 32, (H + 7) / 8);
  if (density_bf16)
    smoke_mip_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(density),
        static_cast<uint16_t*>(out), D, H, W, inv_vmax, bswap);
  else
    smoke_mip_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(density), static_cast<uint16_t*>(out), D,
        H, W, inv_vmax, bswap);
  return (int)cudaGetLastError();
}
