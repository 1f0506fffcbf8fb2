// Smoke MIP render (K10): max over depth, heat colormap and RGB565 pack in
// one pass over a [D, H, W] density volume.
//
// Replaces the TPU kernel esp32_fluid_simulation_tpu/render/pallas_smoke.py
// (render_smoke_mip_pallas / _mip_kernel), which streams [D, th, tw] column
// blocks through VMEM.
//
// Bound on the H100: device-memory bytes.  The volume is read once (2 B a
// voxel as bf16, 33.5 MB at 256^3) and only the uint16 pixels are written,
// ~10 us at 3.35 TB/s.  A thread per pixel walking its column with 2-byte
// loads keeps too few bytes in flight to cover the memory's latency at
// 256^2 pixels (64 B a warp load, ~16 warps an SM).  So here:
//   * a thread owns a group of `vec` adjacent pixels and reads each plane
//     with one 16-byte load (8 bf16 or 4 f32 pixels: 512 B a warp load),
//     kUnroll planes in flight at once;
//   * the depth is split into blockDim.y segments of seg_len planes
//     (segment s: planes [s*seg_len, min(D, (s+1)*seg_len))), each keeping
//     its running maxima in registers, seeded with -inf so that a short or
//     empty segment changes nothing;
//   * segments 1.. leave their maxima in shared memory, and the segment-0
//     thread of each group combines them in order, then maps, packs and
//     stores its `vec` pixels with one store.
// The wrapper (render/cuda_smoke.py, mip_plan) picks vec: 16 bytes' worth
// when the volume's base is 16-byte aligned and H*W is a multiple of it
// (else every plane after the first is misaligned), 1 (the scalar route)
// otherwise; the same single launch either way.
//
// NaN rule: like jnp.max and torch.amax, the maximum is NaN once any voxel
// of the column is NaN (nan_max: a NaN once seen stays, a NaN tap is
// taken, in any segment); the colormap clamps then map it to 0 (a black
// pixel), as the plain version's float-to-int conversion does.  Ties
// between +0 and -0 may keep either; both pack to the same pixel.
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

constexpr int kUnroll = 8;  // planes a thread has in flight

// The word type of one load or store of `bytes` bytes
template <int bytes> struct Word;
template <> struct Word<2> { using type = unsigned short; };
template <> struct Word<4> { using type = unsigned; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<16> { using type = uint4; };

// `V` elements of B (a float, or a bf16's or a pixel's 16 bits) moved by
// one load or store
template <typename B, int V>
union Pack {
  using word_type = typename Word<sizeof(B) * V>::type;
  word_type word;
  B v[V];
};

// the element's bits in memory, and its value
template <typename T> struct Elem;
template <> struct Elem<float> {
  using bits = float;
  static __device__ __forceinline__ float value(float x) { return x; }
};
template <> struct Elem<__nv_bfloat16> {
  using bits = unsigned short;
  static __device__ __forceinline__ float value(unsigned short x) {
    return __uint_as_float((unsigned)x << 16);  // __bfloat162float
  }
};

// NaN-propagating max: keep m once it is NaN, take v if it is NaN
__device__ __forceinline__ float nan_max(float m, float v) {
  return (m != m || v <= m) ? m : v;
}

__device__ __forceinline__ int quant(float v, int bits) {
  // v is in [0, 1] (or 0 for a NaN column, as the clamps return 0)
  return min(max(__float2int_rz(v * (float)(1 << bits)), 0), (1 << bits) - 1);
}

__device__ __forceinline__ uint16_t pack_pixel(float m, float inv_vmax,
                                               int bswap) {
  const float t = m * inv_vmax;
  const float r = fminf(fmaxf(3.f * t, 0.f), 1.f);
  const float g = fminf(fmaxf(3.f * t - 1.f, 0.f), 1.f);
  const float b = fminf(fmaxf(3.f * t - 2.f, 0.f), 1.f);
  unsigned word = (quant(r, 5) << 11) | (quant(g, 6) << 5) | quant(b, 5);
  if (bswap) word = ((word << 8) | (word >> 8)) & 0xFFFFu;
  return (uint16_t)word;
}

template <typename T, int V>
__device__ __forceinline__ void fold(float (&m)[V],
                                     const Pack<typename Elem<T>::bits, V>& x) {
#pragma unroll
  for (int v = 0; v < V; ++v) m[v] = nan_max(m[v], Elem<T>::value(x.v[v]));
}

// block (threads_x, segments): threadIdx.x a pixel group, threadIdx.y a
// depth segment; dynamic shared memory (segments - 1) * V * threads_x floats
template <typename T, int V>
__global__ void smoke_mip_kernel(const T* __restrict__ density,
                                 uint16_t* __restrict__ out, int D,
                                 long long npix, int seg_len, float inv_vmax,
                                 int bswap) {
  extern __shared__ float part[];  // [segment - 1][v][threadIdx.x]
  const int tx = threadIdx.x, s = threadIdx.y, nx = blockDim.x;
  const long long p0 = ((long long)blockIdx.x * nx + tx) * V;
  // npix % V == 0 when V > 1, so a live group is whole
  const bool live = p0 < npix;
  float m[V];
#pragma unroll
  for (int v = 0; v < V; ++v) m[v] = -__int_as_float(0x7f800000);
  if (live) {
    using In = Pack<typename Elem<T>::bits, V>;
    const auto* col =
        reinterpret_cast<const typename In::word_type*>(density + p0);
    const long long stride = npix / V;  // one plane, in words
    const int z1 = (int)min((long long)D, (long long)(s + 1) * seg_len);
    int z = (int)min((long long)D, (long long)s * seg_len);
    for (; z + kUnroll <= z1; z += kUnroll) {
      In x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) x[u].word = col[(z + u) * stride];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) fold<T, V>(m, x[u]);
    }
    for (; z < z1; ++z) {
      In x;
      x.word = col[z * stride];
      fold<T, V>(m, x);
    }
  }
  if (s > 0) {
#pragma unroll
    for (int v = 0; v < V; ++v) part[((s - 1) * V + v) * nx + tx] = m[v];
  }
  __syncthreads();
  if (s > 0 || !live) return;
  for (int k = 1; k < (int)blockDim.y; ++k) {
#pragma unroll
    for (int v = 0; v < V; ++v)
      m[v] = nan_max(m[v], part[((k - 1) * V + v) * nx + tx]);
  }
  Pack<uint16_t, V> w;
#pragma unroll
  for (int v = 0; v < V; ++v) w.v[v] = pack_pixel(m[v], inv_vmax, bswap);
  *reinterpret_cast<typename Pack<uint16_t, V>::word_type*>(out + p0) =
      w.word;
}

template <typename T, int V>
int launch(const void* density, void* out, int D, long long npix,
           int seg_len, int threads_x, int segments, float inv_vmax,
           int bswap, cudaStream_t s) {
  if (V > 1 && (npix % V || reinterpret_cast<uintptr_t>(density) % 16))
    return (int)cudaErrorMisalignedAddress;
  const long long blocks = (npix / V + threads_x - 1) / threads_x;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(float) * (segments - 1) * V * threads_x;
  smoke_mip_kernel<T, V><<<(unsigned)blocks, dim3(threads_x, segments), smem,
                           s>>>(static_cast<const T*>(density),
                                static_cast<uint16_t*>(out), D, npix, seg_len,
                                inv_vmax, bswap);
  return (int)cudaGetLastError();
}

}  // namespace

// density: [D, H, W] float32 (density_bf16 = 0) or bfloat16 (= 1);
// out: [H, W] uint16.  vec: pixels a thread, 16 / sizeof(element) or 1;
// segments * seg_len must cover D.
extern "C" int fluid_smoke_mip(const void* density, void* out, int D, int H,
                               int W, int density_bf16, int vec, int seg_len,
                               int threads_x, int segments, float inv_vmax,
                               int bswap, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long npix = (long long)H * W;
  if (D < 1 || npix < 1 || threads_x < 1 || segments < 1 ||
      (long long)segments * seg_len < D)
    return (int)cudaErrorInvalidValue;
  if (density_bf16) {
    if (vec == 8)
      return launch<__nv_bfloat16, 8>(density, out, D, npix, seg_len,
                                      threads_x, segments, inv_vmax, bswap, s);
    if (vec == 1)
      return launch<__nv_bfloat16, 1>(density, out, D, npix, seg_len,
                                      threads_x, segments, inv_vmax, bswap, s);
  } else {
    if (vec == 4)
      return launch<float, 4>(density, out, D, npix, seg_len, threads_x,
                              segments, inv_vmax, bswap, s);
    if (vec == 1)
      return launch<float, 1>(density, out, D, npix, seg_len, threads_x,
                              segments, inv_vmax, bswap, s);
  }
  return (int)cudaErrorInvalidValue;
}
