// 3D finite differences: the reflected-ghost divergence and the Neumann
// gradient subtract of the pressure projection.
//
// Replaces the TPU kernels esp32_fluid_simulation_tpu/ops/pallas/fd3d.py
// (divergence3d_pallas, subtract_gradient3d_pallas).  Those DMA a haloed
// window, fold its planes into rows and shift whole lane arrays, because a
// TPU core has no per-element neighbour load.  Here one thread owns one
// cell and reads its six face neighbours directly; the plane, row and
// column neighbours of a block's cells are the same few lines, so they come
// from L1/L2 and each field is read from device memory about once.
//
// Bound on the H100: device-memory bytes.  The divergence reads the three
// float32 velocity channels and writes one field (16 B per cell); the
// gradient subtract reads the velocity and the pressure and writes the
// velocity (28 B per cell).  At 256^3 that is 268 MB and 470 MB.
//
// Arithmetic follows ops/fd.py: per axis (fwd - bwd), summed over axes 0, 1,
// 2, then one multiply by inv2dx = float(1 / (2 dx)); the walls use the
// reflected ghost -v (divergence) or the clamped center p (gradient).  Built
// with --fmad=false, bit-equal to the plain PyTorch versions.

#include <cuda_runtime.h>

namespace {

__global__ void divergence3d_kernel(const float* __restrict__ vel,
                                    float* __restrict__ out, int D, int H,
                                    int W, float inv2dx) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z;
  if (i >= H || j >= W) return;
  const long long plane = (long long)H * W;
  const long long vol = plane * D;
  const long long c = z * plane + (long long)i * W + j;
  const float* v0 = vel;
  const float* v1 = vel + vol;
  const float* v2 = vel + 2 * vol;
  const float a = v0[c];
  const float b = v1[c];
  const float e = v2[c];
  // the outside neighbour of a wall cell is -center (finitediff.cpp:17-20)
  const float t0 = (z == D - 1 ? -a : v0[c + plane]) - (z == 0 ? -a : v0[c - plane]);
  const float t1 = (i == H - 1 ? -b : v1[c + W]) - (i == 0 ? -b : v1[c - W]);
  const float t2 = (j == W - 1 ? -e : v2[c + 1]) - (j == 0 ? -e : v2[c - 1]);
  out[c] = ((t0 + t1) + t2) * inv2dx;
}

__global__ void subtract_gradient3d_kernel(const float* __restrict__ vel,
                                           const float* __restrict__ p,
                                           float* __restrict__ out, int D,
                                           int H, int W, float inv2dx) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z;
  if (i >= H || j >= W) return;
  const long long plane = (long long)H * W;
  const long long vol = plane * D;
  const long long c = z * plane + (long long)i * W + j;
  const float pc = p[c];
  // Neumann walls: the outside pressure is the center value
  const float g0 = ((z == D - 1 ? pc : p[c + plane]) - (z == 0 ? pc : p[c - plane])) * inv2dx;
  const float g1 = ((i == H - 1 ? pc : p[c + W]) - (i == 0 ? pc : p[c - W])) * inv2dx;
  const float g2 = ((j == W - 1 ? pc : p[c + 1]) - (j == 0 ? pc : p[c - 1])) * inv2dx;
  out[c] = vel[c] - g0;
  out[vol + c] = vel[vol + c] - g1;
  out[2 * vol + c] = vel[2 * vol + c] - g2;
}

}  // namespace

// vel: [3, D, H, W] float32; out: [D, H, W] float32.
extern "C" int fluid_divergence3d(const void* vel, void* out, int D, int H,
                                  int W, float inv2dx, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((W + 31) / 32, (H + 7) / 8, D);
  divergence3d_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vel), static_cast<float*>(out), D, H, W,
      inv2dx);
  return (int)cudaGetLastError();
}

// vel, out: [3, D, H, W] float32; p: [D, H, W] float32.
extern "C" int fluid_subtract_gradient3d(const void* vel, const void* p,
                                         void* out, int D, int H, int W,
                                         float inv2dx, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((W + 31) / 32, (H + 7) / 8, D);
  subtract_gradient3d_kernel<<<grid, block, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vel), static_cast<const float*>(p),
      static_cast<float*>(out), D, H, W, inv2dx);
  return (int)cudaGetLastError();
}
