// 3D red-black SOR pressure solve from zero: 2*iters parity half-sweeps.
//
// Replaces the TPU kernel esp32_fluid_simulation_tpu/ops/pallas/sor3d.py
// (sor3d_packed_pallas / _sor3d_chunk_padded).  That kernel folds a haloed
// window's planes into rows, packs each colour into half-width lane arrays
// and runs `chunk` sweeps in VMEM per launch; all of that is Mosaic lane
// machinery.  A Hopper block has far less fast memory and blocks cannot
// wait for each other, so this first version launches one in-place half-
// sweep per colour on one stream.  In place is exact red-black Gauss-
// Seidel: a half-sweep updates only one colour, and same-colour cells never
// read each other.  `chunk` therefore has no counterpart here.
//
// Bound on the H100: device-memory bytes.  A half-sweep reads the pressure
// field (its own colour and the neighbours of the other) and half of d, and
// writes half of p: about 8 B per cell.  At 256^3, p and d are 67 MB each
// and together exceed the 50 MB L2, so each of the 20 half-sweeps streams
// them from device memory (~4 GB in all).  Keeping several sweeps on chip
// (temporal blocking in shared memory, the TPU kernel's chunk idea) is a
// later change.
//
// Arithmetic follows ops/poisson.py: neighbours summed
// ((((z- + z+) + i-) + i+) + j-) + j+ with zero ghosts, the -1/a_ii LUT of
// double divisions rounded to float (a_ii = in-bounds neighbour count),
// p = (1-w) p + w (neg_inv (dx d - nb)), even parity first.  Built with
// --fmad=false, bit-equal to the plain PyTorch version.

#include <cuda_runtime.h>

namespace {

// -1/a for a = 1..6, double divisions rounded to float (poisson.cpp:67)
__constant__ float kNegInv[7] = {
    0.f,
    (float)(-1.0 / 1.0),
    (float)(-1.0 / 2.0),
    (float)(-1.0 / 3.0),
    (float)(-1.0 / 4.0),
    (float)(-1.0 / 5.0),
    (float)(-1.0 / 6.0),
};

// One half-sweep over the cells with (z + i + j) % 2 == color; thread
// (m, i, z) owns column j = 2m + ((z + i + color) & 1).
__global__ void sor3d_half_sweep_kernel(float* __restrict__ p,
                                        const float* __restrict__ d, int D,
                                        int H, int W, int color, float dx,
                                        float omega, float one_m_w) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z;
  const int j = 2 * m + ((z + i + color) & 1);
  if (i >= H || j >= W) return;
  const long long plane = (long long)H * W;
  const long long c = z * plane + (long long)i * W + j;
  // zero ghosts outside the domain
  const float zm = z > 0 ? p[c - plane] : 0.f;
  const float zp = z < D - 1 ? p[c + plane] : 0.f;
  const float im = i > 0 ? p[c - W] : 0.f;
  const float ip = i < H - 1 ? p[c + W] : 0.f;
  const float jm = j > 0 ? p[c - 1] : 0.f;
  const float jp = j < W - 1 ? p[c + 1] : 0.f;
  const float nb = ((((zm + zp) + im) + ip) + jm) + jp;
  const int aii = 6 - (z == 0) - (z == D - 1) - (i == 0) - (i == H - 1) -
                  (j == 0) - (j == W - 1);
  p[c] = one_m_w * p[c] + omega * (kNegInv[aii] * (dx * d[c] - nb));
}

}  // namespace

// d, p: [D, H, W] float32 (p is the output; each of D, H, W >= 2).
extern "C" int fluid_sor3d(const void* d, void* p, int D, int H, int W,
                           float dx, int iters, float omega, float one_m_w,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(p);
  const float* dd = static_cast<const float*>(d);
  cudaError_t err = cudaMemsetAsync(pp, 0, sizeof(float) * (size_t)D * H * W,
                                    s);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(32, 8);
  const dim3 grid(((W + 1) / 2 + 31) / 32, (H + 7) / 8, D);
  for (int half = 0; half < 2 * iters; ++half) {
    sor3d_half_sweep_kernel<<<grid, block, 0, s>>>(pp, dd, D, H, W, half % 2,
                                                   dx, omega, one_m_w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
