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
//
// Block mode (K11, _sor3d_chunk, sor3d.py:246-259, the chunk of the
// sharded steps' solve, parallel/sharded3d.py): d and p are one shard's
// haloed block, whose cell (0, 0, 0) sits at global (oz, oi, oj) of a
// GD x GH x GW domain, and `sweeps` sweeps run on the whole block from the
// given p, not from zero.  The half-sweep takes a 3D Geom, as
// csrc/rb2d.cuh's does in 2D: walls, a_ii and the colour (gz + gi + gj) & 1
// come from the global coordinates; a neighbour beyond the array reads 0
// and a neighbour beyond a global wall reads 0 and leaves a_ii, two
// separate tests; cells outside the domain are never updated.  A first
// launch copies p into the output with 0 outside the domain.  Wrong values
// in the outer ring travel one cell per half-sweep, so with a halo of at
// least 2 * sweeps exchanged cells the owned block of a chain of chunks
// equals the whole-grid solve's to the bit.  The TPU kernel's limit of
// 64 sweeps a chunk (its fixed 128-lane column halo) has no counterpart.

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

// Where an array lies in its domain: its extent, the global position of
// its cell (0, 0, 0) and the domain's extent (the origin 0 and the domain
// the array without block mode).
struct Geom3 {
  int D, H, W, oz, oi, oj, GD, GH, GW;
};

__device__ __forceinline__ bool in_domain(int gz, int gi, int gj,
                                          const Geom3& g) {
  return gz >= 0 && gz < g.GD && gi >= 0 && gi < g.GH && gj >= 0 &&
         gj < g.GW;
}

// One half-sweep over the cells with (gz + gi + gj) % 2 == color; thread
// (m, i, z) owns column j = 2m + ((z + i + oz + oi + oj + color) & 1).
template <bool BLOCK>
__global__ void sor3d_half_sweep_kernel(float* __restrict__ p,
                                        const float* __restrict__ d,
                                        const Geom3 g, int color, float dx,
                                        float omega, float one_m_w) {
  const int D = g.D, H = g.H, W = g.W;
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z;
  // & 1, not %: the origin is negative on an edge shard
  const int j = 2 * m + ((BLOCK ? z + i + g.oz + g.oi + g.oj + color
                                : z + i + color) & 1);
  if (i >= H || j >= W) return;
  const int gz = BLOCK ? z + g.oz : z;
  const int gi = BLOCK ? i + g.oi : i;
  const int gj = BLOCK ? j + g.oj : j;
  if (BLOCK && !in_domain(gz, gi, gj, g)) return;  // held at 0
  const int GD = BLOCK ? g.GD : D, GH = BLOCK ? g.GH : H;
  const int GW = BLOCK ? g.GW : W;
  const long long plane = (long long)H * W;
  const long long c = z * plane + (long long)i * W + j;
  // the walls of the domain, and of the array in block mode
  const bool z_lo = gz == 0, z_hi = gz == GD - 1;
  const bool i_lo = gi == 0, i_hi = gi == GH - 1;
  const bool j_lo = gj == 0, j_hi = gj == GW - 1;
  // zero ghosts beyond the walls (and beyond the array in block mode)
  const float zm = (z_lo || (BLOCK && z == 0)) ? 0.f : p[c - plane];
  const float zp = (z_hi || (BLOCK && z == D - 1)) ? 0.f : p[c + plane];
  const float im = (i_lo || (BLOCK && i == 0)) ? 0.f : p[c - W];
  const float ip = (i_hi || (BLOCK && i == H - 1)) ? 0.f : p[c + W];
  const float jm = (j_lo || (BLOCK && j == 0)) ? 0.f : p[c - 1];
  const float jp = (j_hi || (BLOCK && j == W - 1)) ? 0.f : p[c + 1];
  const float nb = ((((zm + zp) + im) + ip) + jm) + jp;
  const int aii = 6 - z_lo - z_hi - i_lo - i_hi - j_lo - j_hi;
  p[c] = one_m_w * p[c] + omega * (kNegInv[aii] * (dx * d[c] - nb));
}

// p_out = p_in inside the domain, 0 outside (block mode's first launch).
__global__ void sor3d_block_init_kernel(const float* __restrict__ p_in,
                                        float* __restrict__ p_out,
                                        const Geom3 g) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z;
  if (i >= g.H || j >= g.W) return;
  const long long c = z * (long long)g.H * g.W + (long long)i * g.W + j;
  p_out[c] = in_domain(z + g.oz, i + g.oi, j + g.oj, g) ? p_in[c] : 0.f;
}

// 2*sweeps half-sweeps, even parity first, in place on p (blocks of 32x8
// threads, half a row's width each, one plane each on grid.z).  Returns the
// first launch error.
template <bool BLOCK>
cudaError_t half_sweeps(float* p, const float* d, const Geom3& g, int sweeps,
                        float dx, float omega, float one_m_w,
                        cudaStream_t s) {
  const dim3 block(32, 8);
  const dim3 grid(((g.W + 1) / 2 + 31) / 32, (g.H + 7) / 8, g.D);
  for (int half = 0; half < 2 * sweeps; ++half) {
    sor3d_half_sweep_kernel<BLOCK><<<grid, block, 0, s>>>(
        p, d, g, half % 2, dx, omega, one_m_w);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// d, p: [D, H, W] float32 (p is the output; each of D, H, W >= 2).
extern "C" int fluid_sor3d(const void* d, void* p, int D, int H, int W,
                           float dx, int iters, float omega, float one_m_w,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(p);
  const cudaError_t err = cudaMemsetAsync(
      pp, 0, sizeof(float) * (size_t)D * H * W, s);
  if (err != cudaSuccess) return (int)err;
  return (int)half_sweeps<false>(pp, static_cast<const float*>(d),
                                 Geom3{D, H, W, 0, 0, 0, D, H, W}, iters, dx,
                                 omega, one_m_w, s);
}

// d, p_in, p_out: one shard's [D, H, W] float32 haloed block, whose cell
// (0, 0, 0) sits at global (oz, oi, oj) of a GD x GH x GW domain; p_out
// (not p_in) gets `sweeps` sweeps from p_in.
extern "C" int fluid_sor3d_chunk(const void* d, const void* p_in,
                                 void* p_out, int D, int H, int W, int oz,
                                 int oi, int oj, int GD, int GH, int GW,
                                 float dx, int sweeps, float omega,
                                 float one_m_w, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(p_out);
  const Geom3 g{D, H, W, oz, oi, oj, GD, GH, GW};
  const dim3 block(32, 8);
  const dim3 grid((W + 31) / 32, (H + 7) / 8, D);
  sor3d_block_init_kernel<<<grid, block, 0, s>>>(
      static_cast<const float*>(p_in), pp, g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)half_sweeps<true>(pp, static_cast<const float*>(d), g, sweeps,
                                dx, omega, one_m_w, s);
}
