// 3D semi-Lagrangian advection with the per-axis CFL clamp and the no-slip
// discount, for 1-4 channels stored in float32 or bfloat16.
//
// Replaces the TPU kernel esp32_fluid_simulation_tpu/ops/pallas/
// advect3d.py (advect3d_pallas / _advect3d_kernel).  That kernel DMAs a
// haloed window and walks every integer (z, row) shift with lane gathers
// over 128-lane panels (packed bf16 pairs, rolled copies), because a TPU
// core has no fast per-element gather.  Hopper does: here one thread owns
// one output cell and reads its eight trilinear taps of each channel
// directly through L1/L2.
//
// Bound on the H100: device-memory bytes.  Per cell it reads the velocity
// (12 B as float32), writes C channels, and reads the taps; the backtrace
// moves at most max_disp cells per axis, so neighbouring threads read
// neighbouring taps and the field is fetched from device memory about once.
// At 256^3 the velocity self-advect moves ~403 MB and the bf16 density +
// temperature pair ~336 MB.
//
// Arithmetic follows the TPU kernel (advect3d.py:83-243): the backtrace
// s = x - v*dt per axis, clamped to x +- max_disp, then to the domain; the
// lower tap floor(s) clamped to [0, n-2]; the accumulation in the kernel's
// order, z-shift outer and row-shift inner,
//   acc = ((c00 + c01) + c10) + c11,  c_ab = colv_ab * (wz_a * wi_b),
//   colv = f[j0] * (1 - dj) + f[j0+1] * dj,
// then the no-slip factor of the unclamped coordinates, (fz * fi) * fj, and
// the store in the field dtype (bf16: round to nearest even).  Computed in
// float32 whatever the storage.  Built with --fmad=false, bit-equal to the
// plain PyTorch version.
//
// Block mode (K11, the global_offset= argument of advect3d_pallas,
// advect3d.py:255-306, called per shard by parallel/sharded_smoke.py and
// parallel/sharded3d.py): vel and out are one shard's owned D x H x W block,
// whose cell (z, 0, 0) sits at global (z, ox, oy) of a D x GH x GW domain
// (the vertical axis is shard-local), and the field is the same block with
// `halo` exchanged cells on each side of the two horizontal axes.  The
// backtrace, both clamps and the no-slip factor run in global coordinates
// exactly as the whole-grid launch; only the tap addresses move: global
// row i0 is haloed row i0 - ox + halo (column likewise), with the field's
// own row and plane strides.  So a block's cells equal the whole grid's to
// the bit.  halo >= max_disp + 1 keeps every tap inside the haloed field.
// The TPU kernel's halo <= pr limit (its aligned sublane halo) has no
// counterpart here.
//
// Self-advect in block mode (SELF): the field is the haloed velocity, and
// the backtrace reads the velocity from its owned interior, (z, i + halo,
// j + halo), so the owned block is not read a second time.  A template
// flag: the other modes compile to the code they had.  A thread owning a
// run of 2 or 4 cells along W, with 8- or 16-byte velocity loads and
// stores where the rows allow them, was timed against a thread per cell
// and lost at 256^3 on the whole grid (PERF.md, PR 9), so a thread owns one
// cell.
//
// The plume's source and buoyancy (SOURCE, the whole grid's scalar launch,
// models/smoke3d.py inject_and_buoy): density and temperature are read
// through two pointers, and the thread that owns a cell, which alone reads
// that cell's velocity, finishes its step there before the stores:
//   rho  = min(bf16(bf16(rho_adv) + bf16(rho_in * src)), 1)  (NaN kept)
//   temp = bf16(bf16(temp_adv) + bf16(temp_in * src))
//   vel[0] -= (alpha * temp - beta * rho) * dt               (float32)
// with src the mask's cell, each operation rounded where PyTorch rounds it,
// so the step stays bit-equal to the advection followed by inject_and_buoy's
// eager ops.  The velocity is the
// step's own, fresh from the self-advect: axis 0 is written in place, through
// a pointer that is not restrict-qualified.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float load(const float* p, long long k) {
  return p[k];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long k) {
  return __bfloat162float(p[k]);
}
__device__ __forceinline__ void store(float* p, long long k, float v) {
  p[k] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, long long k,
                                      float v) {
  p[k] = __float2bfloat16_rn(v);
}
// a float32 value rounded to the storage dtype T and back
__device__ __forceinline__ float rounded(const float*, float v) { return v; }
__device__ __forceinline__ float rounded(const __nv_bfloat16*, float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

// The clamped backtrace coordinate along one axis of n nodes.
__device__ __forceinline__ float source(float x, float raw, float md, int n) {
  const float s = fminf(fmaxf(raw, x - md), x + md);
  return fminf(fmaxf(s, 0.f), (float)(n - 1));
}

// Block mode's geometry: the owned block's global origin, the field's halo
// and the domain's rows and columns (halo = 0: not block mode).
struct Block {
  int ox, oy, halo, GH, GW;
};

// SOURCE's operands: the temperature (field channel 1), the mask (field
// dtype), the velocity written in place, the injections dt * rate and the
// buoyancy's alpha and beta.
struct Source {
  const void* field1;
  const void* mask;
  void* vel;
  float rho_in, temp_in, alpha, beta;
};

template <typename T, typename V, bool BLOCK, bool SELF, bool SOURCE>
__global__ void advect3d_kernel(const T* __restrict__ field,
                                const V* __restrict__ vel,
                                T* __restrict__ out, int C, int D, int H,
                                int W, float dt, float md, int no_slip,
                                const Block b, const Source src) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z;
  if (i >= H || j >= W) return;
  const long long plane = (long long)H * W;
  const long long vol = plane * D;
  const long long c = z * plane + (long long)i * W + j;
  // the domain, and the field's strides (the haloed block's in block mode)
  const int GH = BLOCK ? b.GH : H;
  const int GW = BLOCK ? b.GW : W;
  const int FW = BLOCK ? W + 2 * b.halo : W;
  const long long fplane = BLOCK ? (long long)(H + 2 * b.halo) * FW : plane;
  const long long fvol = fplane * D;
  const float zf = (float)z;
  const float xi = (float)(BLOCK ? i + b.ox : i);
  const float xj = (float)(BLOCK ? j + b.oy : j);
  // the velocity: the owned block's, or (SELF) the haloed field's owned
  // interior
  const long long vc =
      SELF ? z * fplane + (long long)(i + b.halo) * FW + (j + b.halo) : c;
  const long long vvol = SELF ? fvol : vol;
  const V* v = SOURCE ? static_cast<const V*>(src.vel) : vel;
  const float v0 = load(v, vc);
  const float sz_raw = zf - v0 * dt;
  const float si_raw = xi - load(v, vvol + vc) * dt;
  const float sj_raw = xj - load(v, 2 * vvol + vc) * dt;
  const float sz = source(zf, sz_raw, md, D);
  const float si = source(xi, si_raw, md, GH);
  const float sj = source(xj, sj_raw, md, GW);
  const float z0 = fminf(fmaxf(floorf(sz), 0.f), (float)(D - 2));
  const float i0 = fminf(fmaxf(floorf(si), 0.f), (float)(GH - 2));
  const float j0 = fminf(fmaxf(floorf(sj), 0.f), (float)(GW - 2));
  const float dz = sz - z0;
  const float di = si - i0;
  const float dj = sj - j0;
  const float one_m_dj = 1.f - dj;
  const float w00 = (1.f - dz) * (1.f - di);
  const float w01 = (1.f - dz) * di;
  const float w10 = dz * (1.f - di);
  const float w11 = dz * di;
  // the base tap's global row and column, shifted into the field
  const int ti = BLOCK ? b.halo - b.ox : 0;
  const int tj = BLOCK ? b.halo - b.oy : 0;
  const long long t = (long long)z0 * fplane + ((long long)i0 + ti) * FW +
                      ((int)j0 + tj);
  float ns = 1.f;
  if (no_slip)
    ns = (noslip_factor(sz_raw, D) * noslip_factor(si_raw, GH)) *
         noslip_factor(sj_raw, GW);
  float acc0 = 0.f, acc1 = 0.f;  // SOURCE: density and temperature
  for (int ch = 0; ch < C; ++ch) {
    const T* f =
        (SOURCE ? (ch == 0 ? field : static_cast<const T*>(src.field1))
                : field + ch * fvol) +
        t;
    const float c00 = (load(f, 0) * one_m_dj + load(f, 1) * dj) * w00;
    const float c01 = (load(f, FW) * one_m_dj + load(f, FW + 1) * dj) * w01;
    const float c10 =
        (load(f, fplane) * one_m_dj + load(f, fplane + 1) * dj) * w10;
    const float c11 =
        (load(f, fplane + FW) * one_m_dj + load(f, fplane + FW + 1) * dj) *
        w11;
    float acc = ((c00 + c01) + c10) + c11;
    if (no_slip) acc = acc * ns;
    if (!SOURCE)
      store(out, ch * vol + c, acc);
    else if (ch == 0)
      acc0 = acc;
    else
      acc1 = acc;
  }
  if (SOURCE) {
    const float s = load(static_cast<const T*>(src.mask), c);
    float rho = rounded(out, rounded(out, acc0) +
                                 rounded(out, src.rho_in * s));
    if (rho > 1.f) rho = 1.f;  // torch.clamp(max=1): NaN passes
    const float temp = rounded(out, rounded(out, acc1) +
                                        rounded(out, src.temp_in * s));
    const float buoy = (src.alpha * temp - src.beta * rho) * dt;
    store(static_cast<V*>(src.vel), c, v0 - buoy);
    store(out, c, rho);
    store(out, vol + c, temp);
  }
}

template <typename T, typename V, bool BLOCK, bool SELF, bool SOURCE = false>
cudaError_t launch_mode(const void* field, const void* vel, void* out, int C,
                        int D, int H, int W, float dt, float md, int no_slip,
                        const Block& b, cudaStream_t stream,
                        const Source& src = Source{}) {
  const dim3 block(32, 8);
  const dim3 grid((W + 31) / 32, (H + 7) / 8, D);
  advect3d_kernel<T, V, BLOCK, SELF, SOURCE><<<grid, block, 0, stream>>>(
      static_cast<const T*>(field), static_cast<const V*>(vel),
      static_cast<T*>(out), C, D, H, W, dt, md, no_slip, b, src);
  return cudaGetLastError();
}

// The whole grid, block mode, or block mode's self-advect (vel null: the
// velocity is the field's owned interior, in the field's dtype).
template <typename T, typename V>
cudaError_t launch(const void* field, const void* vel, void* out, int C,
                   int D, int H, int W, float dt, float md, int no_slip,
                   const Block& b, cudaStream_t s) {
  if (b.halo == 0)
    return launch_mode<T, V, false, false>(field, vel, out, C, D, H, W, dt,
                                           md, no_slip, b, s);
  if (vel != nullptr)
    return launch_mode<T, V, true, false>(field, vel, out, C, D, H, W, dt,
                                          md, no_slip, b, s);
  if (C != 3) return cudaErrorInvalidValue;
  return launch_mode<T, T, true, true>(field, field, out, C, D, H, W, dt, md,
                                       no_slip, b, s);
}

}  // namespace

// field, out: [C, D, H, W] float32 (field_bf16 = 0) or bfloat16 (= 1);
// vel: [3, D, H, W] float32 (vel_bf16 = 0) or bfloat16 (= 1).  Block mode
// when halo > 0: vel and out are the owned block at global (ox, oy) of a
// D x GH x GW domain and field is [C, D, H + 2 halo, W + 2 halo]; there a
// null vel is the self-advect (field the haloed velocity, C = 3, vel_bf16
// ignored).
extern "C" int fluid_advect3d(const void* field, const void* vel, void* out,
                              int C, int D, int H, int W, int field_bf16,
                              int vel_bf16, float dt, int max_disp,
                              int no_slip, int ox, int oy, int halo, int GH,
                              int GW, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float md = (float)max_disp;
  const Block b{ox, oy, halo, GH, GW};
  if (vel == nullptr && halo == 0) return (int)cudaErrorInvalidValue;
  if (field_bf16)
    return (int)(vel_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(
                                field, vel, out, C, D, H, W, dt, md, no_slip,
                                b, s)
                          : launch<__nv_bfloat16, float>(
                                field, vel, out, C, D, H, W, dt, md, no_slip,
                                b, s));
  return (int)(vel_bf16 ? launch<float, __nv_bfloat16>(field, vel, out, C, D,
                                                        H, W, dt, md,
                                                        no_slip, b, s)
                        : launch<float, float>(field, vel, out, C, D, H, W,
                                               dt, md, no_slip, b, s));
}

// The plume's scalar launch with its source and buoyancy (SOURCE): rho and
// temp [D, H, W] bfloat16 (the density and temperature, read through two
// pointers), vel [3, D, H, W] float32 (axis 0 receives the force in place),
// out [2, D, H, W] bfloat16, mask [D, H, W] bfloat16; rho_in and temp_in
// the injections dt * rate, alpha and beta the buoyancy's.
extern "C" int fluid_advect3d_source(const void* rho, const void* temp,
                                     void* vel, void* out, const void* mask,
                                     int D, int H, int W, float dt,
                                     int max_disp, int no_slip,
                                     float rho_in, float temp_in,
                                     float alpha, float beta, void* stream) {
  const Source src{temp, mask, vel, rho_in, temp_in, alpha, beta};
  const Block b{0, 0, 0, H, W};
  // the kernel reads and writes the velocity through src.vel only
  return (int)launch_mode<__nv_bfloat16, float, false, false, true>(
      rho, nullptr, out, 2, D, H, W, dt, (float)max_disp, no_slip, b,
      static_cast<cudaStream_t>(stream), src);
}
