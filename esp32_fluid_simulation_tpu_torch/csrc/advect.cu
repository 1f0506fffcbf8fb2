// 2D semi-Lagrangian advection with the CFL clamp, the no-slip discount, the
// fused dye clamp and the RGB565 frame riding the store (K2), and the
// MacCormack advection built on it (K5).
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
//
// K5 replaces esp32_fluid_simulation_tpu/ops/pallas/advect.py
// (advect_maccormack_pallas): a forward pass with the extrema of the four
// bilinear taps (the sloop kernel's return_minmax), a backward pass through
// -vel, then the limiter.  The backward pass samples phi_hat at points that
// other blocks write, so K5 takes two launches:
//   1. the advect kernel with MM = kCombined: phi_hat and the bounds
//      lo = min(cmin, phi_hat), hi = max(cmax, phi_hat) (min and max are
//      exact, so folding phi_hat in here equals doing it later);
//   2. maccormack_correct_kernel: backtrace through -vel, bilinear sample of
//      phi_hat, no-slip factor, phi_back rounded to the field dtype (as the
//      stored intermediate is), then phi_hat + 0.5 (field - phi_back)
//      clamped to [lo, hi], rounding to the field dtype after each op as
//      PyTorch's bf16 ops do.
// Bound: device-memory bytes.  The function needs the field and vel read
// once and the output written once; the two launches also write and re-read
// phi_hat, lo and hi (about 5x the field bytes in all).  Recomputing the
// extrema inside launch 2 instead of storing them is a later change.
//
// Tiled-domain mode (K6, the member= argument of advect_pallas,
// advect.py:112-165): the grid is a supergrid of independent mh x mw member
// tiles, and every domain clamp and the no-slip test act per tile.  The
// member origin lo = (i / mh) * mh is computed in integers (exact in float
// below 2^24); after the CFL clamp the sample is clamped to [lo, lo+mh-1],
// the base tap to [lo, lo+mh-2], and the no-slip factor is taken from
// si_raw - lo against mh.  The mode is a template flag, so the kernel
// without a member compiles to the code it had before.  It costs one
// integer division per axis and cell and no bytes.
//
// The overlay (K6, advect.py:601-607) is the drag queue's drain riding the
// store: a dense [C+1, H, W] float32 array whose channel C flags (> 0) the
// cells where channel ch replaces the advected value, after the no-slip
// factor and the clip and before the store in the field dtype.  It adds
// 4 B per cell of reads (the flag channel), and C x 4 B more only at the
// flagged cells.  Also a template flag; it combines with
// neither the extrema nor the frame, as in the TPU kernel.
//
// Block mode (K11, the global_offset= argument of advect_pallas,
// advect.py:741-747, 786-795, called per shard by parallel/sharded.py): the
// output and the velocity are one shard's owned H x W block at global
// (ox, oy) of a GH x GW domain, the field the same block with a halo of at
// least max_disp + 1 exchanged cells per side.  The backtrace, the clamps
// and the no-slip factor are computed in global float coordinates exactly
// as without block mode (integer-valued floats below 2^24 are exact), and
// only the tap addresses move: global row i0 is haloed row i0 - ox + halo
// (the TPU kernel's rel_i, advect.py:143).  So a block's cells are bit-equal
// to the same cells of the whole-grid launch.  A template flag; it takes
// the raw extrema (the sharded MacCormack's predictor) and the dye clip,
// not the member, the overlay or the frame, as in the TPU kernel.  It reads
// the field's halo ring beyond what the block's own launch would (about
// 2% more cells at a 4096^2 block with halo 13).

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

// min / max that propagate NaN like torch.minimum / torch.maximum (fminf
// and fmaxf would drop it)
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Round to the storage dtype T and back: identity for float32.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// What the advect kernel writes beside the field: nothing, the raw extrema
// of the four taps (return_minmax), or those combined with the stored value
// (K5's forward pass).
enum MinMax { kNone = 0, kRaw = 1, kCombined = 2 };

__device__ __forceinline__ int quant_unit(float v, int bits) {
  // clip01 bounds v to [0, 1], so min() alone bounds the code
  return min((int)(v * (float)(1 << bits)), (1 << bits) - 1);
}

// The bilinear stencil of one backtraced point: the base tap's global row
// and column, the weights and the no-slip factor (advect.py:81-167).
struct Stencil {
  int i0, j0;
  float di, dj, w_i0, one_m_dj, ns;
};

// From the unclamped source (si_raw, sj_raw) of node (i, j): the CFL clamp
// to max_disp cells, then the domain clamp (edge lerp) of the whole grid or,
// with MEMBER, of the node's mh x mw member tile; the no-slip factor from
// the unclamped coordinate (member-relative with MEMBER).
template <bool MEMBER>
__device__ __forceinline__ Stencil stencil(int i, int j, float si_raw,
                                           float sj_raw, int H, int W,
                                           float max_disp, int no_slip,
                                           int mh, int mw) {
  const float fi = (float)i;
  const float fj = (float)j;
  float si = fminf(fmaxf(si_raw, fi - max_disp), fi + max_disp);
  float sj = fminf(fmaxf(sj_raw, fj - max_disp), fj + max_disp);
  float i0f, j0f, ns;
  if constexpr (MEMBER) {
    const int oi = (i / mh) * mh;
    const int oj = (j / mw) * mw;
    const float lo_i = (float)oi;
    const float lo_j = (float)oj;
    si = fminf(fmaxf(si, lo_i), (float)(oi + mh - 1));
    sj = fminf(fmaxf(sj, lo_j), (float)(oj + mw - 1));
    i0f = fminf(fmaxf(floorf(si), lo_i), (float)(oi + mh - 2));
    j0f = fminf(fmaxf(floorf(sj), lo_j), (float)(oj + mw - 2));
    ns = no_slip ? noslip_factor(si_raw - lo_i, mh) *
                       noslip_factor(sj_raw - lo_j, mw)
                 : 1.f;
  } else {
    si = fminf(fmaxf(si, 0.f), (float)(H - 1));
    sj = fminf(fmaxf(sj, 0.f), (float)(W - 1));
    i0f = fminf(fmaxf(floorf(si), 0.f), (float)(H - 2));
    j0f = fminf(fmaxf(floorf(sj), 0.f), (float)(W - 2));
    ns = no_slip ? noslip_factor(si_raw, H) * noslip_factor(sj_raw, W) : 1.f;
  }
  Stencil s;
  s.di = si - i0f;
  s.dj = sj - j0f;
  s.w_i0 = 1.f - s.di;
  s.one_m_dj = 1.f - s.dj;
  s.i0 = (int)i0f;
  s.j0 = (int)j0f;
  s.ns = ns;
  return s;
}

// Column lerps, then the row lerp, then the no-slip factor.
__device__ __forceinline__ float bilerp(const Stencil& s, float t00,
                                        float t01, float t10, float t11,
                                        int no_slip) {
  const float colv0 = t00 * s.one_m_dj + t01 * s.dj;
  const float colv1 = t10 * s.one_m_dj + t11 * s.dj;
  const float a = colv0 * s.w_i0 + colv1 * s.di;
  return no_slip ? a * s.ns : a;
}

// Block mode's geometry: the owned block's global origin, the field's halo
// and the domain (halo = 0: not block mode).
struct Block {
  int ox, oy, halo, GH, GW;
};

// Everything one launch of the advect kernel takes.  out (and lo, hi) are
// [C, H, W] in the field dtype, the field too or, in block mode, [C, H +
// 2 halo, W + 2 halo]; overlay is [C+1, H, W] float32 or null; mh = 0 means
// no member tiling.
struct AdvectArgs {
  const void* field;
  const float* vel;
  const float* overlay;
  void* out;
  uint16_t* frame;
  void* lo;
  void* hi;
  int H, W, mh, mw;
  Block blk;
  float dt, max_disp;
  int no_slip, clip01, bswap;
  cudaStream_t stream;
};

template <typename T, int C, int MM, bool MEMBER, bool OVERLAY, bool BLOCK>
__global__ void advect_kernel(const T* __restrict__ field,
                              const float* __restrict__ vel,
                              const float* __restrict__ overlay,
                              T* __restrict__ out,
                              uint16_t* __restrict__ frame,
                              T* __restrict__ lo, T* __restrict__ hi, int H,
                              int W, int mh, int mw, const Block b, float dt,
                              float max_disp, int no_slip, int clip01,
                              int bswap) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= H || j >= W) return;
  const long plane = (long)H * W;
  const long c = (long)i * W + j;
  const int gi = BLOCK ? i + b.ox : i;
  const int gj = BLOCK ? j + b.oy : j;
  const Stencil s = stencil<MEMBER>(gi, gj, (float)gi - vel[c] * dt,
                                    (float)gj - vel[plane + c] * dt,
                                    BLOCK ? b.GH : H, BLOCK ? b.GW : W,
                                    max_disp, no_slip, mh, mw);
  // the field's row stride and plane, and the base tap within it
  const int fw = BLOCK ? W + 2 * b.halo : W;
  const long fplane = BLOCK ? (long)(H + 2 * b.halo) * fw : plane;
  const long base = BLOCK ? (long)(s.i0 - b.ox + b.halo) * fw +
                                (s.j0 - b.oy + b.halo)
                          : (long)s.i0 * W + s.j0;
  // the drain flag of the overlay (a NaN flag writes nothing)
  const bool drain = OVERLAY && overlay[C * plane + c] > 0.f;

  float stored[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    const T* f = field + ch * fplane;
    const float t00 = load(f, base);
    const float t01 = load(f, base + 1);
    const float t10 = load(f, base + fw);
    const float t11 = load(f, base + fw + 1);
    float a = bilerp(s, t00, t01, t10, t11, no_slip);
    if (clip01) a = fminf(fmaxf(a, 0.f), 1.f);
    if (drain) a = overlay[ch * plane + c];
    stored[ch] = store(out + ch * plane, c, a);
    if (MM != kNone) {
      // extrema of the undiscounted taps, exact in the field dtype
      float mn = min_nan(min_nan(t00, t01), min_nan(t10, t11));
      float mx = max_nan(max_nan(t00, t01), max_nan(t10, t11));
      if (MM == kCombined) {
        mn = min_nan(mn, stored[ch]);
        mx = max_nan(mx, stored[ch]);
      }
      store(lo + ch * plane, c, mn);
      store(hi + ch * plane, c, mx);
    }
  }

  if (!BLOCK && C == 3 && frame != nullptr && i < H - 1 && j < W - 1) {
    int word = (quant_unit(stored[0], 5) << 11) |
               (quant_unit(stored[1 % C], 6) << 5) |
               quant_unit(stored[2 % C], 5);
    if (bswap) word = ((word << 8) | (word >> 8)) & 0xFFFF;
    frame[(long)i * (W - 1) + j] = (uint16_t)word;
  }
}

template <typename T, int C, int MM, bool MEMBER, bool OVERLAY, bool BLOCK>
cudaError_t launch(const AdvectArgs& a) {
  const dim3 block(32, 8);
  const dim3 grid((a.W + block.x - 1) / block.x,
                  (a.H + block.y - 1) / block.y);
  advect_kernel<T, C, MM, MEMBER, OVERLAY, BLOCK>
      <<<grid, block, 0, a.stream>>>(
          static_cast<const T*>(a.field), a.vel, a.overlay,
          static_cast<T*>(a.out), C == 3 ? a.frame : nullptr,
          static_cast<T*>(a.lo), static_cast<T*>(a.hi), a.H, a.W, a.mh, a.mw,
          a.blk, a.dt, a.max_disp, a.no_slip, a.clip01, a.bswap);
  return cudaGetLastError();
}

// The member, overlay and block modes; the overlay only without extrema,
// block mode alone and without K5's combined extrema.
template <typename T, int C, int MM>
cudaError_t dispatch_mode(const AdvectArgs& a) {
  const bool member = a.mh > 0;
  if (a.blk.halo > 0) {
    if constexpr (MM != kCombined) {
      if (member || a.overlay != nullptr || a.frame != nullptr)
        return cudaErrorInvalidValue;
      return launch<T, C, MM, false, false, true>(a);
    } else {
      return cudaErrorInvalidValue;
    }
  }
  if (a.overlay != nullptr) {
    if constexpr (MM == kNone) {
      return member ? launch<T, C, MM, true, true, false>(a)
                    : launch<T, C, MM, false, true, false>(a);
    } else {
      return cudaErrorInvalidValue;
    }
  }
  return member ? launch<T, C, MM, true, false, false>(a)
                : launch<T, C, MM, false, false, false>(a);
}

template <typename T, int C>
cudaError_t dispatch_minmax(int minmax, const AdvectArgs& a) {
  switch (minmax) {
    case kNone:
      return dispatch_mode<T, C, kNone>(a);
    case kRaw:
      return dispatch_mode<T, C, kRaw>(a);
    case kCombined:
      return dispatch_mode<T, C, kCombined>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_channels(int C, int minmax, const AdvectArgs& a) {
  switch (C) {
    case 1:
      return dispatch_minmax<T, 1>(minmax, a);
    case 2:
      return dispatch_minmax<T, 2>(minmax, a);
    case 3:
      return dispatch_minmax<T, 3>(minmax, a);
    default:
      return cudaErrorInvalidValue;
  }
}

// K5 launch 2: phi_back = advect(phi_hat, -vel), then the limiter.  The
// backtrace x - dt*(-v) is written x + v*dt: negation is exact, so the two
// are bit-equal.
template <typename T, int C, bool MEMBER>
__global__ void maccormack_correct_kernel(
    const T* __restrict__ field, const T* __restrict__ phi_hat,
    const T* __restrict__ lo, const T* __restrict__ hi,
    const float* __restrict__ vel, T* __restrict__ out, int H, int W, int mh,
    int mw, float dt, float max_disp, int no_slip) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= H || j >= W) return;
  const long plane = (long)H * W;
  const long c = (long)i * W + j;

  const Stencil s = stencil<MEMBER>(i, j, (float)i + vel[c] * dt,
                                    (float)j + vel[plane + c] * dt, H, W,
                                    max_disp, no_slip, mh, mw);

  const long base = (long)s.i0 * W + s.j0;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    const T* f = phi_hat + ch * plane;
    const long k = ch * plane + c;
    const float back = round_to<T>(
        bilerp(s, load(f, base), load(f, base + 1), load(f, base + W),
               load(f, base + W + 1), no_slip));
    // phi_hat + 0.5 * (field - phi_back), rounded after each op
    const float diff = round_to<T>(load(field, k) - back);
    const float half = round_to<T>(0.5f * diff);
    const float corr = round_to<T>(load(phi_hat, k) + half);
    store(out, k, min_nan(max_nan(corr, load(lo, k)), load(hi, k)));
  }
}

template <typename T, int C, bool MEMBER>
cudaError_t launch_correct(const void* field, const void* phi_hat,
                           const void* lo, const void* hi, const void* vel,
                           void* out, int H, int W, int mh, int mw, float dt,
                           float max_disp, int no_slip, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
  maccormack_correct_kernel<T, C, MEMBER><<<grid, block, 0, stream>>>(
      static_cast<const T*>(field), static_cast<const T*>(phi_hat),
      static_cast<const T*>(lo), static_cast<const T*>(hi),
      static_cast<const float*>(vel), static_cast<T*>(out), H, W, mh, mw, dt,
      max_disp, no_slip);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t dispatch_correct_member(const void* field, const void* phi_hat,
                                    const void* lo, const void* hi,
                                    const void* vel, void* out, int H, int W,
                                    int mh, int mw, float dt, float max_disp,
                                    int no_slip, cudaStream_t stream) {
  if (mh > 0)
    return launch_correct<T, C, true>(field, phi_hat, lo, hi, vel, out, H, W,
                                      mh, mw, dt, max_disp, no_slip, stream);
  return launch_correct<T, C, false>(field, phi_hat, lo, hi, vel, out, H, W,
                                     mh, mw, dt, max_disp, no_slip, stream);
}

template <typename T>
cudaError_t dispatch_correct(int C, const void* field, const void* phi_hat,
                             const void* lo, const void* hi, const void* vel,
                             void* out, int H, int W, int mh, int mw,
                             float dt, float max_disp, int no_slip,
                             cudaStream_t stream) {
  switch (C) {
    case 1:
      return dispatch_correct_member<T, 1>(field, phi_hat, lo, hi, vel, out,
                                           H, W, mh, mw, dt, max_disp,
                                           no_slip, stream);
    case 2:
      return dispatch_correct_member<T, 2>(field, phi_hat, lo, hi, vel, out,
                                           H, W, mh, mw, dt, max_disp,
                                           no_slip, stream);
    case 3:
      return dispatch_correct_member<T, 3>(field, phi_hat, lo, hi, vel, out,
                                           H, W, mh, mw, dt, max_disp,
                                           no_slip, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// field, out: [C, H, W] float32 (field_bf16 = 0) or bfloat16 (= 1);
// vel: [2, H, W] float32; overlay: [C+1, H, W] float32 or null (only with
// minmax = 0); frame: [H-1, W-1] uint16 or null (C == 3 only); lo, hi:
// [C, H, W] in the field dtype, written when minmax is 1 (the raw tap
// extrema) or 2 (combined with the stored value), else null; mh, mw: the
// member tile (mh = 0: none; else mh, mw >= 2 dividing H, W).  Block mode
// when halo > 0 (no member, overlay or frame; minmax 0 or 1): out, vel, lo
// and hi are the owned H x W block at global (ox, oy) of a GH x GW domain,
// field is [C, H + 2 halo, W + 2 halo].
extern "C" int fluid_advect(const void* field, const void* vel,
                            const void* overlay, void* out, void* frame,
                            void* lo, void* hi, int C, int H, int W,
                            int field_bf16, float dt, int max_disp, int mh,
                            int mw, int ox, int oy, int halo, int GH, int GW,
                            int no_slip, int clip01, int bswap, int minmax,
                            void* stream) {
  const AdvectArgs a{field, static_cast<const float*>(vel),
                     static_cast<const float*>(overlay), out,
                     static_cast<uint16_t*>(frame), lo, hi, H, W, mh, mw,
                     Block{ox, oy, halo, GH, GW}, dt, (float)max_disp,
                     no_slip, clip01, bswap,
                     static_cast<cudaStream_t>(stream)};
  if (field_bf16) return (int)dispatch_channels<__nv_bfloat16>(C, minmax, a);
  return (int)dispatch_channels<float>(C, minmax, a);
}

// K5 launch 2.  field, phi_hat, lo, hi, out: [C, H, W] in the field dtype
// (phi_hat, lo, hi from fluid_advect with minmax = 2); vel: [2, H, W]
// float32, the forward velocity (the kernel backtraces through -vel); mh, mw
// as for fluid_advect.
extern "C" int fluid_maccormack_correct(const void* field,
                                        const void* phi_hat, const void* lo,
                                        const void* hi, const void* vel,
                                        void* out, int C, int H, int W,
                                        int field_bf16, float dt,
                                        int max_disp, int mh, int mw,
                                        int no_slip, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float md = (float)max_disp;
  if (field_bf16)
    return (int)dispatch_correct<__nv_bfloat16>(
        C, field, phi_hat, lo, hi, vel, out, H, W, mh, mw, dt, md, no_slip,
        s);
  return (int)dispatch_correct<float>(C, field, phi_hat, lo, hi, vel, out, H,
                                      W, mh, mw, dt, md, no_slip, s);
}
