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
// -vel, then the limiter.  The backward pass samples phi_hat only a few
// cells from each node, so K5 is one launch (maccormack_tile_kernel): each
// block owns a TH x TW tile and
//   1. reads its cells' velocities and works out its reach per axis,
//      r = min(ceil(max |v*dt|), max_disp) + 1 over the tile (a NaN or inf
//      velocity counts as max_disp: the CFL clamp sends its source there);
//      the backward taps of its cells lie within r of them;
//   2. computes phi_hat (K2's forward arithmetic, rounded to the field
//      dtype, as the stored intermediate was) over the tile +- r, clipped to
//      the domain or, with MEMBER, to the member tiles the tile touches,
//      into shared memory, and its own cells' tap extrema, combined with
//      phi_hat (min and max are exact), beside it;
//   3. after a barrier, backtraces each own cell through -vel, samples
//      phi_hat from shared memory, and applies the limiter: phi_back
//      rounded to the field dtype, then phi_hat + 0.5 (field - phi_back)
//      clamped to [lo, hi], rounding after each op as PyTorch's bf16 ops do.
// Only the output goes to device memory.  The function's bound is
// device-memory bytes (the field and vel read once, the output written
// once).  At config 3 (2048^2, mean reach 2) the kernel moves 22-29% of
// the two-launch route's bytes at 31-38% of its rate; what holds the rate
// down is not measured (PERF.md, section 6).  The ring of the
// window repeats K2's gathers for (TH + 2r)(TW + 2r) / (TH TW) - 1 of the
// tile.  A thread keeps no cell state across the barriers: it re-reads its
// cells' velocities, and the limiter's bounds wait in shared memory
// (tools/torch_k5_variants.py times the design that holds both in
// registers).  The window's shared memory is sized for the worst case,
// r = max_disp + 1; where that does not fit a block, fluid_maccormack
// launches nothing and says so, and the wrapper takes the two-launch
// route: K2 with the raw extrema, then maccormack_correct_kernel, which
// combines them with phi_hat.

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
// On a member stack (csrc/stack.cuh; the ensemble's [n, C, mh, mw] state,
// with a [n, 2, mh, mw] velocity) the member mode reads and writes the
// stack in place: every coordinate, clamp and weight is the supergrid's,
// and only the loads of the cell's velocity and the store move, and the
// taps, which MEMBER keeps inside the cell's member, sit at the same
// offsets from the cell as on the supergrid with the row stride mw.  The
// launch walks the members (grid.z), a block 32 x 4 cells of one, so a
// thread's addresses and its tile's origin take one division, the
// member's row of tiles, the same across the block: in the supergrid's
// order, with the member tiles found by division, the self-advect took
// 15% longer than the supergrid member mode, and in this order about as
// long (PERF.md, section 6).  A template flag beside
// MEMBER; it takes the overlay (still [C+1, H, W] on the supergrid) and
// the dye clip, not the extrema, the frame or block mode.
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

#include "stack.cuh"

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

// What the advect kernel writes beside the field: nothing, or the raw
// extrema of the four taps (return_minmax).
enum MinMax { kNone = 0, kRaw = 1 };

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
// with MEMBER, of the node's mh x mw member tile, whose origin (oi, oj) is
// (i / mh) * mh, (j / mw) * mw unless the caller has it (oi >= 0); the
// no-slip factor from the unclamped coordinate (member-relative with
// MEMBER).
template <bool MEMBER>
__device__ __forceinline__ Stencil stencil(int i, int j, float si_raw,
                                           float sj_raw, int H, int W,
                                           float max_disp, int no_slip,
                                           int mh, int mw, int oi = -1,
                                           int oj = -1) {
  const float fi = (float)i;
  const float fj = (float)j;
  float si = fminf(fmaxf(si_raw, fi - max_disp), fi + max_disp);
  float sj = fminf(fmaxf(sj_raw, fj - max_disp), fj + max_disp);
  float i0f, j0f, ns;
  if constexpr (MEMBER) {
    if (oi < 0) {
      oi = (i / mh) * mh;
      oj = (j / mw) * mw;
    }
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
// no member tiling.  With stack, field and out are member stacks [n, C,
// mh, mw] and vel [n, 2, mh, mw] of the H x W supergrid.
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
  int no_slip, clip01, bswap, stack;
  cudaStream_t stream;
};

template <typename T, int C, int MM, bool MEMBER, bool OVERLAY, bool BLOCK,
          bool STACK>
__global__ void advect_kernel(const T* __restrict__ field,
                              const float* __restrict__ vel,
                              const float* __restrict__ overlay,
                              T* __restrict__ out,
                              uint16_t* __restrict__ frame,
                              T* __restrict__ lo, T* __restrict__ hi, int H,
                              int W, int mh, int mw, int gw, const Block b,
                              float dt, float max_disp, int no_slip,
                              int clip01, int bswap) {
  // the cell (i, j), its place in the velocity (vc) and in the field and
  // the output (oc) and, on the stack, its member tile's origin (oi, oj): a
  // block there walks a member's rows and columns (grid.z the member, gw
  // members a row of tiles), so a thread's addresses and tile take one
  // division, the block's tile row
  int i, j, oi = -1, oj = -1;
  long vc, oc;
  if constexpr (STACK) {
    const int r = blockIdx.y * blockDim.y + threadIdx.y;
    const int cc = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= mh || cc >= mw) return;
    const int m = blockIdx.z;
    const int qi = m / gw;
    oi = qi * mh;
    oj = (m - qi * gw) * mw;
    i = oi + r;
    j = oj + cc;
    const long cells = (long)mh * mw, loc = (long)r * mw + cc;
    vc = m * (2 * cells) + loc;
    oc = m * (C * cells) + loc;
  } else {
    j = blockIdx.x * blockDim.x + threadIdx.x;
    i = blockIdx.y * blockDim.y + threadIdx.y;
    if (i >= H || j >= W) return;
    vc = oc = (long)i * W + j;
  }
  const long plane = (long)H * W;
  const long c = (long)i * W + j;  // on the supergrid: the overlay, the frame
  const long oplane = plane_of<STACK>(H, W, mh, mw);
  const int gi = BLOCK ? i + b.ox : i;
  const int gj = BLOCK ? j + b.oy : j;
  const Stencil s = stencil<MEMBER>(gi, gj, (float)gi - vel[vc] * dt,
                                    (float)gj - vel[oplane + vc] * dt,
                                    BLOCK ? b.GH : H, BLOCK ? b.GW : W,
                                    max_disp, no_slip, mh, mw, oi, oj);
  // the field's row stride and plane, and the base tap within it (on the
  // stack the taps lie in the cell's member, at the supergrid's offsets
  // from the cell with the row stride mw)
  const int fw = BLOCK ? W + 2 * b.halo : STACK ? mw : W;
  const long fplane = BLOCK ? (long)(H + 2 * b.halo) * fw : oplane;
  const long base = BLOCK   ? (long)(s.i0 - b.ox + b.halo) * fw +
                                (s.j0 - b.oy + b.halo)
                    : STACK ? oc + (long)(s.i0 - i) * mw + (s.j0 - j)
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
    stored[ch] = store(out + ch * oplane, oc, a);
    if (MM == kRaw) {
      // extrema of the undiscounted taps, exact in the field dtype
      store(lo + ch * plane, c, min_nan(min_nan(t00, t01), min_nan(t10, t11)));
      store(hi + ch * plane, c, max_nan(max_nan(t00, t01), max_nan(t10, t11)));
    }
  }

  if (!BLOCK && !STACK && C == 3 && frame != nullptr && i < H - 1 &&
      j < W - 1) {
    int word = (quant_unit(stored[0], 5) << 11) |
               (quant_unit(stored[1 % C], 6) << 5) |
               quant_unit(stored[2 % C], 5);
    if (bswap) word = ((word << 8) | (word >> 8)) & 0xFFFF;
    frame[(long)i * (W - 1) + j] = (uint16_t)word;
  }
}

template <typename T, int C, int MM, bool MEMBER, bool OVERLAY, bool BLOCK,
          bool STACK = false>
cudaError_t launch(const AdvectArgs& a) {
  // on the stack a block is 32 x 4 cells of a member, grid.z the members
  // (32 x 8 took ~2.5% longer there, 64 x 2 as long; PERF.md)
  const dim3 block(32, STACK ? 4 : 8);
  const dim3 grid =
      STACK ? dim3((a.mw + block.x - 1) / block.x,
                   (a.mh + block.y - 1) / block.y, (a.H / a.mh) * (a.W / a.mw))
            : dim3((a.W + block.x - 1) / block.x,
                   (a.H + block.y - 1) / block.y);
  advect_kernel<T, C, MM, MEMBER, OVERLAY, BLOCK, STACK>
      <<<grid, block, 0, a.stream>>>(
          static_cast<const T*>(a.field), a.vel, a.overlay,
          static_cast<T*>(a.out), C == 3 ? a.frame : nullptr,
          static_cast<T*>(a.lo), static_cast<T*>(a.hi), a.H, a.W, a.mh, a.mw,
          STACK ? a.W / a.mw : 0, a.blk, a.dt, a.max_disp, a.no_slip,
          a.clip01, a.bswap);
  return cudaGetLastError();
}

// The member, overlay and block modes; the overlay only without extrema,
// block mode alone, the member stack only with members and without
// extrema or frame.
template <typename T, int C, int MM>
cudaError_t dispatch_mode(const AdvectArgs& a) {
  const bool member = a.mh > 0;
  if (a.blk.halo > 0) {
    if (member || a.overlay != nullptr || a.frame != nullptr || a.stack)
      return cudaErrorInvalidValue;
    return launch<T, C, MM, false, false, true>(a);
  }
  if (a.stack) {
    if constexpr (MM == kNone) {
      if (!member || a.frame != nullptr) return cudaErrorInvalidValue;
      return a.overlay != nullptr
                 ? launch<T, C, MM, true, true, false, true>(a)
                 : launch<T, C, MM, true, false, false, true>(a);
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

// K5's two-launch route, launch 2: phi_back = advect(phi_hat, -vel), then
// the limiter, with the raw tap extrema cmin, cmax of launch 1 (K2 with
// kRaw) combined with phi_hat here.  The backtrace x - dt*(-v) is written
// x + v*dt: negation is exact, so the two are bit-equal.
template <typename T, int C, bool MEMBER>
__global__ void maccormack_correct_kernel(
    const T* __restrict__ field, const T* __restrict__ phi_hat,
    const T* __restrict__ cmin, const T* __restrict__ cmax,
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
    const float ph = load(phi_hat, k);
    const float diff = round_to<T>(load(field, k) - back);
    const float half = round_to<T>(0.5f * diff);
    const float corr = round_to<T>(ph + half);
    const float lo = min_nan(load(cmin, k), ph);
    const float hi = max_nan(load(cmax, k), ph);
    store(out, k, min_nan(max_nan(corr, lo), hi));
  }
}

template <typename T, int C, bool MEMBER>
cudaError_t launch_correct(const void* field, const void* phi_hat,
                           const void* cmin, const void* cmax,
                           const void* vel, void* out, int H, int W, int mh,
                           int mw, float dt, float max_disp, int no_slip,
                           cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
  maccormack_correct_kernel<T, C, MEMBER><<<grid, block, 0, stream>>>(
      static_cast<const T*>(field), static_cast<const T*>(phi_hat),
      static_cast<const T*>(cmin), static_cast<const T*>(cmax),
      static_cast<const float*>(vel), static_cast<T*>(out), H, W, mh, mw, dt,
      max_disp, no_slip);
  return cudaGetLastError();
}

// K5's window route.  A block of kThreads threads owns a TH x TW tile;
// thread t takes the tile's cells t, t + kThreads, ... in row-major order,
// so a warp's loads and stores of a row are contiguous.  32 x 32 beat
// 16 x 64 and 32 x 64 at config 3 on the H100 (PERF.md, section 6).
constexpr int kThreads = 256;
constexpr int TH = 32, TW = 32;

// What fluid_maccormack returns where the window does not fit a block of
// the current device (CUDA's error codes are not negative).
constexpr int kWindowTooLarge = -1;

// The reach of a backtrace moved by d = v*dt cells along one axis, less the
// tap beyond it: the CFL clamp bounds it by max_disp, and a NaN or inf
// velocity clamps the source to x - max_disp, so anything that is not
// <= max_disp counts as max_disp.
__device__ __forceinline__ int reach_of(float d, float max_disp) {
  const float a = fabsf(d);
  return a <= max_disp ? (int)ceilf(a) : (int)max_disp;
}

// K2's forward pass at node (i, j) displaced by (d0, d1) = v*dt: phi_hat
// of each channel, rounded to the field dtype, into dst (channel planes
// wplane apart) and, with EXT, the four taps' extrema combined with it.
template <typename T, int C, bool MEMBER, bool EXT>
__device__ __forceinline__ void forward_cell(const T* __restrict__ field,
                                             int i, int j, float d0, float d1,
                                             int H, int W, int mh, int mw,
                                             float max_disp, int no_slip,
                                             T* dst, int wplane, float* lo,
                                             float* hi) {
  const Stencil s = stencil<MEMBER>(i, j, (float)i - d0, (float)j - d1, H,
                                    W, max_disp, no_slip, mh, mw);
  const long plane = (long)H * W;
  const long base = (long)s.i0 * W + s.j0;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    const T* f = field + ch * plane;
    const float t00 = load(f, base);
    const float t01 = load(f, base + 1);
    const float t10 = load(f, base + W);
    const float t11 = load(f, base + W + 1);
    const float v = store(dst + ch * wplane, 0,
                          bilerp(s, t00, t01, t10, t11, no_slip));
    if constexpr (EXT) {
      lo[ch] = min_nan(min_nan(min_nan(t00, t01), min_nan(t10, t11)), v);
      hi[ch] = max_nan(max_nan(max_nan(t00, t01), max_nan(t10, t11)), v);
    }
  }
}

// Shared memory: the window of phi_hat, [C][TH + 2R][TW + 2R] for the
// largest reach R = max_disp + 1, then the tile's bounds lo and hi,
// [2][C][TH * TW], all in the field dtype (the bounds are exact there: the
// extrema of values of that dtype).
template <typename T, int C, bool MEMBER>
__global__ void __launch_bounds__(kThreads)
    maccormack_tile_kernel(const T* __restrict__ field,
                           const float* __restrict__ vel, T* __restrict__ out,
                           int H, int W, int mh, int mw, float dt,
                           float max_disp, int no_slip) {
  constexpr int NC = TH * TW;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int reach[2];
  // node (i, j) at win[ch * wplane + (i - wo_i) * pw + (j - wo_j)]
  const int R = (int)max_disp + 1;
  const int pw = TW + 2 * R;
  const int wplane = (TH + 2 * R) * pw;
  T* win = reinterpret_cast<T*>(smem);
  T* bounds = win + C * wplane;
  const int tid = threadIdx.x;
  const int ti0 = blockIdx.y * TH, tj0 = blockIdx.x * TW;
  const int ti1 = min(ti0 + TH, H), tj1 = min(tj0 + TW, W);
  const int wo_i = ti0 - R, wo_j = tj0 - R;
  const long plane = (long)H * W;
  if (tid == 0) reach[0] = reach[1] = 0;

  // own cells: the reach, phi_hat and the limiter's bounds
  int ri = 0, rj = 0;
  for (int k = tid; k < NC; k += kThreads) {
    const int i = ti0 + k / TW, j = tj0 + k % TW;
    if (i >= H || j >= W) continue;
    const long c = (long)i * W + j;
    const float d0 = vel[c] * dt;
    const float d1 = vel[plane + c] * dt;
    ri = max(ri, reach_of(d0, max_disp));
    rj = max(rj, reach_of(d1, max_disp));
    float lo[C], hi[C];
    forward_cell<T, C, MEMBER, true>(
        field, i, j, d0, d1, H, W, mh, mw, max_disp, no_slip,
        win + (i - wo_i) * pw + (j - wo_j), wplane, lo, hi);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      store(bounds, ch * NC + k, lo[ch]);
      store(bounds, (C + ch) * NC + k, hi[ch]);
    }
  }
  ri = __reduce_max_sync(0xffffffffu, ri);
  rj = __reduce_max_sync(0xffffffffu, rj);
  __syncthreads();  // reach[] zeroed
  if (tid % 32 == 0) {
    atomicMax(&reach[0], ri);
    atomicMax(&reach[1], rj);
  }
  __syncthreads();

  // the window: the tile +- the reach, clipped to the domain or to the
  // member tiles that the tile touches
  int lo_i = 0, hi_i = H, lo_j = 0, hi_j = W;
  if constexpr (MEMBER) {
    lo_i = (ti0 / mh) * mh;
    hi_i = ((ti1 - 1) / mh) * mh + mh;
    lo_j = (tj0 / mw) * mw;
    hi_j = ((tj1 - 1) / mw) * mw + mw;
  }
  const int wi0 = max(ti0 - reach[0] - 1, lo_i);
  const int wi1 = min(ti1 + reach[0] + 1, hi_i);
  const int wj0 = max(tj0 - reach[1] - 1, lo_j);
  const int wj1 = min(tj1 + reach[1] + 1, hi_j);
  // phi_hat on the ring, its cells numbered in one sequence (the bands
  // above and below the tile, then the rows' cells left and right of it)
  // so that the block takes it in as few rounds as it can: a round per
  // band cost a chain of dependent loads each
  const int ww = wj1 - wj0;
  const int n_top = (ti0 - wi0) * ww;
  const int n_rows = n_top + (wi1 - ti1) * ww;
  const int lw = tj0 - wj0, sw = lw + (wj1 - tj1);
  const int n_ring = n_rows + (ti1 - ti0) * sw;
  for (int k = tid; k < n_ring; k += kThreads) {
    int i, j;
    if (k < n_rows) {
      const bool top = k < n_top;
      const int q = top ? k : k - n_top;
      i = (top ? wi0 : ti1) + q / ww;
      j = wj0 + q % ww;
    } else {
      const int q = k - n_rows;
      const int col = q % sw;
      i = ti0 + q / sw;
      j = col < lw ? wj0 + col : tj1 + (col - lw);
    }
    const long c = (long)i * W + j;
    forward_cell<T, C, MEMBER, false>(
        field, i, j, vel[c] * dt, vel[plane + c] * dt, H, W, mh, mw,
        max_disp, no_slip, win + (i - wo_i) * pw + (j - wo_j), wplane,
        nullptr, nullptr);
  }
  __syncthreads();

  // own cells: the backward pass from the window, and the limiter
  for (int k = tid; k < NC; k += kThreads) {
    const int i = ti0 + k / TW, j = tj0 + k % TW;
    if (i >= H || j >= W) continue;
    const long c = (long)i * W + j;
    const Stencil s = stencil<MEMBER>(i, j, (float)i + vel[c] * dt,
                                      (float)j + vel[plane + c] * dt, H, W,
                                      max_disp, no_slip, mh, mw);
    const int tap = (s.i0 - wo_i) * pw + (s.j0 - wo_j);
    const int own = (i - wo_i) * pw + (j - wo_j);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      const T* w = win + ch * wplane;
      const float back = round_to<T>(bilerp(s, load(w, tap),
                                            load(w, tap + 1),
                                            load(w, tap + pw),
                                            load(w, tap + pw + 1),
                                            no_slip));
      const long kk = ch * plane + c;
      const float diff = round_to<T>(load(field, kk) - back);
      const float half = round_to<T>(0.5f * diff);
      const float corr = round_to<T>(load(w, own) + half);
      store(out, kk,
            min_nan(max_nan(corr, load(bounds, ch * NC + k)),
                    load(bounds, (C + ch) * NC + k)));
    }
  }
}

// The window route's dynamic shared memory for C channels of `elem` bytes
// at max_disp.
long window_bytes(int C, int elem, int max_disp) {
  const long R = (long)max_disp + 1;
  return C * ((TH + 2 * R) * (TW + 2 * R) + 2L * TH * TW) * elem;
}

constexpr int kMaxDevices = 64;

// One launch of the window route, or kWindowTooLarge.  The kernel's
// dynamic shared-memory limit is raised per device only when a launch
// needs more than it was granted, and the device's opt-in limit is asked
// once, so a call at a size seen before makes no query.
template <typename T, int C, bool MEMBER>
int launch_tile(const void* field, const void* vel, void* out, int H, int W,
                int mh, int mw, float dt, int max_disp, int no_slip,
                cudaStream_t stream) {
  const auto kernel = maccormack_tile_kernel<T, C, MEMBER>;
  static int granted[kMaxDevices];  // dynamic bytes allowed so far
  static int room[kMaxDevices];     // the most a launch may take
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (room[dev] == 0) {
    int limit;
    cudaFuncAttributes attr;
    if ((err = cudaDeviceGetAttribute(
             &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
            cudaSuccess ||
        (err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess)
      return (int)err;
    room[dev] = limit - (int)attr.sharedSizeBytes;
  }
  const long bytes = window_bytes(C, (int)sizeof(T), max_disp);
  if (bytes > room[dev]) return kWindowTooLarge;
  if (bytes > granted[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    granted[dev] = (int)bytes;
  }
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(field), static_cast<const float*>(vel),
      static_cast<T*>(out), H, W, mh, mw, dt, (float)max_disp, no_slip);
  return (int)cudaGetLastError();
}

// Dispatch on the channel count and the member flag; K is a functor
// template over <T, C, MEMBER>.
template <typename T, template <typename, int, bool> class K, typename... A>
int dispatch_cm(int C, int mh, A... args) {
  switch (C) {
    case 1:
      return mh > 0 ? K<T, 1, true>::run(args...)
                    : K<T, 1, false>::run(args...);
    case 2:
      return mh > 0 ? K<T, 2, true>::run(args...)
                    : K<T, 2, false>::run(args...);
    case 3:
      return mh > 0 ? K<T, 3, true>::run(args...)
                    : K<T, 3, false>::run(args...);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int C, bool MEMBER>
struct Correct {
  template <typename... A>
  static int run(A... args) {
    return (int)launch_correct<T, C, MEMBER>(args...);
  }
};

template <typename T, int C, bool MEMBER>
struct Tile {
  template <typename... A>
  static int run(A... args) {
    return launch_tile<T, C, MEMBER>(args...);
  }
};

}  // namespace

// field, out: [C, H, W] float32 (field_bf16 = 0) or bfloat16 (= 1);
// vel: [2, H, W] float32; overlay: [C+1, H, W] float32 or null (only with
// minmax = 0); frame: [H-1, W-1] uint16 or null (C == 3 only); lo, hi:
// [C, H, W] in the field dtype, written when minmax is 1 (the raw tap
// extrema) or 2 (combined with the stored value), else null; mh, mw: the
// member tile (mh = 0: none; else mh, mw >= 2 dividing H, W).  Block mode
// when halo > 0 (no member, overlay or frame; minmax 0 or 1): out, vel, lo
// and hi are the owned H x W block at global (ox, oy) of a GH x GW domain,
// field is [C, H + 2 halo, W + 2 halo].  stack = 1: field and out are the
// member stack [H/mh * W/mw, C, mh, mw] of the H x W supergrid, vel [n, 2,
// mh, mw] (members, minmax 0, no frame or block mode; the overlay stays
// on the supergrid).
extern "C" int fluid_advect(const void* field, const void* vel,
                            const void* overlay, void* out, void* frame,
                            void* lo, void* hi, int C, int H, int W,
                            int field_bf16, float dt, int max_disp, int mh,
                            int mw, int ox, int oy, int halo, int GH, int GW,
                            int no_slip, int clip01, int bswap, int minmax,
                            int stack, void* stream) {
  const AdvectArgs a{field, static_cast<const float*>(vel),
                     static_cast<const float*>(overlay), out,
                     static_cast<uint16_t*>(frame), lo, hi, H, W, mh, mw,
                     Block{ox, oy, halo, GH, GW}, dt, (float)max_disp,
                     no_slip, clip01, bswap, stack,
                     static_cast<cudaStream_t>(stream)};
  if (field_bf16) return (int)dispatch_channels<__nv_bfloat16>(C, minmax, a);
  return (int)dispatch_channels<float>(C, minmax, a);
}

// K5's two-launch route, launch 2.  field, phi_hat, cmin, cmax, out:
// [C, H, W] in the field dtype (phi_hat, cmin, cmax from fluid_advect with
// minmax = 1); vel: [2, H, W] float32, the forward velocity (the kernel
// backtraces through -vel); mh, mw as for fluid_advect.
extern "C" int fluid_maccormack_correct(const void* field,
                                        const void* phi_hat, const void* cmin,
                                        const void* cmax, const void* vel,
                                        void* out, int C, int H, int W,
                                        int field_bf16, float dt,
                                        int max_disp, int mh, int mw,
                                        int no_slip, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float md = (float)max_disp;
  if (field_bf16)
    return dispatch_cm<__nv_bfloat16, Correct>(C, mh, field, phi_hat, cmin,
                                               cmax, vel, out, H, W, mh, mw,
                                               dt, md, no_slip, s);
  return dispatch_cm<float, Correct>(C, mh, field, phi_hat, cmin, cmax, vel,
                                     out, H, W, mh, mw, dt, md, no_slip, s);
}

// K5's window route, one launch.  field, out: [C, H, W] float32
// (field_bf16 = 0) or bfloat16 (= 1); vel: [2, H, W] float32; mh, mw as for
// fluid_advect.  Returns kWindowTooLarge (-1), launching nothing, where the
// window for reach max_disp + 1 does not fit a block of the current
// device: the wrapper then takes the two-launch route.
extern "C" int fluid_maccormack(const void* field, const void* vel,
                                void* out, int C, int H, int W,
                                int field_bf16, float dt, int max_disp,
                                int mh, int mw, int no_slip, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (max_disp < 0) return (int)cudaErrorInvalidValue;
  if (field_bf16)
    return dispatch_cm<__nv_bfloat16, Tile>(C, mh, field, vel, out, H, W, mh,
                                            mw, dt, max_disp, no_slip, s);
  return dispatch_cm<float, Tile>(C, mh, field, vel, out, H, W, mh, mw, dt,
                                  max_disp, no_slip, s);
}

namespace {

// K2's member overlay: a thread per (member, slot) of an ensemble's [n, K]
// impulses.  The slot writes its velocity and the flag 1 at its cell of
// the supergrid unless it is inactive or a later active slot of its member
// hits the same clamped cell (the last slot wins, as the plain version's
// member_writes), so no two threads write one cell.
__global__ void member_overlay_kernel(const int* __restrict__ pos,
                                      const float* __restrict__ vel,
                                      const bool* __restrict__ active,
                                      float* __restrict__ out, int n, int k,
                                      int gw, int mh, int mw,
                                      long long plane) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * k || !active[t]) return;
  const int m = t / k;
  const int li = min(max(pos[2 * t], 0), mh - 1);
  const int lj = min(max(pos[2 * t + 1], 0), mw - 1);
  for (int u = t + 1; u < (m + 1) * k; ++u)
    if (active[u] && min(max(pos[2 * u], 0), mh - 1) == li &&
        min(max(pos[2 * u + 1], 0), mw - 1) == lj)
      return;
  const long long cell =
      (long long)((m / gw) * mh + li) * ((long long)gw * mw) +
      (long long)(m % gw) * mw + lj;
  out[cell] = vel[2 * t];
  out[plane + cell] = vel[2 * t + 1];
  out[2 * plane + cell] = 1.0f;
}

}  // namespace

// K2's member overlay.  pos: [n, k, 2] int32, member-local; vel: [n, k, 2]
// float32; active: [n, k] bool; out: [3, plane] float32 with plane =
// gh*mh * gw*mw, the members row-major over gw tiles a row.  Sets out to
// zero, then writes each member's winning slots.
extern "C" int fluid_member_overlay(const void* pos, const void* vel,
                                    const void* active, void* out, int n,
                                    int k, int gw, int mh, int mw,
                                    int plane, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 0 || k < 0 || gw < 1 || mh < 1 || mw < 1 || plane < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e =
      cudaMemsetAsync(out, 0, 3 * (size_t)plane * sizeof(float), s);
  if (e != cudaSuccess) return (int)e;
  if (n * k > 0) {
    const int threads = 256;
    member_overlay_kernel<<<(n * k + threads - 1) / threads, threads, 0, s>>>(
        static_cast<const int*>(pos), static_cast<const float*>(vel),
        static_cast<const bool*>(active), static_cast<float*>(out), n, k, gw,
        mh, mw, plane);
  }
  return (int)cudaGetLastError();
}
