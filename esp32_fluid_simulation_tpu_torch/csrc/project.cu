// Pressure projection with the drag-queue drain: drain -> reflected-ghost
// divergence -> 2*iters red-black SOR half-sweeps from zero -> edge-clamped
// gradient.
//
// Replaces the TPU kernel esp32_fluid_simulation_tpu/ops/pallas/project.py
// (project_fused_pallas / _project_kernel, with the packed red-black solve
// of ops/pallas/rb_common.py:packed_rb_solve_full).  Two routes, chosen by
// the wrapper (ops/cuda/project.py) from iters alone:
//
// The window route (iters <= WINDOW_MAX_ITERS there): one launch,
// project_tile_kernel, the TPU kernel's design.  Each block owns a TH x TW
// tile of the output (of the owned cells in block mode).  With
// R = 2*iters + 1 it
//   1. resolves the impulse slots that fall in its window, the tile +- R;
//   2. writes dxd = dx * div(drained velocity) on the tile +- (R - 1) into
//      shared memory, reading the velocity window straight from device
//      memory in coalesced rows, and p = 0 on the tile +- R;
//   3. runs the 2*iters half-sweeps in shared memory, half-sweep k on the
//      shrinking tile +- (R - k) only (csrc/rb2d.cuh rb_window_half_sweeps:
//      the trapezoid, split by colour so no bank conflicts);
//   4. subtracts the gradient on the tile, reading p's +-1 ring from shared
//      memory, and writes the velocity and the pressure once.
// Bound on the H100: device-memory bytes, the velocity read once and the
// velocity and pressure written once (20 B per cell).  The window takes
// nearly all of a block's 227 KB of shared memory (104 x 146 tiles at
// iters 10), so one block runs per SM and its device-memory phases (2 and
// 4) do not overlap its half-sweeps; the half-sweeps' region averages
// 1.37x the tile, and their shared-memory traffic (4 loads and a store per
// cell update) is what they spend their time on.  Large iters make the
// window too large for the tile, so ops/cuda/project.py cuts the tile, and
// above WINDOW_MAX_ITERS takes:
//
// The sequence route: 2*iters + 2 launches on one stream, the design of
// the first port:
//   1. drain + divergence: dxd = dx * div(drained velocity), p = 0;
//   2. 2*iters in-place parity half-sweeps (csrc/rb2d.cuh, shared with
//      K4's csrc/sor.cu).  In place is exact red-black Gauss-Seidel: a
//      half-sweep updates only one colour, and same-colour cells never read
//      each other;
//   3. gradient subtract from the drained velocity into the output.
// Each half-sweep streams the pressure field and dxd through device memory.
//
// The drain (.ino:264-269) is re-derived per cell from the impulse slots, as
// the TPU kernel does, instead of being scattered into a copy of the
// velocity: that copy would be one more full read and write of the field.
// Each block resolves the slots once (clamp, last active slot wins, keep the
// cells its threads can read) into a short list in shared memory, which is
// almost always empty, so a cell pays one compare per listed impulse.
//
// Tiled-domain mode (K6, project.py:121-134): with a member tile mh x mw the
// reflected ghosts of the divergence, the zero ghosts and a_ii of the
// half-sweeps (csrc/rb2d.cuh) and the Neumann clamp of the gradient apply
// at every member wall; the drain is unchanged, so impulses and members
// combine.
//
// Block mode (K11, project.py:212-217, called per shard by
// parallel/sharded.py): vel is one shard's block with a halo of at least
// 2*iters+2 exchanged cells per side, in global coordinates
// (csrc/rb2d.cuh): the walls of the divergence, the SOR and the gradient
// are the domain's (or the members'), the drain compares global positions,
// a neighbour beyond the block reads 0, and cells outside the domain hold
// dxd = p = 0.  The window route's tiles cover the owned cells, and their
// windows reach at most R cells into the halo.  The sequence route runs
// launches 1 and 2 over the whole haloed block and launch 3 over the owned
// cells.  Both write the owned cells and their pressure to the outputs.
// It combines with impulses and members.
//
// Operand orders are those of project.py:170-191 and rb_common.py:202,212:
// divergence ((-up + dn) + (-lf + rt)) * inv2dx, neighbours
// ((up + dn) + lf) + rt, update (1-w)p + w(neg_inv*(dxd - nb)).  Built with
// --fmad=false, bit-equal to the composed plain PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rb2d.cuh"

namespace {

constexpr int kMaxImpulses = 64;

struct Drain {
  int n;
  int i[kMaxImpulses];
  int j[kMaxImpulses];
  float v0[kMaxImpulses];
  float v1[kMaxImpulses];
};

// The impulse slots as the kernels read them.
struct ImpulseArgs {
  const int* pos;
  const float* vel;
  const uint8_t* act;
  int n;
};

// Resolve the impulse slots into the cells of rows [r0, r1] x cols [c0, c1]
// of the H x W domain (clamped positions, the last active slot at a cell
// wins).  Called by every thread of a block of at least 32 threads.
__device__ void load_drain(Drain& d, const ImpulseArgs& imp, int H, int W,
                           int r0, int r1, int c0, int c1) {
  __shared__ int pi[kMaxImpulses];
  __shared__ int pj[kMaxImpulses];
  __shared__ uint8_t act[kMaxImpulses];
  const int n_imp = imp.n;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < n_imp) {
    pi[tid] = min(max(imp.pos[2 * tid], 0), H - 1);
    pj[tid] = min(max(imp.pos[2 * tid + 1], 0), W - 1);
    act[tid] = imp.act[tid] != 0;
  }
  __syncthreads();
  if (tid < 32) {
    int count = 0;
    for (int base = 0; base < n_imp; base += 32) {
      const int t = base + tid;
      bool keep = t < n_imp && act[t] && pi[t] >= r0 && pi[t] <= r1 &&
                  pj[t] >= c0 && pj[t] <= c1;
      for (int s = t + 1; keep && s < n_imp; ++s)
        if (act[s] && pi[s] == pi[t] && pj[s] == pj[t]) keep = false;
      const unsigned m = __ballot_sync(0xffffffffu, keep);
      if (keep) {
        const int k = count + __popc(m & ((1u << tid) - 1u));
        d.i[k] = pi[t];
        d.j[k] = pj[t];
        d.v0[k] = imp.vel[2 * t];
        d.v1[k] = imp.vel[2 * t + 1];
      }
      count += __popc(m);
    }
    if (tid == 0) d.n = count;
  }
  __syncthreads();
}

__device__ __forceinline__ float drained(const Drain& d, float v, int i,
                                         int j, int ch) {
  for (int k = 0; k < d.n; ++k)
    if (d.i[k] == i && d.j[k] == j) return ch == 0 ? d.v0[k] : d.v1[k];
  return v;
}

// Over the array of g (the haloed block in block mode): local (i, j) is
// global (i + oi, j + oj); the drain list holds global positions.
template <bool MEMBER, bool BLOCK>
__global__ void drain_divergence_kernel(const float* __restrict__ vel,
                                        float* __restrict__ dxd,
                                        float* __restrict__ p,
                                        const ImpulseArgs imp, const Geom g,
                                        float dx, float inv2dx) {
  __shared__ Drain d;
  const int H = g.H, W = g.W;
  const int i0 = blockIdx.y * blockDim.y;
  const int j0 = blockIdx.x * blockDim.x;
  load_drain(d, imp, g.GH, g.GW, g.oi + i0 - 1, g.oi + i0 + (int)blockDim.y,
             g.oj + j0 - 1, g.oj + j0 + (int)blockDim.x);
  const int i = i0 + threadIdx.y;
  const int j = j0 + threadIdx.x;
  if (i >= H || j >= W) return;
  const long plane = (long)H * W;
  const long c = (long)i * W + j;
  const int gi = BLOCK ? i + g.oi : i;
  const int gj = BLOCK ? j + g.oj : j;
  if (BLOCK && !in_domain(gi, gj, g)) {
    dxd[c] = 0.f;
    p[c] = 0.f;
    return;
  }
  const float* v0 = vel;
  const float* v1 = vel + plane;
  const Walls w = walls<MEMBER>(gi, gj, g.GH, g.GW, g.mh, g.mw);
  const float vx = drained(d, v0[c], gi, gj, 0);
  const float vy = drained(d, v1[c], gi, gj, 1);
  // reflected ghosts at the walls: the outside neighbour is -center; in
  // block mode a neighbour beyond the array reads 0
  const float t_up = w.i_lo                  ? -vx
                     : (BLOCK && i == 0)     ? 0.f
                                             : drained(d, v0[c - W], gi - 1,
                                                       gj, 0);
  const float t_dn = w.i_hi                  ? -vx
                     : (BLOCK && i == H - 1) ? 0.f
                                             : drained(d, v0[c + W], gi + 1,
                                                       gj, 0);
  const float t_lf = w.j_lo                  ? -vy
                     : (BLOCK && j == 0)     ? 0.f
                                             : drained(d, v1[c - 1], gi,
                                                       gj - 1, 1);
  const float t_rt = w.j_hi                  ? -vy
                     : (BLOCK && j == W - 1) ? 0.f
                                             : drained(d, v1[c + 1], gi,
                                                       gj + 1, 1);
  const float div = ((-t_up + t_dn) + (-t_lf + t_rt)) * inv2dx;
  dxd[c] = dx * div;
  p[c] = 0.f;
}

// Over the owned cells: the array's cells [halo, H - halo) x [halo,
// W - halo) (all of it without block mode), written densely to out (and,
// in block mode, their pressure to p_out).
template <bool MEMBER, bool BLOCK>
__global__ void gradient_kernel(const float* __restrict__ vel,
                                const float* __restrict__ p,
                                float* __restrict__ out,
                                float* __restrict__ p_out,
                                const ImpulseArgs imp, const Geom g,
                                int halo, float inv2dx) {
  __shared__ Drain d;
  const int W = g.W;
  const int bh = g.H - 2 * halo;
  const int bw = W - 2 * halo;
  const int i0 = blockIdx.y * blockDim.y;
  const int j0 = blockIdx.x * blockDim.x;
  const int ri = g.oi + halo;  // global row of owned cell 0
  const int rj = g.oj + halo;
  load_drain(d, imp, g.GH, g.GW, ri + i0, ri + i0 + (int)blockDim.y - 1,
             rj + j0, rj + j0 + (int)blockDim.x - 1);
  const int oi = i0 + threadIdx.y;  // owned cell
  const int oj = j0 + threadIdx.x;
  if (oi >= bh || oj >= bw) return;
  const int i = oi + halo;  // array cell
  const int j = oj + halo;
  const int gi = BLOCK ? i + g.oi : i;
  const int gj = BLOCK ? j + g.oj : j;
  const long plane = (long)g.H * W;
  const long c = (long)i * W + j;
  const Walls w = walls<MEMBER>(gi, gj, g.GH, g.GW, g.mh, g.mw);
  const float pc = p[c];
  // Neumann walls: the outside pressure is the center value
  const float p_im1 = w.i_lo ? pc : p[c - W];
  const float p_ip1 = w.i_hi ? pc : p[c + W];
  const float p_jm1 = w.j_lo ? pc : p[c - 1];
  const float p_jp1 = w.j_hi ? pc : p[c + 1];
  const float vx = drained(d, vel[c], gi, gj, 0);
  const float vy = drained(d, vel[plane + c], gi, gj, 1);
  const long k = BLOCK ? (long)oi * bw + oj : c;
  const long out_plane = BLOCK ? (long)bh * bw : plane;
  out[k] = vx - (p_ip1 - p_im1) * inv2dx;
  out[out_plane + k] = vy - (p_jp1 - p_jm1) * inv2dx;
  if (BLOCK) p_out[k] = pc;
}

// Rows a window phase loads before it computes on them: its loads are
// issued together, so more of the device memory's latency is hidden.
constexpr int kBatch = 4;

// The window route's dx * div on window rows and columns [1, rows - 1) x
// [1, cols - 1) (the tile +- (R - 1)), 0 outside the domain, into the dxd
// planes; window cell (a, b) is array cell (ai0 + a, aj0 + b) and global
// (wi0 + a, wj0 + b).  Lane l takes the columns b = 1 + l + 32 j and each
// warp walks a run of rows down them, kBatch rows at a time, keeping the
// drained vx of the two rows above the batch in registers.  Loads are
// clamped into the array, so they are unconditional; a value read across
// a wall or the array's edge is never used.  DRAIN: the window holds
// impulses.
template <bool BLOCK, bool DRAIN>
__device__ __forceinline__ void window_divergence(
    const float* __restrict__ vel, const Drain& d, const Geom& g,
    const RbWindow& win, int ai0, int aj0, int wi0, int wj0, float dx,
    float inv2dx) {
  const int H = g.H, W = g.W;
  const float* v0 = vel;
  const float* v1 = vel + (long)H * W;
  const int n = win.rows - 2;  // shared evenly by the warps
  const int a0 = 1 + n * (int)threadIdx.y / (int)blockDim.y;
  const int a1 = 1 + n * ((int)threadIdx.y + 1) / (int)blockDim.y;
  if (a0 >= a1) return;
  for (int b = 1 + threadIdx.x; b < win.cols - 1; b += 32) {
    const int cf = win.col_flags[b];
    const int j = aj0 + b, gj = wj0 + b;
    const int jc = min(max(j, 0), W - 1);
    const int jl = max(jc - 1, 0), jr = min(jc + 1, W - 1);
    // row offset of window row a, clamped into the array
    auto row_at = [&](int a) { return (long)min(max(ai0 + a, 0), H - 1) * W; };
    auto vx_at = [&](int a, float v) {  // drained v0 of window row a
      return DRAIN ? drained(d, v, wi0 + a, gj, 0) : v;
    };
    // vx of rows a - 1 .. a + kBatch of the batch starting at row a
    float vx[kBatch + 2];
    vx[0] = vx_at(a0 - 1, v0[row_at(a0 - 1) + jc]);
    vx[1] = vx_at(a0, v0[row_at(a0) + jc]);
    for (int a = a0; a < a1; a += kBatch) {
      float vy[kBatch], vy_l[kBatch], vy_r[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const long r = row_at(a + u), r1 = row_at(a + u + 1);
        vx[u + 2] = v0[r1 + jc];
        vy[u] = v1[r + jc];
        vy_l[u] = v1[r + jl];
        vy_r[u] = v1[r + jr];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int ar = a + u;
        if (ar >= a1) break;
        const int rf = win.row_flags[ar];
        const int i = ai0 + ar, gi = wi0 + ar;
        vx[u + 2] = vx_at(ar + 1, vx[u + 2]);
        float v = 0.f;
        if (!((rf | cf) & kOutside)) {
          const float vxc = vx[u + 1];
          const float vyc = DRAIN ? drained(d, vy[u], gi, gj, 1) : vy[u];
          // reflected ghosts at the walls: the outside neighbour is
          // -center; in block mode a neighbour beyond the array reads 0
          const float t_up = (rf & kWallLo)          ? -vxc
                             : (BLOCK && i == 0)     ? 0.f
                                                     : vx[u];
          const float t_dn = (rf & kWallHi)          ? -vxc
                             : (BLOCK && i == H - 1) ? 0.f
                                                     : vx[u + 2];
          const float t_lf =
              (cf & kWallLo)        ? -vyc
              : (BLOCK && j == 0)   ? 0.f
              : DRAIN               ? drained(d, vy_l[u], gi, gj - 1, 1)
                                    : vy_l[u];
          const float t_rt =
              (cf & kWallHi)          ? -vyc
              : (BLOCK && j == W - 1) ? 0.f
              : DRAIN                 ? drained(d, vy_r[u], gi, gj + 1, 1)
                                      : vy_r[u];
          const float div = ((-t_up + t_dn) + (-t_lf + t_rt)) * inv2dx;
          v = dx * div;
        }
        rb_dxd_at(win, ar, b) = v;
      }
      vx[0] = vx[kBatch];
      vx[1] = vx[kBatch + 1];
    }
  }
}

// The window route's gradient on the tile, rows and columns [R, R + th) x
// [R, R + tw) of the window (Neumann walls: the outside pressure is the
// center value), written with the pressure to the owned cells: lanes along
// a row, each warp walking a run of rows, kBatch rows at a time.
template <bool DRAIN>
__device__ __forceinline__ void window_gradient(
    const float* __restrict__ vel, float* __restrict__ out,
    float* __restrict__ p_out, const Drain& d, const Geom& g,
    const RbWindow& win, int R, int th, int tw, int t0, int u0, int ai0,
    int aj0, int wi0, int wj0, int bh, int bw, float inv2dx) {
  const long plane = (long)g.H * g.W;
  const long out_plane = (long)bh * bw;
  const int a0 = R + th * (int)threadIdx.y / (int)blockDim.y;
  const int a1 = R + th * ((int)threadIdx.y + 1) / (int)blockDim.y;
  if (a0 >= a1) return;
  for (int b = R + threadIdx.x; b < R + tw; b += 32) {
    const int cf = win.col_flags[b];
    for (int a = a0; a < a1; a += kBatch) {
      float vx[kBatch], vy[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        // rows past the run are clamped to its last: loaded, never used
        const long c = (long)(ai0 + min(a + u, a1 - 1)) * g.W + (aj0 + b);
        vx[u] = vel[c];
        vy[u] = vel[plane + c];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int ar = a + u;
        if (ar >= a1) break;
        const int rf = win.row_flags[ar];
        const float pc = rb_at(win, ar, b);
        const float p_im1 = (rf & kWallLo) ? pc : rb_at(win, ar - 1, b);
        const float p_ip1 = (rf & kWallHi) ? pc : rb_at(win, ar + 1, b);
        const float p_jm1 = (cf & kWallLo) ? pc : rb_at(win, ar, b - 1);
        const float p_jp1 = (cf & kWallHi) ? pc : rb_at(win, ar, b + 1);
        const float vxc =
            DRAIN ? drained(d, vx[u], wi0 + ar, wj0 + b, 0) : vx[u];
        const float vyc =
            DRAIN ? drained(d, vy[u], wi0 + ar, wj0 + b, 1) : vy[u];
        const long k = (long)(t0 + ar - R) * bw + (u0 + b - R);
        out[k] = vxc - (p_ip1 - p_im1) * inv2dx;
        out[out_plane + k] = vyc - (p_jp1 - p_jm1) * inv2dx;
        p_out[k] = pc;
      }
    }
  }
}

// The window route: one block per TH x TW tile of the owned cells (all
// cells without block mode), which are the array's [halo, H - halo) x
// [halo, W - halo).  The window is the tile +- R, R = 2*iters + 1, in
// shared memory: p and dx*d split by colour (RbWindow, csrc/rb2d.cuh), then
// the row and column flags.  Window cell (a, b) is array cell (ai0 + a,
// aj0 + b) and global (wi0 + a, wj0 + b).
template <bool MEMBER, bool BLOCK>
__global__ void __launch_bounds__(1024)
    project_tile_kernel(const float* __restrict__ vel,
                        float* __restrict__ out, float* __restrict__ p_out,
                        const ImpulseArgs imp, const Geom g, int halo,
                        int TH, int TW, int stride, float dx,
                        float inv2dx, int iters, float omega,
                        float one_m_w) {
  extern __shared__ float4 smem[];
  __shared__ Drain d;
  const int R = 2 * iters + 1;
  const int bh = g.H - 2 * halo;
  const int bw = g.W - 2 * halo;
  const int t0 = blockIdx.y * TH;  // the tile's first owned row and column
  const int u0 = blockIdx.x * TW;
  const int th = min(TH, bh - t0);
  const int tw = min(TW, bw - u0);
  const int rows = th + 2 * R;
  const int cols = tw + 2 * R;
  const int ai0 = halo + t0 - R;
  const int aj0 = halo + u0 - R;
  const int wi0 = BLOCK ? ai0 + g.oi : ai0;
  const int wj0 = BLOCK ? aj0 + g.oj : aj0;
  float* sp = reinterpret_cast<float*>(smem);
  float* sd = sp + 2 * stride;
  unsigned char* row_flags = reinterpret_cast<unsigned char*>(sd + 2 * stride);
  unsigned char* col_flags = row_flags + TH + 2 * R;
  const RbWindow win{sp, sd, row_flags, col_flags, rows, cols, stride,
                     (wi0 + wj0) & 1};
  load_drain(d, imp, g.GH, g.GW, wi0, wi0 + rows - 1, wj0, wj0 + cols - 1);

  // 1. the flags and p = 0
  rb_window_init<MEMBER>(win, row_flags, col_flags, g, ai0, aj0);
  __syncthreads();

  // 2. dx * div on the tile +- (R - 1), 0 outside the domain
  if (iters > 0) {
    if (d.n > 0)
      window_divergence<BLOCK, true>(vel, d, g, win, ai0, aj0, wi0, wj0, dx,
                                     inv2dx);
    else
      window_divergence<BLOCK, false>(vel, d, g, win, ai0, aj0, wi0, wj0,
                                      dx, inv2dx);
    __syncthreads();
  }

  // 3. the half-sweeps on the shrinking window
  rb_window_half_sweeps(win, 2 * iters, omega, one_m_w);

  // 4. the gradient on the tile, written with the pressure to the owned
  // cells
  if (d.n > 0)
    window_gradient<true>(vel, out, p_out, d, g, win, R, th, tw, t0, u0, ai0,
                          aj0, wi0, wj0, bh, bw, inv2dx);
  else
    window_gradient<false>(vel, out, p_out, d, g, win, R, th, tw, t0, u0,
                           ai0, aj0, wi0, wj0, bh, bw, inv2dx);
}

template <bool MEMBER, bool BLOCK>
cudaError_t project_window(const float* v, float* vo, float* po,
                           const ImpulseArgs& imp, const Geom& g, int halo,
                           int TH, int TW, int threads_y, float dx,
                           float inv2dx, int iters, float omega,
                           float one_m_w, cudaStream_t s) {
  const WindowShape ws = window_shape(TH, TW, 2 * iters + 1);
  if (ws.cols == 0) return cudaErrorInvalidValue;
  // above 48 KB a block's shared memory must be asked for
  cudaError_t err = cudaFuncSetAttribute(
      project_tile_kernel<MEMBER, BLOCK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, ws.bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.W - 2 * halo + TW - 1) / TW,
                  (g.H - 2 * halo + TH - 1) / TH);
  project_tile_kernel<MEMBER, BLOCK><<<grid, dim3(32, threads_y), ws.bytes,
                                       s>>>(v, vo, po, imp, g, halo, TH, TW,
                                            ws.stride, dx, inv2dx,
                                            iters, omega, one_m_w);
  return cudaGetLastError();
}

template <bool MEMBER, bool BLOCK>
cudaError_t project(const float* v, float* vo, float* pp, float* dd,
                    float* po, const ImpulseArgs& imp, const Geom& g,
                    int halo, float dx, float inv2dx, int iters, float omega,
                    float one_m_w, cudaStream_t s) {
  const dim3 block(32, 8);
  const dim3 grid((g.W + 31) / 32, (g.H + 7) / 8);
  drain_divergence_kernel<MEMBER, BLOCK><<<grid, block, 0, s>>>(
      v, dd, pp, imp, g, dx, inv2dx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = half_sweeps<MEMBER, BLOCK>(pp, dd, g, iters, omega, one_m_w, s);
  if (err != cudaSuccess) return err;

  const dim3 owned((g.W - 2 * halo + 31) / 32, (g.H - 2 * halo + 7) / 8);
  gradient_kernel<MEMBER, BLOCK><<<owned, block, 0, s>>>(v, pp, vo, po, imp,
                                                         g, halo, inv2dx);
  return cudaGetLastError();
}

}  // namespace

// The window route (one launch): vel [2, H, W] float32; the owned cells go
// to vel_out [2, H - 2 halo, W - 2 halo] and their pressure to p_out
// [H - 2 halo, W - 2 halo] (halo = 0 without block mode); TH x TW tiles,
// blocks of 32 x threads_y threads.  The other arguments as for
// fluid_project below.
extern "C" int fluid_project_window(const void* vel, void* vel_out,
                                    void* p_out, const void* ipos,
                                    const void* ivel, const void* iact,
                                    int n_imp, int H, int W, int mh, int mw,
                                    int oi, int oj, int GH, int GW, int halo,
                                    float dx, float inv2dx, int iters,
                                    float omega, float one_m_w, int tile_h,
                                    int tile_w, int threads_y,
                                    void* stream) {
  if (n_imp < 0 || n_imp > kMaxImpulses || iters < 0 || tile_h < 1 ||
      tile_w < 1 || threads_y < 1 || threads_y > 32)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vel);
  float* vo = static_cast<float*>(vel_out);
  float* po = static_cast<float*>(p_out);
  const ImpulseArgs imp{static_cast<const int*>(ipos),
                        static_cast<const float*>(ivel),
                        static_cast<const uint8_t*>(iact), n_imp};
  if (halo > 0) {
    const Geom g{H, W, oi, oj, GH, GW, mh, mw};
    if (mh > 0)
      return (int)project_window<true, true>(v, vo, po, imp, g, halo, tile_h,
                                             tile_w, threads_y, dx, inv2dx,
                                             iters, omega, one_m_w, s);
    return (int)project_window<false, true>(v, vo, po, imp, g, halo, tile_h,
                                            tile_w, threads_y, dx, inv2dx,
                                            iters, omega, one_m_w, s);
  }
  const Geom g{H, W, 0, 0, H, W, mh, mw};
  if (mh > 0)
    return (int)project_window<true, false>(v, vo, po, imp, g, 0, tile_h,
                                            tile_w, threads_y, dx, inv2dx,
                                            iters, omega, one_m_w, s);
  return (int)project_window<false, false>(v, vo, po, imp, g, 0, tile_h,
                                           tile_w, threads_y, dx, inv2dx,
                                           iters, omega, one_m_w, s);
}

// The sequence route (2*iters + 2 launches).
// vel: [2, H, W] float32; p, dxd: [H, W] float32 (dxd is scratch);
// ipos: int32 [n_imp, 2]; ivel: float32 [n_imp, 2]; iact: bool [n_imp];
// mh, mw: the member tile (mh = 0: none; else mh, mw >= 2 dividing the
// domain).  Without block mode (halo = 0) vel_out is [2, H, W] and p the
// pressure.  Block mode when halo > 0: vel is the haloed block, whose cell
// (0, 0) sits at global (oi, oj) of a GH x GW domain; p is scratch, and the
// owned cells go to vel_out [2, H - 2 halo, W - 2 halo] and p_out.
extern "C" int fluid_project(const void* vel, void* vel_out, void* p,
                             void* dxd, const void* ipos, const void* ivel,
                             const void* iact, int n_imp, int H, int W,
                             int mh, int mw, int oi, int oj, int GH, int GW,
                             int halo, void* p_out, float dx, float inv2dx,
                             int iters, float omega, float one_m_w,
                             void* stream) {
  if (n_imp < 0 || n_imp > kMaxImpulses) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vel);
  float* vo = static_cast<float*>(vel_out);
  float* pp = static_cast<float*>(p);
  float* dd = static_cast<float*>(dxd);
  float* po = static_cast<float*>(p_out);
  const ImpulseArgs imp{static_cast<const int*>(ipos),
                        static_cast<const float*>(ivel),
                        static_cast<const uint8_t*>(iact), n_imp};
  if (halo > 0) {
    const Geom g{H, W, oi, oj, GH, GW, mh, mw};
    if (mh > 0)
      return (int)project<true, true>(v, vo, pp, dd, po, imp, g, halo, dx,
                                      inv2dx, iters, omega, one_m_w, s);
    return (int)project<false, true>(v, vo, pp, dd, po, imp, g, halo, dx,
                                     inv2dx, iters, omega, one_m_w, s);
  }
  const Geom g{H, W, 0, 0, H, W, mh, mw};
  if (mh > 0)
    return (int)project<true, false>(v, vo, pp, dd, po, imp, g, 0, dx,
                                     inv2dx, iters, omega, one_m_w, s);
  return (int)project<false, false>(v, vo, pp, dd, po, imp, g, 0, dx, inv2dx,
                                    iters, omega, one_m_w, s);
}
