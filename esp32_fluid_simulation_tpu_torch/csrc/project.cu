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
// project_tile_kernel, a row-pipelined strip.  Bound on the H100:
// device-memory bytes, the velocity read once and the velocity and
// pressure written once (20 B per cell, 0.1 ms at config 0); between the
// read and the writes lie 2*iters half-sweeps of four neighbours each.  The
// TPU kernel keeps them in fast memory on a tile +- R (R = 2*iters + 1),
// the trapezoid; on the H100 a tile's window in shared memory fills an SM,
// so one block ran per SM, its device-memory phases (0.27 ms at config 0)
// serial with its half-sweeps (0.33 ms).  The design here:
//   - a block is 4 warps and owns a row segment of a column strip of the
//     output; its window is the strip +- R columns, at most 256, a lane
//     one plane column of each colour;
//   - it walks down the rows once, and each step runs every stage on its
//     own row: the drain and dx*div of the incoming row, half-sweep k' on
//     the row k' above it, the gradient and the stores of the row
//     2*iters + 1 above it.  Each thread runs its column's stages in order,
//     so a lag of one row a stage needs no barrier between stages; the
//     warps meet once a step;
//   - p lives in registers: each thread keeps, for each stage, its
//     column's values of the last two steps, which are the row above, the
//     row itself and (from this step) the row below that the next stage
//     reads, and the old value of its colour two stages on; the horizontal
//     neighbour comes from the next lane by a shuffle, or at a warp's edge
//     from the edge lanes' values in shared memory.  Shared memory holds
//     dx*d in a ring of 2*iters + 2 rows, each thread its own columns;
//   - the step's velocity rows are loaded before its half-sweeps, which
//     run while the loads are in flight; registers bound the blocks an SM
//     holds (four, 128 registers a thread); the wrapper asks the card and
//     plans two waves of them, so that blocks start and end at different
//     times;
//   - each half-sweep runs on every row and column of the window that the
//     walk passes; the trapezoid's cells are right, the rest never reach
//     them.
// With member tiles (K6) the window route is the trapezoid, the TPU
// kernel's design that the strip replaced (another project_tile_kernel,
// counted apart by the wrapper): on the strip, the member walls' tests cost
// more than this route (PERF.md).  Above WINDOW_MAX_ITERS:
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
// On a member stack (csrc/stack.cuh; the ensemble's [n, 2, mh, mw]
// velocity) the trapezoid reads the velocity and writes the velocity and
// the [n, mh, mw] pressure in place: its window, walls, flags, drain and
// half-sweeps stay in supergrid coordinates, and only the row offset, the
// column offset and the plane of a load or a store change.  A block takes
// its window's row and column offsets from tables that it fills in shared
// memory first (StackWindow, csrc/stack.cuh, 8 B a window row and column):
// computed in the loops, a division a row and the 64-bit products spilled
// registers out of the half-sweeps and cost the launch a quarter of its
// time.  A load clamped across a member wall may land in another member's
// memory; it is never used, as a clamped load is not on the supergrid.  A
// template flag; the sequence route and the strip take no stack.
//
// Block mode (K11, project.py:212-217, called per shard by
// parallel/sharded.py): vel is one shard's block with a halo of at least
// 2*iters+2 exchanged cells per side, in global coordinates
// (csrc/rb2d.cuh): the walls of the divergence, the SOR and the gradient
// are the domain's (or the members'), the drain compares global positions,
// a neighbour beyond the block reads 0, and cells outside the domain hold
// dxd = p = 0.  The window route's strips cover the owned cells, and their
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
#include "stack.cuh"

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

// The window route's instances: KMAX, the most half-sweeps a block's
// pipeline holds (up to 10 iters, and up to 15).  A block is kStripWarps
// warps and a lane owns one plane column of each colour, so a window is at
// most 64 * kStripWarps = 256 columns.
constexpr int kStripKmaxA = 20, kStripKmaxB = 30;
constexpr int kStripWarps = 4;

template <bool V>
struct Bool {
  static constexpr bool value = V;
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// The window route: each block a row segment of a column strip.  The owned
// cells ([halo, H - halo) x [halo, W - halo) of the array) are cut into
// n_strips column strips and each strip into n_segs row segments, as evenly
// as they go.  A block's window is its strip +- R = K + 1 columns, K =
// 2*iters half-sweeps; thread t (warp t / 32, lane t % 32) owns plane
// column m = t, window cells b = 2m and 2m + 1, array column aj0 + b,
// global wj0 + b.
//
// The block walks the array rows tau from i0 - K to i1 + K down its
// segment's owned rows [i0, i1), and each step runs every stage once:
//   the half-sweeps: pipeline stage k (1..KMAX) is half-sweep k' = k - off
//     (off = KMAX - K; stages with k' < 1 hold p = 0) on row tau - k',
//     colour (k' - 1) & 1.  Stage k reads stage k - 1's row below from this
//     step, its row itself and the row above from the two steps before,
//     and its colour's old value from stage k - 2 two steps before: all in
//     the thread's registers (h1: the step before, h2: two steps before).
//     The horizontal neighbour is the next lane's h1, by a shuffle, and at
//     a warp's edge the next warp's, which each warp's edge lanes leave in
//     shared memory (edges, a ring of three steps) before the block's one
//     barrier a step;
//   the gradient of row tau - K - 1 with the pressure of the last two
//     stages, written to the owned cells with the pressure;
//   the drain and dx * div of row tau into a ring of NR = K + 2 rows in
//     shared memory (each thread its own columns), and the row's flags
//     into bit masks.
// The trapezoid: half-sweep k' need only be right on the rows [i0 - K - 1 +
// k', i1 + K + 1 - k') and the columns [k', 2R + tw - k') of the window,
// whose values still reach the owned cells +- 1.  Every stage runs on all
// of the window's columns at every step; at the segment's first steps the
// stages above the trapezoid read ring slots not yet written, and what
// they compute never reaches it.  A row or a column outside the domain or
// the array (kOutside) holds p = 0, so across the domain's walls a
// neighbour reads 0 without a test, and a row or a column with a wall
// changes only -1/a_ii.  No member tiles: those take the trapezoid route
// below.  The walk is compiled twice, with and without the drain,
// and a block takes the first only if impulses fall in its window.
// Without member walls a thread holds at most 128 registers (170 above 10
// iters), so that four blocks (three) fit an SM.
template <int KMAX, bool BLOCK>
__global__ void __launch_bounds__(32 * kStripWarps,
                                  KMAX <= kStripKmaxA ? 4 : 3)
    project_tile_kernel(const float* __restrict__ vel,
                        float* __restrict__ out, float* __restrict__ p_out,
                        const ImpulseArgs imp, const Geom g, int halo,
                        int n_strips, int n_segs, int K, float dx,
                        float inv2dx, float omega, float one_m_w) {
  constexpr int P = 32 * kStripWarps;
  // dx * d of row r in planes (2 s, 2 s + 1) at both slots s = r's ring slot
  // and s + NR, so that every stage reads at a fixed distance below the
  // current row's slot, without a wrap
  extern __shared__ float dring[];
  // edges[slot][w + 1][k][0 / 1]: stage k's value of warp w's lane 0 / 31
  // at the step of slot (rows 0 and kStripWarps + 1 stay 0)
  __shared__ float edges[3][kStripWarps + 2][KMAX + 1][2];
  __shared__ Drain d;
  const int m = threadIdx.x, lane = m & 31, w = m >> 5;
  const int H = g.H, W = g.W;
  const float* v0 = vel;
  const float* v1 = vel + (long)H * W;
  const int bh = H - 2 * halo, bw = W - 2 * halo;
  const int R = K + 1, NR = K + 2, off = KMAX - K;
  // this block's strip of owned columns [u0, u0 + tw) and segment of owned
  // rows [t0, t0 + ts)
  const int sx = blockIdx.x, sy = blockIdx.y;
  const int u0 = sx * (bw / n_strips) + min(sx, bw % n_strips);
  const int tw = bw / n_strips + (sx < bw % n_strips);
  const int t0 = sy * (bh / n_segs) + min(sy, bh % n_segs);
  const int ts = bh / n_segs + (sy < bh % n_segs);
  const int i0 = halo + t0, i1 = i0 + ts;  // array rows
  const int aj0 = halo + u0 - R;           // array column of window column 0
  const int oi = BLOCK ? g.oi : 0, oj = BLOCK ? g.oj : 0;
  const int wj0 = aj0 + oj;
  for (int q = m; q < 3 * (kStripWarps + 2) * (KMAX + 1) * 2; q += P)
    (&edges[0][0][0][0])[q] = 0.f;
  load_drain(d, imp, g.GH, g.GW, i0 - K - 1 + oi, i1 + K + oi, wj0 - 1,
             wj0 + 2 * P);

  // the thread's cells e = 0, 1: flags, -1/a_ii of their column walls
  // without and with a row wall, whether they are owned columns
  const int j0 = aj0 + 2 * m;  // array column of cell 0
  int cf[2];
  float negc[2], negw[2];
  bool owned[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int b = 2 * m + e, j = j0 + e, gj = j + oj;
    int f = kOutside;
    if (b < tw + 2 * R && j >= 0 && j < W && gj >= 0 && gj < g.GW) {
      f = (gj == 0 ? kWallLo : 0) | (gj == g.GW - 1 ? kWallHi : 0);
    }
    cf[e] = f;
    negc[e] = rb_neg_inv((f & kWallLo) + ((f & kWallHi) >> 1));
    negw[e] = rb_neg_inv(1 + (f & kWallLo) + ((f & kWallHi) >> 1));
    owned[e] = b >= R && b < R + tw;
  }
  const int jc0 = clampi(j0, 0, W - 1), jc1 = clampi(j0 + 1, 0, W - 1);
  // lane 0 also reads the column left of its cells, lane 31 the one right
  const int je = lane == 0 ? j0 - 1 : j0 + 2;
  const int jce = clampi(je, 0, W - 1);

  // p of each stage on the thread's column: the step before and two steps
  // before (stage 0 is p before the first half-sweep: 0); h3 three steps
  // before, for stage KMAX - 1 (the gradient's row above)
  float h1[KMAX + 1], h2[KMAX + 1], h3 = 0.f;
#pragma unroll
  for (int k = 0; k <= KMAX; ++k) h1[k] = h2[k] = 0.f;

  // the walk down the rows, with or without impulses in the window
  auto walk = [&](auto drain_tag) {
    constexpr bool DRAIN = decltype(drain_tag)::value;
    auto drain = [&](float v, int gi, int gj, int ch) {
      return DRAIN ? drained(d, v, gi, gj, ch) : v;
    };
    // drained vx of rows tau - 1 and tau on the thread's cells
    const int tau0 = i0 - K;
    float vxa[2], vxb[2];
    {
      const long ra = (long)clampi(tau0 - 1, 0, H - 1) * W;
      const long rb = (long)clampi(tau0, 0, H - 1) * W;
      vxa[0] = drain(v0[ra + jc0], tau0 - 1 + oi, j0 + oj, 0);
      vxa[1] = drain(v0[ra + jc1], tau0 - 1 + oi, j0 + 1 + oj, 0);
      vxb[0] = drain(v0[rb + jc0], tau0 + oi, j0 + oj, 0);
      vxb[1] = drain(v0[rb + jc1], tau0 + oi, j0 + 1 + oj, 0);
    }
    __syncthreads();

    const long out_plane = (long)bh * bw;
    int sl = 0;                  // ring slot of row tau
    int e0 = 0, e1 = 2, e2 = 1;  // edges slots: this step, the two before
    int S = (tau0 + oi + wj0 + 1) & 1;  // the half-sweeps' cells: 2m + S
    // row flags: bit j of each mask is row tau - j's (kWallLo, kWallHi,
    // kOutside), bit 0 set by the divergence
    unsigned mlo = 0, mhi = 0, mout = 0;
    const int n_steps = ts + 2 * K + 1;
    for (int n = 0; n < n_steps; ++n) {
      const int tau = tau0 + n;
      const int rg = tau - K - 1;

      // the loads of the step: vx of row tau + 1 and vy of row tau (the
      // divergence; lanes 0 and 31 also vy beside their cells), vx and vy
      // of row rg (the gradient)
      const long rn = (long)clampi(tau + 1, 0, H - 1) * W;
      const long r0 = (long)clampi(tau, 0, H - 1) * W;
      const long rgo = (long)clampi(rg, 0, H - 1) * W;
      float vxn[2] = {v0[rn + jc0], v0[rn + jc1]};
      const float vy[2] = {v1[r0 + jc0], v1[r0 + jc1]};
      const float vye = v1[r0 + jce];
      const float gx[2] = {v0[rgo + jc0], v0[rgo + jc1]};
      const float gy[2] = {v1[rgo + jc0], v1[rgo + jc1]};

      // 1. the half-sweeps, stage by stage down the rows
      const int cfs = S ? cf[1] : cf[0];
      const float negs = S ? negc[1] : negc[0];
      const float negws = S ? negw[1] : negw[0];
      const int srcl = (lane + (S ? 1 : 31)) & 31;
      // the neighbouring warp's edge lane, the step before
      const bool edge = lane == (S ? 31 : 0);
      const float* ep = &edges[e1][S ? w + 2 : w][0][S ? 0 : 1];
      float cur[KMAX + 1];
      cur[0] = 0.f;
      // row tau - k' at slot sl + NR - k' of the ring, bit k' of the masks
      const float* dq = dring + 2 * (sl + NR + off) * P + m;
      const unsigned swall = (mlo | mhi) << off;
      // rows outside and the stages before the first half-sweep: p = 0
      const unsigned szero = (mout << off) | ((2u << off) - 1u);
      const bool colout = cfs & kOutside;
#pragma unroll
      for (int k = 1; k <= KMAX; ++k) {
        const float here = h1[k - 1];
        float side = __shfl_sync(0xffffffffu, here, srcl);
        side = edge ? ep[2 * (k - 1)] : side;
        float lf = S ? here : side;
        float rt = S ? side : here;
        const float up = h2[k - 1], dn = cur[k - 1];
        const float pc = k >= 2 ? h2[k - 2] : 0.f;
        const float neg_inv = ((swall >> k) & 1) ? negws : negs;
        const float v = rb_cell(pc, up, dn, lf, rt,
                                dq[(-2 * k + ((k - 1) & 1)) * P], neg_inv,
                                omega, one_m_w);
        cur[k] = (((szero >> k) & 1) || colout) ? 0.f : v;
      }

      // 2. the gradient of row rg (Neumann walls: the outside pressure is
      // the center value), written with the pressure to the owned cells.
      // Plane 1 (the last half-sweep's colour) holds rows rg - 1, rg, rg + 1
      // in h2, h1 and cur of stage KMAX, plane 0 in h3, h2 and h1 of stage
      // KMAX - 1; cell (rg, 2m) is in plane p0, cell (rg, 2m + 1) in 1 - p0.
      if (n >= 2 * K + 1) {
        const int rf = ((mlo >> (K + 1)) & 1) * kWallLo |
                       ((mhi >> (K + 1)) & 1) * kWallHi;
        const int p0 = (rg + oi + wj0) & 1;
        const float a_up = p0 ? h3 : h2[KMAX];  // plane 1 - p0
        const float a_c = p0 ? h2[KMAX - 1] : h1[KMAX];
        const float a_dn = p0 ? h1[KMAX - 1] : cur[KMAX];
        const float b_up = p0 ? h2[KMAX] : h3;  // plane p0
        const float b_c = p0 ? h1[KMAX] : h2[KMAX - 1];
        const float b_dn = p0 ? cur[KMAX] : h1[KMAX - 1];
        // cell 0 is b_c with neighbours a_up, a_dn, the left lane's a_c and
        // a_c; cell 1 is a_c with b_up, b_dn, b_c and the right lane's b_c
        float a_l = __shfl_sync(0xffffffffu, a_c, (lane + 31) & 31);
        float b_r = __shfl_sync(0xffffffffu, b_c, (lane + 1) & 31);
        if (lane == 0)
          a_l = p0 ? edges[e2][w][KMAX - 1][1] : edges[e1][w][KMAX][1];
        if (lane == 31)
          b_r = p0 ? edges[e1][w + 2][KMAX][0] : edges[e2][w + 2][KMAX - 1][0];
        const long orow = (long)(rg - halo) * bw - halo;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (!owned[e]) continue;
          const int j = j0 + e;
          const float pc = e ? a_c : b_c;
          const float p_im1 = (rf & kWallLo) ? pc : (e ? b_up : a_up);
          const float p_ip1 = (rf & kWallHi) ? pc : (e ? b_dn : a_dn);
          const float p_jm1 = (cf[e] & kWallLo) ? pc : (e ? b_c : a_l);
          const float p_jp1 = (cf[e] & kWallHi) ? pc : (e ? b_r : a_c);
          const float vxc = drain(gx[e], rg + oi, j + oj, 0);
          const float vyc = drain(gy[e], rg + oi, j + oj, 1);
          const long o = orow + j;
          out[o] = vxc - (p_ip1 - p_im1) * inv2dx;
          out[out_plane + o] = vyc - (p_jp1 - p_jm1) * inv2dx;
          p_out[o] = pc;
        }
      }

      // 3. the drain and dx * div of row tau (reflected ghosts at the
      // walls: the outside neighbour is -center; in block mode a neighbour
      // beyond the array reads 0), 0 outside the domain, into ring slots sl
      // and sl + NR
      {
        const int gi = tau + oi;
        int rf = kOutside;
        if (tau >= 0 && tau < H && gi >= 0 && gi < g.GH) {
          rf = (gi == 0 ? kWallLo : 0) | (gi == g.GH - 1 ? kWallHi : 0);
        }
        mlo |= (rf & kWallLo) ? 1u : 0u;
        mhi |= (rf & kWallHi) ? 1u : 0u;
        mout |= (rf & kOutside) ? 1u : 0u;
        const int p0 = (gi + wj0) & 1;
        const float vyd[2] = {drain(vy[0], gi, j0 + oj, 1),
                              drain(vy[1], gi, j0 + 1 + oj, 1)};
        vxn[0] = drain(vxn[0], gi + 1, j0 + oj, 0);
        vxn[1] = drain(vxn[1], gi + 1, j0 + 1 + oj, 0);
        // vy of the cell left of cell 0 and right of cell 1
        float vy_l = __shfl_sync(0xffffffffu, vyd[1], (lane + 31) & 31);
        float vy_r = __shfl_sync(0xffffffffu, vyd[0], (lane + 1) & 31);
        const float vyed = drain(vye, gi, je + oj, 1);
        vy_l = lane == 0 ? vyed : vy_l;
        vy_r = lane == 31 ? vyed : vy_r;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + e;
          const float vxc = vxb[e];
          const float vyc = vyd[e];
          const float t_up = (rf & kWallLo)            ? -vxc
                             : (BLOCK && tau == 0)     ? 0.f
                                                       : vxa[e];
          const float t_dn = (rf & kWallHi)            ? -vxc
                             : (BLOCK && tau == H - 1) ? 0.f
                                                       : vxn[e];
          const float t_lf = (cf[e] & kWallLo)       ? -vyc
                             : (BLOCK && j == 0)     ? 0.f
                             : e                     ? vyd[0]
                                                     : vy_l;
          const float t_rt = (cf[e] & kWallHi)       ? -vyc
                             : (BLOCK && j == W - 1) ? 0.f
                             : e                     ? vy_r
                                                     : vyd[1];
          const float div = ((-t_up + t_dn) + (-t_lf + t_rt)) * inv2dx;
          const float v = ((rf | cf[e]) & kOutside) ? 0.f : dx * div;
          const int pl = (p0 + e) & 1;
          dring[(2 * sl + pl) * P + m] = v;
          dring[(2 * (sl + NR) + pl) * P + m] = v;
        }
      }

      // 4. the edge lanes' values for the other warps, then move the
      // histories and the velocity rows down a step
      if (lane == 0 || lane == 31) {
#pragma unroll
        for (int k = 1; k <= KMAX; ++k)
          edges[e0][w + 1][k][lane == 31] = cur[k];
      }
      h3 = h2[KMAX - 1];
#pragma unroll
      for (int k = 1; k <= KMAX; ++k) {
        h2[k] = h1[k];
        h1[k] = cur[k];
      }
      vxa[0] = vxb[0];
      vxa[1] = vxb[1];
      vxb[0] = vxn[0];
      vxb[1] = vxn[1];
      sl = sl + 1 == NR ? 0 : sl + 1;
      const int et = e2;
      e2 = e1;
      e1 = e0;
      e0 = et;
      S ^= 1;
      mlo <<= 1;
      mhi <<= 1;
      mout <<= 1;
      __syncthreads();
    }
  };
  if (d.n > 0)
    walk(Bool<true>());
  else
    walk(Bool<false>());
}

// The strip's project_tile_kernel, not the trapezoid's of the same name.
using StripKernel = void (*)(const float*, float*, float*, const ImpulseArgs,
                             const Geom, int, int, int, int, float, float,
                             float, float);

template <int KMAX, bool BLOCK>
StripKernel strip_kernel() {
  return project_tile_kernel<KMAX, BLOCK>;
}

// The bytes of a block's dx * d ring: 2 (KMAX + 2) rows of both planes.
inline int strip_ring_bytes(int kmax) {
  return (int)(2 * (kmax + 2) * 2 * 32 * kStripWarps * sizeof(float));
}

// The window route's resident blocks per SM (the occupancy the card
// reports; the wrapper plans two waves of them).
template <int KMAX>
int strip_blocks_per_sm() {
  const int bytes = strip_ring_bytes(KMAX);
  const StripKernel kernel = strip_kernel<KMAX, false>();
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess)
    return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel, 32 * kStripWarps, bytes) != cudaSuccess)
    return 0;
  return n;
}

template <int KMAX, bool BLOCK>
cudaError_t project_window(const float* v, float* vo, float* po,
                           const ImpulseArgs& imp, const Geom& g, int halo,
                           int n_strips, int n_segs, float dx, float inv2dx,
                           int iters, float omega, float one_m_w,
                           cudaStream_t s) {
  const int K = 2 * iters;
  const int bw = g.W - 2 * halo, bh = g.H - 2 * halo;
  // the widest strip's window must fit the lanes' columns
  if (K > KMAX || n_strips < 1 || n_segs < 1 || n_strips > bw ||
      n_segs > bh || n_segs > 65535 ||
      (bw + n_strips - 1) / n_strips + 2 * (K + 1) > 64 * kStripWarps)
    return cudaErrorInvalidValue;
  // with the static shared memory, above 48 KB: asked for
  const int bytes = strip_ring_bytes(KMAX);
  const StripKernel kernel = strip_kernel<KMAX, BLOCK>();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_strips, n_segs), 32 * kStripWarps, bytes, s>>>(
          v, vo, po, imp, g, halo, n_strips, n_segs, K, dx, inv2dx, omega,
          one_m_w);
  return cudaGetLastError();
}

template <int KMAX>
cudaError_t project_window_modes(const float* v, float* vo, float* po,
                                 const ImpulseArgs& imp, const Geom& g,
                                 int halo, int n_strips, int n_segs, float dx,
                                 float inv2dx, int iters, float omega,
                                 float one_m_w, cudaStream_t s) {
  if (halo > 0)
    return project_window<KMAX, true>(v, vo, po, imp, g, halo, n_strips,
                                      n_segs, dx, inv2dx, iters, omega,
                                      one_m_w, s);
  return project_window<KMAX, false>(v, vo, po, imp, g, 0, n_strips, n_segs,
                                     dx, inv2dx, iters, omega, one_m_w, s);
}

// The trapezoid route, for member tiles (K6): one block per TH x TW tile of
// the owned cells projects it inside its window, the tile +- R, in shared
// memory (RbWindow and rb_window_half_sweeps of csrc/rb2d.cuh, shared with
// K4): flags and p = 0, dx * div of the window, the half-sweeps on the
// shrinking window, the gradient.  One block fills an SM's shared memory.
// On the strip, member walls cost K1 more than this route does (PERF.md).
//
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
// impulses; STACK: vel is a member stack, its offsets in sw.
template <bool BLOCK, bool DRAIN, bool STACK>
__device__ __forceinline__ void window_divergence(
    const float* __restrict__ vel, const Drain& d, const Geom& g,
    const RbWindow& win, const StackWindow& sw, int ai0, int aj0, int wi0,
    int wj0, float dx, float inv2dx) {
  const int H = g.H, W = g.W, mh = g.mh, mw = g.mw;
  const float* v0 = vel;
  const float* v1 = vel + plane_of<STACK>(H, W, mh, mw);
  const int n = win.rows - 2;  // shared evenly by the warps
  const int a0 = 1 + n * (int)threadIdx.y / (int)blockDim.y;
  const int a1 = 1 + n * ((int)threadIdx.y + 1) / (int)blockDim.y;
  if (a0 >= a1) return;
  for (int b = 1 + threadIdx.x; b < win.cols - 1; b += 32) {
    const int cf = win.col_flags[b];
    const int j = aj0 + b, gj = wj0 + b;
    const int jc = min(max(j, 0), W - 1);
    const int jl = max(jc - 1, 0), jr = min(jc + 1, W - 1);
    // column offsets of the column and its neighbours (on the stack the
    // window's columns b - 1, b and b + 1: jl, jc and jr in the array,
    // clamped offsets beyond it, where nothing read is used)
    const long oc = STACK ? sw.col(b, 2) : jc;
    const long ol = STACK ? sw.col(b - 1, 2) : jl;
    const long orr = STACK ? sw.col(b + 1, 2) : jr;
    // row offset of window row a, clamped into the array (the rows past
    // the window that a batch reads are never used)
    auto row_at = [&](int a) -> long {
      if constexpr (STACK)
        return sw.row(min(a, win.rows - 1), 2);
      else
        return (long)min(max(ai0 + a, 0), H - 1) * W;
    };
    auto vx_at = [&](int a, float v) {  // drained v0 of window row a
      return DRAIN ? drained(d, v, wi0 + a, gj, 0) : v;
    };
    // vx of rows a - 1 .. a + kBatch of the batch starting at row a
    float vx[kBatch + 2];
    vx[0] = vx_at(a0 - 1, v0[row_at(a0 - 1) + oc]);
    vx[1] = vx_at(a0, v0[row_at(a0) + oc]);
    for (int a = a0; a < a1; a += kBatch) {
      float vy[kBatch], vy_l[kBatch], vy_r[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const long r = row_at(a + u), r1 = row_at(a + u + 1);
        vx[u + 2] = v0[r1 + oc];
        vy[u] = v1[r + oc];
        vy_l[u] = v1[r + ol];
        vy_r[u] = v1[r + orr];
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
// a row, each warp walking a run of rows, kBatch rows at a time.  STACK:
// vel and out are member stacks, p_out [n, mh, mw] (no block mode), their
// offsets in sw.
template <bool DRAIN, bool STACK>
__device__ __forceinline__ void window_gradient(
    const float* __restrict__ vel, float* __restrict__ out,
    float* __restrict__ p_out, const Drain& d, const Geom& g,
    const RbWindow& win, const StackWindow& sw, int R, int th, int tw,
    int t0, int u0, int ai0, int aj0, int wi0, int wj0, int bh, int bw,
    float inv2dx) {
  const long plane = plane_of<STACK>(g.H, g.W, g.mh, g.mw);
  const long out_plane = STACK ? plane : (long)bh * bw;
  const int a0 = R + th * (int)threadIdx.y / (int)blockDim.y;
  const int a1 = R + th * ((int)threadIdx.y + 1) / (int)blockDim.y;
  if (a0 >= a1) return;
  for (int b = R + threadIdx.x; b < R + tw; b += 32) {
    const int cf = win.col_flags[b];
    const long oc = STACK ? sw.col(b, 2) : aj0 + b;
    for (int a = a0; a < a1; a += kBatch) {
      float vx[kBatch], vy[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        // rows past the run are clamped to its last: loaded, never used
        const int ra = min(a + u, a1 - 1);
        const long c = (STACK ? sw.row(ra, 2) : (long)(ai0 + ra) * g.W) + oc;
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
        // the owned cell in the outputs (on the stack without block mode:
        // window cell (ar, b))
        const long k = STACK ? sw.row(ar, 2) + oc
                             : (long)(t0 + ar - R) * bw + (u0 + b - R);
        const long kp = STACK ? sw.row(ar, 1) + sw.col(b, 1) : k;
        out[k] = vxc - (p_ip1 - p_im1) * inv2dx;
        out[out_plane + k] = vyc - (p_jp1 - p_jm1) * inv2dx;
        p_out[kp] = pc;
      }
    }
  }
}

// The window route: one block per TH x TW tile of the owned cells (all
// cells without block mode), which are the array's [halo, H - halo) x
// [halo, W - halo).  The window is the tile +- R, R = 2*iters + 1, in
// shared memory: p and dx*d split by colour (RbWindow, csrc/rb2d.cuh), then
// the row and column flags.  Window cell (a, b) is array cell (ai0 + a,
// aj0 + b) and global (wi0 + a, wj0 + b).  STACK: vel, out and p_out
// are member stacks of the H x W supergrid (MEMBER, no block mode).
template <bool MEMBER, bool BLOCK, bool STACK>
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
  // STACK: the window's offsets in the member stack, after the flags
  StackWindow sw{};
  if constexpr (STACK) {
    int* t = reinterpret_cast<int*>(row_flags + ((TH + TW + 4 * R + 3) & ~3));
    sw = StackWindow{t, t + rows, t + 2 * rows, t + 2 * rows + cols};
  }
  load_drain(d, imp, g.GH, g.GW, wi0, wi0 + rows - 1, wj0, wj0 + cols - 1);

  // 1. the flags, the stack's offsets and p = 0
  rb_window_init<MEMBER>(win, row_flags, col_flags, g, ai0, aj0);
  if constexpr (STACK)
    stack_window_init(sw, rows, cols, ai0, aj0, g.H, g.W, g.mh, g.mw);
  __syncthreads();

  // 2. dx * div on the tile +- (R - 1), 0 outside the domain
  if (iters > 0) {
    if (d.n > 0)
      window_divergence<BLOCK, true, STACK>(vel, d, g, win, sw, ai0, aj0,
                                            wi0, wj0, dx, inv2dx);
    else
      window_divergence<BLOCK, false, STACK>(vel, d, g, win, sw, ai0, aj0,
                                             wi0, wj0, dx, inv2dx);
    __syncthreads();
  }

  // 3. the half-sweeps on the shrinking window
  rb_window_half_sweeps(win, 2 * iters, omega, one_m_w);

  // 4. the gradient on the tile, written with the pressure to the owned
  // cells
  if (d.n > 0)
    window_gradient<true, STACK>(vel, out, p_out, d, g, win, sw, R, th, tw,
                                 t0, u0, ai0, aj0, wi0, wj0, bh, bw, inv2dx);
  else
    window_gradient<false, STACK>(vel, out, p_out, d, g, win, sw, R, th, tw,
                                  t0, u0, ai0, aj0, wi0, wj0, bh, bw,
                                  inv2dx);
}

template <bool MEMBER, bool BLOCK, bool STACK = false>
cudaError_t project_trapezoid(const float* v, float* vo, float* po,
                              const ImpulseArgs& imp, const Geom& g, int halo,
                              int TH, int TW, int threads_y, float dx,
                              float inv2dx, int iters, float omega,
                              float one_m_w, cudaStream_t s) {
  const WindowShape ws = window_shape(TH, TW, 2 * iters + 1);
  if (ws.cols == 0) return cudaErrorInvalidValue;
  const int bytes =
      ws.bytes + (STACK ? stack_window_bytes(TH + 4 * iters + 2,
                                             TW + 4 * iters + 2)
                        : 0);
  // this overload of project_tile_kernel, not the strip's
  void (*kernel)(const float*, float*, float*, const ImpulseArgs, const Geom,
                 int, int, int, int, float, float, int, float, float) =
      project_tile_kernel<MEMBER, BLOCK, STACK>;
  // above 48 KB a block's shared memory must be asked for
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.W - 2 * halo + TW - 1) / TW,
                  (g.H - 2 * halo + TH - 1) / TH);
  kernel<<<grid, dim3(32, threads_y), bytes, s>>>(
      v, vo, po, imp, g, halo, TH, TW, ws.stride, dx, inv2dx, iters, omega,
      one_m_w);
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
// [H - 2 halo, W - 2 halo] (halo = 0 without block mode); the owned cells
// cut into n_strips column strips of n_segs row segments, one block of 96
// threads each (ops/cuda/project.py strip_plan).  The other arguments as
// for fluid_project below.
extern "C" int fluid_project_window(const void* vel, void* vel_out,
                                    void* p_out, const void* ipos,
                                    const void* ivel, const void* iact,
                                    int n_imp, int H, int W, int mh, int mw,
                                    int oi, int oj, int GH, int GW, int halo,
                                    float dx, float inv2dx, int iters,
                                    float omega, float one_m_w, int n_strips,
                                    int n_segs, void* stream) {
  if (n_imp < 0 || n_imp > kMaxImpulses || iters < 0 ||
      2 * iters > kStripKmaxB || mh > 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vel);
  float* vo = static_cast<float*>(vel_out);
  float* po = static_cast<float*>(p_out);
  const ImpulseArgs imp{static_cast<const int*>(ipos),
                        static_cast<const float*>(ivel),
                        static_cast<const uint8_t*>(iact), n_imp};
  const Geom g = halo > 0 ? Geom{H, W, oi, oj, GH, GW, mh, mw}
                          : Geom{H, W, 0, 0, H, W, mh, mw};
  if (2 * iters <= kStripKmaxA)
    return (int)project_window_modes<kStripKmaxA>(
        v, vo, po, imp, g, halo, n_strips, n_segs, dx, inv2dx, iters, omega,
        one_m_w, s);
  return (int)project_window_modes<kStripKmaxB>(
      v, vo, po, imp, g, halo, n_strips, n_segs, dx, inv2dx, iters, omega,
      one_m_w, s);
}

// The trapezoid route (one launch), for member tiles: the arguments as for
// fluid_project_window, with TH x TW tiles and blocks of 32 x threads_y
// threads in place of the strips and segments.  stack = 1: vel and
// vel_out are the member stack [H/mh * W/mw, 2, mh, mw] of the H x W
// supergrid and p_out [n, mh, mw] (members, no block mode).
extern "C" int fluid_project_trapezoid(const void* vel, void* vel_out,
                                       void* p_out, const void* ipos,
                                       const void* ivel, const void* iact,
                                       int n_imp, int H, int W, int mh,
                                       int mw, int oi, int oj, int GH, int GW,
                                       int halo, float dx, float inv2dx,
                                       int iters, float omega, float one_m_w,
                                       int tile_h, int tile_w, int threads_y,
                                       int stack, void* stream) {
  if (n_imp < 0 || n_imp > kMaxImpulses || iters < 0 || tile_h < 1 ||
      tile_w < 1 || threads_y < 1 || threads_y > 32 ||
      (stack && (mh <= 0 || halo > 0)))
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
      return (int)project_trapezoid<true, true>(v, vo, po, imp, g, halo,
                                                tile_h, tile_w, threads_y, dx,
                                                inv2dx, iters, omega, one_m_w,
                                                s);
    return (int)project_trapezoid<false, true>(v, vo, po, imp, g, halo,
                                               tile_h, tile_w, threads_y, dx,
                                               inv2dx, iters, omega, one_m_w,
                                               s);
  }
  const Geom g{H, W, 0, 0, H, W, mh, mw};
  if (stack)
    return (int)project_trapezoid<true, false, true>(
        v, vo, po, imp, g, 0, tile_h, tile_w, threads_y, dx, inv2dx, iters,
        omega, one_m_w, s);
  if (mh > 0)
    return (int)project_trapezoid<true, false>(v, vo, po, imp, g, 0, tile_h,
                                               tile_w, threads_y, dx, inv2dx,
                                               iters, omega, one_m_w, s);
  return (int)project_trapezoid<false, false>(v, vo, po, imp, g, 0, tile_h,
                                              tile_w, threads_y, dx, inv2dx,
                                              iters, omega, one_m_w, s);
}

// The window route's resident blocks per SM at iters (0: refused).
extern "C" int fluid_project_window_blocks(int iters) {
  if (iters < 0 || 2 * iters > kStripKmaxB) return 0;
  if (2 * iters <= kStripKmaxA) return strip_blocks_per_sm<kStripKmaxA>();
  return strip_blocks_per_sm<kStripKmaxB>();
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
