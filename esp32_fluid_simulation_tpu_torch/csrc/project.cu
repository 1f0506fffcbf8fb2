// Pressure projection with the drag-queue drain: drain -> reflected-ghost
// divergence -> 2*iters red-black SOR half-sweeps from zero -> edge-clamped
// gradient subtract.
//
// Replaces the TPU kernel esp32_fluid_simulation_tpu/ops/pallas/project.py
// (project_fused_pallas / _project_kernel, with the packed red-black solve
// of ops/pallas/rb_common.py:packed_rb_solve_full).  The TPU kernel keeps a
// whole trapezoidal window in VMEM and runs all half-sweeps there.  A Hopper
// block has far less fast memory and blocks cannot wait for each other, so
// this first version runs the phases as separate launches on one stream:
//   1. drain + divergence: dxd = dx * div(drained velocity), p = 0;
//   2. 2*iters in-place parity half-sweeps (csrc/rb2d.cuh, shared with
//      K4's csrc/sor.cu).  In place is exact red-black Gauss-Seidel: a
//      half-sweep updates only one colour, and same-colour cells never read
//      each other;
//   3. gradient subtract from the drained velocity into the output.
//
// Bound on the H100: device-memory bytes.  Each half-sweep reads the whole
// pressure field and dxd for its colour and writes half the pressure field
// (about 1.5 x 4 B per cell); at 4096^2 the 20 half-sweeps are ~85% of the
// bytes, since the 64 MiB pressure field does not stay in the 50 MB L2.
// Keeping the sweeps on chip (shared-memory temporal tiling, as the TPU
// kernel does in VMEM) is the next step and a later change.
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
// 2*iters+2 exchanged cells per side.  Launches 1 and 2 run over the whole
// haloed block in global coordinates (csrc/rb2d.cuh): the walls of the
// divergence, the SOR and the gradient are the domain's (or the members'),
// the drain compares global positions, a neighbour beyond the block reads
// 0, and cells outside the domain hold dxd = p = 0.  Launch 3 runs over the
// owned cells only and writes them, and their pressure, to the outputs.
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
