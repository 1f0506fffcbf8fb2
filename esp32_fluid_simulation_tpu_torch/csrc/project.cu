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

// Resolve the impulse slots into the cells of rows [r0, r1] x cols [c0, c1]
// (clamped positions, the last active slot at a cell wins).  Called by every
// thread of a block of at least 32 threads.
__device__ void load_drain(Drain& d, const int* __restrict__ ipos,
                           const float* __restrict__ ivel,
                           const uint8_t* __restrict__ iact, int n_imp, int H,
                           int W, int r0, int r1, int c0, int c1) {
  __shared__ int pi[kMaxImpulses];
  __shared__ int pj[kMaxImpulses];
  __shared__ uint8_t act[kMaxImpulses];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < n_imp) {
    pi[tid] = min(max(ipos[2 * tid], 0), H - 1);
    pj[tid] = min(max(ipos[2 * tid + 1], 0), W - 1);
    act[tid] = iact[tid] != 0;
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
        d.v0[k] = ivel[2 * t];
        d.v1[k] = ivel[2 * t + 1];
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

template <bool MEMBER>
__global__ void drain_divergence_kernel(
    const float* __restrict__ vel, float* __restrict__ dxd,
    float* __restrict__ p, const int* __restrict__ ipos,
    const float* __restrict__ ivel, const uint8_t* __restrict__ iact,
    int n_imp, int H, int W, int mh, int mw, float dx, float inv2dx) {
  __shared__ Drain d;
  const int i0 = blockIdx.y * blockDim.y;
  const int j0 = blockIdx.x * blockDim.x;
  load_drain(d, ipos, ivel, iact, n_imp, H, W, i0 - 1,
             i0 + (int)blockDim.y, j0 - 1, j0 + (int)blockDim.x);
  const int i = i0 + threadIdx.y;
  const int j = j0 + threadIdx.x;
  if (i >= H || j >= W) return;
  const long plane = (long)H * W;
  const long c = (long)i * W + j;
  const float* v0 = vel;
  const float* v1 = vel + plane;
  const Walls w = walls<MEMBER>(i, j, H, W, mh, mw);
  const float vx = drained(d, v0[c], i, j, 0);
  const float vy = drained(d, v1[c], i, j, 1);
  // reflected ghosts at the walls: the outside neighbour is -center
  const float t_up = w.i_lo ? -vx : drained(d, v0[c - W], i - 1, j, 0);
  const float t_dn = w.i_hi ? -vx : drained(d, v0[c + W], i + 1, j, 0);
  const float t_lf = w.j_lo ? -vy : drained(d, v1[c - 1], i, j - 1, 1);
  const float t_rt = w.j_hi ? -vy : drained(d, v1[c + 1], i, j + 1, 1);
  const float div = ((-t_up + t_dn) + (-t_lf + t_rt)) * inv2dx;
  dxd[c] = dx * div;
  p[c] = 0.f;
}

template <bool MEMBER>
__global__ void gradient_kernel(const float* __restrict__ vel,
                                const float* __restrict__ p,
                                float* __restrict__ out,
                                const int* __restrict__ ipos,
                                const float* __restrict__ ivel,
                                const uint8_t* __restrict__ iact, int n_imp,
                                int H, int W, int mh, int mw, float inv2dx) {
  __shared__ Drain d;
  const int i0 = blockIdx.y * blockDim.y;
  const int j0 = blockIdx.x * blockDim.x;
  load_drain(d, ipos, ivel, iact, n_imp, H, W, i0,
             i0 + (int)blockDim.y - 1, j0, j0 + (int)blockDim.x - 1);
  const int i = i0 + threadIdx.y;
  const int j = j0 + threadIdx.x;
  if (i >= H || j >= W) return;
  const long plane = (long)H * W;
  const long c = (long)i * W + j;
  const Walls w = walls<MEMBER>(i, j, H, W, mh, mw);
  const float pc = p[c];
  // Neumann walls: the outside pressure is the center value
  const float p_im1 = w.i_lo ? pc : p[c - W];
  const float p_ip1 = w.i_hi ? pc : p[c + W];
  const float p_jm1 = w.j_lo ? pc : p[c - 1];
  const float p_jp1 = w.j_hi ? pc : p[c + 1];
  const float vx = drained(d, vel[c], i, j, 0);
  const float vy = drained(d, vel[plane + c], i, j, 1);
  out[c] = vx - (p_ip1 - p_im1) * inv2dx;
  out[plane + c] = vy - (p_jp1 - p_jm1) * inv2dx;
}

template <bool MEMBER>
cudaError_t project(const float* v, float* vo, float* pp, float* dd,
                    const int* ip, const float* iv, const uint8_t* ia,
                    int n_imp, int H, int W, int mh, int mw, float dx,
                    float inv2dx, int iters, float omega, float one_m_w,
                    cudaStream_t s) {
  const dim3 block(32, 8);
  const dim3 grid((W + 31) / 32, (H + 7) / 8);
  drain_divergence_kernel<MEMBER><<<grid, block, 0, s>>>(
      v, dd, pp, ip, iv, ia, n_imp, H, W, mh, mw, dx, inv2dx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = sor_half_sweeps(pp, dd, H, W, mh, mw, iters, omega, one_m_w, s);
  if (err != cudaSuccess) return err;

  gradient_kernel<MEMBER><<<grid, block, 0, s>>>(v, pp, vo, ip, iv, ia,
                                                 n_imp, H, W, mh, mw, inv2dx);
  return cudaGetLastError();
}

}  // namespace

// vel, vel_out: [2, H, W] float32; p, dxd: [H, W] float32 (dxd is scratch);
// ipos: int32 [n_imp, 2]; ivel: float32 [n_imp, 2]; iact: bool [n_imp];
// mh, mw: the member tile (mh = 0: none; else mh, mw >= 2 dividing H, W).
extern "C" int fluid_project(const void* vel, void* vel_out, void* p,
                             void* dxd, const void* ipos, const void* ivel,
                             const void* iact, int n_imp, int H, int W,
                             int mh, int mw, float dx, float inv2dx,
                             int iters, float omega, float one_m_w,
                             void* stream) {
  if (n_imp < 0 || n_imp > kMaxImpulses) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vel);
  float* vo = static_cast<float*>(vel_out);
  float* pp = static_cast<float*>(p);
  float* dd = static_cast<float*>(dxd);
  const int* ip = static_cast<const int*>(ipos);
  const float* iv = static_cast<const float*>(ivel);
  const uint8_t* ia = static_cast<const uint8_t*>(iact);
  if (mh > 0)
    return (int)project<true>(v, vo, pp, dd, ip, iv, ia, n_imp, H, W, mh, mw,
                              dx, inv2dx, iters, omega, one_m_w, s);
  return (int)project<false>(v, vo, pp, dd, ip, iv, ia, n_imp, H, W, mh, mw,
                             dx, inv2dx, iters, omega, one_m_w, s);
}
