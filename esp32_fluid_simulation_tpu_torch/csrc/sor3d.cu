// 3D red-black SOR pressure solve: passes of S fused half-sweeps, each one
// launch that marches z with a column of cells in each thread's registers.
//
// Replaces the TPU kernel esp32_fluid_simulation_tpu/ops/pallas/sor3d.py
// (sor3d_packed_pallas / _sor3d_chunk_padded).  That kernel DMAs a haloed
// (tile_d + 2pz, tile_h + 2pr, tile_w + 2pc) window into VMEM and runs
// `chunk` sweeps there.  A 3D halo of 2*chunk cells a side does not fit on
// a Hopper SM at a tile worth having, so this kernel blocks time in 2.5D:
//
// * A block owns a TH x TW tile of the array's (i, j) cells and a chunk of
//   ZC planes, and holds the tile +- S rows and +- A columns (its window;
//   A is S rounded up to a multiple of 4, so a window row starts on a
//   16-byte boundary).  S is the pass's depth, the half-sweeps it fuses.
// * Each thread owns a quad: four neighbouring cells of one window row, on
//   every plane.  It marches z with the quad's p and dx * d of the last R
//   planes in registers (R >= S + 2, the march unrolled R steps so every
//   ring slot is a fixed register).  The copy engine brings each plane's
//   quad of p and d (16 bytes each, cp.async) into a staging slot of
//   shared memory kLead steps before it enters the registers.
// * At step t, level k (its k-th half-sweep, k = 1..S) updates plane z =
//   zlo + 2 + t - k, one plane behind level k - 1, and every level of a
//   step updates the quad's two cells of one colour (a level's colour and
//   its plane change together).  Its z-neighbours, the quad's other two
//   cells and d are the thread's own registers.  Only the in-plane
//   neighbours in other quads (the rows above and below, the cell left or
//   right) come through shared memory, and those are the other colour,
//   which level k - 1 finished in step t - 1.  So each level publishes its
//   two cells for the next level to read in the next step (a buffer a
//   level, two by step parity), and a step needs one barrier, not one a
//   level.
// * The trapezoid: level k's updates reach the tile only from the window's
//   rows and columns within S - k of it and the planes [z0 - S + k, z1 + S
//   - k) (z0, z1: the block's chunk).  A cell's last level confines the
//   rows and columns; in z every level updates every plane of the array in
//   the domain, since a wrong value outside the trapezoid never reaches a
//   cell inside it.  The last level's plane is then exact on the tile, and
//   the thread stores its quad with one 16-byte store.
// * Passes chain through device memory: a pass reads the previous pass's
//   p and writes another buffer (the wrapper ping-pongs), since its window
//   reads the neighbour tiles' cells.  The first pass of a solve from zero
//   reads no p.
//
// Threads are laid out by row parity (the even window rows first, padded
// to whole warps), so the rows above and below a warp's quads are
// contiguous slots.  Quads that straddle the array's or the domain's edge,
// or rows whose start is not 16-byte aligned (W % 4 != 0), load and store
// cell by cell.
//
// Bound on the H100: device-memory bytes of the solve (d read once and p
// written once: 8 B per cell, 134 MB at 256^3, 0.040 ms at 3.35 TB/s).
// The design before this one (every plane of the window in shared-memory
// rings of p and d, 4-byte copies waited for at the end of each step, a
// barrier a level; 1.075 ms at 256^3) lost a third of its time to the
// copies' latency and most of the rest to issuing the levels: 34 bytes of
// shared-memory traffic a cell update, each with its address arithmetic.
// Its barriers cost 6%.  Here a cell update reads 10 bytes of shared
// memory and writes 4, and what bounds the pass is issue: ~35 instructions
// a level for two cells, 20 of them the update's arithmetic, on a window
// ~2x the tile, 16 warps a block and one block an SM (the registers: 2R
// planes of 4 floats a thread).  Timed in phases (clock64), a warp spends
// ~60% of a step in the levels, 15% entering and fetching a plane, 10%
// storing, 2% at the barrier and 1% waiting for copies.  On a plain step,
// most of them, the levels skip their checks of the array's planes and
// the z-walls.
//
// Arithmetic follows ops/poisson.py: neighbours summed
// ((((z- + z+) + i-) + i+) + j-) + j+ with zero ghosts, the -1/a_ii LUT of
// double divisions rounded to float (a_ii = in-domain neighbour count),
// p = (1-w) p + w (neg_inv (dx d - nb)), even parity first.  Built with
// --fmad=false, bit-equal to the plain PyTorch version.
//
// Block mode (K11, _sor3d_chunk, sor3d.py:246-259, the chunk of the
// sharded steps' solve, parallel/sharded3d.py): d and p are one shard's
// haloed block, whose cell (0, 0, 0) sits at global (oz, oi, oj) of a
// GD x GH x GW domain, and the sweeps run on the whole block from the given
// p.  Walls, a_ii and the colour (gz + gi + gj) & 1 come from the global
// coordinates.  A neighbour beyond the array reads 0 and a neighbour beyond
// a global wall reads 0 and leaves a_ii, two separate rules: a window cell
// outside the array or the domain is loaded as 0 and never updated (which
// gives both zero reads), and a_ii counts the global walls only.  Wrong
// values in the outer ring travel one cell per half-sweep, so with a halo
// of at least 2 * sweeps exchanged cells the owned block of a chain of
// chunks equals the whole-grid solve's to the bit.  The whole-grid solve is
// the same kernel with origin 0 and the array as its domain.

#include <cuda_runtime.h>

#include <utility>

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
// its cell (0, 0, 0) and the domain's extent.
struct Geom3 {
  int D, H, W, oz, oi, oj, GD, GH, GW;
};

// One pass: d, the input p (nullptr: 0) and the output p; the first
// half-sweep's global index h0 (its colour is h0 & 1); the tile (TH x TW
// cells, ZC planes); vec: rows start 16-byte aligned in all three arrays.
struct Pass3 {
  const float* d;
  const float* p_in;
  float* p_out;
  Geom3 g;
  int h0, TH, TW, ZC, vec;
  float dx, omega, one_m_w;
};

// A row's, column's or plane's flags: bits 0-1 its count of global walls,
// kOutside if it lies outside the array or the domain.
constexpr int kOutside = 4;

// The deepest pass the kernel is built for, and a block's most threads (a
// thread's registers: 128 at most, so a block of them fits an SM).
constexpr int kMaxDepth = 6;
constexpr int kMaxThreads = 512;
// Planes fetched ahead of the one that enters the registers, and the
// staging slots they land in.
constexpr int kLead = 3;
constexpr int kStage = kLead + 1;

__device__ __forceinline__ int axis_flags(int x, int n, int gx, int gn) {
  if (x < 0 || x >= n || gx < 0 || gx >= gn) return kOutside;
  return (gx == 0) + (gx == gn - 1);
}

// The window's column margin: S rounded up to a multiple of 4.
__host__ __device__ constexpr int margin(int S) { return (S + 3) / 4 * 4; }

// Quads in a window row of a tile tw columns wide.
__host__ __device__ inline int row_quads(int tw, int S) {
  return (tw + 2 * margin(S) + 3) / 4;
}

// Threads of the even window rows, padded to whole warps.
__host__ __device__ inline int even_threads(int th, int tw, int S) {
  return ((th + 2 * S + 1) / 2 * row_quads(tw, S) + 31) / 32 * 32;
}

// A block's threads for a th x tw tile at depth S.
__host__ __device__ inline int pass_threads(int th, int tw, int S) {
  return (even_threads(th, tw, S) + (th + 2 * S) / 2 * row_quads(tw, S) +
          31) / 32 * 32;
}

// Shared-memory bytes of a pass: two buffers (by step parity) of every
// level but the last, a float2 a thread, and the staging slots, a float4
// of d and one of p a thread.
__host__ __device__ constexpr int pass_bytes(int S) {
  return 2 * S * kMaxThreads * 8 + kStage * 2 * kMaxThreads * 16;
}

// A thread's quad and what it needs of it for the whole march.  The quad's
// cells are kept in the order (u0, u1, v0, v1): u the cells e and e + 2,
// which even steps update, v the cells 1 - e and 3 - e.
struct Quad {
  bool e;          // the quad's cell 1 is one of the even steps' cells
  int load;        // 0: nothing (0), 1: one 16-byte load, 2: cell by cell
  int lmask;       // cells inside the array and the domain (cell order)
  int store;       // 0: nothing, 1: one 16-byte store, 2: cell by cell
  int smask;       // cells in the tile (cell order)
  int goff;        // the array offset of its cell 0 in a plane
  int last[4];     // the last level that updates each cell (0: none)
  float ni[4];     // -1/a_ii of each cell on a plane without a z-wall
  float niw[4];    // and on a plane with one
  int pub, up, dn;  // float2 slots: its own and the rows above and below
  int edge[2];     // the float of a neighbour quad's pair that even and odd
                   // steps read
};
// (Every array of a Quad is indexed by constants only, so it stays in
// registers.)

// The block's extent in z and its march: steps t = -2 .. t_last; level k
// updates plane zlo + 2 + t - k where it lies in [zf, zc), the array's
// planes in the domain.  Levels also update the planes of the window
// outside the trapezoid: a cell there never reaches one inside it, whose
// dependences shrink by a plane a level as the trapezoid does.
struct Chunk {
  int z0, z1, zlo, zhi, zf, zc, t_last, zstride;
};

__device__ __forceinline__ void barrier(int n) {
  asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory");
}

// bytes (16 or 4) from src to the shared address dst through the copy
// engine, or zeros when !valid (src is then not read)
__device__ __forceinline__ void copy16(unsigned dst, const float* src,
                                       bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void copy4(unsigned dst, const float* src,
                                      bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Plane x's quad of d and p into the thread's staging slot at the shared
// addresses sd, sp (0 outside the array, the domain or the window; p 0
// without an input p); one commit group a call.
__device__ __forceinline__ void fetch(const Pass3& a, const Quad& q,
                                      const Chunk& c, int x, unsigned sd,
                                      unsigned sp) {
  // the planes [zf, zhi) of the array in the domain, zhi <= D
  const bool in = x >= c.zf && x < c.zhi;
  const int o = in ? x * c.zstride + q.goff : 0;
  const float* pz = a.p_in ? a.p_in : a.d;
  if (q.load == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool v = in && ((q.lmask >> i) & 1);
      copy4(sd + 4 * i, a.d + (v ? o + i : 0), v);
      copy4(sp + 4 * i, pz + (v ? o + i : 0), v && a.p_in);
    }
  } else {
    const bool v = in && q.load == 1;
    copy16(sd, a.d + o, v);
    copy16(sp, pz + o, v && a.p_in);
  }
  copy_commit();
}

// (u0, u1, v0, v1) of the cells x0..x3
__device__ __forceinline__ void to_uv(bool e, float4 x, float (&r)[4]) {
  r[0] = e ? x.y : x.x;
  r[1] = e ? x.w : x.z;
  r[2] = e ? x.x : x.y;
  r[3] = e ? x.z : x.w;
}

// The cells of the quads above, below and beside that level K reads in
// step U: level K - 1's pairs of the previous step.
struct Around {
  float2 up, dn;
  float edge;
};

template <int U, int K>
__device__ __forceinline__ Around around(const Quad& q, const float2* buf) {
  const float2* in = buf + (2 * (K - 1) + ((U + 1) & 1)) * kMaxThreads;
  return {in[q.up], in[q.dn],
          reinterpret_cast<const float*>(in)[q.edge[U & 1]]};
}

// Level K of step t (static position U in its unrolled block of R steps):
// the quad's two cells of the step's colour on plane zb - K, zb = zlo + 2
// + t, from the neighbours' cells n.  It runs without branches: off the
// array's planes in the domain it computes and keeps nothing.  On a plain
// step (EDGE false) every level's plane is one of those and none a
// z-wall, and it checks neither.  Level K + 1's neighbours are read first,
// so their latency overlaps this level's arithmetic.
template <int S, int R, int U, int K, bool EDGE>
__device__ __forceinline__ void level(const Pass3& a, const Quad& q,
                                      const Chunk& c, int zb,
                                      float (&pr)[R][4], float (&dr)[R][4],
                                      float2* buf, const Around n) {
  // (zb: the step's plane of level 0; the plane of level K is zb - K)
  Around next;
  if constexpr (K < S) next = around<U, K + 1>(q, buf);
  constexpr int P = U & 1;            // even steps update u, odd ones v
  constexpr int a0 = 2 * P, a1 = a0 + 1, b0 = 2 - a0, b1 = b0 + 1;
  constexpr int sl = (U + 2 - K + R) % R;
  constexpr int sb = (U + 1 - K + R) % R;
  constexpr int sa = (U + 3 - K + R) % R;
  const Geom3& g = a.g;
  const int z = zb - K;
  const bool on = !EDGE || (z >= c.zf && z < c.zc);
  // the quad's left and right neighbours of its cells a0 and a1
  const bool f = P ? !q.e : q.e;
  const float jm0 = f ? pr[sl][b0] : n.edge;
  const float jp0 = f ? pr[sl][b1] : pr[sl][b0];
  const float jp1 = f ? n.edge : pr[sl][b1];
  const float nb0 =
      ((((pr[sb][a0] + pr[sa][a0]) + n.up.x) + n.dn.x) + jm0) + jp0;
  const float nb1 =
      ((((pr[sb][a1] + pr[sa][a1]) + n.up.y) + n.dn.y) + jp0) + jp1;
  const bool zw = EDGE && (g.oz + z == 0 || g.oz + z == g.GD - 1);
  const float n0 = zw ? q.niw[a0] : q.ni[a0];
  const float n1 = zw ? q.niw[a1] : q.ni[a1];
  const float v0 =
      a.one_m_w * pr[sl][a0] + a.omega * (n0 * (dr[sl][a0] - nb0));
  const float v1 =
      a.one_m_w * pr[sl][a1] + a.omega * (n1 * (dr[sl][a1] - nb1));
  // a cell this level leaves keeps its value
  if (on && K <= q.last[a0]) pr[sl][a0] = v0;
  if (on && K <= q.last[a1]) pr[sl][a1] = v1;
  if constexpr (K < S) {
    buf[(2 * K + (U & 1)) * kMaxThreads + q.pub] =
        make_float2(pr[sl][a0], pr[sl][a1]);
    level<S, R, U, K + 1, EDGE>(a, q, c, zb, pr, dr, buf, next);
  }
}

// plane z's quad u (in the order u0, u1, v0, v1) into p_out where it lies
// in the block's chunk and the quad in its tile
__device__ __forceinline__ void store(const Pass3& a, const Quad& q,
                                      const Chunk& c, int z,
                                      const float (&u)[4]) {
  if (z < c.z0 || z >= c.z1 || !q.store) return;
  const float x[4] = {q.e ? u[2] : u[0], q.e ? u[0] : u[2],
                      q.e ? u[3] : u[1], q.e ? u[1] : u[3]};
  float* out = a.p_out + (z * c.zstride + q.goff);  // < 2^31 cells
  if (q.store == 1) {
    *reinterpret_cast<float4*>(out) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if ((q.smask >> i) & 1) out[i] = x[i];
  }
}

// Step t: plane zlo + t + 2 enters the registers from its staging slot and
// its cells of the step's colour are published (the pass's input, for
// level 1 in the next step), plane zlo + t + 2 + kLead is fetched, the
// levels run, and the plane the last level finished is stored.
template <int S, int R, int U>
__device__ __forceinline__ void step(const Pass3& a, const Quad& q,
                                     const Chunk& c, int tb,
                                     float (&pr)[R][4], float (&dr)[R][4],
                                     const float4* stage, float2* buf) {
  const int t = tb + U;
  if (t < -2 || t > c.t_last) return;  // uniform over the block
  constexpr int P = U & 1;
  constexpr int sn = (U + 2) % R;
  constexpr int in_slot = (U + 2) % kStage;
  constexpr int out_slot = (U + 2 + kLead) % kStage;
  const int tid = threadIdx.x;
  copy_wait<kLead - 1>();
  to_uv(q.e, stage[(2 * in_slot) * kMaxThreads + tid], pr[sn]);
  float dv[4];
  to_uv(q.e, stage[(2 * in_slot + 1) * kMaxThreads + tid], dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) dr[sn][i] = a.dx * dv[i];
  if constexpr (S > 0)
    buf[(U & 1) * kMaxThreads + q.pub] =
        make_float2(pr[sn][2 * P], pr[sn][2 * P + 1]);
  const unsigned st = static_cast<unsigned>(__cvta_generic_to_shared(stage));
  fetch(a, q, c, c.zlo + t + 2 + kLead,
        st + 16 * ((2 * out_slot + 1) * kMaxThreads + tid),
        st + 16 * ((2 * out_slot) * kMaxThreads + tid));
  if constexpr (S > 0) {
    // a plain step: every level's plane is one of the array's in the
    // domain, and none a z-wall
    const int zb = c.zlo + 2 + t;
    const int w0 = -a.g.oz, w1 = a.g.GD - 1 - a.g.oz;
    const Around n = around<U, 1>(q, buf);
    if (zb - S >= c.zf && zb - 1 < c.zc && (zb - S > w0 || zb - 1 < w0) &&
        (zb - S > w1 || zb - 1 < w1))
      level<S, R, U, 1, false>(a, q, c, zb, pr, dr, buf, n);
    else
      level<S, R, U, 1, true>(a, q, c, zb, pr, dr, buf, n);
  }
  store(a, q, c, c.zlo + 2 + t - S, pr[(U + 2 - S + R) % R]);
  barrier(blockDim.x);
}

template <int S, int R, int... U>
__device__ __forceinline__ void steps(const Pass3& a, const Quad& q,
                                      const Chunk& c, int tb,
                                      float (&pr)[R][4], float (&dr)[R][4],
                                      const float4* stage, float2* buf,
                                      std::integer_sequence<int, U...>) {
  (step<S, R, U>(a, q, c, tb, pr, dr, stage, buf), ...);
}

// One pass on the tile (blockIdx.x, blockIdx.y) of a TH x TW tiling of the
// array's (i, j) and the chunk blockIdx.z of ZC planes.  The march runs in
// blocks of R steps, so that plane zlo + x sits in the fixed register slot
// x % R and its staging slot x % kStage.
template <int S>
__global__ void __launch_bounds__(kMaxThreads, 1)
    sor3d_pass_kernel(const Pass3 a) {
  extern __shared__ float4 smem[];
  float2* buf = reinterpret_cast<float2*>(smem);
  const float4* stage = smem + S * kMaxThreads;
  const Geom3& g = a.g;
  constexpr int A = margin(S);
  constexpr int R = (S + 5) / 4 * 4;  // at least S + 2
  static_assert(R % kStage == 0, "staging slots must repeat with the ring");
  const int t0 = blockIdx.y * a.TH, u0 = blockIdx.x * a.TW;
  const int th = min(a.TH, g.H - t0), tw = min(a.TW, g.W - u0);
  const int rows = th + 2 * S, cols = tw + 2 * S, qw = row_quads(tw, S);
  const int ai0 = t0 - S, aj0 = u0 - A;

  Chunk c;
  c.z0 = blockIdx.z * a.ZC;
  c.z1 = min(c.z0 + a.ZC, g.D);
  c.zlo = max(c.z0 - S, -1);
  c.zf = max(0, -g.oz);
  c.zc = min(g.D, g.GD - g.oz);
  c.zhi = min(c.z1 + S, c.zc);
  c.t_last = c.z1 - 3 - c.zlo + S;  // stores plane z1 - 1
  c.zstride = g.H * g.W;

  // the thread's quad: the even window rows first, then the odd ones, each
  // row qw quads
  const int tid = threadIdx.x;
  const int n_even = (rows + 1) / 2 * qw;
  const int pad = (n_even + 31) / 32 * 32;
  const int odd = tid >= pad;
  const int idx = odd ? tid - pad : tid;
  const int r = 2 * (idx / qw) + odd, gq = idx % qw;
  const bool active = idx < (odd ? rows / 2 : (rows + 1) / 2) * qw;
  auto slot = [&](int rr, int gg) {
    return ((rr & 1) ? pad : 0) + (rr >> 1) * qw + gg;
  };

  // the cells the levels of step t update: (e' + t + i) even for cell i,
  // e' the parity of the row's global position, the march's start and the
  // pass's first half-sweep; e: whether that makes cell 1 an even step's
  Quad q;
  q.e = (g.oz + g.oi + g.oj + c.zlo + ai0 + aj0 + r + a.h0 + 1) & 1;
  q.pub = tid;
  const bool inner_row = active && r > 0 && r < rows - 1;
  q.up = inner_row ? slot(r - 1, gq) : tid;
  q.dn = inner_row ? slot(r + 1, gq) : tid;
  // a neighbour's pair holds its cells of the other colour in cell order:
  // the left quad's cell 3 is its pair's second, the right quad's cell 0
  // its first
  const int left = 2 * (active && gq > 0 ? tid - 1 : tid) + 1;
  const int right = 2 * (active && gq < qw - 1 ? tid + 1 : tid);
  q.edge[0] = q.e ? right : left;
  q.edge[1] = q.e ? left : right;
  const int rf = axis_flags(ai0 + r, g.H, g.oi + ai0 + r, g.GH);
  const int rd = min(r, rows - 1 - r);
  q.lmask = q.smask = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // the cell at place k of (u0, u1, v0, v1)
    const int i = ((k < 2) == q.e ? 1 : 0) + 2 * (k & 1);
    const int col = 4 * gq + i;  // window column
    const int cf = axis_flags(aj0 + col, g.W, g.oj + aj0 + col, g.GW);
    const bool out = !active || ((rf | cf) & kOutside);
    const int cw = col - (A - S);  // column in the trapezoid's base
    q.last[k] = out || cw < 0 || cw >= cols
                    ? 0
                    : min(rd, min(cw, cols - 1 - cw));
    const int walls = (rf & 3) + (cf & 3);
    q.ni[k] = kNegInv[6 - walls];
    q.niw[k] = kNegInv[5 - walls];
    if (!out) q.lmask |= 1 << i;
    if (active && r >= S && r < S + th && col >= A && col < A + tw)
      q.smask |= 1 << i;
  }
  q.goff = (ai0 + r) * g.W + aj0 + 4 * gq;
  q.load = !q.lmask ? 0 : (q.lmask == 15 && a.vec) ? 1 : 2;
  q.store = !q.smask ? 0 : (q.smask == 15 && a.vec) ? 1 : 2;

  // the levels read their neighbours' buffers before the trapezoid reaches
  // them: zeros, not whatever the shared memory held
  for (int i = tid; i < 2 * S * kMaxThreads; i += blockDim.x)
    buf[i] = make_float2(0.f, 0.f);
  float pr[R][4], dr[R][4];
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) pr[j][i] = dr[j][i] = 0.f;
  const unsigned st = static_cast<unsigned>(__cvta_generic_to_shared(stage));
#pragma unroll
  for (int j = 0; j < kLead; ++j)
    fetch(a, q, c, c.zlo + j, st + 16 * ((2 * j + 1) * kMaxThreads + tid),
          st + 16 * ((2 * j) * kMaxThreads + tid));
  barrier(blockDim.x);
  for (int tb = -R; tb <= c.t_last; tb += R)
    steps<S, R>(a, q, c, tb, pr, dr, stage, buf,
                std::make_integer_sequence<int, R>{});
}

template <int S>
cudaError_t launch_pass(const Pass3& a, int threads, cudaStream_t s) {
  constexpr int bytes = pass_bytes(S);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sor3d_pass_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.g.W + a.TW - 1) / a.TW, (a.g.H + a.TH - 1) / a.TH,
                  (a.g.D + a.ZC - 1) / a.ZC);
  sor3d_pass_kernel<S><<<grid, threads, bytes, s>>>(a);
  return cudaGetLastError();
}

// A block's threads for a pass of `depth` on a tile_h x tile_w tile, or 0
// if the kernel does not take it (too deep, a tile width not a multiple of
// 4, more threads than a block of it may have).
int threads_of(int tile_h, int tile_w, int depth) {
  if (depth < 0 || depth > kMaxDepth || tile_h < 1 || tile_w < 4 ||
      tile_w % 4)
    return 0;
  const int n = pass_threads(tile_h, tile_w, depth);
  return n <= kMaxThreads ? n : 0;
}

}  // namespace

// One pass of `depth` half-sweeps, the first of global index h0 (even
// parity first), on d and p_in ([D, H, W] float32; p_in nullptr: from
// zero), into p_out (not p_in).  The array's cell (0, 0, 0) sits at global
// (oz, oi, oj) of a GD x GH x GW domain (0 and the array's own extent
// without block mode).  Tiles of tile_h x tile_w cells and zchunk planes;
// vec: W % 4 == 0 and the three pointers 16-byte aligned.
extern "C" int fluid_sor3d_pass(const void* d, const void* p_in, void* p_out,
                                int D, int H, int W, int oz, int oi, int oj,
                                int GD, int GH, int GW, float dx, int h0,
                                int depth, float omega, float one_m_w,
                                int tile_h, int tile_w, int zchunk, int vec,
                                void* stream) {
  const int threads = threads_of(tile_h, tile_w, depth);
  if (!threads || zchunk < 1 || D < 1 || H < 1 || W < 1 ||
      (long long)D * H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const Pass3 a{static_cast<const float*>(d),
                static_cast<const float*>(p_in),
                static_cast<float*>(p_out),
                Geom3{D, H, W, oz, oi, oj, GD, GH, GW},
                h0,
                tile_h,
                tile_w,
                zchunk,
                vec,
                dx,
                omega,
                one_m_w};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (depth) {
    case 0: return (int)launch_pass<0>(a, threads, s);
    case 1: return (int)launch_pass<1>(a, threads, s);
    case 2: return (int)launch_pass<2>(a, threads, s);
    case 3: return (int)launch_pass<3>(a, threads, s);
    case 4: return (int)launch_pass<4>(a, threads, s);
    case 5: return (int)launch_pass<5>(a, threads, s);
    case 6: return (int)launch_pass<6>(a, threads, s);
  }
  return (int)cudaErrorInvalidValue;
}

// A block's threads for a pass of `depth` on a tile_h x tile_w tile, or 0
// if fluid_sor3d_pass refuses it.
extern "C" int fluid_sor3d_pass_threads(int tile_h, int tile_w, int depth) {
  return threads_of(tile_h, tile_w, depth);
}
