// 3D red-black SOR pressure solve: passes of S fused half-sweeps, each one
// launch that marches z through shared memory.
//
// Replaces the TPU kernel esp32_fluid_simulation_tpu/ops/pallas/sor3d.py
// (sor3d_packed_pallas / _sor3d_chunk_padded).  That kernel DMAs a haloed
// (tile_d + 2pz, tile_h + 2pr, tile_w + 2pc) window into VMEM and runs
// `chunk` sweeps there.  A 3D halo of 2*chunk cells a side does not fit in
// a Hopper block's 227 KB of shared memory at a tile worth having, so this
// kernel blocks time in 2.5D instead:
//
// * A block owns a TH x TW tile of the array's (i, j) cells and a chunk of
//   ZC planes, and holds the tile +- S cells (its window) one z-plane at a
//   time: S is the pass's depth, the number of half-sweeps it fuses.
// * It marches z.  At step t, level k (its k-th half-sweep, k = 1..S)
//   updates plane z = zlo + 2 + t - k, so level k runs one plane behind
//   level k - 1, and the levels of a step run in order with a barrier
//   between them.  Level k at z then reads level k - 1's values at z - 1,
//   z and z + 1, and its writes come after every read of the values they
//   replace (level k - 1 at z + 1 ran earlier in the same step).  One
//   in-place ring of S + 3 planes holds p: the S + 2 planes the levels read
//   and the plane the copy engine fills for the next step (cp.async, 4
//   bytes a cell, 0 outside).  A ring of the same size holds d.
// * The trapezoid: level k updates only the window's rows and columns
//   [k, rows - k) x [k, cols - k) and the planes [z0 - S + k, z1 + S - k)
//   (z0, z1: the block's chunk), the cells whose value still reaches the
//   block's tile and chunk after the pass; the rest of the window holds
//   the pass's input and is read, never written.  After S levels the tile
//   and chunk are exact, and they alone are written out.
// * Passes chain through device memory: a pass reads the previous pass's
//   p and writes another buffer (the wrapper ping-pongs), since its window
//   reads the neighbour tiles' cells.  The first pass of a solve from zero
//   reads no p (the copy fills 0).
//
// Each plane is stored split by the in-plane colour (gi + gj) & 1, as
// RbWindow does in csrc/rb2d.cuh: half q holds window row a's cells of
// in-plane colour q at a * hp + (b >> 1).  The levels of a step all update
// one half (a level's colour and its plane change together), a thread two
// neighbouring words of it at once (8-byte shared-memory accesses): their
// in-plane neighbours lie in the other half, at consecutive words, and
// their z-neighbours in the same half of the planes z - 1 and z + 1.  Each
// thread works out once which window cells it loads and stores and which
// pairs it updates, with their flags and levels, and keeps them in
// registers for the whole march.
//
// Bound on the H100: device-memory bytes of the solve (d read once and p
// written once: 8 B per cell, 134 MB at 256^3, 0.040 ms at 3.35 TB/s).  A
// pass reads d and p (or only d) and writes p once, plus the windows'
// rings of neighbour cells (mostly from L2).  What holds it back is the
// half-sweeps in shared memory: about 34 bytes of shared-memory traffic
// and 30 instructions a cell update, on a trapezoid 1.5-1.8 times the tile
// and chunk, with a barrier between levels.  The launch per half-sweep
// that this replaces streamed p and d through device memory 20 times.
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
// cells, ZC planes).
struct Pass3 {
  const float* d;
  const float* p_in;
  float* p_out;
  Geom3 g;
  int h0, TH, TW, ZC;
  float dx, omega, one_m_w;
};

// A window row's, column's or plane's flags: bits 0-1 its count of global
// walls, kOutside if it lies outside the array or the domain.
constexpr int kOutside = 4;

// The deepest pass the kernel is built for (its depth is a template
// argument, so the levels of a step unroll).
constexpr int kMaxDepth = 6;

__device__ __forceinline__ int axis_flags(int x, int n, int gx, int gn) {
  if (x < 0 || x >= n || gx < 0 || gx >= gn) return kOutside;
  return (gx == 0) + (gx == gn - 1);
}

// 4 bytes from src to the shared address dst through the copy engine, or
// 0 when !valid (src is then not read).
__device__ __forceinline__ void copy_async(unsigned dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The half-plane pitch hp (at least half a window row, even) and the words
// of one half of a window plane (rows x hp), for a TH x TW tile at depth S.
__host__ __device__ __forceinline__ int half_pitch(int TW, int S) {
  return (TW + 2 * S + 3) / 4 * 2;  // even: pairs of words never straddle rows
}

__host__ __device__ __forceinline__ int half_words(int TH, int TW, int S) {
  return (TH + 2 * S) * half_pitch(TW, S);
}

// Shared-memory bytes of a pass: rings of S + 3 planes of p and of d.
__host__ __device__ __forceinline__ int pass_bytes(int TH, int TW, int S) {
  return 4 * 2 * (S + 3) * 2 * half_words(TH, TW, S);
}

// One pass on the tile (blockIdx.x, blockIdx.y) of a TH x TW tiling of the
// array's (i, j) and the chunk blockIdx.z of ZC planes.  Every thread
// takes up to NL cells of the window (which it loads) and of the tile
// (which it stores) and up to NU pairs of neighbouring half-plane words
// (which it updates, two cells of a colour at once), the same on every
// plane, and works out their addresses, flags and levels once.
template <int S, int NL, int NU>
__global__ void __launch_bounds__(512, 1) sor3d_pass_kernel(const Pass3 a) {
  extern __shared__ float smem[];
  const Geom3 g = a.g;
  constexpr int P = S + 3;
  const int t0 = blockIdx.y * a.TH, u0 = blockIdx.x * a.TW;
  const int th = min(a.TH, g.H - t0), tw = min(a.TW, g.W - u0);
  const int rows = th + 2 * S, cols = tw + 2 * S;
  const int z0 = blockIdx.z * a.ZC, z1 = min(z0 + a.ZC, g.D);
  // the planes in the window: [zlo, zhi), one beyond the array at most
  const int zlo = max(z0 - S, -1), zhi = min(z1 + S, g.D + 1);
  const int ai0 = t0 - S, aj0 = u0 - S;  // window cell (0, 0) in the array
  const int base = (ai0 + g.oi + aj0 + g.oj) & 1;
  const int hp = half_pitch(a.TW, S);
  const int half = half_words(a.TH, a.TW, S);
  const int plane = 2 * half;
  float* sp = smem;
  float* sd = sp + P * plane;
  const long long zstride = (long long)g.H * g.W;
  // plane z sits in ring slot (z - zlo) % P, kept by the step loop
  auto wrap = [&](int i) { return i < 0 ? i + P : i >= P ? i - P : i; };
  auto row_flags = [&](int r) {
    return axis_flags(ai0 + r, g.H, g.oi + ai0 + r, g.GH);
  };
  auto col_flags = [&](int c) {
    return c < cols ? axis_flags(aj0 + c, g.W, g.oj + aj0 + c, g.GW)
                    : kOutside;
  };
  // a window cell's word in a plane
  auto word = [&](int r, int c) {
    return ((base + r + c) & 1) * half + r * hp + (c >> 1);
  };

  // load[i]: the plane word of a window cell and its offset in an array
  // plane (-1: outside the array or the domain, loaded as 0); store[i]: a
  // tile cell's plane word and array offset.  upd_w[j]: the first word w =
  // r * hp + m of a pair in a half-plane; for either in-plane colour s of
  // the cells b = 2m + s + 2u (u = 0, 1) there, upd_last[j] holds in byte
  // 2s + u the last level that updates the cell (0: none; the window's rim
  // and cells outside are never updated) and upd_f[j] in bits 4s + 2u and
  // up the cell's count of row and column walls, and in bit 8 (base + r)
  // & 1.
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int nthreads = 32 * blockDim.y;
  int load_w[NL], load_g[NL], store_w[NL], store_g[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int e = tid + i * nthreads;
    load_w[i] = load_g[i] = store_w[i] = store_g[i] = -1;
    if (e < rows * cols) {
      const int r = e / cols, c = e % cols;
      load_w[i] = word(r, c);
      if (!((row_flags(r) | col_flags(c)) & kOutside))
        load_g[i] = (ai0 + r) * g.W + aj0 + c;
    }
    if (e < th * tw) {
      const int r = S + e / tw, c = S + e % tw;
      store_w[i] = word(r, c);
      store_g[i] = (ai0 + r) * g.W + aj0 + c;
    }
  }
  int upd_w[NU], upd_last[NU], upd_f[NU];
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    const int w = 2 * (tid + j * nthreads);
    upd_w[j] = -1;
    upd_last[j] = upd_f[j] = 0;
    if (w < rows * hp) {
      const int r = w / hp, m = w % hp;
      const int rf = row_flags(r);
      int last = 0, f = ((base + r) & 1) << 8;
      for (int s = 0; s < 2; ++s) {
        for (int u = 0; u < 2; ++u) {
          const int b = 2 * (m + u) + s;
          const int cf = col_flags(b);
          const int l = ((rf | cf) & kOutside)
                            ? 0
                            : min(255, min(min(r, rows - 1 - r),
                                           min(b, cols - 1 - b)));
          last |= l << (8 * (2 * s + u));
          f |= ((rf & 3) + (cf & 3)) << (4 * s + 2 * u);
        }
      }
      upd_w[j] = w;
      upd_last[j] = last;
      upd_f[j] = f;
    }
  }

  // plane z of p and d into ring slot i (0 outside the array or the
  // domain)
  const unsigned ring_p = (unsigned)__cvta_generic_to_shared(sp);
  const unsigned ring_d = (unsigned)__cvta_generic_to_shared(sd);
  auto load = [&](int z, int i_slot) {
    const bool z_in = !(axis_flags(z, g.D, g.oz + z, g.GD) & kOutside);
    const bool with_p = z_in && a.p_in;
    const unsigned dp = ring_p + 4 * i_slot * plane;
    const unsigned dd = ring_d + 4 * i_slot * plane;
    const long long zo = z_in ? z * zstride : 0;
    const float* pz = (a.p_in ? a.p_in : a.d) + zo;
    const float* dz = a.d + zo;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      if (load_w[i] < 0) continue;
      const int o = max(load_g[i], 0);
      copy_async(dp + 4 * load_w[i], pz + o, with_p && load_g[i] >= 0);
      copy_async(dd + 4 * load_w[i], dz + o, z_in && load_g[i] >= 0);
    }
    copy_commit();
  };

  // The levels of step t update the cells of in-plane colour q = (h0 + 1 +
  // oz + zlo + t) & 1: level k's colour (h0 + k - 1) & 1 and plane zlo + 2
  // + t - k change together.  For each pair, the step's cells: the last
  // level that updates either (bits 0-7, 8-15), the offset of the
  // horizontal neighbour outside the pair (-1 or 2) and -1/a_ii of either
  // cell on a plane without and with a wall (domain extents are >= 2, so a
  // plane has one wall at most).
  int pair_last[NU], pair_edge[NU];
  float pair_ni[NU][2][2];
  auto colour = [&](int q) {
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      // the pair's cells are b = 2m + s and 2m + s + 2, s = (q + base +
      // r) & 1
      const int s = q ^ (upd_f[j] >> 8);
      const int walls = upd_f[j] >> (4 * s);
      pair_last[j] = (upd_last[j] >> (16 * s)) & 0xffff;
      pair_edge[j] = s ? 2 : -1;
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int zw = 0; zw < 2; ++zw)
          pair_ni[j][u][zw] = kNegInv[6 - ((walls >> (2 * u)) & 3) - zw];
    }
  };

  // level k (1-based) of the pass on plane z, in ring slot i: the window's
  // cells of in-plane colour q in rows and columns [k, rows - k) x [k,
  // cols - k)
  auto level = [&](int k, int z, int i_slot, int q) {
    const int zf = axis_flags(z, g.D, g.oz + z, g.GD);
    if (zf & kOutside) return;
    float* own = sp + i_slot * plane + q * half;
    const float* other = sp + i_slot * plane + (1 - q) * half;
    const float* zm = sp + wrap(i_slot - 1) * plane + q * half;
    const float* zp = sp + wrap(i_slot + 1) * plane + q * half;
    const float* dq = sd + i_slot * plane + q * half;
    const bool zw = zf & 3;
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      const int w = upd_w[j];
      const int l0 = pair_last[j] & 255, l1 = pair_last[j] >> 8;
      if (w < 0 || (k > l0 && k > l1)) continue;
      const float2 up = *reinterpret_cast<const float2*>(other + w - hp);
      const float2 dn = *reinterpret_cast<const float2*>(other + w + hp);
      const float2 mid = *reinterpret_cast<const float2*>(other + w);
      const float edge = other[w + pair_edge[j]];
      const float2 below = *reinterpret_cast<const float2*>(zm + w);
      const float2 above = *reinterpret_cast<const float2*>(zp + w);
      const float2 dv = *reinterpret_cast<const float2*>(dq + w);
      float2 pv = *reinterpret_cast<float2*>(own + w);
      // the in-plane neighbours left and right of either cell
      const bool right = pair_edge[j] > 0;
      const float lf0 = right ? mid.x : edge, rt0 = right ? mid.y : mid.x;
      const float lf1 = right ? mid.y : mid.x, rt1 = right ? edge : mid.y;
      const float nb0 =
          ((((below.x + above.x) + up.x) + dn.x) + lf0) + rt0;
      const float nb1 =
          ((((below.y + above.y) + up.y) + dn.y) + lf1) + rt1;
      const float ni0 = zw ? pair_ni[j][0][1] : pair_ni[j][0][0];
      const float ni1 = zw ? pair_ni[j][1][1] : pair_ni[j][1][0];
      const float p0 =
          a.one_m_w * pv.x + a.omega * (ni0 * (a.dx * dv.x - nb0));
      const float p1 =
          a.one_m_w * pv.y + a.omega * (ni1 * (a.dx * dv.y - nb1));
      // a cell this level leaves keeps its value
      if (k <= l0) pv.x = p0;
      if (k <= l1) pv.y = p1;
      *reinterpret_cast<float2*>(own + w) = pv;
    }
  };

  // plane z's tile, in ring slot i, into p_out
  auto store = [&](int z, int i_slot) {
    const float* pz = sp + i_slot * plane;
    float* out = a.p_out + z * zstride;
#pragma unroll
    for (int i = 0; i < NL; ++i)
      if (store_w[i] >= 0) out[store_g[i]] = pz[store_w[i]];
  };

  load(zlo, 0);
  load(zlo + 1, 1);
  copy_wait_all();
  __syncthreads();
  // step t: store the plane the last level finished in step t - 1, fetch
  // the plane level 1 reads first in step t + 1, run the levels; plane
  // zlo + 2 + t sits in ring slot i_top
  const int steps = z1 - 1 - zlo + S;
  for (int t = -1, i_top = 1; t < steps; ++t, i_top = wrap(i_top + 1)) {
    const int q = (a.h0 + 1 + g.oz + zlo + t) & 1;
    colour(q);
    const int z_done = zlo + 1 + t - S;
    if (z_done >= z0 && z_done < z1) store(z_done, wrap(i_top - 1 - S));
    if (zlo + t + 3 < zhi) load(zlo + t + 3, wrap(i_top + 1));
#pragma unroll
    for (int k = 1; k <= S; ++k) {
      const int z = zlo + 2 + t - k;
      // uniform over the block: every thread takes the same branches
      if (z < max(z0 - S + k, 0) || z >= min(z1 + S - k, g.D)) continue;
      level(k, z, wrap(i_top - k), q);
      if (k < S) __syncthreads();
    }
    copy_wait_all();
    __syncthreads();
  }
}

template <int S, int NL, int NU>
cudaError_t launch_pass(const Pass3& a, int threads_y, cudaStream_t s) {
  const int bytes = pass_bytes(a.TH, a.TW, S);
  cudaError_t err = cudaFuncSetAttribute(
      sor3d_pass_kernel<S, NL, NU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.g.W + a.TW - 1) / a.TW, (a.g.H + a.TH - 1) / a.TH,
                  (a.g.D + a.ZC - 1) / a.ZC);
  sor3d_pass_kernel<S, NL, NU><<<grid, dim3(32, threads_y), bytes, s>>>(a);
  return cudaGetLastError();
}

// The largest instance: window cells and pairs of half-plane words a thread
// may take.
constexpr int kMaxCells = 16, kMaxPairs = 4;

// A pass of depth S with a thread's nl window cells and nu pairs.
template <int S>
cudaError_t launch_depth(const Pass3& a, int threads_y, int nl, int nu,
                         cudaStream_t s) {
  if (nl <= 8 && nu <= 2) return launch_pass<S, 8, 2>(a, threads_y, s);
  if (nl <= kMaxCells && nu <= kMaxPairs)
    return launch_pass<S, kMaxCells, kMaxPairs>(a, threads_y, s);
  return cudaErrorInvalidValue;
}

// A thread's window cells (nl) and pairs of half-plane words (nu) on a
// pass of `depth` on a tile_h x tile_w tile, blocks of 32 x threads_y.
void thread_share(int tile_h, int tile_w, int depth, int threads_y, int* nl,
                  int* nu) {
  const int threads = 32 * threads_y;
  const int rows = tile_h + 2 * depth;
  *nl = (rows * (tile_w + 2 * depth) + threads - 1) / threads;
  *nu = (rows * half_pitch(tile_w, depth) / 2 + threads - 1) / threads;
}

// Whether an instance takes the pass and its shared memory fits a block of
// the current device.
bool pass_fits(int tile_h, int tile_w, int depth, int threads_y) {
  if (depth < 0 || depth > kMaxDepth || tile_h < 1 || tile_w < 1 ||
      threads_y < 1 || threads_y > 16)
    return false;
  int nl, nu, dev, limit;
  thread_share(tile_h, tile_w, depth, threads_y, &nl, &nu);
  if (nl > kMaxCells || nu > kMaxPairs) return false;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return false;
  return pass_bytes(tile_h, tile_w, depth) <= limit;
}

}  // namespace

// One pass of `depth` half-sweeps, the first of global index h0 (even
// parity first), on d and p_in ([D, H, W] float32; p_in nullptr: from
// zero), into p_out (not p_in).  The array's cell (0, 0, 0) sits at global
// (oz, oi, oj) of a GD x GH x GW domain (0 and the array's own extent
// without block mode).  Tiles of tile_h x tile_w cells and zchunk planes,
// blocks of 32 x threads_y threads.
extern "C" int fluid_sor3d_pass(const void* d, const void* p_in, void* p_out,
                                int D, int H, int W, int oz, int oi, int oj,
                                int GD, int GH, int GW, float dx, int h0,
                                int depth, float omega, float one_m_w,
                                int tile_h, int tile_w, int zchunk,
                                int threads_y, void* stream) {
  if (!pass_fits(tile_h, tile_w, depth, threads_y) || zchunk < 1 || D < 1 ||
      H < 1 || W < 1 || (long long)H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const Pass3 a{static_cast<const float*>(d),
                static_cast<const float*>(p_in),
                static_cast<float*>(p_out),
                Geom3{D, H, W, oz, oi, oj, GD, GH, GW},
                h0,
                tile_h,
                tile_w,
                zchunk,
                dx,
                omega,
                one_m_w};
  int nl, nu;
  thread_share(tile_h, tile_w, depth, threads_y, &nl, &nu);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (depth) {
    case 0: return (int)launch_depth<0>(a, threads_y, nl, nu, s);
    case 1: return (int)launch_depth<1>(a, threads_y, nl, nu, s);
    case 2: return (int)launch_depth<2>(a, threads_y, nl, nu, s);
    case 3: return (int)launch_depth<3>(a, threads_y, nl, nu, s);
    case 4: return (int)launch_depth<4>(a, threads_y, nl, nu, s);
    case 5: return (int)launch_depth<5>(a, threads_y, nl, nu, s);
    case 6: return (int)launch_depth<6>(a, threads_y, nl, nu, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The shared-memory bytes of a pass of `depth` on a tile_h x tile_w tile
// with blocks of 32 x threads_y threads, or 0 if fluid_sor3d_pass refuses
// it on the current device (too deep, too many cells or pairs a thread,
// more shared memory than a block may have).
extern "C" int fluid_sor3d_pass_bytes(int tile_h, int tile_w, int depth,
                                      int threads_y) {
  return pass_fits(tile_h, tile_w, depth, threads_y)
             ? pass_bytes(tile_h, tile_w, depth)
             : 0;
}
