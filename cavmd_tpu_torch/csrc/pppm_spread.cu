// PPPM charge spread (forward) and force interpolation (backward).
//
// Replace the TPU kernels of cavmd_tpu/ops/pppm_pallas.py:
//   - spread:      _spread_fwd_kernel / _spread_fwd_kernel_stacked (K2),
//   - interpolate: _spread_bwd_kernel / _spread_bwd_kernel_stacked (K3),
// which the JAX package joins as the custom_vjp spread_grid_pallas. Here
// the two are the forward and backward of one torch.autograd.Function
// (ops/pppm_kernels.py).
//
// Conventions (cavmd_tpu/ops/pppm.py:_spread_matrices), matched exactly:
//   u = (r / L + 1/2) K, base = floor(u), frac = u - base;
//   stencil column j = (base - j) mod K carries weight M_p(frac + j);
//   M_p by the Cox-de Boor recursion of pppm.py:bspline_weights, and
//   M_p' = M_{p-1}(x) - M_{p-1}(x - 1) from its penultimate level.
// The grid is row-major (Kx, Ky, Kz).
//
// K2, the spread. What bounds it on an H100: N p^3 read-modify-writes
// into a mesh that sits in L2 (N = 100,001, p = 6: 21.6 M adds into the
// 32^3 mesh's 32,768 words, ~660 a word), not bytes (the inputs and the
// mesh are ~1.7 MB, 0.5 us at 3.35 TB/s) and not arithmetic. Global
// atomics are served by L2 one word at a time, and a word's adds queue
// behind each other: the first version (one thread a particle, 216
// serial atomicAdds) took 0.144 ms at N = 100,001, and ran on 4 SMs at
// N = 501.
// Design: a warp takes up to 32 particles at a time. Each lane computes
// one particle's three order-p weight rows (Cox-de Boor in registers, one
// reciprocal a level instead of a divide an entry) and stages q w_x, w_y,
// w_z and the row offsets in the warp's shared memory; then the warp adds
// the staged particles one after another, the lanes over the stencil:
// lane l < min(p^2, 32) owns the pair (b, c) = (l / p, l % p), and adds
// q w_x[a] (w_y[b] w_z[c]) for every a, so one warp instruction covers
// ~32/p z-rows of p consecutive words; the pairs past 32 (p >= 6) go over
// the lanes as (a, pair), so a particle takes ceil(p^3 / 32) adds a lane
// (p = 6: 7). The adds go to one of two places:
//   - the tile path (the wrapper's pick from 64 particles an SM up on
//     meshes of up to 32 x 32 (x, y) rows): one block of 8 warps an SM,
//     each block a contiguous chunk of particles (N = 100,001: 768). Run
//     by run, the block numbers the x columns and y rows its charged
//     particles reach (a ballot scan) and, if 8 copies of those rows fit
//     its shared memory (~227 KB less the staging), each warp adds into
//     its own copy with plain loads and stores (a particle's p^3 words
//     are distinct, so all its loads go before its stores, and the warp
//     syncs between particles: no shared-memory atomics); then the block
//     sums the 8 copies in order and flushes the non-zero words with
//     coalesced global atomicAdds. The row stride is Kz padded to p mod 32
//     words, so a warp instruction's words fall in distinct banks. The
//     scenes place molecules on a lattice in row order, so at N = 100,001
//     each block's 768 particles reach few enough of the 1024 rows to fit
//     in one run, and each mesh word takes a few global adds instead of
//     ~660. A run whose rows do not fit is halved,
//     down to 32 particles; past that (particles far apart in index
//     order) the rest of the block's chunk adds to the global mesh.
//   - the global path, for small N and larger meshes: the same warp-wide
//     adds straight into the mesh with global atomicAdd. At small N a warp
//     takes fewer particles (down to 1), so N = 501 runs ~500 warps over
//     the card instead of 4 blocks.
// Particles with q = 0 (the photon) add nothing. Columns wrap at the box
// faces exactly as axis_stencil does. The wrapper zeroes the mesh and
// launches once. The flush and the global path add with float atomics in
// no fixed order, so the mesh's last bits change from call to call
// (relative ~1e-7 of its scale in f32): the spread is not deterministic.
// Tried and not taken (scripts/bench_torch_spread_tail.py times the two
// kept paths side by side; PERF.md has the numbers): the global path
// alone at large N (coalesced, but every add still goes to L2: no faster
// than the first version at 32^3); float4 vector atomics on the global
// path (L2 serves them about a word at a time too: barely faster); one
// shared tile a block with shared-memory atomics, 2 blocks an SM (float
// atomics on shared memory were as slow as the L2's); the tile path on
// 64^3 and 128^3 meshes (a run's rows at 70 or 134 words leave runs of
// ~100-200 particles, and zeroing and flushing the copies run by run
// cost more than the global path).
//
// K3, the interpolation, dE/dr_d = (K_d / L_d) q sum ct M'_p(d) M_p(others)
// over a particle's p^3 mesh-cotangent words. What bounds it on an H100:
// load and shared-memory instructions and the L1 lines they touch, not
// bytes (the 32^3 mesh is 128 KB and stays in L1 and L2; at N = 100,001,
// p = 6, 21.6 M words are read from it, ~36 mesh rows a particle). The
// first version, one thread a particle with the order a run-time argument,
// kept its nine stencil rows in a 288-byte local-memory stack, gathered its
// 216 words one after another, and ran N = 501 on 4 SMs: 0.029 ms at
// N = 501 and at N = 4001 alike, the chain of one thread. Design:
//   - interpolate_kernel<T, P>, one instantiation an order 2-8, so every
//     stencil row lives in registers (no stack frame);
//   - a warp takes up to 32 particles, fewer at small N as K2's global path
//     (warp_group: N = 501 runs ~500 warps in 4-warp blocks); lane k
//     evaluates particle k's three weight and three derivative rows
//     (axis_stencil) and stages them, as (w, w') pairs, with the row
//     offsets in the warp's shared memory, compacted over the charged
//     particles (K2 stages its rows the same way);
//   - the warp then walks the staged particles 32 / G at a time, G = 8
//     lanes a particle (4 up to p = 4): lane c owns z column c and loops
//     over the (a, b) rows, so one load instruction reads G consecutive z
//     words of 32 / G rows through the read-only path, and a lane sums its
//     words against (w_y, w_y') of b, then (w_x, w_x') of a, with w_z, w_z'
//     of c last: ~2 FMAs a word, one paired shared-memory load a row
//     weight. (A warp over one particle's (b, c) pairs, as K2 adds, took
//     0.041 ms at N = 100,001: it reads every weight and offset a word and
//     closes each particle with 15 shuffles);
//   - a butterfly of shuffles in a fixed order over the G lanes closes each
//     particle into its slot, and the lane that staged it stores its
//     dE/dr: one coalesced run a warp. No atomics: two calls give the same
//     bits. Particles with q = 0 are not staged and write exact zeros.
// Replica batches (parallel/replicas.py): both kernels take B replicas of
// one topology in one launch, blockIdx.y the replica. Positions, the mesh
// (B, Kx, Ky, Kz) and dE/dr are offset by the replica; the box is shared,
// and the charges are shared (q_stride 0) or each replica's own row
// (q_stride N: a batch over slabs, parallel/domain.py, where each
// replica's slab holds other atoms). The warp group is sized by B N, so a batch fills the card as
// one larger N would (N = 501, B = 8: 2 particles a warp). K2 takes its
// global path for any batch (N <= 4096 always does today); the tile path
// runs B = 1 only. K2's B = 1 launch is the unbatched one. K3's batched
// launch is its own instantiation (kBatch): with the replica's
// offsets in the one-replica kernel it ran 21% slower at N = 100,001 and
// 5.5% at N = 4001 (scripts/bench_torch_pair_interp.py, parent and change
// in one call, H100 80GB HBM3 at 700 W), past the 5% a shared kernel may
// cost; the one-replica instantiation compiles as before.
// The launches do not synchronise; each returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kMaxOrder = 8;
constexpr int kInterpThreads = 128;  // K3: 4 warps a block
constexpr int kInterpWarps = kInterpThreads / 32;
constexpr int kSpreadThreads = 256;  // K2: 8 warps a block
constexpr int kSpreadWarps = kSpreadThreads / 32;
constexpr int kTileMinPerSm = 64;    // K2: the tile path from N = 64 an SM
constexpr int kTileMaxRows = 32 * 32;  // and up to 32 x 32 (x, y) rows
constexpr int kPathAuto = 0, kPathGlobal = 1, kPathTile = 2;

__device__ __forceinline__ float m_floor(float x) { return floorf(x); }
__device__ __forceinline__ double m_floor(double x) { return floor(x); }

// The stencil base on one axis, base = floor(u) with u = (r / L + 1/2) K,
// and frac = u - base.
template <typename T>
__device__ __forceinline__ int axis_base(T r, T L, int K, T* frac) {
  const T u = (r / L + T(0.5)) * T(K);
  const T k0 = m_floor(u);
  *frac = u - k0;
  return (int)k0;
}

__device__ __forceinline__ int wrap_col(int c, int K) {
  c %= K;
  return c < 0 ? c + K : c;
}

// The z column of stencil entry c from the staged base column z0 (c < p
// <= K, so one wrap at most).
__device__ __forceinline__ int z_col(int z0, int c, int K) {
  const int z = z0 - c;
  return z < 0 ? z + K : z;
}

// Particles a warp takes at a time on K2's global path and in K3: enough
// that ~16 warps an SM run (up to 32), so N = 501 runs ~500 warps over the
// card and N = 100,001 32 particles a warp.
inline int warp_group(int n, int sms) {
  const int warps = 16 * sms;
  const int group = (n + warps - 1) / warps;
  return group < 1 ? 1 : (group > 32 ? 32 : group);
}

// Weights w[j] = M_p(frac + j) and derivatives dw[j] = M_p'(frac + j),
// j = 0..order-1, and the wrapped grid columns col[j] for one axis.
template <typename T>
__device__ __forceinline__ void axis_stencil(T r, T L, int K, int order,
                                             T* w, T* dw, int* col) {
  T frac;
  const int base = axis_base(r, L, K, &frac);
  T prev[kMaxOrder];
#pragma unroll
  for (int j = 0; j < kMaxOrder; ++j) {
    w[j] = (j == 0) ? T(1) : T(0);
    prev[j] = T(0);
  }
#pragma unroll
  for (int n = 2; n <= order; ++n) {
    if (n == order) {
#pragma unroll
      for (int j = 0; j < kMaxOrder; ++j) prev[j] = w[j];
    }
    // one reciprocal a level, not a divide an entry (a divide is a
    // subroutine of ~20 instructions); descending j keeps w[j - 1] at the
    // previous level while w[j] updates
    const T inv = T(1) / T(n - 1);
#pragma unroll
    for (int j = kMaxOrder - 1; j >= 0; --j) {
      if (j < order) {
        const T x = frac + T(j);
        const T shifted = (j > 0) ? w[j - 1] : T(0);
        w[j] = (x * w[j] + (T(n) - x) * shifted) * inv;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxOrder; ++j) {
    if (j < order) {
      dw[j] = prev[j] - ((j > 0) ? prev[j - 1] : T(0));
      col[j] = wrap_col(base - j, K);
    }
  }
}

// Shared memory of one K2 block, in this order: the tile (tile_cap
// values), each warp's staged particles (32 x 3p values: q w_x, w_y, w_z;
// 32 x (2p + 1) ints: the x and y row offsets and the z base), and, on
// the tile path, the x and y maps and their inverses (2 (Kx + Ky) ints).
template <typename T, int P>
constexpr size_t stage_bytes() {
  return (size_t)kSpreadWarps * 32 * (3 * P * sizeof(T) + (2 * P + 1) * sizeof(int));
}

// The warps of a K2 block spread particles [lo, hi) into dst, whose y rows
// are step_y and x planes step_x words apart: with kPrivate, the warp's
// own copy of the block's tile (the columns go through xmap / ymap; plain
// read-add-writes: the p^3 words of one particle are distinct, so no two
// lanes of one instruction meet, and the warp syncs between particles);
// else the mesh in device memory (atomicAdd). Lanes < group stage a
// particle each; the warp then adds the staged particles one after
// another, the lanes over the stencil (see the note above).
template <typename T, int P, bool kPrivate>
__device__ __forceinline__ void spread_warps(
    T* __restrict__ dst, int step_y, int step_x,
    const int* __restrict__ xmap, const int* __restrict__ ymap, T* sw,
    int* si, const T* __restrict__ pos, const T* __restrict__ charge, T Lx,
    T Ly, T Lz, int Kx, int Ky, int Kz, int lo, int hi, int group) {
  constexpr int P2 = P * P;
  constexpr int kFirst = P2 < 32 ? P2 : 32;  // (b, c) pairs, a lane each
  constexpr int kRest = P2 - kFirst;         // pairs past 32 (p >= 6)
  constexpr int kRestDiv = kRest > 0 ? kRest : 1;
  constexpr int kRestSteps = (kRest * P + 31) / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  T* w_warp = sw + warp * 32 * 3 * P;
  int* c_warp = si + warp * 32 * (2 * P + 1);
  const int b1 = lane / P, c1 = lane % P;  // this lane's pair, lane < kFirst
  for (int g0 = lo + warp * group; g0 < hi; g0 += kSpreadWarps * group) {
    const int i = g0 + lane;
    const T q = (lane < group && i < hi) ? charge[i] : T(0);
    const bool live = q != T(0);
    if (live) {  // stage this lane's particle
      T wx[kMaxOrder], wy[kMaxOrder], wz[kMaxOrder], d[kMaxOrder];
      int cx[kMaxOrder], cy[kMaxOrder], cz[kMaxOrder];
      axis_stencil<T>(pos[3 * i], Lx, Kx, P, wx, d, cx);
      axis_stencil<T>(pos[3 * i + 1], Ly, Ky, P, wy, d, cy);
      axis_stencil<T>(pos[3 * i + 2], Lz, Kz, P, wz, d, cz);
      T* w = w_warp + lane * 3 * P;
      int* c = c_warp + lane * (2 * P + 1);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        w[j] = q * wx[j];
        w[P + j] = wy[j];
        w[2 * P + j] = wz[j];
        c[j] = (kPrivate ? xmap[cx[j]] : cx[j]) * step_x;
        c[P + j] = (kPrivate ? ymap[cy[j]] : cy[j]) * step_y;
      }
      c[2 * P] = cz[0];
    }
    unsigned todo = __ballot_sync(0xffffffffu, live);
    __syncwarp();
    while (todo != 0u) {  // the staged particles, one after another
      const int s = __ffs(todo) - 1;
      todo &= todo - 1u;
      const T* w = w_warp + s * 3 * P;
      const int* c = c_warp + s * (2 * P + 1);
      const int z0 = c[2 * P];
      // every staged value and address first; this lane's words: the
      // pair's P (lane < kFirst), then its (a, pair) of the rest
      T val[P + kRestSteps];
      T* word[P + kRestSteps];
      bool on[P + kRestSteps];
      {
        const T yz = w[P + b1] * w[2 * P + c1];
        T* row = dst + c[P + b1] + z_col(z0, c1, Kz);
#pragma unroll
        for (int a = 0; a < P; ++a) {
          on[a] = lane < kFirst;
          val[a] = w[a] * yz;
          word[a] = row + c[a];
        }
      }
#pragma unroll
      for (int r = 0; r < kRestSteps; ++r) {
        const int f = r * 32 + lane;
        const int a = f / kRestDiv;
        const int pair = kFirst + f % kRestDiv;
        const int b = pair / P, k = pair % P;
        on[P + r] = f < kRest * P;
        const int a_ok = on[P + r] ? a : 0, b_ok = on[P + r] ? b : 0;
        val[P + r] = w[a_ok] * (w[P + b_ok] * w[2 * P + k]);
        word[P + r] = dst + c[a_ok] + c[P + b_ok] + z_col(z0, k, Kz);
      }
      if (kPrivate) {
        // the p^3 words of one particle are distinct: all loads, then all
        // stores, so the adds wait for one shared-memory round trip
        T old[P + kRestSteps];
#pragma unroll
        for (int j = 0; j < P + kRestSteps; ++j) old[j] = on[j] ? *word[j] : T(0);
#pragma unroll
        for (int j = 0; j < P + kRestSteps; ++j) {
          if (on[j]) *word[j] = old[j] + val[j];
        }
        __syncwarp();  // the next particle may meet these words
      } else {
#pragma unroll
        for (int j = 0; j < P + kRestSteps; ++j) {
          if (on[j]) atomicAdd(word[j], val[j]);
        }
      }
    }
    __syncwarp();
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kSpreadThreads, 2)
spread_kernel(const T* __restrict__ pos, const T* __restrict__ charge,
              const T* __restrict__ box, int n, int q_stride, int Kx, int Ky,
              int Kz, int group, int chunk, int tile_cap, int Sz,
              T* __restrict__ grid, int* __restrict__ tile_runs) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_nx, s_ny;
  T* tile = reinterpret_cast<T*>(smem);
  T* sw = tile + tile_cap;
  int* si = reinterpret_cast<int*>(sw + kSpreadWarps * 32 * 3 * P);
  int* xmap = si + kSpreadWarps * 32 * (2 * P + 1);
  int* ymap = xmap + Kx;
  int* xinv = ymap + Ky;
  int* yinv = xinv + Kx;

  // this block's replica: its positions, charges and mesh
  pos += 3 * (size_t)n * blockIdx.y;
  charge += (size_t)q_stride * blockIdx.y;
  grid += (size_t)Kx * Ky * Kz * blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lo = blockIdx.x * chunk;
  const int hi = min(n, lo + chunk);
  const T Lx = box[0], Ly = box[1], Lz = box[2];
  if (tile_cap == 0) {  // the global path
    spread_warps<T, P, false>(grid, Kz, Ky * Kz, xmap, ymap, sw, si, pos,
                              charge, Lx, Ly, Lz, Kx, Ky, Kz, lo, hi, group);
    return;
  }

  // the tile path, run by run: number the x columns and y rows a run's
  // charged particles reach; if the warps' copies of those rows fit the
  // tile, accumulate there and flush, else halve the run (down to one
  // warp's 32 particles; if those do not fit either, the rest of the
  // chunk adds to the global mesh)
  int span = chunk;
  for (int run_lo = lo; run_lo < hi;) {
    const int run_hi = min(hi, run_lo + span);
    for (int x = threadIdx.x; x < Kx; x += kSpreadThreads) xmap[x] = 0;
    for (int y = threadIdx.x; y < Ky; y += kSpreadThreads) ymap[y] = 0;
    __syncthreads();
    for (int i = run_lo + threadIdx.x; i < run_hi; i += kSpreadThreads) {
      if (charge[i] == T(0)) continue;
      T frac;
      const int bx = axis_base(pos[3 * i], Lx, Kx, &frac);
      const int by = axis_base(pos[3 * i + 1], Ly, Ky, &frac);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        xmap[wrap_col(bx - j, Kx)] = 1;
        ymap[wrap_col(by - j, Ky)] = 1;
      }
    }
    __syncthreads();
    if (warp < 2) {  // warp 0 numbers the x columns, warp 1 the y rows
      int* map = warp == 0 ? xmap : ymap;
      int* inv = warp == 0 ? xinv : yinv;
      const int K = warp == 0 ? Kx : Ky;
      int count = 0;
      for (int c0 = 0; c0 < K; c0 += 32) {
        const int c = c0 + lane;
        const bool hit = c < K && map[c] != 0;
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (hit) {
          const int k = count + __popc(m & ((1u << lane) - 1u));
          map[c] = k;
          inv[k] = c;
        }
        count += __popc(m);
      }
      if (lane == 0) {
        if (warp == 0) {
          s_nx = count;
        } else {
          s_ny = count;
        }
      }
    }
    __syncthreads();
    const int nx = s_nx, ny = s_ny;
    const int copy = nx * ny * Sz;  // words of one warp's copy
    const bool fits = (long long)kSpreadWarps * nx * ny * Sz <= (long long)tile_cap;
    if (!fits && span > 32) {
      span = (span / 2 + 31) / 32 * 32;
      continue;
    }
    if (!fits) {  // not even 32 particles fit: the rest of the chunk
      spread_warps<T, P, false>(grid, Kz, Ky * Kz, xmap, ymap, sw, si, pos,
                                charge, Lx, Ly, Lz, Kx, Ky, Kz, run_lo, hi,
                                32);
      return;
    }
    for (int t = threadIdx.x; t < kSpreadWarps * copy; t += kSpreadThreads) tile[t] = T(0);
    if (threadIdx.x == 0 && tile_runs != nullptr) atomicAdd(tile_runs, 1);
    __syncthreads();
    spread_warps<T, P, true>(tile + warp * copy, Sz, ny * Sz, xmap, ymap, sw,
                             si, pos, charge, Lx, Ly, Lz, Kx, Ky, Kz, run_lo,
                             run_hi, 32);
    __syncthreads();
    // flush: the copies summed in order, coalesced adds of non-zero words
    const int words = nx * ny * Kz;
    for (int t = threadIdx.x; t < words; t += kSpreadThreads) {
      const int r = t / Kz;
      const int z = t - r * Kz;
      T v = T(0);
#pragma unroll
      for (int k = 0; k < kSpreadWarps; ++k) v += tile[k * copy + r * Sz + z];
      if (v != T(0)) {
        const int lx = r / ny;
        const int ly = r - lx * ny;
        atomicAdd(grid + ((size_t)xinv[lx] * Ky + yinv[ly]) * Kz + z, v);
      }
    }
    __syncthreads();  // the next run renumbers the maps
    run_lo = run_hi;
  }
}

// K3's lanes a particle: lane c < p of a particle's group owns its z
// column c (4 lanes up to p = 4, else 8), so a warp instruction covers
// 32 / lanes particles.
template <int P>
__host__ __device__ constexpr int interp_lanes() {
  return P <= 4 ? 4 : 8;
}

// Values a K3 staging slot holds: (w, w') pairs of x, y and z, and the
// particle's three sums; even, so that every pair is 2-value aligned.
template <int P>
__host__ __device__ constexpr int interp_slot() {
  return 6 * P + 4;
}

// Shared memory of one K3 block: each warp's `group` slots of
// interp_slot<P>() values, then group x (2p + 1) ints (the x and y row
// offsets and the z base).
template <typename T, int P>
constexpr size_t interp_stage_bytes(int group) {
  return (size_t)kInterpWarps * group *
         (interp_slot<P>() * sizeof(T) + (2 * P + 1) * sizeof(int));
}

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

// A (w, w') pair from a staging slot in one shared-memory load.
template <typename T>
__device__ __forceinline__ typename Vec2<T>::type pair_at(const T* p) {
  return *reinterpret_cast<const typename Vec2<T>::type*>(p);
}

// K3: the warps of a block take `group` particles each. Lanes < group
// stage their charged particles' six stencil rows, compacted, in the
// warp's slots; then the warp walks the staged particles 32 / G at a time,
// G lanes a particle: lane c reads, for every (a, b), the word (a, b, c)
// of its particle (so a load instruction covers G consecutive z words of
// 32 / G rows), and sums it against (w_y, w_y') of b, then (w_x, w_x') of
// a, leaving w_z and w_z' of c for last. A butterfly of shuffles in a
// fixed order over the G lanes closes each particle into its slot, and
// the lane that staged it stores its dE/dr, one coalesced run a warp.
// The bound of 4 blocks an SM lets the compiler keep up to 128 registers
// (its own pick, 64 in float, ran slower at N = 100,001).
template <typename T, int P, bool kBatch>
__global__ void __launch_bounds__(kInterpThreads, 4)
interpolate_kernel(const T* __restrict__ ct, const T* __restrict__ pos,
                   const T* __restrict__ charge, const T* __restrict__ box,
                   int n, int q_stride, int Kx, int Ky, int Kz, int group,
                   T* __restrict__ dpos) {
  constexpr int G = interp_lanes<P>();
  constexpr int kPer = 32 / G;
  constexpr int S = interp_slot<P>();
  extern __shared__ __align__(16) unsigned char smem[];
  // this block's replica: its mesh cotangent, positions, charges and dE/dr
  const size_t rep = kBatch ? blockIdx.y : 0;
  ct += (size_t)Kx * Ky * Kz * rep;
  pos += 3 * (size_t)n * rep;
  charge += (size_t)q_stride * rep;
  dpos += 3 * (size_t)n * rep;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  T* w_warp = reinterpret_cast<T*>(smem) + warp * group * S;
  int* c_warp = reinterpret_cast<int*>(reinterpret_cast<T*>(smem) +
                                       kInterpWarps * group * S) +
                warp * group * (2 * P + 1);
  const T Lx = box[0], Ly = box[1], Lz = box[2];
  const int i = (blockIdx.x * kInterpWarps + warp) * group + lane;
  const bool mine = lane < group && i < n;
  const T q = mine ? charge[i] : T(0);
  const bool live = q != T(0);
  const unsigned live_mask = __ballot_sync(0xffffffffu, live);
  const int staged = __popc(live_mask);
  const int slot = __popc(live_mask & ((1u << lane) - 1u));
  if (live) {  // stage this lane's particle in the next free slot
    T wx[kMaxOrder], wy[kMaxOrder], wz[kMaxOrder];
    T dx[kMaxOrder], dy[kMaxOrder], dz[kMaxOrder];
    int cx[kMaxOrder], cy[kMaxOrder], cz[kMaxOrder];
    axis_stencil<T>(pos[3 * i], Lx, Kx, P, wx, dx, cx);
    axis_stencil<T>(pos[3 * i + 1], Ly, Ky, P, wy, dy, cy);
    axis_stencil<T>(pos[3 * i + 2], Lz, Kz, P, wz, dz, cz);
    T* w = w_warp + slot * S;
    int* c = c_warp + slot * (2 * P + 1);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      w[2 * j] = wx[j];
      w[2 * j + 1] = dx[j];
      w[2 * P + 2 * j] = wy[j];
      w[2 * P + 2 * j + 1] = dy[j];
      w[4 * P + 2 * j] = wz[j];
      w[4 * P + 2 * j + 1] = dz[j];
      c[j] = cx[j] * Ky * Kz;
      c[P + j] = cy[j] * Kz;
    }
    c[2 * P] = cz[0];
  }
  __syncwarp();
  const int k = lane / G;                // this lane's particle of the kPer
  const int zc = lane % G < P ? lane % G : 0;  // and its z column
  for (int s0 = 0; s0 < staged; s0 += kPer) {  // warp-uniform
    const int s = s0 + k < staged ? s0 + k : s0;  // a staged slot to read
    const bool on = s0 + k < staged && lane % G < P;
    T* w = w_warp + s * S;
    const int* c = c_warp + s * (2 * P + 1);
    // word offsets of this lane's (b, c) from the mesh's start: one 32-bit
    // add and one wide multiply-add an address, not 64-bit pointer sums
    const int zw = z_col(c[2 * P], zc, Kz);
    int yoff[P];
    typename Vec2<T>::type wy[P];
#pragma unroll
    for (int b = 0; b < P; ++b) {
      yoff[b] = zw + c[P + b];
      wy[b] = pair_at(w + 2 * P + 2 * b);
    }
    // X = sum_a w_x'(a) A(a), Y = sum_a w_x(a) B(a), Z = sum_a w_x(a) A(a),
    // with A(a) = sum_b w_y(b) g(a, b) and B(a) = sum_b w_y'(b) g(a, b)
    T X = 0, Y = 0, Z = 0;
#pragma unroll
    for (int a = 0; a < P; ++a) {
      const int xoff = c[a];
      T g[P];
#pragma unroll
      for (int b = 0; b < P; ++b) g[b] = on ? __ldg(ct + (xoff + yoff[b])) : T(0);
      T A = 0, B = 0;
#pragma unroll
      for (int b = 0; b < P; ++b) {
        A += g[b] * wy[b].x;
        B += g[b] * wy[b].y;
      }
      const typename Vec2<T>::type wxa = pair_at(w + 2 * a);
      X += wxa.y * A;
      Y += wxa.x * B;
      Z += wxa.x * A;
    }
    const typename Vec2<T>::type wzc = pair_at(w + 4 * P + 2 * zc);
    T gx = X * wzc.x, gy = Y * wzc.x, gz = Z * wzc.y;
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      gx += __shfl_xor_sync(0xffffffffu, gx, off);
      gy += __shfl_xor_sync(0xffffffffu, gy, off);
      gz += __shfl_xor_sync(0xffffffffu, gz, off);
    }
    if (lane % G == 0 && s0 + k < staged) {
      w[6 * P] = gx;
      w[6 * P + 1] = gy;
      w[6 * P + 2] = gz;
    }
  }
  __syncwarp();
  if (mine) {  // q = 0 leaves exact zeros
    T mx = 0, my = 0, mz = 0;
    if (live) {
      const T* r = w_warp + slot * S + 6 * P;
      mx = r[0];
      my = r[1];
      mz = r[2];
    }
    dpos[3 * i] = q * mx * (T(Kx) / Lx);
    dpos[3 * i + 1] = q * my * (T(Ky) / Ly);
    dpos[3 * i + 2] = q * mz * (T(Kz) / Lz);
  }
}

inline bool bad_args(int n, int nb, int q_stride, int order, int Kx, int Ky,
                     int Kz) {
  return n < 1 || nb < 1 || nb > 65535 || (q_stride != 0 && q_stride != n) ||
         order < 2 || order > kMaxOrder || Kx < order || Ky < order ||
         Kz < order;
}

// The card's SM count and shared memory an SM and a block may use, read
// once (one device).
struct CardLimits {
  int sms = 0, smem_sm = 0, smem_block = 0;
};

inline int card_limits(CardLimits* out) {
  static CardLimits cached;
  if (cached.sms == 0) {
    CardLimits c;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &c.smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &c.smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    cached = c;
  }
  *out = cached;
  return 0;
}

// K2's launch for order P over nb replicas. path: kPathAuto (for one
// replica the tile path from kTileMinPerSm particles an SM up on meshes of
// up to kTileMaxRows (x, y) rows, else the global path), kPathGlobal or
// kPathTile (one replica only; tests and benchmarks hold each path).
template <typename T, int P>
int launch_spread_p(const T* pos, const T* charge, const T* box, int n,
                    int nb, int q_stride, int Kx, int Ky, int Kz, int path,
                    T* grid, int* tile_runs, cudaStream_t stream) {
  if (nb > 1 && path == kPathTile) return (int)cudaErrorInvalidValue;
  CardLimits card;
  const int err = card_limits(&card);
  if (err != 0) return err;
  // row stride of the tile: Kz padded to P mod 32 words
  const int Sz = Kz + ((P - Kz % 32) % 32 + 32) % 32;
  const size_t stage = stage_bytes<T, P>();
  const size_t maps = 2 * (size_t)(Kx + Ky) * sizeof(int);
  // the tile path: one block an SM; its shared memory, less the block's
  // 1 KB reserve, the kernel's static words, the staging and the maps,
  // holds kSpreadWarps copies
  static size_t static_smem = (size_t)-1;  // per instantiation
  if (static_smem == (size_t)-1) {
    cudaFuncAttributes attr;
    const cudaError_t a = cudaFuncGetAttributes(&attr, spread_kernel<T, P>);
    if (a != cudaSuccess) return (int)a;
    static_smem = attr.sharedSizeBytes;
  }
  size_t per_block = card.smem_sm > 1024 ? (size_t)card.smem_sm - 1024 : 0;
  if (per_block > (size_t)card.smem_block) per_block = card.smem_block;
  per_block = per_block > static_smem ? per_block - static_smem : 0;
  long long tile_cap = 0;
  if (per_block > stage + maps) {
    tile_cap = (long long)((per_block - stage - maps) / sizeof(T));
    const long long all = (long long)kSpreadWarps * Kx * Ky * Sz;
    if (tile_cap > all) tile_cap = all;
  }
  bool tiled = path == kPathTile ||
               (path == kPathAuto && nb == 1 &&
                (long long)n >= (long long)kTileMinPerSm * card.sms &&
                Kx * Ky <= kTileMaxRows);
  if (tile_cap < (long long)kSpreadWarps * Sz) {  // not one row fits
    if (path == kPathTile) return (int)cudaErrorInvalidValue;
    tiled = false;
  }
  int group, chunk, cap;
  size_t smem;
  if (tiled) {  // one wave of contiguous chunks, one block an SM
    group = 32;
    chunk = ((n + card.sms - 1) / card.sms + 31) / 32 * 32;
    cap = (int)tile_cap;
    smem = (size_t)tile_cap * sizeof(T) + stage + maps;
  } else {  // ~16 warps an SM over the batch, up to 32 particles a warp
    group = warp_group(nb * n, card.sms);
    chunk = group * kSpreadWarps;
    cap = 0;
    smem = stage;
  }
  static size_t opted_in = 48 * 1024;  // per instantiation
  if (smem > opted_in) {
    const cudaError_t attr = cudaFuncSetAttribute(
        spread_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (attr != cudaSuccess) return (int)attr;
    opted_in = smem;
  }
  const int blocks = (n + chunk - 1) / chunk;
  spread_kernel<T, P><<<dim3(blocks, nb), kSpreadThreads, smem, stream>>>(
      pos, charge, box, n, q_stride, Kx, Ky, Kz, group, chunk, cap, Sz,
      grid, tile_runs);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_spread(const void* pos, const void* charge, const void* box, int n,
                  int nb, int q_stride, int order, int Kx, int Ky, int Kz,
                  int path, void* grid, void* tile_runs, void* stream) {
  if (bad_args(n, nb, q_stride, order, Kx, Ky, Kz) || path < kPathAuto ||
      path > kPathTile)
    return (int)cudaErrorInvalidValue;
  const T* p = (const T*)pos;
  const T* q = (const T*)charge;
  const T* b = (const T*)box;
  T* g = (T*)grid;
  int* t = (int*)tile_runs;
  cudaStream_t s = (cudaStream_t)stream;
  switch (order) {
    case 2: return launch_spread_p<T, 2>(p, q, b, n, nb, q_stride, Kx, Ky, Kz, path, g, t, s);
    case 3: return launch_spread_p<T, 3>(p, q, b, n, nb, q_stride, Kx, Ky, Kz, path, g, t, s);
    case 4: return launch_spread_p<T, 4>(p, q, b, n, nb, q_stride, Kx, Ky, Kz, path, g, t, s);
    case 5: return launch_spread_p<T, 5>(p, q, b, n, nb, q_stride, Kx, Ky, Kz, path, g, t, s);
    case 6: return launch_spread_p<T, 6>(p, q, b, n, nb, q_stride, Kx, Ky, Kz, path, g, t, s);
    case 7: return launch_spread_p<T, 7>(p, q, b, n, nb, q_stride, Kx, Ky, Kz, path, g, t, s);
    default: return launch_spread_p<T, 8>(p, q, b, n, nb, q_stride, Kx, Ky, Kz, path, g, t, s);
  }
}

// One K3 instantiation's launch: `blocks` blocks a replica of nb.
template <typename T, int P, bool kBatch>
int launch_interpolate_k(const T* ct, const T* pos, const T* charge,
                         const T* box, int n, int nb, int q_stride, int Kx,
                         int Ky, int Kz, int group, int blocks, size_t smem,
                         T* dpos, cudaStream_t stream) {
  static size_t opted_in = 48 * 1024;  // per instantiation
  if (smem > opted_in) {
    const cudaError_t attr = cudaFuncSetAttribute(
        interpolate_kernel<T, P, kBatch>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return (int)attr;
    opted_in = smem;
  }
  interpolate_kernel<T, P, kBatch><<<dim3(blocks, nb), kInterpThreads, smem,
                                     stream>>>(ct, pos, charge, box, n,
                                               q_stride, Kx, Ky, Kz, group,
                                               dpos);
  return (int)cudaGetLastError();
}

// K3's launch for order P over nb replicas: warp_group particles a warp
// (sized by nb n), kInterpWarps warps a block.
template <typename T, int P>
int launch_interpolate_p(const T* ct, const T* pos, const T* charge,
                         const T* box, int n, int nb, int q_stride, int Kx,
                         int Ky, int Kz, T* dpos, cudaStream_t stream) {
  CardLimits card;
  const int err = card_limits(&card);
  if (err != 0) return err;
  const int group = warp_group(nb * n, card.sms);
  const size_t smem = interp_stage_bytes<T, P>(group);
  const int per_block = group * kInterpWarps;
  const int blocks = (n + per_block - 1) / per_block;
  return nb > 1 ? launch_interpolate_k<T, P, true>(ct, pos, charge, box, n, nb,
                                                   q_stride, Kx, Ky, Kz, group,
                                                   blocks, smem, dpos, stream)
                : launch_interpolate_k<T, P, false>(ct, pos, charge, box, n, nb,
                                                    q_stride, Kx, Ky, Kz, group,
                                                    blocks, smem, dpos, stream);
}

template <typename T>
int launch_interpolate(const void* ct, const void* pos, const void* charge,
                       const void* box, int n, int nb, int q_stride, int order,
                       int Kx, int Ky, int Kz, void* dpos, void* stream) {
  if (bad_args(n, nb, q_stride, order, Kx, Ky, Kz))
    return (int)cudaErrorInvalidValue;
  const T* g = (const T*)ct;
  const T* p = (const T*)pos;
  const T* q = (const T*)charge;
  const T* b = (const T*)box;
  T* d = (T*)dpos;
  cudaStream_t s = (cudaStream_t)stream;
  switch (order) {
    case 2: return launch_interpolate_p<T, 2>(g, p, q, b, n, nb, q_stride, Kx, Ky, Kz, d, s);
    case 3: return launch_interpolate_p<T, 3>(g, p, q, b, n, nb, q_stride, Kx, Ky, Kz, d, s);
    case 4: return launch_interpolate_p<T, 4>(g, p, q, b, n, nb, q_stride, Kx, Ky, Kz, d, s);
    case 5: return launch_interpolate_p<T, 5>(g, p, q, b, n, nb, q_stride, Kx, Ky, Kz, d, s);
    case 6: return launch_interpolate_p<T, 6>(g, p, q, b, n, nb, q_stride, Kx, Ky, Kz, d, s);
    case 7: return launch_interpolate_p<T, 7>(g, p, q, b, n, nb, q_stride, Kx, Ky, Kz, d, s);
    default: return launch_interpolate_p<T, 8>(g, p, q, b, n, nb, q_stride, Kx, Ky, Kz, d, s);
  }
}

}  // namespace

extern "C" {

// nb: replicas in the batch (1 unbatched); pos (nb, n, 3), grid and ct
// (nb, Kx, Ky, Kz), dpos (nb, n, 3); box shared. q_stride: 0 when one (n,)
// charge row is shared, n for (nb, n) charges, a row a replica.
// path: 0 = by shape, 1 = the global path, 2 = the tile path (nb = 1).
// tile_runs: NULL, or an int to which each run of particles a block
// accumulated in its shared-memory tile adds 1.
int cavmd_pppm_spread_f32(const void* pos, const void* charge, const void* box,
                          int n, int nb, int q_stride, int order, int Kx,
                          int Ky, int Kz, int path, void* grid,
                          void* tile_runs, void* stream) {
  return launch_spread<float>(pos, charge, box, n, nb, q_stride, order, Kx, Ky,
                          Kz, path, grid, tile_runs, stream);
}

int cavmd_pppm_spread_f64(const void* pos, const void* charge, const void* box,
                          int n, int nb, int q_stride, int order, int Kx,
                          int Ky, int Kz, int path, void* grid,
                          void* tile_runs, void* stream) {
  return launch_spread<double>(pos, charge, box, n, nb, q_stride, order, Kx, Ky,
                          Kz, path, grid, tile_runs, stream);
}

int cavmd_pppm_interpolate_f32(const void* ct, const void* pos,
                               const void* charge, const void* box, int n,
                               int nb, int q_stride, int order, int Kx, int Ky,
                               int Kz, void* dpos, void* stream) {
  return launch_interpolate<float>(ct, pos, charge, box, n, nb, q_stride, order,
                               Kx, Ky, Kz, dpos, stream);
}

int cavmd_pppm_interpolate_f64(const void* ct, const void* pos,
                               const void* charge, const void* box, int n,
                               int nb, int q_stride, int order, int Kx, int Ky,
                               int Kz, void* dpos, void* stream) {
  return launch_interpolate<double>(ct, pos, charge, box, n, nb, q_stride, order,
                               Kx, Ky, Kz, dpos, stream);
}

}  // extern "C"
