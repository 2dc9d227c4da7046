// Cell-list shifted-LJ + short-range Ewald (erfc) pair pass for large N.
//
// Replaces two TPU kernels of cavmd_tpu/ops/pallas_kernels.py: the column
// pass _cell_cols_kernel / _cell_cols_kernel_jsplit (wrapper
// fused_cell_cols_pallas, >= 3 cells per axis) and the gathered-tile pass
// _cell_kernel (wrapper fused_cell_pallas, the fallback when an axis has
// fewer than 3 cells). It computes what the XLA tile path
// cavmd_tpu/ops/neighbor.py:cell_pair_force with make_fused_cell_kernel
// computes, not the Pallas bodies:
//   - for every occupied slot i of cell c and every occupied slot j of the
//     (deduplicated) 27 neighbour cells of c, the pair counts when j != i,
//     j is not in i's exclusion row and r^2 < r_cut^2 (the cell cutoff);
//   - LJ from (T, T) tables (eps, sigma^2, r_cut^2, v_shift) as in the dense
//     kernel, when eps != 0 and r^2 < r_cut^2 of the type pair; Ewald short
//     with true erfc when q_i q_j != 0; minimum image with rint (round half
//     to even, like jnp.round) on every pair, so one kernel serves both
//     grid kinds: with < 3 cells per axis only the neighbour table differs
//     (repeats replaced by the sentinel cell id C, which is empty).
//
// What bounds it on an H100: instructions, not bytes. At N = 100,001
// (17^3 cells, mean occupancy 20.4) the pass tests ~56 M candidate pairs,
// of which ~6.6 M (12%) lie inside the cutoff, against ~6 MB of input.
// Each pair inside the cutoff costs ~150 instructions (IEEE divides and
// sqrt, erfc, exp); each candidate its displacement, r^2 and the cutoff
// test (~17 FP32 operations) and its share of the warp's compaction. A
// warp that evaluates the pair term under the cutoff test pays it on
// nearly every 32-lane step (1 - 0.88^32 = 98% of them hold a pair). With
// the pair term moved behind a queue, the candidate loop is the cost:
// with the pair term switched off the pass keeps 3/4 of its time on an
// H100 (scripts/bench_cell_kernel_parts.py); more warps per SM and
// deeper unrolling moved it by a few percent (PERF.md). Design:
//   - one block of 256 threads per cell (times a row split on small grids,
//     below); the block stages its 27 neighbour cells' occupied slots,
//     compacted, in shared memory (x, y, z, q, id, type as
//     structure-of-arrays). Occupancies: each warp reads the first 32 slots
//     of its cells' bucket rows together and finds the first empty slot
//     with a ballot (buckets fill from slot 0); offsets: a shuffle scan;
//     staging: every thread takes 4 staged rows at a time, finds each
//     row's cell by bisecting the offsets, and has their loads in flight
//     together. Only occupied slots are staged: a sentinel's far position
//     could wrap onto a real coordinate;
//   - dynamic shared memory sized 27 * cap rows (29 KB at cap 45 in f32,
//     49 KB in f64), raised past 48 KB with cudaFuncSetAttribute, so the
//     overflow retry's larger caps still launch (a cap past the 227 KB a
//     block may use returns the attribute's error);
//   - warps take the cell's i rows, one at a time, reading row i from the
//     staged copy of c. Cutoff first: lanes stride over the staged j rows
//     computing only the displacement, r^2 and the cutoff test, four steps
//     of 32 at a time with no branch between them, and push the j rows that
//     pass into a per-warp ring of 256 in shared memory (__ballot_sync,
//     __popc, the lane's rank from the lanes below it). Whenever the ring
//     holds 32, every lane takes one and runs the self test, the exclusion
//     test and the pair term, adding to its own force accumulator; the
//     partial ring is flushed at the end of the row. So the pair term runs
//     on full warps, ~3 times a row at N = 100,001, instead of on ~18
//     mostly idle steps;
//   - the minimum image without a divide or a rint: k = d * (1/L) rounded
//     by adding and subtracting 1.5 * 2^23 (1.5 * 2^52 in f64), then
//     d - L k in one fma. For a pair inside the cutoff |d/L - k| < r_cut/L
//     < 1/2, so a quotient 1-2 ulp off cannot cross a half-integer, the
//     rounding gives the twin's k (round half to even, as rint), and L k is
//     exact for |k| <= 2: every counted pair gets the twin's dx, and r^2 is
//     formed with the _rn intrinsics in the twin's order, so the cutoff
//     decides as the twin does. (This needs L > 2 r_cut per axis, which the
//     minimum image needs anyway.) Per-row image shifts are not taken: in
//     float32 they round pairs across a face differently from the twin;
//   - a warp-shuffle sum closes each row: every particle owns one slot, so
//     its force is written once, with no atomics and no slot gather;
//   - per-block (e_lj, e_ew) partials, summed in a fixed order by the
//     wrapper and halved, as in the dense kernel. Every sum has a fixed
//     order, so two calls on the same inputs give the same bits;
//   - small grids: with fewer cells than ~2 blocks per SM (K8's grid: 8
//     cells at N = 501) the wrapper splits each cell's i rows over `split`
//     blocks (blockIdx.y), each staging the same window; the energy
//     partials are then per (cell, row chunk).
// Not taken: a half shell (Newton's third law) halves the pair terms but
// needs atomics on the j forces, which makes float32 sums order-dependent
// from run to run; a Verlet pair list would change CellList and its
// rebuild. The launch allocates nothing and does not synchronise; it
// returns cudaGetLastError(). The caller zeroes the forces: a particle
// that an overflow left without a slot keeps zero, as slot_gather_forces
// gives it.
//
// The same kernel is the tile pass of the slab domain pipeline, replacing
// fused_cell_cols_slab_pallas (pallas_kernels.py:1044): the grid is a
// slab's extended local grid (cxl + 2, cy, cz), whose x-layers 0 and
// cxl + 1 hold halo copies of the neighbour slabs' edge layers, the ids
// index the (Mtot, 3) table of residents and halo copies, and positions
// are raw (the per-pair minimum image takes the periodic images). Two
// arguments serve it:
//   - cell_begin, cell_count: blocks run for cells [cell_begin,
//     cell_begin + cell_count) only, the own cells; halo cells have
//     sentinel neighbour rows and no pairs, so they launch no block. The
//     energy partials are per launched block;
//   - key (nullable): the id that the self and exclusion tests compare,
//     key[id] instead of id. At one slab the halo layers are copies of the
//     slab's own edge layers, and a bonded partner met through its copy
//     must still be excluded; key maps the copy to its resident id.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_term.cuh"

namespace {

using namespace cavmd;

constexpr int kThreads = 256;  // ops/cell_kernels.py:WARPS_PER_BLOCK * 32
constexpr int kWarps = kThreads / 32;
constexpr int kNeighbors = 27;
constexpr int kUnroll = 4;    // candidate steps of 32 between queue checks
constexpr int kRing = 64 * kUnroll;  // per-warp queue of in-cutoff j rows
constexpr int kStage = 4;     // rows a thread stages at a time
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
// 1.5 * 2^(mantissa bits): t + M - M rounds t to the nearest integer, ties
// to even, for |t| < 2^22 (f32) / 2^51 (f64), as rint does
__device__ __forceinline__ float round_magic(float) { return 12582912.0f; }
__device__ __forceinline__ double round_magic(double) { return 6755399441055744.0; }

// One minimum-image component of d = x_i - x_j: d - L k with k the nearest
// integer to d / L. k comes from d * (1/L) rounded by the magic constant
// (two adds at the full FP32 rate, where rint is a conversion at 1/8 of
// it), L k is taken in the fma exactly (|k| <= 2), so for every pair inside
// the cutoff the result equals the twin's d - L rint(d / L) bit for bit (see
// the note at the top).
template <typename T>
__device__ __forceinline__ T min_image(T d, T L, T inv_L) {
  const T M = round_magic(T(0));
  const T k = sub_rn(fma_rn(d, inv_L, M), M);
  return fma_rn(-L, k, d);
}

// r^2 as the twin forms it: (dx^2 + dy^2) + dz^2, each step rounded.
template <typename T>
__device__ __forceinline__ T norm2(T dx, T dy, T dz) {
  return add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
}

// Bytes of dynamic shared memory for one block: 27 * cap staged rows. A
// count past what a block may use beside the static arrays (227 KB in all)
// makes cudaFuncSetAttribute fail, and the launch returns its error.
template <typename T>
size_t smem_bytes(int cap) {
  return (size_t)kNeighbors * cap * (4 * sizeof(T) + 2 * sizeof(int32_t));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cell_pair_kernel(const T* __restrict__ pos, const T* __restrict__ box,
                 const int32_t* __restrict__ type_id, const T* __restrict__ charge,
                 const T* __restrict__ eps_t, const T* __restrict__ sig2_t,
                 const T* __restrict__ rcut2_t, const T* __restrict__ vshift_t,
                 int ntypes, const int32_t* __restrict__ bucket,
                 const int32_t* __restrict__ nbr, const int32_t* __restrict__ excl,
                 int max_excl, int n, int ncells, int cap, T rc2, T kappa,
                 int lj_on, int coul_on, int cell_begin,
                 const int32_t* __restrict__ key, T* __restrict__ forces,
                 T* __restrict__ e_partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = kNeighbors * cap;
  T* sx = reinterpret_cast<T*>(smem_raw);
  T* sy = sx + rows;
  T* sz = sy + rows;
  T* sq = sz + rows;
  int32_t* sid = reinterpret_cast<int32_t*>(sq + rows);
  int32_t* stype = sid + rows;

  __shared__ T s_eps[kMaxTypes * kMaxTypes];
  __shared__ T s_sig2[kMaxTypes * kMaxTypes];
  __shared__ T s_rc2[kMaxTypes * kMaxTypes];
  __shared__ T s_vsh[kMaxTypes * kMaxTypes];
  __shared__ int s_cell[kNeighbors];
  __shared__ int s_occ[kNeighbors];
  __shared__ int s_off[kNeighbors + 1];  // [27]: rows staged in all
  __shared__ int s_self;                 // c's place in its neighbour row
  __shared__ uint16_t s_ring[kWarps][kRing];  // staged rows < 27 cap < 2^16
  __shared__ T s_red[kWarps][2];

  const int c = cell_begin + blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x; t < ntypes * ntypes; t += blockDim.x) {
    s_eps[t] = eps_t[t];
    s_sig2[t] = sig2_t[t];
    s_rc2[t] = rcut2_t[t];
    s_vsh[t] = vshift_t[t];
  }
  if (threadIdx.x < kNeighbors)
    s_cell[threadIdx.x] = nbr[(size_t)c * kNeighbors + threadIdx.x];
  __syncthreads();

  // occupancy of each neighbour cell: a warp reads a bucket row coalesced,
  // and buckets fill from slot 0, so the first empty slot ends the row. The
  // warp's cells' first 32 slots are read together; a row full in its first
  // 32 slots reads on.
  {
    constexpr int kPerWarp = (kNeighbors + kWarps - 1) / kWarps;
    int first[kPerWarp];
#pragma unroll
    for (int q = 0; q < kPerWarp; ++q) {
      const int k = warp + q * kWarps;
      const int cell = k < kNeighbors ? s_cell[k] : ncells;
      first[q] = cell < ncells && lane < cap ? bucket[(size_t)cell * cap + lane] : n;
    }
#pragma unroll
    for (int q = 0; q < kPerWarp; ++q) {
      const int k = warp + q * kWarps;
      if (k >= kNeighbors) break;  // warp-uniform
      unsigned real = __ballot_sync(kFull, first[q] < n);
      int occ = real == kFull ? 32 : __ffs(~real) - 1;
      if (real == kFull && occ < cap) {
        const int32_t* b = bucket + (size_t)s_cell[k] * cap;
        for (int r0 = 32; r0 < cap; r0 += 32) {
          const int r = r0 + lane;
          real = __ballot_sync(kFull, r < cap && b[r] < n);
          occ = r0 + (real == kFull ? 32 : __ffs(~real) - 1);
          if (real != kFull) break;
        }
      }
      if (lane == 0) s_occ[k] = occ < cap ? occ : cap;
    }
  }
  __syncthreads();
  // staging offsets: an exclusive scan of the 27 occupancies; and where c
  // sits in its own neighbour row (its first occurrence)
  if (warp == 0) {
    const int v = lane < kNeighbors ? s_occ[lane] : 0;
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += u;
    }
    if (lane < kNeighbors) s_off[lane] = incl - v;
    if (lane == kNeighbors - 1) s_off[kNeighbors] = incl;
    const unsigned self = __ballot_sync(kFull, lane < kNeighbors && s_cell[lane] == c);
    if (lane == 0) s_self = self ? __ffs(self) - 1 : -1;
  }
  __syncthreads();

  // stage the occupied neighbour slots, compacted, all threads over all
  // rows, kStage rows a thread at a time so that their loads are in flight
  // together: a staged row's cell is the last one whose offset is <= the row
  const int m = s_off[kNeighbors];
  for (int d0 = 0; d0 < m; d0 += kStage * kThreads) {
    int id[kStage];
#pragma unroll
    for (int q = 0; q < kStage; ++q) {
      const int d = d0 + q * kThreads + threadIdx.x;
      id[q] = -1;
      if (d < m) {
        int lo = 0;
#pragma unroll
        for (int half = 16; half > 0; half >>= 1)
          if (lo + half < kNeighbors && s_off[lo + half] <= d) lo += half;
        id[q] = bucket[(size_t)s_cell[lo] * cap + (d - s_off[lo])];
      }
    }
#pragma unroll
    for (int q = 0; q < kStage; ++q) {
      const int d = d0 + q * kThreads + threadIdx.x;
      if (id[q] >= 0) {
        sx[d] = pos[3 * (size_t)id[q]];
        sy[d] = pos[3 * (size_t)id[q] + 1];
        sz[d] = pos[3 * (size_t)id[q] + 2];
        sq[d] = charge[id[q]];
        sid[d] = key ? key[id[q]] : id[q];
        stype[d] = type_id[id[q]];
      }
    }
  }
  __syncthreads();

  const int self = s_self;
  const int occ_self = self >= 0 ? s_occ[self] : 0;
  const T Lx = box[0], Ly = box[1], Lz = box[2];
  const T iLx = T(1) / Lx, iLy = T(1) / Ly, iLz = T(1) / Lz;
  const unsigned below = (1u << lane) - 1u;
  uint16_t* ring = s_ring[warp];
  T e_lj = 0, e_ew = 0;

  for (int i = blockIdx.y * kWarps + warp; i < occ_self;
       i += gridDim.y * kWarps) {  // warp-uniform
    // row i of c: its staged copy, and its particle id for the exclusion
    // row and the force
    const int ri = s_off[self] + i;
    const int idi = bucket[(size_t)c * cap + i];
    const int kid = sid[ri];
    const T xi = sx[ri], yi = sy[ri], zi = sz[ri], qi = sq[ri];
    const int ti = stype[ri] * ntypes;
    int ex[kMaxExcl];
#pragma unroll
    for (int e = 0; e < kMaxExcl; ++e)
      ex[e] = e < max_excl ? excl[(size_t)idi * max_excl + e] : -1;
    T fx = 0, fy = 0, fz = 0;

    // cutoff first: push the staged rows inside the cutoff into the ring;
    // take 32 whenever it holds 32, and the rest at the row's end
    int head = 0, queued = 0;  // warp-uniform ring state
    for (int j0 = 0; j0 < m || queued > 0;) {
      if (j0 < m && queued < kRing - 32 * kUnroll) {
        // kUnroll steps of 32 candidates: first every step's cutoff test,
        // branch-free (a lane past the staged rows reads the last one and
        // is never near), so the compiler interleaves the steps; then the
        // votes. Every lane writes a slot: the near ones the next `hits`
        // slots in lane order, the others the free slots after them.
        bool near[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = j0 + 32 * u + lane;
          const int jr = j < m ? j : m - 1;
          const T dx = min_image(sub_rn(xi, sx[jr]), Lx, iLx);
          const T dy = min_image(sub_rn(yi, sy[jr]), Ly, iLy);
          const T dz = min_image(sub_rn(zi, sz[jr]), Lz, iLz);
          near[u] = (norm2(dx, dy, dz) < rc2) & (j < m);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const unsigned hits = __ballot_sync(kFull, near[u]);
          const int rank = __popc(hits & below);
          const int total = __popc(hits);
          const int slot = near[u] ? rank : total + lane - rank;
          ring[(head + queued + slot) & (kRing - 1)] = j0 + 32 * u + lane;
          queued += total;
        }
        j0 += 32 * kUnroll;
      }
      if (queued >= 32 || (queued > 0 && j0 >= m)) {
        __syncwarp();
        if (lane < queued) {
          // self and exclusion tests, then the pair term into this lane's
          // accumulators (the displacement as in the cutoff test, bit for
          // bit)
          const int j = ring[(head + lane) & (kRing - 1)];
          const int idj = sid[j];
          bool skip = idj == kid;
#pragma unroll
          for (int e = 0; e < kMaxExcl; ++e) skip |= ex[e] == idj;
          if (!skip) {
            const T dx = min_image(sub_rn(xi, sx[j]), Lx, iLx);
            const T dy = min_image(sub_rn(yi, sy[j]), Ly, iLy);
            const T dz = min_image(sub_rn(zi, sz[j]), Lz, iLz);
            const T f = lj_ewald_pair(norm2(dx, dy, dz), ti + stype[j], qi * sq[j],
                                      s_eps, s_sig2, s_rc2, s_vsh, kappa, lj_on,
                                      coul_on, e_lj, e_ew);
            fx += f * dx;
            fy += f * dy;
            fz += f * dz;
          }
        }
        const int took = queued < 32 ? queued : 32;
        head = (head + took) & (kRing - 1);
        queued -= took;
        __syncwarp();  // the slots just taken are free for the next pushes
      }
    }
    fx = warp_sum(fx);
    fy = warp_sum(fy);
    fz = warp_sum(fz);
    if (lane == 0) {
      forces[3 * (size_t)idi] = fx;
      forces[3 * (size_t)idi + 1] = fy;
      forces[3 * (size_t)idi + 2] = fz;
    }
  }
  e_lj = warp_sum(e_lj);
  e_ew = warp_sum(e_ew);
  if (lane == 0) {
    s_red[warp][0] = e_lj;
    s_red[warp][1] = e_ew;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T a = 0, b = 0;
    for (int w = 0; w < kWarps; ++w) {
      a += s_red[w][0];
      b += s_red[w][1];
    }
    const size_t blk = (size_t)blockIdx.x * gridDim.y + blockIdx.y;
    e_partial[2 * blk] = a;
    e_partial[2 * blk + 1] = b;
  }
}

template <typename T>
int launch(const void* pos, const void* box, const void* type_id,
           const void* charge, const void* eps, const void* sig2,
           const void* rcut2, const void* vshift, int ntypes,
           const void* bucket, const void* nbr, const void* excl, int max_excl,
           int n, int ncells, int cap, double rc2, double kappa, int lj_on,
           int coul_on, int cell_begin, int cell_count, int split,
           const void* key, void* forces, void* e_partial, void* stream) {
  if (ntypes < 1 || ntypes > kMaxTypes || max_excl < 1 || max_excl > kMaxExcl ||
      n < 1 || ncells < 1 || cap < 1 || cell_begin < 0 || cell_count < 1 ||
      cell_begin + cell_count > ncells || split < 1 || split > 65535 ||
      (long long)kNeighbors * cap + 32 * kUnroll > 65535)  // 16-bit ring rows
    return (int)cudaErrorInvalidValue;
  // set the kernel's dynamic shared memory limit when a launch needs more
  // than the last one set, not on every launch (the overflow retry grows
  // cap); the default 48 KB covers static and dynamic bytes together, so
  // the first launch always sets it
  static size_t raised_to = 0;
  const size_t smem = smem_bytes<T>(cap);
  if (smem > raised_to) {
    cudaError_t err = cudaFuncSetAttribute(
        cell_pair_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    raised_to = smem;
  }
  const dim3 grid(cell_count, split);
  cell_pair_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)pos, (const T*)box, (const int32_t*)type_id, (const T*)charge,
      (const T*)eps, (const T*)sig2, (const T*)rcut2, (const T*)vshift, ntypes,
      (const int32_t*)bucket, (const int32_t*)nbr, (const int32_t*)excl, max_excl,
      n, ncells, cap, (T)rc2, (T)kappa, lj_on, coul_on, cell_begin,
      (const int32_t*)key, (T*)forces, (T*)e_partial);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cavmd_cell_pair_f32(const void* pos, const void* box, const void* type_id,
                        const void* charge, const void* eps, const void* sig2,
                        const void* rcut2, const void* vshift, int ntypes,
                        const void* bucket, const void* nbr, const void* excl,
                        int max_excl, int n, int ncells, int cap, double rc2,
                        double kappa, int lj_on, int coul_on, int cell_begin,
                        int cell_count, int split, const void* key, void* forces,
                        void* e_partial, void* stream) {
  return launch<float>(pos, box, type_id, charge, eps, sig2, rcut2, vshift,
                       ntypes, bucket, nbr, excl, max_excl, n, ncells, cap, rc2,
                       kappa, lj_on, coul_on, cell_begin, cell_count, split, key,
                       forces, e_partial, stream);
}

int cavmd_cell_pair_f64(const void* pos, const void* box, const void* type_id,
                        const void* charge, const void* eps, const void* sig2,
                        const void* rcut2, const void* vshift, int ntypes,
                        const void* bucket, const void* nbr, const void* excl,
                        int max_excl, int n, int ncells, int cap, double rc2,
                        double kappa, int lj_on, int coul_on, int cell_begin,
                        int cell_count, int split, const void* key, void* forces,
                        void* e_partial, void* stream) {
  return launch<double>(pos, box, type_id, charge, eps, sig2, rcut2, vshift,
                        ntypes, bucket, nbr, excl, max_excl, n, ncells, cap, rc2,
                        kappa, lj_on, coul_on, cell_begin, cell_count, split, key,
                        forces, e_partial, stream);
}

}  // extern "C"
