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
// What bounds it on an H100: operations. At N = 100,001 (17^3 cells, mean
// occupancy 20.4) the pass tests ~55 M candidate pairs and evaluates ~7.3 M
// in-cutoff pairs (a divide per axis for the minimum image, an erfc and an
// exp each), against ~6 MB of input; the TPU layout tricks (z-haloed
// columns, two-tier i rows, j-split windows, lane padding) answer VMEM and
// lane width and are not carried over. Design:
//   - one block per cell; the block stages its 27 neighbour cells' occupied
//     slots, compacted, in shared memory (x, y, z, q, id, type as
//     structure-of-arrays, so neighbouring lanes read neighbouring words):
//     loops run to the occupancy, so empty slots cost nothing and a
//     sentinel slot is never touched (its far position could wrap onto a
//     real coordinate and give r^2 = 0);
//   - dynamic shared memory sized 27 * cap rows (29 KB at cap 45 in f32,
//     49 KB in f64), raised past 48 KB with cudaFuncSetAttribute, so the
//     overflow retry's larger caps still launch;
//   - warps take the cell's i rows, lanes stride over the staged j rows,
//     and a warp-shuffle sum closes each row: every particle owns one slot,
//     so its force is written once, with no atomics and no slot gather;
//   - per-block (e_lj, e_ew) partials, summed in a fixed order by the
//     wrapper and halved, as in the dense kernel.
// The launch allocates nothing and does not synchronise; it returns
// cudaGetLastError(). The caller zeroes the forces: a particle that an
// overflow left without a slot keeps zero, as slot_gather_forces gives it.
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

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kNeighbors = 27;

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
  __shared__ int s_occ[kNeighbors];
  __shared__ int s_off[kNeighbors + 1];
  __shared__ int s_occ_self;
  __shared__ T s_red[kWarps][2];

  const int c = cell_begin + blockIdx.x;
  for (int t = threadIdx.x; t < ntypes * ntypes; t += blockDim.x) {
    s_eps[t] = eps_t[t];
    s_sig2[t] = sig2_t[t];
    s_rc2[t] = rcut2_t[t];
    s_vsh[t] = vshift_t[t];
  }
  // occupancy of each neighbour cell (buckets fill from slot 0) and of c
  if (threadIdx.x <= kNeighbors) {
    const int cell = threadIdx.x < kNeighbors ? nbr[(size_t)c * kNeighbors + threadIdx.x] : c;
    int occ = 0;
    if (cell < ncells) {
      const int32_t* b = bucket + (size_t)cell * cap;
      while (occ < cap && b[occ] < n) ++occ;
    }
    if (threadIdx.x < kNeighbors) s_occ[threadIdx.x] = occ;
    else s_occ_self = occ;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int k = 0; k < kNeighbors; ++k) {
      s_off[k] = acc;
      acc += s_occ[k];
    }
    s_off[kNeighbors] = acc;
  }
  __syncthreads();

  // stage the occupied neighbour slots, compacted
  for (int s = threadIdx.x; s < rows; s += blockDim.x) {
    const int k = s / cap;
    const int r = s - k * cap;
    if (r < s_occ[k]) {
      const int cell = nbr[(size_t)c * kNeighbors + k];
      const int id = bucket[(size_t)cell * cap + r];
      const int d = s_off[k] + r;
      sx[d] = pos[3 * (size_t)id];
      sy[d] = pos[3 * (size_t)id + 1];
      sz[d] = pos[3 * (size_t)id + 2];
      sq[d] = charge[id];
      sid[d] = key ? key[id] : id;
      stype[d] = type_id[id];
    }
  }
  __syncthreads();

  const int m = s_off[kNeighbors];
  const int occ_self = s_occ_self;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T Lx = box[0], Ly = box[1], Lz = box[2];
  T e_lj = 0, e_ew = 0;

  for (int i = warp; i < occ_self; i += kWarps) {  // warp-uniform
    const int idi = bucket[(size_t)c * cap + i];
    const int kid = key ? key[idi] : idi;
    const T xi = pos[3 * (size_t)idi], yi = pos[3 * (size_t)idi + 1];
    const T zi = pos[3 * (size_t)idi + 2];
    const T qi = charge[idi];
    const int ti = type_id[idi] * ntypes;
    int ex[kMaxExcl];
#pragma unroll
    for (int e = 0; e < kMaxExcl; ++e)
      ex[e] = e < max_excl ? excl[(size_t)idi * max_excl + e] : -1;
    T fx = 0, fy = 0, fz = 0;
    for (int j = lane; j < m; j += 32) {
      const int idj = sid[j];
      bool skip = idj == kid;
#pragma unroll
      for (int e = 0; e < kMaxExcl; ++e) skip |= ex[e] == idj;
      if (skip) continue;
      T dx = xi - sx[j];
      T dy = yi - sy[j];
      T dz = zi - sz[j];
      dx = dx - Lx * m_rint(dx / Lx);
      dy = dy - Ly * m_rint(dy / Ly);
      dz = dz - Lz * m_rint(dz / Lz);
      const T r2 = dx * dx + dy * dy + dz * dz;
      if (!(r2 < rc2)) continue;
      const T f = lj_ewald_pair(r2, ti + stype[j], qi * sq[j], s_eps, s_sig2,
                                s_rc2, s_vsh, kappa, lj_on, coul_on, e_lj, e_ew);
      fx += f * dx;
      fy += f * dy;
      fz += f * dz;
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
    e_partial[2 * (size_t)blockIdx.x] = a;
    e_partial[2 * (size_t)blockIdx.x + 1] = b;
  }
}

template <typename T>
int launch(const void* pos, const void* box, const void* type_id,
           const void* charge, const void* eps, const void* sig2,
           const void* rcut2, const void* vshift, int ntypes,
           const void* bucket, const void* nbr, const void* excl, int max_excl,
           int n, int ncells, int cap, double rc2, double kappa, int lj_on,
           int coul_on, int cell_begin, int cell_count, const void* key,
           void* forces, void* e_partial, void* stream) {
  if (ntypes < 1 || ntypes > kMaxTypes || max_excl < 1 || max_excl > kMaxExcl ||
      n < 1 || ncells < 1 || cap < 1 || cell_begin < 0 || cell_count < 1 ||
      cell_begin + cell_count > ncells)
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
  cell_pair_kernel<T><<<cell_count, kThreads, smem, (cudaStream_t)stream>>>(
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
                        int cell_count, const void* key, void* forces,
                        void* e_partial, void* stream) {
  return launch<float>(pos, box, type_id, charge, eps, sig2, rcut2, vshift,
                       ntypes, bucket, nbr, excl, max_excl, n, ncells, cap, rc2,
                       kappa, lj_on, coul_on, cell_begin, cell_count, key,
                       forces, e_partial, stream);
}

int cavmd_cell_pair_f64(const void* pos, const void* box, const void* type_id,
                        const void* charge, const void* eps, const void* sig2,
                        const void* rcut2, const void* vshift, int ntypes,
                        const void* bucket, const void* nbr, const void* excl,
                        int max_excl, int n, int ncells, int cap, double rc2,
                        double kappa, int lj_on, int coul_on, int cell_begin,
                        int cell_count, const void* key, void* forces,
                        void* e_partial, void* stream) {
  return launch<double>(pos, box, type_id, charge, eps, sig2, rcut2, vshift,
                        ntypes, bucket, nbr, excl, max_excl, n, ncells, cap, rc2,
                        kappa, lj_on, coul_on, cell_begin, cell_count, key,
                       forces, e_partial, stream);
}

}  // extern "C"
