// Shifted-LJ + short-range Ewald (erfc) pair pass over the z-sorted column
// layout (pair_mode='zcol').
//
// Replaces the TPU kernel _zcol_kernel of cavmd_tpu/ops/pallas_kernels.py
// (wrapper fused_zsort_cols_pallas). Particles sit z-sorted in xy columns;
// each column's 9 neighbour columns are merged into one z-sorted halo of
// 9 * cap slots (real slots first, empty ones last), cut into j-blocks of
// 128. The wrapper (ops/zcol_kernels.py) computes, from the live local
// positions, each i-block's two-run hull (s1, c1, s2, count): the j-blocks
// whose z range can reach the i-block's 16 slots. For every real slot i of
// the i-block the kernel sums the pairs with the real slots of the first
// min(count, W) hull blocks, run 1 then run 2, exactly as the TPU kernel:
// a pair counts when j != i, j is not in i's exclusion row and r^2 <
// r_cut^2; LJ from (T, T) tables and Ewald short with true erfc (the XLA
// tile path's math, pair_term.cuh, shared with the cell and dense kernels);
// the minimum image on every pair of the local coordinates by pair_term.cuh's
// min_image (the twin's rint image, bit for bit inside the cutoff).
//
// What bounds it on an H100: operations. At N = 100,001 (17 x 17 columns,
// cap 512, 32 i-blocks a column, W = 8) a hull of ~5-6 blocks gives each i
// row ~700 candidates, ~70 M in all, against ~6.6 M pairs inside the
// cutoff and a few MB of input. What the TPU kernel does for VMEM and
// Mosaic is left behind (the static W-visit unroll and its parking block,
// the pred scratch, padded static rows, the LJ factorisation). Design:
//   - one block per (column, i-block); an i-block past its column's
//     occupancy has c1 = 0 and exits at once (about a third at N =
//     100,001);
//   - the block loops over its own hull: a dynamic trip count costs
//     nothing here. It stages the visited blocks' real slots, compacted,
//     in dynamic shared memory as structure of arrays (x, y, z, q, id,
//     type): the halo's real slots are a prefix of the row, so a block's
//     real slots are a prefix of the block, and no empty slot is staged
//     (its far position could wrap onto a real one);
//   - warps take the i-block's real rows, lanes stride over the staged j
//     rows, and a warp-shuffle sum closes each row: every particle owns one
//     slot, so its force is written once, with no atomics;
//   - per-block (e_lj, e_ew) partials, summed in a fixed order by the
//     wrapper and halved.
// Shared memory is W * 128 staged rows (24 KB at W = 8 in f32, 40 KB in
// f64), raised past 48 KB with cudaFuncSetAttribute when the overflow
// retry grows W. The launch allocates nothing and does not synchronise; it
// returns cudaGetLastError(). The caller zeroes the forces.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_term.cuh"

namespace {

using namespace cavmd;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kIBlock = 16;   // slots of an i-block (the hull's unit)
constexpr int kJBlock = 128;  // slots of a j-block of the merged halo

// Bytes of dynamic shared memory: W * 128 staged rows, then W + 1 offsets
// and W block ids.
template <typename T>
size_t smem_bytes(int W) {
  return (size_t)W * kJBlock * (4 * sizeof(T) + 2 * sizeof(int32_t)) +
         (size_t)(2 * W + 1) * sizeof(int32_t);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
zcol_pair_kernel(const T* __restrict__ pos, const T* __restrict__ box,
                 const int32_t* __restrict__ type_id, const T* __restrict__ charge,
                 const T* __restrict__ eps_t, const T* __restrict__ sig2_t,
                 const T* __restrict__ rcut2_t, const T* __restrict__ vshift_t,
                 int ntypes, const int32_t* __restrict__ bucket,
                 const int32_t* __restrict__ halo, const int32_t* __restrict__ hull,
                 const int32_t* __restrict__ excl, int max_excl, int n, int cap,
                 int W, T rc2, T kappa, T* __restrict__ forces,
                 T* __restrict__ e_partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = W * kJBlock;
  T* sx = reinterpret_cast<T*>(smem_raw);
  T* sy = sx + rows;
  T* sz = sy + rows;
  T* sq = sz + rows;
  int32_t* sid = reinterpret_cast<int32_t*>(sq + rows);
  int32_t* stype = sid + rows;
  int32_t* s_off = stype + rows;  // W + 1 staged-row offsets
  int32_t* s_jb = s_off + W + 1;  // W visited block ids

  __shared__ T s_eps[kMaxTypes * kMaxTypes];
  __shared__ T s_sig2[kMaxTypes * kMaxTypes];
  __shared__ T s_rc2[kMaxTypes * kMaxTypes];
  __shared__ T s_vsh[kMaxTypes * kMaxTypes];
  __shared__ T s_red[kWarps][2];

  const int nib = cap / kIBlock;
  const int col = blockIdx.x / nib;
  const int ib = blockIdx.x - col * nib;
  const int32_t* h = hull + 4 * (size_t)blockIdx.x;
  const int s1 = h[0], c1 = h[1], s2 = h[2];
  const int nv = min(h[3], W);
  if (c1 <= 0) {  // block-uniform: no real slot, or nothing in reach
    if (threadIdx.x == 0) {
      e_partial[2 * (size_t)blockIdx.x] = T(0);
      e_partial[2 * (size_t)blockIdx.x + 1] = T(0);
    }
    return;
  }
  const int32_t* hrow = halo + (size_t)col * 9 * cap;
  for (int t = threadIdx.x; t < ntypes * ntypes; t += blockDim.x) {
    s_eps[t] = eps_t[t];
    s_sig2[t] = sig2_t[t];
    s_rc2[t] = rcut2_t[t];
    s_vsh[t] = vshift_t[t];
  }
  if (threadIdx.x == 0) {
    // real slots of the halo row: its first empty slot, by bisection
    int lo = 0, hi = 9 * cap;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (hrow[mid] < n) lo = mid + 1;
      else hi = mid;
    }
    int acc = 0;
    for (int t = 0; t < nv; ++t) {
      const int jb = t < c1 ? s1 + t : s2 + (t - c1);
      s_jb[t] = jb;
      s_off[t] = acc;
      acc += max(0, min(kJBlock, lo - jb * kJBlock));
    }
    s_off[nv] = acc;
  }
  __syncthreads();

  // stage the visited blocks' real slots, compacted
  for (int s = threadIdx.x; s < nv * kJBlock; s += blockDim.x) {
    const int t = s / kJBlock;
    const int r = s - t * kJBlock;
    const int d = s_off[t] + r;
    if (d < s_off[t + 1]) {
      const int id = hrow[s_jb[t] * kJBlock + r];
      sx[d] = pos[3 * (size_t)id];
      sy[d] = pos[3 * (size_t)id + 1];
      sz[d] = pos[3 * (size_t)id + 2];
      sq[d] = charge[id];
      sid[d] = id;
      stype[d] = type_id[id];
    }
  }
  __syncthreads();

  const int m = s_off[nv];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T Lx = box[0], Ly = box[1], Lz = box[2];
  const T iLx = T(1) / Lx, iLy = T(1) / Ly, iLz = T(1) / Lz;
  T e_lj = 0, e_ew = 0;
  const int32_t* irow = bucket + (size_t)col * cap + ib * kIBlock;

  for (int i = warp; i < kIBlock; i += kWarps) {  // warp-uniform
    const int idi = irow[i];
    if (idi >= n) break;  // a column's real slots are a prefix
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
      bool skip = idj == idi;
#pragma unroll
      for (int e = 0; e < kMaxExcl; ++e) skip |= ex[e] == idj;
      if (skip) continue;
      const T dx = min_image(sub_rn(xi, sx[j]), Lx, iLx);
      const T dy = min_image(sub_rn(yi, sy[j]), Ly, iLy);
      const T dz = min_image(sub_rn(zi, sz[j]), Lz, iLz);
      const T r2 = norm2(dx, dy, dz);
      if (!(r2 < rc2)) continue;
      const T f = lj_ewald_pair(r2, ti + stype[j], qi * sq[j], s_eps, s_sig2,
                                s_rc2, s_vsh, kappa, 1, 1, e_lj, e_ew);
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
           const void* bucket, const void* halo, const void* hull,
           const void* excl, int max_excl, int n, int ncols, int cap, int W,
           double rc2, double kappa, void* forces, void* e_partial,
           void* stream) {
  if (ntypes < 1 || ntypes > kMaxTypes || max_excl < 1 || max_excl > kMaxExcl ||
      n < 1 || ncols < 1 || cap < kJBlock || cap % kJBlock != 0 || W < 1 ||
      W > 9 * cap / kJBlock)
    return (int)cudaErrorInvalidValue;
  // raise the dynamic shared memory limit when a launch needs more than
  // the last one set (the overflow retry grows W); the default 48 KB covers
  // static and dynamic bytes together, so the first launch always sets it
  static size_t raised_to = 0;
  const size_t smem = smem_bytes<T>(W);
  if (smem > raised_to) {
    cudaError_t err = cudaFuncSetAttribute(
        zcol_pair_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    raised_to = smem;
  }
  const int blocks = ncols * (cap / kIBlock);
  zcol_pair_kernel<T><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)pos, (const T*)box, (const int32_t*)type_id, (const T*)charge,
      (const T*)eps, (const T*)sig2, (const T*)rcut2, (const T*)vshift, ntypes,
      (const int32_t*)bucket, (const int32_t*)halo, (const int32_t*)hull,
      (const int32_t*)excl, max_excl, n, cap, W, (T)rc2, (T)kappa, (T*)forces,
      (T*)e_partial);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cavmd_zcol_pair_f32(const void* pos, const void* box, const void* type_id,
                        const void* charge, const void* eps, const void* sig2,
                        const void* rcut2, const void* vshift, int ntypes,
                        const void* bucket, const void* halo, const void* hull,
                        const void* excl, int max_excl, int n, int ncols,
                        int cap, int W, double rc2, double kappa, void* forces,
                        void* e_partial, void* stream) {
  return launch<float>(pos, box, type_id, charge, eps, sig2, rcut2, vshift,
                       ntypes, bucket, halo, hull, excl, max_excl, n, ncols,
                       cap, W, rc2, kappa, forces, e_partial, stream);
}

int cavmd_zcol_pair_f64(const void* pos, const void* box, const void* type_id,
                        const void* charge, const void* eps, const void* sig2,
                        const void* rcut2, const void* vshift, int ntypes,
                        const void* bucket, const void* halo, const void* hull,
                        const void* excl, int max_excl, int n, int ncols,
                        int cap, int W, double rc2, double kappa, void* forces,
                        void* e_partial, void* stream) {
  return launch<double>(pos, box, type_id, charge, eps, sig2, rcut2, vshift,
                        ntypes, bucket, halo, hull, excl, max_excl, n, ncols,
                        cap, W, rc2, kappa, forces, e_partial, stream);
}

}  // extern "C"
