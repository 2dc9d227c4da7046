// Dense all-pairs shifted-LJ + short-range Ewald (erfc) pair pass.
//
// Replaces the TPU kernel cavmd_tpu/ops/pallas_kernels.py:_pair_kernel
// (wrapper make_fused_pair_pallas); semantics are those of the XLA function
// cavmd_tpu/ops/lj.py:fused_pair_force, not of the Pallas body:
//   - true erfc/erfcf (the Pallas body used the A&S rational approximation);
//   - minimum image rounding half to even like jnp.round;
//   - masked pairs are skipped, never divided by r^2 = 0.
//
// What bounds it on an H100: at the reference size (N = 501) the pass is
// ~250k candidate pairs, of which ~14.5% lie inside the 15-bohr cutoff of
// the 46-bohr box: microseconds of SM time, so the chain of dependent
// loads and syncs of one block and how many warps the card runs bound it.
// At N = 4001 (16 M candidates, 32 MB of uint8 masks, 9.6 us at 3.35
// TB/s) it is the mask loads' latency, then the candidate loop's ~35
// instructions a step of 32 and the pair term (scratch copies that skipped
// the mask loads ran much faster). The first version (one
// warp a row, 4 warps a block, the pair term under the cutoff test) ran ~4
// warps an SM at N = 501 and a chain of global loads, three divides and
// rint a pair. Design:
//   - a block of 8 warps takes `rows` rows (1, 2, 4 or 8: N / 256 rounded
//     down to a power of two, so N = 501 runs 501 blocks of one row, ~30
//     warps an SM, and N = 4001 501 blocks of eight); the 8 / rows warps
//     of a row take its j in interleaved steps of 32, so at N = 501 each
//     of the 8 warps has two;
//   - the block stages the j side (x, y, z, q, type) in shared memory as
//     structure of arrays, kChunk rows at a time, every load of a batch in
//     flight together (positions read as one coalesced run), so a j row is
//     read from device memory once a block;
//   - cutoff first: lanes take U steps of 32 candidates at a time (U = 4;
//     2 at one row a block, where a warp has two), computing the minimum
//     image and r^2 only (pair_term.cuh: min_image, norm2), and push each j
//     whose two mask bytes are not both off and whose r^2 is under the
//     larger of the LJ and Coulomb cutoffs, with its two mask bits, into a
//     per-warp ring of 256 in shared memory (ballot, popc, the lane's
//     rank). The mask bytes are loaded a round ahead and read only in the
//     next one, so they are in flight while the warp tests the current
//     steps (the first ones while the block stages). Whenever the ring
//     holds 32, every lane takes one and runs pair_term.cuh's
//     lj_ewald_pair, which applies the exact tests (the type pair's LJ
//     cutoff, the Coulomb cutoff, eps != 0, q_i q_j != 0). The masks
//     already encode eps != 0 and q_i q_j != 0 (integrate/forcefield.py),
//     and a masked-in pair with eps = 0 or q_i q_j = 0 adds exactly zero in
//     the twin too, so the two tests agree with it;
//   - each row sums over all j with no Newton-3 scatter: a warp closes its
//     slice with a shuffle sum, and one thread a row adds the slices in
//     order from shared memory. No atomics; two calls give the same bits;
//   - energies leave as per-block partials (block-ordered sums, halved in
//     the kernel: exact, a power of two), a row of e_lj and a row of e_ew,
//     summed along the rows by one deterministic torch.sum in the wrapper.
// Replica batches (parallel/replicas.py): one launch takes B replicas of
// the same topology, blockIdx.y the replica. Positions, forces and the
// energy partials, (B, 2, blocks), are offset by the replica; the type
// tables, charges and the two (N, N) masks are shared, read by every
// replica's blocks (the masks stay in L2 at N <= 4096: 2 bytes a pair,
// 0.5 MB at N = 501). The rows a block take the batch's B N rows into
// account, as one larger N would: at N = 501 and B = 8, 8 rows a block
// (63 blocks a replica), so a block stages the j side once for 8 rows
// (one row a block, 4008 blocks, took 0.045 ms: every block re-staged all
// 501 j rows for one row). The batched launch is its own instantiation
// (kBatch): with the replica's offsets in the one-replica kernel, the
// float kernel at four steps a round spilled 20 bytes (it sits at the 64
// registers of 4 blocks an SM) and ran 2.9% slower at N = 4001
// (chip_smoke.py phase 1 and scripts/bench_torch_pair_interp.py, H100
// 80GB HBM3 at 700 W). The batched float kernel runs 3 blocks an SM (up
// to 85 registers): at 4 it spilled 20-44 bytes whichever way its replica
// was held (offset pointers, %ctaid.y read at each use, a volatile shared
// word).
// A row range (atom sharding by rows, parallel/shard.py): a launch may take
// rows [row0, row0 + nrows) of the N i rows only, against all N j rows.
// The blocks are sized and counted from nrows as from N, a row reads its
// own row of the two (N, N) masks, and the forces come out (..., nrows,
// 3), the rank's rows; the energy partials are this range's share of the
// halved sums, so the shares of S ranges add to the full launch's energy.
// The full launch is the range (0, N). A range's rows equal the full
// launch's bit for bit when both put as many rows in a block (N = 501 and
// its halves: one); otherwise a row's j slices are added in another order.
// The launch allocates nothing and does not synchronise; it returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_term.cuh"

namespace {

using namespace cavmd;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 1024;         // j rows staged at a time
constexpr int kStage = 8;            // staged words a thread loads at a time
constexpr int kMaxUnroll = 4;        // candidate steps of 32 between queue checks
constexpr int kRing = 64 * kMaxUnroll;  // per-warp queue: (j << 2) | mask bits
constexpr unsigned kFull = 0xffffffffu;

// Rows a block for nb replicas of n rows: nb n / 256 rounded down to a
// power of two, from 1 to 8, so a launch is ~500 blocks (N = 501: 501
// blocks of one row; N = 4001, or N = 501 in a batch of 8: ~500 of
// eight), about 4 an SM.
inline int rows_per_block(int n, int nb) {
  const long long rows = (long long)n * nb;
  int r = 1;
  while (r < kWarps && 2LL * r * 256 <= rows) r *= 2;
  return r;
}

// Steps a round: 2 at one row a block (N < 512: a warp has ~2 steps of the
// row, and 4 would run two empty ones), else 4.
inline int kernel_unroll(int rows) { return rows == 1 ? 2 : 4; }

// Blocks a replica.
inline int blocks_for(int n, int nb) {
  const int r = rows_per_block(n, nb);
  return (n + r - 1) / r;
}

// U: candidate steps of 32 a lane takes between queue checks (kernel_unroll).
template <typename T, int U, bool kBatch>
__global__ void __launch_bounds__(kThreads,
                                  sizeof(T) == 4 ? (kBatch ? 3 : 4) : 2)
dense_pair_kernel(const T* __restrict__ pos, const T* __restrict__ box,
                  const int32_t* __restrict__ type_id,
                  const T* __restrict__ eps_t, const T* __restrict__ sig2_t,
                  const T* __restrict__ rcut2_t, const T* __restrict__ vshift_t,
                  int ntypes, const T* __restrict__ charge,
                  const uint8_t* __restrict__ lj_active,
                  const uint8_t* __restrict__ coul_active, int n, int row0,
                  int nrows, int rows, T kappa, T coul_rc2,
                  T* __restrict__ forces, T* __restrict__ e_partial) {
  __shared__ T s_j[4][kChunk];  // staged x, y, z, q
  __shared__ uint8_t stype[kChunk];
  __shared__ T s_eps[kMaxTypes * kMaxTypes];
  __shared__ T s_sig2[kMaxTypes * kMaxTypes];
  __shared__ T s_rc2[kMaxTypes * kMaxTypes];
  __shared__ T s_vsh[kMaxTypes * kMaxTypes];
  __shared__ uint16_t s_ring[kWarps][kRing];  // j << 2 < kChunk << 2 = 2^12
  __shared__ T s_f[kWarps][3];
  __shared__ T s_red[kWarps][2];
  __shared__ T s_cut2;

  if (kBatch) {  // this block's replica: its positions, forces, partials
    pos += 3 * (size_t)n * blockIdx.y;
    forces += 3 * (size_t)nrows * blockIdx.y;
    e_partial += 2 * (size_t)gridDim.x * blockIdx.y;
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nt2 = ntypes * ntypes;
  for (int t = threadIdx.x; t < nt2; t += kThreads) {
    s_eps[t] = eps_t[t];
    s_sig2[t] = sig2_t[t];
    s_rc2[t] = rcut2_t[t];
    s_vsh[t] = vshift_t[t];
  }
  if (warp == 0) {  // the candidate cutoff: the largest LJ or Coulomb one
    T c = coul_rc2;
    for (int t = lane; t < nt2; t += 32) {
      const T v = rcut2_t[t];
      c = v > c ? v : c;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const T v = __shfl_xor_sync(kFull, c, off);
      c = v > c ? v : c;
    }
    if (lane == 0) s_cut2 = c;
  }

  // this warp's row and j slice (warp-uniform)
  const int slices = kWarps / rows;
  const int slice = warp % slices;
  const int i_own = blockIdx.x * rows + warp / slices;  // in the range
  const bool row_ok = i_own < nrows;
  const int i = row0 + i_own;
  const T Lx = box[0], Ly = box[1], Lz = box[2];
  const T iLx = T(1) / Lx, iLy = T(1) / Ly, iLz = T(1) / Lz;
  T xi = 0, yi = 0, zi = 0, qi = 0;
  int ti = 0;
  if (row_ok) {
    xi = pos[3 * (size_t)i];
    yi = pos[3 * (size_t)i + 1];
    zi = pos[3 * (size_t)i + 2];
    qi = charge[i];
    ti = type_id[i] * ntypes;
  }
  const uint8_t* la = lj_active + (size_t)i * n;
  const uint8_t* ca = coul_active + (size_t)i * n;
  const unsigned below = (1u << lane) - 1u;
  uint16_t* ring = s_ring[warp];
  T fx = 0, fy = 0, fz = 0, e_lj = 0, e_ew = 0;

  const T* sx = s_j[0];
  const T* sy = s_j[1];
  const T* sz = s_j[2];
  const T* sq = s_j[3];
  // the mask bytes of this lane's candidates in steps t .. t + U - 1
  // of the chunk of m rows from c0 (0 past the chunk), loaded into lj[] and
  // cw[] and read only at the next iteration, so the loads stay in flight
  // while the warp works on the current one
  auto load_masks = [&](int c0, int m, int t, uint32_t* lj, uint32_t* cw) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = 32 * (slice + slices * (t + u)) + lane;
      lj[u] = j < m ? la[c0 + j] : 0u;
      cw[u] = j < m ? ca[c0 + j] : 0u;
    }
  };

  for (int c0 = 0; c0 < n; c0 += kChunk) {  // block-uniform
    const int m = min(kChunk, n - c0);
    // this warp's first mask bytes: in flight while the block stages
    uint32_t nlj[U], ncw[U];
    if (row_ok) load_masks(c0, m, 0, nlj, ncw);
    // the last chunk's readers are done (the tables and the first chunk
    // are read only after the staging sync below)
    if (c0 > 0) __syncthreads();
    {
      // stage the chunk, every load of a batch in flight together: the
      // types, then positions as one coalesced run and the charges, kStage
      // words a thread
      int ty[kChunk / kThreads];
#pragma unroll
      for (int u = 0; u < kChunk / kThreads; ++u) {
        const int j = u * kThreads + threadIdx.x;
        ty[u] = j < m ? type_id[c0 + j] : 0;
      }
      for (int t0 = 0; t0 < 4 * m; t0 += kStage * kThreads) {
        T v[kStage];
#pragma unroll
        for (int u = 0; u < kStage; ++u) {
          const int t = t0 + u * kThreads + threadIdx.x;
          v[u] = t < 3 * m ? pos[3 * (size_t)c0 + t]
                           : (t < 4 * m ? charge[c0 + t - 3 * m] : T(0));
        }
#pragma unroll
        for (int u = 0; u < kStage; ++u) {
          const int t = t0 + u * kThreads + threadIdx.x;
          const int j = t < 3 * m ? t / 3 : t - 3 * m;
          if (t < 4 * m) s_j[t < 3 * m ? t - 3 * j : 3][j] = v[u];
        }
      }
#pragma unroll
      for (int u = 0; u < kChunk / kThreads; ++u) {
        const int j = u * kThreads + threadIdx.x;
        if (j < m) stype[j] = (uint8_t)ty[u];
      }
    }
    __syncthreads();
    if (!row_ok) continue;
    const T cut2 = s_cut2;
    int head = 0, queued = 0;  // warp-uniform ring state
    // this warp's steps of 32: j = 32 (slice + slices t) + lane
    for (int t0 = 0; 32 * (slice + slices * t0) < m || queued > 0;) {
      if (32 * (slice + slices * t0) < m && queued <= kRing - 32 * U) {
        // U steps of 32: the mask bits (loaded an iteration ahead;
        // the next iteration's loads go out now), the cutoff tests,
        // branch-free (a lane past the chunk reads its last row and is
        // masked off), then the votes. Every lane writes a slot: the
        // queued ones the next `hits` slots in lane order, the others the
        // free slots after them.
        int bits[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          bits[u] = (nlj[u] != 0u) | ((ncw[u] != 0u) << 1);
        load_masks(c0, m, t0 + U, nlj, ncw);
        bool near[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = 32 * (slice + slices * (t0 + u)) + lane;
          const int jr = j < m ? j : m - 1;
          const T dx = min_image(sub_rn(xi, sx[jr]), Lx, iLx);
          const T dy = min_image(sub_rn(yi, sy[jr]), Ly, iLy);
          const T dz = min_image(sub_rn(zi, sz[jr]), Lz, iLz);
          near[u] = (bits[u] != 0) & (norm2(dx, dy, dz) < cut2);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const unsigned hits = __ballot_sync(kFull, near[u]);
          const int rank = __popc(hits & below);
          const int total = __popc(hits);
          const int slot = near[u] ? rank : total + lane - rank;
          const int j = 32 * (slice + slices * (t0 + u)) + lane;
          ring[(head + queued + slot) & (kRing - 1)] =
              (uint16_t)((j < m ? j << 2 : 0) | bits[u]);
          queued += total;
        }
        t0 += U;
      }
      if (queued >= 32 ||
          (queued > 0 && 32 * (slice + slices * t0) >= m)) {
        __syncwarp();
        if (lane < queued) {
          // the pair term on a full warp: the displacement as in the
          // cutoff test, bit for bit, and the exact tests
          const int e = ring[(head + lane) & (kRing - 1)];
          const int j = e >> 2;
          const T dx = min_image(sub_rn(xi, sx[j]), Lx, iLx);
          const T dy = min_image(sub_rn(yi, sy[j]), Ly, iLy);
          const T dz = min_image(sub_rn(zi, sz[j]), Lz, iLz);
          const T r2 = norm2(dx, dy, dz);
          const T f = lj_ewald_pair(r2, ti + stype[j], qi * sq[j], s_eps,
                                    s_sig2, s_rc2, s_vsh, kappa, e & 1,
                                    (e & 2) && r2 < coul_rc2, e_lj, e_ew);
          fx += f * dx;
          fy += f * dy;
          fz += f * dz;
        }
        const int took = queued < 32 ? queued : 32;
        head = (head + took) & (kRing - 1);
        queued -= took;
        __syncwarp();  // the slots just taken are free for the next pushes
      }
    }
  }

  fx = warp_sum(fx);
  fy = warp_sum(fy);
  fz = warp_sum(fz);
  e_lj = warp_sum(e_lj);
  e_ew = warp_sum(e_ew);
  if (lane == 0) {
    s_f[warp][0] = fx;
    s_f[warp][1] = fy;
    s_f[warp][2] = fz;
    s_red[warp][0] = e_lj;
    s_red[warp][1] = e_ew;
  }
  __syncthreads();
  // one thread a row adds its slices in order; thread 0 the energies
  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    const int ir = blockIdx.x * rows + r;  // the range's own row
    if (ir < nrows) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        T v = 0;
        for (int s = 0; s < slices; ++s) v += s_f[r * slices + s][d];
        forces[3 * (size_t)ir + d] = v;
      }
    }
  }
  if (threadIdx.x == 0) {  // halved here: each pair is met from both rows
    T a = 0, b = 0;
    for (int w = 0; w < kWarps; ++w) {
      a += s_red[w][0];
      b += s_red[w][1];
    }
    e_partial[blockIdx.x] = T(0.5) * a;
    e_partial[gridDim.x + blockIdx.x] = T(0.5) * b;
  }
}

template <typename T>
int launch(const void* pos, const void* box, const void* type_id,
           const void* eps, const void* sig2, const void* rcut2,
           const void* vshift, int ntypes, const void* charge,
           const void* lj_active, const void* coul_active, int n, int row0,
           int nrows, int nb, double kappa, double coul_rc2, void* forces,
           void* e_partial, void* stream) {
  if (ntypes < 1 || ntypes > kMaxTypes || n < 1 || nb < 1 || nb > 65535 ||
      row0 < 0 || nrows < 1 || row0 + nrows > n)
    return (int)cudaErrorInvalidValue;
  const int rows = rows_per_block(nrows, nb);
  auto kernel = nb > 1 ? (kernel_unroll(rows) == 2 ? dense_pair_kernel<T, 2, true>
                                                   : dense_pair_kernel<T, 4, true>)
                       : (kernel_unroll(rows) == 2 ? dense_pair_kernel<T, 2, false>
                                                   : dense_pair_kernel<T, 4, false>);
  kernel<<<dim3(blocks_for(nrows, nb), nb), kThreads, 0,
           (cudaStream_t)stream>>>(
      (const T*)pos, (const T*)box, (const int32_t*)type_id, (const T*)eps,
      (const T*)sig2, (const T*)rcut2, (const T*)vshift, ntypes,
      (const T*)charge, (const uint8_t*)lj_active, (const uint8_t*)coul_active,
      n, row0, nrows, rows, (T)kappa, (T)coul_rc2, (T*)forces, (T*)e_partial);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks a replica of a launch over nb replicas of nrows i rows (N, or a
// row range's length): the length of each of the energy partials' (nb, 2)
// rows.
int cavmd_dense_pair_blocks(int nrows, int nb) {
  return blocks_for(nrows, nb);
}

int cavmd_dense_pair_f32(const void* pos, const void* box, const void* type_id,
                         const void* eps, const void* sig2, const void* rcut2,
                         const void* vshift, int ntypes, const void* charge,
                         const void* lj_active, const void* coul_active, int n,
                         int row0, int nrows, int nb, double kappa,
                         double coul_rc2, void* forces, void* e_partial,
                         void* stream) {
  return launch<float>(pos, box, type_id, eps, sig2, rcut2, vshift, ntypes,
                       charge, lj_active, coul_active, n, row0, nrows, nb,
                       kappa, coul_rc2, forces, e_partial, stream);
}

int cavmd_dense_pair_f64(const void* pos, const void* box, const void* type_id,
                         const void* eps, const void* sig2, const void* rcut2,
                         const void* vshift, int ntypes, const void* charge,
                         const void* lj_active, const void* coul_active, int n,
                         int row0, int nrows, int nb, double kappa,
                         double coul_rc2, void* forces, void* e_partial,
                         void* stream) {
  return launch<double>(pos, box, type_id, eps, sig2, rcut2, vshift, ntypes,
                        charge, lj_active, coul_active, n, row0, nrows, nb,
                        kappa, coul_rc2, forces, e_partial, stream);
}

}  // extern "C"
