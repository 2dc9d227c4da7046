// Shifted-LJ + short-range Ewald (erfc) pair pass over the z-sorted column
// layout (pair_mode='zcol'), and the hull that prunes it.
//
// Replaces the TPU kernel _zcol_kernel of cavmd_tpu/ops/pallas_kernels.py
// (wrapper fused_zsort_cols_pallas) and the XLA hull that wrapper computes
// before it. Particles sit z-sorted in xy columns; each column's 9
// neighbour columns are merged into one z-sorted halo of 9 * cap slots
// (real slots first, empty ones last), cut into j-blocks of 128. Two
// kernels, one stream, no read-back:
//
// zcol_hull_kernel: one block per column. It computes what the plain twins
// ops/zcol_kernels.py:zcol_local_positions and zcol_hull compute, bit for
// bit: each slot's live local z (local_anchor + minimage(position -
// anchor)), the z bounds of the column's i-blocks of 16 slots and of its
// halo's j-blocks, the overlap of every (i-block, j-block) pair on the
// periodic z circle, and each i-block's two-run hull (s1, c1, s2, count):
// the set j-blocks split at the largest internal run of clear ones (ties
// to the first, as argmax takes them), an empty run parked at NB. Every
// operation is rounded as PyTorch rounds it (true division, rint, the _rn
// intrinsics, so nvcc contracts nothing into an fma): a z one image off
// would move a block bound by Lz. A flag per column says some count > W.
// It also writes each of the column's particles' row of an (N, 4) table:
// its local coordinates, computed the same way, and its charge.
//
// zcol_pair_kernel: for every real slot i of an i-block it sums the pairs
// with the real slots of the first min(count, W) blocks of the hull, run 1
// then run 2, exactly as the TPU kernel: a pair counts when j != i, j is
// not in i's exclusion row and r^2 < r_cut^2; LJ from (T, T) tables and
// Ewald short with true erfc (the XLA tile path's math, pair_term.cuh,
// shared with the cell and dense kernels); the minimum image on every pair
// of the local coordinates by pair_term.cuh's min_image (the twin's rint
// image, bit for bit inside the cutoff).
//
// What bounds it on an H100: operations. At N = 100,001 (17 x 17 columns,
// cap 512, 32 i-blocks a column, W = 8) a hull of ~5-6 blocks gives each i
// row ~626 candidates, 62.6 M in all, of which 6.6 M lie inside the
// cutoff, against a few MB of input. The design, on the cell kernel's
// lessons (cell_pair.cu):
//   - one block of 256 threads per (column, i-block), 2 rows a warp; an
//     i-block past its column's occupancy has c1 = 0 and exits at once
//     (about a third at N = 100,001);
//   - staging by all warps: each visited block's real rows (a prefix of
//     the block, as the halo's real slots are a prefix of the row) counted
//     by ballots, offsets by a shuffle scan, then 32 rows a warp at a time,
//     two chunks' loads in flight: the row of the hull kernel's table (one
//     16-byte load in f32; the local coordinates are computed once a
//     particle, not once a visit) and the type, compacted in dynamic
//     shared memory as structure of arrays;
//   - z-chunk pruning: each such group of 32 staged rows (a chunk, inside
//     one block) keeps its z centre and half-length. Row i tests every
//     chunk at once, a lane a chunk (one compare per 32 candidates), and
//     skips a chunk whose periodic z distance exceeds its half-length plus
//     r_cut plus a margin of Lz / 4096, thousands of times the coordinates'
//     rounding: a pair inside the cutoff is never skipped, and nothing
//     assumes the rows are sorted. They nearly are (sorted by z at the
//     rebuild, moved less than skin / 2 since), so a row keeps ~380 of its
//     ~626 candidates;
//   - cutoff first: lanes compute only the displacement, r^2 and the
//     cutoff test over the live chunks, four at a time with no branch
//     between them, and push the rows that pass into a per-warp ring in
//     shared memory (ballot, popc, the lane's rank); whenever it holds 32,
//     every lane takes one and runs the self test, the exclusion test and
//     the pair term;
//   - a warp-shuffle sum closes each row: every particle owns one slot, so
//     its force is written once, with no atomics;
//   - per-block (e_lj, e_ew) partials, already halved, summed in a fixed
//     order by the wrapper. Every sum has a fixed order, so two calls on
//     the same inputs give the same bits.
// A replica batch (replica batching, parallel/replicas.py): B replicas of
// one topology in one box, each with its own positions and column list of
// local ids, run in one launch of each kernel. The lists' (B, XY, ...)
// rows read as B * XY columns, so a block's global column indexes the
// buckets, the halo, the hull, the flags and the energy partials as one
// replica's column does; the batched instantiations (kBatch) offset only
// the per-particle rows (positions, anchors, the (N, 4) table, forces) by
// the column's replica. Types, exclusions and charges are shared, and one
// visit window W serves the batch. The one-replica launches run the
// kBatch = false instantiations, the unbatched kernels' code.
// A row range (atom sharding by rows, parallel/shard.py): row0 and row_end
// keep the i rows whose particle id is in [row0, row_end) (within each
// replica of a batch). A block whose i-block holds no such id returns
// before it stages its visited blocks, and within a block a warp runs no
// candidate step and writes no force for any other row: that row's force
// stays the caller's zero, and the energy partials are the range's share.
// An owned row is summed exactly as in the full launch, so the S ranges of
// a partition give the full launch's forces bit for bit. The full launch
// is the range [0, n).
// Registers: 4 blocks an SM in f32 (64 a thread), 2 in f64, no spill.
// Shared memory is W * 128 staged rows (25 KB at W = 8 in f32, 42 KB in
// f64), raised past 48 KB with cudaFuncSetAttribute when the overflow
// retry grows W. The launches allocate nothing and do not synchronise;
// each returns cudaGetLastError(). The caller zeroes the forces.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_term.cuh"

namespace {

using namespace cavmd;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kIBlock = 16;   // slots of an i-block (the hull's unit)
constexpr int kJBlock = 128;  // slots of a j-block of the merged halo
constexpr int kChunks = kJBlock / 32;  // pruning chunks of a j-block
constexpr int kUnroll = 4;    // chunks tested between ring drains
constexpr int kRing = 256;    // per-warp ring: < 32 left + 4 chunks of 32
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float m_rint(float x) { return rintf(x); }
__device__ __forceinline__ double m_rint(double x) { return rint(x); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }
__device__ __forceinline__ float m_min(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double m_min(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float m_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double m_max(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float m_inf(float) { return __int_as_float(0x7f800000); }
__device__ __forceinline__ double m_inf(double) {
  return __longlong_as_double(0x7ff0000000000000LL);
}

// One coordinate of zcol_local_positions: la + (d - L rint(d / L)) with
// d = x - a, each step rounded as PyTorch rounds it.
template <typename T>
__device__ __forceinline__ T local_coord(T x, T a, T la, T L) {
  const T d = sub_rn(x, a);
  return add_rn(la, sub_rn(d, mul_rn(L, m_rint(div_rn(d, L)))));
}

// A particle's row of the local-coordinate table (N, 4): x, y, z, charge,
// one 16-byte access (f32) or two (f64).
__device__ __forceinline__ void store_row(float* loc, int id, float x, float y,
                                          float z, float q) {
  reinterpret_cast<float4*>(loc)[id] = make_float4(x, y, z, q);
}
__device__ __forceinline__ void store_row(double* loc, int id, double x,
                                          double y, double z, double q) {
  double2* row = reinterpret_cast<double2*>(loc) + 2 * (size_t)id;
  row[0] = make_double2(x, y);
  row[1] = make_double2(z, q);
}
__device__ __forceinline__ void load_row(const float* loc, int id, float& x,
                                         float& y, float& z, float& q) {
  const float4 v = reinterpret_cast<const float4*>(loc)[id];
  x = v.x;
  y = v.y;
  z = v.z;
  q = v.w;
}
__device__ __forceinline__ void load_row(const double* loc, int id, double& x,
                                         double& y, double& z, double& q) {
  const double2* row = reinterpret_cast<const double2*>(loc) + 2 * (size_t)id;
  const double2 a = row[0], b = row[1];
  x = a.x;
  y = a.y;
  z = b.x;
  q = b.y;
}

template <typename T>
__device__ __forceinline__ void warp_min_max(T& mn, T& mx, int width) {
  for (int off = width >> 1; off > 0; off >>= 1) {
    mn = m_min(mn, __shfl_xor_sync(kFull, mn, off));
    mx = m_max(mx, __shfl_xor_sync(kFull, mx, off));
  }
}

// Raise a kernel's dynamic shared memory limit when a launch needs more
// than the last one set, not on every launch (the overflow retry grows W
// and cap); the default 48 KB covers static and dynamic bytes together, so
// the first launch always sets it.
template <typename K>
cudaError_t raise_smem(K kernel, size_t bytes, size_t& raised_to) {
  if (bytes <= raised_to) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) raised_to = bytes;
  return err;
}

// ---------------------------------------------------------------- the hull

// Bytes of the hull kernel's dynamic shared memory: centre and half-length
// of the column's NIB i-blocks and NB j-blocks.
template <typename T>
size_t hull_smem_bytes(int cap) {
  return (size_t)2 * (cap / kIBlock + 9 * cap / kJBlock) * sizeof(T);
}

template <typename T, bool kBatch>
__global__ void __launch_bounds__(kThreads)
zcol_hull_kernel(const T* __restrict__ pos, const T* __restrict__ anchor,
                 const T* __restrict__ local_anchor, const T* __restrict__ box,
                 const T* __restrict__ charge, const int32_t* __restrict__ bucket,
                 const int32_t* __restrict__ halo, int n, int ncols, int cap,
                 int W, T rc, int32_t* __restrict__ hull,
                 bool* __restrict__ flags, T* __restrict__ loc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nib = cap / kIBlock;
  const int nb = 9 * cap / kJBlock;
  // block centres 0.5 (min + max) and half-lengths 0.5 (max - min) of the
  // live z of the real slots; an empty block has min +inf and max -inf, so
  // a half-length of -inf marks it
  T* s_ic = reinterpret_cast<T*>(smem_raw);
  T* s_ih = s_ic + nib;
  T* s_jc = s_ih + nib;
  T* s_jh = s_jc + nb;

  const int col = blockIdx.x;  // a batch's global column r * ncols + c
  if (kBatch) {  // the column's replica: its particles' rows
    const size_t r = col / ncols;
    pos += 3 * (size_t)n * r;
    anchor += 3 * (size_t)n * r;
    local_anchor += 3 * (size_t)n * r;
    loc += 4 * (size_t)n * r;
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T Lx = box[0], Ly = box[1], Lz = box[2];
  const T inf = m_inf(T(0));
  const T half = T(0.5);

  // i-blocks: two a warp, 16 lanes each (nib is a multiple of 8); each of
  // the column's particles also gets its row of the local-coordinate table
  // (every particle with a slot has one slot)
  const int32_t* brow = bucket + (size_t)col * cap;
  for (int p = warp; p < nib / 2; p += kWarps) {
    const int id = brow[32 * p + lane];
    T mn = inf, mx = -inf;
    if (id < n) {
      const size_t o = 3 * (size_t)id;
      const T z = local_coord(pos[o + 2], anchor[o + 2], local_anchor[o + 2], Lz);
      store_row(loc, id, local_coord(pos[o], anchor[o], local_anchor[o], Lx),
                local_coord(pos[o + 1], anchor[o + 1], local_anchor[o + 1], Ly),
                z, charge[id]);
      mn = mx = z;
    }
    warp_min_max(mn, mx, 16);
    if ((lane & 15) == 0) {
      const int ib = 2 * p + (lane >> 4);
      s_ic[ib] = mul_rn(half, add_rn(mn, mx));
      s_ih[ib] = mul_rn(half, sub_rn(mx, mn));
    }
  }
  // j-blocks: one a warp, 4 slots a lane, loads in flight together
  const int32_t* hrow = halo + (size_t)col * 9 * cap;
  for (int b = warp; b < nb; b += kWarps) {
    int id[kChunks];
#pragma unroll
    for (int q = 0; q < kChunks; ++q) id[q] = hrow[b * kJBlock + 32 * q + lane];
    T mn = inf, mx = -inf;
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      if (id[q] < n) {
        const size_t o = 3 * (size_t)id[q] + 2;
        const T z = local_coord(pos[o], anchor[o], local_anchor[o], Lz);
        mn = m_min(mn, z);
        mx = m_max(mx, z);
      }
    }
    warp_min_max(mn, mx, 32);
    if (lane == 0) {
      s_jc[b] = mul_rn(half, add_rn(mn, mx));
      s_jh[b] = mul_rn(half, sub_rn(mx, mn));
    }
  }
  __syncthreads();

  // one i-block a warp: the overlap bits 32 j-blocks at a time, by ballot,
  // folded into the first and last set bit and the largest internal gap
  // (its length g and the set bit p that ends it, the first on ties)
  const T half_Lz = mul_rn(half, Lz);
  int over = 0;
  for (int ib = warp; ib < nib; ib += kWarps) {
    const T ic = s_ic[ib], ih = s_ih[ib];
    int lo = -1, hi = -1, g = -1, p = 0;
    if (ih >= T(0)) {  // warp-uniform: the i-block holds a real slot
      for (int t0 = 0; t0 < nb; t0 += 32) {
        const int t = t0 + lane;
        bool ov = false;
        if (t < nb && s_jh[t] >= T(0)) {
          T d = sub_rn(ic, s_jc[t]);
          d = m_abs(sub_rn(d, mul_rn(Lz, m_rint(div_rn(d, Lz)))));
          const T thresh = add_rn(add_rn(ih, s_jh[t]), rc);
          ov = (d <= thresh) | (thresh >= half_Lz);
        }
        const unsigned word = __ballot_sync(kFull, ov);
        if (word) {
          const unsigned below = word & ((1u << lane) - 1u);
          const int prev = below ? t0 + 31 - __clz(below) : hi;
          const int gap = ov && prev >= 0 ? t - prev - 1 : -1;
          const int wmax = __reduce_max_sync(kFull, gap);
          if (wmax > g) {
            g = wmax;
            p = t0 + __ffs(__ballot_sync(kFull, gap == wmax)) - 1;
          }
          if (lo < 0) lo = t0 + __ffs(word) - 1;
          hi = t0 + 31 - __clz(word);
        }
      }
    }
    const bool any = lo >= 0;
    const bool split = g > 0;  // only with a set bit
    const int c1 = any ? (split ? p - g - 1 : hi) - lo + 1 : 0;
    const int c2 = split ? hi - p + 1 : 0;
    if (lane == 0)
      reinterpret_cast<int4*>(hull)[(size_t)col * nib + ib] =
          make_int4(any ? lo : nb, c1, split ? p : nb, c1 + c2);
    over |= c1 + c2 > W;
  }
  over = __syncthreads_or(over);
  if (threadIdx.x == 0) flags[col] = over != 0;
}

// --------------------------------------------------------------- the pairs

// Bytes of the pair kernel's dynamic shared memory: W * 128 staged rows,
// 4 W chunks (centre, reach, first row, rows), then W visited block ids, W
// occupancies and W + 1 offsets.
template <typename T>
size_t pair_smem_bytes(int W) {
  return (size_t)W * kJBlock * (4 * sizeof(T) + 2 * sizeof(int32_t)) +
         (size_t)W * kChunks * (2 * sizeof(T) + 2 * sizeof(int32_t)) +
         (size_t)(3 * W + 1) * sizeof(int32_t);
}

template <typename T, bool kBatch>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 4 : 2)
zcol_pair_kernel(const T* __restrict__ loc, const T* __restrict__ box,
                 const int32_t* __restrict__ type_id, const T* __restrict__ eps_t,
                 const T* __restrict__ sig2_t, const T* __restrict__ rcut2_t,
                 const T* __restrict__ vshift_t, int ntypes,
                 const int32_t* __restrict__ bucket,
                 const int32_t* __restrict__ halo, const int32_t* __restrict__ hull,
                 const int32_t* __restrict__ excl, int max_excl, int n,
                 int ncols, int cap, int W, T rc, T rc2, T kappa, int row0,
                 int row_end, T* __restrict__ forces,
                 T* __restrict__ e_partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = W * kJBlock;
  const int nchunk = W * kChunks;
  T* sx = reinterpret_cast<T*>(smem_raw);
  T* sy = sx + rows;
  T* sz = sy + rows;
  T* sq = sz + rows;
  T* s_cc = sq + rows;            // chunk z centres
  T* s_reach = s_cc + nchunk;     // half-length + r_cut + margin; -1 empty
  int32_t* sid = reinterpret_cast<int32_t*>(s_reach + nchunk);
  int32_t* stype = sid + rows;
  int32_t* s_cbase = stype + rows;  // chunk's first staged row
  int32_t* s_cn = s_cbase + nchunk;   // chunk's staged rows (0-32)
  int32_t* s_jb = s_cn + nchunk;      // W visited block ids
  int32_t* s_occ = s_jb + W;          // W real rows a visited block
  int32_t* s_off = s_occ + W;         // W + 1 staged-row offsets

  __shared__ T s_eps[kMaxTypes * kMaxTypes];
  __shared__ T s_sig2[kMaxTypes * kMaxTypes];
  __shared__ T s_rc2[kMaxTypes * kMaxTypes];
  __shared__ T s_vsh[kMaxTypes * kMaxTypes];
  __shared__ uint16_t s_ring[kWarps][kRing];  // staged rows < W 128 <= 2^16
  __shared__ T s_red[kWarps][2];

  const int nib = cap / kIBlock;
  const int col = blockIdx.x / nib;
  const int ib = blockIdx.x - col * nib;
  const int4 h = reinterpret_cast<const int4*>(hull)[blockIdx.x];
  const int s1 = h.x, c1 = h.y, s2 = h.z;
  const int nv = min(h.w, W);
  const int32_t* irow = bucket + (size_t)col * cap + ib * kIBlock;
  bool owns = true;  // the i-block holds a row of the range (block-uniform)
  if (c1 > 0 && (row0 > 0 || row_end < n)) {
    const int id = threadIdx.x < kIBlock ? irow[threadIdx.x] : -1;
    owns = __syncthreads_or(id >= row0 && id < row_end) != 0;
  }
  // block-uniform: no real slot, nothing in reach, or no row of the range
  if (c1 <= 0 || !owns) {
    if (threadIdx.x == 0) {
      e_partial[2 * (size_t)blockIdx.x] = T(0);
      e_partial[2 * (size_t)blockIdx.x + 1] = T(0);
    }
    return;
  }
  if (kBatch) {  // the column's replica: its table rows and forces
    const size_t r = col / ncols;
    loc += 4 * (size_t)n * r;
    forces += 3 * (size_t)n * r;
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int32_t* hrow = halo + (size_t)col * 9 * cap;
  for (int t = threadIdx.x; t < ntypes * ntypes; t += blockDim.x) {
    s_eps[t] = eps_t[t];
    s_sig2[t] = sig2_t[t];
    s_rc2[t] = rcut2_t[t];
    s_vsh[t] = vshift_t[t];
  }
  // real rows of each visited block, a warp a block: the halo's real slots
  // are a prefix of the row, so a block's are a prefix of the block
  for (int t = warp; t < nv; t += kWarps) {
    const int jb = t < c1 ? s1 + t : s2 + (t - c1);
    int id[kChunks];
#pragma unroll
    for (int q = 0; q < kChunks; ++q) id[q] = hrow[jb * kJBlock + 32 * q + lane];
    int occ = 0;
#pragma unroll
    for (int q = 0; q < kChunks; ++q) occ += __popc(__ballot_sync(kFull, id[q] < n));
    if (lane == 0) {
      s_jb[t] = jb;
      s_occ[t] = occ;
    }
  }
  __syncthreads();
  // staging offsets: an exclusive scan of the occupancies, 32 at a time
  if (warp == 0) {
    int carry = 0;
    for (int t0 = 0; t0 < nv; t0 += 32) {
      const int t = t0 + lane;
      const int v = t < nv ? s_occ[t] : 0;
      int incl = v;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += u;
      }
      if (t < nv) s_off[t] = carry + incl - v;
      carry += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) s_off[nv] = carry;
  }
  __syncthreads();

  // stage the visited blocks' real rows, a chunk of 32 a warp at a time,
  // two chunks' loads in flight together: each row from the hull kernel's
  // local-coordinate table, and each chunk's z centre and reach
  const T Lx = box[0], Ly = box[1], Lz = box[2];
  const T margin = Lz * T(1.0 / 4096);
  const T inf = m_inf(T(0));
  const int nitems = nv * kChunks;
  for (int k0 = warp; k0 < nitems; k0 += 2 * kWarps) {
    int id[2], cnt[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = k0 + u * kWarps;
      const int t = k / kChunks;
      const int r = (k - t * kChunks) * 32;
      cnt[u] = k < nitems ? min(32, max(0, s_occ[t] - r)) : 0;
      id[u] = lane < cnt[u] ? hrow[s_jb[t] * kJBlock + r + lane] : 0;
    }
    T x[2], y[2], z[2], q[2];
    int ty[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      x[u] = y[u] = z[u] = q[u] = T(0);
      ty[u] = 0;
      if (lane < cnt[u]) {
        load_row(loc, id[u], x[u], y[u], z[u], q[u]);
        ty[u] = type_id[id[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = k0 + u * kWarps;
      if (k >= nitems) break;  // warp-uniform
      const int t = k / kChunks;
      const int r = (k - t * kChunks) * 32;
      T mn = inf, mx = -inf;
      if (lane < cnt[u]) {
        const int d = s_off[t] + r + lane;
        sx[d] = x[u];
        sy[d] = y[u];
        sz[d] = z[u];
        sq[d] = q[u];
        sid[d] = id[u];
        stype[d] = ty[u];
        mn = mx = z[u];
      }
      warp_min_max(mn, mx, 32);
      if (lane == 0) {
        s_cbase[k] = s_off[t] + r;
        s_cn[k] = cnt[u];
        s_cc[k] = T(0.5) * (mn + mx);
        s_reach[k] = cnt[u] > 0 ? T(0.5) * (mx - mn) + rc + margin : T(-1);
      }
    }
  }
  __syncthreads();

  const T iLx = T(1) / Lx, iLy = T(1) / Ly, iLz = T(1) / Lz;
  const unsigned below = (1u << lane) - 1u;
  uint16_t* ring = s_ring[warp];
  T e_lj = 0, e_ew = 0;

  for (int i = warp; i < kIBlock; i += kWarps) {  // warp-uniform
    const int idi = irow[i];
    if (idi >= n) break;  // a column's real slots are a prefix
    // a row outside [row0, row_end) takes no candidate step and writes no
    // force: its loop below is empty
    const int nit = idi >= row0 && idi < row_end ? nitems : 0;
    T xi, yi, zi, qi;
    load_row(loc, idi, xi, yi, zi, qi);
    const int ti = type_id[idi] * ntypes;
    int ex[kMaxExcl];
#pragma unroll
    for (int e = 0; e < kMaxExcl; ++e)
      ex[e] = e < max_excl ? excl[(size_t)idi * max_excl + e] : -1;
    T fx = 0, fy = 0, fz = 0;
    int head = 0, queued = 0;  // warp-uniform ring state

    // one loop, warp-uniform: drain the ring whenever it holds 32 (and at
    // the row's end), else test the next live chunks, else vote on the next
    // 32 chunks
    unsigned live = 0;
    for (int k0 = -32;;) {
      if (queued >= 32 || (queued > 0 && live == 0 && k0 + 32 >= nit)) {
        // take 32 queued rows (or the last few): self and exclusion tests,
        // then the pair term into this lane's accumulators (the
        // displacement as in the cutoff test, bit for bit)
        const int take = queued < 32 ? queued : 32;
        __syncwarp();
        if (lane < take) {
          const int j = ring[(head + lane) & (kRing - 1)];
          const int idj = sid[j];
          bool skip = idj == idi;
#pragma unroll
          for (int e = 0; e < kMaxExcl; ++e) skip |= ex[e] == idj;
          if (!skip) {
            const T dx = min_image(sub_rn(xi, sx[j]), Lx, iLx);
            const T dy = min_image(sub_rn(yi, sy[j]), Ly, iLy);
            const T dz = min_image(sub_rn(zi, sz[j]), Lz, iLz);
            const T f = lj_ewald_pair(norm2(dx, dy, dz), ti + stype[j],
                                      qi * sq[j], s_eps, s_sig2, s_rc2, s_vsh,
                                      kappa, 1, 1, e_lj, e_ew);
            fx += f * dx;
            fy += f * dy;
            fz += f * dz;
          }
        }
        head = (head + take) & (kRing - 1);
        queued -= take;
        __syncwarp();  // the slots just taken are free for the next pushes
        continue;
      }
      if (live == 0) {
        // the next 32 chunks within reach of row i in z, a lane a chunk
        k0 += 32;
        if (k0 >= nit) break;
        const int k = k0 + lane;
        live = __ballot_sync(
            kFull, k < nit && m_abs(min_image(sub_rn(zi, s_cc[k]), Lz, iLz)) <=
                                 s_reach[k]);
        continue;
      }
      // kUnroll live chunks: first every chunk's cutoff test, branch-free
      // (a lane past a chunk's rows reads its first row and is never near),
      // then the votes. Every lane writes a slot: the near ones the next
      // `hits` slots in lane order, the others the free slots after them.
      int base[kUnroll], cnt[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        base[u] = 0;
        cnt[u] = 0;
        if (live) {
          const int kk = k0 + __ffs(live) - 1;
          live &= live - 1;
          base[u] = s_cbase[kk];
          cnt[u] = s_cn[kk];
        }
      }
      bool near[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base[u] + (lane < cnt[u] ? lane : 0);
        const T dx = min_image(sub_rn(xi, sx[j]), Lx, iLx);
        const T dy = min_image(sub_rn(yi, sy[j]), Ly, iLy);
        const T dz = min_image(sub_rn(zi, sz[j]), Lz, iLz);
        near[u] = (norm2(dx, dy, dz) < rc2) & (lane < cnt[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned hits = __ballot_sync(kFull, near[u]);
        const int rank = __popc(hits & below);
        const int total = __popc(hits);
        const int slot = near[u] ? rank : total + lane - rank;
        ring[(head + queued + slot) & (kRing - 1)] = base[u] + lane;
        queued += total;
      }
    }
    fx = warp_sum(fx);
    fy = warp_sum(fy);
    fz = warp_sum(fz);
    if (lane == 0 && nit > 0) {
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
    // every pair is met from both ends: halve here (exact), so the
    // wrapper's sum of the partials is the energy
    e_partial[2 * (size_t)blockIdx.x] = T(0.5) * a;
    e_partial[2 * (size_t)blockIdx.x + 1] = T(0.5) * b;
  }
}

bool geometry_ok(int n, int ncols, int cap, int W) {
  return n >= 1 && ncols >= 1 && cap >= kJBlock && cap % kJBlock == 0 &&
         W >= 1 && W <= 9 * cap / kJBlock && W * kJBlock <= 65536;
}

// nb replicas: the batched instantiations for nb > 1 (ncols * nb global
// columns), the one-replica kernels for nb = 1. Each instantiation keeps
// its own raised shared-memory limit.
template <typename T, bool kBatch>
int launch_hull(const void* pos, const void* anchor, const void* local_anchor,
                const void* box, const void* charge, const void* bucket,
                const void* halo, int n, int ncols, int cap, int W, double rc,
                int nb, void* hull, void* flags, void* loc, void* stream) {
  static size_t raised_to = 0;
  const size_t smem = hull_smem_bytes<T>(cap);
  const cudaError_t err =
      raise_smem(zcol_hull_kernel<T, kBatch>, smem, raised_to);
  if (err != cudaSuccess) return (int)err;
  zcol_hull_kernel<T, kBatch><<<ncols * nb, kThreads, smem,
                                (cudaStream_t)stream>>>(
      (const T*)pos, (const T*)anchor, (const T*)local_anchor, (const T*)box,
      (const T*)charge, (const int32_t*)bucket, (const int32_t*)halo, n, ncols,
      cap, W, (T)rc, (int32_t*)hull, (bool*)flags, (T*)loc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hull_any(const void* pos, const void* anchor,
                    const void* local_anchor, const void* box,
                    const void* charge, const void* bucket, const void* halo,
                    int n, int ncols, int cap, int W, double rc, int nb,
                    void* hull, void* flags, void* loc, void* stream) {
  if (!geometry_ok(n, ncols, cap, W) || nb < 1 ||
      (long long)ncols * nb > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  auto go = nb > 1 ? launch_hull<T, true> : launch_hull<T, false>;
  return go(pos, anchor, local_anchor, box, charge, bucket, halo, n, ncols,
            cap, W, rc, nb, hull, flags, loc, stream);
}

template <typename T, bool kBatch>
int launch_pair(const void* loc, const void* box, const void* type_id,
                const void* eps, const void* sig2, const void* rcut2,
                const void* vshift, int ntypes, const void* bucket,
                const void* halo, const void* hull, const void* excl,
                int max_excl, int n, int ncols, int cap, int W, double rc,
                double rc2, double kappa, int row0, int row_end, int nb,
                void* forces, void* e_partial, void* stream) {
  static size_t raised_to = 0;
  const size_t smem = pair_smem_bytes<T>(W);
  const cudaError_t err =
      raise_smem(zcol_pair_kernel<T, kBatch>, smem, raised_to);
  if (err != cudaSuccess) return (int)err;
  const int blocks = ncols * (cap / kIBlock) * nb;
  zcol_pair_kernel<T, kBatch><<<blocks, kThreads, smem,
                                (cudaStream_t)stream>>>(
      (const T*)loc, (const T*)box, (const int32_t*)type_id, (const T*)eps,
      (const T*)sig2, (const T*)rcut2, (const T*)vshift, ntypes,
      (const int32_t*)bucket, (const int32_t*)halo, (const int32_t*)hull,
      (const int32_t*)excl, max_excl, n, ncols, cap, W, (T)rc, (T)rc2,
      (T)kappa, row0, row_end, (T*)forces, (T*)e_partial);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pair_any(const void* loc, const void* box, const void* type_id,
                    const void* eps, const void* sig2, const void* rcut2,
                    const void* vshift, int ntypes, const void* bucket,
                    const void* halo, const void* hull, const void* excl,
                    int max_excl, int n, int ncols, int cap, int W, double rc,
                    double rc2, double kappa, int row0, int row_end, int nb,
                    void* forces, void* e_partial, void* stream) {
  if (ntypes < 1 || ntypes > kMaxTypes || max_excl < 1 || max_excl > kMaxExcl ||
      !geometry_ok(n, ncols, cap, W) || nb < 1 || row0 < 0 ||
      row_end <= row0 || row_end > n ||
      (long long)ncols * (cap / kIBlock) * nb > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  auto go = nb > 1 ? launch_pair<T, true> : launch_pair<T, false>;
  return go(loc, box, type_id, eps, sig2, rcut2, vshift, ntypes, bucket, halo,
            hull, excl, max_excl, n, ncols, cap, W, rc, rc2, kappa, row0,
            row_end, nb, forces, e_partial, stream);
}

}  // namespace

extern "C" {

int cavmd_zcol_hull_f32(const void* pos, const void* anchor,
                        const void* local_anchor, const void* box,
                        const void* charge, const void* bucket,
                        const void* halo, int n, int ncols, int cap, int W,
                        double rc, int nb, void* hull, void* flags, void* loc,
                        void* stream) {
  return launch_hull_any<float>(pos, anchor, local_anchor, box, charge, bucket,
                                halo, n, ncols, cap, W, rc, nb, hull, flags,
                                loc, stream);
}

int cavmd_zcol_hull_f64(const void* pos, const void* anchor,
                        const void* local_anchor, const void* box,
                        const void* charge, const void* bucket,
                        const void* halo, int n, int ncols, int cap, int W,
                        double rc, int nb, void* hull, void* flags, void* loc,
                        void* stream) {
  return launch_hull_any<double>(pos, anchor, local_anchor, box, charge,
                                 bucket, halo, n, ncols, cap, W, rc, nb, hull,
                                 flags, loc, stream);
}

int cavmd_zcol_pair_f32(const void* loc, const void* box, const void* type_id,
                        const void* eps, const void* sig2, const void* rcut2,
                        const void* vshift, int ntypes, const void* bucket,
                        const void* halo, const void* hull, const void* excl,
                        int max_excl, int n, int ncols, int cap, int W,
                        double rc, double rc2, double kappa, int row0,
                        int row_end, int nb, void* forces, void* e_partial,
                        void* stream) {
  return launch_pair_any<float>(loc, box, type_id, eps, sig2, rcut2, vshift,
                                ntypes, bucket, halo, hull, excl, max_excl, n,
                                ncols, cap, W, rc, rc2, kappa, row0, row_end,
                                nb, forces, e_partial, stream);
}

int cavmd_zcol_pair_f64(const void* loc, const void* box, const void* type_id,
                        const void* eps, const void* sig2, const void* rcut2,
                        const void* vshift, int ntypes, const void* bucket,
                        const void* halo, const void* hull, const void* excl,
                        int max_excl, int n, int ncols, int cap, int W,
                        double rc, double rc2, double kappa, int row0,
                        int row_end, int nb, void* forces, void* e_partial,
                        void* stream) {
  return launch_pair_any<double>(loc, box, type_id, eps, sig2, rcut2, vshift,
                                 ntypes, bucket, halo, hull, excl, max_excl, n,
                                 ncols, cap, W, rc, rc2, kappa, row0, row_end,
                                 nb, forces, e_partial, stream);
}

}  // extern "C"
