// Dense all-pairs shifted-LJ + short-range Ewald (erfc) pair pass.
//
// Replaces the TPU kernel cavmd_tpu/ops/pallas_kernels.py:_pair_kernel
// (wrapper make_fused_pair_pallas); semantics are those of the XLA function
// cavmd_tpu/ops/lj.py:fused_pair_force, not of the Pallas body:
//   - true erfc/erfcf (the Pallas body used the A&S rational approximation);
//   - minimum image with rint/rintf, round half to even like jnp.round;
//   - masked pairs are skipped, never divided by r^2 = 0.
//
// What bounds it on an H100: at the reference size (N = 501) the pass is
// ~250k pairs, ~40 flops each plus one erfc and one exp — microseconds of
// SM time, so launch latency and occupancy bound it, not bandwidth or math.
// Design:
//   - one warp per i row, lanes striding over j, so N = 501 rows give 126
//     blocks of 4 warps (about one per SM) instead of the 4 blocks that one
//     thread per row would give;
//   - each row sums over all j with no Newton-3 scatter, so forces need no
//     atomics and are deterministic;
//   - per-pair parameters come from (T, T) type tables in shared memory and
//     two (N, N) uint8 masks: 2 B/pair instead of the Pallas layout's seven
//     padded f32 N^2 tables (28 B/pair); the mask reads are coalesced
//     across the warp;
//   - energies leave as per-block partials (block-ordered sums), summed by
//     one deterministic torch.sum in the wrapper.
// The launch allocates nothing and does not synchronise; it returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxTypes = 8;

__device__ __forceinline__ float m_rint(float x) { return rintf(x); }
__device__ __forceinline__ double m_rint(double x) { return rint(x); }
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_erfc(float x) { return erfcf(x); }
__device__ __forceinline__ double m_erfc(double x) { return erfc(x); }
__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
dense_pair_kernel(const T* __restrict__ pos, const T* __restrict__ box,
                  const int32_t* __restrict__ type_id,
                  const T* __restrict__ eps_t, const T* __restrict__ sig2_t,
                  const T* __restrict__ rcut2_t, const T* __restrict__ vshift_t,
                  int ntypes, const T* __restrict__ charge,
                  const uint8_t* __restrict__ lj_active,
                  const uint8_t* __restrict__ coul_active, int n, T kappa,
                  T coul_rc2, T* __restrict__ forces,
                  T* __restrict__ e_partial) {
  __shared__ T s_eps[kMaxTypes * kMaxTypes];
  __shared__ T s_sig2[kMaxTypes * kMaxTypes];
  __shared__ T s_rc2[kMaxTypes * kMaxTypes];
  __shared__ T s_vsh[kMaxTypes * kMaxTypes];
  __shared__ T s_red[kWarpsPerBlock][2];

  for (int t = threadIdx.x; t < ntypes * ntypes; t += blockDim.x) {
    s_eps[t] = eps_t[t];
    s_sig2[t] = sig2_t[t];
    s_rc2[t] = rcut2_t[t];
    s_vsh[t] = vshift_t[t];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerBlock + warp;  // warp-uniform

  const T two_over_sqrt_pi = T(1.1283791670955126);
  T fx = 0, fy = 0, fz = 0, e_lj = 0, e_ew = 0;
  if (i < n) {
    const T Lx = box[0], Ly = box[1], Lz = box[2];
    const T xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
    const T qi = charge[i];
    const int ti = type_id[i] * ntypes;
    const uint8_t* la = lj_active + (size_t)i * n;
    const uint8_t* ca = coul_active + (size_t)i * n;
    for (int j = lane; j < n; j += 32) {
      const bool lj = la[j] != 0;
      const bool cw = ca[j] != 0;
      if (!(lj || cw)) continue;
      T dx = xi - pos[3 * j];
      T dy = yi - pos[3 * j + 1];
      T dz = zi - pos[3 * j + 2];
      dx = dx - Lx * m_rint(dx / Lx);
      dy = dy - Ly * m_rint(dy / Ly);
      dz = dz - Lz * m_rint(dz / Lz);
      const T r2 = dx * dx + dy * dy + dz * dz;
      T f = 0;
      if (lj) {
        const int tt = ti + type_id[j];
        if (r2 < s_rc2[tt]) {
          const T eps = s_eps[tt];
          const T inv = s_sig2[tt] / r2;
          const T s6 = inv * inv * inv;
          const T s12 = s6 * s6;
          e_lj += T(4) * eps * (s12 - s6) - s_vsh[tt];
          f += T(24) * eps * (T(2) * s12 - s6) / r2;
        }
      }
      if (cw && r2 < coul_rc2) {
        const T r = m_sqrt(r2);
        const T kr = kappa * r;
        const T ec = m_erfc(kr);
        const T qq = qi * charge[j];
        e_ew += qq * ec / r;
        f += qq * (ec / r2 + kappa * two_over_sqrt_pi * m_exp(-(kr * kr)) / r) / r;
      }
      fx += f * dx;
      fy += f * dy;
      fz += f * dz;
    }
  }
  fx = warp_sum(fx);
  fy = warp_sum(fy);
  fz = warp_sum(fz);
  e_lj = warp_sum(e_lj);
  e_ew = warp_sum(e_ew);
  if (lane == 0) {
    if (i < n) {
      forces[3 * i] = fx;
      forces[3 * i + 1] = fy;
      forces[3 * i + 2] = fz;
    }
    s_red[warp][0] = e_lj;
    s_red[warp][1] = e_ew;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T a = 0, b = 0;
    for (int w = 0; w < kWarpsPerBlock; ++w) {
      a += s_red[w][0];
      b += s_red[w][1];
    }
    e_partial[2 * blockIdx.x] = a;
    e_partial[2 * blockIdx.x + 1] = b;
  }
}

template <typename T>
int launch(const void* pos, const void* box, const void* type_id,
           const void* eps, const void* sig2, const void* rcut2,
           const void* vshift, int ntypes, const void* charge,
           const void* lj_active, const void* coul_active, int n,
           double kappa, double coul_rc2, void* forces, void* e_partial,
           void* stream) {
  if (ntypes < 1 || ntypes > kMaxTypes || n < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  dense_pair_kernel<T><<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      (const T*)pos, (const T*)box, (const int32_t*)type_id, (const T*)eps,
      (const T*)sig2, (const T*)rcut2, (const T*)vshift, ntypes,
      (const T*)charge, (const uint8_t*)lj_active, (const uint8_t*)coul_active,
      n, (T)kappa, (T)coul_rc2, (T*)forces, (T*)e_partial);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cavmd_dense_pair_blocks(int n) { return (n + kWarpsPerBlock - 1) / kWarpsPerBlock; }

int cavmd_dense_pair_f32(const void* pos, const void* box, const void* type_id,
                         const void* eps, const void* sig2, const void* rcut2,
                         const void* vshift, int ntypes, const void* charge,
                         const void* lj_active, const void* coul_active, int n,
                         double kappa, double coul_rc2, void* forces,
                         void* e_partial, void* stream) {
  return launch<float>(pos, box, type_id, eps, sig2, rcut2, vshift, ntypes,
                       charge, lj_active, coul_active, n, kappa, coul_rc2,
                       forces, e_partial, stream);
}

int cavmd_dense_pair_f64(const void* pos, const void* box, const void* type_id,
                         const void* eps, const void* sig2, const void* rcut2,
                         const void* vshift, int ntypes, const void* charge,
                         const void* lj_active, const void* coul_active, int n,
                         double kappa, double coul_rc2, void* forces,
                         void* e_partial, void* stream) {
  return launch<double>(pos, box, type_id, eps, sig2, rcut2, vshift, ntypes,
                        charge, lj_active, coul_active, n, kappa, coul_rc2,
                        forces, e_partial, stream);
}

}  // extern "C"
