// The pair term shared by the cell-list pair passes (cell_pair.cu,
// zcol_pair.cu): shifted LJ from (T, T) tables and short-range Ewald with
// true erfc, as the XLA tile path cavmd_tpu/ops/neighbor.py:cell_pair_force
// with make_fused_cell_kernel computes them (not the A&S erfc of the Pallas
// bodies), plus the warp sum that closes each i row and the precision
// overloads of the math functions.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cavmd {

constexpr int kMaxTypes = 8;
constexpr int kMaxExcl = 8;

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

// Force over r of one pair inside the cell cutoff (r2 < rc2, not self, not
// excluded), adding its energies to e_lj and e_ew. tt = type_i * ntypes +
// type_j indexes the (T, T) tables; LJ counts when eps != 0 and r2 is
// inside the type pair's cutoff, Ewald short when q_i q_j != 0.
template <typename T>
__device__ __forceinline__ T lj_ewald_pair(T r2, int tt, T qq, const T* eps_t,
                                           const T* sig2_t, const T* rc2_t,
                                           const T* vsh_t, T kappa, int lj_on,
                                           int coul_on, T& e_lj, T& e_ew) {
  const T two_over_sqrt_pi = T(1.1283791670955126);
  T f = 0;
  if (lj_on) {
    const T eps = eps_t[tt];
    if (eps != T(0) && r2 < rc2_t[tt]) {
      const T inv = sig2_t[tt] / r2;
      const T s6 = inv * inv * inv;
      const T s12 = s6 * s6;
      e_lj += T(4) * eps * (s12 - s6) - vsh_t[tt];
      f += T(24) * eps * (T(2) * s12 - s6) / r2;
    }
  }
  if (coul_on && qq != T(0)) {
    const T r = m_sqrt(r2);
    const T kr = kappa * r;
    const T ec = m_erfc(kr);
    e_ew += qq * ec / r;
    f += qq * (ec / r2 + kappa * two_over_sqrt_pi * m_exp(-(kr * kr)) / r) / r;
  }
  return f;
}

}  // namespace cavmd
