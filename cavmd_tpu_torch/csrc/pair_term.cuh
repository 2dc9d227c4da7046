// The pair term shared by the pair passes (pair.cu, cell_pair.cu,
// zcol_pair.cu): shifted LJ from (T, T) tables and short-range Ewald with
// true erfc, as the XLA functions cavmd_tpu/ops/lj.py:fused_pair_force and
// cavmd_tpu/ops/neighbor.py:cell_pair_force compute them (not the A&S erfc
// of the Pallas bodies); the minimum image and r^2 every pass takes; the
// warp sum that closes each i row; and the precision overloads of the math
// functions.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cavmd {

constexpr int kMaxTypes = 8;
constexpr int kMaxExcl = 8;

__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_erfc(float x) { return erfcf(x); }
__device__ __forceinline__ double m_erfc(double x) { return erfc(x); }
__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }

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
// (two adds at the full FP32 rate, where rint is a conversion at 1/8 of it
// and d / L a divide), and L k is taken in the fma. For a pair inside the
// cutoff |d/L - k| < r_cut/L < 1/2, so a quotient 1-2 ulp off cannot cross
// a half-integer: the rounding gives the twins' k (round half to even, as
// rint and torch.round), and L k is exact for |k| <= 2, so the result
// equals the twins' d - L rint(d / L) bit for bit. A pair far from the
// cutoff may round the other way near d = L/2, and stays outside it. (This
// needs L > 2 r_cut per axis, which the minimum image needs anyway.)
template <typename T>
__device__ __forceinline__ T min_image(T d, T L, T inv_L) {
  const T M = round_magic(T(0));
  const T k = sub_rn(fma_rn(d, inv_L, M), M);
  return fma_rn(-L, k, d);
}

// r^2 as the twins form it: (dx^2 + dy^2) + dz^2, each step rounded, so a
// cutoff test decides as the twin's does.
template <typename T>
__device__ __forceinline__ T norm2(T dx, T dy, T dz) {
  return add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Force over r of one pair, adding its energies to e_lj and e_ew. tt =
// type_i * ntypes + type_j indexes the (T, T) tables; LJ counts when lj_on,
// eps != 0 and r2 is inside the type pair's cutoff, Ewald short when
// coul_on and q_i q_j != 0. The caller applies the pass's own cutoff (the
// cell passes: the cell cutoff; the dense pass: the Coulomb cutoff, in
// coul_on).
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
