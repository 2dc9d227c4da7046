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
// What bounds them on an H100: N p^3 grid updates (N = 501, p = 6: 108k)
// against a 128 KB (32^3 f32) grid that sits in L2 — the spread is bound
// by atomic throughput on a few hot cache lines, the interpolation by
// p^3 gathered L2 reads per particle; both run in microseconds, so launch
// latency dominates at the reference size.
// Design: one thread per particle evaluates its three order-p weight rows
// in registers (no (N, K) stencil matrices, no Khatri-Rao factor — the
// TPU's MXU layout has no purpose here) and then
//   - spread: atomicAdds its p^3 charge shares into the grid. Particles
//     with q = 0 (the photon) add nothing and return at once. The f32
//     atomicAdd order is not deterministic, so f32 grids differ from run
//     to run by rounding (relative ~1e-7 of the grid scale); f64 uses the
//     native atomicAdd(double).
//   - interpolate: reads the p^3 grid-cotangent values and writes
//     dE/dr_d = (K_d / L_d) q sum ct M'_p(d) M_p(others) — no atomics,
//     deterministic.
// The launches allocate nothing (the wrapper zeroes the grid) and do not
// synchronise; each returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kMaxOrder = 8;
constexpr int kThreads = 128;

__device__ __forceinline__ float m_floor(float x) { return floorf(x); }
__device__ __forceinline__ double m_floor(double x) { return floor(x); }

// Weights w[j] = M_p(frac + j) and derivatives dw[j] = M_p'(frac + j),
// j = 0..order-1, and the wrapped grid columns col[j] for one axis.
template <typename T>
__device__ __forceinline__ void axis_stencil(T r, T L, int K, int order,
                                             T* w, T* dw, int* col) {
  const T u = (r / L + T(0.5)) * T(K);
  const T k0 = m_floor(u);
  const T frac = u - k0;
  const int base = (int)k0;
  T prev[kMaxOrder];
#pragma unroll
  for (int j = 0; j < kMaxOrder; ++j) {
    w[j] = (j == 0) ? T(1) : T(0);
    prev[j] = T(0);
  }
  for (int n = 2; n <= order; ++n) {
    if (n == order) {
#pragma unroll
      for (int j = 0; j < kMaxOrder; ++j) prev[j] = w[j];
    }
    // descending j keeps w[j - 1] at the previous level while w[j] updates
#pragma unroll
    for (int j = kMaxOrder - 1; j >= 0; --j) {
      if (j < order) {
        const T x = frac + T(j);
        const T shifted = (j > 0) ? w[j - 1] : T(0);
        w[j] = (x * w[j] + (T(n) - x) * shifted) / T(n - 1);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxOrder; ++j) {
    if (j < order) {
      dw[j] = prev[j] - ((j > 0) ? prev[j - 1] : T(0));
      int c = (base - j) % K;
      col[j] = c < 0 ? c + K : c;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
spread_kernel(const T* __restrict__ pos, const T* __restrict__ charge,
              const T* __restrict__ box, int n, int order, int Kx, int Ky,
              int Kz, T* __restrict__ grid) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T q = charge[i];
  if (q == T(0)) return;
  T wx[kMaxOrder], wy[kMaxOrder], wz[kMaxOrder], d[kMaxOrder];
  int cx[kMaxOrder], cy[kMaxOrder], cz[kMaxOrder];
  axis_stencil<T>(pos[3 * i], box[0], Kx, order, wx, d, cx);
  axis_stencil<T>(pos[3 * i + 1], box[1], Ky, order, wy, d, cy);
  axis_stencil<T>(pos[3 * i + 2], box[2], Kz, order, wz, d, cz);
  for (int a = 0; a < order; ++a) {
    const T qa = q * wx[a];
    T* plane = grid + (size_t)cx[a] * Ky * Kz;
    for (int b = 0; b < order; ++b) {
      T* row = plane + (size_t)cy[b] * Kz;
      for (int c = 0; c < order; ++c) atomicAdd(row + cz[c], qa * (wy[b] * wz[c]));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
interpolate_kernel(const T* __restrict__ ct, const T* __restrict__ pos,
                   const T* __restrict__ charge, const T* __restrict__ box,
                   int n, int order, int Kx, int Ky, int Kz,
                   T* __restrict__ dpos) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T q = charge[i];
  if (q == T(0)) {
    dpos[3 * i] = T(0);
    dpos[3 * i + 1] = T(0);
    dpos[3 * i + 2] = T(0);
    return;
  }
  T wx[kMaxOrder], wy[kMaxOrder], wz[kMaxOrder];
  T dx[kMaxOrder], dy[kMaxOrder], dz[kMaxOrder];
  int cx[kMaxOrder], cy[kMaxOrder], cz[kMaxOrder];
  axis_stencil<T>(pos[3 * i], box[0], Kx, order, wx, dx, cx);
  axis_stencil<T>(pos[3 * i + 1], box[1], Ky, order, wy, dy, cy);
  axis_stencil<T>(pos[3 * i + 2], box[2], Kz, order, wz, dz, cz);
  T gx = 0, gy = 0, gz = 0;
  for (int a = 0; a < order; ++a) {
    const T* plane = ct + (size_t)cx[a] * Ky * Kz;
    for (int b = 0; b < order; ++b) {
      const T* row = plane + (size_t)cy[b] * Kz;
      const T sx = dx[a] * wy[b];
      const T sy = wx[a] * dy[b];
      const T sz = wx[a] * wy[b];
      for (int c = 0; c < order; ++c) {
        const T g = row[cz[c]];
        gx += g * (sx * wz[c]);
        gy += g * (sy * wz[c]);
        gz += g * (sz * dz[c]);
      }
    }
  }
  dpos[3 * i] = q * gx * (T(Kx) / box[0]);
  dpos[3 * i + 1] = q * gy * (T(Ky) / box[1]);
  dpos[3 * i + 2] = q * gz * (T(Kz) / box[2]);
}

inline bool bad_args(int n, int order, int Kx, int Ky, int Kz) {
  return n < 1 || order < 2 || order > kMaxOrder || Kx < order || Ky < order ||
         Kz < order;
}

template <typename T>
int launch_spread(const void* pos, const void* charge, const void* box, int n,
                  int order, int Kx, int Ky, int Kz, void* grid, void* stream) {
  if (bad_args(n, order, Kx, Ky, Kz)) return (int)cudaErrorInvalidValue;
  spread_kernel<T><<<(n + kThreads - 1) / kThreads, kThreads, 0,
                     (cudaStream_t)stream>>>(
      (const T*)pos, (const T*)charge, (const T*)box, n, order, Kx, Ky, Kz,
      (T*)grid);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_interpolate(const void* ct, const void* pos, const void* charge,
                       const void* box, int n, int order, int Kx, int Ky,
                       int Kz, void* dpos, void* stream) {
  if (bad_args(n, order, Kx, Ky, Kz)) return (int)cudaErrorInvalidValue;
  interpolate_kernel<T><<<(n + kThreads - 1) / kThreads, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const T*)ct, (const T*)pos, (const T*)charge, (const T*)box, n, order,
      Kx, Ky, Kz, (T*)dpos);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cavmd_pppm_spread_f32(const void* pos, const void* charge, const void* box,
                          int n, int order, int Kx, int Ky, int Kz, void* grid,
                          void* stream) {
  return launch_spread<float>(pos, charge, box, n, order, Kx, Ky, Kz, grid, stream);
}

int cavmd_pppm_spread_f64(const void* pos, const void* charge, const void* box,
                          int n, int order, int Kx, int Ky, int Kz, void* grid,
                          void* stream) {
  return launch_spread<double>(pos, charge, box, n, order, Kx, Ky, Kz, grid, stream);
}

int cavmd_pppm_interpolate_f32(const void* ct, const void* pos,
                               const void* charge, const void* box, int n,
                               int order, int Kx, int Ky, int Kz, void* dpos,
                               void* stream) {
  return launch_interpolate<float>(ct, pos, charge, box, n, order, Kx, Ky, Kz,
                                   dpos, stream);
}

int cavmd_pppm_interpolate_f64(const void* ct, const void* pos,
                               const void* charge, const void* box, int n,
                               int order, int Kx, int Ky, int Kz, void* dpos,
                               void* stream) {
  return launch_interpolate<double>(ct, pos, charge, box, n, order, Kx, Ky, Kz,
                                    dpos, stream);
}

}  // extern "C"
