// Fused integrator tail: the two kernels that bracket the force pass.
//
// Replace the TPU kernels of cavmd_tpu/ops/fused_integrator.py:
//   - pre-force  (K4): _pre_force_kernel, wrapper pre_force_apply;
//   - post-force (K5): _post_force_kernel, wrapper post_force_apply.
// They compute what the Pallas kernels compute, not their layout: the TPU
// flattened every per-particle array to (1, 3N) and broadcast mass, masks
// and box into it; here the kernels read (N, 3) v/pos/f/image, (N,) mass,
// the (N,) molecular mask (1 byte per particle), the (3,) box and the
// photon's row index.
//
//   K4: K = 1/2 sum_mol m v^2 -> Bussi alpha (2007, with the 2009 Eq. A8
//       sign fix) -> v = alpha v on the molecules, v += (dt/2) f / m,
//       x += dt v, rewrap with image += floor((x + L/2) / L),
//       x -= image L; the reservoir delta K (1 - alpha^2).
//   K5: v += (dt/2) f / m; exact OU on the photon row,
//       v_p = c_ou v_p + sigma xi; KE_mol, KE_cav and the Langevin
//       reservoir delta KE_p(before) - KE_p(after).
//
// The random draws are made outside, as on the TPU, so both step paths use
// the same numbers. Every scalar that changes during a run (dt, c =
// exp(-dt/tau), r1, r_gamma, c_ou, sigma, the three OU draws) stays on the
// device and is read through a pointer: the wrapper never reads a value
// back to the host. kT and the group's degrees of freedom are fixed per
// method and come by value.
//
// What bounds them on an H100: at N = 501 each moves ~40 KB (K4 reads
// v/pos/f/image and mass/mask and writes v/pos/image: 42.6 KB in f32) —
// 13 ns at 3.35 TB/s — so the launch and one block's latency set the
// time. Design: one block of 1024 threads; each thread walks particles
// i = tid, tid + 1024, ...; the masked kinetic energy is reduced in
// registers, warp shuffles and shared memory in a fixed order (so the
// result is deterministic); thread 0 then computes alpha and the
// reservoir delta, and the block applies the update. One block does not
// scale: at N = 100k it would leave 131 of 132 SMs idle; a grid-wide
// reduction (two passes or a cooperative launch) is later work.
//
// The element-wise updates use the _rn intrinsics so that nvcc does not
// contract them into fused multiply-adds: the results round exactly as
// the plain PyTorch twin's separate operations do, and the image flags
// of the rewrap follow the twin's bit for bit whenever alpha does.
// The launches allocate nothing and do not synchronise; each returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_floor(float x) { return floorf(x); }
__device__ __forceinline__ double m_floor(double x) { return floor(x); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum of `v` over the block, in a fixed order; the result is valid in
// thread 0. `scratch` holds kWarps values.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* scratch) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T total = 0;
  if (warp == 0) {
    total = warp_sum(lane < kWarps ? scratch[lane] : T(0));
  }
  __syncthreads();
  return total;
}

// m v . v as the twin forms it: (m vx) vx + (m vy) vy + (m vz) vz, summed.
template <typename T>
__device__ __forceinline__ T mass_v2(T m, T vx, T vy, T vz) {
  return add_rn(add_rn(mul_rn(mul_rn(m, vx), vx), mul_rn(mul_rn(m, vy), vy)),
                mul_rn(mul_rn(m, vz), vz));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pre_force_kernel(const T* __restrict__ vel, const T* __restrict__ pos,
                 const int32_t* __restrict__ img, const T* __restrict__ frc,
                 const T* __restrict__ mass, const uint8_t* __restrict__ mol,
                 const T* __restrict__ box, const T* __restrict__ dt_p,
                 const T* __restrict__ c_p, const T* __restrict__ r1_p,
                 const T* __restrict__ rg_p, T kT, T dof, int n,
                 T* __restrict__ vel_out, T* __restrict__ pos_out,
                 int32_t* __restrict__ img_out, T* __restrict__ dres) {
  __shared__ T s_red[kWarps];
  __shared__ T s_alpha;

  // 1. the molecular group's kinetic energy
  T k2 = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if (mol[i]) {
      k2 += mass_v2(mass[i], vel[3 * i], vel[3 * i + 1], vel[3 * i + 2]);
    }
  }
  k2 = block_sum(k2, s_red);

  // 2. alpha and the reservoir delta (thread 0)
  if (threadIdx.x == 0) {
    const T K = T(0.5) * k2;
    const T c = *c_p, r1 = *r1_p, rg = *rg_p;
    const T vfac = kT / (T(2) * K);
    const T term1 = vfac * (T(1) - c) * (rg + r1 * r1);
    const T term2 = T(2) * r1 * m_sqrt(vfac * (T(1) - c) * c);
    const T alpha_mag = m_sqrt(c + term1 + term2);
    const T K_bar = kT * dof / T(2);
    const T sign_term = r1 + m_sqrt(c * dof * K / ((T(1) - c) * K_bar));
    const T alpha = sign_term >= T(0) ? alpha_mag : -alpha_mag;
    s_alpha = alpha;
    *dres = K * (T(1) - alpha * alpha);
  }
  __syncthreads();

  // 3. rescale, kick, drift, rewrap
  const T alpha = s_alpha;
  const T dt = *dt_p;
  const T half_dt = mul_rn(T(0.5), dt);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const T m = mass[i];
    const bool is_mol = mol[i] != 0;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int k = 3 * i + d;
      T v = vel[k];
      if (is_mol) v = mul_rn(alpha, v);
      v = add_rn(v, div_rn(mul_rn(half_dt, frc[k]), m));
      const T x = add_rn(pos[k], mul_rn(dt, v));
      const T L = box[d];
      const T shift = m_floor(div_rn(add_rn(x, mul_rn(T(0.5), L)), L));
      vel_out[k] = v;
      pos_out[k] = sub_rn(x, mul_rn(shift, L));
      img_out[k] = img[k] + (int32_t)shift;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
post_force_kernel(const T* __restrict__ vel, const T* __restrict__ frc,
                  const T* __restrict__ mass, const uint8_t* __restrict__ mol,
                  const T* __restrict__ dt_p, int photon,
                  const T* __restrict__ c_ou_p, const T* __restrict__ sig_p,
                  const T* __restrict__ noise, int n,
                  T* __restrict__ vel_out, T* __restrict__ out) {
  __shared__ T s_red[kWarps];
  const T half_dt = mul_rn(T(0.5), *dt_p);
  T ke_mol = 0, ke_cav = 0, dres = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const T m = mass[i];
    T v[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      v[d] = add_rn(vel[3 * i + d], div_rn(mul_rn(half_dt, frc[3 * i + d]), m));
    }
    if (i == photon) {
      const T c_ou = *c_ou_p, sig = *sig_p;
      const T before = mul_rn(T(0.5), mass_v2(m, v[0], v[1], v[2]));
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        v[d] = add_rn(mul_rn(c_ou, v[d]), mul_rn(sig, noise[d]));
      }
      dres = sub_rn(before, mul_rn(T(0.5), mass_v2(m, v[0], v[1], v[2])));
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) vel_out[3 * i + d] = v[d];
    const T e = mass_v2(m, v[0], v[1], v[2]);
    if (mol[i]) {
      ke_mol += e;
    } else {
      ke_cav += e;
    }
  }
  ke_mol = block_sum(ke_mol, s_red);
  ke_cav = block_sum(ke_cav, s_red);
  dres = block_sum(dres, s_red);
  if (threadIdx.x == 0) {
    out[0] = T(0.5) * ke_mol;
    out[1] = T(0.5) * ke_cav;
    out[2] = dres;
  }
}

template <typename T>
int launch_pre(const void* vel, const void* pos, const void* img,
               const void* frc, const void* mass, const void* mol,
               const void* box, const void* dt, const void* c, const void* r1,
               const void* rg, double kT, double dof, int n, void* vel_out,
               void* pos_out, void* img_out, void* dres, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  pre_force_kernel<T><<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)vel, (const T*)pos, (const int32_t*)img, (const T*)frc,
      (const T*)mass, (const uint8_t*)mol, (const T*)box, (const T*)dt,
      (const T*)c, (const T*)r1, (const T*)rg, (T)kT, (T)dof, n,
      (T*)vel_out, (T*)pos_out, (int32_t*)img_out, (T*)dres);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_post(const void* vel, const void* frc, const void* mass,
                const void* mol, const void* dt, int photon, const void* c_ou,
                const void* sig, const void* noise, int n, void* vel_out,
                void* out, void* stream) {
  if (n < 1 || photon >= n) return (int)cudaErrorInvalidValue;
  post_force_kernel<T><<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)vel, (const T*)frc, (const T*)mass, (const uint8_t*)mol,
      (const T*)dt, photon, (const T*)c_ou, (const T*)sig, (const T*)noise, n,
      (T*)vel_out, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cavmd_fused_pre_force_f32(const void* vel, const void* pos, const void* img,
                              const void* frc, const void* mass, const void* mol,
                              const void* box, const void* dt, const void* c,
                              const void* r1, const void* rg, double kT, double dof,
                              int n, void* vel_out, void* pos_out, void* img_out,
                              void* dres, void* stream) {
  return launch_pre<float>(vel, pos, img, frc, mass, mol, box, dt, c, r1, rg, kT,
                           dof, n, vel_out, pos_out, img_out, dres, stream);
}

int cavmd_fused_pre_force_f64(const void* vel, const void* pos, const void* img,
                              const void* frc, const void* mass, const void* mol,
                              const void* box, const void* dt, const void* c,
                              const void* r1, const void* rg, double kT, double dof,
                              int n, void* vel_out, void* pos_out, void* img_out,
                              void* dres, void* stream) {
  return launch_pre<double>(vel, pos, img, frc, mass, mol, box, dt, c, r1, rg, kT,
                            dof, n, vel_out, pos_out, img_out, dres, stream);
}

int cavmd_fused_post_force_f32(const void* vel, const void* frc, const void* mass,
                               const void* mol, const void* dt, int photon,
                               const void* c_ou, const void* sig, const void* noise,
                               int n, void* vel_out, void* out, void* stream) {
  return launch_post<float>(vel, frc, mass, mol, dt, photon, c_ou, sig, noise, n,
                            vel_out, out, stream);
}

int cavmd_fused_post_force_f64(const void* vel, const void* frc, const void* mass,
                               const void* mol, const void* dt, int photon,
                               const void* c_ou, const void* sig, const void* noise,
                               int n, void* vel_out, void* out, void* stream) {
  return launch_post<double>(vel, frc, mass, mol, dt, photon, c_ou, sig, noise, n,
                             vel_out, out, stream);
}

}  // extern "C"
