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
// What bounds them on an H100: bytes and latency. K4 reads v/pos/f/image,
// mass and the mask and writes v/pos/image: 42.6 KB at N = 501 (13 ns at
// 3.35 TB/s) and ~8.9 MB at N = 100,001 in f32 (2.7 us); K5 reads v/f,
// mass and the mask and writes v: ~4.1 MB at N = 100,001 (1.2 us). At
// N = 501 the launch and one block's latency set the time; at N = 100,001
// the bytes must come through every SM, and a reduction (K4: the group KE
// that sets alpha; K5: the two group KEs it returns) stands between the
// element-wise work and the result.
//
// Both are one cooperative launch (cudaLaunchCooperativeKernel) of blocks
// of 512 threads, as many as fit on the card at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count, computed
// once a kernel) and no more than N needs: the grid depends on N and the
// card only (coop_grid). Each block reduces its share in a fixed order
// (registers, warp shuffles, shared memory: block_sum) into a partials
// buffer the wrapper allocates; a grid sync (cooperative_groups; a grid
// of one block syncs with __syncthreads); then the partials are summed in
// one fixed order (sum_partials), so the sums are bit-equal call after
// call. A refused cooperative launch returns its error and the wrapper
// raises: there is no one-block fallback.
//
// K4: pass 1 sums the masked m v^2; after the sync every block sums the
// partials, so every block computes the same K and alpha, bit for bit;
// block 0 writes the reservoir delta. Pass 2: the grid-stride rescale,
// kick, drift and rewrap.
// K5: pass 1 is the grid-stride kick, writing v; the thread that owns the
// photon row runs its exact-OU update and writes the reservoir delta
// itself (one row contributes to it); each block writes its partials of
// 2 KE_mol and 2 KE_cav. After the sync block 0 sums them and writes
// out[0] and out[1]; the other blocks are done.
// Not taken: one block for K5 (its first version: 131 of 132 SMs idle at
// N = 100,001); two launches (partials, then the sums), one launch more
// a step on a host-bound step; a cluster with distributed shared memory,
// whose 16 SMs at most do not cover the card at N = 100,001; for K5, a
// last-block-done counter instead of the grid sync, which needs a counter
// reset to zero every step (a device operation more).
//
// Replica batches (parallel/replicas.py): one launch takes B replicas of
// one topology, blockIdx.y the replica, gridDim.x = g blocks a replica with
// g = max(1, resident / B) (no more than N needs), so the whole grid still
// fits the card at once (B <= resident, hundreds of blocks: a larger batch
// is refused and raises). v/pos/f/image, the per-replica scalars (dt, c,
// r1, r_gamma; c_ou, sigma, the three draws), the reservoir deltas (B,),
// K5's sums (B, 3) and the partials (B, g) are offset by the replica; mass,
// the mask and the box are shared. Each replica's partials are summed in
// one fixed order, so every block of a replica computes the same alpha bit
// for bit. With g = 1 a replica's reduction stays in its block and the
// grid needs no sync. K4's B = 1 launch is the unbatched one. K5's
// batched launch is its own instantiation (kBatch): with the replica's
// offsets the one-replica K5 ran 4.9% slower at N = 501 and 3.9% at
// N = 4001 (scripts/bench_torch_spread_tail.py, parent and change in one
// call, H100 80GB HBM3 at 700 W), at the edge of the 5% a shared kernel
// may cost; the one-replica instantiation compiles as before.
// The element-wise updates use the _rn intrinsics so that nvcc does not
// contract them into fused multiply-adds: the results round exactly as
// the plain PyTorch twin's separate operations do, and the image flags
// of the rewrap follow the twin's bit for bit whenever alpha does.
// The launches allocate nothing and do not synchronise; each returns
// cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kGridThreads = 512;  // K4 and K5: a block of the cooperative grid
constexpr int kGridWarps = kGridThreads / 32;

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

// Sum of `v` over a block of kWarps warps, in a fixed order; the result is
// valid in thread 0. `scratch` holds kWarps values.
template <int kWarps, typename T>
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

// Sum of the `count` partials partial[b * stride + offset] in one fixed
// order (each thread a strided run, then block_sum); valid in thread 0.
// The partials were written by other blocks before a grid sync, so they
// are read past L1.
template <typename T>
__device__ __forceinline__ T sum_partials(const T* partial, int count,
                                          int stride, int offset, T* scratch) {
  T sum = 0;
  for (int b = threadIdx.x; b < count; b += kGridThreads) {
    sum += __ldcg(partial + (size_t)b * stride + offset);
  }
  return block_sum<kGridWarps>(sum, scratch);
}

// The whole grid waits here; a grid of one block a replica needs no grid
// sync (each replica's reduction stays in its block).
__device__ __forceinline__ void grid_sync() {
  if (gridDim.x > 1) {
    cg::this_grid().sync();
  } else {
    __syncthreads();
  }
}

// m v . v as the twin forms it: (m vx) vx + (m vy) vy + (m vz) vz, summed.
template <typename T>
__device__ __forceinline__ T mass_v2(T m, T vx, T vy, T vz) {
  return add_rn(add_rn(mul_rn(mul_rn(m, vx), vx), mul_rn(mul_rn(m, vy), vy)),
                mul_rn(mul_rn(m, vz), vz));
}

template <typename T>
__global__ void __launch_bounds__(kGridThreads)
pre_force_kernel(const T* __restrict__ vel, const T* __restrict__ pos,
                 const int32_t* __restrict__ img, const T* __restrict__ frc,
                 const T* __restrict__ mass, const uint8_t* __restrict__ mol,
                 const T* __restrict__ box, const T* __restrict__ dt_p,
                 const T* __restrict__ c_p, const T* __restrict__ r1_p,
                 const T* __restrict__ rg_p, T kT, T dof, int n,
                 T* __restrict__ vel_out, T* __restrict__ pos_out,
                 int32_t* __restrict__ img_out, T* __restrict__ dres,
                 T* __restrict__ partial) {
  __shared__ T s_red[kGridWarps];
  __shared__ T s_alpha;
  // this block's replica
  {
    const size_t b = blockIdx.y, rows = 3 * (size_t)n * b;
    vel += rows;
    pos += rows;
    img += rows;
    frc += rows;
    vel_out += rows;
    pos_out += rows;
    img_out += rows;
    dt_p += b;
    c_p += b;
    r1_p += b;
    rg_p += b;
    dres += b;
    partial += (size_t)gridDim.x * b;
  }
  const int first = blockIdx.x * kGridThreads + threadIdx.x;
  const int stride = gridDim.x * kGridThreads;

  // 1. this block's share of the molecular group's 2 K
  T k2 = 0;
  for (int i = first; i < n; i += stride) {
    if (mol[i]) {
      k2 += mass_v2(mass[i], vel[3 * i], vel[3 * i + 1], vel[3 * i + 2]);
    }
  }
  k2 = block_sum<kGridWarps>(k2, s_red);
  if (threadIdx.x == 0) partial[blockIdx.x] = k2;
  grid_sync();

  // 2. every block: 2 K from the partials in one order, then alpha; block
  // 0 writes the reservoir delta
  k2 = sum_partials(partial, gridDim.x, 1, 0, s_red);
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
    if (blockIdx.x == 0) *dres = K * (T(1) - alpha * alpha);
  }
  __syncthreads();

  // 3. rescale, kick, drift, rewrap
  const T alpha = s_alpha;
  const T dt = *dt_p;
  const T half_dt = mul_rn(T(0.5), dt);
  for (int i = first; i < n; i += stride) {
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

template <typename T, bool kBatch>
__global__ void __launch_bounds__(kGridThreads)
post_force_kernel(const T* __restrict__ vel, const T* __restrict__ frc,
                  const T* __restrict__ mass, const uint8_t* __restrict__ mol,
                  const T* __restrict__ dt_p, int photon,
                  const T* __restrict__ c_ou_p, const T* __restrict__ sig_p,
                  const T* __restrict__ noise, int n,
                  T* __restrict__ vel_out, T* __restrict__ out,
                  T* __restrict__ partial) {
  __shared__ T s_red[kGridWarps];
  // this block's replica (the OU inputs only with a photon row)
  if (kBatch) {
    const size_t b = blockIdx.y, rows = 3 * (size_t)n * b;
    vel += rows;
    frc += rows;
    vel_out += rows;
    dt_p += b;
    if (photon >= 0) {
      c_ou_p += b;
      sig_p += b;
      noise += 3 * b;
    }
    out += 3 * b;
    partial += 2 * (size_t)gridDim.x * b;
  }
  const int first = blockIdx.x * kGridThreads + threadIdx.x;
  const int stride = gridDim.x * kGridThreads;
  const T half_dt = mul_rn(T(0.5), *dt_p);

  // 1. kick; the photon's OU row and reservoir delta; this block's 2 KEs
  T ke_mol = 0, ke_cav = 0;
  for (int i = first; i < n; i += stride) {
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
      out[2] = sub_rn(before, mul_rn(T(0.5), mass_v2(m, v[0], v[1], v[2])));
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
  if (photon < 0 && blockIdx.x == 0 && threadIdx.x == 0) out[2] = T(0);
  ke_mol = block_sum<kGridWarps>(ke_mol, s_red);
  ke_cav = block_sum<kGridWarps>(ke_cav, s_red);
  if (threadIdx.x == 0) {
    partial[2 * blockIdx.x] = ke_mol;
    partial[2 * blockIdx.x + 1] = ke_cav;
  }
  grid_sync();

  // 2. block 0: the two sums from the partials in one order
  if (blockIdx.x != 0) return;
  ke_mol = sum_partials(partial, gridDim.x, 2, 0, s_red);
  ke_cav = sum_partials(partial, gridDim.x, 2, 1, s_red);
  if (threadIdx.x == 0) {
    out[0] = T(0.5) * ke_mol;
    out[1] = T(0.5) * ke_cav;
  }
}

// Blocks a replica of a cooperative grid of `kernel` for nb replicas of n
// particles: the card's resident blocks (`resident`, computed on the first
// call: one device) shared over the replicas, at least one, no more than
// n needs (at most ceil(n / kGridThreads), the partials the wrappers
// allocate a replica). 0, or the error of a failed query.
template <typename Kernel>
int coop_grid(Kernel kernel, int n, int nb, int* resident, int* grid) {
  if (*resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kGridThreads, 0);
    if (err != cudaSuccess) return (int)err;
    *resident = per_sm * sms;
  }
  const int need = (n + kGridThreads - 1) / kGridThreads;
  const int share = *resident / nb > 1 ? *resident / nb : 1;
  *grid = need < share ? need : share;
  return 0;
}

template <typename T>
int pre_grid(int n, int nb, int* grid) {
  static int resident = 0;
  return coop_grid(pre_force_kernel<T>, n, nb, &resident, grid);
}

template <typename T, bool kBatch>
int post_grid_k(int n, int nb, int* grid) {
  static int resident = 0;
  return coop_grid(post_force_kernel<T, kBatch>, n, nb, &resident, grid);
}

template <typename T>
int post_grid(int n, int nb, int* grid) {
  return nb > 1 ? post_grid_k<T, true>(n, nb, grid)
                : post_grid_k<T, false>(n, nb, grid);
}

template <typename T>
int launch_pre(const void* vel, const void* pos, const void* img,
               const void* frc, const void* mass, const void* mol,
               const void* box, const void* dt, const void* c, const void* r1,
               const void* rg, double kT, double dof, int n, int nb,
               void* vel_out, void* pos_out, void* img_out, void* dres,
               void* partial, int n_partial, void* stream) {
  if (n < 1 || nb < 1 || nb > 65535) return (int)cudaErrorInvalidValue;
  int grid = 0;
  const int err = pre_grid<T>(n, nb, &grid);
  if (err != 0) return err;
  if (grid < 1 || grid > n_partial) return (int)cudaErrorInvalidValue;
  const T* a_vel = (const T*)vel;
  const T* a_pos = (const T*)pos;
  const int32_t* a_img = (const int32_t*)img;
  const T* a_frc = (const T*)frc;
  const T* a_mass = (const T*)mass;
  const uint8_t* a_mol = (const uint8_t*)mol;
  const T* a_box = (const T*)box;
  const T* a_dt = (const T*)dt;
  const T* a_c = (const T*)c;
  const T* a_r1 = (const T*)r1;
  const T* a_rg = (const T*)rg;
  T a_kT = (T)kT, a_dof = (T)dof;
  T* a_vel_out = (T*)vel_out;
  T* a_pos_out = (T*)pos_out;
  int32_t* a_img_out = (int32_t*)img_out;
  T* a_dres = (T*)dres;
  T* a_partial = (T*)partial;
  void* args[] = {&a_vel, &a_pos, &a_img, &a_frc, &a_mass, &a_mol,
                  &a_box, &a_dt, &a_c, &a_r1, &a_rg, &a_kT, &a_dof, &n,
                  &a_vel_out, &a_pos_out, &a_img_out, &a_dres, &a_partial};
  const cudaError_t launch_err = cudaLaunchCooperativeKernel(
      (const void*)pre_force_kernel<T>, dim3(grid, nb), dim3(kGridThreads),
      args, 0, (cudaStream_t)stream);
  if (launch_err != cudaSuccess) return (int)launch_err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_post(const void* vel, const void* frc, const void* mass,
                const void* mol, const void* dt, int photon, const void* c_ou,
                const void* sig, const void* noise, int n, int nb,
                void* vel_out, void* out, void* partial, int n_partial,
                void* stream) {
  if (n < 1 || nb < 1 || nb > 65535 || photon >= n)
    return (int)cudaErrorInvalidValue;
  int grid = 0;
  const int err = post_grid<T>(n, nb, &grid);
  if (err != 0) return err;
  if (grid < 1 || grid > n_partial) return (int)cudaErrorInvalidValue;
  const T* a_vel = (const T*)vel;
  const T* a_frc = (const T*)frc;
  const T* a_mass = (const T*)mass;
  const uint8_t* a_mol = (const uint8_t*)mol;
  const T* a_dt = (const T*)dt;
  const T* a_c_ou = (const T*)c_ou;
  const T* a_sig = (const T*)sig;
  const T* a_noise = (const T*)noise;
  T* a_vel_out = (T*)vel_out;
  T* a_out = (T*)out;
  T* a_partial = (T*)partial;
  void* args[] = {&a_vel, &a_frc, &a_mass, &a_mol, &a_dt, &photon, &a_c_ou,
                  &a_sig, &a_noise, &n, &a_vel_out, &a_out, &a_partial};
  const void* kernel = nb > 1 ? (const void*)post_force_kernel<T, true>
                              : (const void*)post_force_kernel<T, false>;
  const cudaError_t launch_err = cudaLaunchCooperativeKernel(
      kernel, dim3(grid, nb), dim3(kGridThreads), args, 0,
      (cudaStream_t)stream);
  if (launch_err != cudaSuccess) return (int)launch_err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cavmd_fused_pre_force_f32(const void* vel, const void* pos, const void* img,
                              const void* frc, const void* mass, const void* mol,
                              const void* box, const void* dt, const void* c,
                              const void* r1, const void* rg, double kT, double dof,
                              int n, int nb, void* vel_out, void* pos_out,
                              void* img_out, void* dres, void* partial,
                              int n_partial, void* stream) {
  return launch_pre<float>(vel, pos, img, frc, mass, mol, box, dt, c, r1, rg, kT,
                           dof, n, nb, vel_out, pos_out, img_out, dres,
                           partial, n_partial, stream);
}

int cavmd_fused_pre_force_f64(const void* vel, const void* pos, const void* img,
                              const void* frc, const void* mass, const void* mol,
                              const void* box, const void* dt, const void* c,
                              const void* r1, const void* rg, double kT, double dof,
                              int n, int nb, void* vel_out, void* pos_out,
                              void* img_out, void* dres, void* partial,
                              int n_partial, void* stream) {
  return launch_pre<double>(vel, pos, img, frc, mass, mol, box, dt, c, r1, rg, kT,
                            dof, n, nb, vel_out, pos_out, img_out, dres,
                            partial, n_partial, stream);
}

int cavmd_fused_post_force_f32(const void* vel, const void* frc, const void* mass,
                               const void* mol, const void* dt, int photon,
                               const void* c_ou, const void* sig, const void* noise,
                               int n, int nb, void* vel_out, void* out,
                               void* partial, int n_partial, void* stream) {
  return launch_post<float>(vel, frc, mass, mol, dt, photon, c_ou, sig, noise, n,
                            nb, vel_out, out, partial, n_partial, stream);
}

int cavmd_fused_post_force_f64(const void* vel, const void* frc, const void* mass,
                               const void* mol, const void* dt, int photon,
                               const void* c_ou, const void* sig, const void* noise,
                               int n, int nb, void* vel_out, void* out,
                               void* partial, int n_partial, void* stream) {
  return launch_post<double>(vel, frc, mass, mol, dt, photon, c_ou, sig, noise,
                             n, nb, vel_out, out, partial, n_partial, stream);
}

// The blocks a replica of K4's (kernel 4) or K5's (kernel 5) cooperative
// grid for nb replicas of n particles in f32 (f64 if is_f64), into
// *blocks; returns the error code.
int cavmd_fused_grid_blocks(int kernel, int is_f64, int n, int nb,
                            int* blocks) {
  if (n < 1 || nb < 1 || (kernel != 4 && kernel != 5))
    return (int)cudaErrorInvalidValue;
  if (kernel == 4)
    return is_f64 ? pre_grid<double>(n, nb, blocks) : pre_grid<float>(n, nb, blocks);
  return is_f64 ? post_grid<double>(n, nb, blocks) : post_grid<float>(n, nb, blocks);
}

}  // extern "C"
