// Hopper (sm_90a) kernels of the imaginary-time sweep, with a plain C
// interface bound by ctypes in wafer_torch/ops/hopper_stencil.py.
//
// K1 sweep_step<EXT> replaces wafer_tpu/ops/pallas_stencil.py
//   _evolve_kernel (B2, one sweep with the carried correction) and, launched
//   once per step with K2 after it, _evolve_kernel_res in its ground (B1),
//   per-step-norm and excited (B3) modes. It computes, on the fully padded
//   (N+2e)^3 layout,
//       c     = inv*psi - sum_s corr_s*l_s       (at every tap it reads)
//       psi'  = B*(2c + scale*L(c)) - c          (interior)
//       psi'  = 0                                (the Dirichlet shell)
//   with B = 1/(1 + dt/2*(V - vshift)) from coordinates for the analytic
//   potentials (as pallas_stencil._analytic_b, with an IEEE divide in place
//   of the TPU's Horner series) or streamed from b_int. The correction is
//   applied to the input taps, as B2 does; the S(l) form of the resident
//   TPU kernel (correct once at the centre with precomputed swept images)
//   is the same recursion by linearity and is not used here.
//   Each block writes its partial sums of |psi'|^2 and <l_s|psi'> (f32
//   products, f64 sums) to a (n_blocks, 1+S) scratch when reductions are on.
//
// K2 finish_coef replaces the TPU's in-order f32 SMEM accumulation of those
//   partials (pallas_stencil.py:316-332, racc at :2611) and the coefficient
//   recursion (:2507-2516). Blocks of K1 run in no order, so one block of K2
//   adds the partials in a fixed order in f64 and writes the reductions and
//   the next step's coef = [rsqrt(max(n2, 1e-37)), ov_s*inv] to device
//   memory. No float atomics: a seeded run is bit-reproducible.
//
// What bounds K1: HBM bytes. A ground step with analytic B reads psi once
// (its neighbours come from L1/L2) and writes psi' once, about 8 B per grid
// point; a streamed B adds 4 B, every stored state l_s adds 4 B. Its
// arithmetic is ~30 flops per point for the 7-point stencil, far below the
// card's ratio of flops to bytes. The design moves the fewest bytes a
// one-thread-per-point sweep can: A = 2B-1 is never read, B is computed
// from coordinates where the potential has a formula, the normalise+project
// step is folded into the next sweep's input instead of a separate pass,
// and the reductions ride the sweep. Shared-memory tiling, TMA and temporal
// blocking are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: B needs an IEEE divide and
//        denormals must behave as IEEE says).

#include "sweep_common.cuh"

namespace {

constexpr int kFinishThreads = 1024;

__device__ __forceinline__ float analytic_b(const Analytic& a, int i, int j, int k) {
  return 1.0f / (1.0f + a.half_dt * (analytic_v(a, i, j, k) - a.vshift));
}

// One thread per point of the padded grid (sweep_grid); threads on the
// shell write its zeros.
template <int EXT>
__global__ void __launch_bounds__(kThreads) sweep_step_kernel(
    const float* __restrict__ psi, float* __restrict__ out,
    const float* __restrict__ b_int, const float* __restrict__ store,
    const float* __restrict__ coef, double* __restrict__ partials,
    int nx, int ny, int nz, int n_store, int apply, float scale, Analytic an) {
  __shared__ double warp_sums[kThreads / 32];
  const int nyp = ny + 2 * EXT;
  const int nzp = nz + 2 * EXT;
  const int k = blockIdx.x * kBlockZ + threadIdx.x;
  const int j = blockIdx.y * kBlockY + threadIdx.y;
  const int i = blockIdx.z;
  const ptrdiff_t sy = nzp;
  const ptrdiff_t sx = (ptrdiff_t)nyp * nzp;
  const ptrdiff_t vol = sx * (nx + 2 * EXT);
  const bool in_grid = j < nyp && k < nzp;
  const bool interior = in_grid && i >= EXT && i < nx + EXT && j >= EXT &&
                        j < ny + EXT && k >= EXT && k < nz + EXT;
  const ptrdiff_t p = i * sx + j * sy + k;

  float next = 0.0f;
  if (interior) {
    const float inv = apply ? coef[0] : 1.0f;
    // the corrected input at tap q: inv*psi - sum_s corr_s*l_s
    auto c = [&](ptrdiff_t q) {
      float v = psi[q];
      if (apply) {
        v = inv * v;
        for (int s = 0; s < n_store; ++s) v = v - coef[1 + s] * store[s * vol + q];
      }
      return v;
    };
    const float c0 = c(p);
    float acc = -center<EXT>() * c0;
#pragma unroll
    for (int o = 1; o <= EXT; ++o) {
      const float cf = tap<EXT>(o);
      acc += cf * (c(p + o * sx) + c(p - o * sx));
      acc += cf * (c(p + o * sy) + c(p - o * sy));
      acc += cf * (c(p + o) + c(p - o));
    }
    const float b = an.kind == kStreamed
                        ? b_int[((ptrdiff_t)(i - EXT) * ny + (j - EXT)) * nz + (k - EXT)]
                        : analytic_b(an, i, j, k);
    next = b * (2.0f * c0 + scale * acc) - c0;
  }
  if (in_grid) out[p] = next;

  if (partials != nullptr) {
    const int n_red = 1 + n_store;
    const ptrdiff_t blk =
        ((ptrdiff_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    double* mine = partials + blk * n_red;
    const bool lead = threadIdx.x == 0 && threadIdx.y == 0;
    const double n2 = block_sum<kThreads>((double)(next * next), warp_sums);
    if (lead) mine[0] = n2;
    for (int s = 0; s < n_store; ++s) {
      const float lp = interior ? store[s * vol + p] : 0.0f;
      const double ov = block_sum<kThreads>((double)(lp * next), warp_sums);
      if (lead) mine[1 + s] = ov;
    }
  }
}

__global__ void __launch_bounds__(kFinishThreads) finish_coef_kernel(
    const double* __restrict__ partials, int n_blocks, int n_red,
    double* __restrict__ red, float* __restrict__ coef) {
  __shared__ double warp_sums[kFinishThreads / 32];
  for (int q = 0; q < n_red; ++q) {
    double v = 0.0;
    for (int b = threadIdx.x; b < n_blocks; b += kFinishThreads) {
      v += partials[(ptrdiff_t)b * n_red + q];
    }
    v = block_sum<kFinishThreads>(v, warp_sums);
    if (threadIdx.x == 0) red[q] = v;
  }
  if (threadIdx.x == 0) {
    const double inv = 1.0 / sqrt(fmax(red[0], 1e-37));
    coef[0] = (float)inv;
    for (int q = 1; q < n_red; ++q) coef[q] = (float)(red[q] * inv);
  }
}

}  // namespace

extern "C" {

// Rows of the (n_blocks, 1+S) partials scratch one sweep_step writes.
int wafer_sweep_num_blocks(int nx, int ny, int nz, int ext) {
  const dim3 g = sweep_grid(nx, ny, nz, ext);
  return (int)(g.x * g.y * g.z);
}

// psi/out: (nx+2e, ny+2e, nz+2e) f32; b_int: (nx, ny, nz) f32 or NULL when
// kind >= 0; store: (n_store, nx+2e, ny+2e, nz+2e) f32 or NULL; coef:
// (1+n_store) f32 on the device; partials: (n_blocks, 1+n_store) f64 or
// NULL for no reductions. Returns cudaGetLastError() after the launch.
int wafer_sweep_step(const float* psi, float* out, const float* b_int,
                     const float* store, const float* coef, double* partials,
                     int nx, int ny, int nz, int ext, int n_store, int apply,
                     double scale, int kind, double dn, double dt, double mass,
                     double sig, double vshift, void* stream) {
  const Analytic an = make_analytic(nx, ny, nz, kind, dn, dt, mass, sig, vshift, 0.0);
  const dim3 grid = sweep_grid(nx, ny, nz, ext);
  const dim3 block(kBlockZ, kBlockY, 1);
  cudaStream_t s = (cudaStream_t)stream;
  const float sc = (float)scale;
  switch (ext) {
    case 1:
      sweep_step_kernel<1><<<grid, block, 0, s>>>(psi, out, b_int, store, coef, partials,
                                                  nx, ny, nz, n_store, apply, sc, an);
      break;
    case 2:
      sweep_step_kernel<2><<<grid, block, 0, s>>>(psi, out, b_int, store, coef, partials,
                                                  nx, ny, nz, n_store, apply, sc, an);
      break;
    case 3:
      sweep_step_kernel<3><<<grid, block, 0, s>>>(psi, out, b_int, store, coef, partials,
                                                  nx, ny, nz, n_store, apply, sc, an);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// partials: (n_blocks, n_red) f64; red: (n_red) f64; coef: (n_red) f32.
int wafer_finish_coef(const double* partials, int n_blocks, int n_red, double* red,
                      float* coef, void* stream) {
  finish_coef_kernel<<<1, kFinishThreads, 0, (cudaStream_t)stream>>>(partials, n_blocks,
                                                                    n_red, red, coef);
  return (int)cudaGetLastError();
}

const char* wafer_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
