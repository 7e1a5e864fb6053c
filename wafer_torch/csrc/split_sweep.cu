// Hopper (sm_90a) kernel of the split-complex imaginary-time sweep, with a
// plain C interface bound by ctypes in wafer_torch/ops/hopper_split.py.
//
// K3 sweep_step_sc<EXT> replaces wafer_tpu/ops/pallas_split.py
//   _evolve_kernel_sc (B8, one sweep of the (re, im) pair with the carried
//   correction) and, launched once per step with K2 finish_coef
//   (stencil_sweep.cu) after it, the chunk kernels _evolve_kernel_res_sc
//   (B9), _evolve_kernel_resb_sc (B10), _evolve_kernel_res_mixed_sc (B7) and
//   _evolve_kernel_k_sc (B11). On one device all five compute n steps of
//       c     = inv*psi - sum_s (cr_s + i*ci_s)*l_s    (at every tap it reads)
//       psi'  = B*(2c + scale*L(c)) - c                (interior, complex B)
//       psi'  = 0                                      (the Dirichlet shell)
//   and differ only in how they keep psi near the TPU's vector units. Over
//   the pair, with the TPU kernel's A = 2B - 1 eliminated
//   (pallas_split.py:16-18):
//       re' = Br*(2cr + s*Tr) - Bi*(2ci + s*Ti) - cr
//       im' = Br*(2ci + s*Ti) + Bi*(2cr + s*Tr) - ci
//   B = 1/(1 + dt/2*(V - vshift + i*absorb*V)) comes from coordinates for
//   ComplexHarmonic and ComplexCoulomb (IEEE divides, as
//   pallas_split._analytic_b_sc; the TPU's divide-free Horner series is not
//   needed here) or is streamed as (Br, Bi) (ComplexFullCornell).
//   Each block writes partial sums of |psi'|^2, Re<l_s|psi'> and
//   Im<l_s|psi'> (conjugated, as split_complex._overlap; f32 products, f64
//   sums) to a (n_blocks, 1+2S) scratch; K2 adds them in a fixed order and
//   writes the next coef = [inv, Re ov_s*inv, Im ov_s*inv], which is the
//   split recursion of pallas_split.py:595-598. No atomics: a seeded run is
//   bit-reproducible.
//
// Layout: psi/out (2, NXp, NYp, NZp) with re then im, fully padded; B
//   (2, NX, NY, NZ); stored states (S, 2, NXp, NYp, NZp); coef (1+2S) f32.
//
// What bounds K3: HBM bytes, as for K1. A ground step with analytic B reads
// the pair once (neighbours from L1/L2) and writes it once, 16 B per grid
// point; streamed B adds 8 B and each stored pair 8 B. The arithmetic is
// about 40 flops per point at the 7-point stencil plus two divides for B.
// One thread computes both components of its point, so each tap's
// correction is shared by re and im and the pair moves in one pass.

#include "sweep_common.cuh"

namespace {

__device__ __forceinline__ void analytic_b_sc(const Analytic& a, int i, int j, int k,
                                              float& br, float& bi) {
  const float v = analytic_v(a, i, j, k);
  const float dr = 1.0f + a.half_dt * (v - a.vshift);
  const float di = a.half_dt * (a.absorb * v);
  const float mag = dr * dr + di * di;
  br = dr / mag;
  bi = -di / mag;
}

template <int EXT>
__global__ void __launch_bounds__(kThreads) sweep_step_sc_kernel(
    const float* __restrict__ psi, float* __restrict__ out,
    const float* __restrict__ b2, const float* __restrict__ store,
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
  const ptrdiff_t vol = sx * (nx + 2 * EXT);  // one component
  const bool in_grid = j < nyp && k < nzp;
  const bool interior = in_grid && i >= EXT && i < nx + EXT && j >= EXT &&
                        j < ny + EXT && k >= EXT && k < nz + EXT;
  const ptrdiff_t p = i * sx + j * sy + k;

  float next_r = 0.0f;
  float next_i = 0.0f;
  if (interior) {
    const float inv = apply ? coef[0] : 1.0f;
    // the corrected input at tap q: inv*psi - sum_s (cr_s + i*ci_s)*l_s
    auto c = [&](ptrdiff_t q, float& cr, float& ci) {
      float r = psi[q];
      float m = psi[vol + q];
      if (apply) {
        r = inv * r;
        m = inv * m;
        for (int s = 0; s < n_store; ++s) {
          const float* l = store + 2 * s * vol;
          const float lr = l[q];
          const float li = l[vol + q];
          const float ar = coef[1 + 2 * s];
          const float ai = coef[2 + 2 * s];
          r = r - (ar * lr - ai * li);
          m = m - (ar * li + ai * lr);
        }
      }
      cr = r;
      ci = m;
    };
    float c0r, c0i;
    c(p, c0r, c0i);
    float acc_r = -center<EXT>() * c0r;
    float acc_i = -center<EXT>() * c0i;
#pragma unroll
    for (int o = 1; o <= EXT; ++o) {
      const float cf = tap<EXT>(o);
      const ptrdiff_t strides[3] = {sx, sy, 1};
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        float pr, pi, mr, mi;
        c(p + o * strides[ax], pr, pi);
        c(p - o * strides[ax], mr, mi);
        acc_r += cf * (pr + mr);
        acc_i += cf * (pi + mi);
      }
    }
    float br, bi;
    if (an.kind == kStreamed) {
      const ptrdiff_t q = ((ptrdiff_t)(i - EXT) * ny + (j - EXT)) * nz + (k - EXT);
      br = b2[q];
      bi = b2[(ptrdiff_t)nx * ny * nz + q];
    } else {
      analytic_b_sc(an, i, j, k, br, bi);
    }
    const float ur = 2.0f * c0r + scale * acc_r;
    const float ui = 2.0f * c0i + scale * acc_i;
    next_r = br * ur - bi * ui - c0r;
    next_i = br * ui + bi * ur - c0i;
  }
  if (in_grid) {
    out[p] = next_r;
    out[vol + p] = next_i;
  }

  if (partials != nullptr) {
    const int n_red = 1 + 2 * n_store;
    const ptrdiff_t blk =
        ((ptrdiff_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    double* mine = partials + blk * n_red;
    const bool lead = threadIdx.x == 0 && threadIdx.y == 0;
    const double n2 =
        block_sum<kThreads>((double)(next_r * next_r + next_i * next_i), warp_sums);
    if (lead) mine[0] = n2;
    for (int s = 0; s < n_store; ++s) {
      const float* l = store + 2 * s * vol;
      const float lr = interior ? l[p] : 0.0f;
      const float li = interior ? l[vol + p] : 0.0f;
      const double ov_r = block_sum<kThreads>((double)(lr * next_r + li * next_i), warp_sums);
      const double ov_i = block_sum<kThreads>((double)(lr * next_i - li * next_r), warp_sums);
      if (lead) {
        mine[1 + 2 * s] = ov_r;
        mine[2 + 2 * s] = ov_i;
      }
    }
  }
}

}  // namespace

extern "C" {

// psi/out: (2, nx+2e, ny+2e, nz+2e) f32; b2: (2, nx, ny, nz) f32 or NULL
// when kind >= 0 (Harmonic or Coulomb); store: (n_store, 2, nx+2e, ny+2e,
// nz+2e) f32 or NULL; coef: (1+2*n_store) f32 on the device; partials:
// (wafer_sweep_num_blocks, 1+2*n_store) f64 or NULL for no reductions.
// Returns cudaGetLastError() after the launch.
int wafer_sweep_step_sc(const float* psi, float* out, const float* b2, const float* store,
                        const float* coef, double* partials, int nx, int ny, int nz, int ext,
                        int n_store, int apply, double scale, int kind, double dn, double dt,
                        double vshift, double absorb, void* stream) {
  if (kind != kStreamed && kind != kHarmonic && kind != kCoulomb) {
    return (int)cudaErrorInvalidValue;
  }
  const Analytic an = make_analytic(nx, ny, nz, kind, dn, dt, 0.0, 0.0, vshift, absorb);
  const dim3 grid = sweep_grid(nx, ny, nz, ext);
  const dim3 block(kBlockZ, kBlockY, 1);
  cudaStream_t s = (cudaStream_t)stream;
  const float sc = (float)scale;
  switch (ext) {
    case 1:
      sweep_step_sc_kernel<1><<<grid, block, 0, s>>>(psi, out, b2, store, coef, partials,
                                                     nx, ny, nz, n_store, apply, sc, an);
      break;
    case 2:
      sweep_step_sc_kernel<2><<<grid, block, 0, s>>>(psi, out, b2, store, coef, partials,
                                                     nx, ny, nz, n_store, apply, sc, an);
      break;
    case 3:
      sweep_step_sc_kernel<3><<<grid, block, 0, s>>>(psi, out, b2, store, coef, partials,
                                                     nx, ny, nz, n_store, apply, sc, an);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
