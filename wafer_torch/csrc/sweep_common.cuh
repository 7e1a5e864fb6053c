// Helpers shared by the sweep kernels (stencil_sweep.cu, split_sweep.cu):
// the launch shape, the stencil taps, the analytic potentials on
// padded-index coordinates, and the fixed-order block sum.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kBlockZ = 32;  // threads along z, the contiguous axis
constexpr int kBlockY = 8;
constexpr int kThreads = kBlockZ * kBlockY;

// kind codes shared with hopper_stencil.KINDS
enum Kind {
  kStreamed = -1,
  kNoPotential = 0,
  kHarmonic = 1,
  kCoulomb = 2,
  kSimpleCornell = 3,
  kPeriodic = 4,
};

// f32 constants of pallas_stencil._analytic_b, rounded from double on the
// host exactly as the reference rounds its Python-float constants. A shard
// block of a mesh reads B at its global padded index: (ox, oy, oz) is the
// block's interior origin in the global interior, and the centre and the
// Periodic denominators come from the global extents, so a block computes
// each point exactly as the whole grid does (the sharded modes' x_origin /
// origin SMEM scalars, pallas_stencil.py:1389, :1259; pallas_split.py:418).
struct Analytic {
  int kind;
  int ox, oy, oz;         // block origin in the global grid (0 on one device)
  float cx, cy, cz;       // (N+1)/2 per global axis: the centre in padded indices
  float dn;
  float half_dn2;         // 0.5*dn*dn
  float neg_inv_dn;       // -1/dn, the Coulomb core
  float cornell_c;        // -0.5*(4/3)
  float sig;
  float four_mass;
  float two_pi;
  float gx1, gy1, gz1;    // N-1 per axis (Periodic)
  float half_dt;
  float vshift;           // the energy-gauge shift baked into the array B
  float absorb;           // Im V = absorb*V (the split-complex potentials)
};

// nx, ny, nz: the global extents; ox, oy, oz: the block's origin in them.
inline Analytic make_analytic(int nx, int ny, int nz, int ox, int oy, int oz, int kind, double dn,
                              double dt, double mass, double sig, double vshift, double absorb) {
  Analytic an;
  an.kind = kind;
  an.ox = ox;
  an.oy = oy;
  an.oz = oz;
  an.cx = (float)((nx + 1.0) / 2.0);
  an.cy = (float)((ny + 1.0) / 2.0);
  an.cz = (float)((nz + 1.0) / 2.0);
  an.dn = (float)dn;
  an.half_dn2 = (float)(0.5 * dn * dn);
  an.neg_inv_dn = (float)(-1.0 / dn);
  an.cornell_c = (float)(-0.5 * (4.0 / 3.0));
  an.sig = (float)sig;
  an.four_mass = (float)(4.0 * mass);
  an.two_pi = (float)(2.0 * 3.14159265358979323846);
  an.gx1 = (float)(nx - 1.0);
  an.gy1 = (float)(ny - 1.0);
  an.gz1 = (float)(nz - 1.0);
  an.half_dt = (float)(0.5 * dt);
  an.vshift = (float)vshift;
  an.absorb = (float)absorb;
  return an;
}

template <int EXT>
__device__ __forceinline__ float tap(int o) {
  if constexpr (EXT == 1) {
    return 1.0f;
  } else if constexpr (EXT == 2) {
    return o == 1 ? 16.0f : -1.0f;
  } else {
    return o == 1 ? 270.0f : (o == 2 ? -27.0f : 2.0f);
  }
}

template <int EXT>
__device__ __forceinline__ float center() {
  if constexpr (EXT == 1) {
    return 6.0f;
  } else if constexpr (EXT == 2) {
    return 90.0f;
  } else {
    return 1470.0f;
  }
}

// Raw V (no gauge shift) at the block's padded index (i, j, k), that is at
// global padded index (i + ox, j + oy, k + oz), as pallas_stencil._analytic_v.
__device__ __forceinline__ float analytic_v(const Analytic& a, int i, int j, int k) {
  i += a.ox;
  j += a.oy;
  k += a.oz;
  if (a.kind == kPeriodic) {
    const float sx = sinf(a.two_pi * ((float)i - 1.0f) / a.gx1);
    const float sy = sinf(a.two_pi * ((float)j - 1.0f) / a.gy1);
    const float sz = sinf(a.two_pi * ((float)k - 1.0f) / a.gz1);
    return 1.0f - (sx * sx) * ((sy * sy) * (sz * sz));
  }
  const float dx = (float)i - a.cx;
  const float dy = (float)j - a.cy;
  const float dz = (float)k - a.cz;
  const float r2 = dx * dx + (dy * dy + dz * dz);
  if (a.kind == kHarmonic) return a.half_dn2 * r2;
  if (a.kind == kCoulomb || a.kind == kSimpleCornell) {
    const float r = a.dn * sqrtf(r2);
    const float rs = fmaxf(r, a.dn);
    if (a.kind == kCoulomb) return r < a.dn ? a.neg_inv_dn : -1.0f / rs;
    return r < a.dn ? a.four_mass : (a.cornell_c / rs + a.sig * rs) + a.four_mass;
  }
  return 0.0f;
}

// Sum over the block in a fixed order (warp shuffles, then warp 0); the
// result is valid in thread 0. Every thread of the block must call it.
template <int NTHREADS>
__device__ __forceinline__ double block_sum(double v, double* warp_sums) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = v;
  __syncthreads();
  if (tid < 32) {
    v = tid < NTHREADS / 32 ? warp_sums[tid] : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  __syncthreads();  // warp_sums is reused by the next call
  return v;
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// One thread per point of the padded grid: grid = (ceil(NZp/32),
// ceil(NYp/8), NXp). Threads on the shell write its zeros.
inline dim3 sweep_grid(int nx, int ny, int nz, int ext) {
  return dim3(cdiv(nz + 2 * ext, kBlockZ), cdiv(ny + 2 * ext, kBlockY), nx + 2 * ext);
}

}  // namespace
