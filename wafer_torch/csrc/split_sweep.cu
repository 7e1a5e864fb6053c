// Hopper (sm_90a) kernel of the split-complex imaginary-time sweep, with a
// plain C interface bound by ctypes in wafer_torch/ops/hopper_split.py.
//
// K3 sweep_step_sc<EXT> replaces wafer_tpu/ops/pallas_split.py
//   _evolve_kernel_sc (B8, one sweep of the (re, im) pair with the carried
//   correction) and, launched once per step with K2 finish_coef
//   (finish_coef.cu) after it, the chunk kernels _evolve_kernel_res_sc
//   (B9), _evolve_kernel_resb_sc (B10), _evolve_kernel_res_mixed_sc (B7) and
//   _evolve_kernel_k_sc (B11). Given a shard block's global origin it also
//   computes their sharded modes (B8 and B9 with x_origin, B12) and the
//   multi-axis _evolve_kernel_sc_yzp (B15). On one device all five compute n steps of
//       c     = inv*psi - sum_s (cr_s + i*ci_s)*l_s    (once per point it reads)
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
//   Each block writes one row of partial sums of |psi'|^2, Re<l_s|psi'>
//   and Im<l_s|psi'> (conjugated, as split_complex._overlap; f32 products,
//   f64 sums) to a (n_blocks, 1+2S) scratch; K2 adds them in a fixed order and
//   writes the next coef = [inv, Re ov_s*inv, Im ov_s*inv], which is the
//   split recursion of pallas_split.py:595-598. No atomics: a seeded run is
//   bit-reproducible.
//
// Layout: psi/out (2, NXp, NYp, NZp) with re then im, fully padded; B
//   (2, NX, NY, NZ); stored states (S, 2, NXp, NYp, NZp); coef (1+2S) f32.
//
// What bounds K3: HBM bytes, as for K1. A ground step with analytic B must
// read the pair once and write it once, 16 B per grid point; streamed B
// adds 8 B and each stored pair 8 B. The arithmetic is about 40 flops per
// point at the 7-point stencil plus two divides for B, below the card's
// 20 flops per byte; tensor cores have nothing to do here. The design is
// K1's x-marching tiled sweep (sweep_common.cuh, march) with two
// components: one thread computes both components of its column, so the
// queue, the shared plane and the correction [inv, cr_s, ci_s], applied
// once per point, serve re and im together. B's y/z part is computed once
// per column; each block sums |psi'|^2, Re<l_s|psi'> and Im<l_s|psi'>
// once at the end of its segment and writes one partial row.
// Tile: the 16 x 32 tile of K1, so both write 16,384 rows at 512^3, but
// one row a thread (16 x 32 threads): a pair thread holds twice K1's
// values, and two rows a thread cost K3 more in occupancy than they saved
// in instructions (PERF.md, tools/tune_sweep.py). kMinBlocks = 2 caps a
// thread at 64 registers; some EXT 2-3 instantiations spill a few words
// to L1 for it (none at EXT 1 S = 0, 1: chip_smoke phase 1).
// What holds it: as K1, issued instructions, here under the 64-register
// cap. K3 keeps the march's plain forms (sweep_common.cuh without LEAN):
// each change that made K1 faster was tried on it, and each, alone or
// with the others, left the ThreePoint S = 1 launch or the 512^3 ground
// launch 2-10 % slower (tools/tune_sweep.py, PERF.md): a pointer a copy
// stepped one plane a fetch (the im component vol further, or a pointer
// of its own), B's kind tested once a plane, B's ring field read only
// where B streams, psi' through a stepped pointer, the plane loop
// unrolled three planes, and a looser bound (one block of 512 threads an
// SM, up to 128 registers: 30-39 % slower at S = 1). A tighter one (three
// blocks, 40 registers) was not tried.

#include "sweep_common.cuh"

namespace {

constexpr int kTileY = 16;         // thread rows of a block: 512 threads
constexpr int kRows = 1;           // tile rows a thread owns: 16 x 32 tiles, as K1's
constexpr int kRingBytes = 49152;  // shared memory of the copy ring: its steps ahead
constexpr int kMinBlocks = 2;      // blocks an SM must hold: caps registers a thread at 64
constexpr int kThreads = kTileZ * kTileY;
static_assert(kTileY * kRows == kTileRows, "K3 launches the one tile grid");

template <int EXT, int NS, bool WIN>
__global__ void __launch_bounds__(kThreads, kMinBlocks) sweep_step_sc_kernel(const SweepArgs a) {
  if (skipped(a.done)) return;
  march<EXT, 2, NS, kTileY, kRows, kRingBytes, WIN, 1>(a);
}

template <int EXT, int NS, bool WIN>
void launch_sweep_step_sc_ns(const SweepArgs& a, cudaStream_t s) {
  constexpr int bytes = March<EXT, 2, NS, kTileY, kRows>::ring_bytes(kRingBytes);
  // the ring may pass the 48 KB a launch gets without asking (set once)
  static const cudaError_t allowed = cudaFuncSetAttribute(
      sweep_step_sc_kernel<EXT, NS, WIN>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  (void)allowed;  // a refusal shows as the launch's error
  sweep_step_sc_kernel<EXT, NS, WIN><<<sweep_grid(a), dim3(kTileZ, kTileY, 1), bytes, s>>>(a);
}

}  // namespace

extern "C" {

int launch_k3(const SweepArgs& a, int ext, cudaStream_t s) {
  return with_ext(ext, [&](auto e) {
    return with_window(a, [&](auto w) {
      constexpr int EXT = decltype(e)::value;
      constexpr bool WIN = decltype(w)::value;
      if (a.n_store == 0) launch_sweep_step_sc_ns<EXT, 0, WIN>(a, s);
      if (a.n_store == 1) launch_sweep_step_sc_ns<EXT, 1, WIN>(a, s);
      if (a.n_store == 2) launch_sweep_step_sc_ns<EXT, 2, WIN>(a, s);  // sweep_route: no other
      return (int)cudaGetLastError();
    });
  });
}

// psi/out: (2, nx+2e, ny+2e, nz+2e) f32; b2: (2, nx, ny, nz) f32 or NULL
// when kind >= 0 (Harmonic or Coulomb); store: (n_store, 2, nx+2e, ny+2e,
// nz+2e) f32 or NULL; coef: (1+2*n_store) f32 on the device; partials:
// (wafer_sweep_num_blocks, 1+2*n_store) f64 or NULL for no reductions.
// (gnx, gny, gnz), (ox, oy, oz) and the reduction window [red_x0, red_x1):
// the global extents, the block's origin and the planes the partials sum,
// and the batch's flag done, as wafer_sweep_step. The launch takes the
// route of sweep_route. Returns cudaGetLastError() after the launch.
int wafer_sweep_step_sc(const float* psi, float* out, const float* b2, const float* store,
                        const float* coef, double* partials, int nx, int ny, int nz, int ext,
                        int n_store, int apply, double scale, int kind, int gnx, int gny,
                        int gnz, int ox, int oy, int oz, double dn, double dt, double vshift,
                        double absorb, int red_x0, int red_x1, const int* done, void* stream) {
  const int route = sweep_route(true, n_store, false);
  if ((kind != kStreamed && kind != kHarmonic && kind != kCoulomb) || route == kRouteNone) {
    return (int)cudaErrorInvalidValue;
  }
  const SweepArgs a = make_sweep_args(route, psi, out, b2, store, coef, partials, nx, ny, nz,
                                      n_store, apply, scale, kind, gnx, gny, gnz, ox, oy, oz, dn,
                                      dt, 0.0, 0.0, vshift, absorb, red_x0, red_x1, done);
  return launch_route(route, a, ext, (cudaStream_t)stream);
}

}  // extern "C"
