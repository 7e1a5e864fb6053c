// Hopper (sm_90a) kernels of the imaginary-time sweep, with a plain C
// interface bound by ctypes in wafer_torch/ops/hopper_stencil.py.
//
// K1 sweep_step<EXT> replaces wafer_tpu/ops/pallas_stencil.py
//   _evolve_kernel (B2, one sweep with the carried correction) and, launched
//   once per step with K2 after it, _evolve_kernel_res in its ground (B1),
//   per-step-norm and excited (B3) modes, and the large-grid kernels that
//   compute the same chunk with another VMEM schedule: _evolve_kernel_k (B5,
//   K ground steps per pass), _evolve_kernel_resb (B6, R deep-halo ground
//   steps per x-block) and _evolve_kernel_kgs (B4, two normalise+project
//   steps per pass with the correction deferred through Gram matrices).
//   On a shard block of a device mesh (parallel/sharded.py), whose halo
//   holds the neighbours' faces and zeros at global edges, it takes the
//   block's global origin and the global extents for B, and so computes the
//   sharded modes of those kernels and the mesh-only kernels
//   _evolve_kernel_res/_evolve_kernel_k with x_origin and edges (B12, B5),
//   _evolve_kernel_yzp (B13) and the R-step windows _evolve_kernel_res_yzp /
//   _evolve_kernel_resb_yzp (B14), once per step: each block's partials
//   land in its own row range of one buffer (a pointer offset), and one K2
//   adds every shard's rows.
//   Offsets are 64-bit (ptrdiff_t): at 512^3 with two stored states
//   s*vol + q reaches 2.7e8, and one stored state at 1024^3 passes 2^31.
//   It computes, on the fully padded (N+2e)^3 layout,
//       c     = inv*psi - sum_s corr_s*l_s       (once per point it reads)
//       psi'  = B*(2c + scale*L(c)) - c          (interior)
//       psi'  = 0                                (the Dirichlet shell)
//   with B = 1/(1 + dt/2*(V - vshift)) from coordinates for the analytic
//   potentials (pallas_stencil._analytic_b's V, Coulomb's and
//   SimpleCornell's from one rsqrt, with one IEEE reciprocal in place of
//   the TPU's Horner series) or streamed from b_int. The correction is
//   applied to the input, as B2 does, once per point; the S(l) form of the
//   resident TPU kernel (correct once at the centre with precomputed swept
//   images) is the same recursion by linearity and is not used here.
//   Each block writes one row of partial sums of |psi'|^2 and <l_s|psi'>
//   (f32 products, f64 sums) to a (n_blocks, 1+S) scratch when reductions
//   are on.

// K2 finish_coef (csrc/finish_coef.cu) adds those rows in a fixed order
//   and writes the next step's coefficients.
//
// What bounds K1. Its least work is HBM bytes: psi read and psi' written
// once, 8 B a grid point, 4 B more for a streamed B and for each stored
// state. Its ~30 flops a point are far below the card's 20 flops a byte,
// and tensor cores have nothing to do here. The design (sweep_common.cuh,
// march) moves those bytes once: a block owns a 16 x 32 (y, z) tile and
// walks up to kSegment x-planes; each thread keeps two columns' corrected
// values for x = i-EXT..i+EXT in register queues and publishes the centres
// into a shared plane with an EXT-deep y/z halo, so each psi, l_s and
// streamed B value is read once (plus the tile's halo and the segment's
// 2*EXT planes of overlap, mostly L2 hits), the correction is applied once
// per point, not at every tap, and the centre l_s of <l_s|psi'> stays in
// registers. Each thread adds its products down its columns in f64 and
// the block sums once at the end: one partial row per block, 16,384 at
// 512^3 where the one-thread-per-point kernel wrote 567,970.
// Loads: the padded rows (NZp = N + 2*EXT floats) do not start on 16-byte
// boundaries, so neither TMA (16-byte global strides) nor 16-byte cp.async
// or float4 loads fit the layout; 4-byte cp.async copies fill a ring in
// shared memory kRingBytes deep and stay in flight across the per-plane
// barrier (register loads issued one to four planes ahead measured no
// faster than one plane ahead).
// What holds it at ~50-65 % of the byte bound on an H100 (PERF.md, from
// tools/tune_sweep.py and chip_smoke.py): issued instructions (the
// stencil, B, the ring, the halo, 64-bit addresses), at a few resident
// blocks an SM; a contiguous copy of the same bytes runs at 80-90 %. Two
// rows a thread halve the per-plane overhead a point; a grid with few
// tiles walks shorter segments (march_segment) so that its blocks still
// fill the card. The march's LEAN forms cut the instructions around the
// arithmetic and keep more warps resident (the changes K1's bf16 sweep
// measured first), each kept only where the card showed it faster:
// - each copy has a pointer of its own that steps one plane a fetch, and
//   so does each column's psi' (all instantiations);
// - a Harmonic B is computed once a plane for both columns, its x part
//   taken once (harmonic_b), and the ring's B field read only where B
//   streams;
// - launch bounds of three blocks of 256 threads an SM, 80 registers,
//   where the sweep fits them without spilling (min_blocks): S = 1 at
//   every EXT and S = 2 at EXT 1, which nvcc left at 72-96 registers, and
//   past 80 an SM holds two blocks; S = 0 left to nvcc (64-78 registers,
//   three or four blocks);
// - the plane loop unrolled three planes, the x-queue's length, at EXT 1
//   for S = 0 and 1 (unroll), where the queues then shift by renaming.
// The costly kinds of B. Coulomb's and SimpleCornell's V took an IEEE sqrt
// and two IEEE reciprocals a point, Periodic's a sine and a divide, each a
// multi-instruction sequence with a slow-path call: twelve MUFU and twelve
// CALL in a plane loop of 664-750 instructions, and launches 12-30 %
// behind Harmonic's at 256^3 and 512^3. They take k1_b (sweep_common.cuh),
// which both K1 marches share: V from one MUFU rsqrt (radial_v), one IEEE
// reciprocal for B, Periodic's sine once a plane; and they run on kernels
// of their own, sweep_step_costly_kernel (launch_sweep_step_b), whose plane
// loop issues five MUFU and three CALL a plane, 6-21 % faster a launch
// (PERF.md). Their form was measured apart: B once a
// plane for both columns, before the stencil (level with B beside each
// column's stencil, within 2 %), and the loop unrolled at EXT 1 S = 1
// (unroll). The other sources of B keep the kernel they had,
// sweep_step_kernel, its machine code unchanged (the costly kinds' IEEE
// path in it included, which no launch takes any more): nvcc allocates a
// kernel's registers for every path of its loop, and with the new costly
// path beside Harmonic's the Harmonic launches ran 3 % slower, with none
// at all (126 registers, two blocks an SM) 28 % at S = 0, and with none
// and S = 0 bounded to three or four blocks an SM 4-19 % at S = 0 (PERF.md).
// nvcc's report (chip_smoke phase 1): 62-80 registers at EXT 1 S = 0..2,
// none spilled. Tile: 8 x 32 threads, two rows each; segments of up to 16
// planes. Given a batch's flag `done` that is set, every block returns
// before it reads or writes anything: the chunks after a batch's
// convergence verdict cost their launches only (the reference's
// lax.cond(done, idle, work)).
// This is K1's route for up to two f32 stored states. wafer_sweep_step
// sends every other launch by the one route rule (sweep_route,
// sweep_common.cuh) to a source whose note says how it differs: a bf16
// store (the reference's default excited-state streams) to
// stencil_sweep_bf16.cu, three and four stored states to
// stencil_sweep_many.cu (the count fixed at compile time), and more to
// the wide route, stencil_sweep_wide.cu (the count read at run time).

// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: B needs an IEEE reciprocal,
//        and denormals must behave as IEEE says; rsqrtf is the MUFU's
//        approximation either way).

#include "sweep_common.cuh"

namespace {

constexpr int kTileY = 8;          // thread rows of a block: 256 threads
constexpr int kRows = 2;           // tile rows a thread owns: 16 x 32 tiles
constexpr int kRingBytes = 49152;  // shared memory of the copy ring: its steps ahead
constexpr int kMinBlocks = 1;      // blocks an SM must hold at least: caps registers a thread
constexpr int kThreads = kTileZ * kTileY;
static_assert(kTileY * kRows == kTileRows, "K1 launches the one tile grid");

// Blocks an SM must hold for the sweep of (EXT, NS): three, 80 registers a
// thread, where the sweep fits them without spilling and left to itself
// nvcc passes 80 (S = 1; S = 2 at EXT 1), and kMinBlocks else (past 80
// registers an SM holds two blocks of 256 threads, not three). S = 0 is
// left to nvcc (64-78 registers, three or four blocks): it measured
// slower under a bound of three or four (PERF.md, tools/tune_sweep.py);
// chip_smoke phase 1 fails if EXT 1 no longer fits three.
template <int EXT, int NS>
constexpr int min_blocks() {
  return NS == 1 || (NS == 2 && EXT == 1) ? 3 : kMinBlocks;
}

// Planes a pass of the plane loop: the x-queue's length (three), at EXT 1,
// where the queues then shift by renaming. In the kernel of the cheap
// kinds of B (Harmonic, none, streamed) for S = 0 and 1; in the costly
// kinds' for S = 1 alone, where it measured 12-20 % faster (three blocks
// an SM at 76 registers against four at 64): at S = 0 it measured level,
// with B's IEEE sqrt and divides 7-8 % slower (PERF.md, tools/tune_sweep.py).
template <int EXT, int NS>
__host__ __device__ constexpr int unroll(bool costly_b) {
  return EXT == 1 && (NS == 1 || (NS == 0 && !costly_b)) ? 3 : 1;
}

// K1 for every source of B but the costly kinds.
template <int EXT, int NS, bool WIN, int UNROLL>
__global__ void __launch_bounds__(kThreads, (min_blocks<EXT, NS>())) sweep_step_kernel(
    const SweepArgs a) {
  if (skipped(a.done)) return;
  march<EXT, 1, NS, kTileY, kRows, kRingBytes, WIN, UNROLL>(a);
}

// K1 for Coulomb, SimpleCornell and Periodic B (k1_b).
template <int EXT, int NS, bool WIN, int UNROLL>
__global__ void __launch_bounds__(kThreads, (min_blocks<EXT, NS>())) sweep_step_costly_kernel(
    const SweepArgs a) {
  if (skipped(a.done)) return;
  march<EXT, 1, NS, kTileY, kRows, kRingBytes, WIN, UNROLL, true>(a);
}

template <int EXT, int NS, bool WIN, bool COSTLY>
void launch_sweep_step_ns(const SweepArgs& a, cudaStream_t s) {
  constexpr int bytes = March<EXT, 1, NS, kTileY, kRows>::ring_bytes(kRingBytes);
  constexpr int UNROLL = unroll<EXT, NS>(COSTLY);
  void (*kernel)(const SweepArgs) = nullptr;
  if constexpr (COSTLY) {
    kernel = sweep_step_costly_kernel<EXT, NS, WIN, UNROLL>;
  } else {
    kernel = sweep_step_kernel<EXT, NS, WIN, UNROLL>;
  }
  // the ring may pass the 48 KB a launch gets without asking (set once)
  static const cudaError_t allowed =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  (void)allowed;  // a refusal shows as the launch's error
  kernel<<<sweep_grid(a), dim3(kTileZ, kTileY, 1), bytes, s>>>(a);
}

// The kernel of a launch's source of B: the costly kinds' own, or the one
// of the others.
template <int EXT, int NS, bool WIN>
void launch_sweep_step_b(const SweepArgs& a, cudaStream_t s) {
  if (costly_kind(a.an.kind)) {
    launch_sweep_step_ns<EXT, NS, WIN, true>(a, s);
  } else {
    launch_sweep_step_ns<EXT, NS, WIN, false>(a, s);
  }
}

}  // namespace

extern "C" {

int launch_k1_f32(const SweepArgs& a, int ext, cudaStream_t s) {
  return with_ext(ext, [&](auto e) {
    return with_window(a, [&](auto w) {
      constexpr int EXT = decltype(e)::value;
      constexpr bool WIN = decltype(w)::value;
      if (a.n_store == 0) launch_sweep_step_b<EXT, 0, WIN>(a, s);
      if (a.n_store == 1) launch_sweep_step_b<EXT, 1, WIN>(a, s);
      if (a.n_store == 2) launch_sweep_step_b<EXT, 2, WIN>(a, s);  // sweep_route: no other
      return (int)cudaGetLastError();
    });
  });
}

// The route a launch takes (sweep_route): pair non-zero for K3's
// (wafer_sweep_step_sc), store_bf16 non-zero for a bf16 store.
int wafer_sweep_route(int pair, int n_store, int store_bf16) {
  return sweep_route(pair != 0, n_store, store_bf16 != 0);
}

// The most stored states K1's many-state route takes (it takes kManyMinS
// and more).
int wafer_sweep_many_max(void) { return kManyS; }

// The fewest stored states the wide route takes: K1's (pair = 0) past the
// many-state kernels' counts, K3's (pair != 0) past its fixed counts 0..2.
int wafer_sweep_wide_min(int pair) { return pair ? kPairMinS : wafer_sweep_many_max() + 1; }

// Rows of the (n_blocks, 1+NC*S) partials scratch one launch of K1 or K3
// writes, on every route (the one launch shape).
int wafer_sweep_num_blocks(int nx, int ny, int nz, int ext) {
  (void)ext;
  const dim3 g = march_grid(nx, ny, nz, march_segment(nx, ny, nz));
  return (int)(g.x * g.y * g.z);
}

// psi/out: (nx+2e, ny+2e, nz+2e) f32; b_int: (nx, ny, nz) f32 or NULL when
// kind >= 0; store: (n_store, nx+2e, ny+2e, nz+2e) f32, or bf16 when
// store_bf16 is non-zero (its address a multiple of 4 bytes), or NULL;
// coef: (1+n_store) f32 on the device; partials: (n_blocks, 1+n_store) f64
// or NULL for no reductions. (gnx, gny, gnz) are the global extents of the
// grid and of the analytic B, and (ox, oy, oz) the block's origin in them:
// (nx, ny, nz) and 0 on one device. Interior x-planes whose global index
// ox + i lies outside [0, gnx) (a deep x pad past a global face) are
// written zero; the partials sum the planes of [red_x0, red_x1) among the
// others ((0, nx): all of them). done: NULL, or a device int that, when
// non-zero, makes the launch write nothing (a batch's chunks after its
// convergence verdict). The launch takes the route of sweep_route.
// Returns cudaGetLastError() after the launch.
int wafer_sweep_step(const float* psi, float* out, const float* b_int,
                     const void* store, const float* coef, double* partials,
                     int nx, int ny, int nz, int ext, int n_store, int apply,
                     double scale, int kind, int gnx, int gny, int gnz, int ox, int oy,
                     int oz, double dn, double dt, double mass, double sig, double vshift,
                     int red_x0, int red_x1, const int* done, int store_bf16, void* stream) {
  const int route = sweep_route(false, n_store, store_bf16 != 0);
  if (route == kRouteNone) return (int)cudaErrorInvalidValue;
  const SweepArgs a = make_sweep_args(route, psi, out, b_int, store, coef, partials, nx, ny, nz,
                                      n_store, apply, scale, kind, gnx, gny, gnz, ox, oy, oz, dn,
                                      dt, mass, sig, vshift, 0.0, red_x0, red_x1, done);
  return launch_route(route, a, ext, (cudaStream_t)stream);
}

const char* wafer_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
