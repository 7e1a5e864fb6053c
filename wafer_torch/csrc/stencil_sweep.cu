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
//   potentials (as pallas_stencil._analytic_b, with an IEEE divide in place
//   of the TPU's Horner series) or streamed from b_int. The correction is
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
// What holds it at ~50-60 % of the byte bound on an H100 (PERF.md, from
// tools/tune_sweep.py and chip_smoke.py): issued instructions, ~100 a
// point (the stencil, B's divide, the ring, the halo, 64-bit addresses),
// at a few resident blocks an SM; a contiguous copy of the same bytes runs
// at 80-90 %. Two rows a thread halve the per-plane overhead a point;
// a grid with few tiles walks shorter segments (march_segment) so that
// its blocks still fill the card.
// Tile: 8 x 32 threads, two rows each; segments of up to 16 planes.

// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: B needs an IEEE divide and
//        denormals must behave as IEEE says).

#include "sweep_common.cuh"

namespace {

constexpr int kTileY = 8;          // thread rows of a block: 256 threads
constexpr int kRows = 2;           // tile rows a thread owns: 16 x 32 tiles
constexpr int kSegment = 16;       // x-planes a block walks, at most
constexpr int kRingBytes = 49152;  // shared memory of the copy ring: its steps ahead
constexpr int kMinBlocks = 1;      // blocks an SM must hold: caps registers a thread
constexpr int kThreads = kTileZ * kTileY;

template <int EXT, int NS>
__global__ void __launch_bounds__(kThreads, kMinBlocks) sweep_step_kernel(const SweepArgs a) {
  march<EXT, 1, NS, kTileY, kRows, kRingBytes>(a);
}

template <int EXT, int NS>
void launch_sweep_step_ns(const SweepArgs& a, cudaStream_t s) {
  constexpr int bytes = March<EXT, 1, NS, kTileY, kRows>::ring_bytes(kRingBytes);
  // the ring may pass the 48 KB a launch gets without asking (set once)
  static const cudaError_t allowed = cudaFuncSetAttribute(
      sweep_step_kernel<EXT, NS>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  (void)allowed;  // a refusal shows as the launch's error
  const dim3 grid = march_grid<kTileY * kRows>(a.nx, a.ny, a.nz, a.seg);
  sweep_step_kernel<EXT, NS><<<grid, dim3(kTileZ, kTileY, 1), bytes, s>>>(a);
}

template <int EXT>
void launch_sweep_step(const SweepArgs& a, cudaStream_t s) {
  switch (a.n_store) {
    case 0:
      launch_sweep_step_ns<EXT, 0>(a, s);
      break;
    case 1:
      launch_sweep_step_ns<EXT, 1>(a, s);
      break;
    case 2:
      launch_sweep_step_ns<EXT, 2>(a, s);
      break;
    default:
      launch_sweep_step_ns<EXT, kAnyS>(a, s);
  }
}

}  // namespace

extern "C" {

// Rows of the (n_blocks, 1+S) partials scratch one sweep_step writes.
int wafer_sweep_num_blocks(int nx, int ny, int nz, int ext) {
  (void)ext;
  const dim3 g = march_grid<kTileY * kRows>(nx, ny, nz,
                                            march_segment<kTileY * kRows, kSegment>(nx, ny, nz));
  return (int)(g.x * g.y * g.z);
}

// psi/out: (nx+2e, ny+2e, nz+2e) f32; b_int: (nx, ny, nz) f32 or NULL when
// kind >= 0; store: (n_store, nx+2e, ny+2e, nz+2e) f32 or NULL; coef:
// (1+n_store) f32 on the device; partials: (n_blocks, 1+n_store) f64 or
// NULL for no reductions. (gnx, gny, gnz) are the global extents of the
// analytic B and (ox, oy, oz) the block's origin in them: (nx, ny, nz) and
// 0 on one device. Returns cudaGetLastError() after the launch.
int wafer_sweep_step(const float* psi, float* out, const float* b_int,
                     const float* store, const float* coef, double* partials,
                     int nx, int ny, int nz, int ext, int n_store, int apply,
                     double scale, int kind, int gnx, int gny, int gnz, int ox, int oy,
                     int oz, double dn, double dt, double mass, double sig, double vshift,
                     void* stream) {
  SweepArgs a;
  a.psi = psi;
  a.out = out;
  a.b = b_int;
  a.store = store;
  a.coef = coef;
  a.partials = partials;
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  a.n_store = n_store;
  a.apply = apply;
  a.seg = march_segment<kTileY * kRows, kSegment>(nx, ny, nz);
  a.scale = (float)scale;
  a.an = make_analytic(gnx, gny, gnz, ox, oy, oz, kind, dn, dt, mass, sig, vshift, 0.0);
  cudaStream_t s = (cudaStream_t)stream;
  switch (ext) {
    case 1:
      launch_sweep_step<1>(a, s);
      break;
    case 2:
      launch_sweep_step<2>(a, s);
      break;
    case 3:
      launch_sweep_step<3>(a, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* wafer_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
