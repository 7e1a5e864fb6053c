// Helpers shared by the sweep kernels (stencil_sweep.cu, split_sweep.cu,
// stencil_sweep_bf16.cu, _many.cu, _wide.cu): the stencil taps, the
// analytic potentials on padded-index coordinates, the fixed-order block
// sum, the x-marching tiled sweep that both K1 (one component) and K3 (the
// (re, im) pair) run (K1's other routes have marches of their own on the
// same tiles), the one launch shape, and the launch front: the route rule,
// the launch arguments and the EXT and window switches.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTileZ = 32;  // threads along z, the contiguous axis: one warp per tile row

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

// The part of the analytic V that is the same down a whole x-column, at
// the block's padded (j, k), that is at global padded (j + oy, k + oz):
// dy*dy + dz*dz, or for Periodic (sy*sy)*(sz*sz).
__device__ __forceinline__ float analytic_column(const Analytic& a, int j, int k) {
  j += a.oy;
  k += a.oz;
  if (a.kind == kPeriodic) {
    const float sy = sinf(a.two_pi * ((float)j - 1.0f) / a.gy1);
    const float sz = sinf(a.two_pi * ((float)k - 1.0f) / a.gz1);
    return (sy * sy) * (sz * sz);
  }
  const float dy = (float)j - a.cy;
  const float dz = (float)k - a.cz;
  return dy * dy + dz * dz;
}

// Raw V (no gauge shift) at the block's padded plane i of the column whose
// analytic_column is col: pallas_stencil._analytic_v at global padded index
// (i + ox, j + oy, k + oz). The expressions are the reference's,
// dx*dx + (dy*dy + dz*dz) and 1 - (sx*sx)*((sy*sy)*(sz*sz)), with the
// bracket computed once per column, and Coulomb's and SimpleCornell's r
// from an IEEE sqrt and their 1/r from IEEE divides. K3's, and the path of
// K1's kernels for the other kinds that NoPotential takes; K1's costly
// kinds take k1_b.
__device__ __forceinline__ float analytic_v_ieee(const Analytic& a, float col, int i) {
  i += a.ox;
  if (a.kind == kHarmonic) {
    const float dx = (float)i - a.cx;
    const float r2 = dx * dx + col;
    return a.half_dn2 * r2;
  }
  if (a.kind == kPeriodic) {
    const float sx = sinf(a.two_pi * ((float)i - 1.0f) / a.gx1);
    return 1.0f - (sx * sx) * col;
  }
  const float dx = (float)i - a.cx;
  const float r2 = dx * dx + col;
  if (a.kind == kCoulomb || a.kind == kSimpleCornell) {
    const float r = a.dn * sqrtf(r2);
    const float rs = fmaxf(r, a.dn);
    if (a.kind == kCoulomb) return r < a.dn ? a.neg_inv_dn : -1.0f / rs;
    return r < a.dn ? a.four_mass : (a.cornell_c / rs + a.sig * rs) + a.four_mass;
  }
  return 0.0f;
}

// The kinds of B that K1 launches on kernels of their own (march's and
// march_bf16's COSTLY): Coulomb, SimpleCornell and Periodic, by k1_b. Every
// other source of B keeps the kernels it had before them, whose code is
// unchanged (the costly kinds' IEEE path, which no launch takes there,
// included): nvcc allocates a sweep's registers for all the paths its loop
// holds, and with the new costly path beside Harmonic's, or with none (its
// S = 0 launch bound to three or four blocks an SM or not), the Harmonic
// launches measured 3-28 % slower (PERF.md).
__host__ __device__ constexpr bool costly_kind(int kind) {
  return kind == kCoulomb || kind == kSimpleCornell || kind == kPeriodic;
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

// What one sweep reads and writes. NC components (1 for K1, 2 for the
// pair of K3), each a fully padded (nx+2e, ny+2e, nz+2e) f32 array.
struct SweepArgs {
  const float* psi;   // (NC, NXp, NYp, NZp)
  float* out;         // (NC, NXp, NYp, NZp), never psi
  const float* b;     // streamed B (NC, nx, ny, nz), or NULL when an.kind >= 0
  const float* store; // (S, NC, NXp, NYp, NZp) or NULL
  const float* coef;  // (1 + NC*S): [inv, corr_0, ...], pair [inv, cr_0, ci_0, ...]
  double* partials;   // (blocks, 1 + NC*S) or NULL for no reductions
  int nx, ny, nz, n_store, apply;
  int seg;             // x-planes a block walks (march_segment)
  float scale;
  Analytic an;
  // Interior x-planes [grid_x0, grid_x1) lie inside the global grid; the
  // others (a deep x pad past a global face) are written zero. The partial
  // sums add the planes of [red_x0, red_x1), a window inside those. Last,
  // so the fields before them keep the parameter offsets they had without
  // them.
  int grid_x0, grid_x1, red_x0, red_x1;
  // A batch's flag (solver batching): when it points at a non-zero int the
  // launch does nothing; NULL outside a batch. Last, for the same reason.
  const int* done;
  // The stored states streamed in bf16 (S, NXp, NYp, NZp), read in place
  // of `store` by K1's bf16 sweep (stencil_sweep_bf16.cu); NULL otherwise.
  // Last, for the same reason; its address is a multiple of 4 bytes.
  const __nv_bfloat16* store_bf16 = nullptr;
  // K1's SimpleCornell 1/r factor, -0.5*(4/3)/dn (radial_v), rounded from
  // double as Analytic's fields are (cornell_c_over_dn). Last, for the same
  // reason: in Analytic, it moved K3's parameters and its machine code.
  float cornell_c_dn = 0.0f;
};

inline float cornell_c_over_dn(double dn) { return (float)(-0.5 * (4.0 / 3.0) / dn); }

// K1's analytic B for every kind but Harmonic (harmonic_b), the one helper
// of both K1 marches (march, and march_bf16 in stencil_sweep_bf16.cu), so
// both give each point the same bits. Its parts:
//
// k1_plane: the part of V that is the same over the block's padded plane
// i: dx for Coulomb and SimpleCornell, and for Periodic sx*sx,
// analytic_v_ieee's expression (its sine and divide once a plane, not once
// a point, and Periodic's B keeps its bits).
__device__ __forceinline__ float k1_plane(const Analytic& a, int i) {
  i += a.ox;
  if (a.kind == kPeriodic) {
    const float sx = sinf(a.two_pi * ((float)i - 1.0f) / a.gx1);
    return sx * sx;
  }
  return (float)i - a.cx;
}

// radial_v: Coulomb's and SimpleCornell's V at r2 = (r/dn)^2 from one
// rsqrt, y = 1/sqrt(r2) (MUFU, within 2 ulp), each rounding spelled out.
// Coulomb: -1/r = (-1/dn)*y. SimpleCornell: (-2/3)/r + sig*r + 4m, its
// 1/r as (-2/3/dn)*y and its r as dn*s, s = sqrt(r2) from r2*y and one
// Newton step (two FMAs, within an ulp): sig*r is most of V far from the
// core, and the step keeps it to the reference's rounding there. The
// reference's core, r < dn, is r2 < 1: r2 is a sum of squares of integers
// or half-integers, exact in f32, and r2 >= 1 gives sqrt(r2) >= 1, so
// r >= dn. Where r2 < 1 (y may be inf, and r2*y NaN at r2 = 0) the select
// takes the core's value. The reference's form (analytic_v_ieee) takes an
// IEEE sqrt and two divides, each a multi-instruction sequence with a
// slow-path branch. B's relative change is V's times dt/2*|V|*B: within
// two ulp of the reference's B at the examples' steps
// (tests/test_torch_bform.py).
__device__ __forceinline__ float radial_v(const SweepArgs& sa, float r2) {
  const Analytic& a = sa.an;
  const float y = rsqrtf(r2);
  if (a.kind == kCoulomb) return r2 < 1.0f ? a.neg_inv_dn : __fmul_rn(a.neg_inv_dn, y);
  const float r0 = __fmul_rn(r2, y);
  const float s = __fmaf_rn(__fmul_rn(0.5f, y), __fmaf_rn(-r0, r0, r2), r0);
  const float far = __fadd_rn(__fmaf_rn(a.sig, __fmul_rn(a.dn, s), __fmul_rn(sa.cornell_c_dn, y)),
                              a.four_mass);
  return r2 < 1.0f ? a.four_mass : far;
}

// k1_b: B = 1/(1 + dt/2*(V - vshift)) at the column whose analytic_column
// is col, on the plane whose k1_plane is px: Coulomb and SimpleCornell by
// radial_v, Periodic 1 - px*col (analytic_v_ieee's bits); V = 0 for any
// other kind, which K1 does not launch on its costly kernels.
__device__ __forceinline__ float k1_b(const SweepArgs& sa, float col, float px) {
  const Analytic& a = sa.an;
  float v = 0.0f;
  if (a.kind == kPeriodic) {
    v = 1.0f - px * col;
  } else if (a.kind == kCoulomb || a.kind == kSimpleCornell) {
    v = radial_v(sa, px * px + col);
  }
  return 1.0f / (1.0f + a.half_dt * (v - a.vshift));
}

// Whether a launch given the flag `done` must do nothing: the chunks a
// batch runs after its convergence verdict (the reference's
// lax.cond(done, idle, work)). Every block reads it first and returns
// before it reads or writes anything else.
__device__ __forceinline__ bool skipped(const int* done) {
  return done != nullptr && *done != 0;
}

// The x-plane windows of a block of nx interior planes whose plane 0 is
// global plane ox of a grid of gnx planes, reducing over [red_x0, red_x1).
inline void set_x_windows(SweepArgs& a, int ox, int gnx, int red_x0, int red_x1) {
  a.grid_x0 = ox < 0 ? -ox : 0;
  a.grid_x1 = gnx - ox < a.nx ? gnx - ox : a.nx;
  a.red_x0 = red_x0 > a.grid_x0 ? red_x0 : a.grid_x0;
  a.red_x1 = red_x1 < a.grid_x1 ? red_x1 : a.grid_x1;
}

// Whether a launch needs march's plane checks (WIN): some plane lies
// outside the grid or outside the reduction window.
inline bool windowed(const SweepArgs& a) {
  return a.grid_x0 != 0 || a.grid_x1 != a.nx || a.red_x0 != 0 || a.red_x1 != a.nx;
}

// One point's loaded values: psi and, when NL states are kept, each l_s.
template <int NC, int NL>
struct Raw {
  float psi[NC];
  float l[NL][NC];
};

template <int NC, int NL>
__device__ __forceinline__ void clear(Raw<NC, NL>& r) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    r.psi[c] = 0.0f;
#pragma unroll
    for (int s = 0; s < NL; ++s) r.l[s][c] = 0.0f;
  }
}

// v -= (ar + i*ai)*l (one component: v -= ar*l), every rounding spelled
// out: the plain version's order, and the same bits at every copy of this
// code, so that a point is corrected alike wherever it falls in a tile.
template <int NC>
__device__ __forceinline__ void subtract(float (&v)[NC], const float (&l)[NC], float ar,
                                         float ai) {
  if constexpr (NC == 1) {
    v[0] = __fsub_rn(v[0], __fmul_rn(ar, l[0]));
  } else {
    v[0] = __fsub_rn(v[0], __fsub_rn(__fmul_rn(ar, l[0]), __fmul_rn(ai, l[1])));
    v[1] = __fsub_rn(v[1], __fadd_rn(__fmul_rn(ar, l[1]), __fmul_rn(ai, l[0])));
  }
}

// A bf16 stored state read through the copy ring (K1's bf16 sweeps): the
// aligned 4-byte word that holds the bf16 value at `p`,
__device__ __forceinline__ const float* word_of(const __nv_bfloat16* p) {
  return reinterpret_cast<const float*>((uintptr_t)p & ~(uintptr_t)3);
}

// the byte-permute selector that keeps the bf16 value at `p` of its word
// as the high half of an f32 (low half zero): bytes (1, 0) when p starts
// the word, (3, 2) when it ends it,
__device__ __forceinline__ unsigned half_of(const __nv_bfloat16* p) {
  return 0x1044u + 0x1100u * ((unsigned)(uintptr_t)p & 2u);
}

// and the value kept.
__device__ __forceinline__ float upcast(float word, unsigned sel) {
  return __uint_as_float(__byte_perm(__float_as_uint(word), 0u, sel));
}

// A 4-byte asynchronous copy into shared memory (cp.async). The padded
// rows start at no 16-byte boundary, so the 16-byte form does not fit.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned to = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to), "l"(src) : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Slots of the copy ring that fit `budget` bytes: 2 to 8.
__host__ __device__ constexpr int ring_slots(int budget, int slot_bytes) {
  return budget / slot_bytes < 2 ? 2 : (budget / slot_bytes > 8 ? 8 : budget / slot_bytes);
}

template <int NC>
__device__ __forceinline__ void zero_box(float* out, ptrdiff_t vol, ptrdiff_t sx, ptrdiff_t sy,
                                         int x0, int x1, int y0, int y1, int z0, int z1,
                                         int tid, int nt) {
  const int lz = z1 - z0, ly = y1 - y0, n = (x1 - x0) * ly * lz;
  for (int t = tid; t < n; t += nt) {
    const int r = t / lz;
    const ptrdiff_t p = (ptrdiff_t)(x0 + r / ly) * sx + (ptrdiff_t)(y0 + r % ly) * sy + z0 + t % lz;
#pragma unroll
    for (int c = 0; c < NC; ++c) out[c * vol + p] = 0.0f;
  }
}

// Compile-time sizes of one march, shared by the kernel and its launcher.
// A block of TY x 32 threads owns a (TY*R) x 32 tile: thread row ty holds
// tile rows ty, ty+TY, ... (so each warp reads whole rows, coalesced).
template <int EXT, int NC, int NS, int TY, int R>
struct March {
  static constexpr int NT = kTileZ * TY;      // threads of a block
  static constexpr int ROWS = TY * R;         // rows of its tile
  static constexpr int NR = NS;               // stored states held in registers
  static constexpr int OF = NC * (2 + NR);    // a column's ring fields: psi, l_s, streamed B
  static constexpr int HF = NC * (1 + NR);    // a halo point's: psi, l_s
  static constexpr int HR = (2 * EXT * (kTileZ + ROWS) + NT - 1) / NT;  // halo points a thread
  static constexpr int SLOT = NT * (OF * R + HF * HR);                  // floats of a ring slot
  __host__ __device__ static constexpr int slots(int budget) {
    return ring_slots(budget, 4 * SLOT);
  }
  __host__ __device__ static constexpr int ring_bytes(int budget) {
    return 4 * SLOT * slots(budget);
  }
};

// The launch shape of every sweep, each route of K1 and K3 alike: a block
// owns a tile of kTileRows x kTileZ (y, z) columns and walks a segment of
// at most kSegment x-planes, and writes one partial row. So every route
// writes the same rows a grid (wafer_sweep_num_blocks), which num_partials,
// K2 and a mesh's row ranges rely on. A route's thread shape (its kTileY
// thread rows of kRows tile rows each) is its own, asserted to cover
// kTileRows rows.
constexpr int kTileRows = 16;
constexpr int kSegment = 16;

// The x-planes a block walks: kSegment, or fewer (down to 4) where the grid
// has too few tiles for kFillBlocks blocks, about 8 on each of the H100's
// 132 SMs: a shard block of a mesh is a small grid, and its few long blocks
// would leave the card idle while each walks its planes.
constexpr int kFillBlocks = 1024;
inline int march_segment(int nx, int ny, int nz) {
  const int fill = cdiv(nx, cdiv(kFillBlocks, cdiv(nz, kTileZ) * cdiv(ny, kTileRows)));
  return fill > kSegment ? kSegment : (fill < 4 ? 4 : fill);
}

// One block per tile of the interior's (y, z) plane and segment of `seg`
// interior x-planes.
inline dim3 march_grid(int nx, int ny, int nz, int seg) {
  return dim3(cdiv(nz, kTileZ), cdiv(ny, kTileRows), cdiv(nx, seg));
}

// A Harmonic B = 1/(1 + dt/2*(V - vshift)) at the block's padded plane i
// of the R columns whose analytic_column is colv, with V's x part taken
// once: the expressions of analytic_v_ieee and of a column's B, V rounded
// apart (__fmul_rn) as it is where analytic_v_ieee returns it, so every B
// keeps its bits.
template <int R>
__device__ __forceinline__ void harmonic_b(const Analytic& an, const float (&colv)[R], int i,
                                           float (&b)[R][1]) {
  const float dx = (float)(i + an.ox) - an.cx;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float r2 = dx * dx + colv[r];
    const float v = __fmul_rn(an.half_dn2, r2);
    b[r][0] = 1.0f / (1.0f + an.half_dt * (v - an.vshift));
  }
}

// The sweep
//     c     = inv*psi - sum_s corr_s*l_s            (pair: complex corr_s)
//     psi'  = B*(2c + scale*L(c)) - c               (interior; pair: complex B)
//     psi'  = 0                                     (the Dirichlet shell)
// with the block's partial sums of |psi'|^2 and <l_s|psi'> (pair: Re and
// Im, conjugated) in its row of `partials`, over the planes of the
// reduction window; planes outside the grid are written zero.
//
// The block owns a tile of (y, z) columns (March) and walks a.seg x-planes.
// Each thread keeps its R columns' corrected values at planes
// i-EXT..i+EXT in register queues (the x-taps) and publishes the centres
// into a shared plane with an EXT-deep y/z halo (the y- and z-taps), whose
// points the threads share out, HR each at most; two planes alternate, so
// one barrier a plane suffices. The correction is applied once per point,
// as it enters a queue or the halo. Raw values come through a per-thread
// ring of cp.async copies in dynamic shared memory, as many steps ahead as
// RING bytes hold slots (2 to 8), and copies stay in flight across the
// barrier. A column or halo point outside the tile's valid part fills no
// slot, and nothing read from its slots may reach an output.
// The sweep is issue-bound. B's y/z part is computed once per column, and
// for one component (K1, LEAN) the instructions around the arithmetic are
// cut further: each copy has a pointer of its own that steps one plane a
// fetch, and so does each column's psi'; a Harmonic B is computed once a
// plane for the R columns (harmonic_b), and the ring's B field read only
// where B streams. A pair (K3) keeps the plain forms, each copy's address
// rebuilt from the plane offsets and B computed and read per column:
// under K3's 64-register cap the lean forms, alone or together, left its
// S = 1 or its 512^3 ground launch slower (PERF.md, tools/tune_sweep.py).
// Without COSTLY every source of B is tested at run time, a costly kind's
// B computed per column from analytic_v_ieee (K3; K1's other kinds); K1's
// COSTLY kernels serve Coulomb, SimpleCornell and Periodic alone, B from
// k1_b once a plane for the R columns, before the stencil.
// The plane loop is unrolled UNROLL times (its queues then shift by
// renaming). Each thread adds its f32 products in f64 down its columns, in
// order; the block sums once at the end. NS stored states (0..2) are kept
// in registers, centre l_s included (more take stencil_sweep_many.cu's and
// stencil_sweep_wide.cu's marches). WIN compiles in the plane
// checks of a deep block (planes outside the grid, a reduction window);
// without them a launch runs the same code as before they existed, which
// cost the reducing launches 2-4 % as a branch a plane and 2 % as a select
// (PERF.md).
template <int EXT, int NC, int NS, int TY, int R, int RING, bool WIN, int UNROLL,
          bool COSTLY = false>
__device__ __forceinline__ void march(const SweepArgs& a) {
  using M = March<EXT, NC, NS, TY, R>;
  constexpr int NT = M::NT, ROWS = M::ROWS, NR = M::NR, OF = M::OF, HF = M::HF, HR = M::HR;
  constexpr int NSLOT = M::slots(RING);
  constexpr int SW = kTileZ + 2 * EXT;  // row of the shared plane
  constexpr int SP = (ROWS + 2 * EXT) * SW;
  constexpr int NL = NR > 0 ? NR : 1;
  constexpr int NACC = 1 + NC * NR;     // f64 column sums in registers
  __shared__ float plane[2][NC][SP];
  __shared__ double warp_sums[NT / 32];
  extern __shared__ float ring[];       // NSLOT slots: [OF][R][NT] column, [HF][HR][NT] halo floats
  constexpr bool LEAN = NC == 1;        // stepped copy pointers, B a plane (K1)
  static_assert(LEAN || !COSTLY, "K3 takes every source of B");

  const int tz = threadIdx.x, ty = threadIdx.y, tid = ty * kTileZ + tz;
  const int k0 = blockIdx.x * kTileZ, j0 = blockIdx.y * ROWS, i_lo = blockIdx.z * a.seg;
  const int zv = min(kTileZ, a.nz - k0), yv = min(ROWS, a.ny - j0);  // the tile's columns, rows
  const int i_hi = min(i_lo + a.seg, a.nx);
  const int nxp = a.nx + 2 * EXT, nyp = a.ny + 2 * EXT, nzp = a.nz + 2 * EXT;
  const ptrdiff_t sy = nzp;
  const ptrdiff_t sx = (ptrdiff_t)nyp * nzp;
  const ptrdiff_t vol = sx * nxp;  // one component

  // The shell this block owns: the faces its tile and segment touch.
  {
    const bool last_y = j0 + yv == a.ny, last_z = k0 + zv == a.nz;
    const int z0 = k0 == 0 ? 0 : k0 + EXT, z1 = last_z ? nzp : k0 + zv + EXT;
    const int y0 = j0 == 0 ? 0 : j0 + EXT, y1 = last_y ? nyp : j0 + yv + EXT;
    const int x0 = i_lo + EXT, x1 = i_hi + EXT;
    if (i_lo == 0) zero_box<NC>(a.out, vol, sx, sy, 0, EXT, y0, y1, z0, z1, tid, NT);
    if (i_hi == a.nx) zero_box<NC>(a.out, vol, sx, sy, x1, nxp, y0, y1, z0, z1, tid, NT);
    if (j0 == 0) zero_box<NC>(a.out, vol, sx, sy, x0, x1, 0, EXT, z0, z1, tid, NT);
    if (last_y) zero_box<NC>(a.out, vol, sx, sy, x0, x1, a.ny + EXT, nyp, z0, z1, tid, NT);
    if (k0 == 0) zero_box<NC>(a.out, vol, sx, sy, x0, x1, j0 + EXT, j0 + yv + EXT, 0, EXT, tid, NT);
    if (last_z) {
      zero_box<NC>(a.out, vol, sx, sy, x0, x1, j0 + EXT, j0 + yv + EXT, a.nz + EXT, nzp, tid, NT);
    }
  }

  const bool reduce = a.partials != nullptr;
  const bool apply = a.apply != 0;
  const bool own_l = apply || reduce;  // the columns' l_s: correction and centre
  const bool streamed = !COSTLY && a.an.kind == kStreamed;

  // this thread's columns: tile rows ty + r*TY
  bool col[R];
  float colv[R];
  ptrdiff_t own[R];  // within a plane
  const int own_s = (ty + EXT) * SW + tz + EXT;  // row r at + r*TY*SW
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = j0 + ty + r * TY;
    col[r] = tz < zv && j - j0 < yv;
    own[r] = (ptrdiff_t)(j + EXT) * sy + (k0 + tz + EXT);
    colv[r] = streamed ? 0.0f : analytic_column(a.an, j + EXT, k0 + tz + EXT);
  }
  const ptrdiff_t b_plane = (ptrdiff_t)a.ny * a.nz;
  const ptrdiff_t b_vol = b_plane * a.nx;
  const ptrdiff_t b_col = (ptrdiff_t)(j0 + ty) * a.nz + (k0 + tz);
  const ptrdiff_t b_row = (ptrdiff_t)TY * a.nz;  // between a thread's rows
  // the halo points it publishes: point tid + h*NT of the 2*EXT rows above
  // and below the tile's valid rows, then of the 2*EXT columns beside them
  bool halo[HR];
  ptrdiff_t hpos[HR];  // within a plane
  int h_s[HR];
  const int n_hy = 2 * EXT * zv;
#pragma unroll
  for (int h = 0; h < HR; ++h) {
    const int t = tid + h * NT;
    halo[h] = t < n_hy + 2 * EXT * yv;
    int hy = 0, hz = 0;
    if (t < n_hy) {
      const int rr = t / zv;
      hy = rr < EXT ? rr - EXT : yv + rr - EXT;
      hz = t - rr * zv;
    } else if (halo[h]) {
      const int u = t - n_hy, rr = u / (2 * EXT), c = u - rr * (2 * EXT);
      hy = rr;
      hz = c < EXT ? c - EXT : zv + c - EXT;
    }
    hpos[h] = (ptrdiff_t)(j0 + hy + EXT) * sy + (k0 + hz + EXT);
    h_s[h] = (hy + EXT) * SW + hz + EXT;
  }

  // LEAN: the copy pointers of the next fetch (step i_lo first): column r
  // at padded plane i+2*EXT, its l_s there, its streamed B at interior
  // plane i, halo point h and its l_s at padded plane i+EXT; each steps one
  // plane a fetch. And where the loop writes column r's psi' (padded plane
  // i+EXT), one plane further a step.
  const float* f_psi[R];
  const float* f_l[R][NC * NL];
  const float* f_b[R];
  const float* f_hpsi[HR];
  const float* f_hl[HR][NC * NL];
  float* o_out[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const ptrdiff_t q = (ptrdiff_t)(i_lo + 2 * EXT) * sx + own[r];
    f_psi[r] = a.psi + q;
    f_b[r] = a.b + (ptrdiff_t)i_lo * b_plane + b_col + r * b_row;
    o_out[r] = a.out + (ptrdiff_t)(i_lo + EXT) * sx + own[r];
#pragma unroll
    for (int f = 0; f < NC * NL; ++f) f_l[r][f] = a.store + (f * vol + q);
  }
#pragma unroll
  for (int h = 0; h < HR; ++h) {
    const ptrdiff_t q = (ptrdiff_t)(i_lo + EXT) * sx + hpos[h];
    f_hpsi[h] = a.psi + q;
#pragma unroll
    for (int f = 0; f < NC * NL; ++f) f_hl[h][f] = a.store + (f * vol + q);
  }

  const int n_red = 1 + NC * a.n_store;
  double* row = nullptr;
  if (reduce) {
    const ptrdiff_t blk = ((ptrdiff_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    row = a.partials + blk * n_red;
  }
  float co[1 + NC * NL];  // coef, read once
  co[0] = apply ? __ldg(a.coef) : 1.0f;
#pragma unroll
  for (int q = 1; q < 1 + NC * NL; ++q) co[q] = apply && q <= NC * NR ? __ldg(a.coef + q) : 0.0f;

  auto load = [&](Raw<NC, NL>& r, ptrdiff_t q, bool with_l) {
#pragma unroll
    for (int c = 0; c < NC; ++c) r.psi[c] = __ldg(a.psi + c * vol + q);
    if constexpr (NR > 0) {
      if (with_l) {
#pragma unroll
        for (int s = 0; s < NR; ++s) {
#pragma unroll
          for (int c = 0; c < NC; ++c) r.l[s][c] = __ldg(a.store + (NC * s + c) * vol + q);
        }
      }
    }
  };
  // the corrected value from its loaded values
  auto correct = [&](float (&v)[NC], const Raw<NC, NL>& r) {
#pragma unroll
    for (int c = 0; c < NC; ++c) v[c] = apply ? __fmul_rn(co[0], r.psi[c]) : r.psi[c];
    if (!apply) return;
#pragma unroll
    for (int s = 0; s < NR; ++s) {
      subtract<NC>(v, r.l[s], co[1 + NC * s], NC == 2 ? co[2 + NC * s] : 0.0f);
    }
  };
  // ring field f of column r, or of halo point h, in a slot
  auto o_at = [&](float* slot, int f, int r) { return slot + (f * R + r) * NT + tid; };
  auto h_at = [&](float* slot, int f, int h) {
    return slot + OF * R * NT + (f * HR + h) * NT + tid;
  };
  // one copy group a step, into slot sl: what step i consumes, its columns
  // at plane i+EXT, its halo points and streamed B at plane i (interior
  // indices; pl is the padded plane i+EXT's offset, bp plane i's of B,
  // where the addresses are rebuilt)
  auto fetch = [&](int i, int sl, ptrdiff_t pl, ptrdiff_t bp) {
    if (i < i_hi) {
      float* slot = ring + sl * M::SLOT;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!col[r]) continue;
        const ptrdiff_t q = pl + EXT * sx + own[r];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          copy_async(o_at(slot, c, r), LEAN ? f_psi[r] : a.psi + c * vol + q);
        }
        if constexpr (NR > 0) {
          if (own_l) {
#pragma unroll
            for (int f = 0; f < NC * NR; ++f) {
              copy_async(o_at(slot, NC + f, r), LEAN ? f_l[r][f] : a.store + f * vol + q);
            }
          }
        }
        if (streamed) {
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            copy_async(o_at(slot, NC * (1 + NR) + c, r),
                       LEAN ? f_b[r] : a.b + c * b_vol + bp + b_col + r * b_row);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < HR; ++h) {
        if (!halo[h]) continue;
        const ptrdiff_t q = pl + hpos[h];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          copy_async(h_at(slot, c, h), LEAN ? f_hpsi[h] : a.psi + c * vol + q);
        }
        if constexpr (NR > 0) {
          if (apply) {
#pragma unroll
            for (int f = 0; f < NC * NR; ++f) {
              copy_async(h_at(slot, NC + f, h), LEAN ? f_hl[h][f] : a.store + f * vol + q);
            }
          }
        }
      }
    }
    copy_commit();
    if constexpr (!LEAN) return;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      f_psi[r] += sx;
      f_b[r] += b_plane;
#pragma unroll
      for (int f = 0; f < NC * NR; ++f) f_l[r][f] += sx;
    }
#pragma unroll
    for (int h = 0; h < HR; ++h) {
      f_hpsi[h] += sx;
#pragma unroll
      for (int f = 0; f < NC * NR; ++f) f_hl[h][f] += sx;
    }
  };

  // q[r][m]: column r's corrected value at plane i-EXT+m; lq[r][m]: its
  // l_s at plane i+m
  float q[R][2 * EXT + 1][NC];
  float lq[R][EXT + 1][NL][NC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int m = 0; m < 2 * EXT; ++m) {
      Raw<NC, NL> raw;
      clear(raw);
      const ptrdiff_t p = (ptrdiff_t)(i_lo + m) * sx + own[r];  // padded plane of i_lo-EXT+m
      if (col[r]) load(raw, p, own_l);
      correct(q[r][m], raw);
      if constexpr (NR > 0) {
        if (m >= EXT) {
#pragma unroll
          for (int s = 0; s < NR; ++s) {
#pragma unroll
            for (int c = 0; c < NC; ++c) lq[r][m - EXT][s][c] = raw.l[s][c];
          }
        }
      }
    }
  }
#pragma unroll
  for (int d = 0; d + 1 < NSLOT; ++d) {
    fetch(i_lo + d, d, (ptrdiff_t)(i_lo + d + EXT) * sx, (i_lo + d) * b_plane);
  }

  double acc[NACC];
#pragma unroll
  for (int n = 0; n < NACC; ++n) acc[n] = 0.0;

  ptrdiff_t pl = (ptrdiff_t)(i_lo + EXT) * sx;  // padded plane i+EXT, one plane further a step
  ptrdiff_t bp = (ptrdiff_t)i_lo * b_plane;
  const ptrdiff_t ahead = (ptrdiff_t)(NSLOT - 1) * sx;  // to the plane the step's copies are for
  const ptrdiff_t b_ahead = (ptrdiff_t)(NSLOT - 1) * b_plane;
  int sl = 0, fsl = NSLOT - 1;  // the slot step i reads, and refills
#pragma unroll (UNROLL)
  for (int i = i_lo; i < i_hi; ++i) {
    // step i's copies have landed; the slot of step i-1 takes step
    // i+NSLOT-1's
    copy_wait<NSLOT - 2>();
    float* slot = ring + sl * M::SLOT;
    Raw<NC, NL> o[R], h[HR];
    float bv[R][NC];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        o[r].psi[c] = *o_at(slot, c, r);
        if constexpr (!LEAN) bv[r][c] = *o_at(slot, NC * (1 + NR) + c, r);
#pragma unroll
        for (int s = 0; s < NR; ++s) o[r].l[s][c] = *o_at(slot, NC * (1 + s) + c, r);
      }
    }
#pragma unroll
    for (int hh = 0; hh < HR; ++hh) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        h[hh].psi[c] = *h_at(slot, c, hh);
#pragma unroll
        for (int s = 0; s < NR; ++s) h[hh].l[s][c] = *h_at(slot, NC * (1 + s) + c, hh);
      }
    }
    fetch(i + NSLOT - 1, fsl, pl + ahead, bp + b_ahead);
    sl = sl + 1 == NSLOT ? 0 : sl + 1;
    fsl = fsl + 1 == NSLOT ? 0 : fsl + 1;

    float(&sp)[NC][SP] = plane[(i - i_lo) & 1];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      correct(q[r][2 * EXT], o[r]);
      if constexpr (NR > 0) {
#pragma unroll
        for (int s = 0; s < NR; ++s) {
#pragma unroll
          for (int c = 0; c < NC; ++c) lq[r][EXT][s][c] = o[r].l[s][c];
        }
      }
      if (col[r]) {
#pragma unroll
        for (int c = 0; c < NC; ++c) sp[c][own_s + r * TY * SW] = q[r][EXT][c];
      }
    }
#pragma unroll
    for (int hh = 0; hh < HR; ++hh) {
      float hv[NC];
      correct(hv, h[hh]);
      if (halo[hh]) {
#pragma unroll
        for (int c = 0; c < NC; ++c) sp[c][h_s[hh]] = hv[c];
      }
    }
    __syncthreads();

    // the plane's windows, the same for the whole block (x is the marching
    // axis)
    const bool in_grid = !WIN || (i >= a.grid_x0 && i < a.grid_x1);
    const bool red_plane = !WIN || (i >= a.red_x0 && i < a.red_x1);
    // LEAN: B of the plane where it streams, from the step's slot (which
    // the next fetch refills only a step later), where it is Harmonic, or
    // in a costly kernel
    if constexpr (COSTLY) {
      const float px = k1_plane(a.an, i + EXT);
#pragma unroll
      for (int r = 0; r < R; ++r) bv[r][0] = k1_b(a, colv[r], px);
    } else if constexpr (LEAN) {
      if (streamed) {
#pragma unroll
        for (int r = 0; r < R; ++r) bv[r][0] = *o_at(slot, 1 + NR, r);
      } else if (a.an.kind == kHarmonic) {
        harmonic_b<R>(a.an, colv, i + EXT, bv);
      }
    }
    float nxt[R][NC];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < NC; ++c) nxt[r][c] = 0.0f;
      if (!col[r]) continue;
      const int s0 = own_s + r * TY * SW;
      float t[NC], c0[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        c0[c] = q[r][EXT][c];
        t[c] = -center<EXT>() * c0[c];
      }
#pragma unroll
      for (int o2 = 1; o2 <= EXT; ++o2) {
        const float cf = tap<EXT>(o2);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          t[c] += cf * (q[r][EXT + o2][c] + q[r][EXT - o2][c]);
          t[c] += cf * (sp[c][s0 + o2 * SW] + sp[c][s0 - o2 * SW]);
          t[c] += cf * (sp[c][s0 + o2] + sp[c][s0 - o2]);
        }
      }
      if constexpr (NC == 1) {
        float b = bv[r][0];
        if (!COSTLY && !streamed && a.an.kind != kHarmonic) {
          const float v = analytic_v_ieee(a.an, colv[r], i + EXT);
          b = 1.0f / (1.0f + a.an.half_dt * (v - a.an.vshift));
        }
        nxt[r][0] = b * (2.0f * c0[0] + a.scale * t[0]) - c0[0];
      } else {
        float br = bv[r][0], bi = bv[r][1];
        if (!streamed) {
          const float v = analytic_v_ieee(a.an, colv[r], i + EXT);
          const float dr = 1.0f + a.an.half_dt * (v - a.an.vshift);
          const float di = a.an.half_dt * (a.an.absorb * v);
          const float mag = dr * dr + di * di;
          br = dr / mag;
          bi = -di / mag;
        }
        const float ur = 2.0f * c0[0] + a.scale * t[0];
        const float ui = 2.0f * c0[1] + a.scale * t[1];
        nxt[r][0] = br * ur - bi * ui - c0[0];
        nxt[r][1] = br * ui + bi * ur - c0[1];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if constexpr (WIN) {
          if (!in_grid) nxt[r][c] = 0.0f;
        }
        if constexpr (LEAN) {
          *o_out[r] = nxt[r][c];
        } else {
          a.out[c * vol + pl + own[r]] = nxt[r][c];
        }
      }
    }

    if (reduce) {
      // a plane outside the reduction window adds zeros: a select, not a
      // branch, so the loop body stays as it is without a window (adding
      // +0.0 to a sum that started at +0.0 changes none of its bits)
      float w[R][NC];
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int c = 0; c < NC; ++c) w[r][c] = red_plane ? nxt[r][c] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!col[r]) continue;  // its ring slots were never filled
        if constexpr (NC == 1) {
          acc[0] += (double)(w[r][0] * w[r][0]);
        } else {
          acc[0] += (double)(w[r][0] * w[r][0] + w[r][1] * w[r][1]);
        }
        if constexpr (NR > 0) {
#pragma unroll
          for (int s = 0; s < NR; ++s) {
            if constexpr (NC == 1) {
              acc[1 + s] += (double)(lq[r][0][s][0] * w[r][0]);
            } else {
              const float lr = lq[r][0][s][0], li = lq[r][0][s][1];
              acc[1 + 2 * s] += (double)(lr * w[r][0] + li * w[r][1]);
              acc[2 + 2 * s] += (double)(lr * w[r][1] - li * w[r][0]);
            }
          }
        }
      }
    }

    pl += sx;
    bp += b_plane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      o_out[r] += sx;
#pragma unroll
      for (int m = 0; m < 2 * EXT; ++m) {
#pragma unroll
        for (int c = 0; c < NC; ++c) q[r][m][c] = q[r][m + 1][c];
      }
      if constexpr (NR > 0) {
#pragma unroll
        for (int m = 0; m < EXT; ++m) {
#pragma unroll
          for (int s = 0; s < NR; ++s) {
#pragma unroll
            for (int c = 0; c < NC; ++c) lq[r][m][s][c] = lq[r][m + 1][s][c];
          }
        }
      }
    }
  }

  if (reduce) {
#pragma unroll
    for (int n = 0; n < NACC; ++n) {
      const double v = block_sum<NT>(acc[n], warp_sums);
      if (tid == 0) row[n] = v;
    }
  }
}

// The launch front: which route a launch takes, its SweepArgs and the
// compile-time EXT and plane checks of its kernel, decided here once for
// wafer_sweep_step (K1) and wafer_sweep_step_sc (K3).

// The routes, by the code wafer_sweep_route gives (hopper_stencil.ROUTES
// names them in this order, as LAUNCHES counts them).
enum Route {
  kRouteNone = -1,    // no launch: a negative count, or a pair on a bf16 store
  kRouteF32 = 0,      // K1, S <= 2 (stencil_sweep.cu)
  kRouteBf16 = 1,     // K1 on a bf16 store, S = 1, 2 (stencil_sweep_bf16.cu)
  kRouteMany = 2,     // K1, kManyMinS <= S <= kManyS (stencil_sweep_many.cu)
  kRouteBf16Many = 3,
  kRouteWide = 4,     // K1, S > kManyS (stencil_sweep_wide.cu)
  kRouteBf16Wide = 5,
  kRouteSc = 6,       // K3, S < kPairMinS (split_sweep.cu)
  kRouteScWide = 7,   // K3, S >= kPairMinS (stencil_sweep_wide.cu)
};

constexpr int kManyMinS = 3;  // K1's many-state kernels: one for each count kManyMinS..kManyS
constexpr int kManyS = 4;
constexpr int kPairMinS = 3;  // the fewest stored pairs K3's wide route takes

// The one route rule: by the stored-state count, the store's type and
// whether the launch is a pair's (K3). A bf16 store of no states is no
// store: nothing is read from it.
inline int sweep_route(bool pair, int n_store, bool store_bf16) {
  if (n_store < 0 || (pair && store_bf16)) return kRouteNone;
  if (pair) return n_store >= kPairMinS ? kRouteScWide : kRouteSc;
  const int bf16 = store_bf16 && n_store > 0 ? 1 : 0;
  if (n_store > kManyS) return kRouteWide + bf16;
  if (n_store >= kManyMinS) return kRouteMany + bf16;
  return kRouteF32 + bf16;
}

// A launch's SweepArgs from the C arguments of wafer_sweep_step and
// wafer_sweep_step_sc, on `route`: the store read as bf16 on a bf16 route
// and as f32 else, and K1's SimpleCornell factor (a pair leaves it 0; K3's
// callers pass mass and sig 0, K1's absorb 0).
inline SweepArgs make_sweep_args(int route, const float* psi, float* out, const float* b,
                                 const void* store, const float* coef, double* partials, int nx,
                                 int ny, int nz, int n_store, int apply, double scale, int kind,
                                 int gnx, int gny, int gnz, int ox, int oy, int oz, double dn,
                                 double dt, double mass, double sig, double vshift,
                                 double absorb, int red_x0, int red_x1, const int* done) {
  const bool bf16 = route == kRouteBf16 || route == kRouteBf16Many || route == kRouteBf16Wide;
  SweepArgs a;
  a.psi = psi;
  a.out = out;
  a.b = b;
  a.store = bf16 ? nullptr : static_cast<const float*>(store);
  a.store_bf16 = bf16 ? static_cast<const __nv_bfloat16*>(store) : nullptr;
  a.coef = coef;
  a.partials = partials;
  a.done = done;
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  a.n_store = n_store;
  a.apply = apply;
  a.seg = march_segment(nx, ny, nz);
  set_x_windows(a, ox, gnx, red_x0, red_x1);
  a.scale = (float)scale;
  a.an = make_analytic(gnx, gny, gnz, ox, oy, oz, kind, dn, dt, mass, sig, vshift, absorb);
  if (route < kRouteSc) a.cornell_c_dn = cornell_c_over_dn(dn);
  return a;
}

// The grid every route launches (the launch shape above).
inline dim3 sweep_grid(const SweepArgs& a) { return march_grid(a.nx, a.ny, a.nz, a.seg); }

// f(std::integral_constant<int, EXT>()) for a launch's ext, the order's
// halo width (1 to 3); an invalid value, and no launch, for any other.
template <typename F>
int with_ext(int ext, F&& f) {
  if (ext == 1) return f(std::integral_constant<int, 1>());
  if (ext == 2) return f(std::integral_constant<int, 2>());
  if (ext == 3) return f(std::integral_constant<int, 3>());
  return (int)cudaErrorInvalidValue;
}

// f(std::bool_constant<WIN>()): WIN compiles in the plane checks, for a
// launch that needs them (windowed).
template <typename F>
int with_window(const SweepArgs& a, F&& f) {
  return windowed(a) ? f(std::true_type()) : f(std::false_type());
}

}  // namespace

// Each route's launcher, in its route's source: the launch of `a` at halo
// width `ext` on stream `s`; cudaGetLastError() after it, or the error that
// stopped it. C linkage, hidden from the library's exports: SweepArgs is
// each source's own (in its anonymous namespace, which the kernels' names
// carry), the same struct in each, so a C++ name taking it would not link.
extern "C" {
__attribute__((visibility("hidden"))) int launch_k1_f32(const SweepArgs&, int, cudaStream_t);
__attribute__((visibility("hidden"))) int launch_k1_bf16(const SweepArgs&, int, cudaStream_t);
__attribute__((visibility("hidden"))) int launch_k1_many(const SweepArgs&, int, cudaStream_t);
__attribute__((visibility("hidden"))) int launch_k1_bf16_many(const SweepArgs&, int, cudaStream_t);
__attribute__((visibility("hidden"))) int launch_k1_wide(const SweepArgs&, int, cudaStream_t);
__attribute__((visibility("hidden"))) int launch_k1_bf16_wide(const SweepArgs&, int, cudaStream_t);
__attribute__((visibility("hidden"))) int launch_k3(const SweepArgs&, int, cudaStream_t);
__attribute__((visibility("hidden"))) int launch_k3_wide(const SweepArgs&, int, cudaStream_t);
}  // extern "C"

namespace {

// The launch of `a` on `route` (sweep_route's code).
inline int launch_route(int route, const SweepArgs& a, int ext, cudaStream_t s) {
  static int (*const launchers[])(const SweepArgs&, int, cudaStream_t) = {
      launch_k1_f32,  launch_k1_bf16,      launch_k1_many, launch_k1_bf16_many,
      launch_k1_wide, launch_k1_bf16_wide, launch_k3,      launch_k3_wide};
  if (route < 0 || route > kRouteScWide) return (int)cudaErrorInvalidValue;
  return launchers[route](a, ext, s);
}

}  // namespace
