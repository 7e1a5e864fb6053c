// K1 with its stored states streamed in bf16: the Hopper (sm_90a) kernel
// sweep_step_bf16<EXT, NS, WIN>, reached through wafer_sweep_step
// (stencil_sweep.cu) when the store is bf16, and bound by ctypes in
// wafer_torch/ops/hopper_stencil.py (counted as LAUNCHES["sweep_step_bf16"]).
//
// It replaces the excited modes of wafer_tpu/ops/pallas_stencil.py with a
// bf16 store_xpad, the reference's default excited-state streams:
// _evolve_kernel_res (B3, wafer_tpu/solver.py:577-581) and the large-grid
// dispatch of the same chunk (B4), once per step with K2 after it, and the
// sharded windowed/ICI excited chunks of wafer_tpu/parallel/sharded.py:
// 745-750, :1033-1035, :1073-1075 (B12) on a block with an origin. It
// computes what K1 computes (stencil_sweep.cu), on the fully padded layout,
//     c     = inv*psi - sum_s corr_s*l_s       (l_s upcast to f32 where read)
//     psi'  = B*(2c + scale*L(c)) - c          (interior)
//     psi'  = 0                                (the Dirichlet shell)
// with one row of partial sums of |psi'|^2 and <l_s|psi'> per block, and
// every value the f32 kernel's on the upcast values: the same tile, the
// same columns a thread, the same roundings and the same f64 order down
// each thread's columns, so psi' and the partial rows equal, bit for bit,
// the f32 launch on an f32 store that holds the same values.
//
// What bounds it. Its least work is 10 B a point at S = 1 (psi read and
// psi' written, 2 B of l_s), 12 at S = 2. But the f32 march (PR 5's design,
// sweep_common.cuh) is issue-bound at ~50-60 % of its byte bound, and PR
// 10's bf16 instantiation of it issued the f32 instructions plus an index
// add and a byte permute a stored value, so the saved bytes bought nothing
// (38-47 % of the bf16 bound, PERF.md). Its machine code
// (tools/sass_count.py) spends ~30 instructions a column and plane on
// each copy's 64-bit address, rebuilt from the plane, column and field
// offsets with the launch's constants reloaded; and past 80 registers a
// thread an SM holds two of its blocks of 256 threads, not three.
// This sweep keeps the march's schedule (16 x 32 (y, z) tiles of 8 x 32
// threads, two rows a thread, segments of up to 16 x-planes, register
// queues for the x-taps, a shared plane with an EXT-deep halo for the y/z
// taps, a cp.async ring kRingBytes deep), and so its launch shape and
// partial rows, and cuts the instructions around it:
// - each copy has a pointer of its own that steps one plane a fetch: one
//   64-bit add a copy and plane;
// - a bf16 point is 2 bytes and cp.async copies 4 at least, so each copy of
//   l_s takes the aligned 4-byte word (the z-pair) that holds its point
//   (the byte pointer with bit 1 cleared), and the reader keeps its half
//   with one byte permute; its selector is taken once per column and
//   stream when the sweep starts and flips each plane only when a plane
//   holds an odd number of elements (one XOR a plane, no index);
// - B's kind is tested once a plane for both of a thread's columns, and a
//   Harmonic B's x part taken once (analytic_b), with the f32 march's
//   expressions, and the ring's B field is read only where B streams;
// - launch bounds of three blocks an SM where the sweep fits 80 registers
//   without spilling (min_blocks): S = 1 and, at EXT 1, S = 2;
// - the S = 1 plane loop unrolled (three planes at EXT 1, two at EXT 2-3).
// The costly kinds of B (Coulomb, SimpleCornell, Periodic), as in the f32
// sweep: their V took an IEEE sqrt and two reciprocals a point, or a sine
// and a divide, eleven or twelve slow-path calls a plane loop, and their
// launches ran 21-35 % behind Harmonic's. They take k1_b (sweep_common.cuh,
// the f32 march's helper, so both give B the same bits: one rsqrt, one
// reciprocal, Periodic's sine once a plane) on a kernel of their own,
// sweep_step_bf16_costly_kernel, whose plane loop is not unrolled. The
// other sources of B keep sweep_step_bf16_kernel and its machine code
// (the costly kinds' untaken IEEE path included: without it, S = 2 ran
// 26 % slower).
// nvcc's report (chip_smoke phase 1): 75-80 registers at S = 1 (20 bytes
// spilled at EXT 3), 80 at EXT 1 S = 2, 99 and 126 at EXT 2 and 3 S = 2.
//
// The costly route (march_tile). What bounds it: its 256^3 launches sat
// at 46-47 % of their byte bound (S = 1, 2; 53 % at 512^3) on the march
// above, each thread copying its own columns and halo points into a ring
// of its own: six 4-byte cp.async a plane at S = 1 (nine at S = 2), seven
// 64-bit pointers stepped (B's among them, which the costly kinds never
// stream), a selector flipped per l_s copy, and lanes tz and tz + 1
// copying the same l_s word. Its own copies needed no barrier, but each
// thread copied 4 bytes at a time because its own column starts at an odd
// element (padded k0 + EXT). The padded row of N = 256 points is 1,032
// bytes, so every row of a tile with its halo starts 8-byte aligned at
// padded k0 (a multiple of 32): the block copies plane i's haloed tile,
// (16 + 2*EXT) rows of 32 + 2*EXT points, as whole aligned row segments
// into one ring slot (Tile) -- psi in 8-byte pairs, each l_s in 4-byte
// words, each word once -- and each thread reads its R columns and its
// halo points from the slot with scalar shared loads, a bf16 value upcast
// by its place in the slot (a shift). Only who copies what moves: every
// thread keeps its columns, its corrected values, its taps, its B, its
// update and its f64 sums in their order, so psi' and the partial rows
// are the f32 launch's on the upcast values, bit for bit, as before. The
// copy width follows what a launch can observe (row_copy_bytes, counted
// by hopper_stencil.ROW_COPIES): 8-byte pairs where N + 2*EXT is even and
// psi 8-byte aligned (every main path at 128^3 to 512^3), 4-byte points
// where rows alternate their parity (odd N), with SW/2 + 1 words of each
// l_s row, whose half a word it starts on comes from its address. A slot
// holds padded plane k + 2*EXT: step k's columns and the halo of step
// k + EXT, so it lives EXT + 1 steps; the plane's one __syncthreads,
// before the taps, also publishes step i + 1's copies, each thread waiting
// for its own just before it. The slots are a third the size of the
// per-thread ring's (3.6 KB at EXT 1, S = 1), so the 8-byte form takes
// four blocks an SM at 64 registers (tile_min_blocks) on a 24 KB ring; on
// the card that, and not a deeper ring, paid (PERF.md), as did issuing a
// block's first copies before its x-queues' first loads.
// Why not TMA: a tensor map's strides must be multiples of 16 bytes, and
// the 1,032-byte padded row is not; a layout padded to one would reach
// every kernel, the measure and the I/O.
// Against a thread owning a z-pair of points (one word copy for two
// points): a warp issues its copies as one instruction whatever its lanes
// do, so halving the lanes that copy saves no issue slots, and a z-pair a
// thread changes which columns a thread sums, so the partial rows would
// leave the f32 launch's bits; the tile copy moves only the copies, and
// cuts the cp.async a warp issues a plane (six to four at S = 1, nine to
// five at S = 2) by copying whole rows. Times against the first bf16
// design and the f32 sweep: PERF.md.
// Where trouble lies, and what the design does about it:
// - Odd padded rows: with N odd, NZp = N + 2*EXT is odd and consecutive
//   rows and planes start on alternate halves of a word; each column's and
//   halo point's selector comes from its own element index, so any parity
//   pattern is read right (the ragged and odd-NZp grids of chip_smoke 2i).
// - Block origins and windows (the x-mesh chunk, set_x_windows): the
//   origin enters B alone and the window the plane checks (WIN), as in the
//   f32 march; `done` still returns before anything is read or written.
// - The partials' row count: the launch shape is the one every route
//   launches (sweep_common.cuh), so wafer_sweep_num_blocks holds for both
//   stream types and no caller's row ranges move.
// - Three and four stored states take stencil_sweep_many.cu's march, and
//   more than that stencil_sweep_wide.cu's (sweep_route sends them there);
//   this march takes one and two.
// - 64-bit pointers throughout: a stack of two stored states at 1024^3
//   passes 2^31 elements, so no offset is narrowed.
//
// Build: as stencil_sweep.cu (nvcc -gencode arch=compute_90a,code=sm_90a
//        -std=c++17 -O3, no --use_fast_math).

#include "sweep_common.cuh"

namespace {

// The f32 kernel's thread shape and ring (stencil_sweep.cu), on the one
// tile grid (tools/tune_sweep.py sets both files alike).
constexpr int kTileY = 8;          // thread rows of a block: 256 threads
constexpr int kRows = 2;           // tile rows a thread owns: 16 x 32 tiles
constexpr int kRingBytes = 49152;  // shared memory of the copy ring: its steps ahead
constexpr int kMinBlocks = 2;      // blocks an SM must hold at least: caps registers a thread
constexpr int kThreads = kTileZ * kTileY;
static_assert(kTileY * kRows == kTileRows, "K1's bf16 sweep launches the one tile grid");
// shared memory of the costly kinds' tile ring (march_tile): its steps ahead
constexpr int kTileRingBytes = 24576;

// The width of the costly kinds' psi row copies: 8 bytes where every row of
// a haloed tile starts 8-byte aligned (an even padded row, N + 2*EXT, and
// psi 8-byte aligned; the tiles start at even columns), else 4.
inline int row_copy_bytes(const void* psi, int nz, int ext) {
  return (nz + 2 * ext) % 2 == 0 && (reinterpret_cast<uintptr_t>(psi) & 7u) == 0 ? 8 : 4;
}

// Blocks an SM must hold for the sweep of (EXT, NS): three, 80 registers a
// thread, where the sweep fits them without spilling (S = 1; S = 2 at EXT
// 1), and kMinBlocks else. Left to itself nvcc gives these sweeps 72-107
// registers, and past 80 an SM holds two blocks of 256 threads, not three:
// the issue-bound sweep then has a third fewer warps to issue from.
template <int EXT, int NS>
constexpr int min_blocks() {
  return NS == 1 || (NS == 2 && EXT == 1) ? 3 : kMinBlocks;
}

// B at the block's padded plane i of the R columns whose analytic_column
// is colv: 1/(1 + dt/2*(V - vshift)), the f32 march's expressions, with
// the kind tested once for the R columns: Harmonic's x part taken once,
// every other kind's V from analytic_v_ieee. (The costly kinds' kernel
// takes k1_b, sweep_common.cuh, in march_tile.)
template <int R>
__device__ __forceinline__ void analytic_b(const SweepArgs& sa, const float (&colv)[R], int i,
                                           float (&b)[R]) {
  const Analytic& an = sa.an;
  if (an.kind == kHarmonic) {
    const float dx = (float)(i + an.ox) - an.cx;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float r2 = dx * dx + colv[r];
      const float v = an.half_dn2 * r2;
      b[r] = 1.0f / (1.0f + an.half_dt * (v - an.vshift));
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float v = analytic_v_ieee(an, colv[r], i);
      b[r] = 1.0f / (1.0f + an.half_dt * (v - an.vshift));
    }
  }
}

// Planes a pass of the plane loop: at S = 1, three at EXT 1 and two at
// EXT 2-3 (the queues then shift by renaming).
template <int EXT, int NS>
__host__ __device__ constexpr int unroll() {
  return NS == 1 ? (EXT == 1 ? 3 : 2) : 1;
}

// The sweep of march<EXT, 1, NS, TY, R, RING, WIN> (sweep_common.cuh) on a
// bf16 store for every source of B but the costly kinds: the same values,
// stored states upcast where read.
template <int EXT, int NS, int TY, int R, int RING, bool WIN>
__device__ __forceinline__ void march_bf16(const SweepArgs& a) {
  using M = March<EXT, 1, NS, TY, R>;
  constexpr int NT = M::NT, ROWS = M::ROWS, NR = M::NR, OF = M::OF, HF = M::HF, HR = M::HR;
  constexpr int NSLOT = M::slots(RING);
  constexpr int SW = kTileZ + 2 * EXT;  // row of the shared plane
  constexpr int SP = (ROWS + 2 * EXT) * SW;
  constexpr int NL = NR > 0 ? NR : 1;
  constexpr int NACC = 1 + NR;          // f64 column sums in registers
  static_assert(OF == 2 + NR && HF == 1 + NR, "one component");
  __shared__ float plane[2][SP];
  __shared__ double warp_sums[NT / 32];
  extern __shared__ float ring[];       // NSLOT slots: [OF][R][NT] column, [HF][HR][NT] halo

  const int tz = threadIdx.x, ty = threadIdx.y, tid = ty * kTileZ + tz;
  const int k0 = blockIdx.x * kTileZ, j0 = blockIdx.y * ROWS, i_lo = blockIdx.z * a.seg;
  const int zv = min(kTileZ, a.nz - k0), yv = min(ROWS, a.ny - j0);  // the tile's columns, rows
  const int i_hi = min(i_lo + a.seg, a.nx);
  const int nxp = a.nx + 2 * EXT, nyp = a.ny + 2 * EXT, nzp = a.nz + 2 * EXT;
  const ptrdiff_t sy = nzp;
  const ptrdiff_t sx = (ptrdiff_t)nyp * nzp;
  const ptrdiff_t vol = sx * nxp;
  const __nv_bfloat16* const lst = a.store_bf16;

  // The shell this block owns: the faces its tile and segment touch.
  {
    const bool last_y = j0 + yv == a.ny, last_z = k0 + zv == a.nz;
    const int z0 = k0 == 0 ? 0 : k0 + EXT, z1 = last_z ? nzp : k0 + zv + EXT;
    const int y0 = j0 == 0 ? 0 : j0 + EXT, y1 = last_y ? nyp : j0 + yv + EXT;
    const int x0 = i_lo + EXT, x1 = i_hi + EXT;
    if (i_lo == 0) zero_box<1>(a.out, vol, sx, sy, 0, EXT, y0, y1, z0, z1, tid, NT);
    if (i_hi == a.nx) zero_box<1>(a.out, vol, sx, sy, x1, nxp, y0, y1, z0, z1, tid, NT);
    if (j0 == 0) zero_box<1>(a.out, vol, sx, sy, x0, x1, 0, EXT, z0, z1, tid, NT);
    if (last_y) zero_box<1>(a.out, vol, sx, sy, x0, x1, a.ny + EXT, nyp, z0, z1, tid, NT);
    if (k0 == 0) zero_box<1>(a.out, vol, sx, sy, x0, x1, j0 + EXT, j0 + yv + EXT, 0, EXT, tid, NT);
    if (last_z) {
      zero_box<1>(a.out, vol, sx, sy, x0, x1, j0 + EXT, j0 + yv + EXT, a.nz + EXT, nzp, tid, NT);
    }
  }

  const bool reduce = a.partials != nullptr;
  const bool apply = a.apply != 0;
  const bool own_l = apply || reduce;  // the columns' l_s: correction and centre
  const bool streamed = a.an.kind == kStreamed;
  // the selectors flip from one plane to the next when a plane holds an
  // odd number of elements
  const unsigned flip = (unsigned)(sx & 1) * 0x2200u;

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

  // The copy pointers of the next fetch (step i_lo first): column r at
  // padded plane i+2*EXT, its streamed B at interior plane i, halo point h
  // at padded plane i+EXT; each steps one plane a fetch.
  const float* f_psi[R];
  const __nv_bfloat16* f_l[R][NL];
  const float* f_b[R];
  const float* f_hpsi[HR];
  const __nv_bfloat16* f_hl[HR][NL];
  // the selectors of the step the loop reads (step i_lo first), and where
  // it writes psi'
  unsigned sel[R][NL], h_sel[HR][NL];
  float* o_out[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const ptrdiff_t q = (ptrdiff_t)(i_lo + 2 * EXT) * sx + own[r];
    f_psi[r] = a.psi + q;
    f_b[r] = a.b + (ptrdiff_t)i_lo * b_plane + (ptrdiff_t)(j0 + ty + r * TY) * a.nz + (k0 + tz);
    o_out[r] = a.out + (ptrdiff_t)(i_lo + EXT) * sx + own[r];
#pragma unroll
    for (int s = 0; s < NL; ++s) {
      f_l[r][s] = lst + (s * vol + q);
      sel[r][s] = half_of(f_l[r][s]);
    }
  }
#pragma unroll
  for (int h = 0; h < HR; ++h) {
    const ptrdiff_t q = (ptrdiff_t)(i_lo + EXT) * sx + hpos[h];
    f_hpsi[h] = a.psi + q;
#pragma unroll
    for (int s = 0; s < NL; ++s) {
      f_hl[h][s] = lst + (s * vol + q);
      h_sel[h][s] = half_of(f_hl[h][s]);
    }
  }

  const int n_red = 1 + a.n_store;
  double* row = nullptr;
  if (reduce) {
    const ptrdiff_t blk = ((ptrdiff_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    row = a.partials + blk * n_red;
  }
  float co[1 + NL];  // coef, read once
  co[0] = apply ? __ldg(a.coef) : 1.0f;
#pragma unroll
  for (int q = 1; q < 1 + NL; ++q) co[q] = apply && q <= NR ? __ldg(a.coef + q) : 0.0f;

  auto load_l = [&](const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); };
  // the corrected value of a point from its psi and l_s
  auto correct = [&](float psi, const float (&l)[NL]) {
    float v = apply ? __fmul_rn(co[0], psi) : psi;
    if (!apply) return v;
#pragma unroll
    for (int s = 0; s < NR; ++s) {
      float vv[1] = {v};
      const float ls[1] = {l[s]};
      subtract<1>(vv, ls, co[1 + s], 0.0f);
      v = vv[0];
    }
    return v;
  };
  // ring field f of column r, or of halo point h, in a slot
  auto o_at = [&](float* slot, int f, int r) { return slot + (f * R + r) * NT + tid; };
  auto h_at = [&](float* slot, int f, int h) {
    return slot + OF * R * NT + (f * HR + h) * NT + tid;
  };
  // one copy group a step, into slot sl: what step i consumes
  auto fetch = [&](int i, int sl) {
    if (i < i_hi) {
      float* slot = ring + sl * M::SLOT;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!col[r]) continue;
        copy_async(o_at(slot, 0, r), f_psi[r]);
        if constexpr (NR > 0) {
          if (own_l) {
#pragma unroll
            for (int s = 0; s < NR; ++s) copy_async(o_at(slot, 1 + s, r), word_of(f_l[r][s]));
          }
        }
        if (streamed) copy_async(o_at(slot, 1 + NR, r), f_b[r]);
      }
#pragma unroll
      for (int h = 0; h < HR; ++h) {
        if (!halo[h]) continue;
        copy_async(h_at(slot, 0, h), f_hpsi[h]);
        if constexpr (NR > 0) {
          if (apply) {
#pragma unroll
            for (int s = 0; s < NR; ++s) copy_async(h_at(slot, 1 + s, h), word_of(f_hl[h][s]));
          }
        }
      }
    }
    copy_commit();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      f_psi[r] += sx;
      f_b[r] += b_plane;
#pragma unroll
      for (int s = 0; s < NR; ++s) f_l[r][s] += sx;
    }
#pragma unroll
    for (int h = 0; h < HR; ++h) {
      f_hpsi[h] += sx;
#pragma unroll
      for (int s = 0; s < NR; ++s) f_hl[h][s] += sx;
    }
  };

  // q[r][m]: column r's corrected value at plane i-EXT+m; lq[r][m]: its
  // l_s at plane i+m
  float q[R][2 * EXT + 1];
  float lq[R][EXT + 1][NL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int m = 0; m < 2 * EXT; ++m) {
      const ptrdiff_t p = (ptrdiff_t)(i_lo + m) * sx + own[r];  // padded plane of i_lo-EXT+m
      float psi = 0.0f, l[NL];
#pragma unroll
      for (int s = 0; s < NL; ++s) l[s] = 0.0f;
      if (col[r]) {
        psi = __ldg(a.psi + p);
        if constexpr (NR > 0) {
          if (own_l) {
#pragma unroll
            for (int s = 0; s < NR; ++s) l[s] = load_l(lst + (s * vol + p));
          }
        }
      }
      q[r][m] = correct(psi, l);
      if constexpr (NR > 0) {
        if (m >= EXT) {
#pragma unroll
          for (int s = 0; s < NR; ++s) lq[r][m - EXT][s] = l[s];
        }
      }
    }
  }
#pragma unroll
  for (int d = 0; d + 1 < NSLOT; ++d) fetch(i_lo + d, d);

  double acc[NACC];
#pragma unroll
  for (int n = 0; n < NACC; ++n) acc[n] = 0.0;

  int sl = 0, fsl = NSLOT - 1;  // the slot step i reads, and refills
  // the S = 1 sweep unrolled (unroll)
#pragma unroll (unroll<EXT, NS>())
  for (int i = i_lo; i < i_hi; ++i) {
    // step i's copies have landed; the slot of step i-1 takes step
    // i+NSLOT-1's
    copy_wait<NSLOT - 2>();
    float* slot = ring + sl * M::SLOT;
    float o_psi[R], o_l[R][NL], bv[R], h_psi[HR], h_l[HR][NL];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      o_psi[r] = *o_at(slot, 0, r);
      bv[r] = 0.0f;
      if (streamed) bv[r] = *o_at(slot, 1 + NR, r);
#pragma unroll
      for (int s = 0; s < NL; ++s) {
        o_l[r][s] = s < NR ? upcast(*o_at(slot, 1 + s, r), sel[r][s]) : 0.0f;
        sel[r][s] ^= flip;
      }
    }
#pragma unroll
    for (int hh = 0; hh < HR; ++hh) {
      h_psi[hh] = *h_at(slot, 0, hh);
#pragma unroll
      for (int s = 0; s < NL; ++s) {
        h_l[hh][s] = s < NR ? upcast(*h_at(slot, 1 + s, hh), h_sel[hh][s]) : 0.0f;
        h_sel[hh][s] ^= flip;
      }
    }
    fetch(i + NSLOT - 1, fsl);
    sl = sl + 1 == NSLOT ? 0 : sl + 1;
    fsl = fsl + 1 == NSLOT ? 0 : fsl + 1;

    float* sp = plane[(i - i_lo) & 1];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      q[r][2 * EXT] = correct(o_psi[r], o_l[r]);
      if constexpr (NR > 0) {
#pragma unroll
        for (int s = 0; s < NR; ++s) lq[r][EXT][s] = o_l[r][s];
      }
      if (col[r]) sp[own_s + r * TY * SW] = q[r][EXT];
    }
#pragma unroll
    for (int hh = 0; hh < HR; ++hh) {
      const float hv = correct(h_psi[hh], h_l[hh]);
      if (halo[hh]) sp[h_s[hh]] = hv;
    }
    __syncthreads();

    // the plane's windows, the same for the whole block (x is the marching
    // axis)
    const bool in_grid = !WIN || (i >= a.grid_x0 && i < a.grid_x1);
    const bool red_plane = !WIN || (i >= a.red_x0 && i < a.red_x1);
    float bb[R];
    if (streamed) {
#pragma unroll
      for (int r = 0; r < R; ++r) bb[r] = bv[r];
    } else {
      analytic_b<R>(a, colv, i + EXT, bb);
    }
    float nxt[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      nxt[r] = 0.0f;
      if (!col[r]) continue;
      const int s0 = own_s + r * TY * SW;
      const float c0 = q[r][EXT];
      float t = -center<EXT>() * c0;
#pragma unroll
      for (int o2 = 1; o2 <= EXT; ++o2) {
        const float cf = tap<EXT>(o2);
        t += cf * (q[r][EXT + o2] + q[r][EXT - o2]);
        t += cf * (sp[s0 + o2 * SW] + sp[s0 - o2 * SW]);
        t += cf * (sp[s0 + o2] + sp[s0 - o2]);
      }
      nxt[r] = bb[r] * (2.0f * c0 + a.scale * t) - c0;
      if constexpr (WIN) {
        if (!in_grid) nxt[r] = 0.0f;
      }
      *o_out[r] = nxt[r];
    }

    if (reduce) {
      // a plane outside the reduction window adds zeros (a select)
      float w[R];
#pragma unroll
      for (int r = 0; r < R; ++r) w[r] = red_plane ? nxt[r] : 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!col[r]) continue;  // its ring slots were never filled
        acc[0] += (double)(w[r] * w[r]);
        if constexpr (NR > 0) {
#pragma unroll
          for (int s = 0; s < NR; ++s) acc[1 + s] += (double)(lq[r][0][s] * w[r]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < R; ++r) {
      o_out[r] += sx;
#pragma unroll
      for (int m = 0; m < 2 * EXT; ++m) q[r][m] = q[r][m + 1];
      if constexpr (NR > 0) {
#pragma unroll
        for (int m = 0; m < EXT; ++m) {
#pragma unroll
          for (int s = 0; s < NR; ++s) lq[r][m][s] = lq[r][m + 1][s];
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

// The tile copy of the costly kinds' sweep (march_tile): a ring slot holds
// one x-plane's tile with its y and z halo, TR rows of SW points in the
// padded layout's row order, psi as f32 and then each l_s as bf16. With
// PAIR (every haloed row starts 8-byte aligned) a row is SW/2 8-byte psi
// copies and SW/2 4-byte l_s words; else SW 4-byte psi copies and, since a
// row may start on either half of a word, SW/2 + 1 words of each l_s.
// Copy c of a thread takes item tid + c*NT of the plane's psi items, or of
// its l_s words.
template <int EXT, int NS, int TY, int R, bool PAIR>
struct Tile {
  static constexpr int NT = kTileZ * TY;
  static constexpr int TR = TY * R + 2 * EXT;              // rows of the haloed tile
  static constexpr int SW = kTileZ + 2 * EXT;              // points a row (even)
  static constexpr int PW = PAIR ? SW / 2 : SW;            // psi copies a row
  static constexpr int LW = SW / 2 + (PAIR ? 0 : 1);       // l_s words a row
  static constexpr int NP = TR * PW;                       // psi copies a plane
  static constexpr int NL = NS * TR * LW;                  // l_s copies a plane
  static constexpr int CP = (NP + NT - 1) / NT;            // psi copies a thread
  static constexpr int CL = (NL + NT - 1) / NT;            // l_s copies a thread
  static constexpr int LOFF = TR * SW;                     // words of psi before the l_s rows
  static constexpr int SLOT = (LOFF + NL + 3) / 4 * 4;     // words a slot (whole 16 bytes)
  // slots in `budget` bytes, at least EXT + 2: a slot lives EXT + 1
  // steps, and one is filled while they are read
  __host__ __device__ static constexpr int slots(int budget) {
    return budget / (4 * SLOT) < EXT + 2 ? EXT + 2 : budget / (4 * SLOT);
  }
  __host__ __device__ static constexpr int ring_bytes(int budget) {
    return 4 * SLOT * slots(budget);
  }
};

// An 8-byte asynchronous copy into shared memory: two psi points of a row.
__device__ __forceinline__ void copy_async8(float* dst, const float* src) {
  const unsigned to = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(to), "l"(src) : "memory");
}

// The bf16 value at half-word h of a slot, upcast (exact: its bits are the
// f32's high half).
__device__ __forceinline__ float slot_bf16(const float* slot, int h) {
  return __uint_as_float((unsigned)reinterpret_cast<const unsigned short*>(slot)[h] << 16);
}

// K1 on a bf16 store for the costly kinds of B (k1_b): march_bf16's
// columns, queues, shared plane, taps, B, update and f64 sums, each
// thread's arithmetic and order as there, and so psi' and the partial rows
// the f32 launch's on the upcast values bit for bit; only the copies move.
// The block copies each x-plane's haloed tile into a ring slot together
// (Tile); a thread reads its columns and halo points from the slot. The
// fetch of step k copies padded plane k + 2*EXT: step k's columns (the
// leading x-tap), and the halo that step k + EXT publishes, so a slot is
// read for EXT + 1 steps. One __syncthreads a plane, the one before the
// taps, also publishes the next step's copies: each thread waits for its
// own copies of step i + 1 just before it.
template <int EXT, int NS, int TY, int R, int RING, bool WIN, bool PAIR>
__device__ __forceinline__ void march_tile(const SweepArgs& a) {
  using M = March<EXT, 1, NS, TY, R>;
  using T = Tile<EXT, NS, TY, R, PAIR>;
  constexpr int NT = M::NT, ROWS = M::ROWS, NR = NS, HR = M::HR;
  constexpr int NSLOT = T::slots(RING);
  constexpr int SW = T::SW, TR = T::TR, LW = T::LW, CP = T::CP, CL = T::CL;
  constexpr int SP = TR * SW;           // the shared plane: the slot's psi rows
  constexpr int NACC = 1 + NR;          // f64 column sums in registers
  __shared__ float plane[2][SP];
  __shared__ double warp_sums[NT / 32];
  extern __shared__ float ring[];       // NSLOT slots of T::SLOT words

  const int tz = threadIdx.x, ty = threadIdx.y, tid = ty * kTileZ + tz;
  const int k0 = blockIdx.x * kTileZ, j0 = blockIdx.y * ROWS, i_lo = blockIdx.z * a.seg;
  const int zv = min(kTileZ, a.nz - k0), yv = min(ROWS, a.ny - j0);  // the tile's columns, rows
  const int i_hi = min(i_lo + a.seg, a.nx);
  const int nxp = a.nx + 2 * EXT, nyp = a.ny + 2 * EXT, nzp = a.nz + 2 * EXT;
  const ptrdiff_t sy = nzp;
  const ptrdiff_t sx = (ptrdiff_t)nyp * nzp;
  const ptrdiff_t vol = sx * nxp;
  const __nv_bfloat16* const lst = a.store_bf16;

  // The shell this block owns: the faces its tile and segment touch.
  {
    const bool last_y = j0 + yv == a.ny, last_z = k0 + zv == a.nz;
    const int z0 = k0 == 0 ? 0 : k0 + EXT, z1 = last_z ? nzp : k0 + zv + EXT;
    const int y0 = j0 == 0 ? 0 : j0 + EXT, y1 = last_y ? nyp : j0 + yv + EXT;
    const int x0 = i_lo + EXT, x1 = i_hi + EXT;
    if (i_lo == 0) zero_box<1>(a.out, vol, sx, sy, 0, EXT, y0, y1, z0, z1, tid, NT);
    if (i_hi == a.nx) zero_box<1>(a.out, vol, sx, sy, x1, nxp, y0, y1, z0, z1, tid, NT);
    if (j0 == 0) zero_box<1>(a.out, vol, sx, sy, x0, x1, 0, EXT, z0, z1, tid, NT);
    if (last_y) zero_box<1>(a.out, vol, sx, sy, x0, x1, a.ny + EXT, nyp, z0, z1, tid, NT);
    if (k0 == 0) zero_box<1>(a.out, vol, sx, sy, x0, x1, j0 + EXT, j0 + yv + EXT, 0, EXT, tid, NT);
    if (last_z) {
      zero_box<1>(a.out, vol, sx, sy, x0, x1, j0 + EXT, j0 + yv + EXT, a.nz + EXT, nzp, tid, NT);
    }
  }

  const bool reduce = a.partials != nullptr;
  const bool apply = a.apply != 0;
  const bool own_l = apply || reduce;  // the l_s: correction and centre

  // this thread's columns: tile rows ty + r*TY, at slot (and plane) index
  // own_s + r*TY*SW
  bool col[R];
  float colv[R];
  ptrdiff_t own[R];  // within a plane
  const int own_s = (ty + EXT) * SW + tz + EXT;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = j0 + ty + r * TY;
    col[r] = tz < zv && j - j0 < yv;
    own[r] = (ptrdiff_t)(j + EXT) * sy + (k0 + tz + EXT);
    colv[r] = analytic_column(a.an, j + EXT, k0 + tz + EXT);
  }
  // the halo points it publishes: point tid + h*NT of the 2*EXT rows above
  // and below the tile's valid rows, then of the 2*EXT columns beside them,
  // at slot (and plane) index h_s
  bool halo[HR];
  int h_s[HR], h_row[HR], h_z[HR];  // its row and point of the haloed tile
#pragma unroll
  for (int h = 0; h < HR; ++h) {
    const int t = tid + h * NT, n_hy = 2 * EXT * zv;
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
    h_row[h] = hy + EXT;
    h_z[h] = hz + EXT;
    h_s[h] = h_row[h] * SW + h_z[h];
  }
  // Without PAIR a row of l_s starts on either half of its first word: the
  // half of a row's start at plane 0 (the store is 4-byte aligned), which
  // flips a plane where a plane holds an odd number of points.
  auto half0 = [&](int s, int row) {
    return (int)((s * vol + (ptrdiff_t)(j0 + row) * sy + k0) & 1);
  };
  static_assert(TY % 2 == 0, "a thread's rows share their half");
  const int flip = (int)(sx & 1);
  int own_h[NR], h_h[HR][NR];
#pragma unroll
  for (int s = 0; s < NR; ++s) {
    own_h[s] = PAIR ? 0 : half0(s, ty + EXT);
#pragma unroll
    for (int h = 0; h < HR; ++h) h_h[h][s] = PAIR ? 0 : half0(s, h_row[h]);
  }

  // The copies: a pointer each, at step i_lo - EXT's plane first and one
  // plane on each fetch, into word (PAIR ? 2 : 1)*t of a slot's psi rows
  // and word t of its l_s rows (t = tid + c*NT: the items in row order).
  // p_ok: whether a psi copy copies. An l_s copy takes the word that holds
  // point 2*lw of its row where that word holds a point before l_end, the
  // points of the row the step reads (a y-halo row needs none of its
  // corners, so no word past its last column's is read): where l_room =
  // l_end - 2*lw, plus the half of a word the row starts on (0 with PAIR,
  // else moving from plane to plane), is positive.
  const float* f_psi[CP];
  bool p_ok[CP];
  const ptrdiff_t first = (ptrdiff_t)(i_lo + EXT) * sx;  // padded plane of step i_lo - EXT + 2*EXT
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    const int t = tid + c * NT, row = t / T::PW, z = (t - row * T::PW) * (PAIR ? 2 : 1);
    p_ok[c] = t < T::NP && row < yv + 2 * EXT && z < zv + 2 * EXT;
    f_psi[c] = a.psi + first + (ptrdiff_t)(j0 + row) * sy + k0 + z;
  }
  const __nv_bfloat16* f_l[CL];
  int l_room[CL];
#pragma unroll
  for (int c = 0; c < CL; ++c) {
    const int t = tid + c * NT, s = t / (TR * LW), u = t - s * (TR * LW), row = u / LW;
    const int lw = u - row * LW;
    const bool y_halo = row < EXT || row >= yv + EXT;
    const int l_end = t < T::NL && row < yv + 2 * EXT ? (y_halo ? zv + EXT : zv + 2 * EXT) : -1;
    l_room[c] = l_end - 2 * lw;
    f_l[c] = lst + ((ptrdiff_t)s * vol + first + (ptrdiff_t)(j0 + row) * sy + k0 + 2 * lw);
  }

  const int n_red = 1 + a.n_store;
  double* row = nullptr;
  if (reduce) {
    const ptrdiff_t blk = ((ptrdiff_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    row = a.partials + blk * n_red;
  }
  float co[1 + NR];  // coef, read once
  co[0] = apply ? __ldg(a.coef) : 1.0f;
#pragma unroll
  for (int q = 1; q <= NR; ++q) co[q] = apply ? __ldg(a.coef + q) : 0.0f;

  auto load_l = [&](const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); };
  // the corrected value of a point from its psi and l_s
  auto correct = [&](float psi, const float (&l)[NR]) {
    float v = apply ? __fmul_rn(co[0], psi) : psi;
    if (!apply) return v;
#pragma unroll
    for (int s = 0; s < NR; ++s) {
      float vv[1] = {v};
      const float ls[1] = {l[s]};
      subtract<1>(vv, ls, co[1 + s], 0.0f);
      v = vv[0];
    }
    return v;
  };
  // one copy group a step, into `slot`: step k's plane, padded k + 2*EXT
  auto fetch = [&](int k, float* slot) {
    if (k < i_hi) {
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        if (!p_ok[c]) continue;
        if constexpr (PAIR) {
          copy_async8(slot + 2 * (tid + c * NT), f_psi[c]);
        } else {
          copy_async(slot + tid + c * NT, f_psi[c]);
        }
      }
      if (own_l) {
#pragma unroll
        for (int c = 0; c < CL; ++c) {
          const int half = PAIR ? 0 : (int)(((uintptr_t)f_l[c] >> 1) & 1u);
          if (l_room[c] + half > 0) {
            copy_async(slot + T::LOFF + tid + c * NT,
                       PAIR ? reinterpret_cast<const float*>(f_l[c]) : word_of(f_l[c]));
          }
        }
      }
    }
    copy_commit();
#pragma unroll
    for (int c = 0; c < CP; ++c) f_psi[c] += sx;
#pragma unroll
    for (int c = 0; c < CL; ++c) f_l[c] += sx;
  };

  // steps i_lo - EXT .. i_lo - EXT + NSLOT - 2 into slots 0 .., in flight
  // while the queues' first planes are read
#pragma unroll
  for (int d = 0; d + 1 < NSLOT; ++d) fetch(i_lo - EXT + d, ring + d * T::SLOT);
  // q[r][m]: column r's corrected value at plane i-EXT+m; lq[r][m]: its
  // l_s at plane i+m
  float q[R][2 * EXT + 1];
  float lq[R][EXT + 1][NR];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int m = 0; m < 2 * EXT; ++m) {
      const ptrdiff_t p = (ptrdiff_t)(i_lo + m) * sx + own[r];  // padded plane of i_lo-EXT+m
      float psi = 0.0f, l[NR];
#pragma unroll
      for (int s = 0; s < NR; ++s) l[s] = 0.0f;
      if (col[r]) {
        psi = __ldg(a.psi + p);
        if (own_l) {
#pragma unroll
          for (int s = 0; s < NR; ++s) l[s] = load_l(lst + (s * vol + p));
        }
      }
      q[r][m] = correct(psi, l);
      if (m >= EXT) {
#pragma unroll
        for (int s = 0; s < NR; ++s) lq[r][m - EXT][s] = l[s];
      }
    }
  }
  // step i_lo's columns and halo (slots EXT and 0) landed and published
  copy_wait<NSLOT - 2 - EXT>();
  __syncthreads();

  double acc[NACC];
#pragma unroll
  for (int n = 0; n < NACC; ++n) acc[n] = 0.0;

  // the slots of step i's columns and halo, and the one it refills (step
  // i - EXT - 1's, read for the last time by step i - 1)
  float* const ring_end = ring + NSLOT * T::SLOT;
  auto next = [&](float* slot) { return slot + T::SLOT == ring_end ? ring : slot + T::SLOT; };
  float *cs = ring + EXT * T::SLOT, *hs = ring, *fs = ring + (NSLOT - 1) * T::SLOT;
  // where step i writes psi' of column 0 (column r: r*TY rows on)
  float* o_out = a.out + (ptrdiff_t)(i_lo + EXT) * sx + own[0];
#pragma unroll 1
  for (int i = i_lo; i < i_hi; ++i) {
    // the flips of the column plane (padded i + 2*EXT) and the halo's (i + EXT)
    const int pc = PAIR ? 0 : ((i + 2 * EXT) * flip) & 1, ph = PAIR ? 0 : ((i + EXT) * flip) & 1;
    float o_psi[R], o_l[R][NR], h_psi[HR], h_l[HR][NR];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      o_psi[r] = cs[own_s + r * TY * SW];
#pragma unroll
      for (int s = 0; s < NR; ++s) {
        o_l[r][s] = slot_bf16(cs, 2 * T::LOFF + (s * TR + ty + EXT + r * TY) * 2 * LW + tz + EXT +
                                      (own_h[s] ^ pc));
      }
    }
#pragma unroll
    for (int hh = 0; hh < HR; ++hh) {
      h_psi[hh] = hs[h_s[hh]];
#pragma unroll
      for (int s = 0; s < NR; ++s) {
        h_l[hh][s] = slot_bf16(hs, 2 * T::LOFF + (s * TR + h_row[hh]) * 2 * LW + h_z[hh] +
                                       (h_h[hh][s] ^ ph));
      }
    }
    fetch(i + NSLOT - 1 - EXT, fs);
    cs = next(cs);
    hs = next(hs);
    fs = next(fs);

    float* sp = plane[(i - i_lo) & 1];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      q[r][2 * EXT] = correct(o_psi[r], o_l[r]);
#pragma unroll
      for (int s = 0; s < NR; ++s) lq[r][EXT][s] = o_l[r][s];
      if (col[r]) sp[own_s + r * TY * SW] = q[r][EXT];
    }
#pragma unroll
    for (int hh = 0; hh < HR; ++hh) {
      const float hv = correct(h_psi[hh], h_l[hh]);
      if (halo[hh]) sp[h_s[hh]] = hv;
    }
    copy_wait<NSLOT - 2 - EXT>();  // this thread's copies of step i + 1
    __syncthreads();

    // the plane's windows, the same for the whole block (x is the marching
    // axis)
    const bool in_grid = !WIN || (i >= a.grid_x0 && i < a.grid_x1);
    const bool red_plane = !WIN || (i >= a.red_x0 && i < a.red_x1);
    float bb[R];
    {
      const float px = k1_plane(a.an, i + EXT);
#pragma unroll
      for (int r = 0; r < R; ++r) bb[r] = k1_b(a, colv[r], px);
    }
    float nxt[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      nxt[r] = 0.0f;
      if (!col[r]) continue;
      const int s0 = own_s + r * TY * SW;
      const float c0 = q[r][EXT];
      float t = -center<EXT>() * c0;
#pragma unroll
      for (int o2 = 1; o2 <= EXT; ++o2) {
        const float cf = tap<EXT>(o2);
        t += cf * (q[r][EXT + o2] + q[r][EXT - o2]);
        t += cf * (sp[s0 + o2 * SW] + sp[s0 - o2 * SW]);
        t += cf * (sp[s0 + o2] + sp[s0 - o2]);
      }
      nxt[r] = bb[r] * (2.0f * c0 + a.scale * t) - c0;
      if constexpr (WIN) {
        if (!in_grid) nxt[r] = 0.0f;
      }
      o_out[r * TY * sy] = nxt[r];
    }

    if (reduce) {
      // a plane outside the reduction window adds zeros (a select)
      float w[R];
#pragma unroll
      for (int r = 0; r < R; ++r) w[r] = red_plane ? nxt[r] : 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!col[r]) continue;  // outside the tile
        acc[0] += (double)(w[r] * w[r]);
#pragma unroll
        for (int s = 0; s < NR; ++s) acc[1 + s] += (double)(lq[r][0][s] * w[r]);
      }
    }

    o_out += sx;
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int m = 0; m < 2 * EXT; ++m) q[r][m] = q[r][m + 1];
#pragma unroll
      for (int m = 0; m < EXT; ++m) {
#pragma unroll
        for (int s = 0; s < NR; ++s) lq[r][m][s] = lq[r][m + 1][s];
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

// Blocks an SM must hold for the costly kinds' sweep of (EXT, NS, PAIR):
// four, 64 registers a thread, where the 8-byte form fits them without
// spilling (S = 1; S = 2 at EXT 1), and min_blocks else.
template <int EXT, int NS, bool PAIR>
constexpr int tile_min_blocks() {
  return PAIR && (NS == 1 || (NS == 2 && EXT == 1)) ? 4 : min_blocks<EXT, NS>();
}

// K1 on a bf16 store for every source of B but the costly kinds.
template <int EXT, int NS, bool WIN>
__global__ void __launch_bounds__(kThreads, (min_blocks<EXT, NS>())) sweep_step_bf16_kernel(
    const SweepArgs a) {
  if (skipped(a.done)) return;
  march_bf16<EXT, NS, kTileY, kRows, kRingBytes, WIN>(a);
}

// K1 on a bf16 store for Coulomb, SimpleCornell and Periodic B (k1_b),
// with the tile copy's psi rows in 8-byte pairs (PAIR) or 4-byte points.
template <int EXT, int NS, bool WIN, bool PAIR>
__global__ void __launch_bounds__(kThreads, (tile_min_blocks<EXT, NS, PAIR>()))
    sweep_step_bf16_costly_kernel(const SweepArgs a) {
  if (skipped(a.done)) return;
  march_tile<EXT, NS, kTileY, kRows, kTileRingBytes, WIN, PAIR>(a);
}

template <int EXT, int NS, bool WIN>
void launch_bf(const SweepArgs& a, cudaStream_t s) {
  constexpr int bytes = March<EXT, 1, NS, kTileY, kRows>::ring_bytes(kRingBytes);
  void (*kernel)(const SweepArgs) = sweep_step_bf16_kernel<EXT, NS, WIN>;
  // the ring may pass the 48 KB a launch gets without asking (set once)
  static const cudaError_t allowed =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  (void)allowed;  // a refusal shows as the launch's error
  kernel<<<sweep_grid(a), dim3(kTileZ, kTileY, 1), bytes, s>>>(a);
}

template <int EXT, int NS, bool WIN, bool PAIR>
void launch_tile(const SweepArgs& a, cudaStream_t s) {
  constexpr int bytes = Tile<EXT, NS, kTileY, kRows, PAIR>::ring_bytes(kTileRingBytes);
  void (*kernel)(const SweepArgs) = sweep_step_bf16_costly_kernel<EXT, NS, WIN, PAIR>;
  static const cudaError_t allowed =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  (void)allowed;
  kernel<<<sweep_grid(a), dim3(kTileZ, kTileY, 1), bytes, s>>>(a);
}

// The kernel of a launch's source of B: the costly kinds' own (as the f32
// sweep's, stencil_sweep.cu) with the copy width of row_copy_bytes, or the
// one of the others.
template <int EXT, int NS, bool WIN>
void launch_ns(const SweepArgs& a, cudaStream_t s) {
  if (!costly_kind(a.an.kind)) {
    launch_bf<EXT, NS, WIN>(a, s);
  } else if (row_copy_bytes(a.psi, a.nz, EXT) == 8) {
    launch_tile<EXT, NS, WIN, true>(a, s);
  } else {
    launch_tile<EXT, NS, WIN, false>(a, s);
  }
}

}  // namespace

extern "C" {

int launch_k1_bf16(const SweepArgs& a, int ext, cudaStream_t s) {
  return with_ext(ext, [&](auto e) {
    return with_window(a, [&](auto w) {
      constexpr int EXT = decltype(e)::value;
      constexpr bool WIN = decltype(w)::value;
      if (a.n_store == 1) launch_ns<EXT, 1, WIN>(a, s);
      if (a.n_store == 2) launch_ns<EXT, 2, WIN>(a, s);  // sweep_route sends no other count
      return (int)cudaGetLastError();
    });
  });
}

// The width in bytes of the psi row copies of K1's launch with these
// arguments of wafer_sweep_step (launch_ns's rule): 8 or 4 for a costly
// kind of B on this route (march_tile), 0 for any other launch, which
// copies no rows.
int wafer_sweep_row_copy_bytes(const void* psi, int nz, int ext, int n_store, int kind,
                               int store_bf16) {
  if (sweep_route(false, n_store, store_bf16 != 0) != kRouteBf16 || !costly_kind(kind)) return 0;
  return row_copy_bytes(psi, nz, ext);
}

}  // extern "C"
