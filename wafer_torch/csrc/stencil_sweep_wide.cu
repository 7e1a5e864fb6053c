// K1 with five or more stored states (f32 or bf16 store) and K3 with three
// or more stored pairs: the Hopper (sm_90a) kernels sweep_step_wide_kernel,
// sweep_step_bf16_wide_kernel and sweep_step_sc_wide_kernel, reached
// through wafer_sweep_step (stencil_sweep.cu) for S > wafer_sweep_many_max()
// and through wafer_sweep_step_sc (split_sweep.cu) for S >= 3, and counted
// as LAUNCHES["sweep_step_wide"], ["sweep_step_bf16_wide"] and
// ["sweep_step_sc_wide"] (wafer_torch/ops/hopper_stencil.py).
//
// They replace the excited modes of wafer_tpu/ops/pallas_stencil.py and
// pallas_split.py for a solve's sixth state on (a complex solve's fourth):
// _evolve_kernel_res (B3) with n_lower >= 5 on f32 and bf16 store_xpad,
// the pair kernels B7-B11 with n_lower >= 3, and the large-grid and sharded
// dispatches of the same chunk (B4, B12) on a block with an origin and a
// reduction window. The reference compiles a Pallas kernel for each static
// count (pallas_stencil.py:226-228); here the count has no upper bound, so
// it stays a run-time value. They compute what K1 and K3 compute, on the
// fully padded layout,
//     c     = inv*psi - sum_s corr_s*l_s       (pair: complex corr_s)
//     psi'  = B*(2c + scale*L(c)) - c          (interior; pair: complex B)
//     psi'  = 0                                (the Dirichlet shell)
// with one row of partial sums of |psi'|^2 and <l_s|psi'> (pair: Re and Im,
// conjugated) per block.
//
// What bounds them. Their least work is HBM bytes: psi read and psi'
// written once (8 B a point, a pair 16 B), and each stored state read once
// (4 B, bf16 2 B, a pair 8 B): 28 B a point for K1 at S = 5 in f32, 40 B
// for K3 at S = 3. The ~10 flops a stored state a point are far below the
// card's 20 flops a byte. The run-time count that these launches took
// before (march's NS == kAnyS) spent its time elsewhere: a block sum with
// two barriers for every stored state on every plane, each l_s read with
// __ldg where it was used (twice for a column's centre), and 128-168
// registers, one block an SM (9-23 % of the bound on an H100, PERF.md).
//
// The design, a ring of planes: K1's schedule (16 x 32 (y, z) tiles of
// 8 x 32 threads, two rows a thread, segments of up to 16 x-planes,
// register queues for the x-taps, a shared plane with an EXT-deep halo for
// the y/z taps), so the launch shape and the partial rows are K1's and
// K3's, and
// - one cp.async copy group a plane, one plane ahead, in dynamic shared
//   memory sized at run time by S (as far as it fits, below): a step ring
//   of two slots (the columns' psi at plane i+EXT and B at plane i, the
//   halo points' psi and every l_s at plane i, the halo fields packed to
//   the halo's points) and a column ring of EXT+2 slots (the columns' every
//   l_s), in which a column's l_s stays from the plane where it corrects
//   the column's value (i+EXT) to the plane where it weighs psi' (i): each
//   value is read from HBM once;
// - the march starts 2*EXT planes before its segment: those warm-up steps
//   bring the columns' first planes through the rings into the x-queue, so
//   no value is read outside the copy pipeline;
// - the correction c = inv*psi - sum_s corr_s*l_s and the overlaps loop
//   over s at run time, the coefficients in shared memory, the correction
//   in the order of s (subtract<NC>'s roundings);
// - each thread adds its products <l_s|psi'> in f64 to a shared-memory
//   slot of its own, no barrier and no atomic; the block sums its 1+NC*S
//   values once at the end of its segment, as the fixed-count kernels do;
// - each thread reads back only the ring fields it copied: one
//   __syncthreads a plane, for the shared plane;
// - one pointer a column and halo point per stream, stepped a plane a
//   fetch; state s is at s*NC*vol from it; copies address shared memory
//   by 32-bit offsets;
// - the state loops unrolled twice (four times, and not at all, measured
//   slower).
// Measured on an H100 (PERF.md, tools/tune_sweep.py in turns): copies two
// planes ahead ran 7-40 % slower than one ahead; a launch whose two blocks
// take more than 196 KB of an SM's shared memory (which leaves L1 28 KB,
// not 60) ran about a quarter slower, so the halo fields are packed and B's
// fields kept only where it streams (S = 9 went from 0.566 to 0.447 ms at
// 256^3); a bound of three blocks an SM (80 registers) ran up to 30 %
// slower. Groups of four states walked through a fixed ring, each column's
// l_s fetched twice (a first design), ran 21-53 % slower than this ring's
// first form.
// The rings hold every stored state while their shared memory fits what a
// block may have (227 KB on an H100): K1 up to 24 states at EXT 1 and 15 at
// EXT 3, K3 up to 11 pairs at EXT 1 and 7 at EXT 3 (the launch's G, less
// where B streams). The states past them read each l_s where it is used
// (the correction at plane i+EXT, the overlap at plane i, the second read
// from L2), with their coefficients from global memory, and sum their
// overlaps a warp at a time by shuffles, kChunk states a block sum of two
// barriers a plane, into the block's partial row: shared memory that does
// not grow with S, so every count runs. That code is in kernels of its own
// (OVER, with the plane checks, which full windows pass), so a launch the
// rings hold runs the kernels without it. A launch that fails raises: no
// fallback.
// B as the other kernels take it: streamed from the step ring, K1's
// Harmonic by harmonic_b, its costly kinds by k1_b, NoPotential's V = 0, and
// K3's complex B per column from analytic_v_ieee.
// The sums of <l_s|psi'> run in another order than the run-time count's
// (one f64 sum a thread down its columns, then the block), and f32 and bf16
// stores share this code: a bf16 launch equals the f32 launch on its upcast
// values bit for bit.
// Given a batch's flag `done` that is set, every block returns before it
// reads or writes anything.
//
// Build: as stencil_sweep.cu (nvcc -gencode arch=compute_90a,code=sm_90a
//        -std=c++17 -O3, no --use_fast_math); a translation unit of its own,
//        compiled beside the others.

#include "sweep_common.cuh"

namespace {

// K1's thread shape (stencil_sweep.cu), for K1 and K3 alike, on the one
// tile grid. K3 takes S >= kPairMinS here (split_sweep.cu keeps S <= 2).
constexpr int kTileY = 8;      // thread rows of a block: 256 threads
constexpr int kRows = 2;       // tile rows a thread owns: 16 x 32 tiles
constexpr int kMinBlocks = 2;  // blocks an SM must hold at least: 128 registers a thread
constexpr int kThreads = kTileZ * kTileY;
static_assert(kTileY * kRows == kTileRows, "the wide route launches the one tile grid");
constexpr int kWarps = kThreads / 32;  // a warp a tile row (kTileZ = 32)
constexpr int kChunk = 8;  // states past the rings summed a block sum at a time

// The dynamic shared memory of a launch with S stored states, G of them in
// the rings: the overlap slots (NC*G doubles a thread), where G < S the
// warps' sums of the states past the rings (kChunk*NC*kWarps doubles), the
// coefficients (1+NC*G floats), the step ring (two slots: NT floats a
// column field, the columns' psi [NC][R] and, where B streams, B [NC][R],
// then HP floats a halo field, the halo points' psi [NC] and l_s [G][NC])
// and the column ring (EXT+2 slots: the columns' l_s [G][NC][R]).
template <int EXT, int NC>
struct WideLayout {
  static constexpr int R = kRows, NT = kThreads, ROWS = kTileY * kRows;
  static constexpr int HR = March<EXT, NC, 0, kTileY, kRows>::HR;  // halo points a thread
  static constexpr int HP = 2 * EXT * (kTileZ + ROWS);  // halo points of a tile, at most
  static constexpr int F_B = NC * R;     // B's first column field
  static constexpr int COLS = EXT + 2;  // column slots: planes i..i+EXT in use, one in flight
  static constexpr int OB = kChunk * NC * kWarps;  // the warps' sums, past the rings
  // the floats of a step slot's column fields, before its halo fields
  __host__ __device__ static int halo_at(bool streamed) {
    return (streamed ? 2 : 1) * NC * R * NT;
  }
  __host__ __device__ static int coef_floats(int s) { return (1 + NC * s + 3) & ~3; }
  __host__ __device__ static int step_slot(int s, bool streamed) {
    return halo_at(streamed) + HP * NC * (1 + s);
  }
  __host__ __device__ static int col_slot(int s) { return NT * s * NC * R; }
  __host__ __device__ static int over(int g, int s) { return g < s ? OB : 0; }
  __host__ __device__ static size_t bytes(int g, int s, bool streamed) {
    const size_t floats = (size_t)coef_floats(g) + 2 * (size_t)step_slot(g, streamed) +
                          (size_t)COLS * col_slot(g);
    return 8 * ((size_t)NC * g * NT + over(g, s)) + 4 * floats;
  }
  // the ring's states of a launch with s: all of them where their shared
  // memory fits `budget` bytes, else the most that do
  static int ring(int s, bool streamed, size_t budget) {
    int g = s;
    while (g > 0 && bytes(g, s, streamed) > budget) --g;
    return g;
  }
};

// A 4-byte asynchronous copy to the shared-memory address `to`.
__device__ __forceinline__ void copy_to(unsigned to, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to), "l"(src) : "memory");
}

template <int EXT, int NC, bool WIN, typename LT, bool OVER>
__device__ __forceinline__ void march_wide(const SweepArgs& a, const int g) {
  constexpr bool BF16 = sizeof(LT) == 2;
  static_assert(NC == 1 || !BF16, "bf16 stores are K1's");
  using L = WideLayout<EXT, NC>;
  constexpr int TY = kTileY, R = kRows, NT = kThreads, ROWS = TY * R, HR = L::HR, HP = L::HP;
  constexpr int F_B = L::F_B, COLS = L::COLS;
  constexpr int SW = kTileZ + 2 * EXT;  // row of the shared plane
  constexpr int SP = (ROWS + 2 * EXT) * SW;
  __shared__ float plane[2][NC][SP];
  __shared__ double warp_sums[NT / 32];
  extern __shared__ double dyn[];  // WideLayout

  const int tz = threadIdx.x, ty = threadIdx.y, tid = ty * kTileZ + tz;
  const int k0 = blockIdx.x * kTileZ, j0 = blockIdx.y * ROWS, i_lo = blockIdx.z * a.seg;
  const int zv = min(kTileZ, a.nz - k0), yv = min(ROWS, a.ny - j0);  // the tile's columns, rows
  const int i_hi = min(i_lo + a.seg, a.nx);
  const int nxp = a.nx + 2 * EXT, nyp = a.ny + 2 * EXT, nzp = a.nz + 2 * EXT;
  const ptrdiff_t sy = nzp;
  const ptrdiff_t sx = (ptrdiff_t)nyp * nzp;
  const ptrdiff_t vol = sx * nxp;   // one component
  const ptrdiff_t svol = NC * vol;  // one stored state
  const int S = a.n_store;
  const int G = OVER ? g : S;  // the states in the rings
  const bool streamed = a.an.kind == kStreamed;
  const int step_slot = L::step_slot(G, streamed), col_slot = L::col_slot(G);
  const int f_h = L::halo_at(streamed);
  double* ovl = dyn;  // overlap n of this thread at ovl[n*NT + tid]
  double* ob = dyn + (size_t)NC * G * NT;  // OVER: a warp's sum n at ob[n*kWarps + warp]
  float* coef = reinterpret_cast<float*>(ob + (OVER ? L::OB : 0));
  float* steps = coef + L::coef_floats(G);
  float* cols = steps + 2 * (size_t)step_slot;
  // the rings' shared-memory byte addresses, for the copies
  const unsigned steps_at = (unsigned)__cvta_generic_to_shared(steps);
  const unsigned cols_at = (unsigned)__cvta_generic_to_shared(cols);
  const LT* lst;
  if constexpr (BF16) {
    lst = a.store_bf16;
  } else {
    lst = a.store;
  }

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
  const bool own_l = apply || reduce;  // the columns' l_s: correction and overlap
  // bf16: a value's selector flips from one padded plane to the next when a
  // plane holds an odd number of elements, and from state s to s+1 when a
  // state does
  const unsigned flip = (unsigned)(sx & 1) * 0x2200u;
  const unsigned vflip = (unsigned)(svol & 1) * 0x2200u;

  // the coefficients, once, for every thread (the barrier is the block's
  // first: the march below reads them)
  for (int n = tid; n < 1 + NC * G; n += NT) coef[n] = apply ? __ldg(a.coef + n) : 0.0f;
  __syncthreads();
  const float inv = apply ? coef[0] : 1.0f;

  // this thread's columns: tile rows ty + r*TY
  bool col[R];
  float colv[R];
  ptrdiff_t own[R];  // within a plane
  unsigned sel[R] = {};  // bf16: state 0's selector at padded plane 0
  const int own_s = (ty + EXT) * SW + tz + EXT;  // row r at + r*TY*SW
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = j0 + ty + r * TY;
    col[r] = tz < zv && j - j0 < yv;
    own[r] = (ptrdiff_t)(j + EXT) * sy + (k0 + tz + EXT);
    colv[r] = streamed ? 0.0f : analytic_column(a.an, j + EXT, k0 + tz + EXT);
    if constexpr (BF16) sel[r] = half_of(lst + own[r]);
  }
  const ptrdiff_t b_plane = (ptrdiff_t)a.ny * a.nz;
  const ptrdiff_t b_vol = b_plane * a.nx;
  // the halo points it publishes: point tid + h*NT of the 2*EXT rows above
  // and below the tile's valid rows, then of the 2*EXT columns beside them
  bool halo[HR];
  ptrdiff_t hpos[HR];  // within a plane
  int h_s[HR];
  int h_at[HR];  // its place in the rings' halo fields (point 0's for none)
  unsigned h_sel[HR] = {};
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
    h_at[h] = halo[h] ? t : 0;
    if constexpr (BF16) h_sel[h] = half_of(lst + hpos[h]);
  }

  // The march starts 2*EXT planes early (i0): those warm-up steps bring the
  // columns of planes i_lo-EXT..i_lo+EXT-1 through the rings, corrected
  // into the x-queue, and leave the columns' l_s of planes i_lo.. in the
  // column ring for their overlaps. The copy pointers of the next fetch:
  // column r at padded plane i+2*EXT and its l_s there (from plane i0), its
  // streamed B at interior plane i, halo point h and its l_s at padded
  // plane i+EXT (from plane i_lo); each steps one plane a fetch.
  const int i0 = i_lo - 2 * EXT;
  const float* f_psi[R];
  const LT* f_l[R];
  const float* f_b[R];
  const float* f_hpsi[HR];
  const LT* f_hl[HR];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const ptrdiff_t q = (ptrdiff_t)(i0 + 2 * EXT) * sx + own[r];
    f_psi[r] = a.psi + q;
    f_l[r] = lst + q;
    f_b[r] = a.b + (ptrdiff_t)i_lo * b_plane + (ptrdiff_t)(j0 + ty + r * TY) * a.nz + (k0 + tz);
  }
#pragma unroll
  for (int h = 0; h < HR; ++h) {
    const ptrdiff_t q = (ptrdiff_t)(i_lo + EXT) * sx + hpos[h];
    f_hpsi[h] = a.psi + q;
    f_hl[h] = lst + q;
  }

  double* row = nullptr;
  if (reduce) {
    const ptrdiff_t blk = ((ptrdiff_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    row = a.partials + blk * (1 + NC * S);
    for (int n = 0; n < NC * G; ++n) ovl[n * NT + tid] = 0.0;
    // the entries past the rings, each by the thread that adds to it
    if (OVER && tid < kChunk * NC) {
      for (int e = tid; e < NC * (S - G); e += kChunk * NC) row[1 + NC * G + e] = 0.0;
    }
  }

  auto copy_l = [&](unsigned to, const LT* src) {
    if constexpr (BF16) {
      copy_to(to, word_of(src));
    } else {
      copy_to(to, src);
    }
  };
  // the value of state s at padded plane x in a word from a ring, whose
  // selector at plane 0 of state 0 is sel0
  auto ring_l = [&](float word, unsigned sel0, int s, int x) -> float {
    if constexpr (BF16) {
      return upcast(word, sel0 ^ ((s & 1) ? vflip : 0u) ^ ((x & 1) ? flip : 0u));
    } else {
      return word;
    }
  };
  // a value of a state past the rings, read where it is used
  auto load_l = [&](const LT* p) -> float {
    if constexpr (BF16) {
      return __bfloat162float(__ldg(p));
    } else {
      return __ldg(p);
    }
  };
  // the floats of column field f, or of halo field f of halo point h, of
  // this thread in a slot
  auto at = [&](int f) { return f * NT + tid; };
  auto hat = [&](int f, int h) { return f_h + f * HP + h_at[h]; };
  // one copy group a plane: what step i consumes, into step slot sl and
  // column slot cl: its columns' psi and l_s at plane i+EXT, and from the
  // segment's first plane on its halo points' psi and l_s and its streamed
  // B at plane i
  auto fetch = [&](int i, int sl, int cl) {
    const bool seg = i >= i_lo;
    if (i < i_hi) {
      const unsigned st = steps_at + 4u * (unsigned)(sl * step_slot);
      const unsigned cs = cols_at + 4u * (unsigned)(cl * col_slot);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!col[r]) continue;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          copy_to(st + 4u * at(c * R + r), f_psi[r] + c * vol);
          if (streamed && seg) copy_to(st + 4u * at(F_B + c * R + r), f_b[r] + c * b_vol);
        }
        if (own_l) {
          const LT* p = f_l[r];
          unsigned d = cs + 4u * at(r);
#pragma unroll 2
          for (int s = 0; s < G; ++s) {
#pragma unroll
            for (int c = 0; c < NC; ++c) copy_l(d + 4u * (c * R * NT), p + c * vol);
            p += svol;
            d += 4u * (NC * R * NT);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < HR; ++h) {
        if (!halo[h] || !seg) continue;
#pragma unroll
        for (int c = 0; c < NC; ++c) copy_to(st + 4u * hat(c, h), f_hpsi[h] + c * vol);
        if (apply) {
          const LT* p = f_hl[h];
          unsigned d = st + 4u * hat(NC, h);
#pragma unroll 2
          for (int s = 0; s < G; ++s) {
#pragma unroll
            for (int c = 0; c < NC; ++c) copy_l(d + 4u * (c * HP), p + c * vol);
            p += svol;
            d += 4u * (NC * HP);
          }
        }
      }
    }
    copy_commit();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      f_psi[r] += sx;
      f_l[r] += sx;
      if (seg) f_b[r] += b_plane;
    }
#pragma unroll
    for (int h = 0; h < HR; ++h) {
      if (seg) {
        f_hpsi[h] += sx;
        f_hl[h] += sx;
      }
    }
  };

  // q[r][m]: column r's corrected value at plane i-EXT+m
  float q[R][2 * EXT + 1][NC] = {};
  fetch(i0, 0, EXT);

  double acc = 0.0;  // f64 column sums of |psi'|^2
  // slots: the step slot step i reads (the next fetch fills the other),
  // the column slots of planes i+EXT (its correction), i (its overlaps)
  // and i+EXT+1 (the next fetch)
  int ss = 0, kc = EXT, ko = 0, kf = EXT + 1;
  for (int i = i0; i < i_hi; ++i) {
    const bool seg = i >= i_lo;  // past the warm-up: the halo, the stencil, psi'
    copy_wait<0>();
    const float* st = steps + (size_t)ss * step_slot;
    const float* cc = cols + (size_t)kc * col_slot;
    float c_col[R][NC], c_halo[HR][NC], bv[R][NC];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float psi = st[at(c * R + r)];
        c_col[r][c] = apply ? __fmul_rn(inv, psi) : psi;
        bv[r][c] = streamed ? st[at(F_B + c * R + r)] : 0.0f;
      }
    }
#pragma unroll
    for (int h = 0; h < HR; ++h) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float psi = st[hat(c, h)];
        c_halo[h][c] = apply ? __fmul_rn(inv, psi) : psi;
      }
    }
    fetch(i + 1, ss ^ 1, kf);

    if (apply) {
      const int xc = i + 2 * EXT, xh = i + EXT;  // padded planes of the columns, halo
#pragma unroll 2
      for (int s = 0; s < G; ++s) {
        const float ar = coef[1 + NC * s], ai = NC == 2 ? coef[2 + NC * s] : 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float l[NC];
#pragma unroll
          for (int c = 0; c < NC; ++c) l[c] = ring_l(cc[at((s * NC + c) * R + r)], sel[r], s, xc);
          subtract<NC>(c_col[r], l, ar, ai);
        }
        if (!seg) continue;
#pragma unroll
        for (int h = 0; h < HR; ++h) {
          float l[NC];
#pragma unroll
          for (int c = 0; c < NC; ++c) l[c] = ring_l(st[hat(NC + s * NC + c, h)], h_sel[h], s, xh);
          subtract<NC>(c_halo[h], l, ar, ai);
        }
      }
      for (int s = G; OVER && s < S; ++s) {  // past the rings, in the same order
        const float ar = __ldg(a.coef + 1 + NC * s);
        const float ai = NC == 2 ? __ldg(a.coef + 2 + NC * s) : 0.0f;
        const LT* p = lst + (ptrdiff_t)s * svol;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float l[NC];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            l[c] = col[r] ? load_l(p + c * vol + (ptrdiff_t)xc * sx + own[r]) : 0.0f;
          }
          subtract<NC>(c_col[r], l, ar, ai);
        }
        if (!seg) continue;
#pragma unroll
        for (int h = 0; h < HR; ++h) {
          float l[NC];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            l[c] = halo[h] ? load_l(p + c * vol + (ptrdiff_t)xh * sx + hpos[h]) : 0.0f;
          }
          subtract<NC>(c_halo[h], l, ar, ai);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < NC; ++c) q[r][2 * EXT][c] = c_col[r][c];
    }

    if (seg) {  // the stencil and psi' of plane i (a warm-up step stops here)
      float(&sp)[NC][SP] = plane[(i - i_lo) & 1];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (col[r]) {
#pragma unroll
          for (int c = 0; c < NC; ++c) sp[c][own_s + r * TY * SW] = q[r][EXT][c];
        }
      }
#pragma unroll
      for (int h = 0; h < HR; ++h) {
        if (halo[h]) {
#pragma unroll
          for (int c = 0; c < NC; ++c) sp[c][h_s[h]] = c_halo[h][c];
        }
      }
      __syncthreads();

      // the plane's windows, the same for the whole block (x is the marching
      // axis)
      const bool in_grid = !WIN || (i >= a.grid_x0 && i < a.grid_x1);
      const bool red_plane = !WIN || (i >= a.red_x0 && i < a.red_x1);
      // B of the plane where it does not stream: K1's Harmonic by
      // harmonic_b, its costly kinds by k1_b, NoPotential's V = 0; K3's per
      // column below
      if constexpr (NC == 1) {
        if (!streamed) {
          if (costly_kind(a.an.kind)) {
            const float px = k1_plane(a.an, i + EXT);
#pragma unroll
            for (int r = 0; r < R; ++r) bv[r][0] = k1_b(a, colv[r], px);
          } else if (a.an.kind == kHarmonic) {
            harmonic_b<R>(a.an, colv, i + EXT, bv);
          } else {
            const float b0 = 1.0f / (1.0f + a.an.half_dt * (0.0f - a.an.vshift));
#pragma unroll
            for (int r = 0; r < R; ++r) bv[r][0] = b0;
          }
        }
      }
      float w[R][NC];  // psi' in the reduction window, else 0
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float nxt[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) nxt[c] = 0.0f;
        if (col[r]) {
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
            nxt[0] = bv[r][0] * (2.0f * c0[0] + a.scale * t[0]) - c0[0];
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
            nxt[0] = br * ur - bi * ui - c0[0];
            nxt[1] = br * ui + bi * ur - c0[1];
          }
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            if constexpr (WIN) {
              if (!in_grid) nxt[c] = 0.0f;
            }
            a.out[c * vol + (ptrdiff_t)(i + EXT) * sx + own[r]] = nxt[c];
          }
        }
        // a plane outside the reduction window adds zeros (a select)
#pragma unroll
        for (int c = 0; c < NC; ++c) w[r][c] = red_plane ? nxt[c] : 0.0f;
      }

      if (reduce) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (!col[r]) continue;
          if constexpr (NC == 1) {
            acc += (double)(w[r][0] * w[r][0]);
          } else {
            acc += (double)(w[r][0] * w[r][0] + w[r][1] * w[r][1]);
          }
        }
        // <l_s|psi'> of the columns at plane i (pair: conjugated), l_s from
        // the column slot of plane i
        const float* co = cols + (size_t)ko * col_slot;
        const int xo = i + EXT;
#pragma unroll 2
        for (int s = 0; s < G; ++s) {
          double* o = ovl + (NC * s) * NT + tid;
          double v[NC];
#pragma unroll
          for (int c = 0; c < NC; ++c) v[c] = o[c * NT];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (!col[r]) continue;  // its ring slots were never filled
            float l[NC];
#pragma unroll
            for (int c = 0; c < NC; ++c) l[c] = ring_l(co[at((s * NC + c) * R + r)], sel[r], s, xo);
            if constexpr (NC == 1) {
              v[0] += (double)(l[0] * w[r][0]);
            } else {
              v[0] += (double)(l[0] * w[r][0] + l[1] * w[r][1]);
              v[1] += (double)(l[0] * w[r][1] - l[1] * w[r][0]);
            }
          }
#pragma unroll
          for (int c = 0; c < NC; ++c) o[c * NT] = v[c];
        }
        // past the rings: l_s read again at plane i, each warp's sums by
        // shuffles, kChunk states at a time summed over the warps in order
        // and added to the row by thread NC*(s - s0) + c
        for (int s0 = G; OVER && s0 < S; s0 += kChunk) {
          const int ns = min(kChunk, S - s0);
          for (int k = 0; k < ns; ++k) {
            const LT* p = lst + (ptrdiff_t)(s0 + k) * svol + (ptrdiff_t)xo * sx;
            double v[NC] = {};
#pragma unroll
            for (int r = 0; r < R; ++r) {
              if (!col[r]) continue;
              float l[NC];
#pragma unroll
              for (int c = 0; c < NC; ++c) l[c] = load_l(p + c * vol + own[r]);
              if constexpr (NC == 1) {
                v[0] += (double)(l[0] * w[r][0]);
              } else {
                v[0] += (double)(l[0] * w[r][0] + l[1] * w[r][1]);
                v[1] += (double)(l[0] * w[r][1] - l[1] * w[r][0]);
              }
            }
#pragma unroll
            for (int c = 0; c < NC; ++c) {
#pragma unroll
              for (int o = 16; o > 0; o >>= 1) v[c] += __shfl_down_sync(0xffffffffu, v[c], o);
              if (tz == 0) ob[(k * NC + c) * kWarps + ty] = v[c];
            }
          }
          __syncthreads();
          if (tid < ns * NC) {
            double t = 0.0;
            for (int wp = 0; wp < kWarps; ++wp) t += ob[tid * kWarps + wp];
            row[1 + NC * s0 + tid] += t;
          }
          __syncthreads();
        }
      }
    }

    ss ^= 1;
    kc = kc + 1 == COLS ? 0 : kc + 1;
    ko = ko + 1 == COLS ? 0 : ko + 1;
    kf = kf + 1 == COLS ? 0 : kf + 1;
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int m = 0; m < 2 * EXT; ++m) {
#pragma unroll
        for (int c = 0; c < NC; ++c) q[r][m][c] = q[r][m + 1][c];
      }
    }
  }

  if (reduce) {
    const double v = block_sum<NT>(acc, warp_sums);
    if (tid == 0) row[0] = v;
    for (int n = 0; n < NC * G; ++n) {
      const double o = block_sum<NT>(ovl[n * NT + tid], warp_sums);
      if (tid == 0) row[1 + n] = o;
    }
  }
}

// K1 with S > wafer_sweep_many_max() stored states on an f32 store, every
// source of B; the same on a bf16 store; K3 with S >= kPairMinS stored pairs.
// OVER: g of them in the rings, the rest read where they are used (WIN
// true); else all S in the rings, g unused.
template <int EXT, bool WIN, bool OVER>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    sweep_step_wide_kernel(const SweepArgs a, const int g) {
  if (skipped(a.done)) return;
  march_wide<EXT, 1, WIN, float, OVER>(a, g);
}

template <int EXT, bool WIN, bool OVER>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    sweep_step_bf16_wide_kernel(const SweepArgs a, const int g) {
  if (skipped(a.done)) return;
  march_wide<EXT, 1, WIN, __nv_bfloat16, OVER>(a, g);
}

template <int EXT, bool WIN, bool OVER>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    sweep_step_sc_wide_kernel(const SweepArgs a, const int g) {
  if (skipped(a.done)) return;
  march_wide<EXT, 2, WIN, float, OVER>(a, g);
}

template <int EXT, int NC, bool WIN, bool BF16, bool OVER = false>
void (*wide_kernel())(const SweepArgs, int) {
  if constexpr (NC == 2) {
    return sweep_step_sc_wide_kernel<EXT, WIN, OVER>;
  } else if constexpr (BF16) {
    return sweep_step_bf16_wide_kernel<EXT, WIN, OVER>;
  } else {
    return sweep_step_wide_kernel<EXT, WIN, OVER>;
  }
}

// A kernel's leave to take all the dynamic shared memory a block may have
// beside its static arrays, and those bytes (asked once a kernel).
struct Dynamic {
  cudaError_t error;
  size_t budget;
};

Dynamic allow_dynamic(void (*kernel)(const SweepArgs, int)) {
  cudaFuncAttributes fa;
  int dev = 0, optin = 0;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e != cudaSuccess) return {e, 0};
  const int budget = optin - (int)fa.sharedSizeBytes;
  return {cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, budget),
          (size_t)budget};
}

// A launch with every stored state in the rings, where they fit, else
// with the most that fit on the kernel with the states past them (OVER).
template <int EXT, int NC, bool WIN, bool BF16>
cudaError_t launch_wide(const SweepArgs& a, cudaStream_t s) {
  static const Dynamic dyn = allow_dynamic(wide_kernel<EXT, NC, WIN, BF16>());
  static const Dynamic dyn_over = allow_dynamic(wide_kernel<EXT, NC, true, BF16, true>());
  using L = WideLayout<EXT, NC>;
  const bool streamed = a.an.kind == kStreamed;
  const dim3 grid = sweep_grid(a);
  const dim3 block(kTileZ, kTileY, 1);
  if (dyn.error != cudaSuccess) return dyn.error;
  if (L::ring(a.n_store, streamed, dyn.budget) == a.n_store) {
    wide_kernel<EXT, NC, WIN, BF16>()<<<grid, block, L::bytes(a.n_store, a.n_store, streamed),
                                       s>>>(a, a.n_store);
  } else {
    if (dyn_over.error != cudaSuccess) return dyn_over.error;
    const int g = L::ring(a.n_store, streamed, dyn_over.budget);
    wide_kernel<EXT, NC, true, BF16, true>()<<<grid, block, L::bytes(g, a.n_store, streamed),
                                               s>>>(a, g);
  }
  return cudaGetLastError();
}

// Blocks an SM, by registers and shared memory, of the kernel a launch with
// n_store stored states takes (without the plane checks, or the kernel of
// the states past the rings), its dynamic shared bytes and the states in
// its rings; a negative CUDA error code on failure.
template <int EXT, int NC, bool BF16>
int wide_occupancy(int n_store, bool streamed, int* bytes, int* ring) {
  static const Dynamic dyn = allow_dynamic(wide_kernel<EXT, NC, false, BF16>());
  static const Dynamic dyn_over = allow_dynamic(wide_kernel<EXT, NC, true, BF16, true>());
  if (dyn.error != cudaSuccess) return -(int)dyn.error;
  if (dyn_over.error != cudaSuccess) return -(int)dyn_over.error;
  using L = WideLayout<EXT, NC>;
  const bool over = L::ring(n_store, streamed, dyn.budget) < n_store;
  *ring = L::ring(n_store, streamed, (over ? dyn_over : dyn).budget);
  const size_t b = L::bytes(*ring, n_store, streamed);
  *bytes = (int)b;
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks,
      over ? wide_kernel<EXT, NC, true, BF16, true>() : wide_kernel<EXT, NC, false, BF16>(),
      kThreads, b);
  return e == cudaSuccess ? blocks : -(int)e;
}

// The route's launch: K1 (NC = 1) on an f32 or (BF16) a bf16 store, or K3.
template <int NC, bool BF16>
int launch_wide_route(const SweepArgs& a, int ext, cudaStream_t s) {
  return with_ext(ext, [&](auto e) {
    return with_window(a, [&](auto w) {
      return (int)launch_wide<decltype(e)::value, NC, decltype(w)::value, BF16>(a, s);
    });
  });
}

}  // namespace

extern "C" {

// Blocks an SM of the wide route's kernel for a launch at EXT ext with
// n_store stored states (pair: K3's; else K1's, bf16 on a bf16 store) and B
// streamed or from coordinates (without the plane checks, or past the
// rings the kernel of the states past them), its dynamic
// shared memory in `bytes` and the states its rings hold in `ring` (the
// rest read where they are used); negative on a CUDA error or an ext it
// lacks.
int wafer_sweep_wide_occupancy(int pair, int bf16, int ext, int n_store, int streamed, int* bytes,
                               int* ring) {
  if (ext < 1 || ext > 3 || (pair && bf16)) return -(int)cudaErrorInvalidValue;
  return with_ext(ext, [&](auto e) {
    constexpr int EXT = decltype(e)::value;
    if (pair) return wide_occupancy<EXT, 2, false>(n_store, streamed != 0, bytes, ring);
    if (bf16) return wide_occupancy<EXT, 1, true>(n_store, streamed != 0, bytes, ring);
    return wide_occupancy<EXT, 1, false>(n_store, streamed != 0, bytes, ring);
  });
}

int launch_k1_wide(const SweepArgs& a, int ext, cudaStream_t s) {
  return launch_wide_route<1, false>(a, ext, s);
}

int launch_k1_bf16_wide(const SweepArgs& a, int ext, cudaStream_t s) {
  return launch_wide_route<1, true>(a, ext, s);
}

int launch_k3_wide(const SweepArgs& a, int ext, cudaStream_t s) {
  return launch_wide_route<2, false>(a, ext, s);
}

}  // extern "C"
