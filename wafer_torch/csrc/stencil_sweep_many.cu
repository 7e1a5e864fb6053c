// K1 with three or four stored states, on f32 or bf16 stores: the Hopper
// (sm_90a) kernels sweep_step_many_kernel and sweep_step_bf16_many_kernel
// (with sweep_step_many_costly_kernel and sweep_step_bf16_many_costly_kernel
// for Coulomb, SimpleCornell and Periodic B), reached through
// wafer_sweep_step (stencil_sweep.cu) for 3 <= S <= kManyS (sweep_route)
// and bound by ctypes in wafer_torch/ops/hopper_stencil.py (counted as
// LAUNCHES["sweep_step_many"] and LAUNCHES["sweep_step_bf16_many"]).
//
// It replaces the excited modes of wafer_tpu/ops/pallas_stencil.py for the
// fourth and fifth states: _evolve_kernel_res (B3) with n_lower = 3 and 4,
// whose Pallas kernel is compiled for each static count with its loops
// unrolled (pallas_stencil.py:226-228, :321-326), on f32 and bf16
// store_xpad, and the large-grid and sharded dispatches of the same chunk
// (B4, B12) on a block with an origin and a reduction window. It computes
// what K1 computes (stencil_sweep.cu), on the fully padded layout,
//     c     = inv*psi - sum_s corr_s*l_s       (l_s upcast to f32 where bf16)
//     psi'  = B*(2c + scale*L(c)) - c          (interior)
//     psi'  = 0                                (the Dirichlet shell)
// with one row of partial sums of |psi'|^2 and <l_s|psi'> per block.
//
// What bounds it. Its least work is HBM bytes: 8 B a point for psi and psi'
// and 4 B (bf16: 2 B) for each stored state, 20 B a point at S = 3 in f32;
// its ~40 flops a point are far below the card's 20 flops a byte. The
// run-time count of march (sweep_common.cuh, before the wide route),
// which every S >= 3 took before, spent its time elsewhere: a block sum
// with two barriers for every stored state on every plane, each l_s read
// with __ldg at the point of use (twice for a column's centre), and
// 128-142 registers, one block an SM (8-13 % of the bound on an H100,
// PERF.md).
// This march keeps K1's schedule (16 x 32 (y, z) tiles of 8 x 32 threads,
// two rows a thread, segments of up to 16 x-planes, register queues for the
// x-taps, a shared plane with an EXT-deep halo for the y/z taps), so its
// launch shape and partial rows are K1's, and fixes the count at compile
// time, as the reference does:
// - a kernel for each count, NS = 3 and 4 (kManyMinS..kManyS), its loops
//   over the states unrolled and its ring sized for them;
// - every l_s, of the columns and of the halo points, comes through the
//   cp.async ring with psi (a bf16 value as its aligned 4-byte word, kept
//   by a byte permute whose selector flips a plane, as stencil_sweep_bf16.cu
//   does); a column's l_s stays in registers from the plane where it
//   corrects the column's value to the plane where it weighs psi'
//   (EXT planes later), and is read once;
// - each thread adds its products <l_s|psi'> in f64 registers down its
//   columns, and the block sums once at the end, 1+S sums, as S <= 2 does;
// - launch bounds of two blocks an SM (128 registers a thread; three, 80
//   registers, for the costly kinds of B at EXT 1 S = 3: min_blocks), and a
//   ring of three or four slots, two or three steps ahead;
// - one pointer a column and halo point per stream, stepped a plane a
//   fetch; state s is at s*vol from it.
// On an H100 (PERF.md; tools/tune_sweep.py in turns against the run-time
// count) these kernels run 3.2-7.7x faster than it at 256^3 and 512^3: f32
// at 58-71 % of the byte bound, bf16 at 43-60 %. The bf16 kernels issue
// the f32 ones' instructions plus a word address and a byte permute for
// every l_s (327-383 instructions a plane loop against 319-357), at two
// blocks an SM, so their saved bytes buy less; Coulomb's S = 4 on a bf16
// store is the slowest, at 43-45 %.
// A launch with more than kManyS stored states takes the wide route
// (stencil_sweep_wide.cu).
// The sums of <l_s|psi'> run in another order than the run-time count's (one f64
// sum a thread down its columns, then the block), and f32 and bf16 stores
// share this code: a bf16 launch equals the f32 launch on its upcast values
// bit for bit.
// Given a batch's flag `done` that is set, every block returns before it
// reads or writes anything.
//
// Build: as stencil_sweep.cu (nvcc -gencode arch=compute_90a,code=sm_90a
//        -std=c++17 -O3, no --use_fast_math).

#include "sweep_common.cuh"

namespace {

// K1's thread shape (stencil_sweep.cu), on the one tile grid; the stored-
// state counts this route takes, a kernel each, are kManyMinS..kManyS
// (sweep_common.cuh).
constexpr int kTileY = 8;          // thread rows of a block: 256 threads
constexpr int kRows = 2;           // tile rows a thread owns: 16 x 32 tiles
constexpr int kRingBytes = 67584;  // shared memory of the copy ring: its steps ahead
constexpr int kMinBlocks = 2;      // blocks an SM must hold at least: caps registers a thread
constexpr int kThreads = kTileZ * kTileY;
static_assert(kTileY * kRows == kTileRows, "K1's many-state sweep launches the one tile grid");

// Blocks an SM must hold for the kernel of (EXT, NM, costly B): three (80
// registers a thread) for the costly kinds' S = 3 at EXT 1, which fit them
// without spilling (nvcc left them 82-94) and measured 2-12 % faster there;
// kMinBlocks (128 registers) else: under a bound of three the cheap kinds'
// S = 3 spilled (bf16, with the plane checks) or ran up to 2 % slower
// (f32), and every S = 4 spilled or ran 2-32 % slower (PERF.md,
// tools/tune_sweep.py).
template <int EXT, int NM, bool COSTLY>
constexpr int min_blocks() {
  return COSTLY && NM == 3 && EXT == 1 ? 3 : kMinBlocks;
}

// The ring of one march with NM stored states: a slot holds, NT floats
// each, the columns' psi [R], their streamed B [R], the halo points' psi
// [HR], the columns' l_s [NM][R] and the halo points' l_s [NM][HR]; as
// many slots as kRingBytes holds, three or four (for four states, four
// slots measured 2 % and six 33-46 % slower than three: PERF.md).
template <int EXT, int NM>
struct ManyRing {
  using M = March<EXT, 1, 0, kTileY, kRows>;
  static constexpr int R = kRows, HR = M::HR, NT = M::NT;
  static constexpr int F_B = R, F_HPSI = 2 * R, F_L = 2 * R + HR, F_HL = F_L + NM * R;
  static constexpr int SLOT = NT * (F_HL + NM * HR);  // floats of a slot
  static constexpr int NSLOT = ring_slots(kRingBytes, 4 * SLOT);
  static constexpr int BYTES = 4 * SLOT * NSLOT;
};

template <int EXT, int NM, bool WIN, bool COSTLY, typename LT>
__device__ __forceinline__ void march_many(const SweepArgs& a) {
  constexpr bool BF16 = sizeof(LT) == 2;
  using Ring = ManyRing<EXT, NM>;
  constexpr int TY = kTileY, R = kRows, NT = kThreads, ROWS = TY * R, HR = Ring::HR;
  constexpr int F_B = Ring::F_B, F_HPSI = Ring::F_HPSI, F_L = Ring::F_L, F_HL = Ring::F_HL;
  constexpr int NSLOT = Ring::NSLOT;
  constexpr int SW = kTileZ + 2 * EXT;  // row of the shared plane
  constexpr int SP = (ROWS + 2 * EXT) * SW;
  static_assert(NSLOT >= 3, "the ring must hold two steps ahead");
  static_assert(NM >= kManyMinS && NM <= kManyS, "a count of this route");
  __shared__ float plane[2][SP];
  __shared__ double warp_sums[NT / 32];
  extern __shared__ float ring[];  // NSLOT slots of Ring::SLOT floats

  const int tz = threadIdx.x, ty = threadIdx.y, tid = ty * kTileZ + tz;
  const int k0 = blockIdx.x * kTileZ, j0 = blockIdx.y * ROWS, i_lo = blockIdx.z * a.seg;
  const int zv = min(kTileZ, a.nz - k0), yv = min(ROWS, a.ny - j0);  // the tile's columns, rows
  const int i_hi = min(i_lo + a.seg, a.nx);
  const int nxp = a.nx + 2 * EXT, nyp = a.ny + 2 * EXT, nzp = a.nz + 2 * EXT;
  const ptrdiff_t sy = nzp;
  const ptrdiff_t sx = (ptrdiff_t)nyp * nzp;
  const ptrdiff_t vol = sx * nxp;
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
  const bool streamed = !COSTLY && a.an.kind == kStreamed;
  // state s of a point is s*vol further. bf16: the selectors flip from
  // one plane to the next when a plane holds an odd number of elements,
  // and from state s to s+1 when a state does
  const unsigned flip = (unsigned)(sx & 1) * 0x2200u;
  const unsigned vflip = (unsigned)(vol & 1) * 0x2200u;

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
  // at padded plane i+EXT; each steps one plane a fetch. State 0's
  // selectors of the step the loop reads (step i_lo first), and where it
  // writes psi'.
  const float* f_psi[R];
  const LT* f_l[R];
  const float* f_b[R];
  const float* f_hpsi[HR];
  const LT* f_hl[HR];
  unsigned sel[R] = {}, h_sel[HR] = {};
  float* o_out[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const ptrdiff_t q = (ptrdiff_t)(i_lo + 2 * EXT) * sx + own[r];
    f_psi[r] = a.psi + q;
    f_l[r] = lst + q;
    f_b[r] = a.b + (ptrdiff_t)i_lo * b_plane + (ptrdiff_t)(j0 + ty + r * TY) * a.nz + (k0 + tz);
    o_out[r] = a.out + (ptrdiff_t)(i_lo + EXT) * sx + own[r];
    if constexpr (BF16) sel[r] = half_of(f_l[r]);
  }
#pragma unroll
  for (int h = 0; h < HR; ++h) {
    const ptrdiff_t q = (ptrdiff_t)(i_lo + EXT) * sx + hpos[h];
    f_hpsi[h] = a.psi + q;
    f_hl[h] = lst + q;
    if constexpr (BF16) h_sel[h] = half_of(f_hl[h]);
  }

  double* row = nullptr;
  if (reduce) {
    const ptrdiff_t blk = ((ptrdiff_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    row = a.partials + blk * (1 + NM);
  }
  float co[1 + NM];  // coef, read once
  co[0] = apply ? __ldg(a.coef) : 1.0f;
#pragma unroll
  for (int s = 0; s < NM; ++s) co[1 + s] = apply ? __ldg(a.coef + 1 + s) : 0.0f;

  auto load_l = [&](const LT* p) -> float {
    if constexpr (BF16) {
      return __bfloat162float(__ldg(p));
    } else {
      return __ldg(p);
    }
  };
  auto copy_l = [&](float* dst, const LT* src) {
    if constexpr (BF16) {
      copy_async(dst, word_of(src));
    } else {
      copy_async(dst, src);
    }
  };
  // state s's value of a word read from the ring, whose state-0 selector is sel0
  auto ring_l = [&](float word, unsigned sel0, int s) -> float {
    if constexpr (BF16) {
      return upcast(word, (s & 1) ? sel0 ^ vflip : sel0);
    } else {
      return word;
    }
  };
  // the corrected value of a point from its psi and l_s (subtract<1>'s
  // roundings)
  auto correct = [&](float psi, const float (&l)[NM]) {
    float v = apply ? __fmul_rn(co[0], psi) : psi;
    if (!apply) return v;
#pragma unroll
    for (int s = 0; s < NM; ++s) v = __fsub_rn(v, __fmul_rn(co[1 + s], l[s]));
    return v;
  };
  // ring field f of this thread in a slot
  auto at = [&](float* slot, int f) { return slot + f * NT + tid; };
  // one copy group a step, into slot sl: what step i consumes, its columns
  // at plane i+EXT, its halo points and streamed B at plane i
  auto fetch = [&](int i, int sl) {
    if (i < i_hi) {
      float* slot = ring + sl * Ring::SLOT;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!col[r]) continue;
        copy_async(at(slot, r), f_psi[r]);
        if (own_l) {
#pragma unroll
          for (int s = 0; s < NM; ++s) copy_l(at(slot, F_L + s * R + r), f_l[r] + s * vol);
        }
        if (streamed) copy_async(at(slot, F_B + r), f_b[r]);
      }
#pragma unroll
      for (int h = 0; h < HR; ++h) {
        if (!halo[h]) continue;
        copy_async(at(slot, F_HPSI + h), f_hpsi[h]);
        if (apply) {
#pragma unroll
          for (int s = 0; s < NM; ++s) copy_l(at(slot, F_HL + s * HR + h), f_hl[h] + s * vol);
        }
      }
    }
    copy_commit();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      f_psi[r] += sx;
      f_l[r] += sx;
      f_b[r] += b_plane;
    }
#pragma unroll
    for (int h = 0; h < HR; ++h) {
      f_hpsi[h] += sx;
      f_hl[h] += sx;
    }
  };

  // q[r][m]: column r's corrected value at plane i-EXT+m; lq[r][m]: its
  // l_s at plane i+m
  float q[R][2 * EXT + 1];
  float lq[R][EXT + 1][NM];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int m = 0; m < 2 * EXT; ++m) {
      const ptrdiff_t p = (ptrdiff_t)(i_lo + m) * sx + own[r];  // padded plane of i_lo-EXT+m
      float psi = 0.0f, l[NM];
#pragma unroll
      for (int s = 0; s < NM; ++s) l[s] = 0.0f;
      if (col[r]) {
        psi = __ldg(a.psi + p);
        if (own_l) {
#pragma unroll
          for (int s = 0; s < NM; ++s) l[s] = load_l(lst + (s * vol + p));
        }
      }
      q[r][m] = correct(psi, l);
      if (m >= EXT) {
#pragma unroll
        for (int s = 0; s < NM; ++s) lq[r][m - EXT][s] = l[s];
      }
    }
  }
#pragma unroll
  for (int d = 0; d + 1 < NSLOT; ++d) fetch(i_lo + d, d);

  double acc[1 + NM];  // f64 column sums: |psi'|^2, then <l_s|psi'>
#pragma unroll
  for (int n = 0; n <= NM; ++n) acc[n] = 0.0;

  int sl = 0, fsl = NSLOT - 1;  // the slot step i reads, and refills
  for (int i = i_lo; i < i_hi; ++i) {
    // step i's copies have landed; the slot of step i-1 takes step
    // i+NSLOT-1's
    copy_wait<NSLOT - 2>();
    float* slot = ring + sl * Ring::SLOT;
    float o_psi[R], o_l[R][NM], h_psi[HR], h_l[HR][NM];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      o_psi[r] = *at(slot, r);
#pragma unroll
      for (int s = 0; s < NM; ++s) o_l[r][s] = ring_l(*at(slot, F_L + s * R + r), sel[r], s);
      sel[r] ^= flip;
    }
#pragma unroll
    for (int hh = 0; hh < HR; ++hh) {
      h_psi[hh] = *at(slot, F_HPSI + hh);
#pragma unroll
      for (int s = 0; s < NM; ++s) h_l[hh][s] = ring_l(*at(slot, F_HL + s * HR + hh), h_sel[hh], s);
      h_sel[hh] ^= flip;
    }
    fetch(i + NSLOT - 1, fsl);
    sl = sl + 1 == NSLOT ? 0 : sl + 1;
    fsl = fsl + 1 == NSLOT ? 0 : fsl + 1;

    float* sp = plane[(i - i_lo) & 1];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      q[r][2 * EXT] = correct(o_psi[r], o_l[r]);
#pragma unroll
      for (int s = 0; s < NM; ++s) lq[r][EXT][s] = o_l[r][s];
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
    // B of the plane: from the step's slot where it streams (the next fetch
    // refills it only a step later), Harmonic's x part once (harmonic_b),
    // the costly kinds' by k1_b, NoPotential's V = 0
    float bv[R][1];
    if constexpr (COSTLY) {
      const float px = k1_plane(a.an, i + EXT);
#pragma unroll
      for (int r = 0; r < R; ++r) bv[r][0] = k1_b(a, colv[r], px);
    } else {
      if (streamed) {
#pragma unroll
        for (int r = 0; r < R; ++r) bv[r][0] = *at(slot, F_B + r);
      } else if (a.an.kind == kHarmonic) {
        harmonic_b<R>(a.an, colv, i + EXT, bv);
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) bv[r][0] = 1.0f / (1.0f + a.an.half_dt * (0.0f - a.an.vshift));
      }
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
      nxt[r] = bv[r][0] * (2.0f * c0 + a.scale * t) - c0;
      if constexpr (WIN) {
        if (!in_grid) nxt[r] = 0.0f;
      }
      *o_out[r] = nxt[r];
    }

    if (reduce) {
      // a plane outside the reduction window adds zeros (a select)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!col[r]) continue;  // its ring slots were never filled
        const float w = red_plane ? nxt[r] : 0.0f;
        acc[0] += (double)(w * w);
#pragma unroll
        for (int s = 0; s < NM; ++s) acc[1 + s] += (double)(lq[r][0][s] * w);
      }
    }

#pragma unroll
    for (int r = 0; r < R; ++r) {
      o_out[r] += sx;
#pragma unroll
      for (int m = 0; m < 2 * EXT; ++m) q[r][m] = q[r][m + 1];
#pragma unroll
      for (int m = 0; m < EXT; ++m) {
#pragma unroll
        for (int s = 0; s < NM; ++s) lq[r][m][s] = lq[r][m + 1][s];
      }
    }
  }

  if (reduce) {
#pragma unroll
    for (int n = 0; n <= NM; ++n) {
      const double v = block_sum<NT>(acc[n], warp_sums);
      if (tid == 0) row[n] = v;
    }
  }
}

// K1 with NM stored states (kManyMinS..kManyS) on an f32 store: every
// source of B but the costly kinds, and the costly kinds' (k1_b).
template <int EXT, int NM, bool WIN>
__global__ void __launch_bounds__(kThreads, (min_blocks<EXT, NM, false>()))
    sweep_step_many_kernel(const SweepArgs a) {
  if (skipped(a.done)) return;
  march_many<EXT, NM, WIN, false, float>(a);
}

template <int EXT, int NM, bool WIN>
__global__ void __launch_bounds__(kThreads, (min_blocks<EXT, NM, true>()))
    sweep_step_many_costly_kernel(const SweepArgs a) {
  if (skipped(a.done)) return;
  march_many<EXT, NM, WIN, true, float>(a);
}

// The same on a bf16 store.
template <int EXT, int NM, bool WIN>
__global__ void __launch_bounds__(kThreads, (min_blocks<EXT, NM, false>()))
    sweep_step_bf16_many_kernel(const SweepArgs a) {
  if (skipped(a.done)) return;
  march_many<EXT, NM, WIN, false, __nv_bfloat16>(a);
}

template <int EXT, int NM, bool WIN>
__global__ void __launch_bounds__(kThreads, (min_blocks<EXT, NM, true>()))
    sweep_step_bf16_many_costly_kernel(const SweepArgs a) {
  if (skipped(a.done)) return;
  march_many<EXT, NM, WIN, true, __nv_bfloat16>(a);
}

template <int EXT, int NM, bool WIN, bool COSTLY, bool BF16>
void launch_many(const SweepArgs& a, cudaStream_t s) {
  constexpr int bytes = ManyRing<EXT, NM>::BYTES;
  void (*kernel)(const SweepArgs) = nullptr;
  if constexpr (BF16 && COSTLY) {
    kernel = sweep_step_bf16_many_costly_kernel<EXT, NM, WIN>;
  } else if constexpr (BF16) {
    kernel = sweep_step_bf16_many_kernel<EXT, NM, WIN>;
  } else if constexpr (COSTLY) {
    kernel = sweep_step_many_costly_kernel<EXT, NM, WIN>;
  } else {
    kernel = sweep_step_many_kernel<EXT, NM, WIN>;
  }
  // the ring passes the 48 KB a launch gets without asking (set once)
  static const cudaError_t allowed =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  (void)allowed;  // a refusal shows as the launch's error
  kernel<<<sweep_grid(a), dim3(kTileZ, kTileY, 1), bytes, s>>>(a);
}

template <int EXT, int NM, bool WIN, bool BF16>
void launch_many_b(const SweepArgs& a, cudaStream_t s) {
  if (costly_kind(a.an.kind)) {
    launch_many<EXT, NM, WIN, true, BF16>(a, s);
  } else {
    launch_many<EXT, NM, WIN, false, BF16>(a, s);
  }
}

// The route's launch on an f32 or (BF16) a bf16 store.
template <bool BF16>
int launch_many_route(const SweepArgs& a, int ext, cudaStream_t s) {
  return with_ext(ext, [&](auto e) {
    return with_window(a, [&](auto w) {
      constexpr int EXT = decltype(e)::value;
      constexpr bool WIN = decltype(w)::value;
      if (a.n_store == 3) launch_many_b<EXT, 3, WIN, BF16>(a, s);
      if (a.n_store == 4) launch_many_b<EXT, 4, WIN, BF16>(a, s);
      return (int)cudaGetLastError();
    });
  });
}

}  // namespace

extern "C" {

int launch_k1_many(const SweepArgs& a, int ext, cudaStream_t s) {
  return launch_many_route<false>(a, ext, s);
}

int launch_k1_bf16_many(const SweepArgs& a, int ext, cudaStream_t s) {
  return launch_many_route<true>(a, ext, s);
}

}  // extern "C"
