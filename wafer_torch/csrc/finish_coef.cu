// K2 finish_coef for Hopper (sm_90a), with a plain C interface bound by
// ctypes in wafer_torch/ops/hopper_stencil.py.
//
// What it replaces. The TPU kernels carry the per-slab sums of |psi'|^2 and
// <l_s|psi'> in SMEM across their sequential grid and add them in order
// (wafer_tpu/ops/pallas_stencil.py:316-332, racc), then run the coefficient
// recursion (:2507-2516); on a mesh the shards' sums meet in a psum. Blocks
// of K1 and K3 run in no order, so they write one row of partial sums each
// to a (n_blocks, n_red) f64 array, and K2 adds the rows column by column in
// a fixed order and writes
//     red  = the column sums (f64)
//     coef = [rsqrt(max(red_0, 1e-37)), red_q * inv]   (f32)
// for the next sweep, on the device, with no host synchronisation and no
// float atomics: a seeded run repeats to the bit. On a mesh it runs once over
// every shard's rows.
//
// What bounds it on this card. Its bytes are nothing: 16,384 rows x 2
// columns at 512^3 are 256 KB, 0.08 us at 3.35 TB/s, and they sit in L2, just
// written by the sweep. What it costs is latency: the launch itself (an empty
// kernel launched the same way takes 1.7-1.9 us back to back on an H100), the
// L2 round trips a thread waits on, the barriers of the block sums and, with
// several blocks, the hand-over to the last one, and in one block the
// instructions one SM issues. Measured on an H100 (chip_smoke.py phase 2e,
// tools/tune_finish.py, PERF.md): the design it replaced, one block of
// 1,024 threads making one strided pass a column, costs a pass a column;
// a shared-memory tree over 1,024 threads (ten barriers), L2-only (.cg)
// loads of whole rows and indices clamped into range at every load each
// cost more than they saved.
// The design:
// - a thread adds whole rows, each row's n_red doubles read together (a
//   warp's loads cover 32 consecutive rows, contiguous bytes); the rows are
//   read-only for the kernel, so the loads go through L1, which serves a
//   row's other columns. Up to four columns are held in registers (NQ, a
//   template argument: 1, 2, 3 or chunks of 4); whole rounds of kRowsAhead
//   rows are loaded before any is added, one address add a load, and the
//   fewer rows left are added one at a time;
// - a warp adds its threads' sums by shuffles; after one barrier one warp a
//   column adds the warps' sums and writes red and coef from the totals it
//   holds (each such warp also adds column 0's sums, in the same order, for
//   inv), so a small count needs one block and one barrier;
// - above hopper_stencil.FINISH_ONE_BLOCK doubles (rows x n_red: one
//   block's time grows with the bytes it reads) the wrapper passes G > 1
//   (hopper_stencil.finish_groups): G blocks of kGroupThreads each add a
//   fixed contiguous range of rows in one round of loads, and the last block
//   to finish (an integer ticket, atomicInc with wrap-around, so the ticket
//   is zero again for the next launch) adds the G block sums in group order,
//   one warp a column;
// - every sum is in a fixed order over a fixed thread-to-row map, which
//   depends only on (n_blocks, n_red, G).
// The scratch (the ticket and G * n_red block sums) belongs to the
// wrapper's launcher (hopper_stencil.finish_launcher), zeroed once when a
// chunk binds K2; the kernel allocates nothing.
//
// finish_coef_columns_kernel is the design this one replaced; it stays as a
// yardstick that only chip_smoke.py times, and no wrapper launches it.

#include "sweep_common.cuh"

namespace {

constexpr int kGroupThreads = 256;  // threads of each of G > 1 blocks
constexpr int kOneThreads = 512;    // threads of the single block when G = 1 (1,024 spill)
constexpr int kRowsAhead = 4;       // rows a thread loads before adding them
constexpr int kColumnsThreads = 1024;

// Σ p[i * stride] over i < count, by one warp: lanes add i = lane, lane +
// 32, ... in order, then a shuffle tree; the total is in lane 0. GLOBAL
// reads through L2 (values other blocks of this launch wrote), else shared
// memory.
template <bool GLOBAL>
__device__ __forceinline__ double warp_total(const double* p, int count, long stride) {
  double v = 0.0;
  for (int i = threadIdx.x & 31; i < count; i += 32) {
    v += GLOBAL ? __ldcg(p + i * stride) : p[i * stride];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// red[q] = total and coef[q] = [inv, total * inv] with inv from column 0's
// total; every lane that writes a column computes inv from the same bits.
__device__ __forceinline__ void write_coef(double* red, float* coef, int q, double total,
                                           double total0) {
  const double inv = 1.0 / sqrt(fmax(total0, 1e-37));
  red[q] = total;
  coef[q] = (float)(q == 0 ? inv : total * inv);
}

// Adds rows [r0, r1) of the row-major (rows, n_red) array src column by
// column with all THREADS threads of the block and hands each column's
// total, with column 0's, to put(q, total, total0) in lane 0 of one warp a
// column. Columns are taken NQ at a time (all of them when n_red <= NQ).
// Thread t adds rows r0 + t + k * THREADS in row order, each row's columns
// read together (a warp's loads cover 32 whole rows, contiguous bytes;
// read-only, so through L1, which serves a row's other columns): whole
// rounds of kRowsAhead rows, all loaded before any is added, then the
// fewer than kRowsAhead rows left one at a time. In a last chunk of fewer than NQ
// columns the loads past n_red read column n_red - 1 again, and those
// sums are never handed on. Each warp adds its threads' sums by shuffles; after
// one barrier one warp a column adds the warps' sums (and column 0's, in
// the same order, so no second barrier hands it over). Every order is fixed.
// smem holds NQ * THREADS / 32 + 1 doubles. Every thread of the block must
// call it; it ends without a barrier.
template <int THREADS, int NQ, typename Put>
__device__ void sum_rows(const double* __restrict__ src, long r0, long r1, int n_red,
                         double* smem, Put put) {
  constexpr int kWarps = THREADS / 32;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  double* total0 = smem + NQ * kWarps;  // column 0's total, from the first chunk
  for (int q0 = 0; q0 < n_red; q0 += NQ) {
    if (q0 > 0) __syncthreads();  // the previous chunk has read smem
    const int nq = min(NQ, n_red - q0);
    double acc[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[q] = 0.0;
    const long step = (long)THREADS * n_red;  // from one of a thread's rows to its next
    const double* p = src + (r0 + t) * n_red + q0;
    long r = r0 + t;
    for (; r + (long)(kRowsAhead - 1) * THREADS < r1;
         r += (long)kRowsAhead * THREADS, p += kRowsAhead * step) {
      double v[kRowsAhead][NQ];
#pragma unroll
      for (int u = 0; u < kRowsAhead; ++u) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) v[u][q] = __ldg(p + u * step + min(q, nq - 1));
      }
#pragma unroll
      for (int u = 0; u < kRowsAhead; ++u) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) acc[q] += v[u][q];
      }
    }
    for (; r < r1; r += THREADS, p += step) {  // fewer than kRowsAhead rows left
#pragma unroll
      for (int q = 0; q < NQ; ++q) acc[q] += __ldg(p + min(q, nq - 1));
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[q] += __shfl_down_sync(0xffffffffu, acc[q], off);
      if (lane == 0) smem[q * kWarps + warp] = acc[q];
    }
    __syncthreads();
    for (int q = warp; q < nq; q += kWarps) {
      const double v = warp_total<false>(smem + q * kWarps, kWarps, 1);
      double v0 = *total0;
      if (q0 == 0) v0 = q == 0 ? v : warp_total<false>(smem, kWarps, 1);
      if (lane == 0) {
        if (q0 == 0 && q == 0) *total0 = v;
        put(q0 + q, v, v0);
      }
    }
  }
}

template <int THREADS, int NQ>
__global__ void __launch_bounds__(THREADS) finish_coef_kernel(
    const double* __restrict__ partials, int n_blocks, int n_red, double* __restrict__ red,
    float* __restrict__ coef, double* __restrict__ scratch) {
  constexpr int kWarps = THREADS / 32;
  __shared__ double smem[NQ * kWarps + 1];
  __shared__ bool last;
  const int groups = gridDim.x;
  if (groups == 1) {
    sum_rows<THREADS, NQ>(partials, 0, n_blocks, n_red, smem, [red, coef](int q, double v,
                                                                          double v0) {
      write_coef(red, coef, q, v, v0);
    });
    return;
  }
  double* sums = scratch + 1;  // scratch[0] holds the ticket
  const long per = ((long)n_blocks + groups - 1) / groups;
  const long r0 = min((long)n_blocks, (long)blockIdx.x * per);
  const long r1 = min((long)n_blocks, r0 + per);
  double* mine = sums + (long)blockIdx.x * n_red;
  sum_rows<THREADS, NQ>(partials, r0, r1, n_red, smem, [mine](int q, double v, double) {
    mine[q] = v;
    __threadfence();  // this block's sums reach L2 before its ticket
  });
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int* ticket = reinterpret_cast<unsigned int*>(scratch);
    last = atomicInc(ticket, (unsigned int)(groups - 1)) == (unsigned int)(groups - 1);
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  // the G group sums of each column, in group order, by one warp a column
  for (int q = threadIdx.x >> 5; q < n_red; q += kWarps) {
    const double v = warp_total<true>(sums + q, groups, n_red);
    const double v0 = q == 0 ? v : warp_total<true>(sums, groups, n_red);
    if ((threadIdx.x & 31) == 0) write_coef(red, coef, q, v, v0);
  }
}

template <int THREADS, int NQ, typename... Args>
void launch(int groups, cudaStream_t s, Args... args) {
  finish_coef_kernel<THREADS, NQ><<<groups, THREADS, 0, s>>>(args...);
}

// NQ from n_red: one, two or three columns, or chunks of four.
template <int THREADS, typename... Args>
void launch_finish_coef(int n_red, int groups, cudaStream_t s, Args... args) {
  switch (min(n_red, 4)) {
    case 1: return launch<THREADS, 1>(groups, s, args...);
    case 2: return launch<THREADS, 2>(groups, s, args...);
    case 3: return launch<THREADS, 3>(groups, s, args...);
    default: return launch<THREADS, 4>(groups, s, args...);
  }
}

__global__ void __launch_bounds__(kColumnsThreads) finish_coef_columns_kernel(
    const double* __restrict__ partials, int n_blocks, int n_red, double* __restrict__ red,
    float* __restrict__ coef) {
  __shared__ double warp_sums[kColumnsThreads / 32];
  for (int q = 0; q < n_red; ++q) {
    double v = 0.0;
    for (int b = threadIdx.x; b < n_blocks; b += kColumnsThreads) {
      v += partials[(ptrdiff_t)b * n_red + q];
    }
    v = block_sum<kColumnsThreads>(v, warp_sums);
    if (threadIdx.x == 0) red[q] = v;
  }
  if (threadIdx.x == 0) {
    const double inv = 1.0 / sqrt(fmax(red[0], 1e-37));
    coef[0] = (float)inv;
    for (int q = 1; q < n_red; ++q) coef[q] = (float)(red[q] * inv);
  }
}

__global__ void noop_kernel() {}

// Makes `device` current for one launch and restores the caller's device.
struct DeviceScope {
  int prev = -1;
  explicit DeviceScope(int device) {
    cudaGetDevice(&prev);
    if (prev != device) cudaSetDevice(device);
    else prev = -1;
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace

extern "C" {

// partials: (n_blocks, n_red) f64; red: (n_red) f64; coef: (n_red) f32;
// scratch: (1 + groups * n_red) f64 whose first 4 bytes (the ticket) are
// zero, and stay zero after the launch; groups: the blocks that share the
// rows (1: one block of kOneThreads, the scratch unread). Launches on `stream`
// of `device`. Returns cudaGetLastError() after the launch.
int wafer_finish_coef(const double* partials, int n_blocks, int n_red, double* red, float* coef,
                      double* scratch, int groups, int device, void* stream) {
  if (n_blocks < 1 || n_red < 1 || groups < 1 || groups > n_blocks) {
    return (int)cudaErrorInvalidValue;
  }
  DeviceScope scope(device);
  cudaStream_t s = (cudaStream_t)stream;
  if (groups == 1) {
    launch_finish_coef<kOneThreads>(n_red, 1, s, partials, n_blocks, n_red, red, coef, scratch);
  } else {
    launch_finish_coef<kGroupThreads>(n_red, groups, s, partials, n_blocks, n_red, red, coef,
                                      scratch);
  }
  return (int)cudaGetLastError();
}

// The replaced design on the same arguments (no scratch), for timing only.
int wafer_finish_coef_columns(const double* partials, int n_blocks, int n_red, double* red,
                              float* coef, int device, void* stream) {
  DeviceScope scope(device);
  finish_coef_columns_kernel<<<1, kColumnsThreads, 0, (cudaStream_t)stream>>>(
      partials, n_blocks, n_red, red, coef);
  return (int)cudaGetLastError();
}

// An empty kernel launched as K2 is: the floor every launch of this binding
// pays, for timing only.
int wafer_noop(int device, void* stream) {
  DeviceScope scope(device);
  noop_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
