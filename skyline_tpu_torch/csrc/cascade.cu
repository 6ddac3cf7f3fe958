// The device sorted dominance cascade's scan for Hopper (sm_90a): pass (a)
// of skyline_tpu_torch/ops/device_cascade.py — each block's live candidates
// against the survivors of the blocks before it, then the survivors
// appended — in ONE cooperative launch, with nothing read to the host.
//
// Replaces the body of the reference's lax.scan (skyline_tpu/ops/
// device_cascade.py _cascade_core, `body`): the mp pre-drop against the
// buffer prefix (strictly_dominated_bf16, ops/dominance.py), the buffer
// chunks' dominated_by_pallas (pallas_dominance.py) under lax.cond, then
// compact and dynamic_update_slice. The full square (b) and the band (c)
// read candidates only, so the port runs them before the scan, in one
// launch of dominance.cu's windowed K2; the scan takes their survivors as
// `alive`.
//
// The design:
// - One cooperative launch (cudaLaunchCooperativeKernel) whose grid comes
//   from the occupancy query, at most CTAS_PER_SM CTAs an SM, so every CTA
//   is resident; grid-wide barriers (cooperative_groups' grid.sync()) part
//   the phases. Every CTA walks the blocks in order, and every decision in
//   front of a barrier (a block's live flag, the buffer count) is read from
//   the same device memory after the same barrier, so all take one branch.
// - Phase 0, once: for every victim group (GROUP = 256 rows of one block)
//   the step-1 summary of dominance.cu over its live rows (hi_k, the largest
//   sum); barrier.
// - For each block b with a live row (`live[b]`; the reference's lax.cond):
//   * mp and a buffer: the bf16 pre-drop of the block's live rows against
//     buffer rows [0, min(count, 512)), work items (group, tile) over the
//     CTAs, the certified test of dominance.cu step 8 (predrop_tile);
//     barrier.
//   * a buffer: work items (group, buffer tile below ceil(count / TILE))
//     over the CTAs: the exact skip of step 2 on the group's and the tile's
//     summaries, then the tile in shared memory and the f32 compare of step
//     5 (compare_tile) for the victims the tile's summary does not rule out
//     alone. A kill sets the victim's bit in `flags` (atomicOr, one word a
//     32 rows); each item reads the bits first, so a row killed by another
//     item is not compared again; barrier.
//   * the append: CTA c takes group c of the block, counts the survivors of
//     the groups before it from the flags, ranks its own with ballots,
//     writes them at count + offset (rows of DP floats, +inf past the count)
//     in sort order, lowers the summaries of the tiles they land in with a
//     float atomic min (lo_k, the least sum; a NaN sum -inf, as in step 1)
//     and writes the block's verdicts to `out`; the last group's CTA writes
//     the new count; barrier.
//   The buffer only grows, so the appends keep its tile summaries up to
//   date: no prefix is summarised twice.
// - Memory one CTA writes and another reads in this launch (the flags, the
//   count, the buffer, its summaries, the group summaries) is read with
//   __ldcg, from L2 and not from the SM's own L1, which is not coherent
//   across SMs; grid.sync() orders the writes before the reads.
//
// What bounds it: the buffer pass's f32 compares over the needed pairs (x d)
// when the buffer is large; else the barriers (two a live block, three
// with mp; a few microseconds each on 132 SMs) and the alive rows' bytes.
//
// Semantics: a row is killed only by exact strict dominance by a buffer row
// (the pre-drop's certificate is a proof of it), so out = alive & ~(some
// survivor of an earlier block dominates it): the reference's pass (a), bit
// for bit, and the buffer holds the survivors in sort order, as the
// reference's does. Built without --use_fast_math, as dominance.cu.

#include <cooperative_groups.h>

#include "dominance_common.cuh"

namespace {

constexpr int GROUP = V * THREADS;  // victims a CTA holds (one group)
constexpr int PRE_ROWS = 512;       // the pre-drop's buffer prefix (ops.sfs._MP_PREFIX)
// at most this many resident CTAs an SM: the phases' work items are few,
// and a grid barrier costs more the more CTAs it waits for
constexpr int CTAS_PER_SM = 2;

// atomic min of a non-NaN float: the int order of floats with the sign bit
// clear and the reversed unsigned order of those with it set are the float
// order (-0.0 takes the second path, below every negative float there)
__device__ __forceinline__ void atomic_min_float(float* addr, float v) {
  if (__float_as_int(v) >= 0)
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMax(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
}

template <int D>
__device__ __forceinline__ void load_summary_cg(const float* ts, float (&s)[Geo<D>::SW]) {
#pragma unroll
  for (int q = 0; q < Geo<D>::SW / 4; ++q) {
    const float4 f = __ldcg(reinterpret_cast<const float4*>(ts) + q);
    s[4 * q] = f.x;
    s[4 * q + 1] = f.y;
    s[4 * q + 2] = f.z;
    s[4 * q + 3] = f.w;
  }
}

__device__ __forceinline__ bool killed(const unsigned* flags, int j) {
  return (__ldcg(flags + (j >> 5)) >> (j & 31)) & 1u;
}

__device__ __forceinline__ void mark_killed(unsigned* flags, int j) {
  atomicOr(flags + (j >> 5), 1u << (j & 31));
}

// cand (nb * block, D) row-major candidates (non-candidates all-NaN); alive
// (nb * block) uint8, the rows (b) and (c) left; live (nb) uint8, a block
// has an alive row; buf (nb * block, DP) +inf, tsum (ceil(nb * block /
// TILE), SW) +inf, gsum (nb * groups, SW) scratch, flags (ceil(nb * block /
// 32)) and count (1) zero; out (nb * block) uint8 zero. A row's flag bit is
// its own, so no word is reset between blocks.
template <int D, bool MP>
__global__ void __launch_bounds__(THREADS)
cascade_scan_kernel(const float* __restrict__ cand, const uint8_t* __restrict__ alive,
                    const uint8_t* __restrict__ live, float* buf, float* tsum, float* gsum,
                    unsigned* flags, int* count, uint8_t* __restrict__ out, int nb,
                    int block) {
  namespace cg = cooperative_groups;
  constexpr int DP = Geo<D>::DP, SW = Geo<D>::SW;
  constexpr int TILE_F4 = TILE * DP / 4;
  __shared__ float4 tile[TILE_F4];
  __shared__ int wcnt[V][WARPS];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int groups = (block + GROUP - 1) / GROUP;
  const unsigned below = (1u << lane) - 1u;

  // phase 0: each group's summary over its alive rows
  for (int gi = blockIdx.x; gi < nb * groups; gi += gridDim.x) {
    const int b = gi / groups;
    const int base = b * block + (gi % groups) * GROUP;
    const int end = min(base + GROUP, (b + 1) * block);
    float acc[D + 1];
#pragma unroll
    for (int k = 0; k <= D; ++k) acc[k] = -INFINITY;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int j = base + warp * 32 * V + v * 32 + lane;
      if (j < end && alive[j]) {
        float y[D];
        bool ok = true;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          y[k] = cand[(size_t)j * D + k];
          ok = ok & !isnan(y[k]);
        }
        if (ok) {
#pragma unroll
          for (int k = 0; k < D; ++k) acc[k] = fmaxf(acc[k], y[k]);
          const float s = row_sum<D>(y);
          acc[D] = fmaxf(acc[D], isnan(s) ? INFINITY : s);
        }
      }
    }
    write_summary<D, THREADS, false>(acc, gsum + (size_t)gi * SW);
    __syncthreads();  // the reduction's shared row is reused next group
  }
  grid.sync();

  int cnt = 0;
  for (int b = 0; b < nb; ++b) {
    if (!live[b]) continue;
    const int bbase = b * block;
    const int bend = bbase + block;
    if (cnt > 0) {
      if (MP) {
        // the bf16 pre-drop against the buffer's first rows
        const int pre = min(cnt, PRE_ROWS);
        const int ptiles = (pre + TILE - 1) / TILE;
        for (int it = blockIdx.x; it < groups * ptiles; it += gridDim.x) {
          const int t = it % ptiles;
          const int base = bbase + (it / ptiles) * GROUP;
          const int end = min(base + GROUP, bend);
          float yb[V][D + 1];
          bool need[V], found[V];
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int j = base + warp * 32 * V + v * 32 + lane;
            need[v] = j < end && alive[j] && !killed(flags, j);
#pragma unroll
            for (int k = 0; k < D; ++k) {
              yb[v][k] = need[v] ? bf16r(cand[(size_t)j * D + k]) : 0.0f;
              need[v] = need[v] & isfinite(yb[v][k]);
            }
            yb[v][D] = row_sum<D>(yb[v]);
            found[v] = false;
          }
          if (!__syncthreads_or(need[0] | need[1])) continue;
          // the tile rounded to bf16; a row at or past `pre`, or not finite
          // after rounding, cannot certify: a NaN first coordinate
          float* rows = reinterpret_cast<float*>(tile);
          for (int r = tid; r < TILE; r += THREADS) {
            const int i = t * TILE + r;
            float x[DP];
#pragma unroll
            for (int k = 0; k < DP; ++k) x[k] = 0.0f;
            bool ok = i < pre;
            if (ok) {
#pragma unroll
              for (int k = 0; k < D; ++k) {
                x[k] = bf16r(__ldcg(buf + (size_t)i * DP + k));
                ok = ok & isfinite(x[k]);
              }
            }
            if (!ok) x[0] = __int_as_float(0x7fc00000);
#pragma unroll
            for (int k = 0; k < DP; ++k) rows[r * DP + k] = x[k];
          }
          __syncthreads();
          if (__any_sync(FULL, need[0] | need[1])) predrop_tile<D>(tile, yb, need, found);
#pragma unroll
          for (int v = 0; v < V; ++v)
            if (found[v]) mark_killed(flags, base + warp * 32 * V + v * 32 + lane);
          __syncthreads();  // before the tile is refilled
        }
        grid.sync();
      }
      // the buffer pass: rows [0, cnt), +inf past it
      const int ntiles = (cnt + TILE - 1) / TILE;
      for (int it = blockIdx.x; it < groups * ntiles; it += gridDim.x) {
        const int g = it / ntiles;
        const int t = it % ntiles;
        float hi[SW], lo[SW];
        load_summary_cg<D>(gsum + ((size_t)b * groups + g) * SW, hi);
        load_summary_cg<D>(tsum + (size_t)t * SW, lo);
        if (skip_tile<D>(lo, hi)) continue;  // the same for every thread
        const int base = bbase + g * GROUP;
        const int end = min(base + GROUP, bend);
        float yv[V][D + 1];
        bool open[V], dom[V], need[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int j = base + warp * 32 * V + v * 32 + lane;
          open[v] = j < end && alive[j] && !killed(flags, j);
#pragma unroll
          for (int k = 0; k < D; ++k) yv[v][k] = open[v] ? cand[(size_t)j * D + k] : 0.0f;
          const float s = row_sum<D>(yv[v]);
          yv[v][D] = isnan(s) ? INFINITY : s;
          dom[v] = false;
          need[v] = open[v] & !skip_tile<D>(lo, yv[v]);
        }
        if (!__syncthreads_or(need[0] | need[1])) continue;
        const float4* src = reinterpret_cast<const float4*>(buf + (size_t)t * TILE * DP);
        for (int c = tid; c < TILE_F4; c += THREADS) tile[c] = __ldcg(src + c);
        __syncthreads();
        bool pending = open[0] | open[1];
        if (__any_sync(FULL, need[0] | need[1])) compare_tile<D>(tile, yv, open, dom, pending);
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (dom[v]) mark_killed(flags, base + warp * 32 * V + v * 32 + lane);
        __syncthreads();  // before the tile is refilled
      }
      grid.sync();
    }
    // the append, stable: group g's survivors after those of groups < g
    for (int g = blockIdx.x; g < groups; g += gridDim.x) {
      const int base = bbase + g * GROUP;
      const int end = min(base + GROUP, bend);
      int before = 0;
      for (int s0 = bbase; s0 < base; s0 += THREADS) {
        const int j = s0 + tid;
        before += __syncthreads_count(j < base && alive[j] && !killed(flags, j));
      }
      bool keep[V];
      unsigned m[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int j = base + v * THREADS + tid;
        keep[v] = j < end && alive[j] && !killed(flags, j);
        m[v] = __ballot_sync(FULL, keep[v]);
        if (lane == 0) wcnt[v][warp] = __popc(m[v]);
      }
      __syncthreads();
      int total = 0;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        int off = total;
        for (int w = 0; w < WARPS; ++w) {
          off += w < warp ? wcnt[v][w] : 0;
          total += wcnt[v][w];
        }
        const int j = base + v * THREADS + tid;
        if (j < end) out[j] = keep[v] ? 1 : 0;
        if (keep[v]) {
          const int dst = cnt + before + off + __popc(m[v] & below);
          float y[D];
#pragma unroll
          for (int k = 0; k < D; ++k) y[k] = cand[(size_t)j * D + k];
          float* row = buf + (size_t)dst * DP;
          float* ts = tsum + (size_t)(dst / TILE) * SW;
#pragma unroll
          for (int k = 0; k < D; ++k) {
            row[k] = y[k];
            atomic_min_float(ts + k, y[k]);
          }
          const float s = row_sum<D>(y);
          atomic_min_float(ts + D, isnan(s) ? -INFINITY : s);
        }
      }
      if (g == groups - 1 && tid == 0) *count = cnt + before + total;
      __syncthreads();  // wcnt is rewritten by the next group
    }
    grid.sync();
    cnt = __ldcg(count);
  }
}

template <int D, bool MP>
cudaError_t launch_scan(const float* cand, const uint8_t* alive, const uint8_t* live,
                        float* buf, float* tsum, float* gsum, unsigned* flags, int* count,
                        uint8_t* out, int nb, int block, cudaStream_t stream) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // the shared memory is all static: the query sees what the kernel uses
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cascade_scan_kernel<D, MP>,
                                                      THREADS, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const dim3 grid(sms * min(per_sm, CTAS_PER_SM));
  void* args[] = {(void*)&cand, (void*)&alive, (void*)&live, (void*)&buf, (void*)&tsum,
                  (void*)&gsum, (void*)&flags, (void*)&count, (void*)&out, (void*)&nb,
                  (void*)&block};
  err = cudaLaunchCooperativeKernel((const void*)cascade_scan_kernel<D, MP>, grid,
                                    dim3(THREADS), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// One scan over nb blocks of `block` rows (every buffer as the kernel's
// comment lists them, contiguous on the current device). mp: the bf16
// pre-drop before each buffer pass. Launches on ``stream`` without
// synchronising; returns the launch's error (a cooperative launch the card
// refuses included), else cudaGetLastError().
extern "C" int skyline_cascade_scan(const float* cand, const uint8_t* alive,
                                    const uint8_t* live, float* buf, float* tsum,
                                    float* gsum, unsigned* flags, int* count, uint8_t* out,
                                    int d, int nb, int block, int mp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define SKYLINE_CASE(D)                                                                  \
  case D:                                                                                \
    return (int)(mp ? launch_scan<D, true>(cand, alive, live, buf, tsum, gsum, flags,  \
                                           count, out, nb, block, s)                   \
                    : launch_scan<D, false>(cand, alive, live, buf, tsum, gsum, flags, \
                                            count, out, nb, block, s));
    SKYLINE_CASE(1)
    SKYLINE_CASE(2)
    SKYLINE_CASE(3)
    SKYLINE_CASE(4)
    SKYLINE_CASE(5)
    SKYLINE_CASE(6)
    SKYLINE_CASE(7)
    SKYLINE_CASE(8)
    SKYLINE_CASE(9)
    SKYLINE_CASE(10)
    SKYLINE_CASE(11)
    SKYLINE_CASE(12)
    SKYLINE_CASE(13)
    SKYLINE_CASE(14)
    SKYLINE_CASE(15)
    SKYLINE_CASE(16)
#undef SKYLINE_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* skyline_cascade_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
