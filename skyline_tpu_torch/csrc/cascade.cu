// The device sorted dominance cascade's two kernels for Hopper (sm_90a),
// the passes of skyline_tpu_torch/ops/device_cascade.py that compare rows:
//
// - the window pass (skyline_cascade_windows): every block's candidates
//   against the candidates of their window, rows [b * block, band_end[b] *
//   block) — the block itself (the full square) and its band — for all
//   blocks at once. Replaces the reference's self pass, dominated_by_any_
//   pallas (skyline_tpu/ops/pallas_dominance.py), and the band's
//   dominated_by_pallas under lax.cond (skyline_tpu/ops/device_cascade.py
//   _cascade_core, `body`), which the reference runs per block inside its
//   lax.scan: both read candidates only, so the port runs them before the
//   scan.
// - the scan (skyline_cascade_scan): pass (a), each block's live rows, in
//   order, against the survivors of the blocks before it, the survivors
//   appended to a grow-only buffer; with mp the bf16 pre-drop against the
//   buffer's first rows first. Replaces the rest of the reference's scan
//   body: strictly_dominated_bf16 (ops/dominance.py) and the buffer chunks'
//   dominated_by_pallas under lax.cond, then compact and
//   dynamic_update_slice.
//
// Neither reads anything to the host, and each entry is a fixed number of
// launches whatever the block count. The compare, skip and pre-drop device
// code is dominance.cu's (dominance_common.cuh; the step numbers below are
// dominance.cu's header).
//
// What bounds them. Both do little arithmetic for the bytes they move, and
// neither is bound by either. Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py's timings, one window of path (l): 7 flush calls of up to
// 524,288 rows, d = 8, mp):
// - The scan needs ~4 * 10^4 pairs a call and ~0.0005 ms of bytes, and is
//   sequential over the ~34 live blocks of a call: block b's rows meet the
//   survivors of every block before it, so each live block is a phase of
//   its own with a barrier on either side of its append. Its earlier form,
//   one cooperative grid of 264 CTAs, paid two or three grid-wide barriers a
//   live block (716 an (l) window), each waiting for every CTA of the card,
//   and kept the kill flags in global memory: 0.78 ms a call. This one
//   takes 0.26: what is left a live block (~7 us) is a chain of dependent
//   steps — the tile walk, reads from L2 and across the cluster, the two
//   cluster barriers — not arithmetic or bytes.
// - The window pass needs ~4 * 10^7 pairs a call (0.0048 ms at the FP32
//   peak). On a north-star union nearly every candidate slot is an all-NaN
//   duplicate, so a grid of one CTA a victim group mostly loaded its
//   victims and left; on the flush's blocks 42% of the groups hold a
//   candidate, and there the compare loop (step 5, shared with K1-K3) is
//   two thirds of the pass's 0.15 ms a call: it runs at the instruction
//   rate of that loop, as the windowed K2 it replaced did.
//
// The design.
//
// The scan runs on ONE thread-block cluster (cudaLaunchKernelEx with a
// cluster dimension, a grid of exactly one cluster of SCAN_CTAS = 8 CTAs,
// the portable size; cudaOccupancyMaxActiveClusters is asked first and the
// launch refused when it is 0). Its phases are parted
// by the cluster's hardware barrier (barrier.cluster arrive.release /
// wait.acquire, cg::this_cluster().sync()), not by grid barriers:
// - Before it, on the same stream, a plain kernel over every victim group
//   (GROUP = 256 rows of one block) writes the group's summary over its
//   alive rows (step 1's hi_k and largest sum) and whether it has an alive
//   row, sets every buffer tile summary to +inf and zeroes the output.
// - A group is owned by CTA g % C, which keeps the group's keep bits (alive
//   and not yet killed, one word a 32 rows) in its shared memory for the
//   whole block; no kill flag lives in global memory. With the default
//   block of 2,048 rows (8 groups) a CTA owns one group; with fewer groups
//   than CTAs (blocks of 1,024: 4 groups) two CTAs share a group and split
//   the buffer's tiles between them, and the helper's kills reach the
//   owner's words by atomicAnd through distributed shared memory
//   (cluster.map_shared_rank). Larger blocks go round-robin over the
//   cluster.
// - Per live block (the live blocks are a bitmask in shared memory, built
//   once from the group flags): phase A, each CTA's groups against the
//   buffer. With mp first the bf16 pre-drop against the buffer's first
//   PRE_ROWS rows (predrop_tile, step 8): each CTA keeps those rows rounded
//   in its shared memory with each tile's summary, filled as the buffer
//   grows, so once the buffer holds PRE_ROWS rows the pre-drop reads
//   nothing, and a victim meets a prefix tile only where step 8's rules
//   (a') and (b') do not rule it out. Then the buffer's tiles with the exact
//   skip (skip_tile, step 2) on the group's and the tile's summaries, the
//   tiles that survive it compacted in order and streamed through a ring of
//   STAGES shared-memory tiles by cp.async (step 4), each tile's summary
//   copied beside it, each compared by compare_tile (step 5) for the
//   victims the tile's summary does not rule out alone. The pre-drop's kill
//   is a proof of strict dominance, so the two share the phase and the mask
//   is unchanged. A cluster barrier: every kill is in its owner's words.
//   Then the append: every CTA reads every group's keep words through
//   distributed shared memory and counts them, so each knows the survivors
//   of the groups before its own and the block's total without another
//   barrier; each owner writes its survivors in sort order at count +
//   offset (rows of DP floats, read from the staged copy), lowers the
//   summaries of the tiles they land in with a float atomic min (lo_k, the
//   least sum; a row with a NaN coordinate, which cannot dominate, stays
//   out), writes the block's verdicts, sets up the keep words of the next
//   live block from alive flags read when this block began (the second of
//   two sets, so no reader of this block's words is overtaken) and, once
//   every thread of the CTA has read its staged victims (a CTA barrier),
//   starts copying that block's first group of victims and the group's
//   summary into shared memory with cp.async (the candidates never depend on
//   the buffer). A cluster barrier: the buffer rows and summaries are in
//   place.
//   Two cluster barriers a live block (one for the first: there is no
//   buffer to compare against yet), and one at the start.
// - The buffer's rows and tile summaries are written in this launch by
//   other SMs, so they are read from L2, never from the SM's own L1, which
//   is not coherent across SMs: summaries with __ldcg, the pre-drop's rows
//   with __ldcg, the tiles by cp.async.cg. The appends are ordered before
//   those reads by the cluster barrier's release and acquire at cluster
//   scope; the summaries' atomics are performed at L2. The buffer is not
//   filled: the rows of the last tile at or past the count get a NaN first
//   coordinate in shared memory once the tile has landed (NaN <= y is
//   false), so they never dominate.
// - Barriers: 1 + 2 a live block after the first, each a hardware barrier
//   of C CTAs on one GPC, in place of 1 + 2 (3 with mp) grid barriers of 264
//   CTAs. The work is the same pairs; the append's bytes are the
//   survivors'. What is left a live block is a chain of dependent reads
//   (the victims and the summaries from L2, the keep words across the
//   cluster), the tile walk and the two barriers.
// - Each kernel is set up once a device (fitted_for): its dynamic shared
//   memory allowed up to the most a block may ask for, and the occupancy
//   asked at that size, so the answer holds for every smaller launch (the
//   scan's shared memory grows with the block count) and a launch spends no
//   host time on it.
//
// The window pass is two launches:
// - A summary kernel: per tile of TILE candidate rows the exact skip's lo_k
//   and least sum over the rows without a NaN coordinate (the all-NaN
//   non-candidates stay out, so a tile of them is skipped whole by rule (c));
//   per victim group hi_k and the largest sum; the output zeroed. Each group
//   with a candidate appends its work items to a device worklist (one
//   atomicAdd for its items): its window's tiles cut into at most PIECES
//   pieces of one length, at least PIECE_TILES tiles unless the window is
//   shorter (the last piece may be shorter). Groups without a candidate
//   add nothing.
// - A persistent compare kernel, as many CTAs as fit on the card at once
//   (the occupancy query), that pull items from an
//   atomic counter until the worklist is done, so no grid size is read to
//   the host (a grid of two CTAs an SM, eight warps, compared ~10% slower
//   on the flush's blocks). An item: the group's victims in registers, the piece's tiles
//   that survive the skip compacted and streamed through the ring as in the
//   scan, straight from the row-major candidates (no transposed or padded
//   copy); a tile that crosses the window's edge gets a NaN first coordinate
//   on the rows outside it once it has landed — with a block that is a
//   multiple of TILE, as every card size is, only the tests' small blocks
//   have such tiles. A kill is a store of 1 to the victim's output byte:
//   the items of one group OR their kills there, and a store of a constant
//   needs no atomic (the zero was written by the summary kernel, an earlier
//   launch). An item first reads its victims' bytes, so a victim another
//   item has killed is not compared again.
//
// Semantics: a row is killed only by exact strict dominance by a candidate
// of its window (window pass) or by a survivor of an earlier block (the
// scan; the pre-drop's certificate is a proof of it), so the window pass's
// output is dominated_by over each window and the scan's is alive & ~(some
// survivor of an earlier block dominates it): the reference's passes bit
// for bit, the buffer holding the survivors in sort order as the
// reference's does. Built without --use_fast_math, as dominance.cu.

#include <cooperative_groups.h>

#include <mutex>
#include <vector>

#include "dominance_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int GROUP = V * THREADS;  // victims a CTA holds (one group)
constexpr int WORDS = GROUP / 32;   // keep words of a group
constexpr int PRE_ROWS = 512;       // the pre-drop's buffer prefix (ops.sfs._MP_PREFIX)
constexpr int PIECES = 8;           // most pieces a window is cut into
constexpr int PIECE_TILES = 4;      // fewest tiles a piece but the last, unless the window is shorter
constexpr int SCAN_CTAS = 8;        // the scan's cluster (the portable size)

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

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// One victim of this thread, row j of the (N, D) row-major rows (or of
// `src`, the same row elsewhere): its coordinates, then its sum (NaN +inf,
// as for groups); open when it may be dominated at all (no NaN coordinate).
template <int D>
__device__ __forceinline__ bool load_victim(const float* src, float (&y)[D + 1]) {
  bool ok = true;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    y[k] = src[k];
    ok = ok & !isnan(y[k]);
  }
  const float s = row_sum<D>(y);
  y[D] = isnan(s) ? INFINITY : s;
  return ok;
}

// Steps 3-6 over the tiles t = t0, t0 + step, ... below t1: each tile whose
// summary (tsum, read from L2) the set summarised by hi does not rule out,
// in order, streamed through the ring (`load(dst, t)` issues the tile's
// cp.async copies; its summary rides along into `lo_ring`, STAGES summaries
// of SW floats; `edge(rows, t)` patches rows that must not dominate once
// the tile has landed and says whether it did, the same for every thread)
// and compared against this thread's victims. Returns with every thread's
// copies drained.
template <int D, class Load, class Edge>
__device__ __forceinline__ void walk_tiles(const float* tsum, const float (&hi)[Geo<D>::SW],
                                           int t0, int t1, int step, float4* ring,
                                           float4* lo_ring, int* list, int* warp_cnt, Load load,
                                           Edge edge, const float (&yv)[V][D + 1],
                                           const bool (&open)[V], bool (&dom)[V]) {
  constexpr int SW = Geo<D>::SW;
  constexpr int TILE_F4 = TILE * Geo<D>::DP / 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  bool pending = false;
#pragma unroll
  for (int v = 0; v < V; ++v) pending = pending | (open[v] & !dom[v]);
  bool busy = __syncthreads_or(pending);
  for (int c0 = t0; busy && c0 < t1; c0 += CHUNK * step) {
    const int cend = min(t1, c0 + CHUNK * step);
    // step 3: the surviving tiles of this chunk, in order
    int kept = 0;
    for (int i0 = c0; i0 < cend; i0 += THREADS * step) {
      const int t = i0 + tid * step;
      bool keep = false;
      if (t < cend) {
        float lo[SW];
        load_summary_cg<D>(tsum + (size_t)t * SW, lo);
        keep = !skip_tile<D>(lo, hi);
      }
      const unsigned m = __ballot_sync(FULL, keep);
      if (lane == 0) warp_cnt[warp] = __popc(m);
      __syncthreads();
      int off = kept, total = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const int cw = warp_cnt[w];
        off += w < warp ? cw : 0;
        total += cw;
      }
      if (keep) list[off + __popc(m & ((1u << lane) - 1u))] = t;
      kept += total;
      __syncthreads();  // warp_cnt is rewritten next round; list is complete
    }
    // step 4: walk them through the ring, STAGES - 1 tiles ahead, each
    // tile's summary copied with it
    auto fetch = [&](int stage, int t) {
      load(ring + stage * TILE_F4, t);
      if (tid < SW / 4)
        cp_async16(lo_ring + stage * (SW / 4) + tid,
                   reinterpret_cast<const float4*>(tsum + (size_t)t * SW) + tid);
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < kept) fetch(s, list[s]);
      cp_async_commit();
    }
    for (int it = 0; it < kept; ++it) {
      const int nxt = it + STAGES - 1;
      if (nxt < kept) fetch(nxt % STAGES, list[nxt]);
      cp_async_commit();
      cp_async_wait<STAGES - 1>();  // tile `it` has landed (this thread's part)
      __syncthreads();              // ... and every thread's
      float4* cur = ring + (it % STAGES) * TILE_F4;
      if (edge(reinterpret_cast<float*>(cur), list[it])) __syncthreads();
      float lo[SW];
      load_summary<D>(reinterpret_cast<const float*>(lo_ring + (it % STAGES) * (SW / 4)), lo);
      bool need = false;
#pragma unroll
      for (int v = 0; v < V; ++v) need = need | (open[v] & !dom[v] & !skip_tile<D>(lo, yv[v]));
      if (__any_sync(FULL, need)) compare_tile<D>(cur, yv, open, dom, pending);
      // also the barrier before stage (it % STAGES) is refilled
      if (!__syncthreads_or(pending)) break;
    }
    cp_async_wait<0>();
    busy = __syncthreads_or(pending);  // before the next chunk reuses the ring
  }
}

// Rows [tb, tb + TILE) of the (n, D) row-major rows into a tile of DP-float
// rows (rows at or past n are not read: the caller's edge patch covers
// them). vec: 16-byte copies (D a multiple of 4, 16-byte aligned rows).
template <int D>
__device__ __forceinline__ void load_rows(float4* dst, const float* rows, int tb, int n,
                                          bool vec) {
  constexpr int DP = Geo<D>::DP;
  const int m = min(TILE, n - tb);
  if (DP == D && vec) {
    const float4* src = reinterpret_cast<const float4*>(rows + (size_t)tb * D);
    for (int c = threadIdx.x; c < m * (D / 4); c += THREADS) cp_async16(dst + c, src + c);
  } else {
    float* out = reinterpret_cast<float*>(dst);
    const float* src = rows + (size_t)tb * D;
    for (int e = threadIdx.x; e < m * D; e += THREADS)
      cp_async4(out + (e / D) * DP + e % D, src + e);
  }
}

// Rows of a landed tile at tb whose index lies outside [rb, re) get a NaN
// first coordinate; true (for every thread) when the tile crosses an edge.
template <int D>
__device__ __forceinline__ bool mask_outside(float* rows, int tb, int rb, int re) {
  if (tb >= rb && tb + TILE <= re) return false;
  for (int r = threadIdx.x; r < TILE; r += THREADS)
    if (tb + r < rb || tb + r >= re) rows[r * Geo<D>::DP] = __int_as_float(0x7fc00000);
  return true;
}

// Each (device, kernel) is set up once: the kernel's dynamic shared memory
// allowed up to `cap`, the most a block may ask for beside its static shared
// memory, and `ask(dev, cap, &value)` answered (an occupancy, which then
// holds for every launch that asks for `cap` or less); both kept, so a
// launch spends no host time on them again.
struct Fitted {
  int dev;
  const void* fn;
  size_t cap;
  int value;
};
std::mutex fitted_mu;
std::vector<Fitted> fitted;

template <class Ask>
cudaError_t fitted_for(const void* fn, Ask ask, size_t* cap, int* value) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(fitted_mu);
  for (const Fitted& f : fitted)
    if (f.dev == dev && f.fn == fn) {
      *cap = f.cap;
      *value = f.value;
      return cudaSuccess;
    }
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  const size_t c = (size_t)optin - attr.sharedSizeBytes;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c);
  if (err != cudaSuccess) return err;
  int v = 0;
  err = ask(dev, c, &v);
  if (err != cudaSuccess) return err;
  fitted.push_back({dev, fn, c, v});
  *cap = c;
  *value = v;
  return cudaSuccess;
}

// CTAs of `fn` (THREADS threads, `smem` bytes of dynamic shared memory, the
// same for every launch of `fn`) that fit on the current card at once: the
// persistent grid.
cudaError_t resident_ctas(const void* fn, size_t smem, int* ctas) {
  size_t cap = 0;
  cudaError_t err = fitted_for(
      fn,
      [&](int dev, size_t, int* v) {
        int sms = 0, per_sm = 0;
        cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess) return e;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, smem);
        if (e != cudaSuccess) return e;
        *v = sms * per_sm;
        return cudaSuccess;
      },
      &cap, ctas);
  if (err != cudaSuccess) return err;
  return smem <= cap && *ctas > 0 ? cudaSuccess : cudaErrorLaunchOutOfResources;
}

// -- the window pass ----------------------------------------------------------

// grid ntiles + nb * gpb, TILE threads. Blocks below ntiles summarise a
// candidate tile (lo: minima and the least sum over the rows without a NaN
// coordinate, a NaN sum -inf) and zero its rows' output; the rest summarise
// a victim group (hi: maxima and the largest sum over its rows without a NaN
// coordinate, a NaN sum +inf) and, when it has such a row, append its items
// (group, first tile, end tile) for the tiles of its block's window.
template <int D>
__global__ void __launch_bounds__(TILE)
window_summary_kernel(const float* __restrict__ cand, const int* __restrict__ band_end,
                      float* __restrict__ tsum, float* __restrict__ gsum, int4* __restrict__ items,
                      int* __restrict__ counters, uint8_t* __restrict__ out, int n, int block,
                      int gpb, int ntiles) {
  constexpr int SW = Geo<D>::SW;
  const int tid = threadIdx.x;
  float acc[D + 1];
  float y[D + 1];
  if ((int)blockIdx.x < ntiles) {
    const int i = blockIdx.x * TILE + tid;
#pragma unroll
    for (int k = 0; k <= D; ++k) acc[k] = INFINITY;
    if (i < n) {
      out[i] = 0;
      if (load_victim<D>(cand + (size_t)i * D, y)) {
#pragma unroll
        for (int k = 0; k < D; ++k) acc[k] = y[k];
        const float s = row_sum<D>(y);
        acc[D] = isnan(s) ? -INFINITY : s;  // may still dominate: never skip
      }
    }
    write_summary<D, TILE, true>(acc, tsum + (size_t)blockIdx.x * SW);
    return;
  }
  const int gi = blockIdx.x - ntiles;
  const int b = gi / gpb;
  const int base = b * block + (gi % gpb) * GROUP;
  const int end = min(base + GROUP, (b + 1) * block);
#pragma unroll
  for (int k = 0; k <= D; ++k) acc[k] = -INFINITY;
  bool any = false;
  const int j = base + tid;
  if (j < end && load_victim<D>(cand + (size_t)j * D, y)) {
    any = true;
#pragma unroll
    for (int k = 0; k <= D; ++k) acc[k] = y[k];
  }
  write_summary<D, TILE, false>(acc, gsum + (size_t)gi * SW);
  if (__syncthreads_or(any) && tid == 0) {
    const int t_lo = b * block / TILE;
    const int e = min(band_end[b] * block, n);
    const int span = (e + TILE - 1) / TILE - t_lo;
    if (span > 0) {
      const int cut = max(1, min(PIECES, span / PIECE_TILES));
      const int len = (span + cut - 1) / cut;
      const int pieces = (span + len - 1) / len;
      const int at = atomicAdd(counters, pieces);
      for (int p = 0; p < pieces; ++p)
        items[at + p] = make_int4(gi, t_lo + p * len, t_lo + min(span, (p + 1) * len), 0);
    }
  }
}

// Persistent: THREADS threads; each CTA pulls items from counters[1] until
// counters[0] (the summary kernel's count) is reached. Victims map to
// threads as in dominance.cu's dominated_kernel: warp w holds rows base + w
// * 64 + v * 32 + lane.
template <int D>
__global__ void __launch_bounds__(THREADS)
window_kernel(const float* __restrict__ cand, const int* __restrict__ band_end,
              const float* __restrict__ tsum, const float* __restrict__ gsum,
              const int4* __restrict__ items, int* __restrict__ counters,
              uint8_t* __restrict__ out, int n, int block, int gpb, bool vec) {
  constexpr int SW = Geo<D>::SW;
  constexpr int TILE_F4 = TILE * Geo<D>::DP / 4;
  extern __shared__ float4 smem[];
  float4* ring = smem;
  float4* lo_ring = ring + STAGES * TILE_F4;
  int* list = reinterpret_cast<int*>(lo_ring + STAGES * SW / 4);
  __shared__ int warp_cnt[WARPS];
  __shared__ int item;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int total = counters[0];
  for (;;) {
    if (tid == 0) item = atomicAdd(counters + 1, 1);
    __syncthreads();
    const int4 it = item < total ? items[item] : make_int4(-1, 0, 0, 0);
    __syncthreads();  // item is rewritten next round
    if (it.x < 0) break;
    const int gi = it.x;
    const int b = gi / gpb;
    const int base = b * block + (gi % gpb) * GROUP;
    const int end = min(base + GROUP, (b + 1) * block);
    const int rb = b * block, re = min(band_end[b] * block, n);
    float yv[V][D + 1];
    bool open[V], dom[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int j = base + warp * 32 * V + v * 32 + lane;
      open[v] = j < end && !__ldcg(out + j) && load_victim<D>(cand + (size_t)j * D, yv[v]);
      if (!open[v]) {
#pragma unroll
        for (int k = 0; k <= D; ++k) yv[v][k] = 0.0f;
      }
      dom[v] = false;
    }
    float hi[SW];
    load_summary<D>(gsum + (size_t)gi * SW, hi);
    walk_tiles<D>(
        tsum, hi, it.y, it.z, 1, ring, lo_ring, list, warp_cnt,
        [&](float4* dst, int t) { load_rows<D>(dst, cand, t * TILE, n, vec); },
        [&](float* rows, int t) { return mask_outside<D>(rows, t * TILE, rb, re); }, yv, open,
        dom);
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (open[v] & dom[v]) out[base + warp * 32 * V + v * 32 + lane] = 1;
  }
}

template <int D>
cudaError_t launch_windows(const float* cand, const int* band_end, uint8_t* out, float* tsum,
                           float* gsum, int4* items, int* counters, int n, int block,
                           cudaStream_t stream) {
  const int ntiles = (n + TILE - 1) / TILE;
  const int gpb = (block + GROUP - 1) / GROUP;
  const int nb = n / block;
  window_summary_kernel<D><<<ntiles + nb * gpb, TILE, 0, stream>>>(
      cand, band_end, tsum, gsum, items, counters, out, n, block, gpb, ntiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem =
      (size_t)STAGES * (TILE * Geo<D>::DP + Geo<D>::SW) * sizeof(float) + CHUNK * sizeof(int);
  int ctas = 0;
  err = resident_ctas((const void*)window_kernel<D>, smem, &ctas);
  if (err != cudaSuccess) return err;
  const bool vec = D % 4 == 0 && (reinterpret_cast<uintptr_t>(cand) & 15) == 0;
  window_kernel<D><<<ctas, THREADS, smem, stream>>>(cand, band_end, tsum, gsum, items,
                                                     counters, out, n, block, gpb, vec);
  return cudaGetLastError();
}

// -- the scan -----------------------------------------------------------------

// grid nb * groups, THREADS threads: group gi (rows of block gi / groups)
// summarised over its alive rows without a NaN coordinate (step 1's hi),
// glive[gi] = it has an alive row, its rows' output zeroed; blocks below
// ntiles also set buffer tile gi's summary to +inf.
template <int D>
__global__ void __launch_bounds__(THREADS)
scan_summary_kernel(const float* __restrict__ cand, const uint8_t* __restrict__ alive,
                    float* __restrict__ gsum, uint8_t* __restrict__ glive,
                    float* __restrict__ tsum, uint8_t* __restrict__ out, int block, int groups,
                    int ntiles) {
  constexpr int SW = Geo<D>::SW;
  const int gi = blockIdx.x, tid = threadIdx.x;
  const int b = gi / groups;
  const int base = b * block + (gi % groups) * GROUP;
  const int end = min(base + GROUP, (b + 1) * block);
  float acc[D + 1];
#pragma unroll
  for (int k = 0; k <= D; ++k) acc[k] = -INFINITY;
  bool any = false;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int j = base + v * THREADS + tid;
    if (j >= end) continue;
    out[j] = 0;
    if (!alive[j]) continue;
    any = true;
    float y[D + 1];
    if (load_victim<D>(cand + (size_t)j * D, y)) {
#pragma unroll
      for (int k = 0; k <= D; ++k) acc[k] = fmaxf(acc[k], y[k]);
    }
  }
  write_summary<D, THREADS, false>(acc, gsum + (size_t)gi * SW);
  any = __syncthreads_or(any);
  if (tid == 0) glive[gi] = any ? 1 : 0;
  if (gi < ntiles && tid < SW) tsum[(size_t)gi * SW + tid] = INFINITY;
}

__device__ __forceinline__ int next_live(const unsigned* lbits, int nb, int b) {
  if (b >= nb) return nb;
  const int nbw = (nb + 31) >> 5;
  int w = b >> 5;
  unsigned m = lbits[w] & (FULL << (b & 31));
  while (!m && ++w < nbw) m = lbits[w];
  return m ? w * 32 + __ffs(m) - 1 : nb;
}

// The scan's shared memory: the ring and its tiles' summaries, with mp the
// pre-drop's rounded buffer prefix (PRE_ROWS rows of DP floats) and its
// tiles' summaries, the staged victims (GROUP rows of D floats) and their
// group's summary (SW floats), the tile list, the block's survivors per
// group, the live-block bits and two sets of keep words (gpc groups of
// WORDS words each).
template <int D, bool MP>
size_t scan_smem(int nb, int groups) {
  constexpr int DP = Geo<D>::DP, SW = Geo<D>::SW;
  const int gpc = (groups + SCAN_CTAS - 1) / SCAN_CTAS;
  return ((size_t)STAGES * (TILE * DP + SW) +
          (MP ? PRE_ROWS * DP + PRE_ROWS / TILE * SW : 0) + GROUP * D + SW) * sizeof(float) +
         (size_t)(CHUNK + groups + (nb + 31) / 32 + 2 * gpc * WORDS) * sizeof(int);
}

// One cluster of C = SCAN_CTAS CTAs. cand (nb * block, D) row-major
// candidates (non-candidates all-NaN); alive (nb * block) uint8, the rows the
// window pass left; glive, gsum from scan_summary_kernel; buf (whole tiles,
// DP floats a row) and tsum (+inf) the buffer and its tile summaries; out
// (zero) the verdicts.
template <int D, bool MP>
__global__ void __launch_bounds__(THREADS)
cascade_scan_kernel(const float* __restrict__ cand, const uint8_t* __restrict__ alive,
                    const uint8_t* __restrict__ glive, const float* __restrict__ gsum, float* buf,
                    float* tsum, uint8_t* __restrict__ out, int nb, int block, int groups) {
  constexpr int DP = Geo<D>::DP, SW = Geo<D>::SW;
  constexpr int TILE_F4 = TILE * DP / 4;
  extern __shared__ float4 smem[];
  float4* ring = smem;
  float4* lo_ring = ring + STAGES * TILE_F4;
  float* pref = reinterpret_cast<float*>(lo_ring + STAGES * SW / 4);
  float* plo = pref + (MP ? PRE_ROWS * DP : 0);
  float* stage = plo + (MP ? PRE_ROWS / TILE * SW : 0);
  float* hstage = stage + GROUP * D;
  int* list = reinterpret_cast<int*>(hstage + SW);
  int* gcnt = list + CHUNK;
  unsigned* lbits = reinterpret_cast<unsigned*>(gcnt + groups);
  const int nbw = (nb + 31) / 32;
  unsigned* keep = lbits + nbw;
  __shared__ int warp_cnt[WARPS];

  cg::cluster_group cluster = cg::this_cluster();
  constexpr int C = SCAN_CTAS;
  const int c = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gpc = (groups + C - 1) / C;
  // the tiles of a group split S ways when the cluster has more CTAs than
  // the block has groups; CTA c then works on group c % groups, split c /
  // groups (none when c >= groups * S)
  const int S = groups >= C ? 1 : C / groups;
  const int first_g = groups >= C ? c : (c < groups * S ? c % groups : -1);
  // group g's keep word w of set `par`, in its owner's shared memory
  auto word = [&](int par, int g, int w) {
    return cluster.map_shared_rank(keep + (par * gpc + g / C) * WORDS + w, g % C);
  };
  // this thread's alive flag of keep word i (i = warp, warp + WARPS, ...)
  // of block b, or false past the group
  auto alive_at = [&](int b, int i) {
    const int g = i / WORDS * C + c;
    const int base = b * block + g * GROUP;
    const int j = base + i % WORDS * 32 + lane;
    return g < groups && j < min(base + GROUP, (b + 1) * block) && alive[j];
  };
  // the owner's words of block b: alive rows, before any kill; `first`
  // holds this thread's flags of its first two words, read ahead
  auto init_keep = [&](int b, int par, const bool (&first)[2]) {
    for (int i = warp, q = 0; i < gpc * WORDS; i += WARPS, ++q) {
      if (i / WORDS * C + c >= groups) break;
      const unsigned m = __ballot_sync(FULL, q < 2 ? first[q] : alive_at(b, i));
      if (lane == 0) keep[(par * gpc + i / WORDS) * WORDS + i % WORDS] = m;
    }
  };
  // this thread's flags of its first two keep words of block b
  auto read_ahead = [&](int b, bool (&first)[2]) {
#pragma unroll
    for (int q = 0; q < 2; ++q)
      first[q] = b < nb && warp + q * WARPS < gpc * WORDS && alive_at(b, warp + q * WARPS);
  };
  // start copying block b's first group of this CTA into `stage`, and its
  // summary into `hstage`
  auto prefetch = [&](int b) {
    if (first_g < 0) return;
    if (tid < SW) cp_async4(hstage + tid, gsum + ((size_t)b * groups + first_g) * SW + tid);
    const int base = b * block + first_g * GROUP;
    const int rows = min(GROUP, (b + 1) * block - base);
    const float* src = cand + (size_t)base * D;
    for (int e = tid; e < rows * D; e += THREADS) cp_async4(stage + e, src + e);
    cp_async_commit();
  };

  for (int i = tid; i < nbw; i += THREADS) lbits[i] = 0;
  // the pre-drop's prefix: rows not yet in the buffer cannot certify
  if (MP)
    for (int r = tid; r < PRE_ROWS; r += THREADS) pref[r * DP] = __int_as_float(0x7fc00000);
  int pcached = 0;  // prefix rows rounded into `pref` so far
  __syncthreads();
  for (int i = tid; i < nb * groups; i += THREADS)
    if (glive[i]) atomicOr(lbits + (i / groups) / 32, 1u << ((i / groups) % 32));
  __syncthreads();
  int b = next_live(lbits, nb, 0);
  int par = 0;
  if (b < nb) {
    bool first[2];
    read_ahead(b, first);
    init_keep(b, par, first);
    prefetch(b);
  }
  int staged = b;
  cluster.sync();  // every CTA has started (distributed shared memory) and set its words

  int cnt = 0;
  while (b < nb) {
    const int bn = next_live(lbits, nb, b + 1);
    // the next block's alive flags, read now and used at the append
    bool ahead[2];
    read_ahead(bn, ahead);
    cp_async_wait<0>();
    __syncthreads();  // the staged victims have landed
    if (cnt > 0) {
      const int pre = min(cnt, PRE_ROWS);
      if (MP && pre > pcached) {
        // the buffer's new prefix rows rounded to bf16; a row not finite
        // after rounding cannot certify: a NaN first coordinate. Once the
        // buffer holds PRE_ROWS rows the prefix no longer changes
        for (int i = pcached + tid; i < pre; i += THREADS) {
          float x[DP];
#pragma unroll
          for (int k = 0; k < DP; ++k) x[k] = 0.0f;
          bool ok = true;
#pragma unroll
          for (int k = 0; k < D; ++k) {
            x[k] = bf16r(__ldcg(buf + (size_t)i * DP + k));
            ok = ok & isfinite(x[k]);
          }
          if (!ok) x[0] = __int_as_float(0x7fc00000);
#pragma unroll
          for (int k = 0; k < DP; ++k) pref[i * DP + k] = x[k];
        }
        __syncthreads();
        pcached = pre;
        // each prefix tile's summary over its rows that can certify (the
        // least rounded coordinates, then the least rounded sum), for the
        // skip of rules (a') and (b')
        for (int t = 0; t < (pre + TILE - 1) / TILE; ++t) {
          float acc[D + 1];
#pragma unroll
          for (int k = 0; k <= D; ++k) acc[k] = INFINITY;
          for (int r = tid; r < TILE; r += THREADS) {
            const float* x = pref + (size_t)(t * TILE + r) * DP;
            if (isnan(x[0])) continue;
#pragma unroll
            for (int k = 0; k < D; ++k) acc[k] = fminf(acc[k], x[k]);
            acc[D] = fminf(acc[D], row_sum<D>(x));
          }
          write_summary<D, THREADS, true>(acc, plo + t * SW);
          __syncthreads();
        }
      }
      // phase A: this CTA's groups against the buffer
      for (int a = 0;; ++a) {
        int g, s;
        if (groups >= C) {
          g = a * C + c;
          s = 0;
          if (g >= groups) break;
        } else {
          if (a > 0 || first_g < 0) break;
          g = first_g;
          s = c / groups;
        }
        const int base = b * block + g * GROUP;
        const int end = min(base + GROUP, (b + 1) * block);
        const bool staged_here = a == 0 && staged == b;
        float yv[V][D + 1];
        bool open[V], dom[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int r = warp * 32 * V + v * 32 + lane;
          const unsigned m = *word(par, g, warp * V + v);
          open[v] = base + r < end && ((m >> lane) & 1u) &&
                    load_victim<D>(staged_here ? stage + r * D : cand + (size_t)(base + r) * D,
                                   yv[v]);
          if (!open[v]) {
#pragma unroll
            for (int k = 0; k <= D; ++k) yv[v][k] = 0.0f;
          }
          dom[v] = false;
        }
        bool any = false;
#pragma unroll
        for (int v = 0; v < V; ++v) any = any | open[v];
        if (!__syncthreads_or(any)) continue;
        if (MP) {
          // the bf16 pre-drop against the buffer's first rows, rounded in
          // `pref`: tiles s, s + S, ... of rows [0, pre)
          float yb[V][D + 1];
          bool need[V], found[V];
          bool any_need = false;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            need[v] = open[v];
#pragma unroll
            for (int k = 0; k < D; ++k) {
              yb[v][k] = need[v] ? bf16r(yv[v][k]) : 0.0f;
              need[v] = need[v] & isfinite(yb[v][k]);
            }
            yb[v][D] = row_sum<D>(yb[v]);
            found[v] = false;
            any_need = any_need | need[v];
          }
          if (__any_sync(FULL, any_need))
            for (int t = s; t < (pre + TILE - 1) / TILE; t += S) {
              // each victim against the tile's summary alone (a set of one)
              float lo[SW];
              load_summary<D>(plo + t * SW, lo);
              bool live[V];
              bool any_live = false;
#pragma unroll
              for (int v = 0; v < V; ++v) {
                live[v] = need[v] & !found[v] & !predrop_skip<D>(lo, yb[v]);
                any_live = any_live | live[v];
              }
              if (__any_sync(FULL, any_live))
                predrop_tile<D>(reinterpret_cast<const float4*>(pref) + t * TILE_F4, yb, live,
                                found);
            }
#pragma unroll
          for (int v = 0; v < V; ++v) dom[v] = dom[v] | found[v];
        }
        // the buffer pass: tiles s, s + S, ... of rows [0, cnt)
        float hi[SW];
        load_summary<D>(staged_here ? hstage : gsum + ((size_t)b * groups + g) * SW, hi);
        walk_tiles<D>(
            tsum, hi, s, (cnt + TILE - 1) / TILE, S, ring, lo_ring, list, warp_cnt,
            [&](float4* dst, int t) {
              const float4* src = reinterpret_cast<const float4*>(buf + (size_t)t * TILE * DP);
              for (int q = tid; q < TILE_F4; q += THREADS) cp_async16(dst + q, src + q);
            },
            [&](float* rows, int t) { return mask_outside<D>(rows, t * TILE, 0, cnt); }, yv,
            open, dom);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const unsigned m = __ballot_sync(FULL, open[v] & dom[v]);
          if (lane == 0 && m) atomicAnd(word(par, g, warp * V + v), ~m);
        }
      }
      cluster.sync();  // every kill is in its owner's words
    }
    // the append, stable: group g's survivors after those of groups < g.
    // Every CTA counts every group's survivors from the owners' words.
    for (int i = tid; i < groups; i += THREADS) gcnt[i] = 0;
    __syncthreads();
    for (int i = tid; i < groups * WORDS; i += THREADS)
      atomicAdd(gcnt + i / WORDS, __popc(*word(par, i / WORDS, i % WORDS)));
    __syncthreads();
    int total = 0;
    for (int g = 0; g < groups; ++g) total += gcnt[g];
    for (int slot = 0; slot < gpc; ++slot) {
      const int g = slot * C + c;
      if (g >= groups) break;
      int before = 0;
      for (int q = 0; q < g; ++q) before += gcnt[q];
      const unsigned* words = keep + (par * gpc + slot) * WORDS;
      const int base = b * block + g * GROUP;
      const int end = min(base + GROUP, (b + 1) * block);
      // this CTA's first group of the block was staged in shared memory
      const float* rows = slot == 0 && g == first_g && staged == b ? stage : cand + (size_t)base * D;
      for (int r = tid; r < GROUP && base + r < end; r += THREADS) {
        const int j = base + r;
        const int w = r >> 5;
        const bool k = (words[w] >> (r & 31)) & 1u;
        out[j] = k ? 1 : 0;
        if (!k) continue;
        int off = __popc(words[w] & ((1u << (r & 31)) - 1u));
        for (int q = 0; q < w; ++q) off += __popc(words[q]);
        const int dst = cnt + before + off;
        float y[D];
        bool ok = true;
#pragma unroll
        for (int e = 0; e < D; ++e) {
          y[e] = rows[(size_t)r * D + e];
          ok = ok & !isnan(y[e]);
        }
        float* row = buf + (size_t)dst * DP;
#pragma unroll
        for (int e = 0; e < D; ++e) row[e] = y[e];
        if (ok) {  // a row with a NaN coordinate cannot dominate: no summary
          float* ts = tsum + (size_t)(dst / TILE) * SW;
#pragma unroll
          for (int e = 0; e < D; ++e) atomic_min_float(ts + e, y[e]);
          const float sum = row_sum<D>(y);
          atomic_min_float(ts + D, isnan(sum) ? -INFINITY : sum);
        }
      }
    }
    // every thread has read its rows of `stage` before prefetch overwrites
    // them (a thread's copies land on other warps' rows)
    __syncthreads();
    if (bn < nb) {
      init_keep(bn, par ^ 1, ahead);
      prefetch(bn);
    }
    staged = bn;
    cnt += total;
    par ^= 1;
    b = bn;
    cluster.sync();  // the buffer rows, their summaries and the next words are in place
  }
  cp_async_wait<0>();
}

template <int D, bool MP>
cudaError_t launch_scan(const float* cand, const uint8_t* alive, uint8_t* out, float* buf,
                        float* tsum, float* gsum, uint8_t* glive, int nb, int block,
                        cudaStream_t stream) {
  const int groups = (block + GROUP - 1) / GROUP;
  const int ntiles = (nb * block + TILE - 1) / TILE;
  const void* fn = (const void*)cascade_scan_kernel<D, MP>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(SCAN_CTAS);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SCAN_CTAS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  size_t cap = 0;
  int active = 0;
  cudaError_t err = fitted_for(
      fn,
      [&](int, size_t c, int* v) {
        cudaLaunchConfig_t q = cfg;
        q.dynamicSmemBytes = c;
        return cudaOccupancyMaxActiveClusters(v, fn, &q);
      },
      &cap, &active);
  if (err != cudaSuccess) return err;
  if (active < 1) return cudaErrorLaunchOutOfResources;  // the card runs no such cluster
  cfg.dynamicSmemBytes = scan_smem<D, MP>(nb, groups);
  if (cfg.dynamicSmemBytes > cap) return cudaErrorInvalidValue;
  scan_summary_kernel<D><<<nb * groups, THREADS, 0, stream>>>(cand, alive, gsum, glive, tsum,
                                                              out, block, groups, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, cascade_scan_kernel<D, MP>, cand, alive,
                           (const uint8_t*)glive, (const float*)gsum, buf, tsum, out, nb, block,
                           groups);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

#define SKYLINE_DIMS(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

// The window pass over n = nb * block row-major candidates (d floats a row,
// non-candidates all-NaN): out (n) uint8, row j of block b dominated by a
// row of [b * block, min(band_end[b] * block, n)); band_end (nb) int32 in
// blocks. Scratch: tsum (ceil(n / 256), sw) and gsum (nb * ceil(block /
// 256), sw) f32 with sw = d + 1 rounded up to 4, items (nb * ceil(block /
// 256) * 8) int4, counters (2) int32 zero. Two launches on ``stream``
// without synchronising; returns cudaGetLastError() of the launches.
extern "C" int skyline_cascade_windows(const float* cand, const int* band_end, uint8_t* out,
                                       float* tsum, float* gsum, void* items, int* counters,
                                       int d, int n, int block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int4* it = static_cast<int4*>(items);
  switch (d) {
#define SKYLINE_CASE(D) \
  case D:               \
    return (int)launch_windows<D>(cand, band_end, out, tsum, gsum, it, counters, n, block, s);
    SKYLINE_DIMS(SKYLINE_CASE)
#undef SKYLINE_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// One scan over nb blocks of `block` rows: cand (nb * block, d) f32
// row-major, alive (nb * block) uint8; out (nb * block) uint8. Scratch: buf
// (ceil(nb * block / 256) * 256, dp) f32 with dp = d rounded up to 4, tsum
// (ceil(nb * block / 256), sw), gsum (nb * ceil(block / 256), sw) f32,
// glive (nb * ceil(block / 256)) uint8. mp: the bf16 pre-drop in each
// buffer pass. Two launches on ``stream`` without synchronising; returns the launches'
// error (a cluster the card cannot run included), else cudaGetLastError().
extern "C" int skyline_cascade_scan(const float* cand, const uint8_t* alive, uint8_t* out,
                                    float* buf, float* tsum, float* gsum, uint8_t* glive, int d,
                                    int nb, int block, int mp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define SKYLINE_CASE(D)                                                                    \
  case D:                                                                                  \
    return (int)(mp ? launch_scan<D, true>(cand, alive, out, buf, tsum, gsum, glive, nb,   \
                                           block, s)                                       \
                    : launch_scan<D, false>(cand, alive, out, buf, tsum, gsum, glive, nb,  \
                                            block, s));
    SKYLINE_DIMS(SKYLINE_CASE)
#undef SKYLINE_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* skyline_cascade_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
