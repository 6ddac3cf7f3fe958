// Value dominance kernel for Hopper (sm_90a): the skyline engine's hot op.
//
// out[p, j] = some valid x[p, :, i] dominates y[p, :, j]   (minimization:
// all(x_k <= y_k) and any(x_k < y_k)), for an optional leading partition
// dimension p. One kernel serves three entry points of
// skyline_tpu_torch/ops/dominance_kernels.py:
//
//   K1 dominated_by_any  (x == y, one set)   replaces skyline_tpu/ops/
//        pallas_dominance.py dominated_by_any_pallas (_kernel_tri/_kernel,
//        _tile_body, _dom_tile, _tile_sum_skip)
//   K2 dominated_by_rect (rectangular)       replaces dominated_by_pallas
//   K3 skyline_mask_kernel (sum-sort + K1)   replaces skyline_mask_pallas
//
// The layout at the surface follows the TPU kernels: coordinates transposed
// as (P, d, N), validity one uint8 per dominator. The device code that
// cascade.cu shares (steps 1, 2, 5 and 8's pieces) is in
// dominance_common.cuh.
//
// The mixed-precision entry points (the TPU kernels' static mp flag,
// pallas_dominance.py _tile_body and _dom_tile_mp) launch the same compare
// kernel (step 7). The same source holds the row pre-drop of the
// mixed-precision flush (step 8), the reference's strictly_dominated_bf16
// (XLA there, ops/dominance.py).
//
// What bounds it: FP32 compares over the pairs the data needs — d compares
// a pair for all(<=), and d more for any(<) only in the rows where some lane
// of the warp found all(<=) — for the pairs no summary can rule out; the
// inputs are a few MB, so bytes bound it only when almost every pair is
// skipped.
// Tensor cores do not apply: dominance is a conjunction of compares, not a
// sum of products, and no mma form computes all(<=) && any(<) exactly.
// The design, and what each part does about that bound:
//
// 1. A summary pass (summarize_kernel) ahead of the compare loop. For every
//    dominator tile of TILE rows: lo_k, the per-dimension minimum over the
//    rows that can dominate (valid, no NaN coordinate), and the minimum valid
//    row sum (invalid +inf; a NaN sum -inf, so it never skips). For every
//    victim block of V * THREADS victims: hi_k, the per-dimension maximum
//    over the victims that can be dominated (j < ny, no NaN coordinate;
//    invalid and +inf-padded victims count, since the plain version answers
//    for them too), and the maximum victim sum (NaN +inf). Sums are added in
//    dimension order (row_sum) for dominators and victims alike. The same
//    pass writes the dominators row-major, 16-byte aligned (DP floats a row)
//    and padded to whole tiles, with every row that cannot dominate (invalid
//    or past nx) given a NaN first coordinate: NaN <= y is false.
// 2. The exact skip rule. A (block, tile) pair is skipped when
//      (a) tile_min_sum > block_max_sum, or
//      (b) lo_k > hi_k for some k, or
//      (c) lo_k >= hi_k for every k.
//    Proof. Only rows in the summaries can take part in a domination: a
//    dominator that is invalid or has a NaN coordinate fails all(<=), and so
//    does a victim with a NaN coordinate. For x in the tile and y in the
//    block: (a) x <= y in every dimension implies row_sum(x) <= row_sum(y),
//    since rounded addition in one order is monotone, so no x dominates
//    any y; (b) x_k >= lo_k > hi_k >= y_k fails x_k <= y_k; (c) x_k >= lo_k
//    >= hi_k >= y_k in every k, so all(x <= y) forces x == y in every k and
//    any(x < y) fails. An empty tile has lo = +inf and an empty block hi =
//    -inf, so (c) skips both. lo and hi never hold NaN (fminf/fmaxf over
//    rows without NaN, from +inf/-inf). +0.0 and -0.0 compare equal whichever
//    sign fminf/fmaxf returns, and +-inf compare as ordered values, so every
//    step above holds for them. No tile is skipped by its index: a
//    dominator may sort after its victim when f32 sums tie.
// 3. Each block scans its summary against every tile summary (CHUNK at a
//    time), compacts the surviving tile indices in order with a ballot, a
//    popcount and a prefix across warps, and walks only those. A skipped
//    tile costs one summary test, not a load and two barriers. During the
//    walk each lane tests the tile's summary once more against each of its
//    undecided victims alone (a set of one, so the proof holds), and a warp
//    compares the tile only if some victim survives that test: a block
//    whose few undecided victims no tile can dominate (copies of the
//    skyline's own rows, say) then stops comparing though it cannot stop.
// 4. The walk streams surviving tiles through a ring of STAGES shared-memory
//    stages filled by cp.async (16-byte copies, no registers spent), so the
//    next tile loads while the current one is compared. A row is DP floats
//    in shared memory, read as DP/4 16-byte broadcasts (two LDS.128 for
//    d = 8), not d 4-byte loads.
// 5. Each thread holds V victims in registers (d is a template parameter, the
//    counterpart of the Pallas static unroll), so each dominator row read
//    from shared memory serves V pairs. V = 2: at V = 4 the kernel was
//    slower wherever compares dominate and no faster elsewhere (fewer
//    blocks in flight, a warp waits on its slowest of 128 victims, and it
//    spilled at some d); at V = 2 ptxas
//    reports no spill at d = 8 (chip_smoke.py prints the registers, shared
//    memory and spills of every instantiation). Dynamic shared memory is
//    STAGES tiles and the survivor list: 32 KB at d = 8, 56 KB at d = 16.
// 6. A warp whose victims are all decided stops comparing (checked every 32
//    rows) but keeps the ring's barriers; the block stops when all its
//    victims are decided. Nothing is carried between blocks, so the output
//    needs no atomics.
//
// 7. mp. The TPU kernels classify each pair first with a packed bf16
//    margin test (certain, decided-false, undecided) and run the f32
//    predicate only for the pairs left undecided: bf16 runs at twice the
//    f32 rate on the TPU's vector unit, so the pass saves cycles there. On
//    this card the f32 predicate of step 5 is already the cheapest exact
//    test: two FSETPs a dimension for the thread's two pairs, all(<=) first
//    and any(<) only where some lane of the warp found all(<=), with the
//    warp's early exit deciding as soon as a certain pair would. The bf16
//    classification cost about 12 instructions a dimension for the same two
//    pairs (round the dominator row to bf16, its half of the margin with
//    __habs2, __hmul2 and __hadd2, __hneg2, the packed __hsub2, then four
//    scalar bf16 compares with half extraction) before any f32 test, and
//    its output was the f32 kernel's, bit for bit. So mp launches the f32
//    compare kernel. Measured on an H100 80GB HBM3 at 700 W, with the bf16
//    loop built beside this kernel in the same call (chip_smoke.py
//    --parent), mp before and after: K1 on 65,536 rows of one f32 sum 7.850
//    against 3.919 ms (f32 3.902), K2 on 65,536 uniform 8-D victims against
//    458,752 dominators 22.947 against 14.284 ms (f32 14.289), K3 on
//    458,752 uniform rows 49.640 against 25.519 ms (f32 25.053).
// 8. The pre-drop (predrop_summarize_kernel, predrop_kernel): victim j is
//    certified when some dominator row that can certify (valid, finite
//    after rounding) passes the reference's test in every dimension k:
//      fl(yb_k - xb_k) > m_k,  m_k = fl(fl(2^-7 * fl(|xb_k| + |yb_k|)) + 1e-30),
//    on the values rounded to bf16 and back, in f32 operation for operation
//    (__fadd_rn, __fmul_rn, __fsub_rn: nothing contracted). Bound: the 5
//    f32 operations of each pair and dimension the data needs (one pair a
//    certified victim; for every other, each valid dominator whose rounded
//    sum is no larger, less its rounded copies); the bytes only when almost
//    everything is skipped. The design follows steps 1-6:
//    - A summary pass in the same call writes the dominators rounded to
//      bf16, row-major in 16-byte rows, with a NaN first coordinate on every
//      row that cannot certify; per tile of TILE rows, lo_k (the least
//      rounded coordinate over the rows that can certify) and the least
//      rounded row sum; per block of V * THREADS victims, hi_k and the
//      greatest rounded row sum over its live, valid, finite victims.
//    - The exact skip rule. Only finite rows take part: an infinite xb_k or
//      yb_k makes fl(|xb_k| + |yb_k|), and so m_k, +inf, which nothing
//      exceeds, and a NaN fails every comparison. For finite values m_k >=
//      fl(1e-30) > 0, and with no flush-to-zero fl(a - b) > 0 only when
//      a > b, so a pair certifies only when yb_k > xb_k in every k. A
//      (block, tile) pair is skipped when
//        (a') lo_k >= hi_k for some k: xb_k >= lo_k >= hi_k >= yb_k; one
//             dimension is enough here, where step 2's rule (c) needs all;
//        (b') tile_min_sum > block_max_sum: yb_k > xb_k in every k makes
//             row_sum(xb) <= row_sum(yb), rounded addition in one order
//             being monotone.
//      Rows that cannot certify stay out of both summaries; an empty tile
//      has lo = +inf and an empty block hi = -inf, so (a') skips both. A
//      sum of finite values may overflow to +-inf but is never NaN. +0.0
//      and -0.0 compare equal in both the rule and the test. Each warp
//      applies the same test to each of its victims alone against the tile
//      (a set of one). On the north-star data a partition's block of zero
//      rows against its zero skyline prefix is skipped whole.
//    - The compare: V = 2 victims a thread in registers, each dominator row
//      read as DP/4 16-byte shared-memory broadcasts, serving both. First
//      the necessary condition yb_k > xb_k (one FSETP a dimension a pair),
//      the margin test only where some lane of the warp passed it. The exit
//      check is warp-uniform every 32 rows; the block stops when every
//      victim is certified. No atomics: a block writes its own outputs.
//    - The dominators are read in place through their partition stride
//      (the flush passes a prefix of the skyline buffer), and the flush's
//      entry writes its epilogue — the block with +inf on every row that is
//      invalid or certified, the validity less the certified rows, and one
//      certified count per victim block — so the flush adds one sum.
//    Measured on an H100 80GB HBM3 at 700 W at the north-star round shape
//    (P = 8, 512 dominators x 65,536 victims, d = 8; 86% of the (block,
//    tile) pairs skipped): the mask 0.042 ms, the fused entry 0.054 ms,
//    against 0.369 ms in the same call for the kernel this one replaced
//    (one victim a thread, d scalar shared loads a row, a per-thread loop
//    to the first certifying row, no summary).
//
// Semantics match the plain PyTorch predicate (ops/dominance.py) bit for
// bit, NaN and infinities included: the predicate is written as
// all(<=) && any(<), never as min/max of differences. Build without
// --use_fast_math: flush-to-zero would turn a tiny x_k < y_k into equality.

#include "dominance_common.cuh"

namespace {

// Step 1. grid (ntiles + nblocks, P), TILE threads: blocks below ntiles
// summarise a dominator tile and write its rows row-major into xr; the rest
// summarise a victim block of bv victims.
template <int D>
__global__ void __launch_bounds__(TILE)
summarize_kernel(const float* __restrict__ x, const uint8_t* __restrict__ xv,
                 const float* __restrict__ y, float* __restrict__ xr,
                 float* __restrict__ tsum, float* __restrict__ bsum, int nx,
                 int ny, int ntiles, int nblocks, int bv) {
  constexpr int DP = Geo<D>::DP, SW = Geo<D>::SW;
  const int p = blockIdx.y;
  const int idx = blockIdx.x;
  const int tid = threadIdx.x;
  float acc[D + 1];
  if (idx < ntiles) {
    const int t = idx;
    const int i = t * TILE + tid;
    x += (size_t)p * D * nx;
    xv += (size_t)p * nx;
    float v[DP];
#pragma unroll
    for (int k = 0; k < DP; ++k) v[k] = 0.0f;
    bool ok = false;
    float s = INFINITY;
    if (i < nx) {
#pragma unroll
      for (int k = 0; k < D; ++k) v[k] = x[(size_t)k * nx + i];
      if (xv[i]) {
        s = row_sum<D>(v);
        if (isnan(s)) s = -INFINITY;  // may still dominate: never skip
        ok = true;
#pragma unroll
        for (int k = 0; k < D; ++k) ok = ok & !isnan(v[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < D; ++k) acc[k] = ok ? v[k] : INFINITY;
    acc[D] = s;
    if (!(i < nx && xv[i])) v[0] = __int_as_float(0x7fc00000);
    float4* dst = reinterpret_cast<float4*>(xr + ((size_t)p * ntiles * TILE + i) * DP);
#pragma unroll
    for (int q = 0; q < DP / 4; ++q)
      dst[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    write_summary<D, TILE, true>(acc, tsum + ((size_t)p * ntiles + t) * SW);
  } else {
    const int b = idx - ntiles;
    y += (size_t)p * D * ny;
#pragma unroll
    for (int k = 0; k <= D; ++k) acc[k] = -INFINITY;
    const int end = min(ny, (b + 1) * bv);
    for (int j = b * bv + tid; j < end; j += TILE) {
      float v[D];
#pragma unroll
      for (int k = 0; k < D; ++k) v[k] = y[(size_t)k * ny + j];
      const float s = row_sum<D>(v);
      bool ok = true;
#pragma unroll
      for (int k = 0; k < D; ++k) ok = ok & !isnan(v[k]);
      if (ok) {
#pragma unroll
        for (int k = 0; k < D; ++k) acc[k] = fmaxf(acc[k], v[k]);
      }
      acc[D] = fmaxf(acc[D], isnan(s) ? INFINITY : s);
    }
    write_summary<D, TILE, false>(acc, bsum + ((size_t)p * nblocks + b) * SW);
  }
}

template <int D>
__device__ __forceinline__ void load_tile(float4* dst, const float* src) {
  constexpr int F4 = TILE * Geo<D>::DP / 4;
  const float4* s = reinterpret_cast<const float4*>(src);
  for (int c = threadIdx.x; c < F4; c += THREADS) cp_async16(dst + c, s + c);
}

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)STAGES * TILE * Geo<D>::DP * sizeof(float) + CHUNK * sizeof(int);
}

// Steps 3-6. grid (nblocks, P), THREADS threads; block b owns victims
// [b * V * THREADS, (b + 1) * V * THREADS), warp w the 32 * V consecutive
// ones from b * V * THREADS + w * 32 * V, lane l of them l, l + 32, ...
// (coalesced loads per dimension). During the walk each lane also tests
// the tile's summary against each of its undecided victims alone (a set of
// one: the proof of step 2 holds for it), and a warp compares a tile only
// when some lane found a victim the summary does not rule out.
template <int D>
__global__ void __launch_bounds__(THREADS)
dominated_kernel(const float* __restrict__ xr, const float* __restrict__ tsum,
                 const float* __restrict__ bsum, const float* __restrict__ y,
                 uint8_t* __restrict__ out, int ny, int ntiles, int nblocks) {
  constexpr int DP = Geo<D>::DP, SW = Geo<D>::SW;
  constexpr int TILE_F4 = TILE * DP / 4;
  extern __shared__ float4 smem[];
  float4* ring = smem;
  int* list = reinterpret_cast<int*>(smem + STAGES * TILE_F4);
  __shared__ int warp_cnt[WARPS];

  const int p = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  xr += (size_t)p * ntiles * TILE * DP;
  tsum += (size_t)p * ntiles * SW;
  const float* bs = bsum + ((size_t)p * nblocks + blockIdx.x) * SW;
  y += (size_t)p * D * ny;
  out += (size_t)p * ny;
  const int j0 = blockIdx.x * V * THREADS + warp * 32 * V + lane;

  // each victim's coordinates, then its sum (NaN +inf, as for blocks);
  // open: live and free of NaN, so it can be dominated at all
  float yv[V][D + 1];
  bool open[V];
  bool dom[V];
  bool pending = false;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int j = j0 + v * 32;
    const bool live = j < ny;
    open[v] = live;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      yv[v][k] = live ? y[(size_t)k * ny + j] : 0.0f;
      open[v] = open[v] & !isnan(yv[v][k]);
    }
    const float s = row_sum<D>(yv[v]);
    yv[v][D] = isnan(s) ? INFINITY : s;
    dom[v] = false;
    pending = pending | open[v];
  }
  float hi[SW];
  load_summary<D>(bs, hi);

  bool busy = __syncthreads_or(pending);
  for (int c0 = 0; busy && c0 < ntiles; c0 += CHUNK) {
    const int cend = min(ntiles, c0 + CHUNK);
    // step 3: the surviving tiles of this chunk, in order
    int kept = 0;
    for (int base = c0; base < cend; base += THREADS) {
      const int t = base + tid;
      bool keep = false;
      if (t < cend) {
        float lo[SW];
        load_summary<D>(tsum + (size_t)t * SW, lo);
        keep = !skip_tile<D>(lo, hi);
      }
      const unsigned m = __ballot_sync(FULL, keep);
      if (lane == 0) warp_cnt[warp] = __popc(m);
      __syncthreads();
      int off = kept;
      int total = 0;
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
    // step 4: walk them through the ring, STAGES - 1 tiles ahead
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < kept) load_tile<D>(ring + s * TILE_F4, xr + (size_t)list[s] * TILE * DP);
      cp_async_commit();
    }
    for (int it = 0; it < kept; ++it) {
      const int nxt = it + STAGES - 1;
      if (nxt < kept)
        load_tile<D>(ring + (nxt % STAGES) * TILE_F4, xr + (size_t)list[nxt] * TILE * DP);
      cp_async_commit();
      cp_async_wait<STAGES - 1>();  // tile `it` has landed (this thread's part)
      __syncthreads();              // ... and every thread's
      float lo[SW];
      load_summary<D>(tsum + (size_t)list[it] * SW, lo);
      bool need = false;
#pragma unroll
      for (int v = 0; v < V; ++v)
        need = need | (open[v] & !dom[v] & !skip_tile<D>(lo, yv[v]));
      if (__any_sync(FULL, need))
        compare_tile<D>(ring + (it % STAGES) * TILE_F4, yv, open, dom, pending);
      // also the barrier before stage (it % STAGES) is refilled
      if (!__syncthreads_or(pending)) break;
    }
    cp_async_wait<0>();
    busy = __syncthreads_or(pending);  // before the next chunk reuses the ring
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int j = j0 + v * 32;
    if (j < ny) out[j] = dom[v] ? 1 : 0;
  }
}

template <int D>
cudaError_t launch(const float* x, const uint8_t* xv, const float* y, uint8_t* out,
                   float* xr, float* tsum, float* bsum, int P, int nx, int ny,
                   cudaStream_t stream) {
  const int ntiles = (nx + TILE - 1) / TILE;
  const int nblocks = (ny + V * THREADS - 1) / (V * THREADS);
  summarize_kernel<D><<<dim3(ntiles + nblocks, P), TILE, 0, stream>>>(
      x, xv, y, xr, tsum, bsum, nx, ny, ntiles, nblocks, V * THREADS);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // above 48 KB, dynamic shared memory must be asked for
  const size_t smem = smem_bytes<D>();
  err = cudaFuncSetAttribute(dominated_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  dominated_kernel<D><<<dim3(nblocks, P), THREADS, smem, stream>>>(xr, tsum, bsum, y, out, ny,
                                                                   ntiles, nblocks);
  return cudaGetLastError();
}

// Step 8's summary pass. grid (ntiles + nblocks, P), TILE threads: blocks
// below ntiles round a dominator tile to bf16, write it row-major into xr
// (a row that cannot certify — invalid, past nx or not finite — with a NaN
// first coordinate) and summarise it over the rows that can; the rest
// summarise a victim block of bv victims over its live, valid (yv may be
// null: all valid) and finite victims. Rows are d contiguous floats;
// partition p starts xps (xvps, yps, yvps) elements after partition p - 1.
template <int D>
__global__ void __launch_bounds__(TILE)
predrop_summarize_kernel(const float* __restrict__ x, const uint8_t* __restrict__ xv,
                         const float* __restrict__ y, const uint8_t* __restrict__ yv,
                         float* __restrict__ xr, float* __restrict__ tsum,
                         float* __restrict__ bsum, int nx, int ny, long long xps,
                         long long xvps, long long yps, long long yvps, int ntiles,
                         int nblocks, int bv) {
  constexpr int DP = Geo<D>::DP, SW = Geo<D>::SW;
  const int p = blockIdx.y;
  const int tid = threadIdx.x;
  float acc[D + 1];
  if ((int)blockIdx.x < ntiles) {
    const int t = blockIdx.x;
    const int i = t * TILE + tid;
    x += p * xps;
    xv += p * xvps;
    float v[DP];
#pragma unroll
    for (int k = 0; k < DP; ++k) v[k] = 0.0f;
    bool ok = false;
    if (i < nx && xv[i]) {
      ok = true;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        v[k] = bf16r(x[(size_t)i * D + k]);
        ok = ok & isfinite(v[k]);
      }
    }
    const float s = row_sum<D>(v);
#pragma unroll
    for (int k = 0; k < D; ++k) acc[k] = ok ? v[k] : INFINITY;
    acc[D] = ok ? s : INFINITY;
    if (!ok) v[0] = __int_as_float(0x7fc00000);
    float4* dst = reinterpret_cast<float4*>(xr + ((size_t)p * ntiles * TILE + i) * DP);
#pragma unroll
    for (int q = 0; q < DP / 4; ++q)
      dst[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    write_summary<D, TILE, true>(acc, tsum + ((size_t)p * ntiles + t) * SW);
  } else {
    const int b = blockIdx.x - ntiles;
    y += p * yps;
    if (yv) yv += p * yvps;
#pragma unroll
    for (int k = 0; k <= D; ++k) acc[k] = -INFINITY;
    const int end = min(ny, (b + 1) * bv);
    for (int j = b * bv + tid; j < end; j += TILE) {
      if (yv && !yv[j]) continue;
      float v[D];
      bool ok = true;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        v[k] = bf16r(y[(size_t)j * D + k]);
        ok = ok & isfinite(v[k]);
      }
      if (ok) {
#pragma unroll
        for (int k = 0; k < D; ++k) acc[k] = fmaxf(acc[k], v[k]);
        acc[D] = fmaxf(acc[D], row_sum<D>(v));
      }
    }
    write_summary<D, TILE, false>(acc, bsum + ((size_t)p * nblocks + b) * SW);
  }
}

// Step 8's compare. grid (nblocks, P), THREADS threads; victims map to
// threads as in dominated_kernel. A victim is open when it is live, valid
// and finite after rounding. Each tile the block's summary does not rule
// out is loaded into shared memory (at most 16 KB) and walked by the warps
// whose victims survive the tile's summary alone; the block stops when no
// open victim is undecided. FUSED writes the flush's epilogue — yout (the
// block, +inf where a row is invalid or certified), vout (valid and not
// certified) and cnt (certified victims per block) — else out (certified).
template <int D, bool FUSED>
__global__ void __launch_bounds__(THREADS)
predrop_kernel(const float* __restrict__ xr, const float* __restrict__ tsum,
               const float* __restrict__ bsum, const float* __restrict__ y,
               const uint8_t* __restrict__ yv, uint8_t* __restrict__ out,
               float* __restrict__ yout, uint8_t* __restrict__ vout, int* __restrict__ cnt,
               int ny, long long yps, long long yvps, int ntiles, int nblocks) {
  constexpr int DP = Geo<D>::DP, SW = Geo<D>::SW;
  constexpr int TILE_F4 = TILE * DP / 4;
  __shared__ float4 tile[TILE_F4];
  __shared__ int warp_cnt[WARPS];

  const int p = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  xr += (size_t)p * ntiles * TILE * DP;
  tsum += (size_t)p * ntiles * SW;
  const float* bs = bsum + ((size_t)p * nblocks + blockIdx.x) * SW;
  y += p * yps;
  if (FUSED) yv += p * yvps;
  const int j0 = blockIdx.x * V * THREADS + warp * 32 * V + lane;

  float yb[V][D + 1];
  bool valid[V], open[V], found[V];
  bool pending = false;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int j = j0 + v * 32;
    valid[v] = j < ny && (!FUSED || yv[j]);
    open[v] = valid[v];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      yb[v][k] = valid[v] ? bf16r(y[(size_t)j * D + k]) : 0.0f;
      open[v] = open[v] & isfinite(yb[v][k]);
    }
    yb[v][D] = row_sum<D>(yb[v]);
    found[v] = false;
    pending = pending | open[v];
  }
  float hi[SW];
  load_summary<D>(bs, hi);

  if (__syncthreads_or(pending)) {
    for (int t = 0; t < ntiles; ++t) {
      float lo[SW];
      load_summary<D>(tsum + (size_t)t * SW, lo);
      if (predrop_skip<D>(lo, hi)) continue;  // the same for every thread
      // the barrier that ended the last tile walked keeps its readers out
      const float4* src = reinterpret_cast<const float4*>(xr + (size_t)t * TILE * DP);
      for (int c = tid; c < TILE_F4; c += THREADS) tile[c] = src[c];
      __syncthreads();
      bool need[V];
      bool any_need = false;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        need[v] = open[v] & !found[v] & !predrop_skip<D>(lo, yb[v]);
        any_need = any_need | need[v];
      }
      if (__any_sync(FULL, any_need)) predrop_tile<D>(tile, yb, need, found);
      pending = false;
#pragma unroll
      for (int v = 0; v < V; ++v) pending = pending | (open[v] & !found[v]);
      if (!__syncthreads_or(pending)) break;  // also before the tile is refilled
    }
  }
  if (!FUSED) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int j = j0 + v * 32;
      if (j < ny) out[(size_t)p * ny + j] = found[v] ? 1 : 0;
    }
    return;
  }
  // the block's rows are copied through a keep flag each, element by
  // element, so neighbouring threads read and write neighbouring floats
  __shared__ bool keep_s[V * THREADS];
  int mine = 0;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int j = j0 + v * 32;
    const bool keep = valid[v] & !found[v];
    keep_s[warp * 32 * V + v * 32 + lane] = keep;
    if (j < ny) vout[(size_t)p * ny + j] = keep ? 1 : 0;
    mine += found[v] ? 1 : 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mine += __shfl_xor_sync(FULL, mine, o);
  if (lane == 0) warp_cnt[warp] = mine;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += warp_cnt[w];
    cnt[(size_t)p * nblocks + blockIdx.x] = total;
  }
  const int b0 = blockIdx.x * V * THREADS;
  const int rows = min(V * THREADS, ny - b0);
  const float* src = y + (size_t)b0 * D;
  float* dst = yout + ((size_t)p * ny + b0) * D;
  for (int e = tid; e < rows * D; e += THREADS) dst[e] = keep_s[e / D] ? src[e] : INFINITY;
}

template <int D>
cudaError_t launch_predrop(const float* y, const uint8_t* yv, const float* x,
                           const uint8_t* xv, uint8_t* out, float* yout, uint8_t* vout,
                           int* cnt, float* xr, float* tsum, float* bsum, int P, int nx,
                           int ny, long long yps, long long yvps, long long xps,
                           long long xvps, cudaStream_t stream) {
  const int ntiles = (nx + TILE - 1) / TILE;
  const int nblocks = (ny + V * THREADS - 1) / (V * THREADS);
  predrop_summarize_kernel<D><<<dim3(ntiles + nblocks, P), TILE, 0, stream>>>(
      x, xv, y, yv, xr, tsum, bsum, nx, ny, xps, xvps, yps, yvps, ntiles, nblocks,
      V * THREADS);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (yout)
    predrop_kernel<D, true><<<dim3(nblocks, P), THREADS, 0, stream>>>(
        xr, tsum, bsum, y, yv, out, yout, vout, cnt, ny, yps, yvps, ntiles, nblocks);
  else
    predrop_kernel<D, false><<<dim3(nblocks, P), THREADS, 0, stream>>>(
        xr, tsum, bsum, y, yv, out, yout, vout, cnt, ny, yps, yvps, ntiles, nblocks);
  return cudaGetLastError();
}

}  // namespace

// x: (P, d, nx) f32, xv: (P, nx) uint8, y: (P, d, ny) f32, out: (P, ny)
// uint8, all contiguous on the device. Scratch, allocated by the caller:
// xr (P, ceil(nx / 256) * 256, dp) f32 with dp = d rounded up to 4; tsum
// (P, ceil(nx / 256), sw) and bsum (P, ceil(ny / 256), sw) f32 with sw =
// d + 1 rounded up to 4. Launches the summary pass and the compare kernel
// on ``stream`` without synchronising and returns cudaGetLastError() of the
// launches.
extern "C" int skyline_dominated(const float* x, const uint8_t* xv, const float* y,
                                 uint8_t* out, float* xr, float* tsum, float* bsum,
                                 int P, int d, int nx, int ny, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define SKYLINE_CASE(D) \
  case D:               \
    return (int)launch<D>(x, xv, y, out, xr, tsum, bsum, P, nx, ny, s);
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

// The row pre-drop: y (P, ny, d) f32 victims and x (P, nx, d) f32
// dominators, rows of d contiguous floats, partition p of y (yv, x, xv)
// starting yps (yvps, xps, xvps) elements after partition p - 1; xv (P,
// nx) uint8 validity. Scratch as for skyline_dominated. With yout null:
// out (P, ny) uint8, the certified mask of every victim (yv unused). Else
// the flush's epilogue for victims of validity yv: yout (P, ny, d) f32 and
// vout (P, ny) uint8, contiguous, and cnt (P, ceil(ny / 256)) int32 (out
// unused). Writes only its outputs and the scratch. Launches on ``stream``
// without synchronising and returns cudaGetLastError() of the launches.
extern "C" int skyline_predrop(const float* y, const uint8_t* yv, const float* x,
                               const uint8_t* xv, uint8_t* out, float* yout, uint8_t* vout,
                               int* cnt, float* xr, float* tsum, float* bsum, int P, int d,
                               int nx, int ny, long long yps, long long yvps, long long xps,
                               long long xvps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define SKYLINE_CASE(D)                                                                    \
  case D:                                                                                  \
    return (int)launch_predrop<D>(y, yv, x, xv, out, yout, vout, cnt, xr, tsum, bsum, P, \
                                  nx, ny, yps, yvps, xps, xvps, s);
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

extern "C" const char* skyline_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
