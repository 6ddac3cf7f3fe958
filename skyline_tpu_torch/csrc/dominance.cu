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
// as (P, d, N), validity one uint8 per dominator.
//
// The mixed-precision variant (MP = true; the TPU kernels' static mp flag,
// pallas_dominance.py _tile_body and _dom_tile_mp) classifies each pair
// first with a packed bf16 margin test and runs the f32 predicate only for
// the pairs it leaves undecided (step 7 below). The same source holds the
// row pre-drop of the mixed-precision flush (predrop_kernel, step 8), the
// reference's strictly_dominated_bf16 (XLA there, ops/dominance.py).
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
// 7. MP: the thread's two victims are the two halves of a __nv_bfloat162,
//    so one packed subtract, add and multiply serve both pairs. Per
//    dimension, with xb, yb the values rounded to bf16 (round to nearest
//    even), t = xb - yb and m = 2^-6 * |xb| + c_y, c_y = 2^-6 * |yb| + tiny
//    (per victim, once), all rounded to bf16:
//      certain        t < -m in every dimension  -> x dominates y;
//      decided-false  t > m in some dimension    -> x does not;
//      undecided      anything else              -> the f32 predicate.
//    Soundness. Rounding to bf16 moves a value by at most u = 2^-8 of its
//    magnitude (a subnormal by 2^-134; 2^-126 were it flushed), and each
//    bf16 operation is correctly rounded, so t = (xb - yb)(1 + e), |e| <= u,
//    and m >= (2^-6 S + tiny)(1 - u)^2 with S = |xb| + |yb|. Then
//    t < -m gives x_k - y_k <= t / (1 + u) + u S + 2^-125
//              < -m / (1 + u) + u S + 2^-125
//              <= -(0.988 * 2^-6 - 2^-8) S - 0.98 tiny + 2^-125 < 0,
//    so x_k < y_k in f32 in every dimension: x dominates y. t > m gives
//    x_k > y_k the same way, which fails all(<=). An overflow of t to
//    +-inf keeps its sign and |t| > 2^-8 S. Any infinite xb or yb (a finite
//    f32 near its maximum can round to bf16 infinity) makes m infinite and
//    the pair undecided, and NaN fails every comparison: undecided. tiny is
//    bf16(1e-30) = 9.984e-31 (bits 0x0DA2); 2^-6 is 4x the 2^-8 bound, the
//    TPU kernel's _BF16_K_EPS. So the output equals the f32 kernel's, bit
//    for bit; the summary pass, the skip rule and the ring are shared.
// 8. predrop_kernel: the ≤ 512-row dominator prefix, rounded to bf16, in
//    shared memory (16 KB at d = 8); one victim a thread, the reference's
//    f32 arithmetic on the rounded values operation for operation
//    (__fadd_rn/__fmul_rn/__fsub_rn, so nothing is contracted), stopping at
//    the first certifying row. It writes one uint8 a victim. Bound: bytes
//    when the first rows certify (the north-star zeros), else the 5 f32
//    operations of each tested pair and dimension.
//
// Semantics match the plain PyTorch predicate (ops/dominance.py) bit for
// bit, NaN and infinities included: the predicate is written as
// all(<=) && any(<), never as min/max of differences. Build without
// --use_fast_math: flush-to-zero would turn a tiny x_k < y_k into equality.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 256;     // dominator rows per tile (== summary threads)
constexpr int THREADS = 128;  // threads per block of the compare kernel
constexpr int V = 2;          // victims per thread
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 3;     // tiles in flight in the shared-memory ring
constexpr int CHUNK = 2048;   // tile indices scanned per survivor list
constexpr unsigned FULL = 0xffffffffu;
// the bf16 margin of step 7: 2^-6 and bf16(1e-30), as bit patterns
constexpr unsigned short MP_EPS_BITS = 0x3C80;
constexpr unsigned short MP_TINY_BITS = 0x0DA2;
// the pre-drop (step 8): threads a block, dominator rows a shared chunk,
// and its f32 margin, the reference's _BF16_EPS and _BF16_TINY
constexpr int PRE_THREADS = 256;
constexpr int PRE_ROWS = 512;
constexpr float PRE_EPS = 0.0078125f;  // 2^-7
constexpr float PRE_TINY = 1e-30f;
static_assert(V == 2, "the bf16 first pass packs two victims a thread");

// floats per dominator row in shared memory (16-byte rows), and per summary
// (d bounds, then the sum, 16-byte aligned)
template <int D>
struct Geo {
  static constexpr int DP = (D + 3) / 4 * 4;
  static constexpr int SW = (D + 4) / 4 * 4;
};

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Coordinate sum in dimension order; dominators and victims share it, which
// is what makes rule (a) exact.
template <int D>
__device__ __forceinline__ float row_sum(const float* v) {
  float s = v[0];
#pragma unroll
  for (int k = 1; k < D; ++k) s = s + v[k];
  return s;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Reduce acc[0..D] across the block (op = fminf or fmaxf) and let threads
// 0..D write one summary row.
template <int D, int NT, bool MIN>
__device__ __forceinline__ void write_summary(float (&acc)[D + 1], float* dst) {
  __shared__ float red[NT / 32][D + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k <= D; ++k) {
    acc[k] = MIN ? warp_min(acc[k]) : warp_max(acc[k]);
    if (lane == 0) red[warp][k] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x <= D) {
    float m = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < NT / 32; ++w)
      m = MIN ? fminf(m, red[w][threadIdx.x]) : fmaxf(m, red[w][threadIdx.x]);
    dst[threadIdx.x] = m;
  }
}

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
  const int tid = threadIdx.x;
  float acc[D + 1];
  if ((int)blockIdx.x < ntiles) {
    const int t = blockIdx.x;
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
    const int b = blockIdx.x - ntiles;
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
__device__ __forceinline__ void load_summary(const float* __restrict__ ts,
                                             float (&lo)[Geo<D>::SW]) {
#pragma unroll
  for (int q = 0; q < Geo<D>::SW / 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(ts)[q];
    lo[4 * q] = f.x;
    lo[4 * q + 1] = f.y;
    lo[4 * q + 2] = f.z;
    lo[4 * q + 3] = f.w;
  }
}

// Step 2: true when no row of the tile summarised by lo (d minima, then the
// least sum) can dominate any victim of the set summarised by hi (d maxima,
// then the largest sum) — a block, or one victim (its coordinates and sum).
template <int D>
__device__ __forceinline__ bool skip_tile(const float* lo, const float* hi) {
  bool gt = lo[D] > hi[D];  // rule (a)
  bool ge = true;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    gt = gt | (lo[k] > hi[k]);  // rule (b)
    ge = ge & (lo[k] >= hi[k]);  // rule (c)
  }
  return gt | ge;
}

__device__ __forceinline__ __nv_bfloat162 bf16x2_of(unsigned short bits) {
  return __bfloat162bfloat162(__ushort_as_bfloat16(bits));
}

// Step 7: the bf16 classification of one dominator row a[] against the
// thread's two victims (yb: their bf16 values, low half victim 0; cy: their
// 2^-6 |yb| + tiny). Certain pairs set dom; need marks the undecided pairs
// of victims not yet dominated.
template <int D>
__device__ __forceinline__ void mp_classify(const float* a, const __nv_bfloat162 (&yb)[D],
                                            const __nv_bfloat162 (&cy)[D], bool (&dom)[V],
                                            bool (&need)[V]) {
  const __nv_bfloat162 eps = bf16x2_of(MP_EPS_BITS);
  bool lt0 = true, lt1 = true, gt0 = false, gt1 = false;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const __nv_bfloat162 xb = __float2bfloat162_rn(a[k]);
    const __nv_bfloat162 m = __hadd2(__hmul2(__habs2(xb), eps), cy[k]);
    const __nv_bfloat162 nm = __hneg2(m);
    const __nv_bfloat162 t = __hsub2(xb, yb[k]);
    lt0 = lt0 & __hlt(__low2bfloat16(t), __low2bfloat16(nm));
    lt1 = lt1 & __hlt(__high2bfloat16(t), __high2bfloat16(nm));
    gt0 = gt0 | __hgt(__low2bfloat16(t), __low2bfloat16(m));
    gt1 = gt1 | __hgt(__high2bfloat16(t), __high2bfloat16(m));
  }
  dom[0] = dom[0] | lt0;
  dom[1] = dom[1] | lt1;
  need[0] = !(lt0 | gt0) & !dom[0];
  need[1] = !(lt1 | gt1) & !dom[1];
}

// Step 5: every row of one tile against this thread's V victims; a warp
// whose victims are all decided stops (checked every 32 rows). MP: the bf16
// classification first, the f32 predicate for the undecided pairs only.
template <int D, bool MP>
__device__ __forceinline__ void compare_tile(const float4* __restrict__ tile,
                                             const float (&yv)[V][D + 1],
                                             const __nv_bfloat162 (&yb)[D],
                                             const __nv_bfloat162 (&cy)[D],
                                             const bool (&open)[V], bool (&dom)[V],
                                             bool& pending) {
  constexpr int Q = Geo<D>::DP / 4;
  for (int r0 = 0; r0 < TILE; r0 += 32) {
    if (!__any_sync(FULL, pending)) return;
#pragma unroll 4
    for (int r = r0; r < r0 + 32; ++r) {
      float a[4 * Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float4 f = tile[r * Q + q];
        a[4 * q] = f.x;
        a[4 * q + 1] = f.y;
        a[4 * q + 2] = f.z;
        a[4 * q + 3] = f.w;
      }
      if constexpr (MP) {
        bool need[V];
        mp_classify<D>(a, yb, cy, dom, need);
        if (__any_sync(FULL, need[0] | need[1])) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            bool le = need[v], lt = false;
#pragma unroll
            for (int k = 0; k < D; ++k) {
              le = le & (a[k] <= yv[v][k]);
              lt = lt | (a[k] < yv[v][k]);
            }
            dom[v] = dom[v] | (le & lt);
          }
        }
      } else {
        // all(<=) first; any(<) only where some lane of the warp found one:
        // on data that is not mostly duplicates that is rare, and d compares
        // a pair are saved
        bool le[V];
        bool any_le = false;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          le[v] = true;
#pragma unroll
          for (int k = 0; k < D; ++k) le[v] = le[v] & (a[k] <= yv[v][k]);
          any_le = any_le | le[v];
        }
        if (__any_sync(FULL, any_le)) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            bool lt = false;
#pragma unroll
            for (int k = 0; k < D; ++k) lt = lt | (a[k] < yv[v][k]);
            dom[v] = dom[v] | (le[v] & lt);
          }
        }
      }
    }
    pending = false;
#pragma unroll
    for (int v = 0; v < V; ++v) pending = pending | (open[v] & !dom[v]);
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
template <int D, bool MP>
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
  // MP: the victims' bf16 values, packed (low half victim 0), and their
  // share of the margin, 2^-6 |yb| + tiny (step 7)
  __nv_bfloat162 yb[D], cy[D];
  if constexpr (MP) {
    const __nv_bfloat162 eps = bf16x2_of(MP_EPS_BITS), tiny = bf16x2_of(MP_TINY_BITS);
#pragma unroll
    for (int k = 0; k < D; ++k) {
      yb[k] = __floats2bfloat162_rn(yv[0][k], yv[1][k]);
      cy[k] = __hadd2(__hmul2(__habs2(yb[k]), eps), tiny);
    }
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
        compare_tile<D, MP>(ring + (it % STAGES) * TILE_F4, yv, yb, cy, open, dom,
                            pending);
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

template <int D, bool MP>
cudaError_t launch_compare(const float* xr, const float* tsum, const float* bsum,
                           const float* y, uint8_t* out, int P, int ny, int ntiles,
                           int nblocks, cudaStream_t stream) {
  // above 48 KB, dynamic shared memory must be asked for
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      dominated_kernel<D, MP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dominated_kernel<D, MP><<<dim3(nblocks, P), THREADS, smem, stream>>>(
      xr, tsum, bsum, y, out, ny, ntiles, nblocks);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const float* x, const uint8_t* xv, const float* y, uint8_t* out,
                   float* xr, float* tsum, float* bsum, int P, int nx, int ny, bool mp,
                   cudaStream_t stream) {
  const int ntiles = (nx + TILE - 1) / TILE;
  const int nblocks = (ny + V * THREADS - 1) / (V * THREADS);
  summarize_kernel<D><<<dim3(ntiles + nblocks, P), TILE, 0, stream>>>(
      x, xv, y, xr, tsum, bsum, nx, ny, ntiles, nblocks, V * THREADS);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return mp ? launch_compare<D, true>(xr, tsum, bsum, y, out, P, ny, ntiles, nblocks,
                                      stream)
            : launch_compare<D, false>(xr, tsum, bsum, y, out, P, ny, ntiles, nblocks,
                                       stream);
}

// Step 8. grid (ceil(ny / PRE_THREADS), P): victim j of partition p is
// certainly strictly dominated by a valid dominator row, by the reference's
// strictly_dominated_bf16 arithmetic. y (P, ny, D) and x (P, nx, D)
// row-major; an invalid dominator's first coordinate is stored as NaN,
// which fails every margin test.
template <int D>
__global__ void __launch_bounds__(PRE_THREADS)
predrop_kernel(const float* __restrict__ y, const float* __restrict__ x,
               const uint8_t* __restrict__ xv, uint8_t* __restrict__ out, int nx, int ny) {
  __shared__ float xs[PRE_ROWS * D];
  const int p = blockIdx.y;
  const int j = blockIdx.x * PRE_THREADS + threadIdx.x;
  y += (size_t)p * ny * D;
  x += (size_t)p * nx * D;
  xv += (size_t)p * nx;
  const bool live = j < ny;
  float yb[D], ay[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    yb[k] = live ? __bfloat162float(__float2bfloat16_rn(y[(size_t)j * D + k])) : NAN;
    ay[k] = fabsf(yb[k]);
  }
  bool found = false;
  for (int c0 = 0; c0 < nx; c0 += PRE_ROWS) {
    const int rows = min(PRE_ROWS, nx - c0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int e = threadIdx.x; e < rows * D; e += PRE_THREADS) {
      float v = __bfloat162float(__float2bfloat16_rn(x[(size_t)c0 * D + e]));
      if (e % D == 0 && !xv[c0 + e / D]) v = NAN;
      xs[e] = v;
    }
    __syncthreads();
    for (int i = 0; i < rows && !found; ++i) {
      bool all = true;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float xb = xs[i * D + k];
        const float m =
            __fadd_rn(__fmul_rn(PRE_EPS, __fadd_rn(fabsf(xb), ay[k])), PRE_TINY);
        all = all & (__fsub_rn(yb[k], xb) > m);
      }
      found = all;
    }
  }
  if (live) out[(size_t)p * ny + j] = found ? 1 : 0;
}

template <int D>
cudaError_t launch_predrop(const float* y, const float* x, const uint8_t* xv, uint8_t* out,
                           int P, int nx, int ny, cudaStream_t stream) {
  const int blocks = (ny + PRE_THREADS - 1) / PRE_THREADS;
  predrop_kernel<D><<<dim3(blocks, P), PRE_THREADS, 0, stream>>>(y, x, xv, out, nx, ny);
  return cudaGetLastError();
}

}  // namespace

// x: (P, d, nx) f32, xv: (P, nx) uint8, y: (P, d, ny) f32, out: (P, ny)
// uint8, all contiguous on the device. Scratch, allocated by the caller:
// xr (P, ceil(nx / 256) * 256, dp) f32 with dp = d rounded up to 4; tsum
// (P, ceil(nx / 256), sw) and bsum (P, ceil(ny / 256), sw) f32 with sw =
// d + 1 rounded up to 4. mp != 0 launches the mixed-precision compare
// kernel. Launches the summary pass and the compare kernel on ``stream``
// without synchronising and returns cudaGetLastError() of the launches.
extern "C" int skyline_dominated(const float* x, const uint8_t* xv, const float* y,
                                 uint8_t* out, float* xr, float* tsum, float* bsum,
                                 int P, int d, int nx, int ny, int mp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define SKYLINE_CASE(D) \
  case D:               \
    return (int)launch<D>(x, xv, y, out, xr, tsum, bsum, P, nx, ny, mp != 0, s);
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
// dominators, row-major, xv (P, nx) uint8 validity, out (P, ny) uint8, all
// contiguous on the device. Launches on ``stream`` without synchronising
// and returns cudaGetLastError() of the launch.
extern "C" int skyline_predrop(const float* y, const float* x, const uint8_t* xv,
                               uint8_t* out, int P, int d, int nx, int ny, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define SKYLINE_CASE(D) \
  case D:               \
    return (int)launch_predrop<D>(y, x, xv, out, P, nx, ny, s);
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
