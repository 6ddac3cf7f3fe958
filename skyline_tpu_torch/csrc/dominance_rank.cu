// Rank-cascade dominance kernel for Hopper (sm_90a).
//
// out[p, j] = some valid x[p, :, i] dominates y[p, :, j] in dense-rank space,
// for an optional leading partition dimension p: rows 0..d-1 hold
// per-dimension dense ranks over one compared universe and row d their int32
// sum, so
//
//   x dominates y  <=>  all_k(rx_k <= ry_k)  and  rsum_x < rsum_y
//
// (all-<= with equal sums forces equality in every dimension). The kernel
// and its plain version take any int32 (d+1, N) tensor as given and apply
// exactly this predicate; the sum row need not be the sum of the rank rows
// (the SFS rounds' invalid tail victims carry one large rank in every row,
// the sum row included). One kernel serves three entry points of
// skyline_tpu_torch/ops/dominance_kernels.py:
//
//   K5 dominated_by_any_rank  (x == y, one set)  replaces skyline_tpu/ops/
//        pallas_dominance.py dominated_by_any_rank_pallas (_kernel_rank_tri,
//        _kernel_rank, _dom_tile_rank, _tile_rank_skip)
//   K6 dominated_by_rank_rect (rectangular)      replaces dominated_by_rank_pallas
//   K7 skyline_mask_rank_kernel (sum-sort, K4 rank_transform, K5, unsort)
//        replaces skyline_mask_rank_pallas
//
// Layout at the surface follows the TPU kernels: ranks transposed as
// (P, d+1, N) int32; validity one uint8 per dominator.
//
// What bounds it: INT32 compares over the pairs the data needs, d + 1 a pair
// (Hopper issues INT32 compares at half the FP32 rate: 64 results per clock
// per SM, CUDA C++ Programming Guide, arithmetic instruction throughput,
// compute capability 9.0), for the pairs no summary can rule out; the inputs
// are a few MB, so bytes bound it only when almost every pair is skipped.
// The design is the value kernel's (dominance.cu), in rank space:
//
// 1. A summary pass (rank_summarize_kernel) ahead of the compare loop. For
//    every dominator tile of TILE rows: lo_k, the per-dimension minimum rank
//    over its valid rows (INT_MAX when there are none), and the minimum
//    valid rank sum (invalid rows INT_MAX). For every victim block of
//    V * THREADS victims: hi_k, the per-dimension maximum over its live
//    victims (j < ny; invalid victims count, since the plain version answers
//    for them too), and the maximum rank sum. The same pass writes the
//    dominators row-major, 16-byte aligned (RP ints a row: d ranks, the sum,
//    padding; 12 ints = three LDS.128 at d = 8) and padded to whole tiles,
//    with every row that cannot dominate (invalid, or past nx) given rank
//    sum INT_MAX, which is never < any victim's sum.
// 2. The exact skip rule. A (block, tile) pair is skipped when
//      (a) tile_min_rsum >= block_max_rsum, or
//      (b) lo_k > hi_k for some k.
//    Proof. Only valid rows of the tile can dominate (an invalid row's sum is
//    INT_MAX in the row-major copy, and x_sum < y_sum fails for it). For a
//    valid x in the tile and any live y in the block: (a) x_sum >= tmin >=
//    bmax >= y_sum, so x_sum < y_sum fails; (b) x_k >= lo_k > hi_k >= y_k, so
//    x_k <= y_k fails. Both use exact int32 order and no arithmetic, so they
//    hold for any int32 input: no subtraction anywhere (rank sums reach
//    ~2^25 and more once old skylines join the universe). A tile with no
//    valid row has tmin = INT_MAX and is skipped by (a). The value kernel's
//    rule (c), lo_k >= hi_k in every k, is NOT exact here: two rows with
//    equal ranks whose sum rows differ do dominate under the predicate
//    above. Where the sum row is the true sum, (a) already covers what (c)
//    would skip. No tile is skipped by its index: a dominator may sort after
//    its victim when value sums tie (dominance.cu).
// 3. Each block scans its summary against every tile summary (CHUNK at a
//    time), compacts the surviving tile indices in order with a ballot, a
//    popcount and a prefix across warps, and walks only those. A skipped
//    tile costs one summary test, not a load and two barriers. During the
//    walk each lane tests the tile's summary once more against each of its
//    undecided victims alone (a set of one, so the proof holds), and a warp
//    compares the tile only if some victim survives that test: a block of
//    zero-rank victims beside a few invalid tail victims (huge ranks and
//    sums, so the block test never skips) stops comparing once the tail
//    victims are dominated.
// 4. The walk streams surviving tiles through a ring of STAGES shared-memory
//    stages filled by cp.async (16-byte copies, no registers spent), so the
//    next tile loads while the current one is compared; a row is read as
//    RP/4 16-byte broadcasts.
// 5. Each thread holds V = 2 victims in registers (d is a template
//    parameter), so each dominator row read from shared memory serves V
//    pairs. The all(<=) chain goes first and the sum compare runs only in
//    rows where some lane of the warp found all(<=): the other order (the
//    one sum compare first, the chain where a lane found a smaller sum) was
//    slower on the plane and uniform inputs on the H100, since in a warp of
//    64 victims some sum is nearly always larger. Dynamic shared memory is
//    STAGES tiles and the survivor list: 44 KB at d = 8, 68 KB at d = 16.
//    chip_smoke.py prints the registers, shared memory and spills of every
//    instantiation.
// 6. A warp whose victims are all decided stops comparing (checked every 32
//    rows) but keeps the ring's barriers; the block stops when all its
//    victims are decided. Nothing is carried between blocks, so the output
//    needs no atomics.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int TILE = 256;     // dominator rows per tile (== summary threads)
constexpr int THREADS = 128;  // threads per block of the compare kernel
constexpr int V = 2;          // victims per thread
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 3;     // tiles in flight in the shared-memory ring
constexpr int CHUNK = 2048;   // tile indices scanned per survivor list
constexpr unsigned FULL = 0xffffffffu;

// ints per dominator row in shared memory and per summary: d ranks (or
// bounds), then the sum (or its bound), padded to 16 bytes
template <int D>
struct Geo {
  static constexpr int RP = (D + 4) / 4 * 4;
};

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

// Reduce acc[0..D] across the block (minimum or maximum) and let threads
// 0..D write one summary row.
template <int D, int NT, bool MIN>
__device__ __forceinline__ void write_summary(int32_t (&acc)[D + 1], int32_t* dst) {
  __shared__ int32_t red[NT / 32][D + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k <= D; ++k) {
    acc[k] = MIN ? __reduce_min_sync(FULL, acc[k]) : __reduce_max_sync(FULL, acc[k]);
    if (lane == 0) red[warp][k] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x <= D) {
    int32_t m = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < NT / 32; ++w)
      m = MIN ? min(m, red[w][threadIdx.x]) : max(m, red[w][threadIdx.x]);
    dst[threadIdx.x] = m;
  }
}

// Step 1. grid (ntiles + nblocks, P), TILE threads: blocks below ntiles
// summarise a dominator tile and write its rows row-major into xr; the rest
// summarise a victim block of bv victims.
template <int D>
__global__ void __launch_bounds__(TILE)
rank_summarize_kernel(const int32_t* __restrict__ x, const uint8_t* __restrict__ xv,
                      const int32_t* __restrict__ y, int32_t* __restrict__ xr,
                      int32_t* __restrict__ tsum, int32_t* __restrict__ bsum, int nx,
                      int ny, int ntiles, int nblocks, int bv) {
  constexpr int RP = Geo<D>::RP;
  const int p = blockIdx.y;
  const int tid = threadIdx.x;
  int32_t acc[D + 1];
  if ((int)blockIdx.x < ntiles) {
    const int t = blockIdx.x;
    const int i = t * TILE + tid;
    x += (size_t)p * (D + 1) * nx;
    xv += (size_t)p * nx;
    int32_t v[RP];
#pragma unroll
    for (int k = 0; k < RP; ++k) v[k] = 0;
    const bool ok = i < nx && xv[i];
    if (i < nx) {
#pragma unroll
      for (int k = 0; k < D; ++k) v[k] = x[(size_t)k * nx + i];
    }
    // a row that cannot dominate gets the largest sum: x_sum < y_sum fails
    v[D] = ok ? x[(size_t)D * nx + i] : INT_MAX;
#pragma unroll
    for (int k = 0; k < D; ++k) acc[k] = ok ? v[k] : INT_MAX;
    acc[D] = v[D];
    int4* dst = reinterpret_cast<int4*>(xr + ((size_t)p * ntiles * TILE + i) * RP);
#pragma unroll
    for (int q = 0; q < RP / 4; ++q)
      dst[q] = make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    write_summary<D, TILE, true>(acc, tsum + ((size_t)p * ntiles + t) * RP);
  } else {
    const int b = blockIdx.x - ntiles;
    y += (size_t)p * (D + 1) * ny;
#pragma unroll
    for (int k = 0; k <= D; ++k) acc[k] = INT_MIN;
    const int end = min(ny, (b + 1) * bv);
    for (int j = b * bv + tid; j < end; j += TILE) {
#pragma unroll
      for (int k = 0; k <= D; ++k) acc[k] = max(acc[k], y[(size_t)k * ny + j]);
    }
    write_summary<D, TILE, false>(acc, bsum + ((size_t)p * nblocks + b) * RP);
  }
}

template <int D>
__device__ __forceinline__ void load_summary(const int32_t* __restrict__ ts,
                                             int32_t (&lo)[Geo<D>::RP]) {
#pragma unroll
  for (int q = 0; q < Geo<D>::RP / 4; ++q) {
    const int4 f = reinterpret_cast<const int4*>(ts)[q];
    lo[4 * q] = f.x;
    lo[4 * q + 1] = f.y;
    lo[4 * q + 2] = f.z;
    lo[4 * q + 3] = f.w;
  }
}

// Step 2: true when no row of the tile summarised by lo (d minima, then the
// least valid sum) can dominate any victim of the set summarised by hi (d
// maxima, then the largest sum) — a block, or one victim (its ranks and sum).
template <int D>
__device__ __forceinline__ bool skip_tile(const int32_t* lo, const int32_t* hi) {
  bool skip = lo[D] >= hi[D];  // rule (a)
#pragma unroll
  for (int k = 0; k < D; ++k) skip = skip | (lo[k] > hi[k]);  // rule (b)
  return skip;
}

// Step 5: every row of one tile against this thread's V victims; a warp
// whose victims are all decided stops (checked every 32 rows).
template <int D>
__device__ __forceinline__ void compare_tile(const int4* __restrict__ tile,
                                             const int32_t (&yv)[V][D + 1],
                                             const bool (&open)[V], bool (&dom)[V],
                                             bool& pending) {
  constexpr int Q = Geo<D>::RP / 4;
  for (int r0 = 0; r0 < TILE; r0 += 32) {
    if (!__any_sync(FULL, pending)) return;
#pragma unroll 4
    for (int r = r0; r < r0 + 32; ++r) {
      int32_t a[4 * Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int4 f = tile[r * Q + q];
        a[4 * q] = f.x;
        a[4 * q + 1] = f.y;
        a[4 * q + 2] = f.z;
        a[4 * q + 3] = f.w;
      }
      // all(<=) first; the sum only where some lane of the warp found one
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
        for (int v = 0; v < V; ++v) dom[v] = dom[v] | (le[v] & (a[D] < yv[v][D]));
      }
    }
    pending = false;
#pragma unroll
    for (int v = 0; v < V; ++v) pending = pending | (open[v] & !dom[v]);
  }
}

template <int D>
__device__ __forceinline__ void load_tile(int4* dst, const int32_t* src) {
  constexpr int I4 = TILE * Geo<D>::RP / 4;
  const int4* s = reinterpret_cast<const int4*>(src);
  for (int c = threadIdx.x; c < I4; c += THREADS) cp_async16(dst + c, s + c);
}

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)STAGES * TILE * Geo<D>::RP * sizeof(int32_t) + CHUNK * sizeof(int);
}

// Steps 3-6. grid (nblocks, P), THREADS threads; block b owns victims
// [b * V * THREADS, (b + 1) * V * THREADS), warp w the 32 * V consecutive
// ones from b * V * THREADS + w * 32 * V, lane l of them l, l + 32, ...
// (coalesced loads per row).
template <int D>
__global__ void __launch_bounds__(THREADS)
rank_dominated_kernel(const int32_t* __restrict__ xr, const int32_t* __restrict__ tsum,
                      const int32_t* __restrict__ bsum, const int32_t* __restrict__ y,
                      uint8_t* __restrict__ out, int ny, int ntiles, int nblocks) {
  constexpr int RP = Geo<D>::RP;
  constexpr int TILE_I4 = TILE * RP / 4;
  extern __shared__ int4 smem[];
  int4* ring = smem;
  int* list = reinterpret_cast<int*>(smem + STAGES * TILE_I4);
  __shared__ int warp_cnt[WARPS];

  const int p = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  xr += (size_t)p * ntiles * TILE * RP;
  tsum += (size_t)p * ntiles * RP;
  const int32_t* bs = bsum + ((size_t)p * nblocks + blockIdx.x) * RP;
  y += (size_t)p * (D + 1) * ny;
  out += (size_t)p * ny;
  const int j0 = blockIdx.x * V * THREADS + warp * 32 * V + lane;

  // each victim's ranks, then its sum; open: live, so it has an answer
  int32_t yv[V][D + 1];
  bool open[V];
  bool dom[V];
  bool pending = false;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int j = j0 + v * 32;
    open[v] = j < ny;
#pragma unroll
    for (int k = 0; k <= D; ++k) yv[v][k] = open[v] ? y[(size_t)k * ny + j] : 0;
    dom[v] = false;
    pending = pending | open[v];
  }
  int32_t hi[RP];
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
        int32_t lo[RP];
        load_summary<D>(tsum + (size_t)t * RP, lo);
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
      if (s < kept) load_tile<D>(ring + s * TILE_I4, xr + (size_t)list[s] * TILE * RP);
      cp_async_commit();
    }
    for (int it = 0; it < kept; ++it) {
      const int nxt = it + STAGES - 1;
      if (nxt < kept)
        load_tile<D>(ring + (nxt % STAGES) * TILE_I4, xr + (size_t)list[nxt] * TILE * RP);
      cp_async_commit();
      cp_async_wait<STAGES - 1>();  // tile `it` has landed (this thread's part)
      __syncthreads();              // ... and every thread's
      int32_t lo[RP];
      load_summary<D>(tsum + (size_t)list[it] * RP, lo);
      bool need = false;
#pragma unroll
      for (int v = 0; v < V; ++v)
        need = need | (open[v] & !dom[v] & !skip_tile<D>(lo, yv[v]));
      if (__any_sync(FULL, need))
        compare_tile<D>(ring + (it % STAGES) * TILE_I4, yv, open, dom, pending);
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
cudaError_t launch(const int32_t* x, const uint8_t* xv, const int32_t* y, uint8_t* out,
                   int32_t* xr, int32_t* tsum, int32_t* bsum, int P, int nx, int ny,
                   cudaStream_t stream) {
  const int ntiles = (nx + TILE - 1) / TILE;
  const int nblocks = (ny + V * THREADS - 1) / (V * THREADS);
  rank_summarize_kernel<D><<<dim3(ntiles + nblocks, P), TILE, 0, stream>>>(
      x, xv, y, xr, tsum, bsum, nx, ny, ntiles, nblocks, V * THREADS);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // above 48 KB, dynamic shared memory must be asked for
  const size_t smem = smem_bytes<D>();
  err = cudaFuncSetAttribute(rank_dominated_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  rank_dominated_kernel<D><<<dim3(nblocks, P), THREADS, smem, stream>>>(
      xr, tsum, bsum, y, out, ny, ntiles, nblocks);
  return cudaGetLastError();
}

}  // namespace

// x: (P, d+1, nx) int32, xv: (P, nx) uint8, y: (P, d+1, ny) int32, out:
// (P, ny) uint8, all contiguous on the device; d counts the rank rows (the
// sum row comes on top). Scratch, allocated by the caller: xr (P,
// ceil(nx / 256) * 256, rp), tsum (P, ceil(nx / 256), rp) and bsum (P,
// ceil(ny / 256), rp) int32 with rp = d + 1 rounded up to 4. Launches the
// summary pass and the compare kernel on ``stream`` without synchronising
// and returns cudaGetLastError() of the launches.
extern "C" int skyline_rank_dominated(const int32_t* x, const uint8_t* xv,
                                      const int32_t* y, uint8_t* out, int32_t* xr,
                                      int32_t* tsum, int32_t* bsum, int P, int d, int nx,
                                      int ny, void* stream) {
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

extern "C" const char* skyline_rank_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
