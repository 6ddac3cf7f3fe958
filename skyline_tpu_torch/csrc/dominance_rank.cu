// Rank-cascade dominance kernels for Hopper (sm_90a).
//
// out[p, j] = some valid x[p, :, i] dominates y[p, :, j] in dense-rank space:
// rows 0..d-1 hold per-dimension dense ranks over one compared universe and
// row d holds their int32 sum, so
//
//   x dominates y  <=>  all_k(rx_k <= ry_k)  and  rsum_x < rsum_y
//
// (all-<= with equal sums forces equality in every dimension). One kernel
// serves three entry points of skyline_tpu_torch/ops/dominance_kernels.py:
//
//   K5 dominated_by_any_rank  (x == y, one set)  replaces skyline_tpu/ops/
//        pallas_dominance.py dominated_by_any_rank_pallas (_kernel_rank_tri,
//        _kernel_rank, _dom_tile_rank, _tile_rank_skip)
//   K6 dominated_by_rank_rect (rectangular)      replaces dominated_by_rank_pallas
//   K7 skyline_mask_rank_kernel (sum-sort, K4 rank_transform, K5, unsort)
//        replaces skyline_mask_rank_pallas
//
// Layout follows the TPU kernels: ranks transposed as (P, d+1, N) int32 so a
// dimension's ranks are contiguous; validity is one uint8 per dominator.
//
// What bounds it on the H100: integer compare issue rate, pairs x (d+1)
// compares. Every pair costs d+1 shared-memory broadcast loads and d+1
// INT32 compares, and Hopper issues INT32 compares at half the FP32 rate
// (64 vs 128 results per clock per SM, CUDA C++ Programming Guide,
// arithmetic instruction throughput, compute capability 9.0). So per pair
// this kernel may be no faster than the value kernel (dominance.cu), though
// it needs fewer operations than the TPU's VPU form. The inputs are a few
// MB, so bytes never bound it. The design is the value kernel's:
//   - a block owns TILE victims, one per thread, ranks in registers (d is a
//     template parameter);
//   - the block walks the dominator set in TILE-row shared-memory tiles, the
//     loop that replaces the TPU's sequential grid axis; nothing is carried
//     between blocks, so the output needs no atomics;
//   - a dominator tile is skipped when its smallest valid rank sum is >= the
//     block's largest victim rank sum (_tile_rank_skip): domination needs
//     rsum_x < rsum_y strictly, and int32 sums are exact, so the skip is
//     exact. Duplicate rows share a rank sum, so a block of duplicates skips
//     every tile of its own duplicates. There is no skip by tile index (see
//     dominance.cu: a dominator may sort after its victim);
//   - the block stops as soon as every victim in it is dominated.
// The predicate has no subtraction: rank sums reach ~2^25 and more once old
// skylines join the universe, and every rank and sum stays int32.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int TILE = 256;  // victims per block == dominator rows per tile
constexpr int WARPS = TILE / 32;

template <int D>
__global__ void __launch_bounds__(TILE)
rank_dominated_kernel(const int32_t* __restrict__ x,
                      const uint8_t* __restrict__ xv,
                      const int32_t* __restrict__ y, uint8_t* __restrict__ out,
                      int nx, int ny) {
  constexpr int R = D + 1;  // rank rows plus the rank-sum row
  __shared__ int32_t sx[R][TILE];
  __shared__ int32_t red_max[WARPS];
  __shared__ int32_t red_min[WARPS];

  const int p = blockIdx.y;
  x += (size_t)p * R * nx;
  xv += (size_t)p * nx;
  y += (size_t)p * R * ny;
  out += (size_t)p * ny;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j = blockIdx.x * TILE + tid;
  const bool live = j < ny;

  int32_t yv[R];
#pragma unroll
  for (int k = 0; k < R; ++k) yv[k] = live ? y[(size_t)k * ny + j] : 0;
  int32_t vmax = __reduce_max_sync(0xffffffffu, live ? yv[D] : INT_MIN);
  if (lane == 0) red_max[warp] = vmax;
  __syncthreads();
  int32_t bmax = red_max[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) bmax = max(bmax, red_max[w]);

  bool done = !live;
  for (int t = 0; t < nx; t += TILE) {
    const int i = t + tid;
    // an invalid or missing dominator gets the largest rank sum: no victim
    // sum is greater, so it never dominates and leaves the tile minimum
    int32_t s = INT_MAX;
    if (i < nx) {
#pragma unroll
      for (int k = 0; k < D; ++k) sx[k][tid] = x[(size_t)k * nx + i];
      if (xv[i]) s = x[(size_t)D * nx + i];
    }
    sx[D][tid] = s;
    s = __reduce_min_sync(0xffffffffu, s);
    if (lane == 0) red_min[warp] = s;
    __syncthreads();
    int32_t tmin = red_min[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) tmin = min(tmin, red_min[w]);
    if (tmin < bmax && !done) {
      const int lim = min(TILE, nx - t);
      for (int r = 0; r < lim; ++r) {
        bool dom = sx[D][r] < yv[D];
#pragma unroll
        for (int k = 0; k < D; ++k) dom = dom & (sx[k][r] <= yv[k]);
        if (dom) {
          done = true;
          break;
        }
      }
    }
    // also the barrier before the next tile overwrites shared memory
    if (__syncthreads_and(done)) break;
  }
  if (live) out[j] = done ? 1 : 0;
}

template <int D>
void launch(const int32_t* x, const uint8_t* xv, const int32_t* y,
            uint8_t* out, int P, int nx, int ny, cudaStream_t stream) {
  dim3 grid((ny + TILE - 1) / TILE, P);
  rank_dominated_kernel<D><<<grid, TILE, 0, stream>>>(x, xv, y, out, nx, ny);
}

}  // namespace

// x: (P, d+1, nx) int32, xv: (P, nx) uint8, y: (P, d+1, ny) int32, out:
// (P, ny) uint8, all contiguous on the device; d counts the rank rows (the
// sum row comes on top). Launches on ``stream`` without synchronising and
// returns cudaGetLastError() of the launch.
extern "C" int skyline_rank_dominated(const int32_t* x, const uint8_t* xv,
                                      const int32_t* y, uint8_t* out, int P,
                                      int d, int nx, int ny, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define SKYLINE_CASE(D) \
  case D:               \
    launch<D>(x, xv, y, out, P, nx, ny, s); \
    break;
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
  return (int)cudaGetLastError();
}

extern "C" const char* skyline_rank_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
