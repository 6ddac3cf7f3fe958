// Device code shared by the value kernels (dominance.cu) and the device
// cascade's scan (cascade.cu): the geometry, the warp reductions, the
// summaries and the exact tile skip (dominance.cu steps 1-2), the f32
// compare of one tile against a thread's victims (step 5), and the bf16
// pre-drop's rounding, skip and certified compare (step 8). Each source
// includes it in its own unnamed namespace; the step numbers refer to
// dominance.cu's header.

#pragma once

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
// the pre-drop's f32 margin (step 8), the reference's _BF16_EPS and
// _BF16_TINY
constexpr float PRE_EPS = 0.0078125f;  // 2^-7
constexpr float PRE_TINY = 1e-30f;

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

// Step 5: every row of one tile against this thread's V victims; a warp
// whose victims are all decided stops (checked every 32 rows).
template <int D>
__device__ __forceinline__ void compare_tile(const float4* __restrict__ tile,
                                             const float (&yv)[V][D + 1],
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
    pending = false;
#pragma unroll
    for (int v = 0; v < V; ++v) pending = pending | (open[v] & !dom[v]);
  }
}

// Step 8: the pre-drop. bf16r rounds to bf16 (nearest even, the reference's
// convert) and back to f32.
__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// True when no dominator of the tile summarised by lo (d minima of the
// rounded coordinates, then the least rounded sum) can certify any victim
// of the set summarised by hi (d maxima, then the greatest sum) — a block,
// or one victim: rules (a') and (b').
template <int D>
__device__ __forceinline__ bool predrop_skip(const float* lo, const float* hi) {
  bool skip = lo[D] > hi[D];  // (b')
#pragma unroll
  for (int k = 0; k < D; ++k) skip = skip | (lo[k] >= hi[k]);  // (a')
  return skip;
}

// Every row of one tile against the thread's V victims (yb: rounded, then
// the rounded sum), for the victims in need: first the necessary condition
// yb_k > xb_k in every k (one compare a dimension), then, where some lane
// of the warp passed it, the reference's margin test operation for
// operation. A warp stops when none of its victims in need is undecided
// (checked every 32 rows).
template <int D>
__device__ __forceinline__ void predrop_tile(const float4* __restrict__ tile,
                                             const float (&yb)[V][D + 1],
                                             const bool (&need)[V], bool (&found)[V]) {
  constexpr int Q = Geo<D>::DP / 4;
  for (int r0 = 0; r0 < TILE; r0 += 32) {
    bool live = false;
#pragma unroll
    for (int v = 0; v < V; ++v) live = live | (need[v] & !found[v]);
    if (!__any_sync(FULL, live)) return;
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
      bool gt[V];
      bool any_gt = false;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        gt[v] = need[v] & !found[v];
#pragma unroll
        for (int k = 0; k < D; ++k) gt[v] = gt[v] & (yb[v][k] > a[k]);
        any_gt = any_gt | gt[v];
      }
      if (__any_sync(FULL, any_gt)) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          bool cert = gt[v];
#pragma unroll
          for (int k = 0; k < D; ++k) {
            const float m = __fadd_rn(
                __fmul_rn(PRE_EPS, __fadd_rn(fabsf(a[k]), fabsf(yb[v][k]))), PRE_TINY);
            cert = cert & (__fsub_rn(yb[v][k], a[k]) > m);
          }
          found[v] = found[v] | cert;
        }
      }
    }
  }
}

}  // namespace
