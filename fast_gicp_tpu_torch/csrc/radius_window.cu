// Adaptive-radius neighbourhoods: counts within each ladder radius, then
// hard-window moments at each query's own radius; one thread per query.
//
// Replaces fast_gicp_tpu/ops/pallas_kernels.py::_count_kernel and
// ::_window_kernel (reached through radius_window_moments_T, for the
// "adaptive" covariance estimator).  Both work on centered coordinates
// (query and target minus the cloud's mean), with masked points parked at
// MASK_COORD, and both round
//   d^2 = ((q0 - t0)^2 + (q1 - t1)^2) + (q2 - t2)^2
// in that order (explicitly rounded operations, no FMA contraction), so a
// count or a window decision equals the plain version's exactly.
//   radius_count: cnt (L, nq) = for each query and rung l, the number of
//     targets with d^2 <= r2[l] (L <= 32).
//   radius_window: out (16, nq) = [n, sum y (3), sum y y^T (9, row-major),
//     0 (3)] over the targets with d^2 <= r2q[query], y = target * valid
//     (masked targets add nothing).  The sums are full f32: the finalize
//     about the cloud mean cancels ~|y|^2 down to ~|window|^2, so a reduced
//     precision would leave O(1) relative error on the covariance.
// Rows of masked queries carry no meaning.
//
// Bound on an H100: the FP32 operations the functions need.  The count: for
// each pair inside the largest radius, d^2 (8), the rung it falls in (a
// binary search of the ladder, ceil(log2(L + 1)) compares) and one
// increment, then a prefix sum of L a query.  The window: for each pair
// inside its window, d^2, the compare, 6 products and 10 sums.
// Design: fgt_radius_boxes writes the bounding box of the valid points of
// each 128-target tile, once a target cloud; the count and the window both
// read it.  A block of 128 queries takes the box of its valid queries and
// visits only the tiles whose squared box gap is <= its largest radius (the
// ladder's largest rung for the count, its valid queries' largest r2q for
// the window); the gap is rounded like d^2 (tile_cull.cuh), so the cull
// drops no pair inside any radius.  A visited tile is staged in shared
// memory and read by broadcast.  Each thread keeps its L counters (fully
// unrolled, registers; a compare a rung for each pair in range, not the
// bound's search) or its 10 distinct moment sums in registers, adding
// targets in index order.  One thread a query leaves ~5 warps on an SM at
// full width (22,528 queries), so the scan is bound by latency, not by the
// FP32 rate: on an H100 at the full-size synthetic pair a count takes
// 1.59 ms (550x its 2.9 us bound) and a window 0.27 ms (410x its 0.67 us
// byte bound).

#include <cuda_runtime.h>

#include "tile_cull.cuh"

namespace {

constexpr int kThreads = kTile;  // queries per block == targets per tile
constexpr int kWarps = kTileWarps;
constexpr int kMaxRungs = 32;

__global__ void __launch_bounds__(kThreads)
    radius_count_kernel(const float4* __restrict__ q, const float4* __restrict__ t,
                        const float* __restrict__ boxes, const float* __restrict__ r2,
                        int L, int nq, int nt, float* __restrict__ cnt) {
  __shared__ float4 tile[kThreads];
  __shared__ float scratch[6][kWarps];
  __shared__ float qbox[6];
  __shared__ float rung[kMaxRungs];
  if (threadIdx.x < kMaxRungs) rung[threadIdx.x] = threadIdx.x < L ? r2[threadIdx.x] : 0.f;

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float4 qi = i < nq ? q[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  block_bbox(qi, i < nq && qi.w != 0.f, scratch, qbox);  // also publishes rung
  float r2max = rung[0];
  for (int l = 1; l < L; ++l) r2max = fmaxf(r2max, rung[l]);

  int c[kMaxRungs];
#pragma unroll
  for (int l = 0; l < kMaxRungs; ++l) c[l] = 0;
  const int tiles = (nt + kThreads - 1) / kThreads;
  for (int tt = 0; tt < tiles; ++tt) {
    if (!(box_gap2(qbox, boxes + 6 * tt) <= r2max)) continue;  // uniform across the block
    const int base = tt * kThreads;
    const int j = base + threadIdx.x;
    tile[threadIdx.x] = j < nt ? t[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    const int n = min(kThreads, nt - base);
    for (int m = 0; m < n; ++m) {
      const float d2 = sq_dist(qi, tile[m]);
      if (d2 <= r2max) {
#pragma unroll
        for (int l = 0; l < kMaxRungs; ++l)
          if (l < L) c[l] += d2 <= rung[l] ? 1 : 0;
      }
    }
    __syncthreads();
  }
  if (i < nq) {
#pragma unroll
    for (int l = 0; l < kMaxRungs; ++l)
      if (l < L) cnt[(size_t)l * nq + i] = static_cast<float>(c[l]);
  }
}

__global__ void __launch_bounds__(kThreads)
    radius_window_kernel(const float4* __restrict__ q, const float4* __restrict__ t,
                         const float* __restrict__ boxes, const float* __restrict__ r2q,
                         int nq, int nt, float* __restrict__ out) {
  __shared__ float4 tile[kThreads];
  __shared__ float scratch[7][kWarps];
  __shared__ float qbox[7];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float4 qi = i < nq ? q[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float r2 = i < nq ? r2q[i] : 0.f;
  // the valid queries' box and, in qbox[6], their largest window
  block_bbox<7>(qi, i < nq && qi.w != 0.f, scratch, qbox, r2);
  const float bound = qbox[6];

  float acc[10];
#pragma unroll
  for (int a = 0; a < 10; ++a) acc[a] = 0.f;
  const int tiles = (nt + kThreads - 1) / kThreads;
  for (int tt = 0; tt < tiles; ++tt) {
    if (!(box_gap2(qbox, boxes + 6 * tt) <= bound)) continue;  // uniform across the block
    const int base = tt * kThreads;
    const int j = base + threadIdx.x;
    tile[threadIdx.x] = j < nt ? t[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    const int n = min(kThreads, nt - base);
    for (int m = 0; m < n; ++m) {
      const float4 y = tile[m];
      if (sq_dist(qi, y) <= r2) {
        const float v = y.w;
        const float y0 = y.x * v, y1 = y.y * v, y2 = y.z * v;
        acc[0] += v;
        acc[1] += y0;
        acc[2] += y1;
        acc[3] += y2;
        acc[4] += y0 * y0;
        acc[5] += y0 * y1;
        acc[6] += y0 * y2;
        acc[7] += y1 * y1;
        acc[8] += y1 * y2;
        acc[9] += y2 * y2;
      }
    }
    __syncthreads();
  }
  if (i < nq) {
    // rows [n, y (3), yy^T row-major (9), 0 (3)]; y_a y_b == y_b y_a
    const float rows[16] = {acc[0], acc[1], acc[2], acc[3], acc[4], acc[5], acc[6], acc[5],
                            acc[7], acc[8], acc[6], acc[8], acc[9], 0.f,    0.f,    0.f};
#pragma unroll
    for (int r = 0; r < 16; ++r) out[(size_t)r * nq + i] = rows[r];
  }
}

}  // namespace

// t: (nt, 4) float32 [x, y, z, valid] centered, masked targets parked at
// MASK_COORD.  boxes: (6 * ceil(nt / 128),) float32, the box of each
// 128-target tile's valid points, which the count and the window read.
// One launch on `stream`; returns cudaGetLastError().
extern "C" int fgt_radius_boxes(const float* t, int nt, float* boxes, void* stream) {
  const int tiles = (nt + kThreads - 1) / kThreads;
  if (tiles > 0)
    tile_bbox_kernel<true><<<tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(t), nt, boxes);
  return static_cast<int>(cudaGetLastError());
}

// q: (nq, 4) float32 [x, y, z, valid] centered, masked queries parked at
// MASK_COORD; t as above, and boxes from fgt_radius_boxes on it.  r2: (L,)
// float32 with 1 <= L <= 32.  cnt: (L, nq) float32.  One launch on
// `stream`; returns cudaGetLastError().
extern "C" int fgt_radius_count(const float* q, const float* t, const float* boxes,
                                const float* r2, int L, int nq, int nt, float* cnt,
                                void* stream) {
  const int blocks = (nq + kThreads - 1) / kThreads;
  if (blocks > 0 && nt > 0)
    radius_count_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(q), reinterpret_cast<const float4*>(t), boxes, r2, L,
        nq, nt, cnt);
  return static_cast<int>(cudaGetLastError());
}

// q, t and boxes as above; r2q: (nq,) float32 squared window radius a
// query.  out: (16, nq) float32.  One launch on `stream`; returns
// cudaGetLastError().
extern "C" int fgt_radius_window(const float* q, const float* t, const float* boxes,
                                 const float* r2q, int nq, int nt, float* out,
                                 void* stream) {
  const int blocks = (nq + kThreads - 1) / kThreads;
  if (blocks > 0 && nt > 0)
    radius_window_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(q), reinterpret_cast<const float4*>(t), boxes, r2q,
        nq, nt, out);
  return static_cast<int>(cudaGetLastError());
}
