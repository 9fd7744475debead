// Device code shared by the tile-culled point-pair kernels (rbf_moments.cu,
// nn_search.cu, radius_window.cu): warp reductions, the bounding box of the
// points a block or a warp holds, the squared gap between two boxes or
// between a point and a box, the squared distance, and the parallel listing
// of the target chunks that pass a cull.  The gaps and the distance are
// rounded the same way,
//   ((x0 - y0)^2 + (x1 - y1)^2) + (x2 - y2)^2
// with explicitly rounded operations (no FMA contraction), so gap^2 <= d^2
// holds in floats for every pair across two boxes (or a point and a box): a
// kernel that skips a tile whose gap^2 exceeds its radius or bound drops no
// pair the plain version would keep.  Everything here has internal linkage,
// so each source that includes it keeps its own copy.

#pragma once

#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;  // threads per block == points per tile
constexpr int kTileWarps = kTile / 32;

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Bounding box of the points held one per thread and flagged `valid`:
// box[0..2] lo, box[3..5] hi (lo = FLT_MAX > hi = -FLT_MAX when none is
// valid).  With kSlots = 7 also the largest `extra` over the valid points
// into box[6].  kWarps is the block's warp count.  Ends with a barrier, so
// box is readable by the whole block.
template <int kSlots = 6, int kWarps = kTileWarps>
__device__ void block_bbox(float4 p, bool valid, float (*scratch)[kWarps], float* box,
                           float extra = 0.f) {
  static_assert(kSlots == 6 || kSlots == 7, "a box, or a box and one extra maximum");
  float v[7] = {valid ? p.x : FLT_MAX,  valid ? p.y : FLT_MAX,  valid ? p.z : FLT_MAX,
                valid ? p.x : -FLT_MAX, valid ? p.y : -FLT_MAX, valid ? p.z : -FLT_MAX,
                valid ? extra : -FLT_MAX};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < kSlots; ++c) {
    v[c] = c < 3 ? warp_min(v[c]) : warp_max(v[c]);
    if (lane == 0) scratch[c][warp] = v[c];
  }
  __syncthreads();
  if (threadIdx.x < kSlots) {
    const int c = threadIdx.x;
    float r = scratch[c][0];
    for (int w = 1; w < kWarps; ++w)
      r = c < 3 ? fminf(r, scratch[c][w]) : fmaxf(r, scratch[c][w]);
    box[c] = r;
  }
  __syncthreads();
}

__device__ __forceinline__ float axis_gap(float lo_a, float hi_a, float lo_b, float hi_b) {
  return fmaxf(0.f, fmaxf(__fsub_rn(lo_b, hi_a), __fsub_rn(lo_a, hi_b)));
}

// Squared gap between two boxes, rounded like sq_dist; inf when either is
// empty.
__device__ __forceinline__ float box_gap2(const float* a, const float* b) {
  if (a[0] > a[3] || b[0] > b[3]) return INFINITY;
  const float gx = axis_gap(a[0], a[3], b[0], b[3]);
  const float gy = axis_gap(a[1], a[4], b[1], b[4]);
  const float gz = axis_gap(a[2], a[5], b[2], b[5]);
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), __fmul_rn(gz, gz));
}

__device__ __forceinline__ float sq_dist(float4 a, float4 b) {
  const float dx = __fsub_rn(a.x, b.x);
  const float dy = __fsub_rn(a.y, b.y);
  const float dz = __fsub_rn(a.z, b.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// One block per kTile-point tile of t: the box of its points into
// boxes[6 * tile ..], of the valid ones only (w != 0) with kValidOnly, else
// of all of them (masked points parked at MASK_COORD count as points).
template <bool kValidOnly>
__global__ void __launch_bounds__(kTile)
    tile_bbox_kernel(const float4* __restrict__ t, int nt, float* __restrict__ boxes) {
  __shared__ float scratch[6][kTileWarps];
  __shared__ float box[6];
  const int j = blockIdx.x * kTile + threadIdx.x;
  const float4 tj = j < nt ? t[j] : make_float4(0.f, 0.f, 0.f, 0.f);
  block_bbox(tj, j < nt && (!kValidOnly || tj.w != 0.f), scratch, box);
  if (threadIdx.x < 6) boxes[6 * blockIdx.x + threadIdx.x] = box[threadIdx.x];
}

// Squared gap between point p and box b, rounded like sq_dist (inf for an
// empty box).
__device__ __forceinline__ float point_gap2(float4 p, const float* b) {
  const float gx = axis_gap(p.x, p.x, b[0], b[3]);
  const float gy = axis_gap(p.y, p.y, b[1], b[4]);
  const float gz = axis_gap(p.z, p.z, b[2], b[5]);
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), __fmul_rn(gz, gz));
}

// Bounding box of the points held one per lane of a warp and flagged
// `valid`, in every lane: box[0..2] lo, box[3..5] hi (lo > hi when none is).
__device__ __forceinline__ void warp_bbox(float4 p, bool valid, float* box) {
  box[0] = warp_min(valid ? p.x : FLT_MAX);
  box[1] = warp_min(valid ? p.y : FLT_MAX);
  box[2] = warp_min(valid ? p.z : FLT_MAX);
  box[3] = warp_max(valid ? p.x : -FLT_MAX);
  box[4] = warp_max(valid ? p.y : -FLT_MAX);
  box[5] = warp_max(valid ? p.z : -FLT_MAX);
}

constexpr int kChunk = 32;  // points per chunk box: one a lane of a warp

// One warp per kChunk-point chunk of t: the box of its points into
// boxes[6 * chunk ..], of the valid ones only (w != 0) with kValidOnly, else
// of all of them (masked points parked at MASK_COORD count as points).
// Blocks of kTile threads.
template <bool kValidOnly>
__global__ void __launch_bounds__(kTile)
    chunk_bbox_kernel(const float4* __restrict__ t, int nt, float* __restrict__ boxes) {
  const int j = blockIdx.x * kTile + threadIdx.x;
  const int chunk = j / kChunk;
  if (chunk * kChunk >= nt) return;  // uniform across the warp
  const float4 tj = j < nt ? t[j] : make_float4(0.f, 0.f, 0.f, 0.f);
  float box[6];
  warp_bbox(tj, j < nt && (!kValidOnly || tj.w != 0.f), box);
  const int lane = threadIdx.x & 31;
  if (lane < 6) {
    float v = box[0];
#pragma unroll
    for (int c = 1; c < 6; ++c) v = lane == c ? box[c] : v;
    boxes[6 * chunk + lane] = v;
  }
}

// The chunks c in [c0, min(c0 + kCap, n)) with keep(c), listed in chunk
// order into list[0 ..): each thread tests kCap / kThreads of them, a warp
// ballot and a prefix over the block's warps place the kept ones.  Called by
// every thread of a kThreads-thread block; counts is shared scratch.
// Returns the number listed; ends with a barrier, so the list is readable by
// the whole block.
template <int kThreads, int kCap, class Keep>
__device__ __forceinline__ int list_chunks(int c0, int n, Keep keep, int* list,
                                           int (*counts)[kThreads / 32]) {
  static_assert(kCap % kThreads == 0, "whole rounds of the block's threads");
  constexpr int kRounds = kCap / kThreads, kWarpsHere = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool kept[kRounds];
  unsigned votes[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int c = c0 + r * kThreads + threadIdx.x;
    kept[r] = c < n && keep(c);
    votes[r] = __ballot_sync(0xffffffffu, kept[r]);
    if (lane == 0) counts[r][warp] = __popc(votes[r]);
  }
  __syncthreads();
  int base = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    int before = 0, all = 0;
    for (int w = 0; w < kWarpsHere; ++w) {
      before += w < warp ? counts[r][w] : 0;
      all += counts[r][w];
    }
    if (kept[r])
      list[base + before + __popc(votes[r] & ((1u << lane) - 1u))] =
          c0 + r * kThreads + threadIdx.x;
    base += all;
  }
  __syncthreads();
  return base;
}

}  // namespace
