// Exact 1-NN search, one thread per query.
//
// Replaces fast_gicp_tpu/ops/pallas_kernels.py::_nn_kernel (reached through
// nn_search_pallas and its two culled passes).  For each query q it returns
// the index and squared distance of the nearest target point, with
// d^2 = ((q0 - t0)^2 + (q1 - t1)^2) + (q2 - t2)^2 rounded in that order
// (explicitly rounded operations, no FMA contraction), and ties going to
// the lowest target index: the (d^2, index) pair is minimised
// lexicographically, so the result does not depend on the order in which
// target tiles are visited.  Masked targets arrive parked at MASK_COORD
// (distances ~3e18), so they are chosen only when no valid target exists.
//
// Bound on an H100: FP32 operations of the pairs that must be visited (8 a
// pair).  An unculled search at 22,528 x 22,528 is 4.1 GFLOP (61 us at
// 67 TFLOP/s); the clouds arrive voxel-key sorted, so tile bounding boxes
// are tight and an exact cull visits a few percent of the pairs.  Design:
// a prologue kernel writes the bounding box of each 128-target tile; each
// block of 128 queries then visits, first, the tiles whose box touches its
// own (gap 0, where almost every nearest neighbour lies), then every other
// tile whose squared box gap is <= the block's worst best-so-far.  A tile
// farther than that cannot hold a better or equal pair for any query of
// the block.  The gap is rounded like d^2, so gap^2 <= d^2 holds in floats
// for every pair across the two boxes and the cull never drops a pair the
// plain version would choose.  A visited tile is staged in shared memory
// and read by broadcast.  Masked queries (padding) are left out of the
// block's box and bound, so one padding row far from the cloud does not
// make its block visit every tile; their results are finite and carry no
// meaning.  A block of masked queries only uses the box of all its rows.

#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // queries per block == targets per tile
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Bounding box of the points held one per thread and flagged `valid`:
// box[0..2] lo, box[3..5] hi.  Ends with a barrier, so box is readable by
// the whole block.
__device__ void block_bbox(float4 p, bool valid, float (*scratch)[kWarps], float* box) {
  float v[6] = {valid ? p.x : FLT_MAX,  valid ? p.y : FLT_MAX,
                valid ? p.z : FLT_MAX,  valid ? p.x : -FLT_MAX,
                valid ? p.y : -FLT_MAX, valid ? p.z : -FLT_MAX};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    v[c] = c < 3 ? warp_min(v[c]) : warp_max(v[c]);
    if (lane == 0) scratch[c][warp] = v[c];
  }
  __syncthreads();
  if (threadIdx.x < 6) {
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

// Squared gap between two boxes, rounded like d^2 below.
__device__ __forceinline__ float box_gap2(const float* a, const float* b) {
  const float gx = axis_gap(a[0], a[3], b[0], b[3]);
  const float gy = axis_gap(a[1], a[4], b[1], b[4]);
  const float gz = axis_gap(a[2], a[5], b[2], b[5]);
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), __fmul_rn(gz, gz));
}

// One block per 128-target tile: the bounding box of all its points,
// masked ones included (they are real points at MASK_COORD to the search),
// into boxes[6 * tile ..].
__global__ void __launch_bounds__(kThreads)
    tile_bbox_kernel(const float4* __restrict__ t, int nt, float* __restrict__ boxes) {
  __shared__ float scratch[6][kWarps];
  __shared__ float box[6];
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const float4 tj = j < nt ? t[j] : make_float4(0.f, 0.f, 0.f, 0.f);
  block_bbox(tj, j < nt, scratch, box);
  if (threadIdx.x < 6) boxes[6 * blockIdx.x + threadIdx.x] = box[threadIdx.x];
}

__global__ void __launch_bounds__(kThreads)
    nn_search_kernel(const float4* __restrict__ q, const float4* __restrict__ t,
                     const float* __restrict__ boxes, int nq, int nt,
                     int* __restrict__ idx_out, float* __restrict__ d2_out) {
  __shared__ float4 tile[kThreads];
  __shared__ float scratch[6][kWarps];
  __shared__ float qbox[6];
  __shared__ float bound;

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float4 qi = i < nq ? q[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  // the valid queries' box; rows of masked queries count only in a block
  // that has no valid query (the test is uniform: qbox is shared)
  bool counts = i < nq && qi.w != 0.f;
  block_bbox(qi, counts, scratch, qbox);
  if (qbox[0] > qbox[3]) {
    counts = i < nq;
    block_bbox(qi, counts, scratch, qbox);
  }
  if (threadIdx.x == 0) bound = FLT_MAX;
  __syncthreads();

  float best = INFINITY;
  int best_idx = 0;
  const int tiles = (nt + kThreads - 1) / kThreads;
  for (int pass = 0; pass < 2; ++pass) {
    for (int tt = 0; tt < tiles; ++tt) {
      // uniform across the block: qbox, boxes and bound are shared values
      const float gap2 = box_gap2(qbox, boxes + 6 * tt);
      const bool visit = pass == 0 ? gap2 <= 0.f : (gap2 > 0.f && gap2 <= bound);
      if (!visit) continue;
      const int base = tt * kThreads;
      const int j = base + threadIdx.x;
      tile[threadIdx.x] = j < nt ? t[j] : make_float4(0.f, 0.f, 0.f, 0.f);
      __syncthreads();
      const int n = min(kThreads, nt - base);
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        const float4 y = tile[k];
        const float dx = __fsub_rn(qi.x, y.x);
        const float dy = __fsub_rn(qi.y, y.y);
        const float dz = __fsub_rn(qi.z, y.z);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        const int jj = base + k;
        if (d2 < best || (d2 == best && jj < best_idx)) {
          best = d2;
          best_idx = jj;
        }
      }
      // the block's worst best-so-far bounds the tiles still worth a visit
      const float worst = warp_max(counts ? best : 0.f);
      if ((threadIdx.x & 31) == 0) scratch[0][threadIdx.x >> 5] = worst;
      __syncthreads();  // every thread is done with tile; scratch is full
      if (threadIdx.x == 0) {
        float r = scratch[0][0];
        for (int w = 1; w < kWarps; ++w) r = fmaxf(r, scratch[0][w]);
        bound = r;
      }
      __syncthreads();
    }
  }
  if (i < nq) {
    idx_out[i] = best_idx;
    d2_out[i] = fmaxf(best, 0.f);
  }
}

}  // namespace

// q: (nq, 4) float32 [x, y, z, valid]; t: (nt, 4) float32 [x, y, z, valid] with
// masked targets parked at MASK_COORD.  boxes: scratch of 6 * ceil(nt/128)
// floats.  idx: (nq,) int32; d2: (nq,) float32.  Two launches on `stream`
// (tile boxes, then the search); returns cudaGetLastError().
extern "C" int fgt_nn_search(const float* q, const float* t, int nq, int nt,
                             float* boxes, int* idx, float* d2, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (nt + kThreads - 1) / kThreads;
  const int blocks = (nq + kThreads - 1) / kThreads;
  if (tiles > 0 && blocks > 0) {
    tile_bbox_kernel<<<tiles, kThreads, 0, s>>>(reinterpret_cast<const float4*>(t), nt,
                                                boxes);
    nn_search_kernel<<<blocks, kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(q), reinterpret_cast<const float4*>(t), boxes,
        nq, nt, idx, d2);
  }
  return static_cast<int>(cudaGetLastError());
}
