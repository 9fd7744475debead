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

#include <cuda_runtime.h>

#include "tile_cull.cuh"

namespace {

constexpr int kThreads = kTile;  // queries per block == targets per tile
constexpr int kWarps = kTileWarps;

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
        const float d2 = sq_dist(qi, tile[k]);
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
    tile_bbox_kernel<false><<<tiles, kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(t), nt, boxes);
    nn_search_kernel<<<blocks, kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(q), reinterpret_cast<const float4*>(t), boxes,
        nq, nt, idx, d2);
  }
  return static_cast<int>(cudaGetLastError());
}
