// Exact 1-NN search: groups of warps split a block's target chunks.
//
// Replaces fast_gicp_tpu/ops/pallas_kernels.py::_nn_kernel (reached through
// nn_search_pallas and its two culled passes).  For each query q it returns
// the index and squared distance of the nearest target point, with
// d^2 = ((q0 - t0)^2 + (q1 - t1)^2) + (q2 - t2)^2 rounded in that order
// (explicitly rounded operations, no FMA contraction), and ties going to
// the lowest target index: the (d^2, index) pair is minimised
// lexicographically, so the result does not depend on the order in which
// targets are visited.  Masked targets arrive parked at MASK_COORD
// (distances ~3e18), so they are chosen only when no valid target exists.
//
// Bound on an H100: FP32 operations of the pairs that must be visited (8 a
// pair).  An unculled search at 22,528 x 22,528 is 4.1 GFLOP (61 us at
// 67 TFLOP/s); the clouds arrive voxel-key sorted, so chunk boxes are tight
// and an exact cull visits a few percent of the pairs.  What held a first
// design (a block of 128 queries walking the tile boxes one after another)
// was latency: 352 dependent box loads and three barriers a visited tile.
// Design: a prologue kernel writes the box of each 32-target chunk (all
// points, masked ones included, so that a target with no valid point is
// still searched).  A block holds 64 queries, kGroups = 4 times: thread
// g * 64 + i holds query i in group g.  In two passes the block lists, in
// parallel (a box gap a thread, a ballot and a prefix), the chunks it must
// visit: first those whose box touches the box of its valid queries (gap
// 0, where almost every nearest neighbour lies), then those with
// 0 < gap^2 <= the block's bound, the largest best d^2 of its valid queries
// after the first pass.  A chunk farther than that holds no pair better
// than or equal to any valid query's best.  Group g takes every kGroups-th
// listed chunk; each of its warps (32 queries) skips a chunk unless some
// valid query's own point-to-box gap^2 is <= its running best (so the
// bound tightens as the warp goes), stages the chunk in its own shared
// slot (no block barrier) and keeps its queries' (d^2, index) minima.  The
// groups' minima are merged after each pass through shared memory; the
// merge is the lexicographic minimum, so any split gives the same result.
// The gaps are rounded like d^2 (tile_cull.cuh), so the cull never drops a
// pair the plain version would choose.  Masked queries (padding) are left
// out of the block's box and bound and never ask for a chunk; their results
// are finite and carry no meaning (index 0 when their warp visited nothing).
// On an H100 at the full-size pair, 64 queries and 4 groups (352 blocks of
// 8 warps) ran faster than 128 queries with 2, 4 or 8 groups (176 blocks:
// 1.33 waves) and than 32 queries (a looser first-pass bound, so more
// chunks in the second pass).

#include <cuda_runtime.h>

#include "tile_cull.cuh"

namespace {

constexpr int kQueries = 64;  // queries per block
constexpr int kQueryWarps = kQueries / 32;
constexpr int kGroups = 4;  // thread groups sharing one block's queries
constexpr int kThreads = kGroups * kQueries;
constexpr int kWarps = kThreads / 32;
constexpr int kListCap = 1024;  // chunks tested per listing round

__global__ void __launch_bounds__(kThreads)
    nn_search_kernel(const float4* __restrict__ q, const float4* __restrict__ t,
                     const float* __restrict__ boxes, int nq, int nt,
                     int* __restrict__ idx_out, float* __restrict__ d2_out) {
  __shared__ int list[kListCap];
  __shared__ int counts[kListCap / kThreads][kWarps];
  __shared__ float4 slot[kWarps][kChunk];  // each warp's staged chunk
  __shared__ float part_d2[kGroups][kQueries];
  __shared__ int part_idx[kGroups][kQueries];
  __shared__ float scratch[6][kWarps];
  __shared__ float qbox[6];
  __shared__ float warp_bound[kQueryWarps];

  const int tid = threadIdx.x;
  const int g = tid / kQueries, qi_local = tid % kQueries;
  const int lane = tid & 31, warp = tid >> 5;
  const int i = blockIdx.x * kQueries + qi_local;
  const float4 qi = i < nq ? q[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  const bool valid = i < nq && qi.w != 0.f;
  // the valid queries' box (group 0 holds each query once)
  block_bbox(qi, g == 0 && valid, scratch, qbox);

  float best = INFINITY, bound = 0.f;
  int best_idx = 0;
  const int chunks = (nt + kChunk - 1) / kChunk;
  float4* const own = slot[warp];
  for (int pass = 0; pass < 2; ++pass) {
    for (int c0 = 0; c0 < chunks; c0 += kListCap) {
      const int listed = list_chunks<kThreads, kListCap>(
          c0, chunks,
          [&](int c) {
            const float gap2 = box_gap2(qbox, boxes + 6 * c);
            return pass == 0 ? gap2 <= 0.f : (gap2 > 0.f && gap2 <= bound);
          },
          list, counts);
      for (int e = g; e < listed; e += kGroups) {  // uniform across the warp
        const int c = list[e];
        const bool need = valid && point_gap2(qi, boxes + 6 * c) <= best;
        if (!__any_sync(0xffffffffu, need)) continue;
        const int base = c * kChunk;
        const int j = base + lane;
        own[lane] = j < nt ? t[j] : make_float4(0.f, 0.f, 0.f, 0.f);
        __syncwarp();
        const int n = min(kChunk, nt - base);
        // the chunk's first minimum in index order, then the lexicographic
        // merge with the running best
        float cbest = INFINITY;
        int ck = 0;
#pragma unroll 8
        for (int k = 0; k < n; ++k) {
          const float d2 = sq_dist(qi, own[k]);
          if (d2 < cbest) {
            cbest = d2;
            ck = k;
          }
        }
        __syncwarp();  // own is rewritten by the next chunk
        if (cbest < best || (cbest == best && base + ck < best_idx)) {
          best = cbest;
          best_idx = base + ck;
        }
      }
      __syncthreads();  // list is rewritten by the next round
    }
    // every thread merges its query's minima over the groups
    part_d2[g][qi_local] = best;
    part_idx[g][qi_local] = best_idx;
    __syncthreads();
#pragma unroll
    for (int h = 0; h < kGroups; ++h) {
      const float d2 = part_d2[h][qi_local];
      const int jj = part_idx[h][qi_local];
      if (d2 < best || (d2 == best && jj < best_idx)) {
        best = d2;
        best_idx = jj;
      }
    }
    if (pass == 0) {
      // the bound: the largest best of the block's valid queries
      const float worst = warp_max(valid ? best : 0.f);
      if (g == 0 && lane == 0) warp_bound[warp] = worst;
      __syncthreads();  // also: part_* are read before pass 2 rewrites them
      bound = warp_bound[0];
#pragma unroll
      for (int w = 1; w < kQueryWarps; ++w) bound = fmaxf(bound, warp_bound[w]);
    }
  }
  if (g == 0 && i < nq) {
    if (best == INFINITY) best = sq_dist(qi, t[0]);  // a query no warp searched for
    idx_out[i] = best_idx;
    d2_out[i] = fmaxf(best, 0.f);
  }
}

}  // namespace

// q: (nq, 4) float32 [x, y, z, valid]; t: (nt, 4) float32 [x, y, z, valid] with
// masked targets parked at MASK_COORD.  boxes: scratch of 6 * ceil(nt / 32)
// floats.  idx: (nq,) int32; d2: (nq,) float32.  Two launches on `stream`
// (chunk boxes, then the search); returns cudaGetLastError().
extern "C" int fgt_nn_search(const float* q, const float* t, int nq, int nt,
                             float* boxes, int* idx, float* d2, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (nq + kQueries - 1) / kQueries;
  if (nt > 0 && blocks > 0) {
    chunk_bbox_kernel<false><<<(nt + kTile - 1) / kTile, kTile, 0, s>>>(
        reinterpret_cast<const float4*>(t), nt, boxes);
    nn_search_kernel<<<blocks, kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(q), reinterpret_cast<const float4*>(t), boxes,
        nq, nt, idx, d2);
  }
  return static_cast<int>(cudaGetLastError());
}
