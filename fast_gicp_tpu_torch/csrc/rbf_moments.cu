// RBF kernel-density moments: the warps of a block split its target chunks.
//
// Replaces fast_gicp_tpu/ops/pallas_kernels.py::_rbf_kernel (reached through
// rbf_cross_moments_centered_T).  For each query q it sums, over the valid
// targets y with d^2 = |q - y|^2 <= max_dist^2, the weight
// w = exp(-kw d^2) times [1, y, y y^T], all about a common center that the
// caller has already subtracted.  Output rows (16, nq):
//   0      sum w
//   1..3   sum w y
//   4..12  sum w y y^T, row-major (filled symmetrically)
//   13..15 zero
// Rows of masked queries are written but carry no meaning.
//
// Bound on an H100: FP32 operations.  Each pair in range costs a distance
// (8 flops), one expf and 19 flops of moment accumulation; device-memory
// traffic is a few hundred KB a call.  The clouds arrive voxel-key sorted,
// so a box cull keeps a few percent of the pairs, but at a 3 m radius it
// still visits ~7x the pairs in range.  What held a first design (a block
// of 128 queries staging and boxing all 176 target tiles, one thread a
// query, ~5 warps an SM) was latency.  Design: a prologue kernel writes the
// box of the valid points of each 32-target chunk.  A block holds 32
// queries, one a lane, in each of its kGroups warps.  It lists in parallel
// (a box gap a thread, a ballot and a prefix) the chunks whose box lies
// within max_dist of its valid queries' box; warp g takes every kGroups-th
// listed chunk, skips it unless some valid query's own point-to-box gap^2
// is <= max_dist^2, stages it in its own shared slot (no block barrier) and
// runs the expf and the moment update only for the pairs in range (a
// branch: one visited pair in eight is in range; on an H100 it ran faster
// than first collecting each lane's in-range targets of a chunk in a bit
// mask, and 8 warps faster than 4 or 16).  Each thread keeps its query's
// ten sums in registers; at the end the warps' partial sums are added in
// warp order through shared memory (no atomics), so two launches on the
// same input return the same bits.
//
// The squared distance and the exponent are computed with explicitly
// rounded operations (no FMA contraction) in the order the plain PyTorch
// version uses, so both take the same d^2 <= max_dist^2 decisions; the gaps
// are rounded like d^2 (tile_cull.cuh), so the cull drops no pair in range.

#include <cuda_runtime.h>

#include "tile_cull.cuh"

namespace {

constexpr int kGroups = 8;  // warps sharing one block's 32 queries
constexpr int kThreads = 32 * kGroups;
constexpr int kListCap = 1024;  // chunks tested per listing round
constexpr int kSums = 10;

__global__ void __launch_bounds__(kThreads)
    rbf_moments_kernel(const float4* __restrict__ q, const float4* __restrict__ t,
                       const float* __restrict__ boxes, int nq, int nt, float kw,
                       float md2, float* __restrict__ out) {
  __shared__ int list[kListCap];
  __shared__ int counts[kListCap / kThreads][kGroups];
  __shared__ float4 slot[kGroups][kChunk];  // each warp's staged chunk
  __shared__ float part[kGroups][kSums][32];

  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  const float4 qi = i < nq ? q[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  const bool valid = i < nq && qi.w != 0.f;
  float qbox[6];  // every warp holds the block's queries: each boxes them alone
  warp_bbox(qi, valid, qbox);

  float s[kSums];
#pragma unroll
  for (int a = 0; a < kSums; ++a) s[a] = 0.f;
  const float neg_kw = -kw;
  const int chunks = (nt + kChunk - 1) / kChunk;
  float4* const own = slot[g];
  for (int c0 = 0; c0 < chunks; c0 += kListCap) {
    const int listed = list_chunks<kThreads, kListCap>(
        c0, chunks, [&](int c) { return box_gap2(qbox, boxes + 6 * c) <= md2; }, list,
        counts);
    for (int e = g; e < listed; e += kGroups) {  // uniform across the warp
      const int c = list[e];
      const bool need = valid && point_gap2(qi, boxes + 6 * c) <= md2;
      if (!__any_sync(0xffffffffu, need)) continue;
      const int base = c * kChunk;
      const int j = base + lane;
      own[lane] = j < nt ? t[j] : make_float4(0.f, 0.f, 0.f, 0.f);
      __syncwarp();
      const int n = min(kChunk, nt - base);
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        const float4 y = own[k];
        const float d2 = sq_dist(qi, y);
        if (y.w != 0.f && d2 <= md2) {
          const float w = expf(__fmul_rn(d2, neg_kw));
          const float wx = w * y.x, wy = w * y.y, wz = w * y.z;
          s[0] += w;
          s[1] += wx;
          s[2] += wy;
          s[3] += wz;
          s[4] += wx * y.x;
          s[5] += wx * y.y;
          s[6] += wx * y.z;
          s[7] += wy * y.y;
          s[8] += wy * y.z;
          s[9] += wz * y.z;
        }
      }
      __syncwarp();  // own is rewritten by the next chunk
    }
    __syncthreads();  // list is rewritten by the next round
  }

  // the warps' partial sums, added in warp order
#pragma unroll
  for (int a = 0; a < kSums; ++a) part[g][a][lane] = s[a];
  __syncthreads();
  if (g == 0 && i < nq) {
#pragma unroll
    for (int a = 0; a < kSums; ++a) {
      float v = part[0][a][lane];
      for (int h = 1; h < kGroups; ++h) v += part[h][a][lane];
      s[a] = v;
    }
    // rows [sum w, sum w y (3), sum w y y^T (9, row-major), 0 (3)]
    const float rows[16] = {s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[5],
                            s[7], s[8], s[6], s[8], s[9], 0.f,  0.f,  0.f};
#pragma unroll
    for (int r = 0; r < 16; ++r) out[(size_t)r * nq + i] = rows[r];
  }
}

}  // namespace

// q, t: (n, 4) float32 [x, y, z, valid] about the common center.
// boxes: scratch of 6 * ceil(nt / 32) floats.  out: (16, nq) float32.  Two
// launches on `stream` (chunk boxes, then the moments); returns
// cudaGetLastError().
extern "C" int fgt_rbf_moments(const float* q, const float* t, int nq, int nt,
                               float kw, float md2, float* boxes, float* out,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (nq + 31) / 32;
  if (blocks > 0 && nt > 0)
    chunk_bbox_kernel<true><<<(nt + kTile - 1) / kTile, kTile, 0, s>>>(
        reinterpret_cast<const float4*>(t), nt, boxes);
  if (blocks > 0)
    rbf_moments_kernel<<<blocks, kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(q), reinterpret_cast<const float4*>(t), boxes,
        nq, nt, kw, md2, out);
  return static_cast<int>(cudaGetLastError());
}
