// k-NN over per-query-tile candidate slabs, one thread per query.
//
// Replaces fast_gicp_tpu/ops/pallas_kernels.py::_make_knn_slab_kernel
// (reached through knn_slab_pallas, for knn_search_culled).  Query tile i
// (256 queries) searches the slab of its C candidate target tiles cidx[i]
// (ct points each; slab position j = c * ct + lane).  For each query and
// slab position:
//   d^2 = ((q0 - t0)^2 + (q1 - t1)^2) + (q2 - t2)^2, rounded in that order
// (explicitly rounded operations, no FMA contraction).  Outputs, per query,
// the k smallest d^2 ascending (clamped at 0) and their global target ids
// (cidx[i][c] * ct + lane), ties going to the lower slab position: the TPU
// kernel's k rounds of argmin-and-mask, and a stable sort of the slab.  With
// cidx[i] = 0 .. T-1 for every tile the slab is the whole target in index
// order, and the same kernel is the exact k-NN search.
//
// Bound on an H100: FP32 operations, 8 for the distance and one compare a
// candidate (22,528 queries x 4,096 positions at C = 16, ct = 256: 0.83
// GFLOP, 12 us at 67 TFLOP/s).  Design: 4 blocks of 64 threads share one
// query tile (352 blocks over the 132 SMs at full width).  A block stages
// the slab in shared memory 1,024 positions at a time (16 KB of float4 and
// 4 KB of global ids) and every thread reads each position by broadcast, in
// slab order.  Each thread keeps its k best (d^2, id) sorted in kMaxK slots
// (every index a constant: the insertion network is fully unrolled) and
// inserts only on a strict d^2 < its k-th: an equal d^2 later in the slab
// never displaces an earlier one, which is the tie rule.  What this simple
// design pays: one thread a query leaves ~5 warps on an SM, and an insertion
// diverges from the warp's other lanes -- while the lists fill, some lane
// of a warp inserts at most positions (1.57 ms a call at C = 16 on an H100,
// 125x the bound).  Masked targets arrive parked at MASK_COORD (d^2 ~ 3e18,
// finite), so they fill a list only when fewer than k valid targets are in
// the slab; a tile id outside the target reads as masked points.

#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kQueryTile = 256;  // queries sharing one candidate slab
constexpr int kParts = kQueryTile / kThreads;
constexpr int kChunk = 1024;  // slab positions staged at a time
constexpr int kMaxK = 32;
constexpr float kMaskCoord = 1.0e9f;

__global__ void __launch_bounds__(kThreads)
    knn_slab_kernel(const float4* __restrict__ q, const float4* __restrict__ t,
                    const int* __restrict__ cidx, int nt, int C, int ct, int k,
                    int* __restrict__ idx_out, float* __restrict__ sq_out) {
  __shared__ float4 pts[kChunk];
  __shared__ int gid[kChunk];
  const int qt = blockIdx.x;
  const int i = qt * kQueryTile + blockIdx.y * kThreads + threadIdx.x;
  const float4 qi = q[i];
  const int S = C * ct;
  const int tiles = nt / ct;

  float bd[kMaxK];
  int bi[kMaxK];
#pragma unroll
  for (int s = 0; s < kMaxK; ++s) {
    bd[s] = INFINITY;
    bi[s] = 0;
  }
  float worst = INFINITY;  // bd[k - 1]

  for (int base = 0; base < S; base += kChunk) {
    const int n = min(kChunk, S - base);
    __syncthreads();  // every thread is done with the previous chunk
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int pos = base + j;
      const int c = pos / ct;
      const int lane = pos - c * ct;
      const int tile = cidx[qt * C + c];
      pts[j] = tile >= 0 && tile < tiles
                   ? t[(size_t)tile * ct + lane]
                   : make_float4(kMaskCoord, kMaskCoord, kMaskCoord, 0.f);
      gid[j] = tile * ct + lane;
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float4 y = pts[j];
      const float dx = __fsub_rn(qi.x, y.x);
      const float dy = __fsub_rn(qi.y, y.y);
      const float dz = __fsub_rn(qi.z, y.z);
      const float d2 =
          __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      if (d2 < worst) {
        const int g = gid[j];
        // sorted insertion from the top: slot s takes slot s-1's entry while
        // d2 is smaller, else d2 itself where it belongs
#pragma unroll
        for (int s = kMaxK - 1; s > 0; --s) {
          if (s < k) {
            if (d2 < bd[s - 1]) {
              bd[s] = bd[s - 1];
              bi[s] = bi[s - 1];
            } else if (d2 < bd[s]) {
              bd[s] = d2;
              bi[s] = g;
            }
          }
        }
        if (d2 < bd[0]) {
          bd[0] = d2;
          bi[0] = g;
        }
#pragma unroll
        for (int s = 0; s < kMaxK; ++s)
          if (s == k - 1) worst = bd[s];
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kMaxK; ++s) {
    if (s < k) {
      idx_out[(size_t)i * k + s] = bi[s];
      sq_out[(size_t)i * k + s] = fmaxf(bd[s], 0.f);
    }
  }
}

}  // namespace

// q: (nq, 4) float32 [x, y, z, valid], masked queries parked at MASK_COORD,
// nq = 256 * Q.  t: (nt, 4) float32 [x, y, z, valid], masked targets parked
// at MASK_COORD, nt a multiple of ct.  cidx: (Q, C) int32 candidate tiles;
// 1 <= k <= min(32, C * ct).  idx: (nq, k) int32; sq: (nq, k) float32.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int fgt_knn_slab(const float* q, const float* t, const int* cidx, int nq, int nt,
                            int C, int ct, int k, int* idx, float* sq, void* stream) {
  const int Q = nq / kQueryTile;
  if (Q > 0)
    knn_slab_kernel<<<dim3(Q, kParts), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(q), reinterpret_cast<const float4*>(t), cidx, nt, C,
        ct, k, idx, sq);
  return static_cast<int>(cudaGetLastError());
}
