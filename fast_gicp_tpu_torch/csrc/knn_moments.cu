// Fused k-NN selection and neighbourhood moments over candidate slabs, one
// warp per query.
//
// Replaces fast_gicp_tpu/ops/pallas_kernels.py::_make_knn_moments_kernel
// (reached through knn_moments_pallas, for the default "knn" covariances).
// Query tile i (256 queries) searches the slab of its C candidate target
// tiles cidx[i] (ct points each, S = C * ct <= 2048 slab positions).  For
// each query and slab position j:
//   d^2 = ((q0 - t0)^2 + (q1 - t1)^2) + (q2 - t2)^2, rounded in that order;
//   key = (bits of d^2) & -4096 | j.
// Keys are unique, so "the k smallest keys" is one set, the TPU kernel's
// packed-key selection exactly (ties broken by slab position, distances
// quantised at 2^-11 relative for the ordering).  Outputs:
//   mom (10, nq) = [count, sum y (3), sum y y^T upper sym-6] over the k
//     selected candidates, y = (t - origin) * valid, where origin is the
//     first query point of the query tile (a local frame: the finalize
//     cancels ~|local extent|^2, not ~|cloud extent|^2);
//   kth (nq,) = the k-th key & -4096, read back as a float.
//
// Bound on an H100: operations.  At 22,528 queries x 2,048 positions a call
// is ~46 M distances (0.5 GFLOP with the keys), a few us at the FP32 rate;
// the k rounds of selection add k * S / 32 integer minimum and compare
// steps a query.  Design: a block of 8 warps stages the query tile's slab
// (2,048 float4 = 32 KB) in shared memory; 4 blocks share one query tile,
// so a full-width call runs 352 blocks over the 132 SMs instead of 88.
// Each warp takes one query at a time: lane l holds the keys of positions
// l, l + 32, ... in registers, and each of the k rounds is a warp-wide
// minimum (__reduce_min_sync) after which the owning lane retires its key
// and marks the slot in a 64-bit selection mask.  The moments are then
// summed per lane over its selected slots and reduced across the warp.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQueryTile = 256;  // queries sharing one candidate slab
constexpr int kParts = 4;        // blocks per query tile
constexpr int kMaxSlab = 2048;
constexpr int kSlots = kMaxSlab / 32;  // slab positions per lane
constexpr float kMaskCoord = 1.0e9f;   // where masked points are parked

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    knn_moments_kernel(const float4* __restrict__ q, const float4* __restrict__ t,
                       const int* __restrict__ cidx, int nq, int nt, int C, int ct,
                       int k, float* __restrict__ mom, float* __restrict__ kth) {
  __shared__ float4 slab[kMaxSlab];
  const int qt = blockIdx.x;
  const int S = C * ct;
  for (int j = threadIdx.x; j < S; j += kThreads) {
    const int c = j / ct;
    const int tile = cidx[qt * C + c];
    // a tile index outside the target reads as masked points, not memory
    slab[j] = tile >= 0 && tile < nt / ct
                  ? t[(size_t)tile * ct + (j - c * ct)]
                  : make_float4(kMaskCoord, kMaskCoord, kMaskCoord, 0.f);
  }
  __syncthreads();

  const float4 origin = q[qt * kQueryTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kPerPart = kQueryTile / kParts;
  for (int r = warp; r < kPerPart; r += kWarps) {
    const int i = qt * kQueryTile + blockIdx.y * kPerPart + r;
    const float4 qi = q[i];
    int keys[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int j = lane + 32 * s;
      if (j < S) {
        const float4 y = slab[j];
        const float dx = __fsub_rn(qi.x, y.x);
        const float dy = __fsub_rn(qi.y, y.y);
        const float dz = __fsub_rn(qi.z, y.z);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        keys[s] = (__float_as_int(d2) & -4096) | j;
      } else {
        keys[s] = INT_MAX;  // no real key reaches it
      }
    }

    // k rounds of warp-wide min-and-retire; keys are unique, so exactly one
    // slot of one lane matches each round's minimum
    unsigned long long sel = 0ull;
    int m = 0;
    for (int round = 0; round < k; ++round) {
      int local = INT_MAX;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) local = min(local, keys[s]);
      m = __reduce_min_sync(0xffffffffu, local);
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (keys[s] == m) {
          keys[s] = INT_MAX;
          sel |= 1ull << s;
        }
      }
    }

    float acc[10];
#pragma unroll
    for (int a = 0; a < 10; ++a) acc[a] = 0.f;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if ((sel >> s) & 1ull) {
        const float4 y = slab[lane + 32 * s];
        const float v = y.w;
        const float y0 = (y.x - origin.x) * v;
        const float y1 = (y.y - origin.y) * v;
        const float y2 = (y.z - origin.z) * v;
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
#pragma unroll
    for (int a = 0; a < 10; ++a) acc[a] = warp_sum(acc[a]);
    if (lane == 0) {
#pragma unroll
      for (int a = 0; a < 10; ++a) mom[(size_t)a * nq + i] = acc[a];
      kth[i] = fmaxf(__int_as_float(m & -4096), 0.f);
    }
  }
}

}  // namespace

// q: (nq, 4) float32 [x, y, z, valid], masked queries parked at MASK_COORD,
// nq = 256 * Q.  t: (nt, 4) float32 [x, y, z, valid], masked targets parked
// at MASK_COORD, nt a multiple of ct.  cidx: (Q, C) int32 candidate tiles
// in [0, nt / ct), C * ct <= 2048; 1 <= k <= C * ct.  mom: (10, nq); kth:
// (nq,).  Launches on `stream`; returns cudaGetLastError().
extern "C" int fgt_knn_moments(const float* q, const float* t, const int* cidx, int nq,
                               int nt, int C, int ct, int k, float* mom, float* kth,
                               void* stream) {
  const int Q = nq / kQueryTile;
  if (Q > 0)
    knn_moments_kernel<<<dim3(Q, kParts), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(q), reinterpret_cast<const float4*>(t), cidx, nq,
        nt, C, ct, k, mom, kth);
  return static_cast<int>(cudaGetLastError());
}
