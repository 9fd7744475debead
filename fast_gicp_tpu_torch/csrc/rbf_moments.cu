// RBF kernel-density moments, one thread per query.
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
// Bound on an H100: FP32 operations.  Each contributing pair costs a
// distance (8 flops), one expf and 19 flops of moment accumulation, with
// no data reuse problem: a block stages 128 targets in shared memory and
// every thread reads them by broadcast, so device-memory traffic is a few
// hundred KB per call.  The design keeps all ten sums in registers and
// skips a whole staged tile when the bounding boxes of the block's valid
// queries and the tile's valid targets are farther apart than max_dist --
// exact, since every pair across the two boxes is then out of range.  The
// clouds arrive voxel-key sorted, so most tiles are skipped.
//
// The squared distance and the exponent are computed with explicitly
// rounded operations (no FMA contraction) in the order the plain PyTorch
// version uses, so both take the same d^2 <= max_dist^2 decisions.

#include <cuda_runtime.h>

#include "tile_cull.cuh"

namespace {

constexpr int kThreads = kTile;  // queries per block == targets per staged tile
constexpr int kWarps = kTileWarps;

__global__ void __launch_bounds__(kThreads)
    rbf_moments_kernel(const float4* __restrict__ q, const float4* __restrict__ t,
                       int nq, int nt, float kw, float md2,
                       float* __restrict__ out) {
  __shared__ float4 tile[kThreads];
  __shared__ float scratch[6][kWarps];
  __shared__ float qbox[6];
  __shared__ float tbox[6];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float4 qi = i < nq ? q[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  block_bbox(qi, qi.w != 0.f, scratch, qbox);

  float s_w = 0.f, s_x = 0.f, s_y = 0.f, s_z = 0.f;
  float s_xx = 0.f, s_xy = 0.f, s_xz = 0.f, s_yy = 0.f, s_yz = 0.f, s_zz = 0.f;
  const float neg_kw = -kw;

  for (int base = 0; base < nt; base += kThreads) {
    const int j = base + threadIdx.x;
    const float4 tj = j < nt ? t[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    tile[threadIdx.x] = tj;
    block_bbox(tj, tj.w != 0.f, scratch, tbox);  // its barriers publish tile
    // rounded like d2 below, so gap2 <= d2 holds for every pair in floats
    if (box_gap2(qbox, tbox) <= md2) {  // uniform across the block
      const int n = min(kThreads, nt - base);
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        const float4 y = tile[k];
        const float d2 = sq_dist(qi, y);
        const float w = (y.w != 0.f && d2 <= md2) ? expf(__fmul_rn(d2, neg_kw)) : 0.f;
        const float wx = w * y.x, wy = w * y.y, wz = w * y.z;
        s_w += w;
        s_x += wx;
        s_y += wy;
        s_z += wz;
        s_xx += wx * y.x;
        s_xy += wx * y.y;
        s_xz += wx * y.z;
        s_yy += wy * y.y;
        s_yz += wy * y.z;
        s_zz += wz * y.z;
      }
    }
    __syncthreads();  // every thread is done with tile and tbox
  }

  if (i < nq) {
    const float rows[16] = {s_w,  s_x,  s_y,  s_z,  s_xx, s_xy, s_xz, s_xy,
                            s_yy, s_yz, s_xz, s_yz, s_zz, 0.f,  0.f,  0.f};
#pragma unroll
    for (int r = 0; r < 16; ++r) out[(size_t)r * nq + i] = rows[r];
  }
}

}  // namespace

// q, t: (n, 4) float32 [x, y, z, valid] about the common center.
// out: (16, nq) float32.  Launches on `stream`; returns cudaGetLastError().
extern "C" int fgt_rbf_moments(const float* q, const float* t, int nq, int nt,
                               float kw, float md2, float* out, void* stream) {
  const int blocks = (nq + kThreads - 1) / kThreads;
  if (blocks > 0)
    rbf_moments_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(q), reinterpret_cast<const float4*>(t),
        nq, nt, kw, md2, out);
  return static_cast<int>(cudaGetLastError());
}
