// Device code shared by the linearize kernels (linearize.cu, ndt_linearize.cu)
// and the error kernels (trial_error.cu): the cross-block sums and the store
// of the normal equations, the grid of one wave, the pose, the in-kernel
// transform and covariance rotation, the clamped sym-6 inverse and the 28
// sums of one correspondence.
// Every expression keeps the order of the plain PyTorch versions (ops/soa.py);
// the sources that include this file are built with -fmad=false so that the
// products and sums round as those do.

#pragma once

#include <cuda_runtime.h>

namespace fgt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One step of a butterfly reduce-scatter: lanes with bit W clear keep
// columns [0, W) of their 2W, the others [W, 2W), each adding its partner's.
template <int W>
__device__ __forceinline__ void butterfly_step(float (&v)[32], int lane) {
  const bool upper = lane & W;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = upper ? v[i] : v[i + W];
    const float keep = upper ? v[i + W] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
}

// The warp's sum of column `lane` of the 32 columns v: 31 shuffles, where a
// shuffle tree a column takes 5 a column.
__device__ __forceinline__ float warp_sum_scatter32(float (&v)[32]) {
  const int lane = threadIdx.x & 31;
  butterfly_step<16>(v, lane);
  butterfly_step<8>(v, lane);
  butterfly_step<4>(v, lane);
  butterfly_step<2>(v, lane);
  butterfly_step<1>(v, lane);
  return v[0];
}

// The 43 floats [err, H (6 x 6 row-major, both triangles), b (6)] of the 28
// sums [err, H (21 unique), b (6)] of the linearize kernels, in the layout
// of pallas_linearize._unpack_out (ops/soa.py unpack28): store_normal_eq
// writes sum k to its one or two places, so H is exactly symmetric.
__device__ __forceinline__ void store_normal_eq(int k, float v, float* out) {
  if (k == 0) {
    out[0] = v;
    return;
  }
  if (k >= 22) {
    out[37 + (k - 22)] = v;  // b
    return;
  }
  int i, j;
  if (k <= 6 || k >= 16) {  // H11, H22: the upper triangle, row by row
    const int u = k <= 6 ? k - 1 : k - 16, o = k <= 6 ? 0 : 3;
    i = o + (u < 3 ? 0 : (u < 5 ? 1 : 2));
    j = o + (u < 3 ? u : (u < 5 ? u - 2 : 2));
  } else {  // H12, row-major
    i = (k - 7) / 3;
    j = 3 + (k - 7) % 3;
  }
  out[1 + 6 * i + j] = v;
  out[1 + 6 * j + i] = v;
}

// Sums v[0..NT) (NT = 1, or up to 32) over the whole grid into out in a
// fixed order, so a repeat launch on the same grid gives the same bits,
// with no serial walk over the blocks.  partials holds gridDim.x * NT
// floats; *ticket must be 0 on entry and is 0 again on exit.  Each block
// sums its warps (a shuffle tree for NT = 1, else a butterfly that leaves
// column l in lane l) and adds the warps in order into a row of its own;
// the last block to take a ticket (after a __threadfence) adds the G =
// gridDim.x rows with all its threads: kGroups = kThreads / NT groups of NT
// threads, group g adding rows g, g + kGroups, ... in turn (up to 32 loads in
// flight a thread), then the groups in order (NT > 1) or by a shuffle tree a
// warp and the warps in order (NT = 1); it writes out[0..NT), or with
// kNormalEq (NT = 28) the 43 floats of store_normal_eq.  Returns whether
// this block was the last, whose thread 0 (NT = 1) or threads 0..NT-1 wrote
// out.
template <int NT, bool kNormalEq = false>
__device__ bool grid_sum_tree(const float (&v)[NT], float* partials,
                              unsigned int* ticket, float* out) {
  static_assert(NT == 1 || (NT > 1 && NT <= 32), "NT: 1 or 2..32");
  static_assert(!kNormalEq || NT == 28, "the normal equations take the 28 sums");
  constexpr int kGroups = kThreads / NT;
  constexpr int kBatch = NT == 1 ? 8 : 32;  // loads in flight a thread
  __shared__ float s[kWarps][NT == 1 ? 1 : 32];
  __shared__ float grp[kGroups * NT];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned int G = gridDim.x;
  if constexpr (NT == 1) {
    const float r = warp_sum(v[0]);
    if (lane == 0) s[warp][0] = r;
  } else {
    float c[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) c[k] = k < NT ? v[k] : 0.f;
    s[warp][lane] = warp_sum_scatter32(c);
  }
  __syncthreads();
  if (threadIdx.x < NT) {
    float r = 0.f;
    for (int w = 0; w < kWarps; ++w) r += s[w][threadIdx.x];
    partials[blockIdx.x * NT + threadIdx.x] = r;
    __threadfence();  // the row is visible device-wide before the ticket
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == G - 1;
  __syncthreads();
  if (!last) return false;
  if (threadIdx.x < kGroups * NT) {
    const unsigned int g = threadIdx.x / NT, k = threadIdx.x % NT;
    float r = 0.f;
    for (unsigned int b0 = g; b0 < G; b0 += kBatch * kGroups) {
      float t[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const unsigned int b = b0 + i * kGroups;
        t[i] = b < G ? __ldcg(partials + b * NT + k) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) r += t[i];
    }
    grp[threadIdx.x] = r;
  }
  __syncthreads();
  if constexpr (NT == 1) {
    const float r = warp_sum(grp[threadIdx.x]);
    if (lane == 0) s[warp][0] = r;
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = 0.f;
      for (int w = 0; w < kWarps; ++w) t += s[w][0];
      out[0] = t;
    }
  } else if (threadIdx.x < NT) {
    float t = 0.f;
    for (int g = 0; g < kGroups; ++g) t += grp[g * NT + threadIdx.x];
    if constexpr (kNormalEq) {
      store_normal_eq(threadIdx.x, t, out);
    } else {
      out[threadIdx.x] = t;
    }
  }
  if (threadIdx.x == 0) *ticket = 0u;
  return true;
}

// The grid of a kernel whose blocks take per_block of n items a pass: the
// blocks the items need, at most one wave (the device's SMs times the
// blocks of `kernel` that fit on one, asked of the runtime once a device;
// kId names the kernel's cache, one id a kernel across all sources:
// ndt_linearize.cu takes 0-3, trial_error.cu 4-5, linearize.cu 6-7), a
// grid-stride loop taking the rest; at least 1.  0, with the error left for
// cudaGetLastError, if the runtime refuses.
constexpr int kMaxDevices = 16;

// The error code of a launch that wave_grid refused (never 0).
inline int refused() {
  const cudaError_t e = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
}

template <int kId>
inline int wave_grid(const void* kernel, long long n, int per_block) {
  static int waves[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  int wave = dev < kMaxDevices ? waves[dev] : 0;
  if (wave == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) !=
            cudaSuccess)
      return 0;
    wave = sms * (per_sm < 1 ? 1 : per_sm);
    if (dev < kMaxDevices) waves[dev] = wave;
  }
  const long long need = (n + per_block - 1) / per_block;
  return static_cast<int>(need < 1 ? 1 : (need < wave ? need : wave));
}

struct Pose {
  float r00, r01, r02, t0, r10, r11, r12, t1, r20, r21, r22, t2;
};

__device__ __forceinline__ Pose load_pose(const float* __restrict__ x) {
  return {__ldg(x + 0), __ldg(x + 1), __ldg(x + 2),  __ldg(x + 3),
          __ldg(x + 4), __ldg(x + 5), __ldg(x + 6),  __ldg(x + 7),
          __ldg(x + 8), __ldg(x + 9), __ldg(x + 10), __ldg(x + 11)};
}

// A symmetric 3x3 matrix as its six unique entries.
struct Sym6 {
  float m00, m01, m02, m11, m12, m22;
};

// Source column n of a (3, L) array, transformed by the pose.
__device__ __forceinline__ void transform(const Pose& x, const float* __restrict__ p,
                                          int L, int n, float& p0, float& p1,
                                          float& p2) {
  const float s0 = p[n], s1 = p[L + n], s2 = p[2 * L + n];
  p0 = x.r00 * s0 + x.r01 * s1 + x.r02 * s2 + x.t0;
  p1 = x.r10 * s0 + x.r11 * s1 + x.r12 * s2 + x.t1;
  p2 = x.r20 * s0 + x.r21 * s1 + x.r22 * s2 + x.t2;
}

// R C R^T of column n of a (6, L) sym-6 array, R the pose's rotation.
__device__ __forceinline__ Sym6 rotate(const Pose& x, const float* __restrict__ ca,
                                       int L, int n) {
  const float c00 = ca[n], c01 = ca[L + n], c02 = ca[2 * L + n];
  const float c11 = ca[3 * L + n], c12 = ca[4 * L + n], c22 = ca[5 * L + n];
  const float R[3][3] = {{x.r00, x.r01, x.r02}, {x.r10, x.r11, x.r12},
                         {x.r20, x.r21, x.r22}};
  float B[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    B[i][0] = R[i][0] * c00 + R[i][1] * c01 + R[i][2] * c02;
    B[i][1] = R[i][0] * c01 + R[i][1] * c11 + R[i][2] * c12;
    B[i][2] = R[i][0] * c02 + R[i][1] * c12 + R[i][2] * c22;
  }
  auto rc = [&](int i, int j) {
    return B[i][0] * R[j][0] + B[i][1] * R[j][1] + B[i][2] * R[j][2];
  };
  return {rc(0, 0), rc(0, 1), rc(0, 2), rc(1, 1), rc(1, 2), rc(2, 2)};
}

// Adjugate inverse, the determinant clamped to +-1e-18 (a singular matrix
// would otherwise give 0 * inf = NaN, which no later mask removes); each
// entry is then multiplied by `valid`.
__device__ __forceinline__ Sym6 sym_inv(const Sym6& e, float valid) {
  const float a00 = e.m11 * e.m22 - e.m12 * e.m12;
  const float a01 = e.m02 * e.m12 - e.m01 * e.m22;
  const float a02 = e.m01 * e.m12 - e.m02 * e.m11;
  const float a11 = e.m00 * e.m22 - e.m02 * e.m02;
  const float a12 = e.m01 * e.m02 - e.m00 * e.m12;
  const float a22 = e.m00 * e.m11 - e.m01 * e.m01;
  float det = e.m00 * a00 + e.m01 * a01 + e.m02 * a02;
  if (fabsf(det) < 1e-18f) det = det < 0.f ? -1e-18f : 1e-18f;
  const float inv_det = 1.f / det;
  return {a00 * inv_det * valid, a01 * inv_det * valid, a02 * inv_det * valid,
          a11 * inv_det * valid, a12 * inv_det * valid, a22 * inv_det * valid};
}

// acc += w * [err, H (21 unique), b (6)] of e^T M e, J^T M J, J^T M e with
// e = q - p and J = [skew(p) | -I].
__device__ __forceinline__ void accumulate28(float (&acc)[28], float w, float p0,
                                             float p1, float p2, float q0, float q1,
                                             float q2, const Sym6& M) {
  const float m00 = M.m00, m01 = M.m01, m02 = M.m02;
  const float m11 = M.m11, m12 = M.m12, m22 = M.m22;
  const float d0 = q0 - p0, d1 = q1 - p1, d2 = q2 - p2;
  const float me0 = m00 * d0 + m01 * d1 + m02 * d2;
  const float me1 = m01 * d0 + m11 * d1 + m12 * d2;
  const float me2 = m02 * d0 + m12 * d1 + m22 * d2;
  // G = M skew(p)
  const float g00 = m01 * p2 - m02 * p1, g10 = m11 * p2 - m12 * p1;
  const float g20 = m12 * p2 - m22 * p1, g01 = m02 * p0 - m00 * p2;
  const float g11 = m12 * p0 - m01 * p2, g21 = m22 * p0 - m02 * p2;
  const float g02 = m00 * p1 - m01 * p0, g12 = m01 * p1 - m11 * p0;
  const float g22 = m02 * p1 - m12 * p0;
  const float terms[28] = {
      d0 * me0 + d1 * me1 + d2 * me2,
      // H11 = -(skew(p) G), 6 unique
      p2 * g10 - p1 * g20, p2 * g11 - p1 * g21, p2 * g12 - p1 * g22,
      p0 * g21 - p2 * g01, p0 * g22 - p2 * g02, p1 * g02 - p0 * g12,
      // H12 = skew(p) M (9)
      p1 * m02 - p2 * m01, p1 * m12 - p2 * m11, p1 * m22 - p2 * m12,
      p2 * m00 - p0 * m02, p2 * m01 - p0 * m12, p2 * m02 - p0 * m22,
      p0 * m01 - p1 * m00, p0 * m11 - p1 * m01, p0 * m12 - p1 * m02,
      // H22 = M (6)
      m00, m01, m02, m11, m12, m22,
      // b = [-p x Me; -Me]
      p2 * me1 - p1 * me2, p0 * me2 - p2 * me0, p1 * me0 - p0 * me1,
      -me0, -me1, -me2};
#pragma unroll
  for (int k = 0; k < 28; ++k) acc[k] += w * terms[k];
}

// e^T M e with e = q - p.
__device__ __forceinline__ float mahalanobis(float p0, float p1, float p2, float q0,
                                             float q1, float q2, const Sym6& M) {
  const float d0 = q0 - p0, d1 = q1 - p1, d2 = q2 - p2;
  const float me0 = M.m00 * d0 + M.m01 * d1 + M.m02 * d2;
  const float me1 = M.m01 * d0 + M.m11 * d1 + M.m12 * d2;
  const float me2 = M.m02 * d0 + M.m12 * d1 + M.m22 * d2;
  return d0 * me0 + d1 * me1 + d2 * me2;
}

}  // namespace fgt
