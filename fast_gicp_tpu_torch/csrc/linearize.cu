// GICP/VGICP linearization and trial error, one thread per correspondence.
//
// Replaces fast_gicp_tpu/ops/pallas_linearize.py::_linearize_raw_kernel,
// ::_linearize_kernel (both with their shared core _lin_body) and
// ::_error_kernel.
//
// linearize_raw / linearize, per correspondence n (L of them):
//   unpack the gathered target row: raw voxel rows [count, sum mu (3),
//   sum cov (9 row-major), pad (3)] are divided by count (count 0 marks a
//   miss, which clears valid); finalized rows [mu (3), cov (9 row-major),
//   count, pad (3)] are read as they are (GICP's rows carry count 1).
//   Then, shared: transform the source point by the pose x,
//   M = (C_B + R C_A R^T)^-1 with the determinant clamped to +-1e-18,
//   w = sqrt(count) * valid; accumulate the 28 sums [err, H (21 unique),
//   b (6)] of w e^T M e, w J^T M J, w J^T M e with J = [skew(p) | -I];
//   write aux (10, L) = [M (6), w, mu_B (3)].
// error, per correspondence: sum of w e^T M e at a trial pose, reading the
//   frozen aux.
//
// Bound on an H100: device-memory bytes, and in practice launch latency.  At
// L = 22,528 a linearize moves about 3.2 MB (about 1 us at 3.35 TB/s) and an
// error call about 1.2 MB; each is a few hundred flops per correspondence.
// The design reads every input once with coalesced loads, keeps the 28 sums
// in registers, reduces them per block with warp shuffles into a scratch
// row per block, and lets the last block to finish (ticket counter after a
// __threadfence) add the block rows in block order -- so the cross-block sum
// is part of the kernel and its order does not depend on scheduling.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums v[0..NT) over the whole grid into out[0..NT).  partials holds
// gridDim.x * NT floats; *ticket must be 0 on entry and is 0 again on exit.
template <int NT>
__device__ void grid_sum(const float (&v)[NT], float* partials,
                         unsigned int* ticket, float* out) {
  __shared__ float s[kWarps][NT];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    const float r = warp_sum(v[k]);
    if (lane == 0) s[warp][k] = r;
  }
  __syncthreads();
  if (threadIdx.x < NT) {
    float r = 0.f;
    for (int w = 0; w < kWarps; ++w) r += s[w][threadIdx.x];
    partials[blockIdx.x * NT + threadIdx.x] = r;
    __threadfence();  // the row is visible device-wide before the ticket
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) {
    if (threadIdx.x < NT) {
      float r = 0.f;
      for (unsigned int b = 0; b < gridDim.x; ++b)
        r += __ldcg(partials + b * NT + threadIdx.x);
      out[threadIdx.x] = r;
    }
    if (threadIdx.x == 0) *ticket = 0u;
  }
}

struct Pose {
  float r00, r01, r02, t0, r10, r11, r12, t1, r20, r21, r22, t2;
};

__device__ __forceinline__ Pose load_pose(const float* __restrict__ x) {
  return {__ldg(x + 0), __ldg(x + 1), __ldg(x + 2),  __ldg(x + 3),
          __ldg(x + 4), __ldg(x + 5), __ldg(x + 6),  __ldg(x + 7),
          __ldg(x + 8), __ldg(x + 9), __ldg(x + 10), __ldg(x + 11)};
}

// The target side of one correspondence, unpacked from its 16-float row.
struct Target {
  float q0, q1, q2;                    // mu_B
  float b00, b01, b02, b11, b12, b22;  // C_B, sym-6
  float count, valid;
};

// Raw voxel row [count, sum mu (3), sum cov9, pad (3)]: finalized here.
__device__ __forceinline__ Target unpack_raw(const float4* __restrict__ rows, int n,
                                             float valid_in) {
  const float4 r0 = rows[4 * n + 0], r1 = rows[4 * n + 1];
  const float4 r2 = rows[4 * n + 2], r3 = rows[4 * n + 3];
  const float count = r0.x;
  const float alive = count > 0.f ? 1.f : 0.f;
  const float inv_n = alive / fmaxf(count, 1.f);
  // sym-6 of the row-major cov9 at row offsets 4, 5, 6, 8, 9, 12
  return {r0.y * inv_n, r0.z * inv_n, r0.w * inv_n,
          r1.x * inv_n, r1.y * inv_n, r1.z * inv_n,
          r2.x * inv_n, r2.y * inv_n, r3.x * inv_n,
          count, valid_in * alive};
}

// Finalized row [mu (3), cov9, count, pad (3)].
__device__ __forceinline__ Target unpack_finalized(const float4* __restrict__ rows, int n,
                                                   float valid_in) {
  const float4 r0 = rows[4 * n + 0], r1 = rows[4 * n + 1];
  const float4 r2 = rows[4 * n + 2], r3 = rows[4 * n + 3];
  // sym-6 of the row-major cov9 at row offsets 3, 4, 5, 7, 8, 11
  return {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.w, r2.x, r2.w, r3.x, valid_in};
}

template <bool kRaw>
__global__ void __launch_bounds__(kThreads)
    linearize_kernel(const float* __restrict__ p, const float* __restrict__ ca,
                     const float* __restrict__ xp, const float4* __restrict__ rows,
                     const float* __restrict__ valid_in, int L,
                     float* partials, unsigned int* ticket,
                     float* __restrict__ out, float* __restrict__ aux) {
  const Pose x = load_pose(xp);
  float acc[28];
#pragma unroll
  for (int k = 0; k < 28; ++k) acc[k] = 0.f;

  for (int n = blockIdx.x * kThreads + threadIdx.x; n < L; n += gridDim.x * kThreads) {
    const Target tg = kRaw ? unpack_raw(rows, n, valid_in[n])
                           : unpack_finalized(rows, n, valid_in[n]);
    const float q0 = tg.q0, q1 = tg.q1, q2 = tg.q2;
    const float b00 = tg.b00, b01 = tg.b01, b02 = tg.b02;
    const float b11 = tg.b11, b12 = tg.b12, b22 = tg.b22;
    const float count = tg.count, valid = tg.valid;

    const float s0 = p[n], s1 = p[L + n], s2 = p[2 * L + n];
    const float p0 = x.r00 * s0 + x.r01 * s1 + x.r02 * s2 + x.t0;
    const float p1 = x.r10 * s0 + x.r11 * s1 + x.r12 * s2 + x.t1;
    const float p2 = x.r20 * s0 + x.r21 * s1 + x.r22 * s2 + x.t2;

    // R C_A R^T
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
    const float e00 = b00 + rc(0, 0), e01 = b01 + rc(0, 1), e02 = b02 + rc(0, 2);
    const float e11 = b11 + rc(1, 1), e12 = b12 + rc(1, 2), e22 = b22 + rc(2, 2);

    // adjugate inverse, det clamped to +-1e-18
    const float a00 = e11 * e22 - e12 * e12;
    const float a01 = e02 * e12 - e01 * e22;
    const float a02 = e01 * e12 - e02 * e11;
    const float a11 = e00 * e22 - e02 * e02;
    const float a12 = e01 * e02 - e00 * e12;
    const float a22 = e00 * e11 - e01 * e01;
    float det = e00 * a00 + e01 * a01 + e02 * a02;
    if (fabsf(det) < 1e-18f) det = det < 0.f ? -1e-18f : 1e-18f;
    const float inv_det = 1.f / det;
    const float m00 = a00 * inv_det * valid, m01 = a01 * inv_det * valid;
    const float m02 = a02 * inv_det * valid, m11 = a11 * inv_det * valid;
    const float m12 = a12 * inv_det * valid, m22 = a22 * inv_det * valid;
    const float w = sqrtf(fmaxf(count, 0.f)) * valid;

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

    const float aux_n[10] = {m00, m01, m02, m11, m12, m22, w, q0, q1, q2};
#pragma unroll
    for (int k = 0; k < 10; ++k) aux[(size_t)k * L + n] = aux_n[k];
  }
  grid_sum<28>(acc, partials, ticket, out);
}

__global__ void __launch_bounds__(kThreads)
    error_kernel(const float* __restrict__ p, const float* __restrict__ xp,
                 const float* __restrict__ aux, int L, float* partials,
                 unsigned int* ticket, float* __restrict__ out) {
  const Pose x = load_pose(xp);
  float acc[1] = {0.f};
  for (int n = blockIdx.x * kThreads + threadIdx.x; n < L; n += gridDim.x * kThreads) {
    const float s0 = p[n], s1 = p[L + n], s2 = p[2 * L + n];
    const float p0 = x.r00 * s0 + x.r01 * s1 + x.r02 * s2 + x.t0;
    const float p1 = x.r10 * s0 + x.r11 * s1 + x.r12 * s2 + x.t1;
    const float p2 = x.r20 * s0 + x.r21 * s1 + x.r22 * s2 + x.t2;
    const float m00 = aux[n], m01 = aux[L + n], m02 = aux[2 * L + n];
    const float m11 = aux[3 * L + n], m12 = aux[4 * L + n], m22 = aux[5 * L + n];
    const float w = aux[6 * L + n];
    const float d0 = aux[7 * L + n] - p0, d1 = aux[8 * L + n] - p1;
    const float d2 = aux[9 * L + n] - p2;
    const float me0 = m00 * d0 + m01 * d1 + m02 * d2;
    const float me1 = m01 * d0 + m11 * d1 + m12 * d2;
    const float me2 = m02 * d0 + m12 * d1 + m22 * d2;
    acc[0] += w * (d0 * me0 + d1 * me1 + d2 * me2);
  }
  grid_sum<1>(acc, partials, ticket, out);
}

}  // namespace

// Number of blocks the wrappers size their partials scratch for.
extern "C" int fgt_reduce_blocks(int L) {
  const int blocks = (L + kThreads - 1) / kThreads;
  return blocks < 1 ? 1 : (blocks > 264 ? 264 : blocks);
}

// p (3, L), ca (6, L), x (4, 4), rows (L, 16), valid (L,): float32; rows
// raw ([count, sum mu, sum cov9, pad]).  partials: fgt_reduce_blocks(L) * 28
// floats; ticket: one zeroed uint32.  out: 28 floats; aux: (10, L).
extern "C" int fgt_linearize_raw(const float* p, const float* ca, const float* x,
                                 const float* rows, const float* valid, int L,
                                 float* partials, unsigned int* ticket, float* out,
                                 float* aux, void* stream) {
  linearize_kernel<true><<<fgt_reduce_blocks(L), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      p, ca, x, reinterpret_cast<const float4*>(rows), valid, L, partials, ticket,
      out, aux);
  return static_cast<int>(cudaGetLastError());
}

// As fgt_linearize_raw, with finalized rows ([mu, cov9, count, pad]).
extern "C" int fgt_linearize(const float* p, const float* ca, const float* x,
                             const float* rows, const float* valid, int L,
                             float* partials, unsigned int* ticket, float* out,
                             float* aux, void* stream) {
  linearize_kernel<false><<<fgt_reduce_blocks(L), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      p, ca, x, reinterpret_cast<const float4*>(rows), valid, L, partials, ticket,
      out, aux);
  return static_cast<int>(cudaGetLastError());
}

// p (3, L), x (4, 4), aux (10, L): float32.  partials: fgt_reduce_blocks(L)
// floats; ticket: one zeroed uint32; out: 1 float.
extern "C" int fgt_error(const float* p, const float* x, const float* aux, int L,
                         float* partials, unsigned int* ticket, float* out,
                         void* stream) {
  error_kernel<<<fgt_reduce_blocks(L), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(p, x, aux, L, partials,
                                                      ticket, out);
  return static_cast<int>(cudaGetLastError());
}
