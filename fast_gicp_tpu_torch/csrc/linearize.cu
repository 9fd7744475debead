// GICP/VGICP linearization, one thread per correspondence.
//
// Replaces fast_gicp_tpu/ops/pallas_linearize.py::_linearize_raw_kernel and
// ::_linearize_kernel (both with their shared core _lin_body).  The trial
// error that reads their aux, ::_error_kernel, is trial_error.cu's.
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
//
// Bound on an H100: device-memory bytes, and in practice launch latency.  At
// L = 22,528 a linearize moves about 3.2 MB (about 1 us at 3.35 TB/s), a few
// hundred flops per correspondence.
// The design reads every input once with coalesced loads, keeps the 28 sums
// in registers and reduces them inside the kernel (lin_common.cuh's
// grid_sum, whose order does not depend on scheduling).

#include "lin_common.cuh"

using namespace fgt;

namespace {

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

    float p0, p1, p2;
    transform(x, p, L, n, p0, p1, p2);
    const Sym6 rc = rotate(x, ca, L, n);
    const Sym6 m = sym_inv({b00 + rc.m00, b01 + rc.m01, b02 + rc.m02, b11 + rc.m11,
                            b12 + rc.m12, b22 + rc.m22},
                           valid);
    const float w = sqrtf(fmaxf(count, 0.f)) * valid;
    accumulate28(acc, w, p0, p1, p2, q0, q1, q2, m);

    const float aux_n[10] = {m.m00, m.m01, m.m02, m.m11, m.m12, m.m22, w, q0, q1, q2};
#pragma unroll
    for (int k = 0; k < 10; ++k) aux[(size_t)k * L + n] = aux_n[k];
  }
  grid_sum<28>(acc, partials, ticket, out);
}

}  // namespace

// Grid of the GICP linearize kernels (and of their grid_sum) for L
// correspondences.
static int reduce_blocks(int L) {
  const int blocks = (L + kThreads - 1) / kThreads;
  return blocks < 1 ? 1 : (blocks > 264 ? 264 : blocks);
}

// Most blocks any linearize or error kernel of this library launches on the
// current device, so rows of partials a scratch needs: one wave of
// kThreads-blocks filling every SM (ndt_linearize.cu and trial_error.cu size
// their grids to a wave), and at least the 264 of the GICP linearize
// kernels.  -1 if the runtime refuses.
extern "C" int fgt_max_reduce_blocks() {
  int dev = 0, sms = 0, threads = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&threads, cudaDevAttrMaxThreadsPerMultiProcessor, dev) !=
          cudaSuccess)
    return -1;
  const int wave = sms * (threads / kThreads);
  return wave > 264 ? wave : 264;
}

// p (3, L), ca (6, L), x (4, 4), rows (L, 16), valid (L,): float32; rows
// raw ([count, sum mu, sum cov9, pad]).  partials: fgt_max_reduce_blocks()
// * 28 floats; ticket: one uint32, 0 on entry and left 0.  out: 28 floats;
// aux: (10, L).
extern "C" int fgt_linearize_raw(const float* p, const float* ca, const float* x,
                                 const float* rows, const float* valid, int L,
                                 float* partials, unsigned int* ticket, float* out,
                                 float* aux, void* stream) {
  linearize_kernel<true><<<reduce_blocks(L), kThreads, 0,
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
  linearize_kernel<false><<<reduce_blocks(L), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      p, ca, x, reinterpret_cast<const float4*>(rows), valid, L, partials, ticket,
      out, aux);
  return static_cast<int>(cudaGetLastError());
}
