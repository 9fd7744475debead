// One Levenberg-Marquardt trial step in one thread.
//
// Replaces fast_gicp_tpu/ops/pallas_solver.py::_lm_trial_kernel.  Solves
// (H + lambda I) d = -b by an unrolled 6x6 Cholesky (diagonal clamped at
// 1e-30 before the square root) plus one iterative-refinement step, then
// forms delta = se3_exp(d) (quaternion rotation, Taylor branch below
// theta^2 < 1e-10, V := R there), xi = delta x and
// denom = d . (lambda d - b).  lambda is read from device memory, so the
// solver never copies it to the host.
//
// Bound on an H100: launch latency.  The step reads 59 floats, writes 39
// and does about a thousand flops; one thread does all of it, because the
// time is the launch itself and a dependent chain of 6x6 solves gains
// nothing from more threads.
//
// out (39 floats): xi (4x4 row-major), delta (4x4 row-major), d (6), denom.

#include <cuda_runtime.h>

namespace {

constexpr float kSmallAngleSq = 1e-10f;

__device__ void chol_solve6(const float (&a)[6][6], const float (&rhs)[6],
                            float (&x)[6]) {
  float L[6][6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = a[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    const float diag = sqrtf(fmaxf(s, 1e-30f));
    L[j][j] = diag;
    const float inv_diag = 1.f / diag;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float t = a[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t = t - L[i][k] * L[j][k];
      L[i][j] = t * inv_diag;
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = rhs[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

__global__ void lm_trial_kernel(const float* __restrict__ H, const float* __restrict__ b,
                                const float* __restrict__ lam_p,
                                const float* __restrict__ x, float* __restrict__ out) {
  const float lam = *lam_p;
  float a[6][6], rhs[6], bb[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) a[i][j] = H[6 * i + j] + (i == j ? lam : 0.f);
    bb[i] = b[i];
    rhs[i] = -bb[i];
  }
  float d0[6], r[6], dr[6], d[6];
  chol_solve6(a, rhs, d0);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float ad = 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k) ad += a[i][k] * d0[k];
    r[i] = rhs[i] - ad;
  }
  chol_solve6(a, r, dr);
#pragma unroll
  for (int i = 0; i < 6; ++i) d[i] = d0[i] + dr[i];

  // se3_exp(d)
  const float w0 = d[0], w1 = d[1], w2 = d[2];
  const float theta_sq = w0 * w0 + w1 * w1 + w2 * w2;
  const bool small = theta_sq < kSmallAngleSq;
  const float ts_safe = small ? 1.f : theta_sq;
  const float theta = sqrtf(ts_safe);
  const float theta_quad = theta_sq * theta_sq;
  const float imag = small ? 0.5f - theta_sq / 48.f + theta_quad / 3840.f
                           : sinf(0.5f * theta) / theta;
  const float real = small ? 1.f - theta_sq / 8.f + theta_quad / 384.f
                           : cosf(0.5f * theta);
  const float qw = real, qx = imag * w0, qy = imag * w1, qz = imag * w2;
  const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
  const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
  const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
  const float R[3][3] = {{1.f - 2.f * (yy + zz), 2.f * (xy - wz), 2.f * (xz + wy)},
                         {2.f * (xy + wz), 1.f - 2.f * (xx + zz), 2.f * (yz - wx)},
                         {2.f * (xz - wy), 2.f * (yz + wx), 1.f - 2.f * (xx + yy)}};
  const float av = (1.f - cosf(theta)) / ts_safe;
  const float bv = (theta - sinf(theta)) / (ts_safe * theta);
  const float W[3][3] = {{0.f, -w2, w1}, {w2, 0.f, -w0}, {-w1, w0, 0.f}};
  float t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float ti = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float w2ik = 0.f;
#pragma unroll
      for (int m = 0; m < 3; ++m) w2ik += W[i][m] * W[m][k];
      const float v = small ? R[i][k] : (i == k ? 1.f : 0.f) + av * W[i][k] + bv * w2ik;
      ti += v * d[3 + k];
    }
    t[i] = ti;
  }

  const float D[4][4] = {{R[0][0], R[0][1], R[0][2], t[0]},
                         {R[1][0], R[1][1], R[1][2], t[1]},
                         {R[2][0], R[2][1], R[2][2], t[2]},
                         {0.f, 0.f, 0.f, 1.f}};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) s += D[i][k] * x[4 * k + j];
      out[4 * i + j] = s;
      out[16 + 4 * i + j] = D[i][j];
    }
  }
  float denom = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    out[32 + i] = d[i];
    denom += d[i] * (lam * d[i] - bb[i]);
  }
  out[38] = denom;
}

}  // namespace

// H (6, 6), b (6,), lambda (1,), x (4, 4): float32 on the device.
// out: 39 floats.  Returns cudaGetLastError().
extern "C" int fgt_lm_trial(const float* H, const float* b, const float* lam,
                            const float* x, float* out, void* stream) {
  lm_trial_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(H, b, lam, x, out);
  return static_cast<int>(cudaGetLastError());
}
