// Device code of one Levenberg-Marquardt trial, shared by the standalone
// trial kernel (lm_trial.cu) and the trial launch of the error kernel
// (trial_error.cu): the trial step of fast_gicp_tpu/ops/pallas_solver.py::
// _lm_trial_kernel and the LM schedule of solver.lsq_solve, in the order of
// the plain PyTorch versions (ops/cuda_solver.py).  The sources that include
// this file are built with -fmad=false, so that the same inputs give the
// same bits in every kernel and every block that runs this code.

#pragma once

#include <cuda_runtime.h>

namespace fgt {

constexpr float kSmallAngleSq = 1e-10f;

// A solve's LM state (ops/cuda_solver.py STATE_*): the pose x, lambda, nu,
// the two flags a trial leaves for the host (done = accept | conv_reject,
// conv = delta passes the convergence test), and the last trial's xi,
// delta, d, denom, error and the lambda it ran with.
constexpr int kStateX = 0;         // 16, row-major
constexpr int kStateLam = 16;
constexpr int kStateNu = 17;
constexpr int kStateDone = 18;     // 1.f or 0.f
constexpr int kStateConv = 19;     // 1.f or 0.f
constexpr int kStateTrial = 20;    // 39: xi (16), delta (16), d (6), denom
constexpr int kStateYi = 59;
constexpr int kStateLamUsed = 60;
constexpr int kStateFloats = 64;
constexpr int kTrialFloats = 39;

// The larger of a and b, NaN if either is NaN (torch.max and torch.maximum
// propagate NaN, where fmaxf drops it).
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// The unrolled LL^T factor of a 6x6 SPD matrix, the diagonal clamped at
// 1e-30 before its square root (only L's lower triangle is written).
__device__ __forceinline__ void chol6(const float (&a)[6][6], float (&L)[6][6]) {
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
}

// Solves L L^T x = rhs by forward and back substitution.
__device__ __forceinline__ void chol_solve6(const float (&L)[6][6], const float (&rhs)[6],
                                            float (&x)[6]) {
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

// One trial step in one thread: solve (H + lambda I) d = -b by an unrolled
// 6x6 Cholesky (diagonal clamped at 1e-30 before the square root) plus one
// iterative-refinement step, then delta = se3_exp(d) (quaternion rotation,
// Taylor branch below theta^2 < 1e-10, V := R there), xi = delta x and
// denom = d . (lambda d - b).  out (39 floats): xi (4x4 row-major), delta
// (4x4 row-major), d (6), denom.
__device__ __forceinline__ void lm_trial_step(const float* H, const float* b, float lam,
                                              const float* x, float* out) {
  float a[6][6], rhs[6], bb[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) a[i][j] = H[6 * i + j] + (i == j ? lam : 0.f);
    bb[i] = b[i];
    rhs[i] = -bb[i];
  }
  // one factor for both solves (the refinement solves with the same matrix)
  float L[6][6], d0[6], r[6], dr[6], d[6];
  chol6(a, L);
  chol_solve6(L, rhs, d0);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float ad = 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k) ad += a[i][k] * d0[k];
    r[i] = rhs[i] - ad;
  }
  chol_solve6(L, r, dr);
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

// lambda at a solve's first trial after a linearization: factor *
// max|diag H| while lambda is still unset (< 0), else lambda as it stands.
// factor is the float32 rounding of the config's lm_init_lambda_factor.
__device__ __forceinline__ float lm_init_lambda(const float* H, float lam, float factor) {
  float m = fabsf(H[0]);
#pragma unroll
  for (int i = 1; i < 6; ++i) m = nan_max(m, fabsf(H[7 * i]));
  const float init = m * factor;
  return lam < 0.f ? init : lam;
}

// The LM schedule after a trial (lsq_registration_impl.hpp:53-168, in the
// order of the eager torch ops it replaces), written to `state`:
//   rho = (y0 - yi) / denom; reject = !(rho >= 0) (NaN-safe accept);
//   conv = max(max|R - I| * inv_rot, max|t| * inv_trans) < 1 on delta,
//     inv_* the float32 roundings of the epsilons' reciprocals (torch
//     divides a float32 CUDA tensor by a Python float as a product with
//     that reciprocal);
//   conv_reject = reject & conv;
//   lambda <- accept ? lambda max(1/3, 1 - u u u), u = 2 rho - 1 (NaN-propagating
//     clamp), : (conv_reject ? lambda : nu lambda);
//   nu <- reject & !conv_reject ? 2 nu : nu;  x <- accept ? xi : x;
//   done = accept | conv_reject.
// t: the trial's 39 floats; x: the pose it started from; lam, nu: the
// values it ran with.  Also copies the trial into the state and records
// lam as the lambda used; yi is already in the state.
__device__ __forceinline__ void lm_schedule(float y0, float yi, const float* t,
                                            const float* x, float lam, float nu,
                                            float inv_rot, float inv_trans,
                                            float* state) {
  const float* delta = t + 16;
  const float rho = (y0 - yi) / t[38];
  const bool reject = !(rho >= 0.f);
  float rmax = fabsf(delta[0] - 1.f), tmax = fabsf(delta[3]);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (i + j > 0) rmax = nan_max(rmax, fabsf(delta[4 * i + j] - (i == j ? 1.f : 0.f)));
    if (i > 0) tmax = nan_max(tmax, fabsf(delta[4 * i + 3]));
  }
  const bool conv = nan_max(rmax * inv_rot, tmax * inv_trans) < 1.f;
  const bool conv_reject = reject && conv;
  const bool accept = !reject;
  const float u = 2.f * rho - 1.f;
  const float c = 1.f - u * u * u;
  const float third = static_cast<float>(1.0 / 3.0);
  const float clamped = c != c ? c : fmaxf(c, third);
  const float new_lam = accept ? lam * clamped : (conv_reject ? lam : nu * lam);
  const float new_nu = reject && !conv_reject ? 2.f * nu : nu;
#pragma unroll
  for (int k = 0; k < 16; ++k) state[kStateX + k] = accept ? t[k] : x[k];
#pragma unroll
  for (int k = 0; k < kTrialFloats; ++k) state[kStateTrial + k] = t[k];
  state[kStateLamUsed] = lam;
  state[kStateLam] = new_lam;
  state[kStateNu] = new_nu;
  state[kStateDone] = accept || conv_reject ? 1.f : 0.f;
  state[kStateConv] = conv ? 1.f : 0.f;
}

}  // namespace fgt
