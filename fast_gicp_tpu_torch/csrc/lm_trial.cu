// One Levenberg-Marquardt trial step in one thread.
//
// Replaces fast_gicp_tpu/ops/pallas_solver.py::_lm_trial_kernel.  Solves
// (H + lambda I) d = -b by an unrolled 6x6 Cholesky (diagonal clamped at
// 1e-30 before the square root) plus one iterative-refinement step, then
// forms delta = se3_exp(d) (quaternion rotation, Taylor branch below
// theta^2 < 1e-10, V := R there), xi = delta x and
// denom = d . (lambda d - b).  lambda is read from device memory, so the
// solver never copies it to the host.  The arithmetic is lm_step.cuh's
// lm_trial_step, which the LM solve runs inside its trial launch of the
// error kernel (trial_error.cu); this standalone kernel serves the
// Gauss-Newton step and the checks that hold the trial launch to it.
//
// Bound on an H100: launch latency.  The step reads 59 floats, writes 39
// and does about a thousand flops; one thread does all of it, because the
// time is the launch itself and a dependent chain of 6x6 solves gains
// nothing from more threads.
//
// out (39 floats): xi (4x4 row-major), delta (4x4 row-major), d (6), denom.

#include "lm_step.cuh"

namespace {

__global__ void lm_trial_kernel(const float* __restrict__ H, const float* __restrict__ b,
                                const float* __restrict__ lam_p,
                                const float* __restrict__ x, float* __restrict__ out) {
  fgt::lm_trial_step(H, b, *lam_p, x, out);
}

}  // namespace

// H (6, 6), b (6,), lambda (1,), x (4, 4): float32 on the device.
// out: 39 floats.  Returns cudaGetLastError().
extern "C" int fgt_lm_trial(const float* H, const float* b, const float* lam,
                            const float* x, float* out, void* stream) {
  lm_trial_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(H, b, lam, x, out);
  return static_cast<int>(cudaGetLastError());
}
