// Block-tridiagonal solve by block-Thomas elimination: the preconditioner of
// the sparse pose-graph solve.
//
// Replaces no Pallas kernel: it replaces XLA's compiled pair of `lax.scan`s
// in fast_gicp_tpu/models/pose_graph_sparse.py::_tridiag_solve, which solves
// the system with diagonal blocks D (K, 6, 6) (lambda I already added),
// super-diagonal blocks U (K, 6, 6) (U[K-1] unused) and right-hand side
// r (K, 6):
//   C_k = D_k - U_{k-1}^T G_{k-1},  G_k = C_k^-1 U_k,
//   y_k = C_k^-1 (r_k - U_{k-1}^T y_{k-1}),  x_k = y_k - G_k x_{k+1}.
// C_k, and with it G_k, depend on the linearization and lambda only, not on
// the right-hand side, so the solve is split in two entries:
//   * factor (once an LM trial): C_k, its unrolled LL^T with the diagonal
//     clamped at 1e-30 before the square root (linalg3.cholesky_solve), and
//     twelve column solves with that factor: C_k^-1 (the identity's columns)
//     and G_k (U_k's columns).  Outputs Cinv (K, 6, 6) and G (K, 6, 6).
//   * apply (once a CG iteration): the forward sweep for y and the backward
//     sweep for x, two 6x6 matrix-vector products a step each way.
//
// Bound on an H100: neither bytes nor FP32 operations, but the K-step
// serial chain.  An apply moves about 2 KB a step and does about 300 flops
// a step; each step waits for the previous one.  So one thread block walks
// k.  In the factor, 36 threads form C_k's entries, one thread factors it
// and 12 threads run the column solves, with a barrier between the three,
// and each thread loads its next step's inputs into registers before the
// barriers.  In the apply, one thread walks the chain from shared memory,
// while the block's other warps stage the next 32 steps' blocks into the
// other half of a double buffer; only the two 6-term dot products a step
// are on the chain.
//
// Built without FMA contraction, so the factor rounds as the plain PyTorch
// version's fixed-order products, LL^T and column solves do.

#include <cuda_runtime.h>

namespace {

constexpr int kFactorThreads = 64;
constexpr int kApplyThreads = 128;
constexpr int kChunk = 32;             // steps staged a round of the apply
constexpr int kFwdFloats = 36 + 36 + 6;  // Cinv_k, U_{k-1}, r_k
constexpr int kBwdFloats = 36 + 6;       // G_k, y_k

__global__ void __launch_bounds__(kFactorThreads)
    block_tridiag_factor_kernel(const float* __restrict__ D, const float* __restrict__ U,
                                float* __restrict__ Cinv, float* __restrict__ G, int K) {
  __shared__ float g_prev[36];
  __shared__ float c[36];
  __shared__ float l[36];
  const int t = threadIdx.x;
  const int i = t / 6, j = t % 6;
  // step 0's inputs: D_0 (threads < 36), U_0's column t - 6 (threads 6..11)
  float d_next = t < 36 ? D[t] : 0.f;
  float u_prev[6], u_col[6];
  for (int m = 0; m < 6; ++m) {
    u_prev[m] = 0.f;
    u_col[m] = (t >= 6 && t < 12) ? U[m * 6 + (t - 6)] : 0.f;
  }
  for (int k = 0; k < K; ++k) {
    const float d = d_next;
    float up[6], uc[6];
    for (int m = 0; m < 6; ++m) {
      up[m] = u_prev[m];
      uc[m] = u_col[m];
    }
    if (k + 1 < K) {  // the next step's inputs, in flight across the barriers
      if (t < 36) {
        d_next = D[(k + 1) * 36 + t];
        for (int m = 0; m < 6; ++m) u_prev[m] = U[k * 36 + m * 6 + i];  // U_k[m][i]
      }
      if (t >= 6 && t < 12)
        for (int m = 0; m < 6; ++m) u_col[m] = U[(k + 1) * 36 + m * 6 + (t - 6)];
    }
    // C_k[i][j] = D_k[i][j] - sum_m U_{k-1}[m][i] G_{k-1}[m][j], m in order
    if (t < 36) {
      float v = d;
      if (k > 0) {
        float acc = __fmul_rn(up[0], g_prev[j]);
        for (int m = 1; m < 6; ++m) acc = __fadd_rn(acc, __fmul_rn(up[m], g_prev[m * 6 + j]));
        v = __fsub_rn(v, acc);
      }
      c[t] = v;
    }
    __syncthreads();
    if (t == 0) {  // linalg3.cholesky_solve's LL^T, the 1e-30 clamp included
      for (int jj = 0; jj < 6; ++jj) {
        float s = c[jj * 6 + jj];
        for (int kk = 0; kk < jj; ++kk) s = __fsub_rn(s, __fmul_rn(l[jj * 6 + kk], l[jj * 6 + kk]));
        const float diag = __fsqrt_rn(s < 1e-30f ? 1e-30f : s);  // NaN stays NaN, as in torch.clamp
        l[jj * 6 + jj] = diag;
        const float inv_diag = __fdiv_rn(1.f, diag);
        for (int ii = jj + 1; ii < 6; ++ii) {
          float s2 = c[ii * 6 + jj];
          for (int kk = 0; kk < jj; ++kk)
            s2 = __fsub_rn(s2, __fmul_rn(l[ii * 6 + kk], l[jj * 6 + kk]));
          l[ii * 6 + jj] = __fmul_rn(s2, inv_diag);
        }
      }
    }
    __syncthreads();
    if (t < 12) {  // column t of C_k^-1 (t < 6) or of G_k = C_k^-1 U_k
      float b[6], y[6], x[6];
      for (int m = 0; m < 6; ++m) b[m] = t < 6 ? (m == t ? 1.f : 0.f) : uc[m];
      for (int ii = 0; ii < 6; ++ii) {
        float s = b[ii];
        for (int kk = 0; kk < ii; ++kk) s = __fsub_rn(s, __fmul_rn(l[ii * 6 + kk], y[kk]));
        y[ii] = __fdiv_rn(s, l[ii * 6 + ii]);
      }
      for (int ii = 5; ii >= 0; --ii) {
        float s = y[ii];
        for (int kk = ii + 1; kk < 6; ++kk) s = __fsub_rn(s, __fmul_rn(l[kk * 6 + ii], x[kk]));
        x[ii] = __fdiv_rn(s, l[ii * 6 + ii]);
      }
      float* out = t < 6 ? Cinv + k * 36 + t : G + k * 36 + (t - 6);
      for (int m = 0; m < 6; ++m) out[m * 6] = x[m];
      if (t >= 6)
        for (int m = 0; m < 6; ++m) g_prev[m * 6 + (t - 6)] = x[m];
    }
    __syncthreads();
  }
}

// Stage steps [k0, k0 + n) of the forward sweep into buf ([n][kFwdFloats]).
__device__ void stage_forward(float* buf, const float* __restrict__ Cinv,
                              const float* __restrict__ U, const float* __restrict__ r, int k0,
                              int n, int tid, int nthreads) {
  for (int e = tid; e < n * kFwdFloats; e += nthreads) {
    const int s = e / kFwdFloats, o = e - s * kFwdFloats, k = k0 + s;
    float v;
    if (o < 36)
      v = Cinv[k * 36 + o];
    else if (o < 72)
      v = k > 0 ? U[(k - 1) * 36 + (o - 36)] : 0.f;
    else
      v = r[k * 6 + (o - 72)];
    buf[e] = v;
  }
}

// Stage steps [k0, k0 + n) of the backward sweep into buf ([n][kBwdFloats]).
__device__ void stage_backward(float* buf, const float* __restrict__ G, const float* y, int k0,
                               int n, int tid, int nthreads) {
  for (int e = tid; e < n * kBwdFloats; e += nthreads) {
    const int s = e / kBwdFloats, o = e - s * kBwdFloats, k = k0 + s;
    buf[e] = o < 36 ? G[k * 36 + o] : y[k * 6 + (o - 36)];
  }
}

__global__ void __launch_bounds__(kApplyThreads)
    block_tridiag_apply_kernel(const float* __restrict__ Cinv, const float* __restrict__ G,
                               const float* __restrict__ U, const float* __restrict__ r,
                               float* x, int K) {
  __shared__ float buf[2][kChunk * kFwdFloats];
  const int tid = threadIdx.x;
  const int chunks = (K + kChunk - 1) / kChunk;
  // forward sweep: y_k, written to x
  stage_forward(buf[0], Cinv, U, r, 0, min(kChunk, K), tid, kApplyThreads);
  __syncthreads();
  float y[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int ch = 0; ch < chunks; ++ch) {
    const int k0 = ch * kChunk, n = min(kChunk, K - k0);
    if (tid >= 32) {
      if (ch + 1 < chunks)
        stage_forward(buf[(ch + 1) & 1], Cinv, U, r, k0 + kChunk,
                      min(kChunk, K - k0 - kChunk), tid - 32, kApplyThreads - 32);
    } else if (tid == 0) {
      const float* b = buf[ch & 1];
      for (int s = 0; s < n; ++s, b += kFwdFloats) {
        float v[6];
        for (int ii = 0; ii < 6; ++ii) {  // r_k - U_{k-1}^T y_{k-1}
          float acc = __fmul_rn(b[36 + ii], y[0]);
          for (int m = 1; m < 6; ++m) acc = __fadd_rn(acc, __fmul_rn(b[36 + m * 6 + ii], y[m]));
          v[ii] = __fsub_rn(b[72 + ii], acc);
        }
        for (int ii = 0; ii < 6; ++ii) {  // C_k^-1 v
          float acc = __fmul_rn(b[ii * 6], v[0]);
          for (int m = 1; m < 6; ++m) acc = __fadd_rn(acc, __fmul_rn(b[ii * 6 + m], v[m]));
          y[ii] = acc;
        }
        for (int ii = 0; ii < 6; ++ii) x[(k0 + s) * 6 + ii] = y[ii];
      }
    }
    __syncthreads();
  }
  // backward sweep: x_k = y_k - G_k x_{k+1}, x_K = 0
  {
    const int k0 = (chunks - 1) * kChunk;
    stage_backward(buf[0], G, x, k0, K - k0, tid, kApplyThreads);
  }
  __syncthreads();
  float xn[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int ch = chunks - 1, round = 0; ch >= 0; --ch, ++round) {
    const int k0 = ch * kChunk, n = min(kChunk, K - k0);
    if (tid >= 32) {
      if (ch > 0)
        stage_backward(buf[(round + 1) & 1], G, x, k0 - kChunk, kChunk, tid - 32,
                       kApplyThreads - 32);
    } else if (tid == 0) {
      const float* b = buf[round & 1] + (n - 1) * kBwdFloats;
      for (int s = n - 1; s >= 0; --s, b -= kBwdFloats) {
        float xk[6];
        for (int ii = 0; ii < 6; ++ii) {
          float acc = __fmul_rn(b[ii * 6], xn[0]);
          for (int m = 1; m < 6; ++m) acc = __fadd_rn(acc, __fmul_rn(b[ii * 6 + m], xn[m]));
          xk[ii] = __fsub_rn(b[36 + ii], acc);
        }
        for (int ii = 0; ii < 6; ++ii) {
          xn[ii] = xk[ii];
          x[(k0 + s) * 6 + ii] = xk[ii];
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

// D (K, 6, 6), U (K, 6, 6): float32 on the device.  Writes Cinv (K, 6, 6)
// and G (K, 6, 6).  Returns cudaGetLastError().
extern "C" int fgt_block_tridiag_factor(const float* D, const float* U, float* Cinv, float* G,
                                        int K, void* stream) {
  if (K > 0)
    block_tridiag_factor_kernel<<<1, kFactorThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        D, U, Cinv, G, K);
  return static_cast<int>(cudaGetLastError());
}

// Cinv, G, U (K, 6, 6) and r (K, 6): float32 on the device.  Writes x
// (K, 6), which must not alias r.  Returns cudaGetLastError().
extern "C" int fgt_block_tridiag_apply(const float* Cinv, const float* G, const float* U,
                                       const float* r, float* x, int K, void* stream) {
  if (K > 0)
    block_tridiag_apply_kernel<<<1, kApplyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        Cinv, G, U, r, x, K);
  return static_cast<int>(cudaGetLastError());
}
