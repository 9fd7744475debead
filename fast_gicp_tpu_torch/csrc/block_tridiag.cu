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
// serial chain: each step waits for the previous one, and a step's own
// dependent operations (20 in the apply; 124 in the factor, 6 square roots
// and 18 IEEE divisions among them) are what a launch takes.  So each entry
// is one warp walking the chain, with nothing but register shuffles between
// the lanes of a step, and its operands off the chain:
//   * they come in chunks of kChunk steps by bulk copies (the Tensor Memory
//     Accelerator) into a ring of shared-memory slots, each completing on an
//     mbarrier of its slot.  Lane 0 issues a chunk's copies as soon as the
//     walk has left the chunk before it in the slot, and the walk waits on
//     the slot once a chunk and reads from shared memory.  A warp's own
//     loads into registers would not stay ahead of it: the scoreboards that
//     track them also track its shuffles, so a step would wait for the loads
//     issued for later steps.
//   * apply: lane i (< 6) on row i of a step.  Forward,
//     v_i = r_k[i] - sum_m U_{k-1}[m][i] y_{k-1}[m], then
//     y_k[i] = sum_m Cinv_k[i][m] v_m; backward,
//     x_k[i] = y_k[i] - sum_m G_k[i][m] x_{k+1}[m]; the six values of the
//     previous product come by __shfl_sync.  The backward sweep walks the
//     forward's chunks in reverse.  y stays in shared memory up to
//     kOnChipSteps steps; above that it goes through x and comes back by
//     bulk copy.
//   * factor: lanes 0-20 form C_k's 21 lower entries (G_{k-1}'s columns by
//     shuffle from the lanes that solved them), a shuffle broadcasts them,
//     every lane forms the same LL^T in its registers (SIMT issues it once
//     for the warp), and lanes 0-11 run the twelve column solves with it,
//     the forward substitution interleaved with the factor's columns.  A
//     division's fast path refuses a zero numerator, and the identity's
//     columns give the forward substitution many: those lanes take IEEE's
//     quotient of a zero directly (div_rn), so the warp stays on the fast
//     path.
//   * the walks' loops are unrolled 8 steps; the next step's operands are
//     read from shared memory while a step runs.
//
// Every entry is formed with the plain PyTorch version's products and sums
// in its order, each rounded on its own (the `_rn` intrinsics, and the file
// is built without FMA contraction), so both entries give the plain
// versions' bits.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAllLanes = 0xffffffffu;
constexpr int kChunk = 16;          // steps a bulk copy brings
constexpr int kSlots = 3;           // the apply's ring slots (the factor's: 2)
constexpr int kOnChipSteps = 1024;  // the apply's y in shared memory (24 KB) up to this K

// Index of C_k's lower entry (i, j), i >= j, in column order: (0, 0) ..
// (5, 0), (1, 1) .. (5, 1), ..., (5, 5).
__host__ __device__ constexpr int tri(int i, int j) { return j * 6 - j * (j - 1) / 2 + (i - j); }

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// mbarrier of a slot: one arrival (lane 0's, with the bytes it expects) a phase
__device__ __forceinline__ void slot_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem(bar)) : "memory");
}

__device__ __forceinline__ void slot_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem(bar)),
               "r"(bytes)
               : "memory");
}

// bytes (a multiple of 16, both ends 16-byte aligned) from global src to dst
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem(dst)),
      "l"(src), "r"(bytes), "r"(smem(bar))
      : "memory");
}

__device__ __forceinline__ void slot_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem(bar)),
      "r"(parity)
      : "memory");
}

// after the warp's last reads of a slot, before lane 0 copies into it again
__device__ __forceinline__ void slot_release() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncwarp();
}

__device__ __forceinline__ void slots_ready(unsigned long long* bars, int n) {
  if (threadIdx.x == 0) {
    for (int q = 0; q < n; ++q) slot_init(bars + q);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
}

// __fdiv_rn(s, d) for the forward substitution, whose numerators start at
// the identity's zeros: a zero numerator fails the division's fast-path
// check and sends the whole warp down its slow path, so such a lane
// divides 1 instead and takes the quotient IEEE gives a zero numerator (a
// zero with the sign of s times that of d; NaN where d is 0 or NaN).
__device__ __forceinline__ float div_rn(float s, float d) {
  const float q = __fdiv_rn(s == 0.f ? 1.f : s, d);
  const float z = d != d || d == 0.f
                      ? __int_as_float(0x7fffffff)
                      : __int_as_float((__float_as_int(s) ^ __float_as_int(d)) & 0x80000000);
  return s == 0.f ? z : q;
}

// Lane 0: the bulk copies of the factor's chunk c into slot c % 2: D_k for
// k = k0 .. k0 + n - 1 into fd, U_k for k = k0 - 1 .. k0 + n - 1 into fu
// (k0 = 0: from position 1).
__device__ __forceinline__ void factor_issue(float (*fd)[kChunk * 36],
                                             float (*fu)[(kChunk + 1) * 36],
                                             unsigned long long* bars, const float* D,
                                             const float* U, int K, int c) {
  const int k0 = c * kChunk, n = min(kChunk, K - k0);
  const int u0 = k0 > 0 ? k0 - 1 : 0, un = k0 > 0 ? n + 1 : n;
  unsigned long long* bar = &bars[c & 1];
  slot_expect(bar, (n + un) * 144);
  bulk_copy(fd[c & 1], D + k0 * 36, n * 144, bar);
  bulk_copy(fu[c & 1] + (k0 > 0 ? 0 : 36), U + u0 * 36, un * 144, bar);
}

__global__ void __launch_bounds__(kWarp)
    block_tridiag_factor_kernel(const float* __restrict__ D, const float* __restrict__ U,
                                float* __restrict__ Cinv, float* __restrict__ G, int K,
                                int* __restrict__ launches) {
  __shared__ __align__(128) float fd[2][kChunk * 36];
  __shared__ __align__(128) float fu[2][(kChunk + 1) * 36];
  __shared__ __align__(8) unsigned long long bars[2];
  const int t = threadIdx.x;
  const int chunks = (K + kChunk - 1) / kChunk;
  if (t == 0 && launches != nullptr) atomicAdd(launches, 1);
  slots_ready(bars, 2);
  if (t == 0)
    for (int c = 0; c < min(2, chunks); ++c) factor_issue(fd, fu, bars, D, U, K, c);
  // C_k's entry (ci, cj) of this lane; lanes 21-31 repeat entry 20
  int e = t < 20 ? t : 20, cj = 0;
  while (e >= 6 - cj) {
    e -= 6 - cj;
    ++cj;
  }
  const int ci = cj + e;
  // this lane's column solve: col < 6 the identity's column col (C_k^-1),
  // col >= 6 U_k's column gj = col - 6 (G_k); lanes 12-31 repeat column 11
  const int col = t < 11 ? t : 11;
  const bool g_col = col >= 6;
  const int gj = g_col ? col - 6 : 0;
  float xs[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // this lane's column, the last step's
  for (int c = 0; c < chunks; ++c) {
    const int sl = c & 1, k0 = c * kChunk, n = min(kChunk, K - k0);
    slot_wait(&bars[sl], (c >> 1) & 1);
    // a step's operands: D_k[ci][cj], U_{k-1}[m][ci] and U_k[m][gj] (the
    // next step's read from shared memory while this one runs)
    float d = fd[sl][ci * 6 + cj], up[6], uc[6];
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      up[m] = fu[sl][m * 6 + ci];
      uc[m] = fu[sl][36 + m * 6 + gj];
    }
    for (int s = 0; s < n; ++s) {
      const int k = k0 + s, sn = min(s + 1, n - 1);
      const float d_next = fd[sl][sn * 36 + ci * 6 + cj];
      float up_next[6], uc_next[6];
#pragma unroll
      for (int m = 0; m < 6; ++m) {
        up_next[m] = fu[sl][sn * 36 + m * 6 + ci];
        uc_next[m] = fu[sl][(sn + 1) * 36 + m * 6 + gj];
      }
      // C_k[ci][cj] = D_k[ci][cj] - sum_m U_{k-1}[m][ci] G_{k-1}[m][cj], m in order
      float v = d;
      if (k > 0) {
        float g[6];
#pragma unroll
        for (int m = 0; m < 6; ++m) g[m] = __shfl_sync(kAllLanes, xs[m], 6 + cj);
        float acc = __fmul_rn(up[0], g[0]);
#pragma unroll
        for (int m = 1; m < 6; ++m) acc = __fadd_rn(acc, __fmul_rn(up[m], g[m]));
        v = __fsub_rn(v, acc);
      }
      float c21[21];
#pragma unroll
      for (int q = 0; q < 21; ++q) c21[q] = __shfl_sync(kAllLanes, v, q);
      // linalg3.cholesky_solve's LL^T, the 1e-30 clamp included, with this
      // lane's forward substitution L y = b as each column of L is done
      float l[21], y[6];
#pragma unroll
      for (int jj = 0; jj < 6; ++jj) {
        float sd = c21[tri(jj, jj)];
#pragma unroll
        for (int kk = 0; kk < jj; ++kk)
          sd = __fsub_rn(sd, __fmul_rn(l[tri(jj, kk)], l[tri(jj, kk)]));
        const float diag = __fsqrt_rn(sd < 1e-30f ? 1e-30f : sd);  // NaN stays NaN, as in torch.clamp
        l[tri(jj, jj)] = diag;
        const float inv_diag = __fdiv_rn(1.f, diag);
#pragma unroll
        for (int ii = jj + 1; ii < 6; ++ii) {
          float s2 = c21[tri(ii, jj)];
#pragma unroll
          for (int kk = 0; kk < jj; ++kk)
            s2 = __fsub_rn(s2, __fmul_rn(l[tri(ii, kk)], l[tri(jj, kk)]));
          l[tri(ii, jj)] = __fmul_rn(s2, inv_diag);
        }
        float sy = g_col ? uc[jj] : (jj == col ? 1.f : 0.f);  // b
#pragma unroll
        for (int kk = 0; kk < jj; ++kk) sy = __fsub_rn(sy, __fmul_rn(l[tri(jj, kk)], y[kk]));
        y[jj] = div_rn(sy, diag);
      }
      // L^T x = y
#pragma unroll
      for (int ii = 5; ii >= 0; --ii) {
        float sx = y[ii];
#pragma unroll
        for (int kk = ii + 1; kk < 6; ++kk) sx = __fsub_rn(sx, __fmul_rn(l[tri(kk, ii)], xs[kk]));
        xs[ii] = __fdiv_rn(sx, l[tri(ii, ii)]);
      }
      if (t < 12) {
        float* out = g_col ? G + k * 36 + gj : Cinv + k * 36 + col;
#pragma unroll
        for (int m = 0; m < 6; ++m) out[m * 6] = xs[m];
      }
      d = d_next;
#pragma unroll
      for (int m = 0; m < 6; ++m) {
        up[m] = up_next[m];
        uc[m] = uc_next[m];
      }
    }
    if (c + 2 < chunks) {
      slot_release();
      if (t == 0) factor_issue(fd, fu, bars, D, U, K, c + 2);
    }
  }
}

// Lane 0: the bulk copies of the apply's job j into slot j % kSlots: forward
// chunk j (j < chunks): Cinv_k into sa, U_{k-1} into su (k0 = 0: from
// position 1), r_k into sv; else backward chunk 2 chunks - 1 - j: G_k into
// sa and, above kOnChipSteps, y_k into sv.  An odd last chunk's r and y
// rows end 8 bytes short of a 16-byte multiple: those two floats are read
// elsewhere (r_{K-1}[4..5] from global memory, y_{K-1} from the walk's
// registers).  `with_y` false leaves a backward job's y copy for later, its
// bytes already expected.
__device__ __forceinline__ void apply_issue(float (*sa)[kChunk * 36], float (*su)[kChunk * 36],
                                            float (*sv)[kChunk * 6], unsigned long long* bars,
                                            const float* Cinv, const float* G, const float* U,
                                            const float* r, const float* x, int K, int chunks,
                                            int j, bool y_on_chip, bool with_y) {
  const int sl = j % kSlots;
  unsigned long long* bar = &bars[sl];
  const bool fwd = j < chunks;
  const int c = fwd ? j : 2 * chunks - 1 - j, k0 = c * kChunk, n = min(kChunk, K - k0);
  const unsigned rows = (n * 24) & ~15u;
  if (fwd) {
    const int un = k0 > 0 ? n : n - 1;
    slot_expect(bar, n * 144 + un * 144 + rows);
    bulk_copy(sa[sl], Cinv + k0 * 36, n * 144, bar);
    if (un > 0) bulk_copy(su[sl] + (k0 > 0 ? 0 : 36), U + (k0 > 0 ? k0 - 1 : 0) * 36, un * 144, bar);
    if (rows > 0) bulk_copy(sv[sl], r + k0 * 6, rows, bar);
  } else {
    slot_expect(bar, n * 144 + (y_on_chip ? 0 : rows));
    bulk_copy(sa[sl], G + k0 * 36, n * 144, bar);
    if (!y_on_chip && with_y && rows > 0) bulk_copy(sv[sl], x + k0 * 6, rows, bar);
  }
}

__global__ void __launch_bounds__(kWarp)
    block_tridiag_apply_kernel(const float* __restrict__ Cinv, const float* __restrict__ G,
                               const float* __restrict__ U, const float* __restrict__ r,
                               float* x, int K, int* __restrict__ launches) {
  __shared__ __align__(128) float sa[kSlots][kChunk * 36];
  __shared__ __align__(128) float su[kSlots][kChunk * 36];
  __shared__ __align__(128) float sv[kSlots][kChunk * 6];
  __shared__ __align__(8) unsigned long long bars[kSlots];
  __shared__ float ys_on_chip[kOnChipSteps * 6];
  const int lane = threadIdx.x;
  const int i = lane < 6 ? lane : 5;  // row i; lanes 6-31 repeat row 5 and store nothing
  const int chunks = (K + kChunk - 1) / kChunk, jobs = 2 * chunks;
  // y_k of the forward sweep: on chip, or in x (which the backward sweep
  // overwrites once its chunk's copy of y has landed)
  const bool y_on_chip = K <= kOnChipSteps;
  const float r_last = r[(K - 1) * 6 + i];  // r_{K-1}[i], for an odd last chunk
  if (lane == 0 && launches != nullptr) atomicAdd(launches, 1);
  slots_ready(bars, kSlots);
  if (lane == 0)
    for (int j = 0; j < min(kSlots, jobs); ++j)
      apply_issue(sa, su, sv, bars, Cinv, G, U, r, x, K, chunks, j, y_on_chip, false);

  float y = 0.f;
  for (int j = 0; j < chunks; ++j) {  // forward sweep
    const int sl = j % kSlots, k0 = j * kChunk, n = min(kChunk, K - k0);
    slot_wait(&bars[sl], (j / kSlots) & 1);
    // a step's operands: Cinv_k[i][m], U_{k-1}[m][i], r_k[i] (the next
    // step's read from shared memory while this one runs)
    float ca[6], ua[6], ra = sv[sl][i];
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      ca[m] = sa[sl][i * 6 + m];
      ua[m] = su[sl][m * 6 + i];
    }
#pragma unroll 8
    for (int s = 0; s < n; ++s) {
      const int k = k0 + s, sn = min(s + 1, n - 1);
      float cn[6], un[6];
      const float rn = sv[sl][sn * 6 + i];
#pragma unroll
      for (int m = 0; m < 6; ++m) {
        cn[m] = sa[sl][sn * 36 + i * 6 + m];
        un[m] = su[sl][sn * 36 + m * 6 + i];
      }
      const float rk = k == K - 1 && (n & 1) && i >= 4 ? r_last : ra;
      float v = rk;  // r_k - U_{k-1}^T y_{k-1}
      if (k > 0) {
        float ym[6];
#pragma unroll
        for (int m = 0; m < 6; ++m) ym[m] = __shfl_sync(kAllLanes, y, m);
        float acc = __fmul_rn(ua[0], ym[0]);
#pragma unroll
        for (int m = 1; m < 6; ++m) acc = __fadd_rn(acc, __fmul_rn(ua[m], ym[m]));
        v = __fsub_rn(rk, acc);
      }
      float vm[6];  // C_k^-1 v
#pragma unroll
      for (int m = 0; m < 6; ++m) vm[m] = __shfl_sync(kAllLanes, v, m);
      float acc = __fmul_rn(ca[0], vm[0]);
#pragma unroll
      for (int m = 1; m < 6; ++m) acc = __fadd_rn(acc, __fmul_rn(ca[m], vm[m]));
      y = acc;
      if (lane < 6) {
        if (y_on_chip)
          ys_on_chip[k * 6 + i] = y;
        else
          x[k * 6 + i] = y;
      }
      ra = rn;
#pragma unroll
      for (int m = 0; m < 6; ++m) {
        ca[m] = cn[m];
        ua[m] = un[m];
      }
    }
    if (j + kSlots < jobs) {
      slot_release();
      if (lane == 0)
        apply_issue(sa, su, sv, bars, Cinv, G, U, r, x, K, chunks, j + kSlots, y_on_chip, false);
    }
  }
  if (!y_on_chip) asm volatile("fence.proxy.async.global;" ::: "memory");  // y, now in x
  __syncwarp();
  if (!y_on_chip && lane == 0) {
    // the backward jobs issued so far take their y
    for (int j = chunks; j < min(chunks + kSlots, jobs); ++j) {
      const int k0 = (jobs - 1 - j) * kChunk;
      const unsigned rows = (min(kChunk, K - k0) * 24) & ~15u;
      if (rows > 0) bulk_copy(sv[j % kSlots], x + k0 * 6, rows, &bars[j % kSlots]);
    }
  }

  float xn = 0.f;  // backward sweep: x_k = y_k - G_k x_{k+1}, x_K = 0
  for (int j = chunks; j < jobs; ++j) {
    const int sl = j % kSlots, k0 = (jobs - 1 - j) * kChunk, n = min(kChunk, K - k0);
    slot_wait(&bars[sl], (j / kSlots) & 1);
    // a step's operands: G_k[i][m] and y_k[i] (the next step's read while
    // this one runs)
    float ga[6], ya = y_on_chip ? ys_on_chip[(k0 + n - 1) * 6 + i] : sv[sl][(n - 1) * 6 + i];
#pragma unroll
    for (int m = 0; m < 6; ++m) ga[m] = sa[sl][(n - 1) * 36 + i * 6 + m];
#pragma unroll 8
    for (int s = n - 1; s >= 0; --s) {
      const int k = k0 + s, sn = max(s - 1, 0);
      float gn[6];
      const float yn = y_on_chip ? ys_on_chip[(k0 + sn) * 6 + i] : sv[sl][sn * 6 + i];
#pragma unroll
      for (int m = 0; m < 6; ++m) gn[m] = sa[sl][sn * 36 + i * 6 + m];
      const float yk = !y_on_chip && k == K - 1 ? y : ya;
      float xm[6];
#pragma unroll
      for (int m = 0; m < 6; ++m) xm[m] = __shfl_sync(kAllLanes, xn, m);
      float acc = __fmul_rn(ga[0], xm[0]);
#pragma unroll
      for (int m = 1; m < 6; ++m) acc = __fadd_rn(acc, __fmul_rn(ga[m], xm[m]));
      xn = __fsub_rn(yk, acc);
      if (lane < 6) x[k * 6 + i] = xn;
      ya = yn;
#pragma unroll
      for (int m = 0; m < 6; ++m) ga[m] = gn[m];
    }
    if (j + kSlots < jobs) {
      slot_release();
      if (lane == 0)
        apply_issue(sa, su, sv, bars, Cinv, G, U, r, x, K, chunks, j + kSlots, y_on_chip, true);
    }
  }
}

}  // namespace

// D (K, 6, 6), U (K, 6, 6): float32 on the device, 16-byte aligned.  Writes
// Cinv (K, 6, 6) and G (K, 6, 6).  `launches` (one int of device memory, or
// null): the kernel adds one to it as it runs, so a launch replayed from a
// CUDA graph counts too.  Returns cudaGetLastError().
extern "C" int fgt_block_tridiag_factor(const float* D, const float* U, float* Cinv, float* G,
                                        int K, int* launches, void* stream) {
  if (K > 0)
    block_tridiag_factor_kernel<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
        D, U, Cinv, G, K, launches);
  return static_cast<int>(cudaGetLastError());
}

// Cinv, G, U (K, 6, 6) and r (K, 6): float32 on the device, 16-byte
// aligned.  Writes x (K, 6), 16-byte aligned, which must not alias r.
// `launches` as the factor's.  Returns cudaGetLastError().
extern "C" int fgt_block_tridiag_apply(const float* Cinv, const float* G, const float* U,
                                       const float* r, float* x, int K, int* launches,
                                       void* stream) {
  if (K > 0)
    block_tridiag_apply_kernel<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
        Cinv, G, U, r, x, K, launches);
  return static_cast<int>(cudaGetLastError());
}
