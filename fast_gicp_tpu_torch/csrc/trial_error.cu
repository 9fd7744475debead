// The trial error of both objectives, and the LM trial launch that carries
// it.
//
// Replaces fast_gicp_tpu/ops/pallas_linearize.py::_error_kernel (GICP,
// VGICP) and ::_ndt_error_kernel (NDT) and, in its trial form, joins them to
// fast_gicp_tpu/ops/pallas_solver.py::_lm_trial_kernel and the LM schedule of
// solver.lsq_solve, so that an LM trial is one launch.
//
// error_kernel<kCauchy, kTrial>, per lane n of L (offset-major, L = K * N):
//   w e^T M e at the pose against the frozen aux (10, L) = [M (6), a, mu (3)],
//   the source point being column n % N of p; w = a (GICP, VGICP: the
//   linearize's weight) or, with kCauchy, c^2 / (c^2 + |mu - p|^2) * a
//   (NDT: a is `valid`, the Cauchy weight taken at the pose).  The lanes'
//   sum goes to out.
// With kTrial the pose is the trial's: every block first runs lm_step.cuh's
// trial step on the solve's state (thread 0, into shared memory; the same
// code on the same inputs under -fmad=false gives every block the same xi,
// so no block waits on another), then the body above at xi; the last block
// of the cross-block sum runs the LM schedule and writes the new state and
// the flags the host reads.  Its grid is the trial-off kernel's, so its sum,
// and with it every bit of the state, equals a standalone lm_trial launch,
// the trial-off launch and the eager schedule on the same inputs.
//
// Bound on an H100: device-memory bytes, and in practice the launch.  The
// function reads 12 B a source point and 40 B of aux a lane: at the paths'
// sizes (22,528 to 157,696 lanes) 1.2 to 6.6 MB, 0.35 to 2.0 us at
// 3.35 TB/s; the trial adds 98 floats and a dependent chain of about 700
// flops.  The design:
//   * four consecutive lanes a thread: each aux row one float4, the source
//     points read once from the untiled columns, as one float4 a
//     coordinate where N is a multiple of 4;
//   * a grid of one wave (the SMs times the blocks that fit, asked of the
//     runtime once a device), a grid-stride loop beyond; lin_common.cuh's
//     grid_sum_tree across blocks, in a fixed order;
//   * the trial's chain runs in thread 0 while the block's other threads'
//     first aux and source loads, which do not depend on the pose, are in
//     flight; the trial replaces the standalone trial launch and 34 eager
//     ops a trial, which the host would otherwise enqueue.

#include "launch_count.cuh"
#include "lin_common.cuh"
#include "lm_step.cuh"

using namespace fgt;

namespace {

constexpr int kErrorLanes = 4;  // lanes a thread: one float4 a row
// Blocks an SM the register budget allows: 3 (80 registers) for the
// trial-off kernel; 2 (128) with the trial, whose step needs about 100 in
// one thread, and whose grid (the trial-off kernel's: at most 264 blocks
// up to 270,336 lanes) still fits in one wave.
constexpr int kBlocksPerSm = 3;
constexpr int kTrialBlocksPerSm = 2;

// The solve's state and the normal equations of a trial launch.
struct Trial {
  const float* H;      // (6, 6)
  const float* b;      // (6,)
  const float* y0;     // the objective at the linearization point
  float* state;        // kStateFloats, updated in place
  int first;           // the first trial after a linearization: lambda init, nu = 2
  float lambda_factor; // lm_init_lambda_factor, float32
  float inv_rot;       // 1 / rotation_epsilon, float32
  float inv_trans;     // 1 / transformation_epsilon, float32
};

// w e^T M e of one lane at the pose: s its (untransformed) source point, a
// its aux column.
template <bool kCauchy>
__device__ __forceinline__ float error_lane(float s0, float s1, float s2, const Pose& x,
                                            const float (&a)[10], float c_sq) {
  const float p0 = x.r00 * s0 + x.r01 * s1 + x.r02 * s2 + x.t0;
  const float p1 = x.r10 * s0 + x.r11 * s1 + x.r12 * s2 + x.t1;
  const float p2 = x.r20 * s0 + x.r21 * s1 + x.r22 * s2 + x.t2;
  const Sym6 m = {a[0], a[1], a[2], a[3], a[4], a[5]};
  if constexpr (kCauchy) {
    const float e0 = a[7] - p0, e1 = a[8] - p1, e2 = a[9] - p2;
    const float w = c_sq / (c_sq + e0 * e0 + e1 * e1 + e2 * e2) * a[6];
    return w * mahalanobis(p0, p1, p2, a[7], a[8], a[9], m);
  } else {
    return a[6] * mahalanobis(p0, p1, p2, a[7], a[8], a[9], m);
  }
}

// The aux columns and source points of lane group g (lanes 4g..4g+3): each
// aux row as one float4 when L is a multiple of 4 (vec_aux), the four
// source points as one float4 a coordinate when they are consecutive
// columns of p (vec_p: N and the row stride multiples of 4); else lane by
// lane, lanes past L reading lane L - 1.
__device__ __forceinline__ void load_group(const float* __restrict__ p, int ps, int N,
                                           const float* __restrict__ aux, int L,
                                           bool vec_aux, bool vec_p, int g,
                                           float (&a)[kErrorLanes][10],
                                           float (&s)[kErrorLanes][3]) {
  const int n0 = kErrorLanes * g;
  if (vec_aux) {
#pragma unroll
    for (int r = 0; r < 10; ++r) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(aux + (size_t)r * L) + g);
      a[0][r] = v.x;
      a[1][r] = v.y;
      a[2][r] = v.z;
      a[3][r] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kErrorLanes; ++j) {
      const int n = min(n0 + j, L - 1);
#pragma unroll
      for (int r = 0; r < 10; ++r) a[j][r] = __ldg(aux + (size_t)r * L + n);
    }
  }
  if (vec_p) {
    const int i0 = n0 % N;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p + (size_t)r * ps + i0));
      s[0][r] = v.x;
      s[1][r] = v.y;
      s[2][r] = v.z;
      s[3][r] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kErrorLanes; ++j) {
      const int i = min(n0 + j, L - 1) % N;
#pragma unroll
      for (int r = 0; r < 3; ++r) s[j][r] = __ldg(p + (size_t)r * ps + i);
    }
  }
}

// The trial step of a trial launch, in one thread: x, lambda and nu from
// the state (lambda initialised and nu = 2 at a first trial), the trial's
// 39 floats into t; y0 read here too, off the schedule's path.
__device__ __forceinline__ void trial_prologue(const Trial& tr, float* t, float* x,
                                               float* lam_nu_y0) {
#pragma unroll
  for (int k = 0; k < 16; ++k) x[k] = tr.state[kStateX + k];
  float lam = tr.state[kStateLam], nu = tr.state[kStateNu];
  lam_nu_y0[2] = *tr.y0;
  if (tr.first) {
    lam = lm_init_lambda(tr.H, lam, tr.lambda_factor);
    nu = 2.f;
  }
  lam_nu_y0[0] = lam;
  lam_nu_y0[1] = nu;
  lm_trial_step(tr.H, tr.b, lam, x, t);
}

// Four consecutive lanes a thread, in a grid-stride loop; lane n reads
// source column n % N of p (row stride ps).  kTrial: the pose is the
// trial's xi (xp unused), out is the state's error slot.
template <bool kCauchy, bool kTrial>
__global__ void __launch_bounds__(kThreads, kTrial ? kTrialBlocksPerSm : kBlocksPerSm)
    error_kernel(const float* __restrict__ p, int ps, int N, const float* __restrict__ xp,
                 const float* __restrict__ aux, float c_sq, int L, bool vec_aux, bool vec_p,
                 float* partials, unsigned int* ticket, float* out, Trial tr,
                 int* __restrict__ launches) {
  count_launch(launches);
  const int groups = (L + kErrorLanes - 1) / kErrorLanes;
  const int stride = gridDim.x * kThreads;
  int g = blockIdx.x * kThreads + threadIdx.x;
  float a[kErrorLanes][10], s[kErrorLanes][3];
  __shared__ float t[kTrialFloats], x0[16], lam_nu_y0[3];
  Pose x;
  if constexpr (kTrial) {
    // thread 0 runs the trial's chain while the block's other threads have
    // their first group's loads, which do not depend on the pose, in
    // flight; thread 0 loads its group after the chain, so that no load is
    // held in registers across it
    if (threadIdx.x == 0) {
      trial_prologue(tr, t, x0, lam_nu_y0);
    } else if (g < groups) {
      load_group(p, ps, N, aux, L, vec_aux, vec_p, g, a, s);
    }
    __syncthreads();
    if (threadIdx.x == 0 && g < groups) load_group(p, ps, N, aux, L, vec_aux, vec_p, g, a, s);
    x = {t[0], t[1], t[2], t[3], t[4], t[5], t[6], t[7], t[8], t[9], t[10], t[11]};
  } else {
    if (g < groups) load_group(p, ps, N, aux, L, vec_aux, vec_p, g, a, s);
    x = load_pose(xp);
  }

  float acc[1] = {0.f};
  while (g < groups) {
    const int n0 = kErrorLanes * g;
#pragma unroll
    for (int j = 0; j < kErrorLanes; ++j)
      if (n0 + j < L) acc[0] += error_lane<kCauchy>(s[j][0], s[j][1], s[j][2], x, a[j], c_sq);
    g += stride;
    if (g < groups) load_group(p, ps, N, aux, L, vec_aux, vec_p, g, a, s);
  }
  if (!grid_sum_tree<1>(acc, partials, ticket, out)) return;
  if constexpr (kTrial) {
    if (threadIdx.x == 0)
      lm_schedule(lam_nu_y0[2], out[0], t, x0, lam_nu_y0[0], lam_nu_y0[1], tr.inv_rot,
                  tr.inv_trans, tr.state);
  }
}

// One launch of error_kernel<kCauchy, kTrial> on the grid of the trial-off
// kernel (one wave of it), so that both forms sum in the same order.
template <bool kCauchy, bool kTrial>
int launch(const float* p, int ps, int N, const float* x, const float* aux, float c_sq,
           int L, float* partials, unsigned int* ticket, float* out, const Trial& tr,
           int* launches, void* stream) {
  const int grid = wave_grid<4 + kCauchy>(
      reinterpret_cast<const void*>(error_kernel<kCauchy, false>), L, kThreads * kErrorLanes);
  if (grid == 0) return refused();
  auto aligned = [](const float* ptr) { return reinterpret_cast<size_t>(ptr) % 16 == 0; };
  const bool vec_aux = L % kErrorLanes == 0 && aligned(aux);
  const bool vec_p = N % kErrorLanes == 0 && ps % kErrorLanes == 0 && aligned(p);
  error_kernel<kCauchy, kTrial><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, ps, N, x, aux, c_sq, L, vec_aux, vec_p, partials, ticket, out, tr, launches);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// GICP / VGICP: p (3, L), x (4, 4), aux (10, L) [M (6), w, mu (3)]:
// float32.  partials: fgt_max_reduce_blocks() floats; ticket: one uint32, 0
// on entry and left 0; out: 1 float.  launches: the tally slot (one int of
// device memory, or null).
extern "C" int fgt_error(const float* p, const float* x, const float* aux, int L,
                         float* partials, unsigned int* ticket, float* out, int* launches,
                         void* stream) {
  return launch<false, false>(p, L, L, x, aux, 0.f, L, partials, ticket, out, Trial{},
                              launches, stream);
}

// NDT: p: 3 rows of at least N floats, row stride ps (the untiled (3, N)
// source columns, or the first N columns of a (3, L) array tiled over the
// offsets); lane n (of L, offset-major) reads column n % N.  x (4, 4),
// aux (10, L) [M (6), valid, mu (3)]: float32.  c_sq: resolution^2.
// partials, ticket, out, launches: as fgt_error.
extern "C" int fgt_ndt_error(const float* p, int ps, int N, const float* x,
                             const float* aux, float c_sq, int L, float* partials,
                             unsigned int* ticket, float* out, int* launches,
                             void* stream) {
  return launch<true, false>(p, ps, N, x, aux, c_sq, L, partials, ticket, out, Trial{},
                             launches, stream);
}

// One LM trial as one launch: the trial step on the state (kStateFloats
// floats, updated in place) with H (6, 6), b (6,) and y0 (1) of the last
// linearization, the error at the trial pose (cauchy = 0: fgt_error's
// weight, p's row stride must then be N = L; 1: fgt_ndt_error's with c_sq),
// then the LM schedule.  first: the first trial after a linearization.
// lambda_factor, inv_rot, inv_trans: float32 lm_init_lambda_factor and the
// reciprocals of the two epsilons.  partials, ticket, launches: as fgt_error.
extern "C" int fgt_lm_step(const float* H, const float* b, const float* y0, float* state,
                           int first, float lambda_factor, float inv_rot, float inv_trans,
                           const float* p, int ps, int N, const float* aux, int cauchy,
                           float c_sq, int L, float* partials, unsigned int* ticket,
                           int* launches, void* stream) {
  const Trial tr{H, b, y0, state, first, lambda_factor, inv_rot, inv_trans};
  float* out = state + kStateYi;
  return cauchy ? launch<true, true>(p, ps, N, nullptr, aux, c_sq, L, partials, ticket, out,
                                     tr, launches, stream)
                : launch<false, true>(p, ps, N, nullptr, aux, c_sq, L, partials, ticket,
                                      out, tr, launches, stream);
}
