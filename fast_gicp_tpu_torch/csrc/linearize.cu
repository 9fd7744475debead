// GICP/VGICP linearization, one thread per correspondence.
//
// Replaces fast_gicp_tpu/ops/pallas_linearize.py::_linearize_raw_kernel and
// ::_linearize_kernel (both with their shared core _lin_body).  The trial
// error that reads their aux, ::_error_kernel, is trial_error.cu's.
//
// linearize_raw / linearize, per correspondence n (L of them):
//   read target row r = ids[n] of the row table (T, 16), or r = n when no
//   ids are given (rows gathered by the caller); unpack it: raw voxel rows
//   [count, sum mu (3), sum cov (9 row-major), pad (3)] are divided by
//   count (count 0 marks a miss, which clears valid); finalized rows
//   [mu (3), cov (9 row-major), count, pad (3)] are read as they are
//   (GICP's rows carry count 1).
//   Then, shared: transform the source point by the pose x,
//   M = (C_B + R C_A R^T)^-1 with the determinant clamped to +-1e-18,
//   w = sqrt(count) * valid; accumulate the 28 sums [err, H (21 unique),
//   b (6)] of w e^T M e, w J^T M J, w J^T M e with J = [skew(p) | -I];
//   write aux (10, L) = [M (6), w, mu_B (3)], and from the last block the
//   normal equations [err, H (6 x 6), b (6)] (43 floats).
//
// Bound on an H100: device-memory bytes, and in practice the launch and the
// cross-block sum.  At L = 22,528 a linearize moves about 3.2 MB (about
// 1 us at 3.35 TB/s), a few hundred flops per correspondence.  The TPU
// kernel takes rows gathered by XLA, because a TPU kernel cannot gather
// rows well; here a lane reads its row by index as cheaply as its own, so
// the gather (and the (L, 16) array it writes and the kernel reads back)
// is gone.  The design:
//   * the row by index: 64 bytes as four float4 from row ids[n] (int32 ids
//     from nn_search, int64 from the voxel lookup, read as the caller has
//     them); ids == nullptr reads row n, and both forms run on the grid of
//     the same kernel, so they sum in the same order and agree bit for bit;
//   * the 28 sums in registers, then lin_common.cuh's grid_sum_tree: a
//     warp butterfly, then the last block adds the blocks' rows with all its
//     threads in a fixed order (a repeat launch is bit-identical), and
//     writes the normal equations with store_normal_eq, so no eager unpack
//     follows;
//   * a grid of at most one wave (wave_grid), a grid-stride loop beyond.
// Two alternatives measured slower at the paths' sizes (PERF.md section
// 6): 128-thread blocks, so that every SM gets work at 22,528 lanes, and
// clusters of 8 blocks that add their rows through distributed shared
// memory before one row a cluster goes through global memory.

#include "launch_count.cuh"
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
__device__ __forceinline__ Target unpack_raw(const float4* __restrict__ row,
                                             float valid_in) {
  const float4 r0 = row[0], r1 = row[1], r2 = row[2], r3 = row[3];
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
__device__ __forceinline__ Target unpack_finalized(const float4* __restrict__ row,
                                                   float valid_in) {
  const float4 r0 = row[0], r1 = row[1], r2 = row[2], r3 = row[3];
  // sym-6 of the row-major cov9 at row offsets 3, 4, 5, 7, 8, 11
  return {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.w, r2.x, r2.w, r3.x, valid_in};
}

template <bool kRaw, typename Id>
__global__ void __launch_bounds__(kThreads)
    linearize_kernel(const float* __restrict__ p, const float* __restrict__ ca,
                     const float* __restrict__ xp, const float4* __restrict__ rows,
                     const Id* __restrict__ ids, const float* __restrict__ valid_in, int L,
                     float* partials, unsigned int* ticket, float* __restrict__ out,
                     float* __restrict__ aux, int* __restrict__ launches) {
  count_launch(launches, ids != nullptr);
  const Pose x = load_pose(xp);
  float acc[28];
#pragma unroll
  for (int k = 0; k < 28; ++k) acc[k] = 0.f;

  for (int n = blockIdx.x * kThreads + threadIdx.x; n < L; n += gridDim.x * kThreads) {
    const long long r = ids != nullptr ? static_cast<long long>(ids[n]) : n;
    const Target tg = kRaw ? unpack_raw(rows + 4 * r, valid_in[n])
                           : unpack_finalized(rows + 4 * r, valid_in[n]);
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
  grid_sum_tree<28, true>(acc, partials, ticket, out);
}

// One launch on the grid of the kernel without ids, so the three forms (no
// ids, int32, int64) sum in one order.
template <bool kRaw>
int launch(const float* p, const float* ca, const float* x, const float* rows,
           const void* ids, int id_bytes, const float* valid, int L, float* partials,
           unsigned int* ticket, float* out, float* aux, int* launches, void* stream) {
  const void* kernel = reinterpret_cast<const void*>(linearize_kernel<kRaw, int>);
  const int grid = wave_grid<6 + kRaw>(kernel, L, kThreads);
  if (grid == 0) return refused();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* rows4 = reinterpret_cast<const float4*>(rows);
  switch (id_bytes) {
    case 0:
    case 4:
      linearize_kernel<kRaw, int><<<grid, kThreads, 0, s>>>(
          p, ca, x, rows4, static_cast<const int*>(ids), valid, L, partials, ticket, out, aux,
          launches);
      break;
    case 8:
      linearize_kernel<kRaw, long long><<<grid, kThreads, 0, s>>>(
          p, ca, x, rows4, static_cast<const long long*>(ids), valid, L, partials, ticket, out,
          aux, launches);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Most blocks any linearize or error kernel of this library launches on the
// current device, so rows of partials a scratch needs: one wave of the
// kThreads-blocks filling every SM (every such kernel sizes its grid to at
// most a wave with wave_grid).  -1 if the runtime refuses.
extern "C" int fgt_max_reduce_blocks() {
  int dev = 0, sms = 0, threads = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&threads, cudaDevAttrMaxThreadsPerMultiProcessor, dev) !=
          cudaSuccess)
    return -1;
  return sms * (threads / kThreads);
}

// p (3, L), ca (6, L), x (4, 4), rows (T, 16), valid (L,): float32, rows
// 16-byte aligned and raw ([count, sum mu, sum cov9, pad]).  ids: (L,) row
// indices in [0, T), id_bytes 4 (int32) or 8 (int64); or null with
// id_bytes 0, and then T = L and lane n reads row n.  partials:
// fgt_max_reduce_blocks() * 28 floats; ticket: one uint32, 0 on entry and
// left 0.  out: 43 floats [err, H (6 x 6), b (6)]; aux: (10, L).  launches:
// the tally slot (two ints of device memory: all runs, runs with ids), or
// null.
extern "C" int fgt_linearize_raw(const float* p, const float* ca, const float* x,
                                 const float* rows, const void* ids, int id_bytes,
                                 const float* valid, int L, float* partials,
                                 unsigned int* ticket, float* out, float* aux, int* launches,
                                 void* stream) {
  return launch<true>(p, ca, x, rows, ids, id_bytes, valid, L, partials, ticket, out, aux,
                      launches, stream);
}

// As fgt_linearize_raw, with finalized rows ([mu, cov9, count, pad]).
extern "C" int fgt_linearize(const float* p, const float* ca, const float* x,
                             const float* rows, const void* ids, int id_bytes,
                             const float* valid, int L, float* partials,
                             unsigned int* ticket, float* out, float* aux, int* launches,
                             void* stream) {
  return launch<false>(p, ca, x, rows, ids, id_bytes, valid, L, partials, ticket, out, aux,
                       launches, stream);
}
