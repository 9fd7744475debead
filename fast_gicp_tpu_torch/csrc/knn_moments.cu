// Fused k-NN selection and neighbourhood moments over candidate slabs, one
// warp per query.
//
// Replaces fast_gicp_tpu/ops/pallas_kernels.py::_make_knn_moments_kernel
// (reached through knn_moments_pallas, for the default "knn" covariances).
// Query tile i (256 queries) searches the slab of its C candidate target
// tiles cidx[i] (ct points each, S = C * ct <= 4096 slab positions).  For
// each query and slab position j:
//   d^2 = ((q0 - t0)^2 + (q1 - t1)^2) + (q2 - t2)^2, rounded in that order;
//   key = (bits of d^2) & -4096 | j.
// Keys are unique, so "the k smallest keys" is one set, the TPU kernel's
// packed-key selection exactly (ties broken by slab position, distances
// quantised at 2^-11 relative for the ordering), whatever order the keys
// are visited in.  Outputs:
//   mom (10, nq) = [count, sum y (3), sum y y^T upper sym-6] over the k
//     selected candidates, y = (t - origin) * valid, where origin is the
//     first query point of the query tile (a local frame: the finalize
//     cancels ~|local extent|^2, not ~|cloud extent|^2);
//   kth (nq,) = the k-th key & -4096, read back as a float.
//
// Bound on an H100: operations.  At 22,528 queries x 2,048 positions a call
// is ~46 M distances (0.5 GFLOP with the keys), a few us at the FP32 rate.
// What held the first design (k rounds of a warp-wide minimum over 64 keys
// a lane, ~2,800 instructions a query against ~770 for the distances) was
// the selection.  Design for k <= 32 (knn_moments_kernel), knn_slab.cu's
// on 32-bit keys: a warp keeps the k smallest keys of kRows queries at once,
// one key a lane (lane j the j-th smallest), and reads the slab twice.
// Pass 1 takes each lane's least key over its positions; the k-th smallest
// of the 32 lane minima is the key of a real candidate with k - 1 smaller
// ones, so it bounds the k-th smallest key.  Pass 2 keys each candidate
// against the kRows queries; a ballot against each query's threshold (the
// bound, then the k-th kept key) finds the few candidates at or below it,
// and each is inserted by a warp-wide shift (a ballot for its place,
// __shfl_up_sync for the shift).  On the full-size synthetic pair at
// C = 16 x 128 a query meets ~107 keys below its running k-th key in slab
// order, and ~27 under the bound.  A block of kWarps warps takes 32 queries
// of one query tile and stages their slab in shared memory, kChunk
// positions at a time, double-buffered (one barrier a chunk), so a slab of
// any width up to 4,096 fits in 32 KB; 8 blocks a query tile give 704
// blocks of 8 warps at full width.  The moments: lane j gathers its
// neighbour from the target and the warp sums the ten products by a fixed
// xor tree, so two launches on the same input return the same bits.
// For k > 32 (the contract allows k <= S) knn_moments_rounds_kernel keeps
// the round-by-round selection: each of k rounds is a warp-wide minimum of
// the keys above the previous round's, over the whole slab staged in
// dynamic shared memory, and the lane that holds the position adds its
// moments.
// Masked targets arrive parked at MASK_COORD (d^2 ~ 3e18, finite), so they
// are selected only when the slab holds fewer than k valid targets; a tile
// id outside the target reads as masked points.

#include <climits>
#include <cuda_runtime.h>

#include "launch_count.cuh"

namespace {

constexpr int kWarps = 8;  // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;  // queries a warp keeps at once
constexpr int kQueryTile = 256;  // queries sharing one candidate slab
constexpr int kBlockQueries = kWarps * kRows;
constexpr int kParts = kQueryTile / kBlockQueries;  // blocks a query tile
constexpr int kChunk = 1024;  // slab positions staged at a time
constexpr int kMaxSlab = 4096;  // 12 position bits in a key
constexpr int kMaxListK = 32;  // one kept key a lane
constexpr int kRoundParts = 4;  // blocks a query tile, k > 32
constexpr float kMaskCoord = 1.0e9f;
constexpr int kNoKey = INT_MAX;  // an empty slot; above every real key
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int make_key(float4 a, float4 b, int pos) {
  const float dx = __fsub_rn(a.x, b.x);
  const float dy = __fsub_rn(a.y, b.y);
  const float dz = __fsub_rn(a.z, b.z);
  const float d2 =
      __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  return (__float_as_int(d2) & -4096) | pos;
}

// Slab position pos of query tile qt: its target point, or a masked point
// for a tile id outside the target.
__device__ __forceinline__ float4 slab_point(const float4* __restrict__ t,
                                             const int* __restrict__ cidx, int qt, int C,
                                             int ct, int tiles, int pos) {
  const int c = pos / ct;
  const int tile = cidx[qt * C + c];
  return tile >= 0 && tile < tiles ? t[(size_t)tile * ct + (pos - c * ct)]
                                   : make_float4(kMaskCoord, kMaskCoord, kMaskCoord, 0.f);
}

// Stage slab positions [base, base + n) of query tile qt into pts.
__device__ __forceinline__ void stage(float4* pts, const float4* __restrict__ t,
                                      const int* __restrict__ cidx, int qt, int C, int ct,
                                      int tiles, int base, int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    pts[j] = slab_point(t, cidx, qt, C, ct, tiles, base + j);
}

// Insert key x into the warp's ascending list (lane j holds the j-th
// smallest of the k kept, lanes >= k hold kNoKey).  x lands at p, the
// number of kept keys below it; the keys from p up shift one lane up and
// the k-th falls out.  A key not below the k-th (p >= k) changes nothing.
__device__ __forceinline__ void insert(int& list, int x, int lane, int k) {
  const int p = __popc(__ballot_sync(kFull, list < x));
  const int up = __shfl_up_sync(kFull, list, 1);
  if (lane < k && lane >= p) list = lane == p ? x : up;
}

// The k-th smallest of the warp's 32 values v (one a lane): a bitonic sort
// across the lanes, then lane k - 1's.
__device__ __forceinline__ int warp_kth_smallest(int v, int k, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int o = __shfl_xor_sync(kFull, v, stride);
      const bool ascending = (lane & size) == 0, low = (lane & stride) == 0;
      v = low == ascending ? min(v, o) : max(v, o);
    }
  }
  return __shfl_sync(kFull, v, k - 1);
}

// The ten moment terms of neighbour y about origin, added to acc.
__device__ __forceinline__ void add_moments(float* acc, float4 y, float4 origin) {
  const float v = y.w;
  const float y0 = (y.x - origin.x) * v;
  const float y1 = (y.y - origin.y) * v;
  const float y2 = (y.z - origin.z) * v;
  acc[0] += v;
  acc[1] += y0;
  acc[2] += y1;
  acc[3] += y2;
  acc[4] += y0 * y0;
  acc[5] += y0 * y1;
  acc[6] += y0 * y2;
  acc[7] += y1 * y1;
  acc[8] += y1 * y2;
  acc[9] += y2 * y2;
}

// The warp's sums of acc (a fixed xor tree) into mom, and the k-th key's
// distance into kth, for query i; kth_key is warp-uniform.
__device__ __forceinline__ void write_query(float* acc, int kth_key, int lane, int i, int nq,
                                            float* __restrict__ mom, float* __restrict__ kth) {
#pragma unroll
  for (int a = 0; a < 10; ++a)
    for (int o = 16; o > 0; o >>= 1) acc[a] += __shfl_xor_sync(kFull, acc[a], o);
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 10; ++a) mom[(size_t)a * nq + i] = acc[a];
    kth[i] = fmaxf(__int_as_float(kth_key & -4096), 0.f);
  }
}

__global__ void __launch_bounds__(kThreads)
    knn_moments_kernel(const float4* __restrict__ q, const float4* __restrict__ t,
                       const int* __restrict__ cidx, int nq, int nt, int C, int ct, int k,
                       float* __restrict__ mom, float* __restrict__ kth,
                       int* __restrict__ launches) {
  __shared__ float4 pts[2][kChunk];
  count_launch(launches);
  const int qt = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int i0 = qt * kQueryTile + blockIdx.y * kBlockQueries + (threadIdx.x >> 5) * kRows;
  const int S = C * ct;
  const int tiles = nt / ct;
  const int chunks = (S + kChunk - 1) / kChunk;

  float4 qr[kRows];
  int lane_min[kRows];  // pass 1: the least key of this lane's positions
  int list[kRows], thr[kRows];  // pass 2: keys below thr are inserted
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    qr[r] = q[i0 + r];
    lane_min[r] = kNoKey;
    list[r] = kNoKey;
  }

  // Two passes over the slab, each chunk staged while the one before is
  // read (one barrier a chunk).  Pass 1 takes each lane's least key over
  // its positions (j = lane mod 32); the k-th smallest of those 32 minima
  // is a real key with k - 1 distinct smaller ones, so it bounds the k-th
  // smallest key.  Pass 2 inserts only the keys at or below the bound or,
  // once k are kept, below the k-th kept key.
  stage(pts[0], t, cidx, qt, C, ct, tiles, 0, min(kChunk, S));
  __syncthreads();
  for (int step = 0, buf = 0; step < 2 * chunks; ++step, buf ^= 1) {
    const int c = step % chunks, base = c * kChunk;
    const int n = min(kChunk, S - base);
    // the next chunk goes to the other buffer, which every warp finished
    // reading before the barrier that ended the step before
    if (step + 1 < 2 * chunks) {
      const int next = (step + 1) % chunks * kChunk;
      stage(pts[buf ^ 1], t, cidx, qt, C, ct, tiles, next, min(kChunk, S - next));
    }
    if (step < chunks) {
      for (int j = lane; j < n; j += 32) {
        const float4 y = pts[buf][j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) lane_min[r] = min(lane_min[r], make_key(qr[r], y, base + j));
      }
    } else {
      if (step == chunks) {
        // the bound is a real key (k <= S), below kNoKey: bound + 1 is safe
#pragma unroll
        for (int r = 0; r < kRows; ++r) thr[r] = warp_kth_smallest(lane_min[r], k, lane) + 1;
      }
      for (int j0 = 0; j0 < n; j0 += 32) {  // uniform across the warp
        const int j = j0 + lane;
        const bool in = j < n;
        const float4 y = pts[buf][in ? j : 0];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int key = in ? make_key(qr[r], y, base + j) : kNoKey;
          unsigned hits = __ballot_sync(kFull, key < thr[r]);
          if (hits) {  // uniform across the warp
            do {
              const int src = __ffs(hits) - 1;
              hits &= hits - 1;
              insert(list[r], __shfl_sync(kFull, key, src), lane, k);
            } while (hits);
            thr[r] = min(thr[r], __shfl_sync(kFull, list[r], k - 1));
          }
        }
      }
    }
    __syncthreads();
  }

  // lane j < k holds the j-th selected key: its neighbour's moments, summed
  // across the warp
  const float4 origin = q[qt * kQueryTile];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float acc[10];
#pragma unroll
    for (int a = 0; a < 10; ++a) acc[a] = 0.f;
    if (lane < k) add_moments(acc, slab_point(t, cidx, qt, C, ct, tiles, list[r] & 4095), origin);
    write_query(acc, __shfl_sync(kFull, list[r], k - 1), lane, i0 + r, nq, mom, kth);
  }
}

__global__ void __launch_bounds__(kThreads)
    knn_moments_rounds_kernel(const float4* __restrict__ q, const float4* __restrict__ t,
                              const int* __restrict__ cidx, int nq, int nt, int C, int ct,
                              int k, float* __restrict__ mom, float* __restrict__ kth,
                              int* __restrict__ launches) {
  count_launch(launches);
  extern __shared__ float4 slab[];  // the whole slab, S positions
  const int qt = blockIdx.x;
  const int S = C * ct;
  stage(slab, t, cidx, qt, C, ct, nt / ct, 0, S);
  __syncthreads();

  const float4 origin = q[qt * kQueryTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kPerPart = kQueryTile / kRoundParts;
  for (int r = warp; r < kPerPart; r += kWarps) {
    const int i = qt * kQueryTile + blockIdx.y * kPerPart + r;
    const float4 qi = q[i];
    float acc[10];
#pragma unroll
    for (int a = 0; a < 10; ++a) acc[a] = 0.f;
    // round m: the least key above the last round's; keys are unique, so
    // the k rounds select the k smallest, and the lane holding each one's
    // position adds its moments
    int m = INT_MIN;
    for (int round = 0; round < k; ++round) {
      int local = kNoKey;
      for (int j = lane; j < S; j += 32) {
        const int key = make_key(qi, slab[j], j);
        if (key > m) local = min(local, key);
      }
      m = __reduce_min_sync(kFull, local);
      if ((m & 31) == lane) add_moments(acc, slab[m & 4095], origin);
    }
    write_query(acc, m, lane, i, nq, mom, kth);
  }
}

}  // namespace

// q: (nq, 4) float32 [x, y, z, valid], masked queries parked at MASK_COORD,
// nq = 256 * Q.  t: (nt, 4) float32 [x, y, z, valid], masked targets parked
// at MASK_COORD, nt a multiple of ct.  cidx: (Q, C) int32 candidate tiles
// in [0, nt / ct), C * ct <= 4096; 1 <= k <= C * ct.  mom: (10, nq); kth:
// (nq,).  launches: the tally slot (one int of device memory, or null).
// One launch on `stream` (k <= 32: the bounded insertion; else the
// rounds); returns cudaGetLastError().
extern "C" int fgt_knn_moments(const float* q, const float* t, const int* cidx, int nq,
                               int nt, int C, int ct, int k, float* mom, float* kth,
                               int* launches, void* stream) {
  const int Q = nq / kQueryTile;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const float4* t4 = reinterpret_cast<const float4*>(t);
  if (Q <= 0) return static_cast<int>(cudaGetLastError());
  if (k <= kMaxListK) {
    knn_moments_kernel<<<dim3(Q, kParts), kThreads, 0, s>>>(q4, t4, cidx, nq, nt, C, ct, k,
                                                           mom, kth, launches);
  } else {
    // above 48 KB only after this attribute; set once for the widest slab
    static const cudaError_t attr =
        cudaFuncSetAttribute(knn_moments_rounds_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSlab * static_cast<int>(sizeof(float4)));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    knn_moments_rounds_kernel<<<dim3(Q, kRoundParts), kThreads, C * ct * sizeof(float4), s>>>(
        q4, t4, cidx, nq, nt, C, ct, k, mom, kth, launches);
  }
  return static_cast<int>(cudaGetLastError());
}
