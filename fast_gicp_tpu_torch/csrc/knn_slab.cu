// k-NN over per-query-tile candidate slabs, one warp per query.
//
// Replaces fast_gicp_tpu/ops/pallas_kernels.py::_make_knn_slab_kernel
// (reached through knn_slab_pallas, for knn_search_culled).  Query tile i
// (256 queries) searches the slab of its C candidate target tiles cidx[i]
// (ct points each; slab position j = c * ct + lane).  For each query and
// slab position:
//   d^2 = ((q0 - t0)^2 + (q1 - t1)^2) + (q2 - t2)^2, rounded in that order
// (explicitly rounded operations, no FMA contraction).  Outputs, per query,
// the k smallest d^2 ascending (clamped at 0) and their global target ids
// (cidx[i][c] * ct + lane), ties going to the lower slab position: the TPU
// kernel's k rounds of argmin-and-mask, and a stable sort of the slab.  With
// cidx[i] = 0 .. T-1 for every tile the slab is the whole target in index
// order, and the same kernel is the exact k-NN search.
//
// Bound on an H100: FP32 operations, 8 for the distance and one compare a
// candidate (22,528 queries x 4,096 positions at C = 16, ct = 256: 0.83
// GFLOP, 12 us at 67 TFLOP/s).  What holds a thread-a-query design far
// from it is latency (a few warps an SM) and the sorted insertions, which
// diverge within a warp while the lists fill.  Design: each query's
// candidates are keyed (bits of d^2) << 32 | slab position.  d^2 is a
// rounded sum of squares, >= 0 (finite even for parked points), so its bits
// order as the floats do, and the keys are unique: the k smallest keys are
// one set in one order whatever order they are visited in, and it is the
// stable sort's.  A warp keeps the current k smallest keys of kRows queries
// at once, one key a lane (lane j the j-th smallest, lanes >= k an empty
// key), and reads the slab twice.  Pass 1 takes each lane's least d^2 over
// its positions; the k-th smallest of the 32 lane minima bounds the k-th
// smallest d^2 from above (they are k distinct candidates).  Pass 2 keys
// each candidate against the kRows queries (kRows independent chains); a
// ballot against each query's threshold (the bound, then the k-th kept
// key) finds the few candidates below it, and each is inserted by a
// warp-wide shift (a ballot for its place, __shfl_up_sync for the shift),
// so no lane waits on another's insertion.  The bound is what keeps the
// insertions few: without it a query of the full-size synthetic pair meets
// about a hundred keys below its running k-th key in slab order at C = 16
// x 256, and thousands in the exact search's index order.  A block of kWarps warps
// takes 32 queries of one query tile and stages their shared slab in shared
// memory, kChunk positions at a time, double-buffered (one barrier a
// chunk); 8 blocks a query tile give 704 blocks of 8 warps at full width
// (22,528 queries).  Masked targets arrive parked at MASK_COORD (d^2 ~
// 3e18, finite), so they enter a list only when fewer than k valid targets
// are in the slab; a tile id outside the target reads as masked points.

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
constexpr float kMaskCoord = 1.0e9f;
constexpr unsigned long long kNoKey = ~0ull;  // an empty slot; above every key
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sq_dist(float4 a, float4 b) {
  const float dx = __fsub_rn(a.x, b.x);
  const float dy = __fsub_rn(a.y, b.y);
  const float dz = __fsub_rn(a.z, b.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Insert key x into the warp's ascending list (lane j holds the j-th
// smallest of the k kept, lanes >= k hold kNoKey).  x lands at p, the
// number of kept keys below it; the keys from p up shift one lane up and
// the k-th falls out.  A key not below the k-th (p >= k) changes nothing.
__device__ __forceinline__ void insert(unsigned long long& list, unsigned long long x,
                                       int lane, int k) {
  const int p = __popc(__ballot_sync(kFull, list < x));
  const unsigned long long up = __shfl_up_sync(kFull, list, 1);
  if (lane < k && lane >= p) list = lane == p ? x : up;
}

// Stage slab positions [base, base + n) of query tile qt into pts.
__device__ __forceinline__ void stage(float4* pts, const float4* __restrict__ t,
                                      const int* __restrict__ cidx, int qt, int C, int ct,
                                      int tiles, int base, int n) {
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int pos = base + j;
    const int c = pos / ct;
    const int tile = cidx[qt * C + c];
    pts[j] = tile >= 0 && tile < tiles ? t[(size_t)tile * ct + (pos - c * ct)]
                                       : make_float4(kMaskCoord, kMaskCoord, kMaskCoord, 0.f);
  }
}

// The k-th smallest of the warp's 32 values v (one a lane): a bitonic sort
// across the lanes, then lane k - 1's.
__device__ __forceinline__ float warp_kth_smallest(float v, int k, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float o = __shfl_xor_sync(kFull, v, stride);
      const bool ascending = (lane & size) == 0, low = (lane & stride) == 0;
      v = low == ascending ? fminf(v, o) : fmaxf(v, o);
    }
  }
  return __shfl_sync(kFull, v, k - 1);
}

__global__ void __launch_bounds__(kThreads)
    knn_slab_kernel(const float4* __restrict__ q, const float4* __restrict__ t,
                    const int* __restrict__ cidx, int nt, int C, int ct, int k,
                    int* __restrict__ idx_out, float* __restrict__ sq_out,
                    int* __restrict__ launches) {
  __shared__ float4 pts[2][kChunk];
  count_launch(launches);
  const int qt = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int i0 = qt * kQueryTile + blockIdx.y * kBlockQueries + (threadIdx.x >> 5) * kRows;
  const int S = C * ct;  // a multiple of 128: every chunk holds whole warp steps
  const int tiles = nt / ct;
  const int chunks = (S + kChunk - 1) / kChunk;

  float4 qr[kRows];
  float lane_min[kRows];  // pass 1: the least d^2 of this lane's positions
  unsigned long long list[kRows], kth[kRows];  // pass 2: kth bounds the k-th smallest key
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    qr[r] = q[i0 + r];
    lane_min[r] = INFINITY;
    list[r] = kNoKey;
  }

  // Two passes over the slab, each chunk staged while the one before is
  // read (one barrier a chunk).  Pass 1 takes each lane's least d^2 over
  // its positions (j = lane mod 32); the k-th smallest of those 32 minima
  // is the d^2 of k distinct candidates, so it bounds the k-th smallest
  // d^2 from above.  Pass 2 keys the candidates and inserts only those
  // below the bound or, once k are kept, below the k-th kept key.
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
        for (int r = 0; r < kRows; ++r) lane_min[r] = fminf(lane_min[r], sq_dist(qr[r], y));
      }
    } else {
      if (step == chunks) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          kth[r] = static_cast<unsigned long long>(
                       __float_as_uint(warp_kth_smallest(lane_min[r], k, lane))) << 32 |
                   0xffffffffu;
      }
      for (int j = lane; j < n; j += 32) {
        const float4 y = pts[buf][j];
        const unsigned long long pos = static_cast<unsigned>(base + j);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const unsigned long long key =
              static_cast<unsigned long long>(__float_as_uint(sq_dist(qr[r], y))) << 32 | pos;
          unsigned hits = __ballot_sync(kFull, key < kth[r]);
          if (hits) {  // uniform across the warp
            do {
              const int src = __ffs(hits) - 1;
              hits &= hits - 1;
              insert(list[r], __shfl_sync(kFull, key, src), lane, k);
            } while (hits);
            const unsigned long long last = __shfl_sync(kFull, list[r], k - 1);
            kth[r] = last < kth[r] ? last : kth[r];
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (lane < k) {
      const int pos = static_cast<int>(list[r] & 0xffffffffu);
      const int c = pos / ct;
      const size_t o = (size_t)(i0 + r) * k + lane;
      idx_out[o] = cidx[qt * C + c] * ct + (pos - c * ct);
      sq_out[o] = fmaxf(__uint_as_float(static_cast<unsigned>(list[r] >> 32)), 0.f);
    }
  }
}

}  // namespace

// q: (nq, 4) float32 [x, y, z, valid], masked queries parked at MASK_COORD,
// nq = 256 * Q.  t: (nt, 4) float32 [x, y, z, valid], masked targets parked
// at MASK_COORD, nt a multiple of ct.  cidx: (Q, C) int32 candidate tiles;
// 1 <= k <= min(32, C * ct).  idx: (nq, k) int32; sq: (nq, k) float32.
// launches: the tally slot (one int of device memory, or null).  Launches
// on `stream`; returns cudaGetLastError().
extern "C" int fgt_knn_slab(const float* q, const float* t, const int* cidx, int nq, int nt,
                            int C, int ct, int k, int* idx, float* sq, int* launches,
                            void* stream) {
  const int Q = nq / kQueryTile;
  if (Q > 0)
    knn_slab_kernel<<<dim3(Q, kParts), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(q), reinterpret_cast<const float4*>(t), cidx, nt, C,
        ct, k, idx, sq, launches);
  return static_cast<int>(cudaGetLastError());
}
