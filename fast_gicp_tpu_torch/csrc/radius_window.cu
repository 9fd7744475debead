// Adaptive-radius neighbourhoods: counts within each ladder radius, then
// hard-window moments at each query's own radius.
//
// Replaces fast_gicp_tpu/ops/pallas_kernels.py::_count_kernel and
// ::_window_kernel (reached through radius_window_moments_T, for the
// "adaptive" covariance estimator).  Both work on centered coordinates
// (query and target minus the cloud's mean), with masked points parked at
// MASK_COORD, and both round
//   d^2 = ((q0 - t0)^2 + (q1 - t1)^2) + (q2 - t2)^2
// in that order (explicitly rounded operations, no FMA contraction), so a
// count or a window decision equals the plain version's exactly.
//   radius_count: cnt (L, nq) = for each query and rung l, the number of
//     targets with d^2 <= r2[l] (L <= 32, in any order, repeats allowed).
//   radius_window: out (16, nq) = [n, sum y (3), sum y y^T (9, row-major),
//     0 (3)] over the targets with d^2 <= r2q[query], y = target * valid
//     (masked targets add nothing).  The sums are full f32: the finalize
//     about the cloud mean cancels ~|y|^2 down to ~|window|^2, so a reduced
//     precision would leave O(1) relative error on the covariance.
// Rows of masked queries carry no meaning.
//
// fgt_radius_boxes writes, once a target cloud, the bounding box of the
// valid points of each 128-target tile (the count's cull) and of each
// 32-target chunk (the window's).  Every gap is rounded like d^2
// (tile_cull.cuh), so no cull drops a pair inside its radius.  The count
// takes the box of a block's 128 valid queries and visits only the tiles
// whose squared box gap is <= the ladder's largest rung.
//
// radius_count.  Bound on an H100: the FP32 operations the function needs,
// for each pair inside the largest radius d^2 (8), the rung it falls in (a
// binary search of the ladder, ceil(log2(L + 1)) compares) and one
// increment, then a prefix sum of L a query.  The cull visits ~4.9x the
// pairs in range (67.6 M against 13.8 M on the full-size synthetic pair),
// so what holds the kernel is the per-pair work and how many warps hide its
// latency.  Design: kCountGroups groups of 128 threads share the block's 128
// queries (thread g * 128 + i holds query i); the block lists the tiles
// that pass the cull in shared memory and group g takes every
// kCountGroups-th of them, staging each in its own shared slot (a named
// barrier a group), which also evens out blocks that keep 23 or 37 tiles.
// The L rungs are ranked once a block (ties by index) into an ascending
// copy padded with +inf to 32 entries.  For each pair a thread finds by a
// 5-step binary search of that copy (the first three levels from registers,
// the last two from shared memory) the first ranked rung with d^2 <= r2,
// or the discard bucket L when none holds the pair, and adds one to its own
// histogram column in shared memory ([bucket][thread]: no bank conflicts;
// the add is a shared atomic only so that nothing waits on its result).
// Every pair takes the same path, so nothing diverges (a warp vote that
// skips targets none of the warp's queries reaches would skip only a
// quarter of them on the full-size pair), and a thread keeps kBatch pairs
// in flight, their searches before their adds.  The kernel is bound by
// latency, so warps pay: on an H100, 8 groups (1,024 threads, one block an
// SM) ran faster than 4 or 2, and batches of 8 pairs than of 2 or 4.  At
// the end each query sums its groups' columns and
// prefix-sums them over the ranked buckets, and rung l reads the prefix at
// its rank: integer counts, exact in any order.
//
// radius_window.  Bound on an H100: for each pair inside its window d^2,
// the compare, 6 products and 10 sums (553,523 pairs on the full-size
// synthetic pair: its bytes bound it).  The first design (one thread a
// query, a block of 128 culling 128-target tiles by its box and its
// largest window) walked 57.3 M pairs for those 0.55 M, because the
// windows spread from 0.18 to 34 m^2 and one far query set the walk of
// 127 near ones, with ~5 warps an SM and two barriers a tile: 0.27 ms on
// an H100.  Design: a warp a query, its lanes across the targets.  The
// warp lists the 32-target chunks whose box lies within the query's own
// window (a point-to-box gap a lane, one ballot a round of 32 chunks) and
// walks them, each lane testing and adding one target of each chunk (two
// chunks' loads in flight at a time) into its own ten sums: 14.9 M pairs
// on that pair, 22 chunks a query.  Nothing is staged in shared memory and
// nothing waits on a barrier (blocks of 8 warps, up to 64 warps an SM).
// At the end the lanes' sums are added by a fixed xor tree, so two
// launches return the same bits.

#include <cuda_runtime.h>

#include "launch_count.cuh"
#include "tile_cull.cuh"

namespace {

constexpr int kMaxRungs = 32;
constexpr int kCountGroups = 8;  // thread groups sharing one block's queries
constexpr int kCountThreads = kCountGroups * kTile;
constexpr int kCountWarps = kCountThreads / 32;
constexpr int kBatch = 8;  // pairs a thread keeps in flight
// the histograms: (L + 1) buckets, the last one for "outside every rung"
constexpr int kCountHistBytes = (kMaxRungs + 1) * kCountThreads * 4;

constexpr int kWindowWarps = 8;  // queries a window block, one a warp
constexpr int kWindowThreads = kWindowWarps * 32;

// Barrier of the 128 threads of group g (ids 1..kCountGroups; 0 is
// __syncthreads).
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(kTile) : "memory");
}

__global__ void __launch_bounds__(kCountThreads)
    radius_count_kernel(const float4* __restrict__ q, const float4* __restrict__ t,
                        const float* __restrict__ boxes, const float* __restrict__ r2,
                        int L, int nq, int nt, float* __restrict__ cnt,
                        int* __restrict__ launches) {
  count_launch(launches);
  extern __shared__ int hist[];  // [L + 1][kCountThreads]
  __shared__ float4 tile[kCountGroups][kTile];
  __shared__ int visit[kCountThreads];  // the tiles that pass the cull, one chunk
  __shared__ int warp_kept[kCountWarps];
  __shared__ float scratch[6][kCountWarps];
  __shared__ float qbox[6];
  __shared__ float sorted[kMaxRungs];  // the rungs ascending, +inf past L
  __shared__ int rank[kMaxRungs];

  const int tid = threadIdx.x;
  const int g = tid / kTile, qi_local = tid % kTile;
  const int lane = tid & 31, warp = tid >> 5;
  if (tid < kMaxRungs) {
    // a NaN rung holds nothing (d^2 <= NaN is false): rank it as -inf,
    // below every d^2, so its bucket stays empty
    float v = INFINITY;
    int rk = tid;
    if (tid < L) {
      v = r2[tid];
      v = isnan(v) ? -INFINITY : v;
      rk = 0;
      for (int m = 0; m < L; ++m) {
        float w = r2[m];
        w = isnan(w) ? -INFINITY : w;
        rk += (w < v || (w == v && m < tid)) ? 1 : 0;
      }
    }
    sorted[rk] = v;
    rank[tid] = rk;
  }
  int* const own = hist + tid;  // this thread's column
  for (int b = 0; b <= L; ++b) own[b * kCountThreads] = 0;

  const int i = blockIdx.x * kTile + qi_local;
  const float4 qi = i < nq ? q[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  // the box of the block's valid queries (group 0 holds each once); the
  // barrier inside also publishes sorted and rank
  block_bbox(qi, g == 0 && i < nq && qi.w != 0.f, scratch, qbox);
  const float r2max = sorted[L - 1];
  // the search's first three levels: sorted[15]; [7], [23]; [3], [11], [19], [27]
  const float top[7] = {sorted[15], sorted[7],  sorted[23], sorted[3],
                        sorted[11], sorted[19], sorted[27]};

  const int tiles = (nt + kTile - 1) / kTile;
  for (int c0 = 0; c0 < tiles; c0 += kCountThreads) {
    // list this chunk's tiles that pass the cull, in tile order
    const int tt = c0 + tid;
    const bool keep = tt < tiles && box_gap2(qbox, boxes + 6 * tt) <= r2max;
    const unsigned kept = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_kept[warp] = __popc(kept);
    __syncthreads();
    int at = __popc(kept & ((1u << lane) - 1u)), n_kept = 0;
    for (int w = 0; w < kCountWarps; ++w) {
      at += w < warp ? warp_kept[w] : 0;
      n_kept += warp_kept[w];
    }
    if (keep) visit[at] = tt;
    __syncthreads();

    for (int v = g; v < n_kept; v += kCountGroups) {  // uniform across the group
      const int j = visit[v] * kTile + qi_local;
      // past the target's end a NaN point: no d^2 <= r2 holds for it
      tile[g][qi_local] = j < nt ? t[j] : make_float4(NAN, NAN, NAN, 0.f);
      group_sync(g);
      for (int m = 0; m < kTile; m += kBatch) {
        // kBatch pairs in flight: their searches first, then their adds
        // (shared reads are not moved past a shared atomic)
        int bucket[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const float d2 = sq_dist(qi, tile[g][m + u]);
          // b = the number of ranked rungs below d2 (the first rung that
          // holds the pair), by a binary search of the 32 padded entries:
          // the first three levels from registers, the last two from shared
          int b = top[0] < d2 ? 16 : 0;
          b += (b ? top[2] : top[1]) < d2 ? 8 : 0;
          b += (b & 16 ? (b & 8 ? top[6] : top[5]) : (b & 8 ? top[4] : top[3])) < d2 ? 4 : 0;
          b += sorted[b + 1] < d2 ? 2 : 0;
          b += sorted[b] < d2 ? 1 : 0;
          // the discard bucket L when no rung holds it (and for a NaN d^2)
          bucket[u] = d2 <= r2max ? b : L;
        }
        // the adds' results are not read, so nothing waits on them
#pragma unroll
        for (int u = 0; u < kBatch; ++u) atomicAdd(own + bucket[u] * kCountThreads, 1);
      }
      group_sync(g);
    }
    __syncthreads();  // visit is rewritten by the next chunk
  }

  // each query's counts: its groups' columns summed and prefix-summed over
  // the ranked buckets into group 0's column; rung l reads its rank's
  if (tid < kTile) {
    int run = 0;
    for (int b = 0; b < L; ++b) {
      int s = 0;
#pragma unroll
      for (int gg = 0; gg < kCountGroups; ++gg) s += hist[b * kCountThreads + gg * kTile + tid];
      run += s;
      hist[b * kCountThreads + tid] = run;
    }
  }
  __syncthreads();
  for (int o = tid; o < L * kTile; o += kCountThreads) {
    const int l = o / kTile, qq = o % kTile;
    const int iq = blockIdx.x * kTile + qq;
    if (iq < nq) cnt[(size_t)l * nq + iq] = static_cast<float>(hist[rank[l] * kCountThreads + qq]);
  }
}

// Target y's ten window sums [n, y (3), upper sym-6 y y^T], y = target *
// valid, added to acc when `inside`.
__device__ __forceinline__ void add_window(float* acc, float4 y, bool inside) {
  if (!inside) return;
  const float v = y.w;
  const float y0 = y.x * v, y1 = y.y * v, y2 = y.z * v;
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

__global__ void __launch_bounds__(kWindowThreads)
    radius_window_kernel(const float4* __restrict__ q, const float4* __restrict__ t,
                         const float* __restrict__ chunk_boxes, const float* __restrict__ r2q,
                         int nq, int nt, float* __restrict__ out,
                         int* __restrict__ launches) {
  count_launch(launches);
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWindowWarps + (threadIdx.x >> 5);
  if (i >= nq) return;  // uniform across the warp
  const float4 qi = q[i];
  const float r2 = r2q[i];

  float acc[10];
#pragma unroll
  for (int a = 0; a < 10; ++a) acc[a] = 0.f;
  const int chunks = (nt + kChunk - 1) / kChunk;
  for (int c0 = 0; c0 < chunks; c0 += 32) {
    // the chunks of this round whose box lies within the window, a chunk a
    // lane, by one ballot
    const int c = c0 + lane;
    unsigned listed =
        __ballot_sync(0xffffffffu, c < chunks && point_gap2(qi, chunk_boxes + 6 * c) <= r2);
    while (listed) {  // uniform across the warp
      // two listed chunks at a time, both loads in flight before the adds
      const int ca = __ffs(listed) - 1;
      listed &= listed - 1;
      const int cb = listed ? __ffs(listed) - 1 : -1;
      listed &= listed - 1;
      const int ja = (c0 + ca) * kChunk + lane;
      const int jb = cb < 0 ? nt : (c0 + cb) * kChunk + lane;
      const float4 ya = ja < nt ? t[ja] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 yb = jb < nt ? t[jb] : make_float4(0.f, 0.f, 0.f, 0.f);
      add_window(acc, ya, ja < nt && sq_dist(qi, ya) <= r2);
      add_window(acc, yb, jb < nt && sq_dist(qi, yb) <= r2);
    }
  }
  // the lanes' sums by a fixed xor tree: two launches give the same bits
#pragma unroll
  for (int a = 0; a < 10; ++a)
    for (int o = 16; o > 0; o >>= 1) acc[a] += __shfl_xor_sync(0xffffffffu, acc[a], o);
  if (lane < 16) {
    // rows [n, y (3), yy^T row-major (9), 0 (3)]; y_a y_b == y_b y_a; row
    // `lane` from lane `lane`
    const int src[16] = {0, 1, 2, 3, 4, 5, 6, 5, 7, 8, 6, 8, 9, -1, -1, -1};
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < 16; ++r) v = lane == r && src[r] >= 0 ? acc[src[r]] : v;
    out[(size_t)lane * nq + i] = v;
  }
}

}  // namespace

// t: (nt, 4) float32 [x, y, z, valid] centered, masked targets parked at
// MASK_COORD.  boxes: (6 * ceil(nt / 128),) float32, the box of each
// 128-target tile's valid points, which the count reads; chunk_boxes:
// (6 * ceil(nt / 32),) float32, the box of each 32-target chunk's valid
// points, which the window reads.  Two launches on `stream`; returns
// cudaGetLastError().
extern "C" int fgt_radius_boxes(const float* t, int nt, float* boxes, float* chunk_boxes,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (nt + kTile - 1) / kTile;
  if (tiles > 0) {
    tile_bbox_kernel<true><<<tiles, kTile, 0, s>>>(reinterpret_cast<const float4*>(t), nt,
                                                      boxes);
    chunk_bbox_kernel<true><<<tiles, kTile, 0, s>>>(reinterpret_cast<const float4*>(t), nt,
                                                    chunk_boxes);
  }
  return static_cast<int>(cudaGetLastError());
}

// q: (nq, 4) float32 [x, y, z, valid] centered, masked queries parked at
// MASK_COORD; t as above, and boxes from fgt_radius_boxes on it.  r2: (L,)
// float32 with 1 <= L <= 32.  cnt: (L, nq) float32.  launches: the tally
// slot (one int of device memory, or null).  One launch on `stream`;
// returns cudaGetLastError().
extern "C" int fgt_radius_count(const float* q, const float* t, const float* boxes,
                                const float* r2, int L, int nq, int nt, float* cnt,
                                int* launches, void* stream) {
  const int blocks = (nq + kTile - 1) / kTile;
  if (blocks > 0 && nt > 0) {
    // above 48 KB only after this attribute; set once for the largest ladder
    static const cudaError_t attr = cudaFuncSetAttribute(
        radius_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kCountHistBytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    radius_count_kernel<<<blocks, kCountThreads, (L + 1) * kCountThreads * sizeof(int),
                          static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(q), reinterpret_cast<const float4*>(t), boxes, r2, L,
        nq, nt, cnt, launches);
  }
  return static_cast<int>(cudaGetLastError());
}

// q and t as above, chunk_boxes from fgt_radius_boxes on t; r2q: (nq,)
// float32 squared window radius a query.  out: (16, nq) float32.
// launches: as fgt_radius_count's.  One launch on `stream`; returns
// cudaGetLastError().
extern "C" int fgt_radius_window(const float* q, const float* t, const float* chunk_boxes,
                                 const float* r2q, int nq, int nt, float* out,
                                 int* launches, void* stream) {
  const int blocks = (nq + kWindowWarps - 1) / kWindowWarps;
  if (blocks > 0 && nt > 0)
    radius_window_kernel<<<blocks, kWindowThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(q), reinterpret_cast<const float4*>(t), chunk_boxes,
        r2q, nq, nt, out, launches);
  return static_cast<int>(cudaGetLastError());
}
