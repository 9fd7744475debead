// The device-resident LM loop: the condition kernel of the solve's
// conditional WHILE nodes, and the host entries that put those nodes into
// a CUDA graph while a stream is being captured.
//
// Replaces no Pallas kernel.  It is the counterpart of the predicates of
// the two nested `lax.while_loop`s of fast_gicp_tpu/solver.py, which XLA
// evaluates on the TPU: here each loop of `solver.lsq_solve`'s device form
// is a conditional WHILE node (CUDA 12.4+), and this one-thread kernel
// reads the LM state that the trial launch left on the device, keeps the
// loop's counters there and writes the loop's condition into the node's
// handle (cudaGraphSetConditional), so no loop exit waits on the host.
//
// Bound on an H100: launch latency.  It reads at most 40 floats and
// writes at most 44 (the Hessian select), a few dozen operations, one
// thread: the time is the launch.
//
// The state is the solve's LM buffer (csrc/lm_step.cuh kState*); floats
// 61-63 are the loop's own: the trial counter of the current linearization,
// the outer iterations run and the trials run in all.  `counts` is the
// device's running tally of what the loops ran (ops/cuda_solver.py
// loop_counts): condition launches, trials, outer iterations (one
// linearization each) and solves -- a profiler does not see every kernel a
// conditional body runs, so a replay's launches are read from it.
//
// pg_cond_kernel is the same for the pose-graph solves' device form
// (models/pose_graph_sparse.py, models/pose_graph.py): one thread that steps
// a loop's trip counter and writes the condition of JAX's while_loops,
//   Gauss-Newton  it < max_iterations & ~conv
//                 (fast_gicp_tpu/models/pose_graph_sparse.py:317-319,
//                  pose_graph.py:111-113),
//   LM trials     t < lm_max_trials & ~accepted                 (:288-290),
//   PCG           i < cg_iterations & res.res > tol max(|b|^2, 1e-30)
//                                                               (:255-260),
// the last from the two device scalars the reduction just before it left,
// and the CG's refresh test (i + 1) % 64 == 0 (:271-275) as the condition of
// a conditional IF node.  It also keeps the tally of ops/cuda_pose_graph.py
// pg_counts.  Bound: launch latency (it reads at most 13 bytes and
// read-modify-writes two tally ints).

#include <cuda_runtime.h>

namespace {

constexpr int kStateDone = 18;
constexpr int kStateConv = 19;
constexpr int kStateTrial = 61;       // trials since the last linearization
constexpr int kStateIteration = 62;   // outer iterations run
constexpr int kStateTrialsRun = 63;   // trials run in the whole solve

// Modes (ops/cuda_solver.py LOOP_*):
constexpr int kOuterEnter = 0;  // before the outer loop: results reset
constexpr int kFirstTrial = 1;  // after a linearization's first trial
constexpr int kAfterTrial = 2;  // after each later trial
constexpr int kAfterInner = 3;  // after the trials of a linearization

__global__ void loop_cond_kernel(float* __restrict__ state, const float* __restrict__ H,
                                 const float* __restrict__ y0, float* __restrict__ H_out,
                                 float* __restrict__ y_out, unsigned char* __restrict__ converged,
                                 int* __restrict__ iterations, int* __restrict__ flag,
                                 int* __restrict__ counts, int mode, int max_iterations,
                                 int lm_max_iterations, int lm, cudaGraphConditionalHandle handle,
                                 int set_handle) {
  unsigned int cond = 0;
  counts[0] += 1;
  if (mode == kOuterEnter) {
    counts[3] += 1;
    state[kStateIteration] = 0.f;
    state[kStateTrialsRun] = 0.f;
    for (int k = 0; k < 36; ++k) H_out[k] = (k % 7 == 0) ? 1.f : 0.f;
    *y_out = 0.f;
    *converged = 0;
    *iterations = 0;
    cond = max_iterations > 0;
  } else if (mode == kFirstTrial || mode == kAfterTrial) {
    const float j = mode == kFirstTrial ? 1.f : state[kStateTrial] + 1.f;
    state[kStateTrial] = j;
    state[kStateTrialsRun] += 1.f;
    counts[1] += 1;
    cond = state[kStateDone] == 0.f && j < static_cast<float>(lm_max_iterations);
  } else {  // kAfterInner
    const bool success = lm ? state[kStateDone] != 0.f : true;
    const bool conv = state[kStateConv] != 0.f;
    const float i = state[kStateIteration] + 1.f;
    state[kStateIteration] = i;
    counts[2] += 1;
    *converged = conv && success ? 1 : 0;
    *iterations = static_cast<int>(i);
    if (success) {
      for (int k = 0; k < 36; ++k) H_out[k] = H[k];
    }
    *y_out = *y0;
    cond = success && !conv && i < static_cast<float>(max_iterations);
  }
  *flag = static_cast<int>(cond);
  if (set_handle) cudaGraphSetConditional(handle, cond);
}

// pg_cond modes (ops/cuda_pose_graph.py PG_*) and tally slots (PG_COUNTS)
constexpr int kPgGnEnter = 0;     // before the Gauss-Newton loop: it = 0
constexpr int kPgGnStep = 1;      // after a Gauss-Newton iteration: it += 1
constexpr int kPgTrialEnter = 2;  // before the trials: t = 0
constexpr int kPgTrialStep = 3;   // after a trial: t += 1
constexpr int kPgCgEnter = 4;     // before the CG iterations: i = 0
constexpr int kPgCgStep = 5;      // after a CG iteration: i += 1
constexpr int kPgRefresh = 6;     // the CG iteration's refresh test: (i + 1) % cap == 0
constexpr int kCountConds = 0, kCountSolves = 1, kCountIterations = 2, kCountTrials = 3,
              kCountPcgs = 4, kCountCg = 5;

__global__ void pg_cond_kernel(int* __restrict__ counter, const unsigned char* __restrict__ stop,
                               const float* __restrict__ rr, const float* __restrict__ thresh,
                               int* __restrict__ flag, int* __restrict__ counts, int mode, int cap,
                               cudaGraphConditionalHandle handle, int set_handle) {
  counts[kCountConds] += 1;
  int n = *counter;
  unsigned int cond;
  if (mode == kPgRefresh) {
    cond = (n + 1) % cap == 0;
  } else {
    const bool enter = mode == kPgGnEnter || mode == kPgTrialEnter || mode == kPgCgEnter;
    n = enter ? 0 : n + 1;
    *counter = n;
    const int slot = mode == kPgGnEnter ? kCountSolves
                     : mode == kPgGnStep ? kCountIterations
                     : mode == kPgTrialStep ? kCountTrials
                     : mode == kPgCgEnter ? kCountPcgs
                     : mode == kPgCgStep ? kCountCg : -1;
    if (slot >= 0) counts[slot] += 1;
    cond = n < cap;
    if (mode == kPgCgEnter || mode == kPgCgStep) {
      cond = cond && *rr > *thresh;  // false for a NaN residual, as in JAX
    } else {
      cond = cond && *stop == 0;
    }
  }
  *flag = static_cast<int>(cond);
  if (set_handle) cudaGraphSetConditional(handle, cond);
}

// Graph-building calls are made in relaxed capture mode: a capture of
// torch's in global mode would otherwise refuse any call it deems unsafe.
struct RelaxedCapture {
  cudaStreamCaptureMode saved = cudaStreamCaptureModeRelaxed;
  RelaxedCapture() { cudaThreadExchangeStreamCaptureMode(&saved); }
  ~RelaxedCapture() { cudaThreadExchangeStreamCaptureMode(&saved); }
};

cudaError_t capture_info(cudaStream_t stream, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n) {
  cudaStreamCaptureStatus status;
  unsigned long long id;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, &id, graph, deps, n);
  if (err == cudaSuccess && status != cudaStreamCaptureStatusActive)
    err = cudaErrorIllegalState;  // the stream is not capturing
  return err;
}

}  // namespace

// One launch of the condition kernel on `stream`.  state (64 floats), H (36),
// y0 (1), H_out (36), y_out (1), converged (1 byte), iterations (1 int),
// flag (1 int), counts (4 ints): device memory.  With set_handle, the condition is also
// written into `handle` (the kernel must then be part of the graph that
// owns the handle).  Returns cudaGetLastError().
extern "C" int fgt_loop_cond(float* state, const float* H, const float* y0, float* H_out,
                             float* y_out, unsigned char* converged, int* iterations, int* flag,
                             int* counts, int mode, int max_iterations, int lm_max_iterations,
                             int lm, unsigned long long handle, int set_handle, void* stream) {
  loop_cond_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      state, H, y0, H_out, y_out, converged, iterations, flag, counts, mode, max_iterations,
      lm_max_iterations, lm, static_cast<cudaGraphConditionalHandle>(handle), set_handle);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the pose-graph condition kernel on `stream`.  counter (1
// int), flag (1 int), counts (the tally's 8 ints; it adds to the first six)
// and, where the mode reads them, stop (1 byte: a bool tensor's), rr and
// thresh (1 float each): device memory; the others may be null.  cap > 0 for kPgRefresh.  With set_handle, the
// condition also goes into `handle`.  Returns cudaGetLastError().
extern "C" int fgt_pg_cond(int* counter, const unsigned char* stop, const float* rr,
                           const float* thresh, int* flag, int* counts, int mode, int cap,
                           unsigned long long handle, int set_handle, void* stream) {
  pg_cond_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      counter, stop, rr, thresh, flag, counts, mode, cap,
      static_cast<cudaGraphConditionalHandle>(handle), set_handle);
  return static_cast<int>(cudaGetLastError());
}

// A conditional handle (default value 0, assigned by the condition kernel
// before the node is reached) on the graph that `stream` is capturing into.
extern "C" int fgt_cond_handle_create(void* stream, unsigned long long* handle_out) {
  RelaxedCapture relaxed;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n;
  cudaError_t err = capture_info(static_cast<cudaStream_t>(stream), &graph, &deps, &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err == cudaSuccess) *handle_out = static_cast<unsigned long long>(handle);
  return static_cast<int>(err);
}

namespace {

// Adds a conditional node of `type` on `handle` to the graph `stream` is
// capturing into, after the capture's current dependencies, makes the node
// the stream's one dependency (what the stream captures next runs after it),
// and begins capturing `body_stream` into the node's body graph.
int cond_begin(void* stream, unsigned long long handle, void* body_stream,
               cudaGraphConditionalNodeType type) {
  RelaxedCapture relaxed;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n;
  cudaError_t err = capture_info(s, &graph, &deps, &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = static_cast<cudaGraphConditionalHandle>(handle);
  params.conditional.type = type;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraph_t body = params.conditional.phGraph_out[0];
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream), body, nullptr,
                                      nullptr, 0, cudaStreamCaptureModeRelaxed);
  return static_cast<int>(err);
}

}  // namespace

// A WHILE node on `handle` (cond_begin): its body runs while the handle is
// nonzero, the handle read before each trip.
extern "C" int fgt_while_begin(void* stream, unsigned long long handle, void* body_stream) {
  return cond_begin(stream, handle, body_stream, cudaGraphCondTypeWhile);
}

// An IF node on `handle` (cond_begin): its body runs once if the handle is
// nonzero.
extern "C" int fgt_if_begin(void* stream, unsigned long long handle, void* body_stream) {
  return cond_begin(stream, handle, body_stream, cudaGraphCondTypeIf);
}

// Ends the capture of a conditional node's body that fgt_while_begin or
// fgt_if_begin started.
extern "C" int fgt_while_end(void* body_stream) {
  RelaxedCapture relaxed;
  cudaGraph_t body;
  return static_cast<int>(cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body));
}
