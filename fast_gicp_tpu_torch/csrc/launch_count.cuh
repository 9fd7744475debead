// The device's tally of kernel runs (ops/tally.py): a kernel given a slot
// of it adds one to the slot as it runs, from block (0, 0, 0)'s thread
// (0, 0, 0), so the runs of a CUDA graph's replays are counted too, which a
// host counter (one an enqueue) cannot see.  A run in a counted form (a
// linearize reading rows by index, an NDT lookup) also adds one to the next
// slot, the form's.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void count_launch(int* launches, bool form = false) {
  if (launches != nullptr && (blockIdx.x | blockIdx.y | blockIdx.z) == 0 &&
      (threadIdx.x | threadIdx.y | threadIdx.z) == 0) {
    atomicAdd(launches, 1);
    if (form) atomicAdd(launches + 1, 1);
  }
}
