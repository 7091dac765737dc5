// A kernel's compiled resources and occupancy, as the plan checker
// (repro_torch/analysis/hopper_check.py) reads them from the built
// library. Each source exports <kernel>_attributes(variant, smem, out),
// which picks one compiled template variant and calls
// kernel_attributes on it.
#pragma once

#include <cuda_runtime.h>

namespace repro {

// out[0] registers a thread, out[1] static shared memory (bytes), out[2]
// local memory a thread (bytes; above 0 the kernel spills), out[3] the
// most threads a block it can launch with, out[4] CTAs an SM at `threads`
// threads a block and `smem` bytes of dynamic shared memory, out[5]
// `threads` (the block size its launcher uses). The dynamic shared
// memory attribute is raised to `smem` where it is below it, never
// lowered, as the launchers raise it. Returns a CUDA error code or 0.
inline int kernel_attributes(const void* fn, int threads, int smem,
                             int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > a.maxDynamicSharedSizeBytes) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int ctas = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, threads,
                                                    static_cast<size_t>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = a.maxThreadsPerBlock;
  out[4] = ctas;
  out[5] = threads;
  return 0;
}

}  // namespace repro
