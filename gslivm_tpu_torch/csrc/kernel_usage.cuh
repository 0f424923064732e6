// Resource use of a kernel as the CUDA runtime reports it for the current
// device, shared by every kernel library that exports a `<entry>_usage`
// C function (kernels.py:usage).
#pragma once

#include <cuda_runtime.h>

// Into out[5]: registers and local (stack and spill) bytes per thread,
// static and dynamic shared bytes per block, and the blocks of `threads`
// threads with dyn_smem dynamic shared bytes that one SM holds. Returns a
// cudaError_t.
template <typename Kernel>
inline int kernel_usage(Kernel kernel, int threads, int dyn_smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, dyn_smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = dyn_smem;
  out[4] = blocks;
  return 0;
}
