// The launch-config query that each source's `<name>_launch_config` entry
// point answers with, for the launch-config checker
// (repro_torch.analysis.kernels) and the occupancy the smoke prints. One
// copy, included by every source: build.library_path hashes this header
// into each library's name, so an edit here rebuilds them all.

#pragma once

#include <cuda_runtime.h>

// A kernel's resources at the threads and dynamic shared memory its
// launcher passes: into out[0..6], cudaFuncGetAttributes' numRegs,
// sharedSizeBytes, localSizeBytes and maxThreadsPerBlock, the threads, the
// dynamic bytes, and cudaOccupancyMaxActiveBlocksPerMultiprocessor at
// those. Dynamic shared memory above the 48 KiB default is opted into
// first, as every launcher does (below it the attribute changes nothing
// the query reports). Returns the cudaError.
template <typename Kernel>
int launch_resources(Kernel kernel, int threads, size_t smem, int* out) {
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = a.maxThreadsPerBlock;
  out[4] = threads;
  out[5] = static_cast<int>(smem);
  out[6] = blocks;
  return 0;
}
