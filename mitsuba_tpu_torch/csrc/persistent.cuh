// The persistent grid of the port's kernels (sm_90a): csrc/intersect_packed.cu,
// csrc/megakernel.cu and csrc/megakernel_bvh.cu launch as many blocks as
// the card holds at once, and their threads take work from a counter in
// device memory until it runs out.
#pragma once

#include <cuda_runtime.h>

namespace mk {

// What a persistent launch of `kernel` uses: blocks, resident blocks per
// SM (from the occupancy calculator at these threads and dynamic shared
// bytes), threads a block, SMs.
struct PersistentGrid {
  int blocks, resident, threads, sms;
};

// Fills `g` for `kernel` at `threads` a block and `smem` dynamic shared
// bytes: SMs x resident blocks, capped at `max_blocks` (the blocks that
// have any work).  Sets the kernel's dynamic shared memory limit to
// `smem`, which above 48 KB must be asked for.  Returns the first CUDA
// error.
template <class Kernel>
inline cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem,
                                   int max_blocks, PersistentGrid& g) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&g.sms, cudaDevAttrMultiProcessorCount,
                                 dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&g.resident, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  if (g.resident < 1) return cudaErrorInvalidConfiguration;
  g.threads = threads;
  g.blocks = g.sms * g.resident < max_blocks ? g.sms * g.resident
                                              : max_blocks;
  return cudaSuccess;
}

}  // namespace mk
