// What a kernel launch asks of the card, read from the runtime: the query
// each .cu exports beside its launcher (nns_<name>_launch_info), for the
// port's launch analyzer (nnstreamer_tpu_torch/analysis/kernels.py).
//
// A launcher that takes a non-null `info` fills it for every kernel it
// would launch, in launch order, kFields values each, and launches nothing:
// the grid, block and dynamic shared memory come from the launcher's own
// code, the registers, static shared memory, local (spill) bytes and the
// block limit from cudaFuncGetAttributes, and the resident blocks an SM
// from cudaOccupancyMaxActiveBlocksPerMultiprocessor.
#pragma once

#include <cuda_runtime.h>

namespace nns_launch {

enum Field {
  kGridX, kGridY, kGridZ, kBlockX, kBlockY, kBlockZ, kDynSmem,
  kRegs, kStaticSmem, kLocalBytes, kMaxThreads, kBlocksPerSm, kFields
};

// Fill out[0 .. kFields) for `fn` launched as <<<grid, block, dyn>>>.
// `max_dyn` is the dynamic shared memory the launcher allows the kernel
// (cudaFuncAttributeMaxDynamicSharedMemorySize; 0 = it sets none), set
// here as the launcher sets it so that the occupancy is the launch's. A
// launch the card refuses reports 0 blocks an SM rather than an error.
inline cudaError_t describe(const void* fn, dim3 grid, dim3 block, size_t dyn, size_t max_dyn,
                            long long* out) {
  cudaFuncAttributes at;
  cudaError_t err = cudaFuncGetAttributes(&at, fn);
  if (err != cudaSuccess) return err;
  int resident = 0;
  bool settable = true;
  if (max_dyn > 0)
    settable = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(max_dyn)) == cudaSuccess;
  if (!settable || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &resident, fn, static_cast<int>(block.x * block.y * block.z), dyn) !=
                       cudaSuccess)
    resident = 0;
  cudaGetLastError();  // a refused attribute or occupancy query is a reading, not a fault
  out[kGridX] = grid.x;
  out[kGridY] = grid.y;
  out[kGridZ] = grid.z;
  out[kBlockX] = block.x;
  out[kBlockY] = block.y;
  out[kBlockZ] = block.z;
  out[kDynSmem] = static_cast<long long>(dyn);
  out[kRegs] = at.numRegs;
  out[kStaticSmem] = static_cast<long long>(at.sharedSizeBytes);
  out[kLocalBytes] = static_cast<long long>(at.localSizeBytes);
  out[kMaxThreads] = at.maxThreadsPerBlock;
  out[kBlocksPerSm] = resident;
  return cudaSuccess;
}

}  // namespace nns_launch
