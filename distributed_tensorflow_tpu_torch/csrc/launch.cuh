// Shared by the launchers: the dynamic shared-memory opt-in, per device.
//
// cudaFuncSetAttribute(..., MaxDynamicSharedMemorySize, ...) sets an
// attribute of the kernel on the *current* device only.  A launcher that
// remembered one process-wide "done" flag would opt in on the first card
// it ran on and then launch on another card without it, and that launch
// would be refused.  Each launcher keeps one flag per device instead
// (indexed by cudaGetDevice); the Python wrappers make the operands'
// device current before they call in.

#pragma once

#include <cuda_runtime.h>

namespace dtt {

constexpr int kMaxDevices = 64;

// Opt `kernel` in to `smem` bytes of dynamic shared memory on the current
// device once; `done` is the launcher's own per-device flag array (one
// static array per kernel instantiation).  Two threads racing here both
// set the same attribute, which is harmless.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t smem,
                        bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess) done[dev] = true;
  return e;
}

}  // namespace dtt
