// 16-byte asynchronous copies from device to shared memory (sm_80 and up),
// shared by the Relief kernels.
#pragma once

#include <cuda_runtime.h>

namespace fs {

// Copy 16 bytes from `src` to `dst` (both 16-byte aligned), bypassing L1;
// with `valid` false, write 16 zero bytes and read nothing from `src`.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Let `kernel` take `bytes` of dynamic shared memory (past the default
// 48 KB only with this opt-in).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace fs
