// Asynchronous 16- and 8-byte copies from device memory into shared memory
// (cp.async, sm_80 and later), used by the rings of csrc/stem_conv.cu and
// csrc/gather_gemm.cuh. A copy bypasses the registers: the thread starts it
// and goes on; copies are collected into groups with cp_async_commit and
// awaited with cp_async_wait<N> (all but the newest N groups have landed).
#pragma once

#include <cuda_runtime.h>

namespace mgar {

// Copies 16 bytes from src to the shared-memory address dst; with
// pred == false nothing is read and dst gets 16 zero bytes (src must still
// be a valid pointer). Both addresses are 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

// The same for 8 bytes (through L1: the .cg form takes 16 bytes only);
// both addresses are 8-byte aligned.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = pred ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace mgar
