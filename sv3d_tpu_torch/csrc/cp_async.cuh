// cp.async helpers shared by the tensor-core tiles (mma_bf16.cuh) and the
// f32 FMA tiles (fma_f32.cuh): 16-byte and 4-byte copies from device memory
// into shared memory that bypass the registers, with a zero-filling form for
// the ragged edges of a tile (src_bytes 0 writes zeros and reads nothing).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// 16 bytes, of which the first src_bytes (0 or 16) are read and the rest zeroed
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes, read when src_bytes is 4, zeroed when it is 0
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
