// Shared helpers of the GPIC kernels (each .cu builds into its own shared
// library with a plain C interface, loaded from Python with ctypes).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// max(x, lo) that keeps a NaN x, like jnp.maximum / torch.clamp_min
// (fmaxf alone would swallow it and hide a corrupt input from the power
// loop's non-finite latch).
__device__ __forceinline__ float nan_max(float x, float lo) {
    return isnan(x) ? x : fmaxf(x, lo);
}

// 16 bytes from global to shared memory without passing through registers;
// src_bytes < 16 zero-fills the rest (0: no read). Both addresses 16-byte
// aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(a), "l"(src),
                 "r"(src_bytes));
}
// The same for 4 bytes (cp.async.ca): src_bytes 0 zero-fills. Both
// addresses 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(a), "l"(src),
                 "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

extern "C" const char* gpic_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
