// Shared helpers of the GPIC kernels (each .cu builds into its own shared
// library with a plain C interface, loaded from Python with ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// max(x, lo) that keeps a NaN x, like jnp.maximum / torch.clamp_min
// (fmaxf alone would swallow it and hide a corrupt input from the power
// loop's non-finite latch).
__device__ __forceinline__ float nan_max(float x, float lo) {
    return isnan(x) ? x : fmaxf(x, lo);
}

// A's stored types: float, or __nv_bfloat16 (the reference's a_dtype,
// O4). An entry is made and summed in f32 and rounded once when it is
// stored, to nearest even as astype and torch's .to() round; a sweep
// widens each stored entry back to f32, which is exact, so a bf16 A sweeps
// to the bits of the same kernel on its f32 upcast.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}
// One entry of A loaded, or stored, with the streaming cache hint (A is
// read or written once a pass and would only evict what is reused).
__device__ __forceinline__ float ldcs_f32(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float ldcs_f32(const __nv_bfloat16* p) {
    return __bfloat162float(
        __ushort_as_bfloat16(__ldcs(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void stcs_f32(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void stcs_f32(__nv_bfloat16* p, float v) {
    __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(__float2bfloat16_rn(v)));
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
