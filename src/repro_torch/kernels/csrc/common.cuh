// Shared helpers of the GPIC kernels (each .cu builds into its own shared
// library with a plain C interface, loaded from Python with ctypes).
#pragma once

#include <cuda_runtime.h>

// max(x, lo) that keeps a NaN x, like jnp.maximum / torch.clamp_min
// (fmaxf alone would swallow it and hide a corrupt input from the power
// loop's non-finite latch).
__device__ __forceinline__ float nan_max(float x, float lo) {
    return isnan(x) ? x : fmaxf(x, lo);
}

extern "C" const char* gpic_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
