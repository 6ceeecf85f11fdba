// Fragment helpers of kernel 12's forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu): split-TF32 mma.sync m16n8k8 operands, bf16
// transposed fragment loads and the tile staging, for blocks of 4 warps.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace flash {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
    return __float2bfloat16_rn(0.f);
}

// Elements p[0] and p[1] as f32 (p is 8-byte aligned for f32, 4 for bf16).
__device__ __forceinline__ void load_pair(const float* p, float& x0, float& x1) {
    const float2 w = *reinterpret_cast<const float2*>(p);
    x0 = w.x;
    x1 = w.y;
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float& x0, float& x1) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    x0 = __uint_as_float(w << 16);
    x1 = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ uint32_t tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

// x = hi + lo to about 2^-22 of x, hi and lo TF32 values
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
}

// c += a b over one 16 x 8 x 8 TF32 step, f32 accumulation
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// N = 4 or 2 8 x 8 bf16 tiles, transposed: lanes 8m..8m+7 give the
// row addresses of tile m; each lane gets rows 2t and 2t + 1 of column g.
template <int N>
__device__ __forceinline__ void ldmatrix_t(uint32_t (&r)[N], const void* p) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    if constexpr (N == 4)
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
                     : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
    else
        asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
                     : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

// Rows [r0, r0 + ROWS) of a (s, d) head with row stride ``ss`` into a
// (ROWS, DP) tile of pitch PITCH, in the source's type; rows past s and
// columns past d read as 0. ASYNC: 16-byte cp.async (rows and d 16-byte
// aligned, checked by the wrapper), else plain loads and stores.
template <bool ASYNC, int ROWS, int DP, int PITCH, typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, long long ss, int r0, int s,
                                      int d) {
    if constexpr (ASYNC) {
        constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // elements a chunk
        constexpr int CPR = DP / EPC;                          // chunks a row
        const int d_chunks = d / EPC;
        for (int e = threadIdx.x; e < ROWS * CPR; e += THREADS) {
            const int r = e / CPR, c = e - r * CPR;
            const int row = r0 + r;
            const bool ok = row < s && c < d_chunks;
            const T* from = ok ? src + static_cast<long long>(row) * ss + c * EPC : src;
            cp_async16(dst + r * PITCH + c * EPC, from, ok ? 16 : 0);
        }
    } else {
        for (int e = threadIdx.x; e < ROWS * DP; e += THREADS) {
            const int r = e / DP, c = e - r * DP;
            const int row = r0 + r;
            dst[r * PITCH + c] =
                row < s && c < d ? src[static_cast<long long>(row) * ss + c] : zero<T>();
        }
    }
}

}  // namespace flash
