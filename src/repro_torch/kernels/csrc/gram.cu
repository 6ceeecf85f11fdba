// Tall-skinny Gram G = V^T V for Hopper (sm_90a), V (n, c) f32, c <= 64.
//
// Replaces: src/repro/kernels/gram.py::gram (the Pallas TPU kernel
// _gram_kernel), which prices the Cholesky-QR of every orthogonal sweep
// and the subspace residual stopping rule ([V | U], so c up to 2r).
//
// Bound on an H100: the read of V, n c 4 bytes (1.4 us at n = 45,000,
// c = 4), against 2 n c^2 operations. At the power loop's shapes the kernel
// is launch-bound: its two launches cost more than either term.
//
// Design:
//  * Pass 1: block b reduces the fixed, contiguous rows
//    [b ROWS, (b + 1) ROWS) into a (c, c) partial. Rows are staged in
//    shared memory CHUNK at a time; thread t owns entries t, t + 256, ...
//    of the partial and adds the rows in row order with fmaf.
//  * Pass 2: one block adds the partials in block order.
//  * No float atomics: the Gram feeds every QR and the residual rule, so it
//    gives the same bits on every run. fmaf(a, b, s) == fmaf(b, a, s), so G
//    is exactly symmetric.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 256;     // rows per block of pass 1
constexpr int CHUNK = 32;     // rows staged in shared memory at a time
constexpr int MAX_C = 64;
constexpr int EPT = MAX_C * MAX_C / THREADS;  // entries per thread, at most

__global__ void __launch_bounds__(THREADS) gram_partial_kernel(
    const float* __restrict__ v, float* __restrict__ part, int n, int c) {
    __shared__ float s_v[CHUNK * MAX_C];
    const int tid = threadIdx.x;
    const int cc = c * c;
    const int r0 = blockIdx.x * ROWS;
    const int r1 = min(r0 + ROWS, n);

    float acc[EPT];
#pragma unroll
    for (int q = 0; q < EPT; ++q) acc[q] = 0.f;

    for (int k0 = r0; k0 < r1; k0 += CHUNK) {
        const int kc = min(CHUNK, r1 - k0);
        __syncthreads();  // the previous chunk has been consumed
        for (int e = tid; e < kc * c; e += THREADS)
            s_v[e] = v[static_cast<size_t>(k0) * c + e];
        __syncthreads();
#pragma unroll
        for (int q = 0; q < EPT; ++q) {
            const int e = tid + q * THREADS;
            if (e < cc) {
                const int i = e / c, j = e - i * c;
                float s = acc[q];
                for (int k = 0; k < kc; ++k) s = fmaf(s_v[k * c + i], s_v[k * c + j], s);
                acc[q] = s;
            }
        }
    }
#pragma unroll
    for (int q = 0; q < EPT; ++q) {
        const int e = tid + q * THREADS;
        if (e < cc) part[static_cast<size_t>(blockIdx.x) * cc + e] = acc[q];
    }
}

__global__ void __launch_bounds__(THREADS) gram_finish_kernel(
    const float* __restrict__ part, float* __restrict__ g, int n_blocks, int cc) {
    for (int e = threadIdx.x; e < cc; e += THREADS) {
        float s = 0.f;
        for (int b = 0; b < n_blocks; ++b) s += part[static_cast<size_t>(b) * cc + e];
        g[e] = s;
    }
}

}  // namespace

// Rows per block of pass 1: the wrapper sizes the (n_blocks, c * c)
// scratch ``part`` with it.
extern "C" int gpic_gram_rows_per_block() { return ROWS; }

extern "C" int gpic_gram(const float* v, float* part, float* g, int n, int c,
                         cudaStream_t stream) {
    if (c < 1 || c > MAX_C || n < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int n_blocks = (n + ROWS - 1) / ROWS;
    gram_partial_kernel<<<n_blocks, THREADS, 0, stream>>>(v, part, n, c);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    gram_finish_kernel<<<1, THREADS, 0, stream>>>(part, g, n_blocks, c * c);
    return static_cast<int>(cudaGetLastError());
}
