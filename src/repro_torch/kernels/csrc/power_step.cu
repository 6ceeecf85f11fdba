// Degree-normalized mat-mat sweep for Hopper (sm_90a):
//     U = (A V) / max(d, 1e-30),  A (R, C) f32, V (C, r) f32, d (R,) f32.
//
// Replaces: src/repro/kernels/power_step.py::degree_normalized_matmat (the
// Pallas TPU kernel _power_step_kernel), which runs once per power sweep.
//
// Bound on an H100: the read of A. At n = 45,000 that is 8.1 GB per sweep,
// about 2.4 ms at 3.35 TB/s; V, d and U are O(n r) and the 2 n^2 r flops
// are far under the line at r <= 32.
//
// Design:
//  * One block of 256 threads per row of A. The threads stream the row
//    with consecutive addresses (each warp load is 128 contiguous bytes),
//    four loads in flight per thread, through the streaming cache hint so
//    A does not evict V, which stays in L2 (n r floats).
//  * Each thread accumulates its r partials in registers in a fixed order
//    (columns t, t + 256, ...); the block then reduces them with a warp
//    tree and the 8 warps in order. No atomics: U is the same from run to
//    run.
//  * r is a template bound RT in {1, 2, 4, 8, 16, 32} so the partials stay
//    in registers; the wrapper rejects r > 32.
//  * The epilogue is the floored divide the reference pins
//    (u / max(d, 1e-30), NaN degrees propagate).

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int UNROLL = 4;

template <int RT>
__global__ void __launch_bounds__(THREADS) power_step_kernel(
    const float* __restrict__ a, const float* __restrict__ v,
    const float* __restrict__ d, float* __restrict__ u,
    int n_cols, int r) {
    __shared__ float s_red[NWARPS][RT];
    const int row = blockIdx.x;
    const int tid = threadIdx.x;
    const float* arow = a + static_cast<size_t>(row) * n_cols;

    float acc[RT];
#pragma unroll
    for (int c = 0; c < RT; ++c) acc[c] = 0.f;

    int j = tid;
    for (; j + (UNROLL - 1) * THREADS < n_cols; j += UNROLL * THREADS) {
        float av[UNROLL];
#pragma unroll
        for (int q = 0; q < UNROLL; ++q) av[q] = __ldcs(arow + j + q * THREADS);
#pragma unroll
        for (int q = 0; q < UNROLL; ++q) {
            const float* vrow = v + static_cast<size_t>(j + q * THREADS) * r;
#pragma unroll
            for (int c = 0; c < RT; ++c)
                if (c < r) acc[c] = fmaf(av[q], vrow[c], acc[c]);
        }
    }
    for (; j < n_cols; j += THREADS) {
        const float aj = __ldcs(arow + j);
        const float* vrow = v + static_cast<size_t>(j) * r;
#pragma unroll
        for (int c = 0; c < RT; ++c)
            if (c < r) acc[c] = fmaf(aj, vrow[c], acc[c]);
    }

    const int lane = tid & 31;
    const int warp = tid >> 5;
#pragma unroll
    for (int c = 0; c < RT; ++c) {
        float s = acc[c];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
        if (lane == 0) s_red[warp][c] = s;
    }
    __syncthreads();
    if (tid < r) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) s += s_red[w][tid];
        u[static_cast<size_t>(row) * r + tid] = __fdiv_rn(s, nan_max(d[row], 1e-30f));
    }
}

template <int RT>
void launch(const float* a, const float* v, const float* d, float* u,
            int n_rows, int n_cols, int r, cudaStream_t stream) {
    power_step_kernel<RT><<<n_rows, THREADS, 0, stream>>>(a, v, d, u, n_cols, r);
}

}  // namespace

extern "C" int gpic_degree_normalized_matmat(
    const float* a, const float* v, const float* d, float* u,
    int n_rows, int n_cols, int r, cudaStream_t stream) {
    if (r <= 1) launch<1>(a, v, d, u, n_rows, n_cols, r, stream);
    else if (r <= 2) launch<2>(a, v, d, u, n_rows, n_cols, r, stream);
    else if (r <= 4) launch<4>(a, v, d, u, n_rows, n_cols, r, stream);
    else if (r <= 8) launch<8>(a, v, d, u, n_rows, n_cols, r, stream);
    else if (r <= 16) launch<16>(a, v, d, u, n_rows, n_cols, r, stream);
    else if (r <= 32) launch<32>(a, v, d, u, n_rows, n_cols, r, stream);
    else return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}
