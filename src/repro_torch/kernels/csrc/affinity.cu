// Fused affinity stripe + degree build for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/affinity.py::affinity_and_degree (the Pallas
// TPU kernel _affinity_kernel), dense fixed-bandwidth specs: cosine,
// cosine_shifted and rbf. It computes the (R, C) stripe
// A[row_offset:row_offset+R, col_offset:col_offset+C] of the masked
// similarity matrix and D, the stripe's row sums, in one pass.
//
// Bound on an H100: the write of A. At n = 45,000 A is n^2 * 4 B = 8.1 GB,
// about 2.4 ms at 3.35 TB/s; the features it reads are n * m * 4 B. The
// arithmetic (2m FMAs, the transform and, for rbf, one expf per entry) sits
// under that line.
//
// Design:
//  * One block of TN = 256 threads owns TM = 16 rows and loops over ALL
//    column tiles of TN columns. Thread t owns column c0 + t of each tile,
//    so every store of a row is 256 consecutive floats (coalesced), and
//    the 16 rows' partial sums stay in registers for the whole sweep.
//  * The TPU kernel carries D across its sequential column grid; Hopper
//    blocks run in no order, so the column loop lives inside the block
//    instead, and D is written once after a fixed-order block reduction
//    (warp tree, then the 8 warps in order). No atomics: D is the same from
//    run to run, which the power loop's stopping rule (accel <= 1e-5/n)
//    depends on.
//  * The feature slabs are staged in shared memory in chunks of at most
//    MC = 32 features, so any m works; the dot product runs as an fmaf
//    chain over the features in order.
//  * The ragged edge is masked in the kernel (no padding copies), and the
//    global diagonal (row_offset + i == col_offset + j) is zeroed.
//  * The transform is the one of affinity_tile_transform, with the
//    element-wise steps rounded one by one (__f*_rn) as the plain PyTorch
//    version rounds them: cosine = dot, cosine_shifted = 0.5 * (1 + dot),
//    rbf = exp(-max(sqr + sqc - 2 dot, 0) * inv_two_sigma_sq).

#include "common.cuh"

namespace {

constexpr int TM = 16;   // rows per block
constexpr int TN = 256;  // columns per tile == threads per block
constexpr int MC = 32;   // feature chunk staged in shared memory
constexpr int NWARPS = TN / 32;

enum Kind { COSINE = 0, COSINE_SHIFTED = 1, RBF = 2 };

__global__ void __launch_bounds__(TN) affinity_kernel(
    const float* __restrict__ xr, const float* __restrict__ xc,
    float* __restrict__ a, float* __restrict__ d,
    int n_rows, int n_cols, int m, int row_offset, int col_offset,
    int kind, float inv_two_sigma_sq) {
    // dynamic shared memory: s_xc[TN][kmax + 1] (padded: conflict-free
    // column reads), s_xr[TM][kmax]
    extern __shared__ float smem[];
    const int kmax = min(m, MC);
    float* s_xc = smem;
    float* s_xr = smem + TN * (kmax + 1);
    __shared__ float s_sqr[TM];
    __shared__ float s_red[NWARPS][TM];

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int row0 = blockIdx.x * TM;
    const bool rbf = kind == RBF;

    // squared norms of the block's rows (rbf only), features in order
    if (tid < TM) {
        float s = 0.f;
        const int row = row0 + tid;
        if (rbf && row < n_rows) {
            const float* xrow = xr + static_cast<size_t>(row) * m;
            for (int k = 0; k < m; ++k) s = __fadd_rn(s, __fmul_rn(xrow[k], xrow[k]));
        }
        s_sqr[tid] = s;
    }

    float rowsum[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) rowsum[r] = 0.f;

    for (int c0 = 0; c0 < n_cols; c0 += TN) {
        const int col = c0 + tid;
        float acc[TM];
#pragma unroll
        for (int r = 0; r < TM; ++r) acc[r] = 0.f;
        float sqc = 0.f;

        for (int k0 = 0; k0 < m; k0 += MC) {
            const int kc = min(MC, m - k0);
            __syncthreads();  // the previous chunk has been consumed
            // the row slab changes only with the feature chunk
            if (m > MC || c0 == 0) {
                for (int e = tid; e < TM * kc; e += TN) {
                    const int r = e / kc, k = e - r * kc;
                    const int row = row0 + r;
                    s_xr[r * kmax + k] = row < n_rows
                        ? xr[static_cast<size_t>(row) * m + k0 + k] : 0.f;
                }
            }
            for (int e = tid; e < TN * kc; e += TN) {
                const int j = e / kc, k = e - j * kc;
                const int cc = c0 + j;
                s_xc[j * (kmax + 1) + k] = cc < n_cols
                    ? xc[static_cast<size_t>(cc) * m + k0 + k] : 0.f;
            }
            __syncthreads();
            for (int k = 0; k < kc; ++k) {
                const float cv = s_xc[tid * (kmax + 1) + k];
                if (rbf) sqc = __fadd_rn(sqc, __fmul_rn(cv, cv));
#pragma unroll
                for (int r = 0; r < TM; ++r)
                    acc[r] = fmaf(s_xr[r * kmax + k], cv, acc[r]);
            }
        }

#pragma unroll
        for (int r = 0; r < TM; ++r) {
            const int row = row0 + r;
            float v;
            if (kind == COSINE) {
                v = acc[r];
            } else if (kind == COSINE_SHIFTED) {
                v = __fmul_rn(0.5f, __fadd_rn(1.0f, acc[r]));
            } else {
                const float d2 = __fsub_rn(__fadd_rn(s_sqr[r], sqc),
                                           __fmul_rn(2.0f, acc[r]));
                v = expf(__fmul_rn(-nan_max(d2, 0.f), inv_two_sigma_sq));
            }
            const bool inside = row < n_rows && col < n_cols;
            if (!inside || row_offset + row == col_offset + col) v = 0.f;
            if (inside) a[static_cast<size_t>(row) * n_cols + col] = v;
            rowsum[r] += v;
        }
    }

    // fixed-order reduction of the row sums: warp tree, then warps in order
#pragma unroll
    for (int r = 0; r < TM; ++r) {
        float s = rowsum[r];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
        if (lane == 0) s_red[warp][r] = s;
    }
    __syncthreads();
    if (tid < TM && row0 + tid < n_rows) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) s += s_red[w][tid];
        d[row0 + tid] = s;
    }
}

}  // namespace

extern "C" int gpic_affinity_and_degree(
    const float* xr, const float* xc, float* a, float* d,
    int n_rows, int n_cols, int m, int row_offset, int col_offset,
    int kind, float inv_two_sigma_sq, cudaStream_t stream) {
    const int kmax = m < MC ? m : MC;
    const size_t smem = sizeof(float) * (TN * (kmax + 1) + TM * kmax);
    const int grid = (n_rows + TM - 1) / TM;
    affinity_kernel<<<grid, TN, smem, stream>>>(
        xr, xc, a, d, n_rows, n_cols, m, row_offset, col_offset, kind,
        inv_two_sigma_sq);
    return static_cast<int>(cudaGetLastError());
}
