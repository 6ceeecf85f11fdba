// The masked affinity tile, shared by every affinity-family kernel.
//
// CUDA form of the reference's shared _masked_tile
// (src/repro/kernels/streaming.py): affinity.cu writes the tile to A, and
// streaming.cu folds it into the power sweep or the degree without storing
// it. Both call the functions below with the same thread-to-column layout,
// so a streamed tile entry is the stored one, bit for bit, by construction.
//
// Layout: a block of TN = 256 threads owns TM consecutive rows and walks
// the column tiles c0 = 0, TN, 2 TN, ... in order; thread t owns column
// c0 + t of each tile. Feature slabs are staged in shared memory in chunks
// of at most MC features, so any m works.
//
// Arithmetic, one rounding per step as the plain PyTorch version rounds:
//  * squared norms (rbf): __fadd_rn / __fmul_rn over the features in order;
//  * the dot product: an fmaf chain over the features in order, from 0;
//  * the transform: cosine = dot, cosine_shifted = 0.5 * (1 + dot),
//    rbf = expf(-max(sqr + sqc - 2 dot, 0) * inv_two_sigma_sq);
//  * the mask: 0 outside the (n_rows, n_cols) stripe and on the global
//    diagonal (row_offset + i == col_offset + j).
#pragma once

#include "common.cuh"

namespace tile {

constexpr int TN = 256;  // columns per tile == threads per block
constexpr int MC = 32;   // feature chunk staged in shared memory
constexpr int NWARPS = TN / 32;

enum Kind { COSINE = 0, COSINE_SHIFTED = 1, RBF = 2 };

// Dynamic shared memory of a block of tm rows: s_xc[TN][kmax + 1] (padded:
// conflict-free column reads), then s_xr[tm][kmax].
inline size_t smem_bytes(int tm, int m) {
    const int kmax = m < MC ? m : MC;
    return sizeof(float) * (TN * (kmax + 1) + tm * kmax);
}

// Squared norms of the block's TM rows into s_sqr (0 unless rbf). The
// caller synchronizes before the first tile reads them.
template <int TM>
__device__ __forceinline__ void row_sq_norms(const float* __restrict__ xr, int n_rows,
                                             int m, int row0, bool rbf, float* s_sqr) {
    const int tid = threadIdx.x;
    if (tid < TM) {
        float s = 0.f;
        const int row = row0 + tid;
        if (rbf && row < n_rows) {
            const float* xrow = xr + static_cast<size_t>(row) * m;
            for (int k = 0; k < m; ++k) s = __fadd_rn(s, __fmul_rn(xrow[k], xrow[k]));
        }
        s_sqr[tid] = s;
    }
}

__device__ __forceinline__ float transform(int kind, float dot, float sqr, float sqc,
                                           float inv_two_sigma_sq) {
    if (kind == COSINE) return dot;
    if (kind == COSINE_SHIFTED) return __fmul_rn(0.5f, __fadd_rn(1.0f, dot));
    const float d2 = __fsub_rn(__fadd_rn(sqr, sqc), __fmul_rn(2.0f, dot));
    return expf(__fmul_rn(-nan_max(d2, 0.f), inv_two_sigma_sq));
}

// The masked tile entries of rows row0 .. row0 + TM - 1 at this thread's
// column c0 + threadIdx.x: emit(r, a) receives each entry as soon as it is
// made, so the caller's store or fold interleaves with the transform.
// Every thread of the block must call it for every tile (it synchronizes
// the block).
template <int TM, typename Emit>
__device__ __forceinline__ void masked_tile(
    const float* __restrict__ xr, const float* __restrict__ xc,
    float* s_xc, float* s_xr, const float* s_sqr, int row0, int c0,
    int n_rows, int n_cols, int m, int row_offset, int col_offset,
    int kind, float inv_two_sigma_sq, Emit emit) {
    const int tid = threadIdx.x;
    const int kmax = min(m, MC);
    const int col = c0 + tid;
    const bool rbf = kind == RBF;
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
        const float v = transform(kind, acc[r], s_sqr[r], sqc, inv_two_sigma_sq);
        const bool keep = row < n_rows && col < n_cols && row_offset + row != col_offset + col;
        emit(r, keep ? v : 0.f);
    }
}

// Fixed-order block reduction of K per-thread partials: a warp tree
// (__shfl_down_sync, offsets 16 down to 1), then the NWARPS warp sums in
// warp order. Thread t < K returns the block total of partial t (others
// return 0). s_red holds NWARPS * K floats. No atomics: the same bits on
// every run.
template <int K>
__device__ __forceinline__ float block_reduce_fixed(const float (&part)[K], float* s_red) {
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
#pragma unroll
    for (int c = 0; c < K; ++c) {
        float s = part[c];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
        if (lane == 0) s_red[warp * K + c] = s;
    }
    __syncthreads();
    float s = 0.f;
    if (tid < K) {
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) s += s_red[w * K + tid];
    }
    return s;
}

}  // namespace tile
