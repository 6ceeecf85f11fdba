// The affinity tile, shared by every affinity-family kernel.
//
// CUDA form of the reference's shared _masked_tile
// (src/repro/kernels/streaming.py) and of the row-top-k kernel's scoring
// (src/repro/kernels/row_topk.py): affinity.cu writes the tile to A,
// streaming.cu folds it into the power sweep or the degree without storing
// it, row_topk.cu ranks its scores, and block_sparse.cu folds or tests the
// live tiles of a block plan. All call the functions below with
// the same thread-to-column layout, so a streamed tile entry is the stored
// one, and a row-top-k score is the entry that the build compares with the
// threshold, bit for bit, by construction.
//
// Layout: a block of TN = 256 threads owns TM consecutive rows and walks
// the column tiles c0 = 0, TN, 2 TN, ... in order (a block-sparse kernel
// only the live ones, in the same order); thread t owns column c0 + t of
// each tile. Feature slabs are staged in shared memory in chunks
// of at most MC features, so any m works.
//
// Arithmetic, one rounding per step as the plain PyTorch version rounds:
//  * squared norms (rbf, and the neg_sqdist score of any kind):
//    __fadd_rn / __fmul_rn over the features in order;
//  * the dot product: an fmaf chain over the features in order, from 0;
//  * d2 = (sqr + sqc) - 2 dot;
//  * the transform: cosine = dot, cosine_shifted = 0.5 * (1 + dot),
//    rbf = expf(-max(d2, 0) * inv_two_sigma_sq), or with adaptive scales
//    expf(-max(d2, 0) / (scale_r[i] * scale_c[j])), a division by the
//    rounded product as the reference divides;
//  * the neg_sqdist score: -max(d2, 0);
//  * the mask: outside the (n_rows, n_cols) stripe and on the global
//    diagonal (row_offset + i == col_offset + j); masked_tile also drops
//    entries below the row's threshold (a < thr[i]) and, for the transpose
//    product, below the column's own threshold (a < thr_c[j]), and emits 0
//    for every dropped entry.
//
// Symmetry: S_ij == S_ji bit for bit (fmaf(a, b, s) == fmaf(b, a, s), and
// sums and products of two operands commute), which the transpose product
// of the component probe relies on.
//
// POLICY (a template flag) compiles the policy operands in; the dense
// fixed spec takes POLICY = false, which leaves no policy branch in the
// per-entry loop. Both forms make every entry with the same operations,
// so they give the same bits.
#pragma once

#include <math.h>

#include "common.cuh"

namespace tile {

constexpr int TN = 256;  // columns per tile == threads per block
constexpr int MC = 32;   // feature chunk staged in shared memory
constexpr int NWARPS = TN / 32;

enum Kind { COSINE = 0, COSINE_SHIFTED = 1, RBF = 2 };
enum Stat { SIMILARITY = 0, NEG_SQDIST = 1 };

// The graph-policy operands; a null pointer turns the policy off. Padded
// rows and columns take scale 1 and threshold +inf, as the reference pads.
struct Policy {
    const float* scale_r;  // (n_rows) adaptive local scales of the rows
    const float* scale_c;  // (n_cols) adaptive local scales of the columns
    const float* thr;      // (n_rows) row thresholds: keep a >= thr[i]
    const float* thr_c;    // (n_cols) column thresholds: keep a >= thr_c[j]
};

// Per-row values of the block's TM rows, in shared memory.
template <int TM>
struct Rows {
    float sqr[TM];   // squared norms (0 unless the score needs them)
    float sclr[TM];  // adaptive scales (1 without)
    float thr[TM];   // thresholds (+inf without)
};

// Rows per block of the streamed sweep with r <= RT columns: TM * RT
// register partials stay near 64 registers (streaming.cu, block_sparse.cu).
__host__ __device__ constexpr int tm_for(int rt) {
    return rt >= 32 ? 2 : rt >= 16 ? 4 : rt >= 8 ? 8 : 16;
}

// Dynamic shared memory of a block of tm rows: s_xc[TN][kmax + 1] (padded:
// conflict-free column reads), then s_xr[tm][kmax].
inline size_t smem_bytes(int tm, int m) {
    const int kmax = m < MC ? m : MC;
    return sizeof(float) * (TN * (kmax + 1) + tm * kmax);
}

__host__ __device__ inline bool needs_norms(int kind, int stat) {
    return kind == RBF || stat == NEG_SQDIST;
}

// Load the block's per-row values into rows. The caller synchronizes
// before the first tile reads them.
template <int TM>
__device__ __forceinline__ void load_rows(const float* __restrict__ xr, int n_rows, int m,
                                          int row0, bool norms, const Policy& pol,
                                          Rows<TM>& rows) {
    const int tid = threadIdx.x;
    if (tid < TM) {
        float s = 0.f;
        const int row = row0 + tid;
        const bool inside = row < n_rows;
        if (norms && inside) {
            const float* xrow = xr + static_cast<size_t>(row) * m;
            for (int k = 0; k < m; ++k) s = __fadd_rn(s, __fmul_rn(xrow[k], xrow[k]));
        }
        rows.sqr[tid] = s;
        rows.sclr[tid] = pol.scale_r != nullptr && inside ? pol.scale_r[row] : 1.f;
        rows.thr[tid] = pol.thr != nullptr && inside ? pol.thr[row] : INFINITY;
    }
}

__device__ __forceinline__ float sq_dist(float dot, float sqr, float sqc) {
    return __fsub_rn(__fadd_rn(sqr, sqc), __fmul_rn(2.0f, dot));
}

__device__ __forceinline__ float transform(int kind, float dot, float sqr, float sqc,
                                           float inv_two_sigma_sq, bool adaptive,
                                           float sclr, float sclc) {
    if (kind == COSINE) return dot;
    if (kind == COSINE_SHIFTED) return __fmul_rn(0.5f, __fadd_rn(1.0f, dot));
    const float neg_d2 = -nan_max(sq_dist(dot, sqr, sqc), 0.f);
    if (adaptive) return expf(__fdiv_rn(neg_d2, __fmul_rn(sclr, sclc)));
    return expf(__fmul_rn(neg_d2, inv_two_sigma_sq));
}

// The scores of rows row0 .. row0 + TM - 1 at this thread's column
// c0 + threadIdx.x (first: this is the first tile the block visits, so the
// row slab must be staged even when all features fit in one chunk; the
// dense kernels visit c0 = 0 first, the block-sparse ones their first live
// tile): emit(r, s, valid) receives each score as soon as it is
// made (the affinity value for SIMILARITY, -max(d2, 0) for NEG_SQDIST) with
// valid = inside the stripe and off the global diagonal. Every thread of
// the block must call it for every tile (it synchronizes the block).
template <int TM, bool POLICY, typename Emit>
__device__ __forceinline__ void tile_scores(
    const float* __restrict__ xr, const float* __restrict__ xc,
    float* s_xc, float* s_xr, const Rows<TM>& rows, int row0, int c0, bool first,
    int n_rows, int n_cols, int m, int row_offset, int col_offset,
    int kind, int stat, float inv_two_sigma_sq, const Policy& pol, Emit emit) {
    const int tid = threadIdx.x;
    const int kmax = min(m, MC);
    const int col = c0 + tid;
    const bool norms = needs_norms(kind, stat);
    const bool adaptive = POLICY && pol.scale_r != nullptr;
    const float sclc = adaptive && col < n_cols ? pol.scale_c[col] : 1.f;
    float acc[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) acc[r] = 0.f;
    float sqc = 0.f;

    for (int k0 = 0; k0 < m; k0 += MC) {
        const int kc = min(MC, m - k0);
        __syncthreads();  // the previous chunk has been consumed
        // the row slab changes only with the feature chunk
        if (m > MC || first) {
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
            if (norms) sqc = __fadd_rn(sqc, __fmul_rn(cv, cv));
#pragma unroll
            for (int r = 0; r < TM; ++r)
                acc[r] = fmaf(s_xr[r * kmax + k], cv, acc[r]);
        }
    }

    // one loop per score form, chosen once per tile: a per-entry choice
    // lets the compiler make both forms (the adaptive divide too) for
    // every entry
    const auto valid = [&](int r) {
        const int row = row0 + r;
        return row < n_rows && col < n_cols && row_offset + row != col_offset + col;
    };
    if (stat == NEG_SQDIST) {
#pragma unroll
        for (int r = 0; r < TM; ++r)
            emit(r, -nan_max(sq_dist(acc[r], rows.sqr[r], sqc), 0.f), valid(r));
    } else if (adaptive) {
#pragma unroll
        for (int r = 0; r < TM; ++r)
            emit(r, transform(kind, acc[r], rows.sqr[r], sqc, inv_two_sigma_sq, true,
                              rows.sclr[r], sclc), valid(r));
    } else {
#pragma unroll
        for (int r = 0; r < TM; ++r)
            emit(r, transform(kind, acc[r], rows.sqr[r], sqc, inv_two_sigma_sq, false,
                              1.f, 1.f), valid(r));
    }
}

// The masked affinity entries (0 where dropped) of the block's rows at this
// thread's column: emit(r, a) receives each one as soon as it is made, so
// the caller's store or fold interleaves with the transform.
template <int TM, bool POLICY, typename Emit>
__device__ __forceinline__ void masked_tile(
    const float* __restrict__ xr, const float* __restrict__ xc,
    float* s_xc, float* s_xr, const Rows<TM>& rows, int row0, int c0, bool first,
    int n_rows, int n_cols, int m, int row_offset, int col_offset,
    int kind, float inv_two_sigma_sq, const Policy& pol, Emit emit) {
    const int col = c0 + threadIdx.x;
    const float thr_c = POLICY && pol.thr_c != nullptr && col < n_cols ? pol.thr_c[col]
                                                                      : INFINITY;
    tile_scores<TM, POLICY>(xr, xc, s_xc, s_xr, rows, row0, c0, first, n_rows, n_cols, m,
                            row_offset, col_offset, kind, SIMILARITY, inv_two_sigma_sq, pol,
                            [&](int r, float a, bool valid) {
        bool keep = valid;
        if constexpr (POLICY) {
            if (pol.thr != nullptr) keep = keep && a >= rows.thr[r];
            if (pol.thr_c != nullptr) keep = keep && a >= thr_c;
        }
        emit(r, keep ? a : 0.f);
    });
}

// Whether a kernel needs the POLICY form for these operands.
inline bool has_policy(const Policy& pol) {
    return pol.scale_r != nullptr || pol.thr != nullptr || pol.thr_c != nullptr;
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
