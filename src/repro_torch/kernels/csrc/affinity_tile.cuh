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
// of at most MC features, so any m works. Every kernel of the family also
// has a register template for m <= MR (below): no staging and no barrier
// per tile, the same entries in the same order, the same bits. row_topk.cu's
// register template makes its scores from the same pieces (Col,
// load_col, clean_span, transform), each warp owning rows of its own.
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

// Add entry a to a row sum as a step of its own. A plain `sum += a` lets
// nvcc contract the last multiply that makes the entry (expf's scaling by
// 2^k, which rounds only where the entry is subnormal) into an FMA with the
// sum, where the kernel does not also store the entry; the degrees then
// part from the stored build's D on rows of subnormal entries alone. Every
// row sum of the family adds through this, so each one adds the entry as
// stored, the order and rounding of the plain version's sum.
__device__ __forceinline__ void add_entry(float& sum, float a) { sum = __fadd_rn(sum, a); }

__device__ __forceinline__ float sq_dist(float dot, float sqr, float sqc) {
    return __fsub_rn(__fadd_rn(sqr, sqc), __fmul_rn(2.0f, dot));
}

// The argument of the rbf transform's expf, from d2 = sq_dist(...).
__device__ __forceinline__ float rbf_exponent(float d2, float inv_two_sigma_sq, bool adaptive,
                                              float sclr, float sclc) {
    const float neg_d2 = -nan_max(d2, 0.f);
    if (adaptive) return __fdiv_rn(neg_d2, __fmul_rn(sclr, sclc));
    return __fmul_rn(neg_d2, inv_two_sigma_sq);
}

__device__ __forceinline__ float transform(int kind, float dot, float sqr, float sqc,
                                           float inv_two_sigma_sq, bool adaptive,
                                           float sclr, float sclc) {
    if (kind == COSINE) return dot;
    if (kind == COSINE_SHIFTED) return __fmul_rn(0.5f, __fadd_rn(1.0f, dot));
    return expf(rbf_exponent(sq_dist(dot, sqr, sqc), inv_two_sigma_sq, adaptive, sclr, sclc));
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

// Which thresholds a policy gives, where a loop knows it at compile time:
// the row thresholds only, the column thresholds only, THR_ANY (tested at
// run time: both, or neither), or THR_NONE (neither; with_form never gives
// it, affinity.cu takes it for adaptive scales alone).
enum Thr { THR_ANY = 0, THR_ROW = 1, THR_COL = 2, THR_NONE = 3 };

// The stored entry of score a: a where it is kept (valid, and at or above
// the row's and the column's thresholds where the policy gives them), else
// 0. transform() and this are the per-entry function of every loop below,
// the staged one and the register ones alike. Each threshold is read only
// where the policy has it; THR says which it has, or THR_ANY to test.
template <bool POLICY, int THR = THR_ANY>
__device__ __forceinline__ float keep_entry(float a, bool valid, const Policy& pol,
                                            const float& thr_r, const float& thr_c) {
    bool keep = valid;
    if constexpr (POLICY) {
        if (THR == THR_ROW || (THR == THR_ANY && pol.thr != nullptr)) keep = keep && a >= thr_r;
        if (THR == THR_COL || (THR == THR_ANY && pol.thr_c != nullptr)) keep = keep && a >= thr_c;
    }
    return keep ? a : 0.f;
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
        emit(r, keep_entry<POLICY>(a, valid, pol, rows.thr[r], thr_c));
    });
}

// Whether a kernel needs the POLICY form for these operands.
inline bool has_policy(const Policy& pol) {
    return pol.scale_r != nullptr || pol.thr != nullptr || pol.thr_c != nullptr;
}

// ---------------------------------------------------------------------------
// The register templates of the streamed sweeps (streaming.cu's and
// block_sparse.cu's mat-mat) for m <= MR features: no slab in shared memory
// and no barrier per tile.
//
// The block stages its TM rows once (their features in RowFeats, their
// norms, scales and thresholds in Rows). Each thread then reads its own
// column's features, V row, scale and threshold straight from global
// memory into a Col, one tile ahead of the tile it folds, so the loads
// of the next tile overlap this tile's arithmetic. A warp whose 32 columns
// and the block's TM rows all lie inside the stripe, off the global
// diagonal, folds without the validity test; only the ragged tiles and the
// warps the diagonal crosses take the masked form. Both forms make every
// entry with transform() and keep_entry() from the same operands in the
// same order as the staged loop (the dot product's fmaf chain over the
// features in order, from 0; the column norm the same __fadd_rn /
// __fmul_rn chain), and fold it at once with fmaf(a, v, acc): the register
// templates give the staged template's bits.

constexpr int MR = 2;  // widest feature count of the register templates (the paper's m)

// Blocks an SM each register template is compiled for: two (128 registers
// a thread) where its partials, rows and double-buffered column operands
// fit in them without a spill (ptxas -v: r <= 2, and r = 8, 16, where TM x
// RT = 64), else one (r = 3, 4: TM = 16 rows of 4 partials; r > 16: 2 x 32
// V values in flight).
__host__ __device__ constexpr int reg_blocks_per_sm(int rt) {
    return rt == 4 || rt >= 32 ? 1 : 2;
}

// The block's row features, feature-major: feature k of row row0 + i at
// x[k][i], 0 past m or past the stripe's rows.
template <int TM>
struct __align__(16) RowFeats {
    float x[MR][TM];
};

// Load the block's row features into rf. The caller synchronizes before
// the first tile reads them.
template <int TM>
__device__ __forceinline__ void load_row_feats(const float* __restrict__ xr, int n_rows, int m,
                                               int row0, RowFeats<TM>& rf) {
    for (int e = threadIdx.x; e < MR * TM; e += TN) {
        const int k = e / TM, i = e - k * TM;
        const int row = row0 + i;
        rf.x[k][i] = k < m && row < n_rows ? xr[static_cast<size_t>(row) * m + k] : 0.f;
    }
}

// One thread's operands of one column; 0, 1 or +inf past the stripe.
template <int RT>
struct Col {
    float x[MR];  // features (0 past m)
    float v[RT];  // the column's row of V (0 past r)
    float scl;    // adaptive scale_c (1 without)
    float thr;    // column threshold thr_c (+inf without)
};

template <int RT, bool POLICY>
__device__ __forceinline__ void load_col(const float* __restrict__ xc,
                                         const float* __restrict__ v, const Policy& pol,
                                         int col, int n_cols, int m, int r, Col<RT>& c) {
    const bool inside = col < n_cols;
#pragma unroll
    for (int k = 0; k < MR; ++k)
        c.x[k] = inside && k < m ? xc[static_cast<size_t>(col) * m + k] : 0.f;
#pragma unroll
    for (int j = 0; j < RT; ++j)
        c.v[j] = inside && j < r ? v[static_cast<size_t>(col) * r + j] : 0.f;
    c.scl = POLICY && pol.scale_r != nullptr && inside ? pol.scale_c[col] : 1.f;
    c.thr = POLICY && pol.thr_c != nullptr && inside ? pol.thr_c[col] : INFINITY;
}

// Whether the TM rows from row0 and the 32 columns from w0 all lie inside
// the stripe with no (i, j) of them on the global diagonal
// row_offset + row0 + i == col_offset + w0 + j, i.e. the offset gap delta
// outside (-TM, 32): a warp that owns those entries can make them without
// the mask.
template <int TM>
__device__ __forceinline__ bool clean_span(int row0, int w0, int n_rows, int n_cols,
                                           int row_offset, int col_offset) {
    const int delta = (row_offset + row0) - (col_offset + w0);
    return row0 + TM <= n_rows && w0 + 32 <= n_cols && (delta >= 32 || delta <= -TM);
}

// Whether this thread's warp folds the tile at c0 without the mask (its 32
// columns of the tile and the block's TM rows: clean_span). The same for
// every lane of the warp.
template <int TM>
__device__ __forceinline__ bool clean_warp(int row0, int c0, int n_rows, int n_cols,
                                           int row_offset, int col_offset) {
    return clean_span<TM>(row0, c0 + (threadIdx.x & ~31), n_rows, n_cols, row_offset,
                          col_offset);
}

// Policy row operands of the register templates (thresholds, adaptive
// scales): G = min(TM, 4) rows at a time, read from shared memory where the
// entries use them by a vector load in asm, which the compiler neither
// hoists out of the tile loop nor keeps in registers across it. The rows'
// features and norms stay in registers; these would push the policy forms
// past the 128 registers of two blocks an SM. p is 4 G-byte aligned (the
// caller's Rows is 16-byte aligned).
template <int G>
__device__ __forceinline__ void lds_group(const float* p, float (&out)[G]) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    if constexpr (G == 4)
        asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                     : "=f"(out[0]), "=f"(out[1]), "=f"(out[2]), "=f"(out[3]) : "r"(a));
    else
        asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(out[0]), "=f"(out[1]) : "r"(a));
}

// A score form fixed at compile time: the kind, whether the scales are
// adaptive, and which thresholds the policy gives (Thr).
template <int KIND_, bool ADAPTIVE_, int THR_>
struct Form {
    static constexpr int KIND = KIND_;
    static constexpr bool ADAPTIVE = ADAPTIVE_;
    static constexpr int THR = THR_;
};

// Fold this thread's column col (operands c) into the TM x RT partials:
// the column's TM entries, each folded at once into acc[i * RT + j] with
// fmaf(a, v[j], acc), the staged template's fold. The score form F is
// fixed, so no entry chooses it. MASKED applies the stripe's edges and
// the global diagonal: a column past the edge folds nothing (the staged
// template skips it too), a masked entry folds a 0.
template <int TM, int RT, typename F, bool POLICY, bool MASKED>
__device__ __forceinline__ void fold_col(const Col<RT>& c, const RowFeats<TM>& rf,
                                         const Rows<TM>& rows, int m, float inv_two_sigma_sq,
                                         const Policy& pol, int row0, int col, int n_rows,
                                         int n_cols, int row_offset, int col_offset,
                                         float (&acc)[TM * RT]) {
    constexpr int KIND = F::KIND;
    constexpr bool ADAPTIVE = F::ADAPTIVE;
    constexpr bool ROW_THR = F::THR == THR_ROW;
    if (MASKED && col >= n_cols) return;
    float dot[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) dot[i] = 0.f;
    float sqc = 0.f;
#pragma unroll
    for (int k = 0; k < MR; ++k) {
        if (k < m) {
            if (KIND == RBF) sqc = __fadd_rn(sqc, __fmul_rn(c.x[k], c.x[k]));
#pragma unroll
            for (int i = 0; i < TM; ++i) dot[i] = fmaf(rf.x[k][i], c.x[k], dot[i]);
        }
    }
    constexpr int G = TM < 4 ? TM : 4;
    float thr[G], scl[G];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        if (i % G == 0) {
            if (POLICY && (ROW_THR || (F::THR == THR_ANY && pol.thr != nullptr)))
                lds_group<G>(rows.thr + i, thr);
            if (ADAPTIVE) lds_group<G>(rows.sclr + i, scl);
        }
        const float s = transform(KIND, dot[i], rows.sqr[i], sqc, inv_two_sigma_sq, ADAPTIVE,
                                  ADAPTIVE ? scl[i % G] : 1.f, ADAPTIVE ? c.scl : 1.f);
        const bool valid = !MASKED || (row0 + i < n_rows
                                       && row_offset + row0 + i != col_offset + col);
        const float a = keep_entry<POLICY, F::THR>(s, valid, pol, thr[i % G], c.thr);
#pragma unroll
        for (int j = 0; j < RT; ++j) acc[i * RT + j] = fmaf(a, c.v[j], acc[i * RT + j]);
    }
}

// Fold one tile of column c0 (operands c) with the warp's form of fold_col.
template <int TM, int RT, typename F, bool POLICY>
__device__ __forceinline__ void fold_tile(const Col<RT>& c, const RowFeats<TM>& rf,
                                          const Rows<TM>& rows, int m, float inv_two_sigma_sq,
                                          const Policy& pol, int row0, int c0, int n_rows,
                                          int n_cols, int row_offset, int col_offset,
                                          float (&acc)[TM * RT]) {
    const int col = c0 + threadIdx.x;
    if (clean_warp<TM>(row0, c0, n_rows, n_cols, row_offset, col_offset))
        fold_col<TM, RT, F, POLICY, false>(
            c, rf, rows, m, inv_two_sigma_sq, pol, row0, col, n_rows, n_cols, row_offset,
            col_offset, acc);
    else
        fold_col<TM, RT, F, POLICY, true>(
            c, rf, rows, m, inv_two_sigma_sq, pol, row0, col, n_rows, n_cols, row_offset,
            col_offset, acc);
}

template <int KIND, bool ADAPTIVE, typename F>
__device__ __forceinline__ void with_thr(const Policy& pol, F& f) {
    if (pol.thr != nullptr && pol.thr_c == nullptr) f(Form<KIND, ADAPTIVE, THR_ROW>{});
    else if (pol.thr == nullptr && pol.thr_c != nullptr) f(Form<KIND, ADAPTIVE, THR_COL>{});
    else f(Form<KIND, ADAPTIVE, THR_ANY>{});
}

// Call f(Form<...>{}) with the operands' score form, so that a register
// template's tile loop is compiled once per form and chooses none per
// entry. Adaptive scales exist only for rbf and only in the POLICY form.
// The thresholds are told apart for fixed-bandwidth rbf, the default kNN
// route's form (the sweep's row thresholds, the probe's column
// thresholds); with adaptive scales, whose divide dominates an entry,
// more forms measured slower on the card (registers, fewer blocks an SM).
template <bool POLICY, typename F>
__device__ __forceinline__ void with_form(int kind, const Policy& pol, F&& f) {
    if (kind == RBF) {
        if constexpr (POLICY) {
            if (pol.scale_r != nullptr) f(Form<RBF, true, THR_ANY>{});
            else with_thr<RBF, false>(pol, f);
        } else {
            f(Form<RBF, false, THR_ANY>{});
        }
    } else if (kind == COSINE_SHIFTED) {
        f(Form<COSINE_SHIFTED, false, THR_ANY>{});
    } else {
        f(Form<COSINE, false, THR_ANY>{});
    }
}

// ---------------------------------------------------------------------------
// The register templates of the stored build (affinity.cu), the streamed
// degrees (streaming.cu, block_sparse.cu) and the liveness pass
// (block_sparse.cu): the entries alone, no V.
//
// All use the sweeps' pieces above (RowFeats, Col loaded a tile ahead,
// clean_span, with_form) and hand each entry, made with transform()'s
// arithmetic and keep_entry(), to the caller's emit(i, a): the build stores
// it and adds it to its row sum, the degrees add it to their row sums (the
// staged loop's add_entry), the liveness pass ORs a != 0.
//
// All skip the exponent where an entry is provably dropped. With the row
// thresholds (rbf, POLICY form) an entry is kept only if expf(x) >= thr_i,
// x its exponent. exp_cutoff(thr_i) gives a c_i with x < c_i =>
// expf(x) < thr_i, and skip_bound turns c_i into a bound on the squared
// distance, d2 > b_i (adaptive: d2 > b_i scale_c[j]) => x < c_i, so the
// test needs neither the clamp, the scale, the divide nor the expf. A warp
// whose 32 columns the test drops for all TM rows emits nothing for the
// tile (every entry is 0); any other warp votes again row by row and makes
// exactly the entries of each row that the test keeps somewhere in the
// warp. The degree then adds nothing where it would add +0, which leaves a
// row sum that is never -0 as it was, so D keeps the staged template's
// bits; the live map is the same map. The stored build must still write
// the dropped entries: with ZEROS, col_entries hands it each of them as
// emit(i, 0.f), the staged loop's +0, without making it.

// A c with x < c => expf(x) < thr for every float x. expf is within 2 ulp
// and logf within 1 ulp (no fast math): in the exponent, with the rounding
// of c, under 2^-22 (|logf(thr)| + 1) together, and the margin is 64 times
// that, 2^-16 (|logf(thr)| + 1). A thr that is not a normal positive float
// (<= 0, subnormal, NaN: no row threshold) gives -inf, which skips nothing;
// thr = +inf (a padding row) gives +inf, which skips every entry of the
// row, none of which is kept.
__device__ __forceinline__ float exp_cutoff(float thr) {
    if (!(thr >= 0x1p-126f)) return -INFINITY;
    if (thr == INFINITY) return INFINITY;
    const float l = logf(thr);
    return l - (fabsf(l) + 1.f) * 0x1p-16f;
}

// Scales inside [2^-50, 2^50] keep every product of the adaptive test a
// normal float, so each rounding is relative (2^-24).
__device__ __forceinline__ bool scale_in_range(float s) {
    return s >= 0x1p-50f && s <= 0x1p50f;
}

// The row's bound b of the skip test on the squared distance d2 (a float
// never compares above +inf: +inf skips nothing, -inf every entry but a
// NaN). With c = exp_cutoff(thr) in [-88.8, -2^-16]:
//  * fixed bandwidth, x = RN(-d2 inv): b = RN(RN(-c / inv) (1 + 2^-18)),
//    at least (-c / inv) (1 + 2^-20), so d2 > b gives -d2 inv <
//    c (1 + 2^-20) and x <= RN(c (1 + 2^-20)) < c;
//  * adaptive, x = RN(-d2 / RN(s_i s_j)): b = RN(RN(-c (1 + 2^-18)) s_i),
//    tested as d2 > RN(b s_j): then d2 / RN(s_i s_j) > -c (1 + 2^-19) and
//    x < c, with s_i and s_j in range (an out-of-range column makes its
//    entries exactly: col_entries).
// Anything outside those ranges (c > -2^-16, i.e. thr > 1, which no rbf
// entry reaches; inv not positive and finite; an out-of-range s_i; a b
// that is not a normal float) skips nothing.
__device__ __forceinline__ float skip_bound(float thr, bool adaptive, float inv_two_sigma_sq,
                                            float sclr) {
    const float c = exp_cutoff(thr);
    if (c == INFINITY) return -INFINITY;
    if (!(c <= -0x1p-16f) || c == -INFINITY) return INFINITY;
    if (adaptive)
        return scale_in_range(sclr) ? __fmul_rn(__fmul_rn(-c, 1.f + 0x1p-18f), sclr) : INFINITY;
    if (!(inv_two_sigma_sq > 0.f && inv_two_sigma_sq < INFINITY)) return INFINITY;
    const float b = __fmul_rn(__fdiv_rn(-c, inv_two_sigma_sq), 1.f + 0x1p-18f);
    return b >= 0x1p-126f ? b : INFINITY;
}

// Each row's skip bound into bound (16-byte aligned, TM floats), from the
// rows' thresholds and scales, which the same thread wrote in load_rows;
// +inf where the policy gives no row thresholds. The caller synchronizes
// before the first tile reads them.
template <int TM>
__device__ __forceinline__ void load_skip_bounds(const Policy& pol, const Rows<TM>& rows,
                                                 float inv_two_sigma_sq, float* bound) {
    const int i = threadIdx.x;
    if (i < TM)
        bound[i] = pol.thr != nullptr ? skip_bound(rows.thr[i], pol.scale_r != nullptr,
                                                   inv_two_sigma_sq, rows.sclr[i])
                                      : INFINITY;
}

// The TM entries of this thread's column col (operands c), each handed to
// emit(i, a) in row order. MASKED as in fold_col: a column past the edge
// emits nothing, a masked entry a 0. Every lane of the warp calls it with
// the same MASKED (the skip is a warp vote). An entry the skip test drops
// is emitted as 0 with ZEROS, and not at all without.
template <int TM, typename F, bool POLICY, bool MASKED, bool ZEROS, typename Emit>
__device__ __forceinline__ void col_entries(const Col<1>& c, const RowFeats<TM>& rf,
                                            const Rows<TM>& rows, const float* bound, int m,
                                            float inv_two_sigma_sq, const Policy& pol, int row0,
                                            int col, int n_rows, int n_cols, int row_offset,
                                            int col_offset, Emit emit) {
    constexpr int KIND = F::KIND;
    constexpr bool ADAPTIVE = F::ADAPTIVE;
    constexpr bool SKIP = POLICY && KIND == RBF && (F::THR == THR_ROW || F::THR == THR_ANY);
    const bool inside = !MASKED || col < n_cols;
    float s[TM];  // the dot products, then (rbf) the squared distances
#pragma unroll
    for (int i = 0; i < TM; ++i) s[i] = 0.f;
    float sqc = 0.f;
#pragma unroll
    for (int k = 0; k < MR; ++k) {
        if (k < m) {
            if (KIND == RBF) sqc = __fadd_rn(sqc, __fmul_rn(c.x[k], c.x[k]));
#pragma unroll
            for (int i = 0; i < TM; ++i) s[i] = fmaf(rf.x[k][i], c.x[k], s[i]);
        }
    }
    if (KIND == RBF) {
#pragma unroll
        for (int i = 0; i < TM; ++i) s[i] = sq_dist(s[i], rows.sqr[i], sqc);
    }
    constexpr int G = TM < 4 ? TM : 4;
    float g[G], h[G], b[G];
    // the test of entry i: false where it drops the entry (never a NaN d2's)
    const auto may_keep = [&](int i) {
        return !(s[i] > (ADAPTIVE ? __fmul_rn(b[i % G], c.scl) : b[i % G]));
    };
    // a column whose entries are all made exactly (a scale out of range)
    const bool col_exact = ADAPTIVE && !scale_in_range(c.scl);
    if constexpr (SKIP) {
        bool need = col_exact;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            if (i % G == 0) lds_group<G>(bound + i, b);
            need |= may_keep(i);
        }
        if (!__any_sync(0xffffffffu, inside && need)) {
            if (ZEROS && inside) {
#pragma unroll
                for (int i = 0; i < TM; ++i) emit(i, 0.f);
            }
            return;
        }
    }
    // then each row by a vote of its own (every lane reaches each vote): a
    // row none of whose 32 entries the test keeps emits nothing (ZEROS: 0s)
    const bool row_thr = POLICY && (F::THR == THR_ROW || (F::THR == THR_ANY && pol.thr != nullptr));
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        if (i % G == 0) {
            if (SKIP) lds_group<G>(bound + i, b);
            if (row_thr) lds_group<G>(rows.thr + i, g);
            if (ADAPTIVE) lds_group<G>(rows.sclr + i, h);
        }
        if (SKIP && !__any_sync(0xffffffffu, inside && (col_exact || may_keep(i)))) {
            if (ZEROS && inside) emit(i, 0.f);
            continue;
        }
        if (!inside) continue;
        const float a = KIND == RBF
            ? expf(rbf_exponent(s[i], inv_two_sigma_sq, ADAPTIVE, ADAPTIVE ? h[i % G] : 1.f,
                                ADAPTIVE ? c.scl : 1.f))
            : transform(KIND, s[i], 0.f, 0.f, 0.f, false, 1.f, 1.f);
        const bool valid = !MASKED || (row0 + i < n_rows
                                       && row_offset + row0 + i != col_offset + col);
        emit(i, keep_entry<POLICY, F::THR>(a, valid, pol, g[i % G], c.thr));
    }
}

// The entries of one tile of column c0 (operands c) with the warp's form
// of col_entries.
template <int TM, typename F, bool POLICY, bool ZEROS = false, typename Emit>
__device__ __forceinline__ void tile_entries(const Col<1>& c, const RowFeats<TM>& rf,
                                             const Rows<TM>& rows, const float* bound, int m,
                                             float inv_two_sigma_sq, const Policy& pol, int row0,
                                             int c0, int n_rows, int n_cols, int row_offset,
                                             int col_offset, Emit emit) {
    const int col = c0 + threadIdx.x;
    if (clean_warp<TM>(row0, c0, n_rows, n_cols, row_offset, col_offset))
        col_entries<TM, F, POLICY, false, ZEROS>(c, rf, rows, bound, m, inv_two_sigma_sq, pol,
                                                 row0, col, n_rows, n_cols, row_offset,
                                                 col_offset, emit);
    else
        col_entries<TM, F, POLICY, true, ZEROS>(c, rf, rows, bound, m, inv_two_sigma_sq, pol,
                                                row0, col, n_rows, n_cols, row_offset,
                                                col_offset, emit);
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
