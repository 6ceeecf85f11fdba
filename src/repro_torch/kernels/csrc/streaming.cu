// Streaming (A-free) power sweep and degree for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/streaming.py::affinity_matmat (the Pallas TPU
// kernel _streaming_kernel) and ::affinity_degree_streaming
// (_streaming_degree_kernel), with the graph-policy operands (adaptive
// scales scale_r / scale_c, the row threshold thr and, for the mat-mat,
// the column threshold thr_c that makes it the transpose product of the
// component probe; null pointers for the dense fixed spec). Neither stores
// A: each masked tile is rebuilt from the features (affinity_tile.cuh)
// and folded at once into
//     U = (A V) / max(d, 1e-30)     (d = nullptr: the unnormalized A V)
//     D = A 1.
// Both are stripe-general: rows x (R, m) against columns xc (C, m) at the
// global offsets that place the diagonal.
//
// With thr_c (and thr null) the tile keeps S_ij where S_ij >= thr_c[j],
// which is A^T's entry (i, j) = A_ji = S_ji kept where S_ji >= thr[j]:
// the scores are symmetric bit for bit (affinity_tile.cuh), so the
// column mask is the exact transpose pattern, and no A^T is stored.
//
// Bound on an H100: the operations. The inputs are O(n (m + r)) bytes, but
// every sweep rebuilds n^2 entries: 2m for the dot product, about 6 for the
// rbf transform (one expf), 2r for the product with V. At n = 45,000, m = 2,
// r = 1 that is 2.4e10 f32 operations, 0.36 ms at 67 TFLOP/s, against the
// 2.42 ms that reading a stored A would take. Each expf also takes one
// MUFU.EX2, of which an SM makes 16 a clock: n^2 / (132 x 16 x 1.98 GHz) =
// 0.48 ms, a second floor above the first. What the card issues is the
// limit in practice: about 17 instructions an entry at m = 2, r = 1 (the
// dot product 2, d2 3, the clamp 2, the scale 1, expf 8, the fold 1), at
// 128 lanes a clock per SM about 1.1 ms. A threshold adds a compare,
// adaptive scales a multiply, per entry; a truncated tile is rebuilt in
// full (skipping dead tiles is the block-sparse kernels' work).
//
// Design:
//  * The block shape of affinity.cu: TN = 256 threads own TM rows and walk
//    all column tiles in order, thread t owning column c0 + t.
//  * Two templates make the same entries. The staged one (any m) takes
//    them from tile::masked_tile, as the stored A does: per tile it stages
//    the column slab in shared memory between two barriers and tests every
//    entry's mask. The register one (m <= tile::MR, the paper's m = 2)
//    stages the block's rows once; each thread loads its own column's
//    features, V row and policy operands one tile ahead into registers, so
//    a tile costs no barrier and its loads overlap the previous tile's
//    arithmetic; only the warps on a ragged edge or on the global diagonal
//    test the mask (tile::fold_tile). The score form (kind, adaptive) is
//    fixed per compiled loop, not chosen per entry. Both call
//    tile::transform and tile::keep_entry and fold in the same order, so
//    they give the same bits: the card check holds x against x with zero
//    feature columns appended past tile::MR, which takes the staged one.
//  * The mat-mat folds each entry into TM x RT register partials with
//    fmaf(a, v[col][c], acc) and reduces them with the warp tree and then
//    the 8 warps in order, then the floored divide of power_step.cu. Thread
//    t thus adds columns t, t + 256, ... in order, exactly as power_step.cu
//    does over a stored row, so U is bitwise equal to the explicit engine's
//    U for the same x, V and d. The masked diagonal is multiplied in (a 0
//    times V), as power_step.cu multiplies A's 0 diagonal, so a NaN/Inf in
//    V still reaches the loop's health latches; columns past the edge are
//    skipped (power_step.cu never visits them) and V is never read there.
//  * TM follows RT so that the TM * RT partials stay near 64 registers;
//    no row's summation order depends on TM.
//  * The degree is affinity.cu's loop without the store: the same TM = 16,
//    the same per-thread row sums over the tiles, the same reduction, so
//    the streamed D is bitwise equal to affinity_and_degree's D. It has
//    the mat-mat's two templates; the register one adds each entry to its
//    row sum where the mat-mat folds it with V, and with row thresholds
//    skips the expf of a warp's tile whose entries are all provably below
//    them (tile::col_entries): on a kNN graph most tiles, so the MUFU
//    floor then counts only the entries near a threshold.

#include "affinity_tile.cuh"

namespace {

using tile::TN;
using tile::tm_for;

template <int RT, bool POLICY>
__global__ void __launch_bounds__(TN) streaming_matmat_kernel(
    const float* __restrict__ xr, const float* __restrict__ xc, tile::Policy pol,
    const float* __restrict__ v, const float* __restrict__ d, float* __restrict__ u,
    int n_rows, int n_cols, int m, int r, int row_offset, int col_offset,
    int kind, float inv_two_sigma_sq) {
    constexpr int TM = tm_for(RT);
    extern __shared__ float smem[];
    float* s_xc = smem;
    float* s_xr = smem + TN * (min(m, tile::MC) + 1);
    __shared__ tile::Rows<TM> s_rows;
    __shared__ float s_red[tile::NWARPS * TM * RT];

    const int row0 = blockIdx.x * TM;
    tile::load_rows<TM>(xr, n_rows, m, row0, kind == tile::RBF, pol, s_rows);

    float acc[TM * RT];
#pragma unroll
    for (int e = 0; e < TM * RT; ++e) acc[e] = 0.f;

    for (int c0 = 0; c0 < n_cols; c0 += TN) {
        const int col = c0 + threadIdx.x;
        const bool inside = col < n_cols;
        float vv[RT];
#pragma unroll
        for (int c = 0; c < RT; ++c)
            vv[c] = inside && c < r ? v[static_cast<size_t>(col) * r + c] : 0.f;
        tile::masked_tile<TM, POLICY>(xr, xc, s_xc, s_xr, s_rows, row0, c0, c0 == 0, n_rows,
                                      n_cols, m, row_offset, col_offset, kind, inv_two_sigma_sq,
                                      pol,
                                      [&](int i, float a) {
            if (inside) {
#pragma unroll
                for (int c = 0; c < RT; ++c)
                    if (c < r) acc[i * RT + c] = fmaf(a, vv[c], acc[i * RT + c]);
            }
        });
    }

    const float s = tile::block_reduce_fixed<TM * RT>(acc, s_red);
    const int i = threadIdx.x / RT, c = threadIdx.x - i * RT;
    const int row = row0 + i;
    if (threadIdx.x < TM * RT && c < r && row < n_rows)
        u[static_cast<size_t>(row) * r + c] =
            d == nullptr ? s : __fdiv_rn(s, nan_max(d[row], 1e-30f));
}

// The register template (m <= tile::MR): the rows staged once, each
// thread's column operands loaded one tile ahead, no barrier in the tile
// loop (affinity_tile.cuh); streaming_matmat_kernel above is the staged
// template (any m). The two give the same bits.
template <int RT, bool POLICY>
__global__ void __launch_bounds__(TN, tile::reg_blocks_per_sm(RT)) streaming_matmat_reg_kernel(
    const float* __restrict__ xr, const float* __restrict__ xc, tile::Policy pol,
    const float* __restrict__ v, const float* __restrict__ d, float* __restrict__ u,
    int n_rows, int n_cols, int m, int r, int row_offset, int col_offset,
    int kind, float inv_two_sigma_sq) {
    constexpr int TM = tm_for(RT);
    __shared__ __align__(16) tile::Rows<TM> s_rows;
    __shared__ tile::RowFeats<TM> s_rf;
    __shared__ float s_red[tile::NWARPS * TM * RT];

    const int row0 = blockIdx.x * TM;
    tile::load_rows<TM>(xr, n_rows, m, row0, kind == tile::RBF, pol, s_rows);
    tile::load_row_feats<TM>(xr, n_rows, m, row0, s_rf);
    __syncthreads();

    float acc[TM * RT];
#pragma unroll
    for (int e = 0; e < TM * RT; ++e) acc[e] = 0.f;

    tile::with_form<POLICY>(kind, pol, [&](auto form) {
        using Form = decltype(form);
        tile::Col<RT> cur, nxt;
        tile::load_col<RT, POLICY>(xc, v, pol, threadIdx.x, n_cols, m, r, cur);
        for (int c0 = 0; c0 < n_cols; c0 += TN) {
            tile::load_col<RT, POLICY>(xc, v, pol, c0 + TN + threadIdx.x, n_cols, m, r, nxt);
            tile::fold_tile<TM, RT, Form, POLICY>(
                cur, s_rf, s_rows, m, inv_two_sigma_sq, pol, row0, c0, n_rows, n_cols,
                row_offset, col_offset, acc);
            cur = nxt;
        }
    });

    const float s = tile::block_reduce_fixed<TM * RT>(acc, s_red);
    const int i = threadIdx.x / RT, c = threadIdx.x - i * RT;
    const int row = row0 + i;
    if (threadIdx.x < TM * RT && c < r && row < n_rows)
        u[static_cast<size_t>(row) * r + c] =
            d == nullptr ? s : __fdiv_rn(s, nan_max(d[row], 1e-30f));
}

constexpr int TM_DEG = 16;  // affinity.cu's TM

template <bool POLICY>
__global__ void __launch_bounds__(TN) streaming_degree_kernel(
    const float* __restrict__ xr, const float* __restrict__ xc, tile::Policy pol,
    float* __restrict__ d, int n_rows, int n_cols, int m, int row_offset, int col_offset,
    int kind, float inv_two_sigma_sq) {
    extern __shared__ float smem[];
    float* s_xc = smem;
    float* s_xr = smem + TN * (min(m, tile::MC) + 1);
    __shared__ tile::Rows<TM_DEG> s_rows;
    __shared__ float s_red[tile::NWARPS * TM_DEG];

    const int row0 = blockIdx.x * TM_DEG;
    tile::load_rows<TM_DEG>(xr, n_rows, m, row0, kind == tile::RBF, pol, s_rows);

    float rowsum[TM_DEG];
#pragma unroll
    for (int r = 0; r < TM_DEG; ++r) rowsum[r] = 0.f;

    for (int c0 = 0; c0 < n_cols; c0 += TN)
        tile::masked_tile<TM_DEG, POLICY>(xr, xc, s_xc, s_xr, s_rows, row0, c0, c0 == 0, n_rows,
                                          n_cols, m, row_offset, col_offset, kind,
                                          inv_two_sigma_sq, pol, [&](int r, float a) {
                                              tile::add_entry(rowsum[r], a);
                                          });

    const float s = tile::block_reduce_fixed<TM_DEG>(rowsum, s_red);
    if (threadIdx.x < TM_DEG && row0 + threadIdx.x < n_rows) d[row0 + threadIdx.x] = s;
}

// The degree's register template (m <= tile::MR): #5's register template
// with each entry added to its row sum, the staged loop's tile::add_entry,
// in place of the fold with V (no V is loaded); TM_DEG = tm_for(1) rows, so
// the same per-thread sums and the same reduction: the staged template's
// bits. Where the row thresholds exist, a warp's tile whose entries are
// all provably dropped takes no expf and adds nothing (tile::col_entries).
template <bool POLICY>
__global__ void __launch_bounds__(TN, tile::reg_blocks_per_sm(1)) streaming_degree_reg_kernel(
    const float* __restrict__ xr, const float* __restrict__ xc, tile::Policy pol,
    float* __restrict__ d, int n_rows, int n_cols, int m, int row_offset, int col_offset,
    int kind, float inv_two_sigma_sq) {
    static_assert(tm_for(1) == TM_DEG, "the degree's rows are the r = 1 sweep's");
    __shared__ __align__(16) tile::Rows<TM_DEG> s_rows;
    __shared__ tile::RowFeats<TM_DEG> s_rf;
    __shared__ __align__(16) float s_bound[TM_DEG];
    __shared__ float s_red[tile::NWARPS * TM_DEG];

    const int row0 = blockIdx.x * TM_DEG;
    tile::load_rows<TM_DEG>(xr, n_rows, m, row0, kind == tile::RBF, pol, s_rows);
    tile::load_row_feats<TM_DEG>(xr, n_rows, m, row0, s_rf);
    tile::load_skip_bounds<TM_DEG>(pol, s_rows, inv_two_sigma_sq, s_bound);
    __syncthreads();

    float rowsum[TM_DEG];
#pragma unroll
    for (int r = 0; r < TM_DEG; ++r) rowsum[r] = 0.f;

    tile::with_form<POLICY>(kind, pol, [&](auto form) {
        using Form = decltype(form);
        tile::Col<1> cur, nxt;  // r = 0: the features and scale alone
        tile::load_col<1, POLICY>(xc, nullptr, pol, threadIdx.x, n_cols, m, 0, cur);
        for (int c0 = 0; c0 < n_cols; c0 += TN) {
            tile::load_col<1, POLICY>(xc, nullptr, pol, c0 + TN + threadIdx.x, n_cols, m, 0,
                                      nxt);
            tile::tile_entries<TM_DEG, Form, POLICY>(
                cur, s_rf, s_rows, s_bound, m, inv_two_sigma_sq, pol, row0, c0, n_rows, n_cols,
                row_offset, col_offset, [&](int i, float a) { tile::add_entry(rowsum[i], a); });
            cur = nxt;
        }
    });

    const float s = tile::block_reduce_fixed<TM_DEG>(rowsum, s_red);
    if (threadIdx.x < TM_DEG && row0 + threadIdx.x < n_rows) d[row0 + threadIdx.x] = s;
}

template <int RT>
void launch_matmat(const float* xr, const float* xc, const tile::Policy& pol,
                   const float* v, const float* d, float* u, int n_rows, int n_cols,
                   int m, int r, int row_offset, int col_offset, int kind,
                   float inv_two_sigma_sq, cudaStream_t stream) {
    constexpr int TM = tm_for(RT);
    const int grid = (n_rows + TM - 1) / TM;
    const bool policy = tile::has_policy(pol);
#define GPIC_ARGS xr, xc, pol, v, d, u, n_rows, n_cols, m, r, row_offset, col_offset, kind, \
                  inv_two_sigma_sq
    if (m > tile::MR) {
        const size_t smem = tile::smem_bytes(TM, m);
        if (policy) streaming_matmat_kernel<RT, true><<<grid, TN, smem, stream>>>(GPIC_ARGS);
        else streaming_matmat_kernel<RT, false><<<grid, TN, smem, stream>>>(GPIC_ARGS);
    } else {
        if (policy) streaming_matmat_reg_kernel<RT, true><<<grid, TN, 0, stream>>>(GPIC_ARGS);
        else streaming_matmat_reg_kernel<RT, false><<<grid, TN, 0, stream>>>(GPIC_ARGS);
    }
#undef GPIC_ARGS
}

}  // namespace

// d may be null: U is then the unnormalized A V. scale_r / scale_c / thr /
// thr_c may be null (policy off).
extern "C" int gpic_streaming_matmat(
    const float* xr, const float* xc, const float* scale_r, const float* scale_c,
    const float* thr, const float* thr_c, const float* v, const float* d, float* u,
    int n_rows, int n_cols, int m, int r, int row_offset, int col_offset,
    int kind, float inv_two_sigma_sq, cudaStream_t stream) {
    const tile::Policy pol{scale_r, scale_c, thr, thr_c};
#define GPIC_LAUNCH(RT) launch_matmat<RT>(xr, xc, pol, v, d, u, n_rows, n_cols, m, r, \
                                          row_offset, col_offset, kind, inv_two_sigma_sq, \
                                          stream)
    if (r < 1) return static_cast<int>(cudaErrorInvalidValue);
    else if (r <= 1) GPIC_LAUNCH(1);
    else if (r <= 2) GPIC_LAUNCH(2);
    else if (r <= 4) GPIC_LAUNCH(4);
    else if (r <= 8) GPIC_LAUNCH(8);
    else if (r <= 16) GPIC_LAUNCH(16);
    else if (r <= 32) GPIC_LAUNCH(32);
    else return static_cast<int>(cudaErrorInvalidValue);
#undef GPIC_LAUNCH
    return static_cast<int>(cudaGetLastError());
}

// scale_r / scale_c / thr may be null (policy off).
extern "C" int gpic_streaming_degree(
    const float* xr, const float* xc, const float* scale_r, const float* scale_c,
    const float* thr, float* d,
    int n_rows, int n_cols, int m, int row_offset, int col_offset,
    int kind, float inv_two_sigma_sq, cudaStream_t stream) {
    const int grid = (n_rows + TM_DEG - 1) / TM_DEG;
    const tile::Policy pol{scale_r, scale_c, thr, nullptr};
    const bool policy = tile::has_policy(pol);
#define GPIC_ARGS xr, xc, pol, d, n_rows, n_cols, m, row_offset, col_offset, kind, inv_two_sigma_sq
    if (m > tile::MR) {
        const size_t smem = tile::smem_bytes(TM_DEG, m);
        if (policy) streaming_degree_kernel<true><<<grid, TN, smem, stream>>>(GPIC_ARGS);
        else streaming_degree_kernel<false><<<grid, TN, smem, stream>>>(GPIC_ARGS);
    } else {
        if (policy) streaming_degree_reg_kernel<true><<<grid, TN, 0, stream>>>(GPIC_ARGS);
        else streaming_degree_reg_kernel<false><<<grid, TN, 0, stream>>>(GPIC_ARGS);
    }
#undef GPIC_ARGS
    return static_cast<int>(cudaGetLastError());
}
