// Block-CSR sweeps over the live tiles of a truncated affinity graph, and
// the A-free liveness pass that plans them, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/block_sparse.py, its four Pallas TPU kernels:
//   block_liveness                 (_liveness_kernel)
//   block_sparse_matmat            (_bs_matmat_kernel)
//   block_sparse_streaming_matmat  (_bs_streaming_kernel)
//   block_sparse_streaming_degree  (_bs_degree_kernel)
// A kNN-truncated A keeps ~knn_k entries a row. On cluster-sorted rows
// whole tiles of it are zero, and these kernels visit only the tiles that
// are not: the stored sweep reads only the live tiles of A, the streamed
// sweep and degree rebuild only the live tiles from the features.
//
// The plan (core/affinity.py::block_plan) is the port's own grid, not the
// reference's: row blocks of PLAN_TM = 16 rows, column tiles of TN = 256
// columns (affinity_tile.cuh), on the device as int32:
//   counts  (nI,)     live tiles of row block i
//   col_idx (nI, nJ)  their ids in ascending order first (then the dead ids)
// Every kernel's row block divides PLAN_TM (bs_rows(RT) in {16, 8, 4, 2, 1}
// rows for the stored sweep's ring, 2 or 1 for its plain-load template,
// tm_for(RT) in {16, 8, 4, 2} for the streamed one, 16 for the degree and
// the liveness pass), reads plan row row0 / PLAN_TM and loops its
// counts itself: a sweep needs neither max_b nor a host sync. An id at or
// past nJ, or a count past nJ, is ignored (a plan from outside cannot read
// out of bounds).
//
// Bitwise: each kernel is its dense twin with the column loop replaced by
// the walk over the live tiles in ascending order. A dead tile holds only
// zeros, and fmaf(0, v, acc) == acc for a finite v, so skipping it leaves
// every partial as it was: U and D are bit for bit those of
// power_step.cu and streaming.cu (up to the sign of an exact zero result,
// which a skipped -0 partial could flip). A NaN or Inf of V in a dead tile
// is not multiplied in, so, unlike the dense kernels, it reaches only the
// rows whose live tiles hold its column.
//
// Bound on an H100: the stored sweep, the live tiles' bytes of A (at
// n = 45,000 a quarter of the 8.1 GB on cluster-sorted blobs, about 0.6 ms
// at 3.35 TB/s; half that in bf16, where V's column of each live tile, read
// once a row, would be four times A's bytes, so a block shares it between
// rows); the streamed sweep and degree, the live tiles' operations
// (streaming.cu's count scaled by the live fraction, and its MUFU and
// issue floors likewise; the degree's register template with row
// thresholds makes only the live entries near a threshold with their
// expf, so its operations are every live entry's dot product, d2 and skip
// test, its MUFU floor that share); the liveness pass, every tile's
// operations, like the streamed degree, since it must score them all to
// find the live ones.
//
// Design:
//  * The stored sweep takes ROWS rows of one plan row block a block (ROWS
//    x RT partials a thread), which share the plan row's ids: thread t
//    loads V's row id * 256 + t once a live tile and applies it to the
//    column's entry in each of the ROWS rows, so V's traffic falls by ROWS.
//    A bf16 A whose rows start on 16 bytes streams the live tiles of
//    bs_rows(RT) rows (16 at r <= 2) through a ring of STAGES shared-memory
//    stages, each one tile's 256 columns of the block's rows, filled by
//    16-byte cp.async with STAGES - 1 tiles in flight (16 KB a block) and
//    one barrier a tile, walking the plan two ids ahead, as the streamed
//    kernels do, with V's row of the next tile in flight while this one
//    folds. An f32 A, and rows off 16 bytes, take the plain-load template:
//    plain_rows(RT) rows a block (2 at r <= 4) and plain_unroll(RT) live
//    tiles at a time, their entries and V's rows all in flight before the
//    first folds. On an H100 at E1 the ring runs bf16 at 0.6 of the
//    plain-load template's time and f32 a little slower than it, so f32
//    takes the plain-load template.
//    Thread t adds columns id * 256 + t in ascending tile order with
//    fmaf, each row is reduced by the fixed warp tree and warp order of
//    tile::block_reduce_fixed, and the epilogue is the same floored
//    __fdiv_rn: U is power_step.cu's bits, whatever the template and ROWS.
//    A bf16 A (O4) takes the same kernel on its element type, each entry
//    widened to f32 as it is read: U is bit for bit this kernel's on the
//    f32 upcast, and power_step.cu's on the same bf16 A.
//  * The streamed sweep and degree are streaming.cu's kernels with the
//    first visited tile staging the row slab (tile_scores' first flag).
//    Each has streaming.cu's two templates: the staged one (any m) and the
//    register one (m <= tile::MR: rows staged once, column operands in
//    registers, the mask only on ragged and diagonal warps, no barrier a
//    tile). The register ones walk the plan two ids ahead, so that the load
//    of ids[b + 2] and of tile b + 1's column operands are in flight while
//    tile b is made: no live tile waits on the chain id -> column -> V. The
//    degree's register template, like streaming.cu's, skips the clamp,
//    scale, divide and expf of the entries of a live tile that lie provably
//    below their row's threshold (tile::col_entries) and adds nothing for
//    them, where the staged loop adds +0: the same D.
//  * The liveness pass is affinity.cu's block over every column tile with
//    the store replaced by a block-wide OR (__syncthreads_or) of
//    "entry != 0": a tile is live iff the build would store a nonzero (or
//    NaN) entry in it; padding rows and columns emit 0 and never count.
//    Its register template (m <= tile::MR) makes the entries as the
//    streamed degree's does (no expf where a warp's entries are provably
//    below their thresholds), ORs them per warp with a vote and writes
//    only the 1s into the zeroed map: no barrier a tile.

#include "affinity_tile.cuh"

namespace {

using tile::TN;
using tile::tm_for;
constexpr int PLAN_TM = 16;  // rows of a plan row block

// The live tiles of the plan row holding row0: (ids, count).
__device__ __forceinline__ int plan_row(const int* __restrict__ counts,
                                        const int* __restrict__ col_idx, int row0,
                                        int n_j, const int** ids) {
    const int rb = row0 / PLAN_TM;
    *ids = col_idx + static_cast<size_t>(rb) * n_j;
    return min(counts[rb], n_j);
}

// The stored sweep's ring: rows a block for r <= RT (ROWS x RT partials a
// thread, at most 32), and stages: STAGES - 1 stages of ROWS x 256 entries
// in flight make 16 KB a block (3 stages of 8 KB in bf16 at 16 rows), at
// least 3, at most 8.
__host__ __device__ constexpr int bs_rows(int rt) { return rt <= 2 ? PLAN_TM : 32 / rt; }
template <typename T>
__host__ __device__ constexpr int bs_stages(int rows) {
    const int stage = rows * TN * static_cast<int>(sizeof(T));
    const int s = 1 + (16384 + stage - 1) / stage;
    return s < 3 ? 3 : s < 8 ? s : 8;
}
// The plain-load template's rows a block and live tiles loaded at a time
// (its partials and its tiles' entries and V rows stay in registers)
__host__ __device__ constexpr int plain_rows(int rt) { return rt <= 4 ? 2 : 1; }
__host__ __device__ constexpr int plain_unroll(int rt) { return rt <= 8 ? 4 : 2; }

// The first column of live tile id for this thread, or n_cols (no column,
// nothing loaded) for an id outside [0, nJ): every sweep's walk of the plan.
__device__ __forceinline__ int tile_col(int id, int n_j, int n_cols) {
    return static_cast<unsigned>(id) < static_cast<unsigned>(n_j)
        ? id * TN + static_cast<int>(threadIdx.x) : n_cols;
}

// V's row col (zeros past the r columns, or for no column)
template <int RT>
__device__ __forceinline__ void load_v_row(const float* __restrict__ v, int col, int n_cols,
                                           int r, float (&vv)[RT]) {
#pragma unroll
    for (int c = 0; c < RT; ++c)
        vv[c] = col < n_cols && c < r ? v[static_cast<size_t>(col) * r + c] : 0.f;
}

// acc[i * RT + c] += a_i V[col, c] for the block's ROWS entries a_i of a column
template <int RT, int ROWS>
__device__ __forceinline__ void fold_column(float (&acc)[ROWS * RT], const float (&aj)[ROWS],
                                            const float (&vv)[RT], int r) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int c = 0; c < RT; ++c)
            if (c < r) acc[i * RT + c] = fmaf(aj[i], vv[c], acc[i * RT + c]);
}

// U rows [row0, row0 + ROWS) over the plan's live tiles: RING streams the
// tiles through the shared-memory ring (rows on 16 bytes), else the
// plain-load template. The same bits either way, and whatever ROWS (see
// the header).
template <int RT, bool RING, typename T, int ROWS = RING ? bs_rows(RT) : plain_rows(RT),
          int STAGES = bs_stages<T>(ROWS)>
__global__ void __launch_bounds__(TN) bs_matmat_kernel(
    const T* __restrict__ a, const float* __restrict__ v,
    const float* __restrict__ d, const int* __restrict__ counts,
    const int* __restrict__ col_idx, float* __restrict__ u,
    int n_rows, int n_cols, int n_j, int r) {
    static_assert(PLAN_TM % ROWS == 0, "a block's rows lie in one plan row block");
    static_assert(!RING || STAGES >= 2, "the ring keeps a tile in flight");
    extern __shared__ float4 ring4[];
    __shared__ float s_red[tile::NWARPS * ROWS * RT];
    const int row0 = blockIdx.x * ROWS;
    const int nr = min(ROWS, n_rows - row0);
    const int tid = threadIdx.x;
    const int* ids;
    const int nb = plan_row(counts, col_idx, row0, n_j, &ids);

    float acc[ROWS * RT];
#pragma unroll
    for (int e = 0; e < ROWS * RT; ++e) acc[e] = 0.f;

    if constexpr (RING) {
        // the plan walked two ids ahead: V's row of tile b + 1 loads while
        // tile b folds
        int id_next = nb > 1 ? ids[1] : n_j;
        float vc[RT], vn[RT];
        load_v_row<RT>(v, tile_col(nb > 0 ? ids[0] : n_j, n_j, n_cols), n_cols, r, vc);
        // stage b % STAGES holds live tile b's 256 columns of the block's
        // rows as 16-byte pieces, row i at entry i * 256; a piece past the
        // row's end or of a row past the last is zero-filled and never read
        constexpr int PIECE = 16 / static_cast<int>(sizeof(T));  // entries a cp.async moves
        constexpr int PER_ROW = TN / PIECE;
        constexpr int PIECES = ROWS * PER_ROW;
        T* ring = reinterpret_cast<T*>(ring4);
        const auto fill = [&](int b, int id) {
            if (b < nb && static_cast<unsigned>(id) < static_cast<unsigned>(n_j)) {
                T* slot = ring + (b % STAGES) * (ROWS * TN);
#pragma unroll
                for (int p0 = 0; p0 < PIECES; p0 += TN) {
                    const int p = p0 + tid;
                    if (PIECES % TN == 0 || p < PIECES) {
                        const int i = p / PER_ROW;
                        const int j = id * TN + (p - i * PER_ROW) * PIECE;
                        const bool ok = i < nr && j < n_cols;
                        cp_async16(slot + i * TN + (p - i * PER_ROW) * PIECE,
                                   a + static_cast<size_t>(row0 + (ok ? i : 0)) * n_cols
                                       + (ok ? j : 0),
                                   ok ? 16 : 0);
                    }
                }
            }
            cp_async_commit();  // an empty group past the plan keeps the count
        };
#pragma unroll
        for (int b = 0; b < STAGES - 1; ++b) fill(b, b < nb ? ids[b] : n_j);
        int id_fill = STAGES - 1 < nb ? ids[STAGES - 1] : n_j;
        int id = nb > 0 ? ids[0] : n_j;
        for (int b = 0; b < nb; ++b) {
            cp_async_wait<STAGES - 2>();  // tile b has landed for this thread ...
            __syncthreads();              // ... and for all, who are done with tile b - 1
            fill(b + STAGES - 1, id_fill);
            id_fill = b + STAGES < nb ? ids[b + STAGES] : n_j;
            const int id_after = b + 2 < nb ? ids[b + 2] : n_j;
            load_v_row<RT>(v, tile_col(id_next, n_j, n_cols), n_cols, r, vn);
            if (tile_col(id, n_j, n_cols) < n_cols) {
                const T* slot = ring + (b % STAGES) * (ROWS * TN) + tid;
                float aj[ROWS];
#pragma unroll
                for (int i = 0; i < ROWS; ++i) aj[i] = to_f32(slot[i * TN]);
                fold_column<RT, ROWS>(acc, aj, vc, r);
            }
#pragma unroll
            for (int c = 0; c < RT; ++c) vc[c] = vn[c];
            id = id_next;
            id_next = id_after;
        }
    } else {
        // PLAIN_UNROLL live tiles at a time: their ids, then the ROWS
        // entries of column id * 256 + t of each (with the streaming cache
        // hint) and V's rows, all in flight before the first folds
        constexpr int PLAIN_UNROLL = plain_unroll(RT);
        const T* base = a + static_cast<size_t>(row0) * n_cols;
        for (int b = 0; b < nb; b += PLAIN_UNROLL) {
            int col[PLAIN_UNROLL];
            float aj[PLAIN_UNROLL][ROWS], vv[PLAIN_UNROLL][RT];
#pragma unroll
            for (int q = 0; q < PLAIN_UNROLL; ++q)
                col[q] = tile_col(b + q < nb ? ids[b + q] : n_j, n_j, n_cols);
#pragma unroll
            for (int q = 0; q < PLAIN_UNROLL; ++q) {
#pragma unroll
                for (int i = 0; i < ROWS; ++i)
                    aj[q][i] = col[q] < n_cols && i < nr
                        ? ldcs_f32(base + static_cast<size_t>(i) * n_cols + col[q]) : 0.f;
                load_v_row<RT>(v, col[q], n_cols, r, vv[q]);
            }
#pragma unroll
            for (int q = 0; q < PLAIN_UNROLL; ++q)
                if (col[q] < n_cols) fold_column<RT, ROWS>(acc, aj[q], vv[q], r);
        }
    }

    const float s = tile::block_reduce_fixed<ROWS * RT>(acc, s_red);
    const int i = tid / RT, c = tid - i * RT;
    if (tid < ROWS * RT && c < r && i < nr)
        u[static_cast<size_t>(row0 + i) * r + c] = __fdiv_rn(s, nan_max(d[row0 + i], 1e-30f));
}

template <int RT, bool POLICY>
__global__ void __launch_bounds__(TN) bs_streaming_matmat_kernel(
    const float* __restrict__ xr, const float* __restrict__ xc, tile::Policy pol,
    const float* __restrict__ v, const float* __restrict__ d,
    const int* __restrict__ counts, const int* __restrict__ col_idx, float* __restrict__ u,
    int n_rows, int n_cols, int m, int r, int row_offset, int col_offset,
    int kind, float inv_two_sigma_sq) {
    constexpr int TM = tm_for(RT);
    extern __shared__ float smem[];
    float* s_xc = smem;
    float* s_xr = smem + TN * (min(m, tile::MC) + 1);
    __shared__ tile::Rows<TM> s_rows;
    __shared__ float s_red[tile::NWARPS * TM * RT];

    const int row0 = blockIdx.x * TM;
    const int n_j = (n_cols + TN - 1) / TN;
    const int* ids;
    const int nb = plan_row(counts, col_idx, row0, n_j, &ids);
    tile::load_rows<TM>(xr, n_rows, m, row0, kind == tile::RBF, pol, s_rows);

    float acc[TM * RT];
#pragma unroll
    for (int e = 0; e < TM * RT; ++e) acc[e] = 0.f;

    bool first = true;
    for (int b = 0; b < nb; ++b) {
        const int id = ids[b];
        if (id >= n_j) continue;
        const int c0 = id * TN;
        const int col = c0 + threadIdx.x;
        const bool inside = col < n_cols;
        float vv[RT];
#pragma unroll
        for (int c = 0; c < RT; ++c)
            vv[c] = inside && c < r ? v[static_cast<size_t>(col) * r + c] : 0.f;
        tile::masked_tile<TM, POLICY>(xr, xc, s_xc, s_xr, s_rows, row0, c0, first, n_rows,
                                      n_cols, m, row_offset, col_offset, kind,
                                      inv_two_sigma_sq, pol, [&](int i, float a) {
            if (inside) {
#pragma unroll
                for (int c = 0; c < RT; ++c)
                    if (c < r) acc[i * RT + c] = fmaf(a, vv[c], acc[i * RT + c]);
            }
        });
        first = false;
    }

    const float s = tile::block_reduce_fixed<TM * RT>(acc, s_red);
    const int i = threadIdx.x / RT, c = threadIdx.x - i * RT;
    const int row = row0 + i;
    if (threadIdx.x < TM * RT && c < r && row < n_rows)
        u[static_cast<size_t>(row) * r + c] =
            d == nullptr ? s : __fdiv_rn(s, nan_max(d[row], 1e-30f));
}

// streaming.cu's register template over the live tiles (m <= tile::MR),
// walking the plan two ids ahead: while tile b folds, the id of tile b + 2
// and the column operands of tile b + 1 are in flight.
template <int RT, bool POLICY>
__global__ void __launch_bounds__(TN, tile::reg_blocks_per_sm(RT)) bs_streaming_matmat_reg_kernel(
    const float* __restrict__ xr, const float* __restrict__ xc, tile::Policy pol,
    const float* __restrict__ v, const float* __restrict__ d,
    const int* __restrict__ counts, const int* __restrict__ col_idx, float* __restrict__ u,
    int n_rows, int n_cols, int m, int r, int row_offset, int col_offset,
    int kind, float inv_two_sigma_sq) {
    constexpr int TM = tm_for(RT);
    __shared__ __align__(16) tile::Rows<TM> s_rows;
    __shared__ tile::RowFeats<TM> s_rf;
    __shared__ float s_red[tile::NWARPS * TM * RT];

    const int row0 = blockIdx.x * TM;
    const int n_j = (n_cols + TN - 1) / TN;
    const int* ids;
    const int nb = plan_row(counts, col_idx, row0, n_j, &ids);
    tile::load_rows<TM>(xr, n_rows, m, row0, kind == tile::RBF, pol, s_rows);
    tile::load_row_feats<TM>(xr, n_rows, m, row0, s_rf);
    __syncthreads();

    float acc[TM * RT];
#pragma unroll
    for (int e = 0; e < TM * RT; ++e) acc[e] = 0.f;

    tile::with_form<POLICY>(kind, pol, [&](auto form) {
        using Form = decltype(form);
        int id = nb > 0 ? ids[0] : n_j;
        int id_next = nb > 1 ? ids[1] : n_j;
        tile::Col<RT> cur, nxt;
        tile::load_col<RT, POLICY>(xc, v, pol, tile_col(id, n_j, n_cols), n_cols, m, r, cur);
        for (int b = 0; b < nb; ++b) {
            const int id_after = b + 2 < nb ? ids[b + 2] : n_j;
            tile::load_col<RT, POLICY>(xc, v, pol, tile_col(id_next, n_j, n_cols), n_cols, m, r,
                                       nxt);
            if (static_cast<unsigned>(id) < static_cast<unsigned>(n_j))
                tile::fold_tile<TM, RT, Form, POLICY>(
                    cur, s_rf, s_rows, m, inv_two_sigma_sq, pol, row0, id * TN, n_rows, n_cols,
                    row_offset, col_offset, acc);
            cur = nxt;
            id = id_next;
            id_next = id_after;
        }
    });

    const float s = tile::block_reduce_fixed<TM * RT>(acc, s_red);
    const int i = threadIdx.x / RT, c = threadIdx.x - i * RT;
    const int row = row0 + i;
    if (threadIdx.x < TM * RT && c < r && row < n_rows)
        u[static_cast<size_t>(row) * r + c] =
            d == nullptr ? s : __fdiv_rn(s, nan_max(d[row], 1e-30f));
}

template <bool POLICY>
__global__ void __launch_bounds__(TN) bs_streaming_degree_kernel(
    const float* __restrict__ xr, const float* __restrict__ xc, tile::Policy pol,
    const int* __restrict__ counts, const int* __restrict__ col_idx, float* __restrict__ d,
    int n_rows, int n_cols, int m, int row_offset, int col_offset,
    int kind, float inv_two_sigma_sq) {
    extern __shared__ float smem[];
    float* s_xc = smem;
    float* s_xr = smem + TN * (min(m, tile::MC) + 1);
    __shared__ tile::Rows<PLAN_TM> s_rows;
    __shared__ float s_red[tile::NWARPS * PLAN_TM];

    const int row0 = blockIdx.x * PLAN_TM;
    const int n_j = (n_cols + TN - 1) / TN;
    const int* ids;
    const int nb = plan_row(counts, col_idx, row0, n_j, &ids);
    tile::load_rows<PLAN_TM>(xr, n_rows, m, row0, kind == tile::RBF, pol, s_rows);

    float rowsum[PLAN_TM];
#pragma unroll
    for (int r = 0; r < PLAN_TM; ++r) rowsum[r] = 0.f;

    bool first = true;
    for (int b = 0; b < nb; ++b) {
        const int id = ids[b];
        if (id >= n_j) continue;
        tile::masked_tile<PLAN_TM, POLICY>(xr, xc, s_xc, s_xr, s_rows, row0, id * TN, first,
                                           n_rows, n_cols, m, row_offset, col_offset, kind,
                                           inv_two_sigma_sq, pol, [&](int r, float a) {
                                               tile::add_entry(rowsum[r], a);
                                           });
        first = false;
    }

    const float s = tile::block_reduce_fixed<PLAN_TM>(rowsum, s_red);
    if (threadIdx.x < PLAN_TM && row0 + threadIdx.x < n_rows) d[row0 + threadIdx.x] = s;
}

// The degree's register template over the live tiles (m <= tile::MR):
// streaming.cu's streaming_degree_reg_kernel (the same PLAN_TM = 16 rows,
// row sums, skip test and reduction) walking the plan as
// bs_streaming_matmat_reg_kernel does, two ids ahead, ids outside [0, nJ)
// ignored. bs_streaming_degree_kernel above is the staged template (any m);
// the two give the same bits.
template <bool POLICY>
__global__ void __launch_bounds__(TN, tile::reg_blocks_per_sm(1)) bs_streaming_degree_reg_kernel(
    const float* __restrict__ xr, const float* __restrict__ xc, tile::Policy pol,
    const int* __restrict__ counts, const int* __restrict__ col_idx, float* __restrict__ d,
    int n_rows, int n_cols, int m, int row_offset, int col_offset,
    int kind, float inv_two_sigma_sq) {
    static_assert(tm_for(1) == PLAN_TM, "the degree's rows are the r = 1 sweep's");
    __shared__ __align__(16) tile::Rows<PLAN_TM> s_rows;
    __shared__ tile::RowFeats<PLAN_TM> s_rf;
    __shared__ __align__(16) float s_bound[PLAN_TM];
    __shared__ float s_red[tile::NWARPS * PLAN_TM];

    const int row0 = blockIdx.x * PLAN_TM;
    const int n_j = (n_cols + TN - 1) / TN;
    const int* ids;
    const int nb = plan_row(counts, col_idx, row0, n_j, &ids);
    tile::load_rows<PLAN_TM>(xr, n_rows, m, row0, kind == tile::RBF, pol, s_rows);
    tile::load_row_feats<PLAN_TM>(xr, n_rows, m, row0, s_rf);
    tile::load_skip_bounds<PLAN_TM>(pol, s_rows, inv_two_sigma_sq, s_bound);
    __syncthreads();

    float rowsum[PLAN_TM];
#pragma unroll
    for (int r = 0; r < PLAN_TM; ++r) rowsum[r] = 0.f;

    tile::with_form<POLICY>(kind, pol, [&](auto form) {
        using Form = decltype(form);
        int id = nb > 0 ? ids[0] : n_j;
        int id_next = nb > 1 ? ids[1] : n_j;
        tile::Col<1> cur, nxt;  // r = 0: the features and scale alone
        tile::load_col<1, POLICY>(xc, nullptr, pol, tile_col(id, n_j, n_cols), n_cols, m, 0, cur);
        for (int b = 0; b < nb; ++b) {
            const int id_after = b + 2 < nb ? ids[b + 2] : n_j;
            tile::load_col<1, POLICY>(xc, nullptr, pol, tile_col(id_next, n_j, n_cols), n_cols, m,
                                      0, nxt);
            if (static_cast<unsigned>(id) < static_cast<unsigned>(n_j))
                tile::tile_entries<PLAN_TM, Form, POLICY>(
                    cur, s_rf, s_rows, s_bound, m, inv_two_sigma_sq, pol, row0, id * TN, n_rows,
                    n_cols, row_offset, col_offset,
                    [&](int i, float a) { tile::add_entry(rowsum[i], a); });
            cur = nxt;
            id = id_next;
            id_next = id_after;
        }
    });

    const float s = tile::block_reduce_fixed<PLAN_TM>(rowsum, s_red);
    if (threadIdx.x < PLAN_TM && row0 + threadIdx.x < n_rows) d[row0 + threadIdx.x] = s;
}

template <bool POLICY>
__global__ void __launch_bounds__(TN) liveness_kernel(
    const float* __restrict__ xr, const float* __restrict__ xc, tile::Policy pol,
    int* __restrict__ live, int n_rows, int n_cols, int m, int row_offset, int col_offset,
    int kind, float inv_two_sigma_sq) {
    extern __shared__ float smem[];
    float* s_xc = smem;
    float* s_xr = smem + TN * (min(m, tile::MC) + 1);
    __shared__ tile::Rows<PLAN_TM> s_rows;

    const int row0 = blockIdx.x * PLAN_TM;
    const int n_j = (n_cols + TN - 1) / TN;
    tile::load_rows<PLAN_TM>(xr, n_rows, m, row0, kind == tile::RBF, pol, s_rows);

    for (int cj = 0; cj < n_j; ++cj) {
        bool any = false;
        tile::masked_tile<PLAN_TM, POLICY>(xr, xc, s_xc, s_xr, s_rows, row0, cj * TN, cj == 0,
                                           n_rows, n_cols, m, row_offset, col_offset, kind,
                                           inv_two_sigma_sq, pol,
                                           [&](int, float a) { any = any || a != 0.f; });
        const int tile_live = __syncthreads_or(any);
        if (threadIdx.x == 0) live[static_cast<size_t>(blockIdx.x) * n_j + cj] = tile_live != 0;
    }
}

// The liveness pass's register template (m <= tile::MR): each thread makes
// its column's PLAN_TM entries from the sweeps' pieces (column operands a
// tile ahead, the mask only on ragged and diagonal warps, no expf where an
// entry is provably dropped: tile::col_entries) and ORs entry != 0 (a NaN
// counts); a warp vote replaces the block barrier, and a warp that finds a
// live entry writes 1. The map comes zeroed from the wrapper and every
// writer writes the same 1, so it is liveness_kernel's map with no barrier
// and no ordering. With no partials to keep it fits 64 registers, four
// blocks an SM (two, as the degree takes, measured slower on the card).
template <bool POLICY>
__global__ void __launch_bounds__(TN, 4) liveness_reg_kernel(
    const float* __restrict__ xr, const float* __restrict__ xc, tile::Policy pol,
    int* __restrict__ live, int n_rows, int n_cols, int m, int row_offset, int col_offset,
    int kind, float inv_two_sigma_sq) {
    __shared__ __align__(16) tile::Rows<PLAN_TM> s_rows;
    __shared__ tile::RowFeats<PLAN_TM> s_rf;
    __shared__ __align__(16) float s_bound[PLAN_TM];

    const int row0 = blockIdx.x * PLAN_TM;
    const int n_j = (n_cols + TN - 1) / TN;
    tile::load_rows<PLAN_TM>(xr, n_rows, m, row0, kind == tile::RBF, pol, s_rows);
    tile::load_row_feats<PLAN_TM>(xr, n_rows, m, row0, s_rf);
    tile::load_skip_bounds<PLAN_TM>(pol, s_rows, inv_two_sigma_sq, s_bound);
    __syncthreads();
    int* live_row = live + static_cast<size_t>(blockIdx.x) * n_j;

    tile::with_form<POLICY>(kind, pol, [&](auto form) {
        using Form = decltype(form);
        tile::Col<1> cur, nxt;  // r = 0: the features and scale alone
        tile::load_col<1, POLICY>(xc, nullptr, pol, threadIdx.x, n_cols, m, 0, cur);
        for (int cj = 0; cj < n_j; ++cj) {
            const int c0 = cj * TN;
            tile::load_col<1, POLICY>(xc, nullptr, pol, c0 + TN + threadIdx.x, n_cols, m, 0,
                                      nxt);
            bool any = false;
            tile::tile_entries<PLAN_TM, Form, POLICY>(
                cur, s_rf, s_rows, s_bound, m, inv_two_sigma_sq, pol, row0, c0, n_rows, n_cols,
                row_offset, col_offset, [&](int, float a) { any |= a != 0.f; });
            if (__any_sync(0xffffffffu, any) && (threadIdx.x & 31) == 0) live_row[cj] = 1;
            cur = nxt;
        }
    });
}

template <int RT, bool RING, typename T>
int launch_bs_matmat(const T* a, const float* v, const float* d, const int* counts,
                     const int* col_idx, float* u, int n_rows, int n_cols, int r,
                     cudaStream_t stream) {
    constexpr int ROWS = RING ? bs_rows(RT) : plain_rows(RT);
    constexpr int BYTES = RING ? bs_stages<T>(ROWS) * ROWS * TN * static_cast<int>(sizeof(T)) : 0;
    const int n_j = (n_cols + TN - 1) / TN;
    auto kernel = bs_matmat_kernel<RT, RING, T>;
    if constexpr (RING) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<(n_rows + ROWS - 1) / ROWS, TN, BYTES, stream>>>(a, v, d, counts, col_idx, u,
                                                             n_rows, n_cols, n_j, r);
    return static_cast<int>(cudaGetLastError());
}

template <bool RING, typename T>
int launch_bs_matmat_r(const T* a, const float* v, const float* d, const int* counts,
                       const int* col_idx, float* u, int n_rows, int n_cols, int r,
                       cudaStream_t stream) {
#define GPIC_LAUNCH(RT) return launch_bs_matmat<RT, RING>(a, v, d, counts, col_idx, u, \
                                                          n_rows, n_cols, r, stream)
    if (r < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (r <= 1) GPIC_LAUNCH(1);
    if (r <= 2) GPIC_LAUNCH(2);
    if (r <= 4) GPIC_LAUNCH(4);
    if (r <= 8) GPIC_LAUNCH(8);
    if (r <= 16) GPIC_LAUNCH(16);
    if (r <= 32) GPIC_LAUNCH(32);
#undef GPIC_LAUNCH
    return static_cast<int>(cudaErrorInvalidValue);
}

template <int RT>
void launch_bs_streaming(const float* xr, const float* xc, const tile::Policy& pol,
                         const float* v, const float* d, const int* counts,
                         const int* col_idx, float* u, int n_rows, int n_cols, int m, int r,
                         int row_offset, int col_offset, int kind, float inv_two_sigma_sq,
                         cudaStream_t stream) {
    constexpr int TM = tm_for(RT);
    const int grid = (n_rows + TM - 1) / TM;
    const bool policy = tile::has_policy(pol);
#define GPIC_ARGS xr, xc, pol, v, d, counts, col_idx, u, n_rows, n_cols, m, r, row_offset, \
                  col_offset, kind, inv_two_sigma_sq
    if (m > tile::MR) {
        const size_t smem = tile::smem_bytes(TM, m);
        if (policy) bs_streaming_matmat_kernel<RT, true><<<grid, TN, smem, stream>>>(GPIC_ARGS);
        else bs_streaming_matmat_kernel<RT, false><<<grid, TN, smem, stream>>>(GPIC_ARGS);
    } else {
        if (policy) bs_streaming_matmat_reg_kernel<RT, true><<<grid, TN, 0, stream>>>(GPIC_ARGS);
        else bs_streaming_matmat_reg_kernel<RT, false><<<grid, TN, 0, stream>>>(GPIC_ARGS);
    }
#undef GPIC_ARGS
}

}  // namespace

// a is float, or __nv_bfloat16 where a_bf16 is nonzero. ring: a bf16 A
// whose rows all start on 16 bytes (A's address and C's bytes multiples of
// 16) streams its live tiles through the cp.async ring; 0 takes the
// plain-load template, which an f32 A always takes (the ring measured
// slower in f32 on an H100).
extern "C" int gpic_block_sparse_matmat(
    const void* a, const float* v, const float* d, const int* counts, const int* col_idx,
    float* u, int n_rows, int n_cols, int r, int ring, int a_bf16, cudaStream_t stream) {
    const auto* ab = static_cast<const __nv_bfloat16*>(a);
    if (a_bf16 && ring)
        return launch_bs_matmat_r<true>(ab, v, d, counts, col_idx, u, n_rows, n_cols, r, stream);
    if (a_bf16)
        return launch_bs_matmat_r<false>(ab, v, d, counts, col_idx, u, n_rows, n_cols, r, stream);
    if (ring) return static_cast<int>(cudaErrorInvalidValue);
    return launch_bs_matmat_r<false>(static_cast<const float*>(a), v, d, counts, col_idx, u,
                                     n_rows, n_cols, r, stream);
}

// d may be null: U is then the unnormalized A V. scale_r / scale_c / thr
// may be null (policy off).
extern "C" int gpic_block_sparse_streaming_matmat(
    const float* xr, const float* xc, const float* scale_r, const float* scale_c,
    const float* thr, const float* v, const float* d, const int* counts, const int* col_idx,
    float* u, int n_rows, int n_cols, int m, int r, int row_offset, int col_offset,
    int kind, float inv_two_sigma_sq, cudaStream_t stream) {
    const tile::Policy pol{scale_r, scale_c, thr, nullptr};
#define GPIC_LAUNCH(RT) launch_bs_streaming<RT>(xr, xc, pol, v, d, counts, col_idx, u, n_rows, \
                                                n_cols, m, r, row_offset, col_offset, kind, \
                                                inv_two_sigma_sq, stream)
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

extern "C" int gpic_block_sparse_streaming_degree(
    const float* xr, const float* xc, const float* scale_r, const float* scale_c,
    const float* thr, const int* counts, const int* col_idx, float* d,
    int n_rows, int n_cols, int m, int row_offset, int col_offset,
    int kind, float inv_two_sigma_sq, cudaStream_t stream) {
    const int grid = (n_rows + PLAN_TM - 1) / PLAN_TM;
    const tile::Policy pol{scale_r, scale_c, thr, nullptr};
    const bool policy = tile::has_policy(pol);
#define GPIC_ARGS xr, xc, pol, counts, col_idx, d, n_rows, n_cols, m, row_offset, col_offset, \
                  kind, inv_two_sigma_sq
    if (m > tile::MR) {
        const size_t smem = tile::smem_bytes(PLAN_TM, m);
        if (policy) bs_streaming_degree_kernel<true><<<grid, TN, smem, stream>>>(GPIC_ARGS);
        else bs_streaming_degree_kernel<false><<<grid, TN, smem, stream>>>(GPIC_ARGS);
    } else {
        if (policy) bs_streaming_degree_reg_kernel<true><<<grid, TN, 0, stream>>>(GPIC_ARGS);
        else bs_streaming_degree_reg_kernel<false><<<grid, TN, 0, stream>>>(GPIC_ARGS);
    }
#undef GPIC_ARGS
    return static_cast<int>(cudaGetLastError());
}

// live is (ceil(n_rows / 16), ceil(n_cols / 256)) int32, zeroed by the
// caller (the register template writes only the live tiles' 1s).
extern "C" int gpic_block_liveness(
    const float* xr, const float* xc, const float* scale_r, const float* scale_c,
    const float* thr, int* live, int n_rows, int n_cols, int m, int row_offset,
    int col_offset, int kind, float inv_two_sigma_sq, cudaStream_t stream) {
    const int grid = (n_rows + PLAN_TM - 1) / PLAN_TM;
    const tile::Policy pol{scale_r, scale_c, thr, nullptr};
    const bool policy = tile::has_policy(pol);
#define GPIC_ARGS xr, xc, pol, live, n_rows, n_cols, m, row_offset, col_offset, kind, \
                  inv_two_sigma_sq
    if (m > tile::MR) {
        const size_t smem = tile::smem_bytes(PLAN_TM, m);
        if (policy) liveness_kernel<true><<<grid, TN, smem, stream>>>(GPIC_ARGS);
        else liveness_kernel<false><<<grid, TN, smem, stream>>>(GPIC_ARGS);
    } else {
        if (policy) liveness_reg_kernel<true><<<grid, TN, 0, stream>>>(GPIC_ARGS);
        else liveness_reg_kernel<false><<<grid, TN, 0, stream>>>(GPIC_ARGS);
    }
#undef GPIC_ARGS
    return static_cast<int>(cudaGetLastError());
}
