// Streamed per-row top-K of the affinity scores for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/row_topk.py::row_topk (the Pallas TPU kernel
// _row_topk_kernel), pass 1 of the two-pass graph build: the (R, K)
// descending top-K of each row's scores over the stripe of xr (R, m)
// against xc (C, m), the global diagonal and the padding excluded, and
// -inf where a row has fewer than K valid entries. stat SIMILARITY scores
// the affinity value (adaptive scales applied when given), NEG_SQDIST
// scores -max(d2, 0) for any kind. No (R, C) array is stored.
//
// Bound on an H100: the operations. Every call scores R * C entries (2m
// for the dot product, the transform, one compare with the row's running
// K-th value) and writes only R * K floats. At n = 45,000, m = 2 that is
// about 2e10 f32 operations, 0.3 ms at 67 TFLOP/s; the similarity score
// also takes one expf (one MUFU.EX2) an entry, 0.48 ms at 16 a clock per
// SM. What the card issues is the limit in practice: about 20
// instructions an entry (the rbf score as in streaming.cu, the compare
// with the row's K-th value and the candidate's bit), and the merges.
//
// Design:
//  * The scores are the build's entries bit for bit: tile::transform (or
//    -max(d2, 0)) from the same operands in the same order as
//    tile::tile_scores, the code that affinity.cu stores and streaming.cu
//    folds. A threshold read from the K-th score is then compared
//    (a >= thr) with the very value the build makes, so a row keeps K
//    entries, or more only on an exact tie.
//  * Two templates make the same scores. The staged one (any m,
//    row_topk_kernel) is affinity.cu's block shape: TN = 256 threads own
//    TM = 16 rows, each tile's column slab staged in shared memory between
//    two barriers, then a third barrier and one warp a row to merge the
//    tile's candidates into the block's lists. The register one (m <=
//    tile::MR, the paper's m = 2, row_topk_reg_kernel) gives each warp RW
//    rows of its own and their lists: the rows' features and norms and
//    their K-th values in registers, each lane's column operands loaded
//    one 32-column step ahead, no block barrier at all, the mask only in
//    the steps on an edge or on the global diagonal, the score form fixed
//    for each compiled loop. A lane keeps a step's RW scores in registers
//    and sets a bit for each that beats its row's K-th value; the warp
//    merges only on the steps where some lane set one (one
//    __reduce_or_sync a step), fetching the candidates by shuffles, and
//    the merge refreshes the K-th values. No score goes through shared
//    memory, and a warp never waits on another: once the lists hold their
//    K best, few scores beat the K-th, so most steps are scoring alone.
//    The warp visits its 32-column blocks in a golden-ratio stride order,
//    not in column order: on class-sorted data (the generators' contract)
//    a row in column order meets a new class's columns, and another wave
//    of scores that beat its K-th, once per class.
//  * A merge inserts one candidate at a time into the row's descending
//    list of K (a ballot finds the place, a shuffle shifts the tail; two
//    slots a lane, so K <= 64): the staged template in shared memory, the
//    register one in registers, the row's list loaded once a merge.
//  * Only values come out. A tie needs no rule: the multiset of the top K
//    values does not depend on which of two equal scores is kept, nor on
//    the order in which the columns are visited, so the output is
//    torch.topk(...).values exactly, and the two templates give the same
//    bits (the card check holds x against x with a zero feature column
//    appended, which takes the staged one). A NaN score is never kept
//    (torch.topk would rank it first); the front door refuses NaN features.

#include "affinity_tile.cuh"

namespace {

constexpr int TM = 16;     // rows per block of the staged template
constexpr int MAX_K = 64;  // two list slots per lane
// The register template's shape: with RW = 8 rows a warp, the rows'
// features, norms and K-th values and a step's scores fit in 80
// registers, so six blocks of RWARPS warps fit an SM (24 warps; 5,625
// warps at n = 45,000). 16 rows a warp take 128 registers (16 warps an
// SM, 2,813 warps: a third of a wave left at the end).
constexpr int RW = 8;         // rows per warp of the register template
constexpr int RWARPS = 4;     // warps per block of the register template
constexpr int REG_BLOCKS = 6; // blocks an SM the register template is compiled for
constexpr unsigned FULL = 0xffffffffu;
using tile::MR;
using tile::TN;

// Insert v into the descending list buf[0, k) when it beats buf[k - 1]. All
// 32 lanes of the warp call it with the same v (the test is warp-uniform).
__device__ __forceinline__ void insert_desc(float* buf, int k, float v, int lane) {
    if (!(v > buf[k - 1])) return;
    const int i0 = lane, i1 = lane + 32;
    const bool in0 = i0 < k, in1 = i1 < k;
    const float b0 = in0 ? buf[i0] : 0.f;
    const float b1 = in1 ? buf[i1] : 0.f;
    // the entries >= v come first in a descending list: p is v's place
    const int p = __popc(__ballot_sync(FULL, in0 && b0 >= v))
                + __popc(__ballot_sync(FULL, in1 && b1 >= v));
    const float up0 = __shfl_up_sync(FULL, b0, 1);  // buf[i0 - 1]
    const float up1 = __shfl_up_sync(FULL, b1, 1);  // buf[i1 - 1], lanes 1..31
    const float last0 = __shfl_sync(FULL, b0, 31);  // buf[31] = buf[i1 - 1] at lane 0
    const float n0 = i0 < p ? b0 : (i0 == p ? v : up0);
    const float n1 = i1 < p ? b1 : (i1 == p ? v : (lane == 0 ? last0 : up1));
    __syncwarp();  // every lane has read the list before any lane writes
    if (in0) buf[i0] = n0;
    if (in1) buf[i1] = n1;
    __syncwarp();
}

template <bool POLICY>
__global__ void __launch_bounds__(TN) row_topk_kernel(
    const float* __restrict__ xr, const float* __restrict__ xc, tile::Policy pol,
    float* __restrict__ out, int n_rows, int n_cols, int m, int k,
    int row_offset, int col_offset, int kind, int stat, float inv_two_sigma_sq) {
    extern __shared__ float smem[];
    const int kmax = min(m, tile::MC);
    float* s_xc = smem;
    float* s_xr = s_xc + TN * (kmax + 1);
    float* s_list = s_xr + TM * kmax;  // TM descending lists of k scores
    float* s_cand = s_list + TM * k;   // TM candidate lists of up to TN scores
    __shared__ tile::Rows<TM> s_rows;
    __shared__ int s_ncand[TM];
    __shared__ float s_kth[TM];        // each list's last entry

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int row0 = blockIdx.x * TM;
    tile::load_rows<TM>(xr, n_rows, m, row0, tile::needs_norms(kind, stat), pol, s_rows);
    for (int e = tid; e < TM * k; e += TN) s_list[e] = -INFINITY;
    if (tid < TM) {
        s_ncand[tid] = 0;
        s_kth[tid] = -INFINITY;
    }
    // tile_scores synchronizes the block before it emits anything

    for (int c0 = 0; c0 < n_cols; c0 += TN) {
        tile::tile_scores<TM, POLICY>(xr, xc, s_xc, s_xr, s_rows, row0, c0, c0 == 0, n_rows, n_cols,
                                      m, row_offset, col_offset, kind, stat,
                                      inv_two_sigma_sq, pol, [&](int r, float s, bool valid) {
            if (valid && s > s_kth[r]) s_cand[r * TN + atomicAdd(&s_ncand[r], 1)] = s;
        });
        __syncthreads();
        for (int r = warp; r < TM; r += tile::NWARPS) {
            float* list = s_list + r * k;
            const int nc = s_ncand[r];
            for (int j = 0; j < nc; ++j) insert_desc(list, k, s_cand[r * TN + j], lane);
            if (lane == 0) {
                s_kth[r] = list[k - 1];
                s_ncand[r] = 0;
            }
        }
        // the next tile's tile_scores synchronizes before it reads s_kth
    }
    __syncthreads();
    for (int e = tid; e < TM * k; e += TN) {
        const int r = e / k;
        if (row0 + r < n_rows) out[static_cast<size_t>(row0 + r) * k + (e - r * k)] = s_list[e];
    }
}

// ---------------------------------------------------------------------------
// The register template (m <= MR): each warp owns RW rows and their lists.

// A warp's rows in shared memory, read once into registers (features,
// norms) or, for the adaptive scales, four at a time where the scores use
// them (tile::lds_group). 0 features and norm, scale 1 past the stripe.
struct __align__(16) WarpRows {
    float x[MR][RW];  // features, feature-major; 0 past m
    float sqr[RW];    // squared norms (0 unless the score needs them)
    float scl[RW];    // adaptive scales (1 without)
};

// One lane's operands of one column: its M features and adaptive scale_c
// (0 features, scale 1 past the stripe). M, the feature count, is fixed
// at compile time, so a column's features load with no per-step address
// arithmetic beyond col * M and its dot product has no feature test.
template <int M>
struct TopkCol {
    float x[M];
    float scl;
};

template <int M, bool ADAPTIVE>
__device__ __forceinline__ void load_topk_col(const float* __restrict__ xc,
                                              const float* __restrict__ scale_c, int col,
                                              int n_cols, TopkCol<M>& c) {
    const bool inside = col < n_cols;
    const float* p = xc + static_cast<size_t>(col) * M;
#pragma unroll
    for (int k = 0; k < M; ++k) c.x[k] = inside ? p[k] : 0.f;
    c.scl = ADAPTIVE && inside ? scale_c[col] : 1.f;
}

// The scores of the warp's RW rows at this lane's column col (operands c)
// into sc; bit i of the returned mask says that score i is valid and beats
// its row's K-th value. The arithmetic is tile_scores' (staged template),
// in its order: the dot product an fmaf chain over the features from 0,
// the column norm the __fadd_rn / __fmul_rn chain, then -max(d2, 0) or
// tile::transform. MASKED applies the stripe's edges and the global
// diagonal.
template <int STAT, int KIND, bool ADAPTIVE, bool MASKED, int M>
__device__ __forceinline__ unsigned score_col(
    const TopkCol<M>& c, const float (&rx)[M][RW], const float (&sqr)[RW],
    const float (&kth)[RW], const WarpRows& wr, float inv_two_sigma_sq, int row0, int col,
    int n_rows, int n_cols, int row_offset, int col_offset, float (&sc)[RW]) {
    constexpr bool NORMS = STAT == tile::NEG_SQDIST || KIND == tile::RBF;
    float dot[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) dot[i] = 0.f;
    float sqc = 0.f;
#pragma unroll
    for (int k = 0; k < M; ++k) {
        if (NORMS) sqc = __fadd_rn(sqc, __fmul_rn(c.x[k], c.x[k]));
#pragma unroll
        for (int i = 0; i < RW; ++i) dot[i] = fmaf(rx[k][i], c.x[k], dot[i]);
    }
    unsigned mask = 0u;
    float scl[4];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
        if (ADAPTIVE && i % 4 == 0) tile::lds_group<4>(wr.scl + i, scl);
        sc[i] = STAT == tile::NEG_SQDIST
            ? -nan_max(tile::sq_dist(dot[i], sqr[i], sqc), 0.f)
            : tile::transform(KIND, dot[i], sqr[i], sqc, inv_two_sigma_sq, ADAPTIVE,
                              ADAPTIVE ? scl[i % 4] : 1.f, ADAPTIVE ? c.scl : 1.f);
        const bool valid = !MASKED || (col < n_cols && row0 + i < n_rows
                                       && row_offset + row0 + i != col_offset + col);
        if (valid && sc[i] > kth[i]) mask |= 1u << i;
    }
    return mask;
}

// The last entry (the K-th) of a descending list of k held by the warp's
// lanes: slot lane in b0, slot lane + 32 in b1.
__device__ __forceinline__ float list_last(float b0, float b1, int k) {
    return k > 32 ? __shfl_sync(FULL, b1, k - 33) : __shfl_sync(FULL, b0, k - 1);
}

// Insert v into a descending list of k held by the warp's lanes (slot
// lane in b0, slot lane + 32 in b1) when it beats the list's last entry:
// insert_desc's ballot and shifts, on registers. All 32 lanes call it with
// the same v.
__device__ __forceinline__ void insert_reg(float& b0, float& b1, int k, float v, int lane) {
    if (!(v > list_last(b0, b1, k))) return;
    const int i0 = lane, i1 = lane + 32;
    const bool in0 = i0 < k, in1 = i1 < k;
    // the entries >= v come first in a descending list: p is v's place
    const int p = __popc(__ballot_sync(FULL, in0 && b0 >= v))
                + __popc(__ballot_sync(FULL, in1 && b1 >= v));
    const float up0 = __shfl_up_sync(FULL, b0, 1);  // slot i0 - 1
    const float up1 = __shfl_up_sync(FULL, b1, 1);  // slot i1 - 1, lanes 1..31
    const float last0 = __shfl_sync(FULL, b0, 31);  // slot 31 = slot i1 - 1 at lane 0
    const float n0 = i0 < p ? b0 : (i0 == p ? v : up0);
    const float n1 = i1 < p ? b1 : (i1 == p ? v : (lane == 0 ? last0 : up1));
    if (in0) b0 = n0;
    if (in1) b1 = n1;
}

// Merge one row's candidates of the step (the lanes whose bit is set, each
// holding its score s) into the row's list: the list comes into
// registers, takes the candidates one at a time (each fetched by a
// shuffle) and goes back; returns its new K-th value.
__device__ __forceinline__ float merge_row(float* list, float s, bool cand, int k, int lane) {
    float b0 = lane < k ? list[lane] : -INFINITY;
    float b1 = lane + 32 < k ? list[lane + 32] : -INFINITY;
    unsigned src = __ballot_sync(FULL, cand);
    while (src != 0u) {
        const int l = __ffs(src) - 1;
        src &= src - 1u;
        insert_reg(b0, b1, k, __shfl_sync(FULL, s, l), lane);
    }
    if (lane < k) list[lane] = b0;
    if (lane + 32 < k) list[lane + 32] = b1;
    return list_last(b0, b1, k);
}

// The warp's walk over the columns in 32-column blocks, in one score form
// and feature count M: score a block, and on the steps where some lane has
// a candidate (one __reduce_or_sync a step) merge each row that has one.
// The blocks are visited in the order b = t * stride mod n_blocks (stride
// coprime with n_blocks, near n_blocks / phi, phi the golden ratio): the
// top K does not depend on the order, and on class-sorted data a row
// meets its own class's columns early on, so its K-th value rises early
// and fewer scores beat it. The row features come from shared memory into
// registers here, where M is known.
template <int STAT, int KIND, bool ADAPTIVE, int M>
__device__ __forceinline__ void topk_walk(
    const float* __restrict__ xc, const float* __restrict__ scale_c, const WarpRows& wr,
    float (&kth)[RW], float* lists, int n_rows, int n_cols, int k, int stride, int row0,
    int row_offset, int col_offset, float inv_two_sigma_sq, int lane) {
    float rx[M][RW], sqr[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
#pragma unroll
        for (int kk = 0; kk < M; ++kk) rx[kk][i] = wr.x[kk][i];
        sqr[i] = wr.sqr[i];
    }
    const int n_blocks = (n_cols + 31) / 32;
    TopkCol<M> cur, nxt;
    load_topk_col<M, ADAPTIVE>(xc, scale_c, lane, n_cols, cur);
    int b = 0;
    for (int t = 0; t < n_blocks; ++t) {
        const int c0 = b * 32;
        const int col = c0 + lane;
        b += stride;
        if (b >= n_blocks) b -= n_blocks;
        load_topk_col<M, ADAPTIVE>(xc, scale_c, b * 32 + lane, n_cols, nxt);
        float sc[RW];
        const unsigned mask =
            tile::clean_span<RW>(row0, c0, n_rows, n_cols, row_offset, col_offset)
            ? score_col<STAT, KIND, ADAPTIVE, false, M>(cur, rx, sqr, kth, wr, inv_two_sigma_sq,
                                                        row0, col, n_rows, n_cols, row_offset,
                                                        col_offset, sc)
            : score_col<STAT, KIND, ADAPTIVE, true, M>(cur, rx, sqr, kth, wr, inv_two_sigma_sq,
                                                       row0, col, n_rows, n_cols, row_offset,
                                                       col_offset, sc);
        const unsigned rows = __reduce_or_sync(FULL, mask);
        if (rows != 0u) {
#pragma unroll
            for (int i = 0; i < RW; ++i)
                if ((rows >> i) & 1u)
                    kth[i] = merge_row(lists + i * k, sc[i], (mask >> i) & 1u, k, lane);
        }
        cur = nxt;
    }
}

__global__ void __launch_bounds__(RWARPS * 32, REG_BLOCKS) row_topk_reg_kernel(
    const float* __restrict__ xr, const float* __restrict__ xc, tile::Policy pol,
    float* __restrict__ out, int n_rows, int n_cols, int m, int k, int stride,
    int row_offset, int col_offset, int kind, int stat, float inv_two_sigma_sq) {
    extern __shared__ float smem[];
    __shared__ WarpRows s_wr[RWARPS];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int row0 = (blockIdx.x * RWARPS + warp) * RW;
    if (row0 >= n_rows) return;
    float* lists = smem + warp * RW * k;  // RW descending lists of k scores
    WarpRows& wr = s_wr[warp];
    const bool adaptive = pol.scale_r != nullptr && stat == tile::SIMILARITY
                          && kind == tile::RBF;

    for (int e = lane; e < MR * RW; e += 32) {
        const int kk = e / RW, i = e - kk * RW;
        const int row = row0 + i;
        wr.x[kk][i] = kk < m && row < n_rows ? xr[static_cast<size_t>(row) * m + kk] : 0.f;
    }
    if (lane < RW) {
        // tile::load_rows' norm: __fadd_rn / __fmul_rn over the features in order
        const int row = row0 + lane;
        const bool inside = row < n_rows;
        float s = 0.f;
        if (tile::needs_norms(kind, stat) && inside) {
            const float* xrow = xr + static_cast<size_t>(row) * m;
            for (int kk = 0; kk < m; ++kk) s = __fadd_rn(s, __fmul_rn(xrow[kk], xrow[kk]));
        }
        wr.sqr[lane] = s;
        wr.scl[lane] = adaptive && inside ? pol.scale_r[row] : 1.f;
    }
    for (int e = lane; e < RW * k; e += 32) lists[e] = -INFINITY;
    __syncwarp();
    float kth[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) kth[i] = -INFINITY;

#define GPIC_WALK(STAT, KIND, ADAPTIVE)                                                 \
    (m == 1 ? topk_walk<STAT, KIND, ADAPTIVE, 1>(xc, pol.scale_c, wr, kth, lists, n_rows, \
                                                 n_cols, k, stride, row0, row_offset,      \
                                                 col_offset, inv_two_sigma_sq, lane)       \
            : topk_walk<STAT, KIND, ADAPTIVE, MR>(xc, pol.scale_c, wr, kth, lists, n_rows, \
                                                  n_cols, k, stride, row0, row_offset,     \
                                                  col_offset, inv_two_sigma_sq, lane))
    using tile::COSINE;
    using tile::COSINE_SHIFTED;
    using tile::RBF;
    using tile::SIMILARITY;
    if (stat == tile::NEG_SQDIST) GPIC_WALK(tile::NEG_SQDIST, RBF, false);
    else if (kind == RBF && adaptive) GPIC_WALK(SIMILARITY, RBF, true);
    else if (kind == RBF) GPIC_WALK(SIMILARITY, RBF, false);
    else if (kind == COSINE_SHIFTED) GPIC_WALK(SIMILARITY, COSINE_SHIFTED, false);
    else GPIC_WALK(SIMILARITY, COSINE, false);
#undef GPIC_WALK

    __syncwarp();
    for (int e = lane; e < RW * k; e += 32) {
        const int i = e / k;
        if (row0 + i < n_rows) out[static_cast<size_t>(row0 + i) * k + (e - i * k)] = lists[e];
    }
}

// The register template's block stride: coprime with n_blocks, near
// n_blocks / phi, so that consecutive steps land far apart.
int golden_stride(int n_blocks) {
    int stride = static_cast<int>(0.6180339887498949 * n_blocks);
    if (stride < 1) stride = 1;
    const auto gcd = [](int a, int b) {
        while (b != 0) {
            const int t = a % b;
            a = b;
            b = t;
        }
        return a;
    };
    while (gcd(stride, n_blocks) != 1) ++stride;
    return stride;
}

}  // namespace

// scale_r / scale_c may be null (fixed bandwidth). 1 <= k <= 64.
extern "C" int gpic_row_topk(
    const float* xr, const float* xc, const float* scale_r, const float* scale_c,
    float* out, int n_rows, int n_cols, int m, int k, int row_offset, int col_offset,
    int kind, int stat, float inv_two_sigma_sq, cudaStream_t stream) {
    if (k < 1 || k > MAX_K || m < 1) return static_cast<int>(cudaErrorInvalidValue);
    const tile::Policy pol{scale_r, scale_c, nullptr, nullptr};
    if (m <= MR) {
        // RW k floats a warp: 8 KB a block at k = 64
        const size_t smem = sizeof(float) * RWARPS * RW * k;
        const int warps = (n_rows + RW - 1) / RW;
        row_topk_reg_kernel<<<(warps + RWARPS - 1) / RWARPS, RWARPS * 32, smem, stream>>>(
            xr, xc, pol, out, n_rows, n_cols, m, k, golden_stride((n_cols + 31) / 32),
            row_offset, col_offset, kind, stat, inv_two_sigma_sq);
        return static_cast<int>(cudaGetLastError());
    }
    const int kmax = m < tile::MC ? m : tile::MC;
    const size_t smem = sizeof(float) * (TN * (kmax + 1) + TM * kmax + TM * k + TM * TN);
    const bool policy = tile::has_policy(pol);
    const cudaError_t attr = policy
        ? cudaFuncSetAttribute(row_topk_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem))
        : cudaFuncSetAttribute(row_topk_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const int grid = (n_rows + TM - 1) / TM;
    if (policy)
        row_topk_kernel<true><<<grid, TN, smem, stream>>>(
            xr, xc, pol, out, n_rows, n_cols, m, k, row_offset, col_offset, kind, stat,
            inv_two_sigma_sq);
    else
        row_topk_kernel<false><<<grid, TN, smem, stream>>>(
            xr, xc, pol, out, n_rows, n_cols, m, k, row_offset, col_offset, kind, stat,
            inv_two_sigma_sq);
    return static_cast<int>(cudaGetLastError());
}
