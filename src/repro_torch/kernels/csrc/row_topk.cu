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
// about 2e10 f32 operations, 0.3 ms at 67 TFLOP/s.
//
// Design:
//  * The scores are the build's entries bit for bit: tile::tile_scores of
//    affinity_tile.cuh, the code that affinity.cu stores and streaming.cu
//    folds, with the same thread-to-column layout. A threshold read from
//    the K-th score is then compared (a >= thr) with the very value the
//    build makes, so a row keeps K entries, or more only on an exact tie.
//  * The block shape of affinity.cu: TN = 256 threads, TM = 16 rows, the
//    column tiles in order. Each row keeps a descending list of K scores
//    in shared memory, and its last entry in s_kth.
//  * The TPU kernel merges each tile with K rounds of row-max; here a
//    thread offers its score to the row's candidate list (a shared atomic
//    slot) only when it beats the row's K-th, and after the tile one warp
//    per row inserts the candidates one by one (a ballot finds the place,
//    a shuffle shifts the tail). Once a list holds its K best, few scores
//    beat the K-th, so the selection costs little beside the scoring.
//  * Only values come out. A tie needs no rule: the multiset of the top K
//    values does not depend on which of two equal scores is kept, so the
//    output is torch.topk(...).values exactly. A NaN score is never kept
//    (torch.topk would rank it first); the front door refuses NaN features.

#include "affinity_tile.cuh"

namespace {

constexpr int TM = 16;     // rows per block
constexpr int MAX_K = 64;  // two list slots per lane
using tile::TN;

// Insert v into the descending list buf[0, k) when it beats buf[k - 1]. All
// 32 lanes of the warp call it with the same v (the test is warp-uniform).
__device__ __forceinline__ void insert_desc(float* buf, int k, float v, int lane) {
    if (!(v > buf[k - 1])) return;
    constexpr unsigned FULL = 0xffffffffu;
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

}  // namespace

// scale_r / scale_c may be null (fixed bandwidth). 1 <= k <= 64.
extern "C" int gpic_row_topk(
    const float* xr, const float* xc, const float* scale_r, const float* scale_c,
    float* out, int n_rows, int n_cols, int m, int k, int row_offset, int col_offset,
    int kind, int stat, float inv_two_sigma_sq, cudaStream_t stream) {
    if (k < 1 || k > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
    const int kmax = m < tile::MC ? m : tile::MC;
    const size_t smem = sizeof(float) * (TN * (kmax + 1) + TM * kmax + TM * k + TM * TN);
    const tile::Policy pol{scale_r, scale_c, nullptr, nullptr};
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
