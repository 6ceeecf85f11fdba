// Fused affinity stripe + degree build for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/affinity.py::affinity_and_degree (the Pallas
// TPU kernel _affinity_kernel): cosine, cosine_shifted and rbf, with the
// graph-policy operands (adaptive scales scale_r / scale_c, the row
// threshold thr of a kNN truncation; null pointers for the dense fixed
// spec, whose bits do not change). It computes the (R, C) stripe
// A[row_offset:row_offset+R, col_offset:col_offset+C] of the masked
// similarity matrix and D, the stripe's row sums, in one pass.
//
// Bound on an H100: the write of A. At n = 45,000 A is n^2 * 4 B = 8.1 GB,
// about 2.4 ms at 3.35 TB/s; the features it reads are n * m * 4 B. The
// arithmetic (2m FMAs, the transform and, for rbf, one expf per entry;
// one compare more with a threshold) sits under that line. A truncated A
// is stored dense, zeros and all: the block-sparse route that stores and
// sweeps only its live tiles is a later kernel.
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
//  * The masked tile (feature slabs staged in chunks of 32, the fmaf dot
//    chain, the __f*_rn transform, the edge, diagonal and threshold masks)
//    is the shared code of affinity_tile.cuh, which streaming.cu and
//    row_topk.cu call too: a streamed tile is this kernel's stored tile,
//    and the threshold from row_topk.cu is one of its entries, bit for
//    bit.

#include "affinity_tile.cuh"

namespace {

constexpr int TM = 16;   // rows per block
using tile::TN;

template <bool POLICY>
__global__ void __launch_bounds__(TN) affinity_kernel(
    const float* __restrict__ xr, const float* __restrict__ xc,
    tile::Policy pol, float* __restrict__ a, float* __restrict__ d,
    int n_rows, int n_cols, int m, int row_offset, int col_offset,
    int kind, float inv_two_sigma_sq) {
    extern __shared__ float smem[];
    float* s_xc = smem;
    float* s_xr = smem + TN * (min(m, tile::MC) + 1);
    __shared__ tile::Rows<TM> s_rows;
    __shared__ float s_red[tile::NWARPS * TM];

    const int row0 = blockIdx.x * TM;
    const int col_t = threadIdx.x;
    tile::load_rows<TM>(xr, n_rows, m, row0, kind == tile::RBF, pol, s_rows);

    float rowsum[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) rowsum[r] = 0.f;

    for (int c0 = 0; c0 < n_cols; c0 += TN) {
        const int col = c0 + col_t;
        tile::masked_tile<TM, POLICY>(xr, xc, s_xc, s_xr, s_rows, row0, c0, c0 == 0, n_rows,
                              n_cols, m, row_offset, col_offset, kind, inv_two_sigma_sq, pol,
                              [&](int r, float v) {
            const int row = row0 + r;
            if (row < n_rows && col < n_cols) a[static_cast<size_t>(row) * n_cols + col] = v;
            rowsum[r] += v;
        });
    }

    // fixed-order reduction of the row sums: warp tree, then warps in order
    const float s = tile::block_reduce_fixed<TM>(rowsum, s_red);
    if (threadIdx.x < TM && row0 + threadIdx.x < n_rows) d[row0 + threadIdx.x] = s;
}

}  // namespace

// scale_r / scale_c / thr may be null (policy off).
extern "C" int gpic_affinity_and_degree(
    const float* xr, const float* xc, const float* scale_r, const float* scale_c,
    const float* thr, float* a, float* d,
    int n_rows, int n_cols, int m, int row_offset, int col_offset,
    int kind, float inv_two_sigma_sq, cudaStream_t stream) {
    const int grid = (n_rows + TM - 1) / TM;
    const tile::Policy pol{scale_r, scale_c, thr, nullptr};
    const size_t smem = tile::smem_bytes(TM, m);
    if (tile::has_policy(pol))
        affinity_kernel<true><<<grid, TN, smem, stream>>>(
            xr, xc, pol, a, d, n_rows, n_cols, m, row_offset, col_offset, kind,
            inv_two_sigma_sq);
    else
        affinity_kernel<false><<<grid, TN, smem, stream>>>(
            xr, xc, pol, a, d, n_rows, n_cols, m, row_offset, col_offset, kind,
            inv_two_sigma_sq);
    return static_cast<int>(cudaGetLastError());
}
