// Fused affinity stripe + degree build for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/affinity.py::affinity_and_degree (the Pallas
// TPU kernel _affinity_kernel): cosine, cosine_shifted and rbf, with the
// graph-policy operands (adaptive scales scale_r / scale_c, the row
// threshold thr of a kNN truncation; null pointers for the dense fixed
// spec, whose bits do not change). It computes the (R, C) stripe
// A[row_offset:row_offset+R, col_offset:col_offset+C] of the masked
// similarity matrix and D, the stripe's row sums, in one pass. A is stored
// in f32 or, as the reference's out_dtype=bfloat16 (O4), in bf16: every
// entry is made and added to D in f32 exactly as for an f32 A, then rounded
// to nearest even as it is stored, so a bf16 A is bit for bit the f32 A
// rounded (astype) and D is the f32 call's D.
//
// Bound on an H100: the write of A. At n = 45,000 A is n^2 * 4 B = 8.1 GB,
// about 2.4 ms at 3.35 TB/s (bf16: 4.05 GB, 1.2 ms); the features it reads are n * m * 4 B. The
// arithmetic (2m FMAs, the transform and, for rbf, one expf per entry;
// one compare more with a threshold) sits under that line once no barrier
// or shared-memory slab paces each tile. Each expf takes one MUFU.EX2: a
// second floor of n^2 / (132 x 16 x 1.98 GHz) = 0.48 ms, where the row
// thresholds' skip test (below) lets it count only the entries made. A
// truncated A is stored dense, zeros and all; the block-sparse route
// sweeps only its live tiles (block_sparse.cu), and the explicit engine's
// one-pass build (core/graph.py::fused_affinity_build) calls this kernel
// without thr and masks the stored A in place.
//
// Design:
//  * One block of TN = 256 threads owns TM = 16 rows and loops over ALL
//    column tiles of TN columns. Thread t owns column c0 + t of each tile,
//    so every store of a row is 256 consecutive floats (coalesced, each
//    warp 32 x 4 contiguous bytes), and the 16 rows' partial sums stay in
//    registers for the whole sweep. No thread owns 4 adjacent columns: the
//    row sum adds columns t, t + 256, ... in order, the order that the
//    streamed degrees (streaming.cu, block_sparse.cu) and
//    ops.stored_degree match bit for bit.
//  * The TPU kernel carries D across its sequential column grid; Hopper
//    blocks run in no order, so the column loop lives inside the block
//    instead, and D is written once after a fixed-order block reduction
//    (warp tree, then the 8 warps in order). No atomics: D is the same from
//    run to run, which the power loop's stopping rule (accel <= 1e-5/n)
//    depends on.
//  * Two templates make the same entries (affinity_tile.cuh). The staged
//    one (any m) takes them from tile::masked_tile: per tile it stages the
//    column slab in shared memory between two barriers and tests every
//    entry's mask. The register one (m <= tile::MR, the paper's m = 2)
//    stages the block's rows once; each thread loads its own column's
//    features and policy operands one tile ahead into registers, so a tile
//    costs no barrier and its loads overlap the previous tile's stores;
//    only the warps on a ragged edge or on the global diagonal test the
//    mask (tile::tile_entries), and the score form is fixed per compiled
//    loop. Its stores take one of two paths, chosen by the launcher:
//     - bulk (rows of 16-byte multiples: n_cols % 4 == 0 in f32, % 8 in
//       bf16): each entry goes to a double-buffered 16 x 256 tile of the
//       stored type in shared memory (16 KB in bf16, 32 in f32), and once the
//       block has made the tile (one barrier), each of 16 threads writes
//       one row's 1 KB (bf16: 512 bytes) with a 1-D bulk copy (cp.async.bulk, the copy
//       engine of the TMA), waited on only before its buffer is reused;
//       whole 1 KB row segments wrote A faster than 128-byte warp stores
//       on an H100 (PERF.md section 6);
//     - register: each entry is stored as it is made, with the streaming
//       hint (__stcs: A is 160 times the 50 MB L2 and only the next pass
//       reads it), the 16 stores of a column independent of each other;
//       for ragged rows, and for adaptive scales without thresholds (the
//       fused build's call, whose divide sets its pace), where the bulk
//       path's barrier a tile measured slower.
//  * The register template's skip test: with row thresholds (rbf, the
//    two-pass route), an entry whose squared distance lies past a bound
//    derived from its row's threshold (tile::skip_bound) is provably
//    dropped, so it is stored as +0, the staged loop's dropped value,
//    without the clamp, scale, divide or expf (tile::col_entries' ZEROS
//    form). The row sums add that +0 as the staged loop does. Adaptive
//    scales without thresholds (the fused build's call) take a form with
//    no skip test (tile::THR_NONE), whose warp votes would find nothing
//    to skip on every entry. Both templates call tile::transform and
//    tile::keep_entry and add in the same order, so they give the same A
//    and D: the card check holds x against x with a zero feature column
//    appended past tile::MR, which takes the staged one.
//  * The masked tile is the shared code of affinity_tile.cuh, which
//    streaming.cu, row_topk.cu and block_sparse.cu call too: a streamed
//    tile is this kernel's stored tile, and the threshold from row_topk.cu
//    is one of its entries, bit for bit.

#include "affinity_tile.cuh"

namespace {

constexpr int TM = 16;   // rows per block
using tile::TN;

template <bool POLICY, typename T>
__global__ void __launch_bounds__(TN) affinity_kernel(
    const float* __restrict__ xr, const float* __restrict__ xc,
    tile::Policy pol, T* __restrict__ a, float* __restrict__ d,
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
            if (row < n_rows && col < n_cols)
                a[static_cast<size_t>(row) * n_cols + col] = from_f32<T>(v);
            tile::add_entry(rowsum[r], v);
        });
    }

    // fixed-order reduction of the row sums: warp tree, then warps in order
    const float s = tile::block_reduce_fixed<TM>(rowsum, s_red);
    if (threadIdx.x < TM && row0 + threadIdx.x < n_rows) d[row0 + threadIdx.x] = s;
}

// Write bytes from shared memory at src to global memory at dst with a 1-D
// bulk copy, committed as a bulk group of its own (both 16-byte aligned,
// bytes a multiple of 16).
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(src));
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 :: "l"(dst), "r"(s), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// The register template (m <= tile::MR): streaming.cu's degree template with
// each entry also stored, by bulk copies of the tile's rows (BULK) or by
// register stores, and with the entries the skip test drops stored as +0
// (tile_entries' ZEROS form); affinity_kernel above is the staged template
// (any m). They give the same A and D.
template <bool POLICY, bool BULK, typename T>
__global__ void __launch_bounds__(TN, 2) affinity_reg_kernel(
    const float* __restrict__ xr, const float* __restrict__ xc,
    tile::Policy pol, T* __restrict__ a, float* __restrict__ d,
    int n_rows, int n_cols, int m, int row_offset, int col_offset,
    int kind, float inv_two_sigma_sq) {
    // two tiles' rows, as raw bytes (a __shared__ array may not be of a type
    // with constructors)
    __shared__ __align__(128) unsigned char s_bytes[(BULK ? 2 * TM * TN : 1) * sizeof(T)];
    T* s_tile = reinterpret_cast<T*>(s_bytes);
    __shared__ __align__(16) tile::Rows<TM> s_rows;
    __shared__ tile::RowFeats<TM> s_rf;
    __shared__ __align__(16) float s_bound[TM];
    __shared__ float s_red[tile::NWARPS * TM];

    const int row0 = blockIdx.x * TM;
    tile::load_rows<TM>(xr, n_rows, m, row0, kind == tile::RBF, pol, s_rows);
    tile::load_row_feats<TM>(xr, n_rows, m, row0, s_rf);
    tile::load_skip_bounds<TM>(pol, s_rows, inv_two_sigma_sq, s_bound);
    __syncthreads();

    const int rows_in = n_rows - row0;   // the block's rows inside the stripe
    // bulk: thread i < TM copies row row0 + i; register: thread t stores column t
    const bool copier = BULK && static_cast<int>(threadIdx.x) < min(TM, rows_in);
    T* a_thread = a + static_cast<size_t>(row0 + (BULK ? threadIdx.x : 0)) * n_cols
                      + (BULK ? 0 : threadIdx.x);
    float rowsum[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) rowsum[r] = 0.f;

    const auto build = [&](auto form) {
        using Form = decltype(form);
        tile::Col<1> cur, nxt;  // r = 0: the features and scale alone
        tile::load_col<1, POLICY>(xc, nullptr, pol, threadIdx.x, n_cols, m, 0, cur);
        int buf = 0;
        for (int c0 = 0; c0 < n_cols; c0 += TN) {
            tile::load_col<1, POLICY>(xc, nullptr, pol, c0 + TN + threadIdx.x, n_cols, m, 0,
                                      nxt);
            if constexpr (BULK) {
                T* s_col = s_tile + buf * (TM * TN) + threadIdx.x;
                tile::tile_entries<TM, Form, POLICY, true>(
                    cur, s_rf, s_rows, s_bound, m, inv_two_sigma_sq, pol, row0, c0, n_rows,
                    n_cols, row_offset, col_offset, [&](int i, float v) {
                        s_col[i * TN] = from_f32<T>(v);
                        tile::add_entry(rowsum[i], v);
                    });
                // the tile's writes visible to the copy engine, and the copy
                // that read this buffer two tiles ago done reading
                asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
                if (copier) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
                __syncthreads();
                if (copier)
                    bulk_store(a_thread + c0, s_tile + buf * (TM * TN) + threadIdx.x * TN,
                               static_cast<int>(sizeof(T)) * min(TN, n_cols - c0));
                buf ^= 1;
            } else {
                T* a_col = a_thread + c0;
                tile::tile_entries<TM, Form, POLICY, true>(
                    cur, s_rf, s_rows, s_bound, m, inv_two_sigma_sq, pol, row0, c0, n_rows,
                    n_cols, row_offset, col_offset, [&](int i, float v) {
                        if (i < rows_in) stcs_f32(a_col + static_cast<size_t>(i) * n_cols, v);
                        tile::add_entry(rowsum[i], v);
                    });
            }
            cur = nxt;
        }
    };
    // adaptive scales without thresholds (the fused build's call): a form of
    // its own, without the skip test's votes, which have nothing to skip
    // there and measured a third of its time
    if constexpr (POLICY) {
        if (kind == tile::RBF && pol.scale_r != nullptr && pol.thr == nullptr)
            build(tile::Form<tile::RBF, true, tile::THR_NONE>{});
        else
            tile::with_form<POLICY>(kind, pol, build);
    } else {
        tile::with_form<POLICY>(kind, pol, build);
    }
    // the shared buffers live until the last copy has read them
    if (copier) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");

    const float s = tile::block_reduce_fixed<TM>(rowsum, s_red);
    if (threadIdx.x < TM && row0 + threadIdx.x < n_rows) d[row0 + threadIdx.x] = s;
}

template <typename T>
int launch(const float* xr, const float* xc, const float* scale_r, const float* scale_c,
           const float* thr, T* a, float* d, int n_rows, int n_cols, int m, int row_offset,
           int col_offset, int kind, float inv_two_sigma_sq, cudaStream_t stream) {
    const int grid = (n_rows + TM - 1) / TM;
    const tile::Policy pol{scale_r, scale_c, thr, nullptr};
    const bool policy = tile::has_policy(pol);
#define GPIC_ARGS xr, xc, pol, a, d, n_rows, n_cols, m, row_offset, col_offset, kind, \
                  inv_two_sigma_sq
    if (m > tile::MR) {
        const size_t smem = tile::smem_bytes(TM, m);
        if (policy) affinity_kernel<true, T><<<grid, TN, smem, stream>>>(GPIC_ARGS);
        else affinity_kernel<false, T><<<grid, TN, smem, stream>>>(GPIC_ARGS);
    } else {
        // bulk copies need 16-byte rows (n_cols a multiple of 4 in f32, of
        // 8 in bf16); E2's fused form (scales, no thr) keeps the register
        // stores (affinity_reg_kernel)
        const bool bulk = (static_cast<size_t>(n_cols) * sizeof(T)) % 16 == 0
                          && reinterpret_cast<uintptr_t>(a) % 16 == 0
                          && !(scale_r != nullptr && thr == nullptr);
        if (policy && bulk) affinity_reg_kernel<true, true, T><<<grid, TN, 0, stream>>>(GPIC_ARGS);
        else if (policy) affinity_reg_kernel<true, false, T><<<grid, TN, 0, stream>>>(GPIC_ARGS);
        else if (bulk) affinity_reg_kernel<false, true, T><<<grid, TN, 0, stream>>>(GPIC_ARGS);
        else affinity_reg_kernel<false, false, T><<<grid, TN, 0, stream>>>(GPIC_ARGS);
    }
#undef GPIC_ARGS
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scale_r / scale_c / thr may be null (policy off). a is float, or
// __nv_bfloat16 where a_bf16 is nonzero.
extern "C" int gpic_affinity_and_degree(
    const float* xr, const float* xc, const float* scale_r, const float* scale_c,
    const float* thr, void* a, float* d,
    int n_rows, int n_cols, int m, int row_offset, int col_offset,
    int kind, float inv_two_sigma_sq, int a_bf16, cudaStream_t stream) {
    if (a_bf16)
        return launch(xr, xc, scale_r, scale_c, thr, static_cast<__nv_bfloat16*>(a), d, n_rows,
                      n_cols, m, row_offset, col_offset, kind, inv_two_sigma_sq, stream);
    return launch(xr, xc, scale_r, scale_c, thr, static_cast<float*>(a), d, n_rows, n_cols, m,
                  row_offset, col_offset, kind, inv_two_sigma_sq, stream);
}
