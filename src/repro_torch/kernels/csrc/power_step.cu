// Degree-normalized mat-mat sweep for Hopper (sm_90a):
//     U = (A V) / max(d, 1e-30),  A (R, C) f32, V (C, r) f32, d (R,) f32.
//
// Replaces: src/repro/kernels/power_step.py::degree_normalized_matmat (the
// Pallas TPU kernel _power_step_kernel), which runs once per power sweep.
//
// Bound on an H100: the read of A. At n = 45,000 that is 8.1 GB per sweep,
// about 2.4 ms at 3.35 TB/s; V, d and U are O(n r) and the 2 n^2 r flops
// are far under the line at r <= 32.
//
// Design:
//  * One block of 256 threads per row of A, or per ROWS rows (Ring below).
//    Each row's sum has one fixed order: thread t accumulates its r
//    partials in registers over columns t, t + 256, ... in order; the block
//    reduces them with a shfl_down tree from 16 to 1 and adds the 8 warps in
//    order. So U is bit for bit the U of the block-sparse sweep
//    (block_sparse.cu) and of the streamed sweep, whatever ROWS, and the
//    same from run to run (no atomics).
//  * The rows stream through a ring of STAGES shared-memory stages of CH
//    columns, filled by 16-byte cp.async (one instruction moves 4 columns,
//    and STAGES - 1 stages are in flight while a thread sums the current
//    one), so each SM keeps enough of A's bytes in flight to run at the
//    memory's rate. Thread t reads its own columns of a stage back in order,
//    so the bits are those of a plain load of each column.
//  * Rows that do not start on 16 bytes (C not a multiple of 4, or an
//    unaligned A) take the plain-load template of the same kernel, chosen
//    by the wrapper: one row a block, four scalar loads in flight per
//    thread, through the streaming cache hint so A does not evict V from
//    L2.
//  * r is a template bound RT in {1, 2, 4, 8, 16, 32} so the partials stay
//    in registers; the wrapper rejects r > 32.
//  * The epilogue is the floored divide the reference pins
//    (u / max(d, 1e-30), NaN degrees propagate).

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int UNROLL = 4;  // plain-load template: loads in flight per thread

// The ring's shape for r <= RT: rows a block, columns a stage, stages.
// From r = 2 on, V's loads outweigh A's, so a block takes 4 rows and each V
// value it loads serves all of them (from r = 16 one row again, for the
// partials' registers); 24 or 32 KB a block keep 7 or 8 blocks on an SM.
template <int RT> struct Ring {
    static constexpr int ROWS = RT == 1 || RT >= 16 ? 1 : 4;
    static constexpr int CH = 2048 / ROWS;
    static constexpr int STAGES = ROWS == 1 ? 3 : 4;
    static constexpr int BYTES = STAGES * ROWS * CH * 4;
    static_assert(CH % THREADS == 0, "whole columns per thread");
};

// acc[i] += a_i V[j, :r] for the ROWS values a_i of column j
template <int RT, int ROWS>
__device__ __forceinline__ void add_column(float (&acc)[ROWS][RT], const float (&aj)[ROWS],
                                           const float* v, int j, int r) {
    const float* vrow = v + static_cast<size_t>(j) * r;
    float vv[RT];
#pragma unroll
    for (int c = 0; c < RT; ++c) vv[c] = c < r ? vrow[c] : 0.f;
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int c = 0; c < RT; ++c)
            if (c < r) acc[i][c] = fmaf(aj[i], vv[c], acc[i][c]);
}

template <int RT, bool RING>
__global__ void __launch_bounds__(THREADS) power_step_kernel(
    const float* __restrict__ a, const float* __restrict__ v,
    const float* __restrict__ d, float* __restrict__ u,
    int n_rows, int n_cols, int r) {
    constexpr int ROWS = RING ? Ring<RT>::ROWS : 1;
    extern __shared__ float4 ring4[];
    __shared__ float s_red[NWARPS][ROWS][RT];
    const int row0 = blockIdx.x * ROWS;
    const int nr = min(ROWS, n_rows - row0);
    const int tid = threadIdx.x;

    float acc[ROWS][RT];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int c = 0; c < RT; ++c) acc[i][c] = 0.f;

    if constexpr (RING) {
        // stage k holds columns [k CH, (k + 1) CH) of the block's rows, as
        // 16-byte pieces; a piece past the row's end (or a row past the
        // last) is zero-filled and never read
        constexpr int CH = Ring<RT>::CH, STAGES = Ring<RT>::STAGES;
        float* ring = reinterpret_cast<float*>(ring4);
        const int n_ch = (n_cols + CH - 1) / CH;
        auto fill = [&](int k) {
            float* slot = ring + (k % STAGES) * ROWS * CH;
#pragma unroll
            for (int i = 0; i < ROWS; ++i) {
                const float* arow = a + static_cast<size_t>(row0 + min(i, nr - 1)) * n_cols;
#pragma unroll
                for (int p = tid; p < CH / 4; p += THREADS) {
                    const int j = k * CH + 4 * p;
                    const bool ok = i < nr && j < n_cols;
                    cp_async16(slot + i * CH + 4 * p, ok ? arow + j : arow, ok ? 16 : 0);
                }
            }
        };
#pragma unroll
        for (int k = 0; k < STAGES - 1; ++k) {
            if (k < n_ch) fill(k);
            cp_async_commit();
        }
        for (int k = 0; k < n_ch; ++k) {
            if (k + STAGES - 1 < n_ch) fill(k + STAGES - 1);
            cp_async_commit();
            cp_async_wait<STAGES - 1>();  // stage k has landed for this thread ...
            __syncthreads();              // ... and for every thread
            const float* slot = ring + (k % STAGES) * ROWS * CH;
            const int j0 = k * CH;
#pragma unroll
            for (int q = 0; q < CH / THREADS; ++q) {
                const int j = j0 + tid + q * THREADS;
                if (j0 + CH > n_cols && j >= n_cols) break;
                float aj[ROWS];
#pragma unroll
                for (int i = 0; i < ROWS; ++i) aj[i] = slot[i * CH + tid + q * THREADS];
                add_column(acc, aj, v, j, r);
            }
            __syncthreads();  // every thread is done with the stage before it is refilled
        }
    } else {
        const float* arow = a + static_cast<size_t>(row0) * n_cols;
        int j = tid;
        for (; j + (UNROLL - 1) * THREADS < n_cols; j += UNROLL * THREADS) {
            float av[UNROLL];
#pragma unroll
            for (int q = 0; q < UNROLL; ++q) av[q] = __ldcs(arow + j + q * THREADS);
#pragma unroll
            for (int q = 0; q < UNROLL; ++q) {
                const float aj[1] = {av[q]};
                add_column(acc, aj, v, j + q * THREADS, r);
            }
        }
        for (; j < n_cols; j += THREADS) {
            const float aj[1] = {__ldcs(arow + j)};
            add_column(acc, aj, v, j, r);
        }
    }

    const int lane = tid & 31;
    const int warp = tid >> 5;
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int c = 0; c < RT; ++c) {
            float s = acc[i][c];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
            if (lane == 0) s_red[warp][i][c] = s;
        }
    __syncthreads();
    for (int e = tid; e < nr * r; e += THREADS) {
        const int i = e / r, c = e - i * r;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) s += s_red[w][i][c];
        u[static_cast<size_t>(row0 + i) * r + c] = __fdiv_rn(s, nan_max(d[row0 + i], 1e-30f));
    }
}

template <int RT>
int launch(const float* a, const float* v, const float* d, float* u,
           int n_rows, int n_cols, int r, bool ring, cudaStream_t stream) {
    if (!ring) {
        power_step_kernel<RT, false><<<n_rows, THREADS, 0, stream>>>(a, v, d, u, n_rows, n_cols, r);
        return static_cast<int>(cudaGetLastError());
    }
    using R = Ring<RT>;
    auto kernel = power_step_kernel<RT, true>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           R::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<(n_rows + R::ROWS - 1) / R::ROWS, THREADS, R::BYTES, stream>>>(a, v, d, u, n_rows,
                                                                              n_cols, r);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ring: every row of A starts on 16 bytes (A's address and 4 C bytes are
// multiples of 16), so it streams through the cp.async ring; 0 takes the
// plain-load template.
extern "C" int gpic_degree_normalized_matmat(
    const float* a, const float* v, const float* d, float* u,
    int n_rows, int n_cols, int r, int ring, cudaStream_t stream) {
    const bool rg = ring != 0;
    if (r <= 1) return launch<1>(a, v, d, u, n_rows, n_cols, r, rg, stream);
    if (r <= 2) return launch<2>(a, v, d, u, n_rows, n_cols, r, rg, stream);
    if (r <= 4) return launch<4>(a, v, d, u, n_rows, n_cols, r, rg, stream);
    if (r <= 8) return launch<8>(a, v, d, u, n_rows, n_cols, r, rg, stream);
    if (r <= 16) return launch<16>(a, v, d, u, n_rows, n_cols, r, rg, stream);
    if (r <= 32) return launch<32>(a, v, d, u, n_rows, n_cols, r, rg, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}
