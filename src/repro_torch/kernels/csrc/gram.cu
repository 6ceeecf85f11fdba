// Tall-skinny Gram G = V^T V for Hopper (sm_90a), V (n, c) f32, c <= 64.
//
// Replaces: src/repro/kernels/gram.py::gram (the Pallas TPU kernel
// _gram_kernel), which prices the Cholesky-QR of every orthogonal sweep
// and the subspace residual stopping rule ([V | U], so c up to 2r).
//
// Bound on an H100: the read of V, n c 4 bytes (0.11 us at n = 45,000,
// c = 2; 0.21 us at c = 4), against 2 n c^2 operations. At the power
// loop's shapes the kernel is latency-bound: one launch, one read of V and
// two dependent chains (a block's rows, then the block partials) cost more
// than either term.
//
// Design (one launch a call):
//  * Block b reduces the fixed, contiguous rows [b ROWS, (b + 1) ROWS):
//    one coalesced read stages them in shared memory (16-byte loads where
//    V is aligned), one barrier, then thread t adds the rows in row order
//    into entries t, t + 256, ... of a (c, c) partial, each entry an
//    unrolled fmaf chain from 0 with its operands loaded ahead. No barrier
//    a chunk.
//  * The finish runs in the same launch, in the last block to arrive: each
//    block writes its partial, __threadfence(), then takes an integer
//    atomicAdd ticket; the block that draws the last one adds the partials
//    in block order, from 0 (staged in shared memory FIN floats at a time),
//    writes G and resets the ticket to 0 for the next call.
//  * The ticket is one unsigned int that the wrapper allocates with zeros
//    once per (device, stream) and keeps (kernels/gram.py): calls on one
//    stream run one after another, so they never share it in flight, and
//    each leaves it at 0. The partials' scratch is kept the same way.
//  * No float atomics: the Gram feeds every QR and the residual rule, so it
//    gives the same bits on every run, and the same bits as the two-launch
//    kernel before it (the same association: rows in order within 256-row
//    blocks, then the partials in block order). fmaf(a, b, s) ==
//    fmaf(b, a, s), so G is exactly symmetric.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 256;    // rows per block (kernels/gram.py: ROWS_PER_BLOCK)
constexpr int MAX_C = 64;
constexpr int FIN = 4096;    // partial floats the last block stages at a time

// Entries a thread owns: Q = 1 up to c = 16, 4 up to 32, 16 up to 64.
template <int Q>
__global__ void __launch_bounds__(THREADS) gram_kernel(
    const float* __restrict__ v, float* __restrict__ part, unsigned* __restrict__ ticket,
    float* __restrict__ g, int n, int c) {
    extern __shared__ float smem[];  // max(ROWS c, FIN) floats
    __shared__ bool s_last;
    const int tid = threadIdx.x;
    const int cc = c * c;
    const int r0 = blockIdx.x * ROWS;
    const int len = min(ROWS, n - r0) * c;

    // the block's rows, contiguous in V: one coalesced read
    const float* src = v + static_cast<size_t>(r0) * c;
    int e0 = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        const int len4 = len >> 2;
        for (int e = tid; e < len4; e += THREADS)
            reinterpret_cast<float4*>(smem)[e] = reinterpret_cast<const float4*>(src)[e];
        e0 = len4 << 2;
    }
    for (int e = e0 + tid; e < len; e += THREADS) smem[e] = src[e];
    __syncthreads();

    int ii[Q], jj[Q];
    bool own[Q];
    float acc[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
        const int e = tid + q * THREADS;
        own[q] = e < cc;
        ii[q] = own[q] ? e / c : 0;
        jj[q] = own[q] ? e - ii[q] * c : 0;
        acc[q] = 0.f;
    }
    if (own[0]) {
        const int kc = len / c;
        if (Q == 1 && kc == ROWS) {
            // a full block: the chain unrolled whole, so its loads run ahead
#pragma unroll
            for (int k = 0; k < ROWS; ++k)
                acc[0] = fmaf(smem[k * c + ii[0]], smem[k * c + jj[0]], acc[0]);
        } else {
#pragma unroll 8
            for (int k = 0; k < kc; ++k) {
                const float* row = smem + k * c;
#pragma unroll
                for (int q = 0; q < Q; ++q)
                    if (own[q]) acc[q] = fmaf(row[ii[q]], row[jj[q]], acc[q]);
            }
        }
#pragma unroll
        for (int q = 0; q < Q; ++q)
            if (own[q]) part[static_cast<size_t>(blockIdx.x) * cc + tid + q * THREADS] = acc[q];
        __threadfence();  // the partial is visible to every block before the ticket
    }

    // the ticket: the last block to draw it finishes
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();

#pragma unroll
    for (int q = 0; q < Q; ++q) acc[q] = 0.f;
    const int per = max(1, FIN / cc);  // partials staged at a time
    for (int b0 = 0; b0 < static_cast<int>(gridDim.x); b0 += per) {
        const int nb = min(per, static_cast<int>(gridDim.x) - b0);
        __syncthreads();  // the previous partials (or the rows) have been consumed
        for (int e = tid; e < nb * cc; e += THREADS)
            smem[e] = __ldcg(part + static_cast<size_t>(b0) * cc + e);
        __syncthreads();
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            if (own[q]) {
                const float* p = smem + tid + q * THREADS;
                float s = acc[q];
#pragma unroll 32
                for (int b = 0; b < nb; ++b) s += p[b * cc];
                acc[q] = s;
            }
        }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q)
        if (own[q]) g[tid + q * THREADS] = acc[q];
    if (tid == 0) *ticket = 0u;
}

template <int Q>
int launch(const float* v, float* part, unsigned* ticket, float* g, int n, int c,
           cudaStream_t stream) {
    const int n_blocks = (n + ROWS - 1) / ROWS;
    const int floats = ROWS * c > FIN ? ROWS * c : FIN;
    const size_t smem = sizeof(float) * floats;
    if (smem > 48 * 1024) {
        const cudaError_t attr = cudaFuncSetAttribute(
            gram_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (attr != cudaSuccess) return static_cast<int>(attr);
    }
    gram_kernel<Q><<<n_blocks, THREADS, smem, stream>>>(v, part, ticket, g, n, c);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// part holds part_floats floats, at least ceil(n / 256) c^2; ticket is 0
// (and is left at 0).
extern "C" int gpic_gram(const float* v, float* part, unsigned* ticket, float* g, int n, int c,
                         long long part_floats, cudaStream_t stream) {
    if (c < 1 || c > MAX_C || n < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (static_cast<long long>((n + ROWS - 1) / ROWS) * c * c > part_floats)
        return static_cast<int>(cudaErrorInvalidValue);
    if (c <= 16) return launch<1>(v, part, ticket, g, n, c, stream);
    if (c <= 32) return launch<4>(v, part, ticket, g, n, c, stream);
    return launch<16>(v, part, ticket, g, n, c, stream);
}
