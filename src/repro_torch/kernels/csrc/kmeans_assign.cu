// k-means assignment step for Hopper (sm_90a): for each point the index of
// the nearest centroid (first index on ties) and the squared distance.
//
// Replaces: src/repro/kernels/kmeans_assign.py::kmeans_assign (the Pallas
// TPU kernel _assign_kernel), launched kmeans_iters + 1 times per run.
//
// Bound on an H100: launch latency. The main path gives it n = 45,000
// points of dim 1 and k = 4 centroids: it reads ~0.2 MB and writes
// ~0.4 MB, a fraction of a microsecond at 3.35 TB/s, far below the few
// microseconds any launch takes.
//
// Design:
//  * One thread per point, no (n, k) distance matrix in memory. The
//    centroids and their squared norms sit in shared memory, loaded once
//    per block.
//  * Distances use the expansion form of the reference,
//    (|x|^2 + |c|^2) - 2 x.c, each step rounded as the plain version
//    rounds it, so near-ties resolve as they do there.
//  * The running minimum is updated with a strict <, so the first index
//    wins on ties, as argmin does. The loop bound over the k real
//    centroids takes the place of the TPU kernel's +inf lane padding.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) kmeans_assign_kernel(
    const float* __restrict__ x, const float* __restrict__ cents,
    int* __restrict__ labels, float* __restrict__ dists,
    int n, int k, int dim) {
    extern __shared__ float smem[];  // s_c[k * dim], then s_csq[k]
    float* s_c = smem;
    float* s_csq = smem + k * dim;
    for (int e = threadIdx.x; e < k * dim; e += THREADS) s_c[e] = cents[e];
    __syncthreads();
    for (int j = threadIdx.x; j < k; j += THREADS) {
        float s = 0.f;
        for (int q = 0; q < dim; ++q)
            s = __fadd_rn(s, __fmul_rn(s_c[j * dim + q], s_c[j * dim + q]));
        s_csq[j] = s;
    }
    __syncthreads();

    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    const float* xi = x + static_cast<size_t>(i) * dim;
    float xx = 0.f;
    for (int q = 0; q < dim; ++q) xx = __fadd_rn(xx, __fmul_rn(xi[q], xi[q]));

    float best = 0.f;
    int lab = 0;
    for (int j = 0; j < k; ++j) {
        float dot = 0.f;
        for (int q = 0; q < dim; ++q) dot = fmaf(xi[q], s_c[j * dim + q], dot);
        const float d2 = __fsub_rn(__fadd_rn(xx, s_csq[j]), __fmul_rn(2.0f, dot));
        if (j == 0 || d2 < best) {
            best = d2;
            lab = j;
        }
    }
    labels[i] = lab;
    dists[i] = best;
}

}  // namespace

extern "C" int gpic_kmeans_assign(
    const float* x, const float* cents, int* labels, float* dists,
    int n, int k, int dim, cudaStream_t stream) {
    const size_t smem = sizeof(float) * (static_cast<size_t>(k) * dim + k);
    const int grid = (n + THREADS - 1) / THREADS;
    kmeans_assign_kernel<<<grid, THREADS, smem, stream>>>(x, cents, labels, dists, n, k, dim);
    return static_cast<int>(cudaGetLastError());
}
