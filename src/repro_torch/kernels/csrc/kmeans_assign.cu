// k-means assignment step for Hopper (sm_90a): for each point the index of
// the nearest centroid and the squared distance, with argmin's rules for
// ties and NaNs.
//
// Replaces: src/repro/kernels/kmeans_assign.py::kmeans_assign (the Pallas
// TPU kernel _assign_kernel), launched kmeans_iters + 1 times per run.
//
// Bound on an H100: the launch. The main path gives it n = 45,000 points
// of dim 1 and k = 4 centroids: it reads ~0.2 MB and writes ~0.4 MB, a
// fraction of a microsecond at 3.35 TB/s, below the time of the smallest
// kernel the card runs. So the design shortens the dependent chain inside
// the launch: one DRAM round trip, no barrier.
//
// Arithmetic, the same in both forms, bit for bit: |x|^2 and |c|^2 are
// __fadd_rn chains of __fmul_rn squares over q from 0, each dot product an
// fmaf chain over q from 0, and d2 = (|x|^2 + |c|^2) - 2 x.c with one
// rounding a step, the plain version's expansion. The minimum is scanned
// in j order with takes() (partial minima combined with beats()): the
// first NaN wins with its NaN, else the first minimum (strict <); a point
// whose distances are all NaN gets label 0. That is jnp.argmin /
// jnp.min, and torch.argmin / torch.amin. The loop bound over the k real
// centroids takes the place of the TPU kernel's +inf lane padding.
//
// Two forms, picked by the launcher on dim and k * dim:
//  * small (1 <= dim <= SMALL_DIM, k dim <= SMALL_FLOATS), the GPIC paths'
//    shapes (classic dim 1, orthogonal dim 2, ensemble dim 4; k 3-4): each
//    thread takes PTS consecutive points and issues their loads first (dim
//    float4 loads where x is 16-byte aligned), then reads the centroids
//    through the read-only path into registers (every lane reads the same
//    address: a broadcast) and computes each |c|^2 itself. Labels and
//    distances go out as one int4 and one float4. No shared memory and no
//    barrier: the launch, one round trip to memory, the stores. DIM is a
//    template parameter, so every loop unrolls.
//  * general (any k and dim): 128 points a block. Chunks of DQ features of
//    the block's points and of CK centroids stream through shared memory,
//    double-buffered with cp.async. Each thread owns GP points and GC of
//    the chunk's centroids (one of GROUPS centroid groups) and carries their
//    GP x GC dot products in registers across the feature chunks: each
//    float4 it reads from shared memory feeds 16 or 32 fmaf (with one
//    point a thread, 17 reads a 64 fmaf, the reads set the pace). It
//    scans its centroids in j order; the GROUPS partial minima of a point,
//    in adjacent lanes, are combined with beats() by two shuffles. The
//    points' chunks are staged again for each centroid chunk (from L2),
//    which keeps shared memory fixed (46 KB) for any k and dim.

#include "common.cuh"

namespace {

constexpr int SMALL_DIM = 8;        // the widest dim of the small form
constexpr int SMALL_FLOATS = 64;    // its budget of centroid registers, k * dim
constexpr int SMALL_THREADS = 256;
constexpr int PTS = 4;              // points a thread of the small form

constexpr int GEN_THREADS = 128;
constexpr int GROUPS = 4;           // threads that share a point, one centroid group each
constexpr int PG = GEN_THREADS / GROUPS;   // point groups of a block
constexpr int GP = 4;               // points a thread: pg + PG p
constexpr int GC = 8;               // centroids a thread in a chunk: g + GROUPS m
constexpr int BP = PG * GP;         // points a block (128)
constexpr int CK = GROUPS * GC;     // centroids a chunk (32)
constexpr int DQ = 32;              // features a chunk
constexpr int RS = DQ + 4;          // row stride of the staged rows: 16-byte rows, and
                                    // the float4 reads of a warp fall in distinct banks
constexpr int STAGE = (BP + CK) * RS;   // floats of one buffer
constexpr int GEN_BYTES = static_cast<int>(sizeof(float)) * (2 * STAGE + CK);
static_assert(GEN_BYTES <= 48 * 1024, "the general form stays in static shared memory");

// A scan in j order: does d2 replace the best so far (first: none yet)? A
// NaN replaces a number, a smaller number a larger one; an equal value or
// a later NaN does not. That is argmin's and min's result: the first NaN
// with its NaN, else the first minimum; all NaN: label 0.
__device__ __forceinline__ bool takes(float d2, float best, bool first) {
    return first || d2 < best || (isnan(d2) && !isnan(best));
}

// Combining two partial results of such scans, in any order: does b, of
// centroid lb, beat a, of centroid la (-1: none)? As in the scan, with
// equal values or two NaNs going to the lower index.
__device__ __forceinline__ bool beats(float b, int lb, float a, int la) {
    if (lb < 0) return false;
    if (la < 0) return true;
    if (isnan(b) || isnan(a)) return isnan(b) && (!isnan(a) || lb < la);
    return b < a || (b == a && lb < la);
}

__device__ __forceinline__ float sq_dist(float xx, float csq, float dot) {
    return __fsub_rn(__fadd_rn(xx, csq), __fmul_rn(2.0f, dot));
}

// VEC: x, labels and dists start on 16 bytes, so a full group of PTS
// points moves as float4 and int4.
template <int DIM, bool VEC>
__global__ void __launch_bounds__(SMALL_THREADS) kmeans_assign_small_kernel(
    const float* __restrict__ x, const float* __restrict__ cents,
    int* __restrict__ labels, float* __restrict__ dists, int n, int k) {
    constexpr int KMAX = SMALL_FLOATS / DIM;
    const int i0 = (blockIdx.x * SMALL_THREADS + threadIdx.x) * PTS;
    if (i0 >= n) return;
    const int cnt = min(PTS, n - i0);
    const bool vec = VEC && cnt == PTS;
    const float* xi = x + static_cast<size_t>(i0) * DIM;

    // the points first: PTS * DIM consecutive floats
    float xv[PTS * DIM];
    if (vec) {
#pragma unroll
        for (int v = 0; v < DIM; ++v) {
            const float4 t = __ldg(reinterpret_cast<const float4*>(xi) + v);
            xv[4 * v] = t.x;
            xv[4 * v + 1] = t.y;
            xv[4 * v + 2] = t.z;
            xv[4 * v + 3] = t.w;
        }
    } else {
#pragma unroll
        for (int e = 0; e < PTS * DIM; ++e) xv[e] = e < cnt * DIM ? __ldg(xi + e) : 0.f;
    }
    // then the centroids, all in flight together
    float c[KMAX * DIM];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
        if (j >= k) break;
#pragma unroll
        for (int q = 0; q < DIM; ++q) c[j * DIM + q] = __ldg(cents + j * DIM + q);
    }

    float xx[PTS], best[PTS];
    int lab[PTS];
#pragma unroll
    for (int p = 0; p < PTS; ++p) {
        xx[p] = 0.f;
#pragma unroll
        for (int q = 0; q < DIM; ++q)
            xx[p] = __fadd_rn(xx[p], __fmul_rn(xv[p * DIM + q], xv[p * DIM + q]));
        best[p] = 0.f;
        lab[p] = 0;
    }
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
        if (j >= k) break;
        float csq = 0.f;
#pragma unroll
        for (int q = 0; q < DIM; ++q)
            csq = __fadd_rn(csq, __fmul_rn(c[j * DIM + q], c[j * DIM + q]));
#pragma unroll
        for (int p = 0; p < PTS; ++p) {
            float dot = 0.f;
#pragma unroll
            for (int q = 0; q < DIM; ++q) dot = fmaf(xv[p * DIM + q], c[j * DIM + q], dot);
            const float d2 = sq_dist(xx[p], csq, dot);
            if (takes(d2, best[p], j == 0)) {
                best[p] = d2;
                lab[p] = j;
            }
        }
    }

    if (vec) {
        *reinterpret_cast<int4*>(labels + i0) = make_int4(lab[0], lab[1], lab[2], lab[3]);
        *reinterpret_cast<float4*>(dists + i0) = make_float4(best[0], best[1], best[2], best[3]);
    } else {
#pragma unroll
        for (int p = 0; p < PTS; ++p) {
            if (p < cnt) {
                labels[i0 + p] = lab[p];
                dists[i0 + p] = best[p];
            }
        }
    }
}

// Stage features [q0, q0 + DQ) of the block's BP points (rows row0..) and
// of centroids [c0, c0 + CK) into buf, one row of RS floats each, points
// first; what lies past n, k or dim is zero-filled and never read as a real
// feature. VEC: dim % 4 == 0 and both bases 16-byte aligned, so every row
// is too.
template <bool VEC>
__device__ __forceinline__ void stage_chunk(float* buf, const float* x, const float* cents,
                                            int row0, int n, int k, int dim, int c0,
                                            int q0) {
    constexpr int W = VEC ? 4 : 1;      // floats a copy
    constexpr int V = DQ / W;           // copies a row
    for (int e = threadIdx.x; e < (BP + CK) * V; e += GEN_THREADS) {
        const int r = e / V, q = W * (e % V);
        const bool point = r < BP;
        const int row = point ? row0 + r : c0 + r - BP;
        const float* base = point ? x : cents;
        const bool in = row < (point ? n : k) && q0 + q < dim;
        const float* src = in ? base + static_cast<size_t>(row) * dim + q0 + q : base;
        if (VEC)
            cp_async16(buf + r * RS + q, src, in ? 16 : 0);
        else
            cp_async4(buf + r * RS + q, src, in ? 4 : 0);
    }
}

template <bool VEC>
__global__ void __launch_bounds__(GEN_THREADS) kmeans_assign_general_kernel(
    const float* __restrict__ x, const float* __restrict__ cents,
    int* __restrict__ labels, float* __restrict__ dists, int n, int k, int dim) {
    extern __shared__ __align__(16) float smem[];  // two buffers, then s_csq[CK]
    float* s_csq = smem + 2 * STAGE;
    const int tid = threadIdx.x;
    const int g = tid % GROUPS, pg = tid / GROUPS;   // centroid group, point group
    const int row0 = blockIdx.x * BP;
    const int nq = dim > 0 ? (dim + DQ - 1) / DQ : 1;
    const int stages = nq * ((k + CK - 1) / CK);   // centroid chunks outer, features inner

    stage_chunk<VEC>(smem, x, cents, row0, n, k, dim, 0, 0);
    cp_async_commit();
    float xx[GP], best[GP], dot[GP][GC];
    int lab[GP];
#pragma unroll
    for (int p = 0; p < GP; ++p) {
        xx[p] = 0.f;
        best[p] = 0.f;
        lab[p] = -1;
    }
    float csq = 0.f;
    for (int s = 0; s < stages; ++s) {
        const int cc = s / nq, qc = s - cc * nq;
        if (s + 1 < stages) {
            const int c1 = (s + 1) / nq, q1 = s + 1 - c1 * nq;
            stage_chunk<VEC>(smem + ((s + 1) & 1) * STAGE, x, cents, row0, n, k, dim, c1 * CK,
                             q1 * DQ);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const float* buf = smem + (s & 1) * STAGE;
        const float* cs = buf + BP * RS;
        const int qn = min(DQ, dim - qc * DQ);
        if (qc == 0) {
#pragma unroll
            for (int p = 0; p < GP; ++p)
#pragma unroll
                for (int m = 0; m < GC; ++m) dot[p][m] = 0.f;
        }
        int q = 0;
        for (; q + 4 <= qn; q += 4) {
            float4 xq[GP];
#pragma unroll
            for (int p = 0; p < GP; ++p) {
                xq[p] = *reinterpret_cast<const float4*>(buf + (pg + PG * p) * RS + q);
                if (cc == 0) {
                    xx[p] = __fadd_rn(xx[p], __fmul_rn(xq[p].x, xq[p].x));
                    xx[p] = __fadd_rn(xx[p], __fmul_rn(xq[p].y, xq[p].y));
                    xx[p] = __fadd_rn(xx[p], __fmul_rn(xq[p].z, xq[p].z));
                    xx[p] = __fadd_rn(xx[p], __fmul_rn(xq[p].w, xq[p].w));
                }
            }
#pragma unroll
            for (int m = 0; m < GC; ++m) {
                const float4 cq =
                    *reinterpret_cast<const float4*>(cs + (g + GROUPS * m) * RS + q);
#pragma unroll
                for (int p = 0; p < GP; ++p) {
                    dot[p][m] = fmaf(xq[p].x, cq.x, dot[p][m]);
                    dot[p][m] = fmaf(xq[p].y, cq.y, dot[p][m]);
                    dot[p][m] = fmaf(xq[p].z, cq.z, dot[p][m]);
                    dot[p][m] = fmaf(xq[p].w, cq.w, dot[p][m]);
                }
            }
        }
        for (; q < qn; ++q) {
            float xq[GP];
#pragma unroll
            for (int p = 0; p < GP; ++p) {
                xq[p] = buf[(pg + PG * p) * RS + q];
                if (cc == 0) xx[p] = __fadd_rn(xx[p], __fmul_rn(xq[p], xq[p]));
            }
#pragma unroll
            for (int m = 0; m < GC; ++m) {
                const float cq = cs[(g + GROUPS * m) * RS + q];
#pragma unroll
                for (int p = 0; p < GP; ++p) dot[p][m] = fmaf(xq[p], cq, dot[p][m]);
            }
        }
        if (tid < CK) {   // |c|^2 of centroid cc * CK + tid, carried across the chunks
            if (qc == 0) csq = 0.f;
            for (int qq = 0; qq < qn; ++qq)
                csq = __fadd_rn(csq, __fmul_rn(cs[tid * RS + qq], cs[tid * RS + qq]));
        }
        if (qc == nq - 1) {
            if (tid < CK) s_csq[tid] = csq;
            __syncthreads();
#pragma unroll
            for (int m = 0; m < GC; ++m) {   // this group's centroids, in j order
                const int j = cc * CK + g + GROUPS * m;
                if (j >= k) break;
                const float c2 = s_csq[g + GROUPS * m];
#pragma unroll
                for (int p = 0; p < GP; ++p) {
                    const float d2 = sq_dist(xx[p], c2, dot[p][m]);
                    if (takes(d2, best[p], lab[p] < 0)) {
                        best[p] = d2;
                        lab[p] = j;
                    }
                }
            }
        }
        __syncthreads();   // the buffer just read is the next stage's target
    }
    // the GROUPS partial minima of a point sit in adjacent lanes
#pragma unroll
    for (int p = 0; p < GP; ++p) {
#pragma unroll
        for (int off = 1; off < GROUPS; off <<= 1) {
            const float ob = __shfl_xor_sync(0xffffffffu, best[p], off);
            const int ol = __shfl_xor_sync(0xffffffffu, lab[p], off);
            if (beats(ob, ol, best[p], lab[p])) {
                best[p] = ob;
                lab[p] = ol;
            }
        }
        const int i = row0 + pg + PG * p;
        if (g == 0 && i < n) {
            labels[i] = lab[p];
            dists[i] = best[p];
        }
    }
}

template <int DIM>
int launch_small(const float* x, const float* cents, int* labels, float* dists, int n, int k,
                 bool aligned, cudaStream_t stream) {
    const int groups = (n + PTS - 1) / PTS;
    const int grid = (groups + SMALL_THREADS - 1) / SMALL_THREADS;
    if (aligned)
        kmeans_assign_small_kernel<DIM, true>
            <<<grid, SMALL_THREADS, 0, stream>>>(x, cents, labels, dists, n, k);
    else
        kmeans_assign_small_kernel<DIM, false>
            <<<grid, SMALL_THREADS, 0, stream>>>(x, cents, labels, dists, n, k);
    return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int launch_general(const float* x, const float* cents, int* labels, float* dists, int n, int k,
                   int dim, cudaStream_t stream) {
    const int grid = (n + BP - 1) / BP;
    kmeans_assign_general_kernel<VEC>
        <<<grid, GEN_THREADS, GEN_BYTES, stream>>>(x, cents, labels, dists, n, k, dim);
    return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" int gpic_kmeans_assign(
    const float* x, const float* cents, int* labels, float* dists,
    int n, int k, int dim, cudaStream_t stream) {
    if (n < 1 || k < 1 || dim < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (dim >= 1 && dim <= SMALL_DIM && static_cast<long long>(k) * dim <= SMALL_FLOATS) {
        const bool aligned = aligned16(x) && aligned16(labels) && aligned16(dists);
        switch (dim) {
            case 1: return launch_small<1>(x, cents, labels, dists, n, k, aligned, stream);
            case 2: return launch_small<2>(x, cents, labels, dists, n, k, aligned, stream);
            case 3: return launch_small<3>(x, cents, labels, dists, n, k, aligned, stream);
            case 4: return launch_small<4>(x, cents, labels, dists, n, k, aligned, stream);
            case 5: return launch_small<5>(x, cents, labels, dists, n, k, aligned, stream);
            case 6: return launch_small<6>(x, cents, labels, dists, n, k, aligned, stream);
            case 7: return launch_small<7>(x, cents, labels, dists, n, k, aligned, stream);
            default: return launch_small<8>(x, cents, labels, dists, n, k, aligned, stream);
        }
    }
    if (dim % 4 == 0 && aligned16(x) && aligned16(cents))
        return launch_general<true>(x, cents, labels, dists, n, k, dim, stream);
    return launch_general<false>(x, cents, labels, dists, n, k, dim, stream);
}
