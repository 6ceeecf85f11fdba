// Causal (or full) flash attention with grouped-query heads for Hopper
// (sm_90a): out = softmax(q k^T / sqrt(d), masked) v, one pass over K and V
// per query tile, the (s, s) scores never written to device memory.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (the
// Pallas TPU kernel _flash_kernel), the attention of the dense LM's
// no-cache forward and of its prefill over the KV cache.
//
// Layout: q (b, h, s, d) and k, v (b, kv, s, d), each with its own element
// strides on b, h and s and a contiguous d, so the model's (b, s, h, d)
// activations and the (b, S, kv, d) cache slice are read in place; the
// public (bh, s, d) form is b = 1. Query head hi reads kv head hi / rep,
// rep = h / kv, as the Pallas index map does with the flattened bh.
// Types: q f32 or bf16; k and v f32 or bf16 (the serve path passes f32 q
// with the bf16 cache). Everything is computed in f32 (K and V upcast on
// load, p kept in f32: the reference's oracle's arithmetic); the output is
// rounded once to q's type.
//
// Bound on an H100: operations. At the serve shape (b h = 128, s = 2048,
// d = 80, causal) the two products are 2 * 2 * (s^2 / 2) * d * bh = 8.6e10
// f32 operations, 1.28 ms at 67 TFLOP/s, against 0.075 ms for the bytes.
//
// Design (the simple one; wgmma, TMA and a bf16 PV are later work):
//  * One block of 256 threads per (b h, 64-row query tile), the tiles of a
//    head launched last-first so the long causal rows start early. It walks
//    the 64-key tiles in order, stopping after the diagonal when causal: a
//    tile wholly above it leaves m, l and acc unchanged (p = 0, the
//    correction factor is 1), so skipping it is exact.
//  * Q, the K and V tiles (as f32) and the P tile live in shared memory
//    with an odd pitch (d + 1, 65), so the column reads of K and V by 16
//    neighbouring threads hit 16 banks.
//  * Thread (ty, tx) of a 16 x 16 grid owns query rows ty + 16 i (i < 4):
//    the 4 x 4 scores at key columns tx + 16 j, and the accumulator at
//    output columns tx + 16 jj (jj < NJ = ceil(d / 16)), so the running
//    max m, sum l and acc of its rows stay in its registers; the row max
//    and sum reduce over the 16 lanes of a half-warp with shuffles.
//  * m = -inf is guarded as in the Pallas kernel; expf, not __expf;
//    out = acc / max(l, 1e-30).

#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // a 16 x 16 grid
constexpr int MAX_D = 128;
constexpr int P_PITCH = BK + 1;
static_assert(BQ == BK, "stage() fills 64-row tiles of Q, K and V alike");

struct Args {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    long long q_sb, q_sh, q_ss;
    long long k_sb, k_sh, k_ss;
    long long v_sb, v_sh, v_ss;
    long long o_sb, o_sh, o_ss;
    int h, rep, s, d, n_qt, causal;
    float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// Rows [r0, r0 + 64) of a (s, d) head with row stride ``ss`` into a
// (64, d + 1) f32 tile; rows past s read as 0.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ss, int r0,
                                      int s, int d) {
    const int dp = d + 1;
    for (int e = threadIdx.x; e < BK * d; e += THREADS) {
        const int r = e / d, c = e - r * d;
        const int row = r0 + r;
        dst[r * dp + c] = row < s ? to_f32(src[static_cast<long long>(row) * ss + c]) : 0.f;
    }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

template <typename TQ, typename TKV, int NJ>
__global__ void __launch_bounds__(THREADS) flash_kernel(Args a) {
    extern __shared__ float smem[];
    const int d = a.d, dp = d + 1;
    float* q_s = smem;             // (BQ, dp)
    float* k_s = q_s + BQ * dp;    // (BK, dp)
    float* v_s = k_s + BK * dp;    // (BK, dp)
    float* p_s = v_s + BK * dp;    // (BQ, P_PITCH)

    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    const int q0 = (a.n_qt - 1 - static_cast<int>(blockIdx.x)) * BQ;
    const int g = blockIdx.y;                  // flattened (batch, query head)
    const int bi = g / a.h, hi = g - bi * a.h, ki = hi / a.rep;
    const TQ* q = static_cast<const TQ*>(a.q) + bi * a.q_sb + hi * a.q_sh;
    const TKV* k = static_cast<const TKV*>(a.k) + bi * a.k_sb + ki * a.k_sh;
    const TKV* v = static_cast<const TKV*>(a.v) + bi * a.v_sb + ki * a.v_sh;
    TQ* o = static_cast<TQ*>(a.o) + bi * a.o_sb + hi * a.o_sh;

    stage(q_s, q, a.q_ss, q0, a.s, d);

    float m[4], l[4], acc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.f;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
    }

    int n_kt = (a.s + BK - 1) / BK;
    if (a.causal) n_kt = min(n_kt, (min(q0 + BQ, a.s) - 1) / BK + 1);

    for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();  // Q is staged; the last tile's K, V and P are consumed
        stage(k_s, k, a.k_ss, k0, a.s, d);
        stage(v_s, v, a.v_ss, k0, a.s, d);
        __syncthreads();

        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
        for (int c = 0; c < d; ++c) {
            float qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * dp + c];
#pragma unroll
            for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * dp + c];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = ty + 16 * i, qi = q0 + row;
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kj = k0 + tx + 16 * j;
                const bool ok = kj < a.s && (!a.causal || kj <= qi);
                sc[i][j] = ok ? sc[i][j] * a.scale : -INFINITY;
                mx = fmaxf(mx, sc[i][j]);
            }
            const float m_new = fmaxf(m[i], half_warp_max(mx));
            // a row with no valid key yet keeps m = -inf; guard the exp
            const float m_safe = m_new == -INFINITY ? 0.f : m_new;
            float rs = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = sc[i][j] == -INFINITY ? 0.f : expf(sc[i][j] - m_safe);
                p_s[row * P_PITCH + tx + 16 * j] = p;
                rs += p;
            }
            const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe);
            l[i] = l[i] * corr + half_warp_sum(rs);
#pragma unroll
            for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= corr;
            m[i] = m_new;
        }
        __syncthreads();  // the P tile is complete

        const int n_keys = min(BK, a.s - k0);
        for (int t = 0; t < n_keys; ++t) {
            float pv[4], vv[NJ];
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * P_PITCH + t];
#pragma unroll
            for (int jj = 0; jj < NJ; ++jj) {
                const int c = tx + 16 * jj;
                vv[jj] = c < d ? v_s[t * dp + c] : 0.f;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = fmaf(pv[i], vv[jj], acc[i][jj]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int qi = q0 + ty + 16 * i;
        if (qi >= a.s) continue;
        const float l_floor = fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
            const int c = tx + 16 * jj;
            if (c < d) o[static_cast<long long>(qi) * a.o_ss + c] = from_f32<TQ>(acc[i][jj] / l_floor);
        }
    }
}

template <typename TQ, typename TKV, int NJ>
int launch_nj(const Args& a, int bh, cudaStream_t stream) {
    const int smem = static_cast<int>(((BQ + 2 * BK) * (a.d + 1) + BQ * P_PITCH) * sizeof(float));
    auto kernel = flash_kernel<TQ, TKV, NJ>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(a.n_qt, bh), THREADS, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int launch_types(const Args& a, int bh, cudaStream_t stream) {
    switch ((a.d + 15) / 16) {
        case 1: return launch_nj<TQ, TKV, 1>(a, bh, stream);
        case 2: return launch_nj<TQ, TKV, 2>(a, bh, stream);
        case 3: return launch_nj<TQ, TKV, 3>(a, bh, stream);
        case 4: return launch_nj<TQ, TKV, 4>(a, bh, stream);
        case 5: return launch_nj<TQ, TKV, 5>(a, bh, stream);
        case 6: return launch_nj<TQ, TKV, 6>(a, bh, stream);
        case 7: return launch_nj<TQ, TKV, 7>(a, bh, stream);
        default: return launch_nj<TQ, TKV, 8>(a, bh, stream);
    }
}

}  // namespace

// q_type and kv_type: 0 = f32, 1 = bf16 (o has q's type); the pairs taken
// are (0, 0), (0, 1) and (1, 1). Strides are in elements: q (b, h, s, d)
// by q_sb, q_sh, q_ss, d contiguous; k and v (b, kv, s, d) likewise.
extern "C" int gpic_flash_attention(
    const void* q, const void* k, const void* v, void* o, int q_type, int kv_type,
    int b, int h, int kv, int s, int d,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int causal, float scale, cudaStream_t stream) {
    if (b < 1 || kv < 1 || h % kv != 0 || s < 1 || d < 1 || d > MAX_D ||
        static_cast<long long>(b) * h > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    Args a{q, k, v, o, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           o_sb, o_sh, o_ss, h, h / kv, s, d, (s + BQ - 1) / BQ, causal, scale};
    const int bh = b * h;
    if (q_type == 0 && kv_type == 0) return launch_types<float, float>(a, bh, stream);
    if (q_type == 0 && kv_type == 1) return launch_types<float, __nv_bfloat16>(a, bh, stream);
    if (q_type == 1 && kv_type == 1)
        return launch_types<__nv_bfloat16, __nv_bfloat16>(a, bh, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}
