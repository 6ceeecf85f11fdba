// Backward of kernel 12 (flash_attention.cu) for Hopper (sm_90a): the
// gradients dQ, dK and dV of out = softmax(q k^T scale, masked) v, the
// (s, s) scores and probabilities rebuilt tile by tile and never written to
// device memory.
//
// Replaces: the reverse-mode derivative that XLA takes of the reference's
// jnp attention when it trains (src/repro/models/layers.py:207-230: the
// logits einsum, the softmax and the PV einsum). The reference has no
// Pallas backward; in the port kernel 12 lies on the training forward, so
// its gradient is these kernels, behind a torch.autograd.Function
// (kernels/flash_attention.py).
//
// The algebra, with L the forward's row log-sum-exp of the scaled logits
// (flash_attention.cu writes it when asked):
//   D  = rowsum(dO * O)                      delta_kernel, one warp a row
//   P  = exp(S scale - L),  S = Q K^T        both kernels below rebuild it
//   dV = P^T dO,  dK = dS^T Q scale          dkdv_kernel
//   dS = P * (dO V^T - D)
//   dQ = dS K scale                          dq_kernel
//
// Bound on an H100: operations. At the training shape (b = 2, h = kv = 32,
// s = 1,024, d = 80, causal) the backward's five products (S rebuilt,
// dP = dO V^T, dV, dQ, dK) are 2.5 times the forward's two: 5 * 2 *
// (s^2 / 2) d b h = 2.7e10 operations, 0.40 ms at the f32 FMA rate of
// 67 TFLOP/s; this design rebuilds S and dP in both kernels (7 products).
//
// Design (correct before fast; PERF.md row 12 has its times):
//  * f32 FMA on CUDA cores, f32 accumulation; the inputs are staged into
//    shared memory as f32, element by element (any alignment: strided 4-D
//    views with d contiguous, the forward's layouts), d zero-padded to a
//    multiple of 16 (DP) with an odd row pitch, so no fragment load has a
//    bank conflict. Types: the forward's pairs (q f32 or bf16; k, v f32 or
//    bf16; dO in q's type); each gradient comes back in its input's type.
//  * A block is 256 threads, 16 x 16; on a 64 x 64 score tile each thread
//    owns 4 x 4 entries (rows ty + 16 i, columns tx + 16 j), on a 64 x DP
//    gradient tile 4 rows by DP / 16 columns (tx + 16 j).
//  * dkdv_kernel: one block per (b, kv head, 64-key tile). It loops over
//    the rep query heads of its kv head and, in each, over the 64-query
//    tiles that see its keys (causal: from its own tile on), and keeps dK
//    and dV in registers until one store. The GQA sum runs in this fixed
//    order inside the block: no float atomics, the same bits every call.
//  * dq_kernel: one block per (b, query head, 64-query tile), looping over
//    the key tiles its rows see (causal: up to its diagonal tile), dQ in
//    registers until one store.
//  * Masked entries (key past the query, or either past s) get P = 0; the
//    blocks with the most tiles start first.

#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // 16 x 16
constexpr int BT = 64;        // rows of a query or key tile
constexpr int SP = BT + 1;    // pitch of the 64 x 64 score tiles
constexpr int MAX_D = 128;

struct Args {
    const void* q;
    const void* k;
    const void* v;
    const void* dout;
    const float* lse;    // (b, h, s)
    const float* delta;  // (b, h, s)
    void* dq;
    void* dk;
    void* dv;
    long long q_sb, q_sh, q_ss;
    long long k_sb, k_sh, k_ss;
    long long v_sb, v_sh, v_ss;
    long long do_sb, do_sh, do_ss;
    long long dq_sb, dq_sh, dq_ss;
    long long dk_sb, dk_sh, dk_ss;
    long long dv_sb, dv_sh, dv_ss;
    int bh, h, kv, rep, s, d, n_t, causal;
    float scale;
};

// Rows [r0, r0 + 64) of an (s, d) head with row stride ``ss`` into a
// (64, DP) f32 tile of pitch DP + 1; rows past s and columns past d are 0.
template <int DP, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ss, int r0, int s,
                                      int d) {
    for (int e = threadIdx.x; e < BT * DP; e += THREADS) {
        const int r = e / DP, c = e - r * DP;
        const int row = r0 + r;
        dst[r * (DP + 1) + c] = row < s && c < d ? to_f32(src[row * ss + c]) : 0.f;
    }
}

// L and D of the query rows [q0, q0 + 64) (0 past s).
__device__ __forceinline__ void stage_rows(float* l_s, float* d_s, const float* lse,
                                           const float* delta, int q0, int s) {
    if (threadIdx.x < BT) {
        const int qi = q0 + threadIdx.x;
        l_s[threadIdx.x] = qi < s ? lse[qi] : 0.f;
        d_s[threadIdx.x] = qi < s ? delta[qi] : 0.f;
    }
}

template <int NT>
constexpr int smem_bytes(int score_tiles) {
    return static_cast<int>(sizeof(float)) *
           (4 * BT * (16 * NT + 1) + score_tiles * BT * SP + 2 * BT);
}

// A[i][j] += sum_c X[ty + 16 i][c] Y[tx + 16 j][c] and B[i][j] += the same
// of X2 and Y2: two 64 x 64 products of (64, DP) tiles of pitch P.
template <int DP>
__device__ __forceinline__ void two_scores(float (&A)[4][4], float (&B)[4][4],
                                           const float* X, const float* Y, const float* X2,
                                           const float* Y2, int tx, int ty) {
    constexpr int P = DP + 1;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) A[i][j] = B[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; ++c) {
        float x[4], x2[4], y[4], y2[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            x[i] = X[(ty + 16 * i) * P + c];
            x2[i] = X2[(ty + 16 * i) * P + c];
            y[i] = Y[(tx + 16 * i) * P + c];
            y2[i] = Y2[(tx + 16 * i) * P + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                A[i][j] = fmaf(x[i], y[j], A[i][j]);
                B[i][j] = fmaf(x2[i], y2[j], B[i][j]);
            }
    }
}

template <typename TQ, typename TKV, int NT>
__global__ void __launch_bounds__(THREADS) dkdv_kernel(Args a) {
    constexpr int DP = 16 * NT, P = DP + 1;
    extern __shared__ __align__(16) float sm[];
    float* k_s = sm;              // 64 keys x DP
    float* v_s = k_s + BT * P;
    float* q_s = v_s + BT * P;    // 64 queries x DP
    float* o_s = q_s + BT * P;    // dO
    float* p_s = o_s + BT * P;    // P^T: keys x queries
    float* ds_s = p_s + BT * SP;  // dS^T
    float* l_s = ds_s + BT * SP;
    float* dl_s = l_s + BT;

    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    const int n_bkv = a.bh / a.rep;
    const int kt = static_cast<int>(blockIdx.x) / n_bkv;  // low key tiles (most work) first
    const int gk = static_cast<int>(blockIdx.x) - kt * n_bkv;
    const int bi = gk / a.kv, ki = gk - bi * a.kv;
    const int k0 = kt * BT;
    stage<DP>(k_s, static_cast<const TKV*>(a.k) + bi * a.k_sb + ki * a.k_sh, a.k_ss, k0, a.s,
              a.d);
    stage<DP>(v_s, static_cast<const TKV*>(a.v) + bi * a.v_sb + ki * a.v_sh, a.v_ss, k0, a.s,
              a.d);

    float dk[4][NT], dv[4][NT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) dk[i][j] = dv[i][j] = 0.f;

    for (int r = 0; r < a.rep; ++r) {
        const int hi = ki * a.rep + r;
        const TQ* q = static_cast<const TQ*>(a.q) + bi * a.q_sb + hi * a.q_sh;
        const TQ* dout = static_cast<const TQ*>(a.dout) + bi * a.do_sb + hi * a.do_sh;
        const long long row0 = (static_cast<long long>(bi) * a.h + hi) * a.s;
        for (int qt = a.causal ? kt : 0; qt < a.n_t; ++qt) {
            const int q0 = qt * BT;
            __syncthreads();  // the previous tile's readers are done
            stage<DP>(q_s, q, a.q_ss, q0, a.s, a.d);
            stage<DP>(o_s, dout, a.do_ss, q0, a.s, a.d);
            stage_rows(l_s, dl_s, a.lse + row0, a.delta + row0, q0, a.s);
            __syncthreads();

            float st[4][4], dpt[4][4];  // S^T = K Q^T and dP^T = V dO^T
            two_scores<DP>(st, dpt, k_s, q_s, v_s, o_s, tx, ty);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int kj = k0 + ty + 16 * i, col = tx + 16 * j, qi = q0 + col;
                    const bool ok = kj < a.s && qi < a.s && !(a.causal && kj > qi);
                    const float p = ok ? expf(st[i][j] * a.scale - l_s[col]) : 0.f;
                    p_s[(ty + 16 * i) * SP + col] = p;
                    ds_s[(ty + 16 * i) * SP + col] = p * (dpt[i][j] - dl_s[col]);
                }
            __syncthreads();

            // dV += P^T dO and dK += dS^T Q over the tile's 64 queries
#pragma unroll 4
            for (int c = 0; c < BT; ++c) {
                float px[4], sx[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    px[i] = p_s[(ty + 16 * i) * SP + c];
                    sx[i] = ds_s[(ty + 16 * i) * SP + c];
                }
#pragma unroll
                for (int j = 0; j < NT; ++j) {
                    const float o = o_s[c * P + tx + 16 * j], qv = q_s[c * P + tx + 16 * j];
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        dv[i][j] = fmaf(px[i], o, dv[i][j]);
                        dk[i][j] = fmaf(sx[i], qv, dk[i][j]);
                    }
                }
            }
        }
    }

    TKV* gk_out = static_cast<TKV*>(a.dk) + bi * a.dk_sb + ki * a.dk_sh;
    TKV* gv_out = static_cast<TKV*>(a.dv) + bi * a.dv_sb + ki * a.dv_sh;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int kj = k0 + ty + 16 * i;
        if (kj >= a.s) continue;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const int c = tx + 16 * j;
            if (c < a.d) {
                gk_out[kj * a.dk_ss + c] = from_f32<TKV>(dk[i][j] * a.scale);
                gv_out[kj * a.dv_ss + c] = from_f32<TKV>(dv[i][j]);
            }
        }
    }
}

template <typename TQ, typename TKV, int NT>
__global__ void __launch_bounds__(THREADS) dq_kernel(Args a) {
    constexpr int DP = 16 * NT, P = DP + 1;
    extern __shared__ __align__(16) float sm[];
    float* q_s = sm;              // 64 queries x DP
    float* o_s = q_s + BT * P;    // dO
    float* k_s = o_s + BT * P;    // 64 keys x DP
    float* v_s = k_s + BT * P;
    float* ds_s = v_s + BT * P;   // dS: queries x keys
    float* l_s = ds_s + BT * SP;
    float* dl_s = l_s + BT;

    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    const int n_blk = static_cast<int>(blockIdx.x);
    const int gi = n_blk % a.bh;                      // flattened (batch, query head)
    const int qt = a.n_t - 1 - n_blk / a.bh;          // the longest rows first
    const int bi = gi / a.h, hi = gi - bi * a.h, ki = hi / a.rep;
    const int q0 = qt * BT;
    const TKV* k = static_cast<const TKV*>(a.k) + bi * a.k_sb + ki * a.k_sh;
    const TKV* v = static_cast<const TKV*>(a.v) + bi * a.v_sb + ki * a.v_sh;
    const long long row0 = static_cast<long long>(gi) * a.s;
    stage<DP>(q_s, static_cast<const TQ*>(a.q) + bi * a.q_sb + hi * a.q_sh, a.q_ss, q0, a.s,
              a.d);
    stage<DP>(o_s, static_cast<const TQ*>(a.dout) + bi * a.do_sb + hi * a.do_sh, a.do_ss, q0,
              a.s, a.d);
    stage_rows(l_s, dl_s, a.lse + row0, a.delta + row0, q0, a.s);

    float dq[4][NT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) dq[i][j] = 0.f;

    const int n_kt = a.causal ? qt + 1 : a.n_t;
    for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * BT;
        __syncthreads();  // the previous tile's readers are done
        stage<DP>(k_s, k, a.k_ss, k0, a.s, a.d);
        stage<DP>(v_s, v, a.v_ss, k0, a.s, a.d);
        __syncthreads();

        float sc[4][4], dp[4][4];  // S = Q K^T and dP = dO V^T
        two_scores<DP>(sc, dp, q_s, k_s, o_s, v_s, tx, ty);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int row = ty + 16 * i, qi = q0 + row, kj = k0 + tx + 16 * j;
                const bool ok = kj < a.s && qi < a.s && !(a.causal && kj > qi);
                const float p = ok ? expf(sc[i][j] * a.scale - l_s[row]) : 0.f;
                ds_s[row * SP + tx + 16 * j] = p * (dp[i][j] - dl_s[row]);
            }
        __syncthreads();

        // dQ += dS K over the tile's 64 keys
#pragma unroll 4
        for (int c = 0; c < BT; ++c) {
            float sx[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) sx[i] = ds_s[(ty + 16 * i) * SP + c];
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const float kv = k_s[c * P + tx + 16 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i) dq[i][j] = fmaf(sx[i], kv, dq[i][j]);
            }
        }
    }

    TQ* g_out = static_cast<TQ*>(a.dq) + bi * a.dq_sb + hi * a.dq_sh;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int qi = q0 + ty + 16 * i;
        if (qi >= a.s) continue;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const int c = tx + 16 * j;
            if (c < a.d) g_out[qi * a.dq_ss + c] = from_f32<TQ>(dq[i][j] * a.scale);
        }
    }
}

// D[row] = sum_c dO[row][c] O[row][c] in f32, one warp a row of the
// (b, h, s) rows; O and dO in q's type.
template <typename T>
__global__ void __launch_bounds__(THREADS) delta_kernel(Args a, const void* o_ptr,
                                                        long long o_sb, long long o_sh,
                                                        long long o_ss, float* delta) {
    const int lane = threadIdx.x & 31;
    const long long row = static_cast<long long>(blockIdx.x) * (THREADS / 32) + (threadIdx.x >> 5);
    if (row >= static_cast<long long>(a.bh) * a.s) return;
    const int si = static_cast<int>(row % a.s);
    const int gi = static_cast<int>(row / a.s);
    const int bi = gi / a.h, hi = gi - bi * a.h;
    const T* o = static_cast<const T*>(o_ptr) + bi * o_sb + hi * o_sh + si * o_ss;
    const T* dout = static_cast<const T*>(a.dout) + bi * a.do_sb + hi * a.do_sh + si * a.do_ss;
    float acc = 0.f;
    for (int c = lane; c < a.d; c += 32) acc = fmaf(to_f32(o[c]), to_f32(dout[c]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) delta[row] = acc;
}

template <int NT, typename TQ, typename TKV>
int launch_nt(const Args& a, bool dq, cudaStream_t stream) {
    const long long n_blocks = static_cast<long long>(dq ? a.bh : a.bh / a.rep) * a.n_t;
    const int smem = smem_bytes<NT>(dq ? 1 : 2);
    auto kernel = dq ? dq_kernel<TQ, TKV, NT> : dkdv_kernel<TQ, TKV, NT>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<static_cast<unsigned>(n_blocks), THREADS, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int launch_types(const Args& a, bool dq, cudaStream_t stream) {
    switch ((a.d + 15) / 16) {
        case 1: return launch_nt<1, TQ, TKV>(a, dq, stream);
        case 2: return launch_nt<2, TQ, TKV>(a, dq, stream);
        case 3: return launch_nt<3, TQ, TKV>(a, dq, stream);
        case 4: return launch_nt<4, TQ, TKV>(a, dq, stream);
        case 5: return launch_nt<5, TQ, TKV>(a, dq, stream);
        case 6: return launch_nt<6, TQ, TKV>(a, dq, stream);
        case 7: return launch_nt<7, TQ, TKV>(a, dq, stream);
        default: return launch_nt<8, TQ, TKV>(a, dq, stream);
    }
}

int check_shape(int b, int h, int kv, int s, int d, long long blocks) {
    if (b < 1 || h < 1 || kv < 1 || h % kv != 0 || s < 1 || d < 1 || d > MAX_D ||
        blocks > 0x7fffffffLL)
        return static_cast<int>(cudaErrorInvalidValue);
    return 0;
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk, void* dv, int b,
               int h, int kv, int s, int d, const long long* st, int causal, float scale) {
    return Args{q, k, v, dout, lse, delta, dq, dk, dv,
                st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
                st[9], st[10], st[11], st[12], st[13], st[14], st[15], st[16], st[17],
                st[18], st[19], st[20],
                b * h, h, kv, h / kv, s, d, (s + BT - 1) / BT, causal, scale};
}

int dispatch(const Args& a, int q_type, int kv_type, bool dq, cudaStream_t stream) {
    if (q_type == 0 && kv_type == 0) return launch_types<float, float>(a, dq, stream);
    if (q_type == 0 && kv_type == 1) return launch_types<float, __nv_bfloat16>(a, dq, stream);
    if (q_type == 1 && kv_type == 1)
        return launch_types<__nv_bfloat16, __nv_bfloat16>(a, dq, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Types as in gpic_flash_attention: 0 = f32, 1 = bf16; dO has q's type.
// Strides are in elements, three a tensor ((b, head, s) with d contiguous).
// D (delta) and L (lse) are (b, h, s) f32, contiguous.

// delta = rowsum(dO * O): o and dout (b, h, s, d) in q's type.
extern "C" int gpic_flash_attention_bwd_delta(
    const void* o, const void* dout, float* delta, int q_type, int b, int h, int s, int d,
    long long o_sb, long long o_sh, long long o_ss,
    long long do_sb, long long do_sh, long long do_ss, cudaStream_t stream) {
    const long long rows = static_cast<long long>(b) * h * s;
    const long long n_blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
    const int bad = check_shape(b, h, h, s, d, n_blocks);
    if (bad) return bad;
    const long long st[21] = {0, 0, 0, 0, 0, 0, 0, 0, 0, do_sb, do_sh, do_ss};
    const Args a = make_args(nullptr, nullptr, nullptr, dout, nullptr, delta, nullptr, nullptr,
                             nullptr, b, h, h, s, d, st, 0, 0.f);
    if (q_type == 0)
        delta_kernel<float><<<static_cast<unsigned>(n_blocks), THREADS, 0, stream>>>(
            a, o, o_sb, o_sh, o_ss, delta);
    else if (q_type == 1)
        delta_kernel<__nv_bfloat16><<<static_cast<unsigned>(n_blocks), THREADS, 0, stream>>>(
            a, o, o_sb, o_sh, o_ss, delta);
    else
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}

// dK and dV: q, dout (b, h, s, d); k, v, dk, dv (b, kv, s, d).
extern "C" int gpic_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, void* dk, void* dv, int q_type, int kv_type,
    int b, int h, int kv, int s, int d,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long do_sb, long long do_sh, long long do_ss,
    long long dk_sb, long long dk_sh, long long dk_ss,
    long long dv_sb, long long dv_sh, long long dv_ss,
    int causal, float scale, cudaStream_t stream) {
    const int bad = check_shape(b, h, kv, s, d,
                                static_cast<long long>(b) * kv * ((s + BT - 1) / BT));
    if (bad) return bad;
    const long long st[21] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                              do_sb, do_sh, do_ss, 0, 0, 0,
                              dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss};
    const Args a = make_args(q, k, v, dout, lse, delta, nullptr, dk, dv, b, h, kv, s, d, st,
                             causal, scale);
    return dispatch(a, q_type, kv_type, false, stream);
}

// dQ: q, dout, dq (b, h, s, d); k, v (b, kv, s, d).
extern "C" int gpic_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, void* dq, int q_type, int kv_type,
    int b, int h, int kv, int s, int d,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long do_sb, long long do_sh, long long do_ss,
    long long dq_sb, long long dq_sh, long long dq_ss,
    int causal, float scale, cudaStream_t stream) {
    const int bad = check_shape(b, h, kv, s, d,
                                static_cast<long long>(b) * h * ((s + BT - 1) / BT));
    if (bad) return bad;
    const long long st[21] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                              do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss};
    const Args a = make_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr, b, h, kv, s, d,
                             st, causal, scale);
    return dispatch(a, q_type, kv_type, true, stream);
}
