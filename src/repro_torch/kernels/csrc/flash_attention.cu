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
// with the bf16 cache). The function is the oracle's f32 one (logits and
// p in f32, out = acc / max(l, 1e-30)); the output is rounded once to q's
// type. Where the caller asks for it (a training forward), the kernel also
// writes each row's f32 log-sum-exp L = m + log(max(l, 1e-30)) of the
// scaled logits, (b, h, s) contiguous, which the backward kernels
// (flash_attention_bwd.cu) read to rebuild P = exp(S scale - L); without it
// the output's bits are those of a call that writes no L.
//
// Bound on an H100: operations. At the serve shape (b h = 128, s = 2048,
// d = 80, causal) the two products are 2 * 2 * (s^2 / 2) * d * bh = 8.6e10
// operations: 1.28 ms at the f32 FMA rate of 67 TFLOP/s, 0.35 ms for the
// two split-TF32 terms each product runs here at the 495 TFLOP/s TF32 rate,
// against 0.075 ms for the bytes.
//
// Design:
//  * Tensor cores through mma.sync m16n8k8 TF32, with split operands that
//    keep f32 accuracy (CUTLASS's 3xTF32): x = hi + lo, both rounded to
//    TF32 by cvt.rna. A bf16 value is exact in TF32, so q k^T over a bf16 K
//    is q_hi k + q_lo k and p v over a bf16 V is p_hi v + p_lo v (2 terms);
//    over f32 K and V the three terms lo hi + hi lo + hi hi (lo lo, below
//    f32 rounding, is dropped); a bf16 q over bf16 K is one exact term.
//  * A block of 4 warps takes one 64-row query tile; each warp owns 16
//    rows (__launch_bounds__(128, 1): the widest templates need up to 212
//    registers a thread, and without the bound ptxas spilled some of them
//    to keep more blocks on an SM). The scores S (16 x 64 a warp) and the output accumulator
//    (16 x d) live in registers in the mma fragment layout, so the row max
//    and sum reduce over the 4 lanes of a quad with shuffles. The contracted
//    index of each product is permuted inside its 8-wide step (fragment
//    column t holds index 2t, column t + 4 index 2t + 1): S's accumulator is
//    then P's A operand as it stands, no shuffle or shared round trip, and
//    a lane's two B values are one 8-byte (f32) or 4-byte (bf16) load.
//  * Q (once) and 64-key K and V tiles go into shared memory in their own
//    type, d zero-padded to a multiple of 16, with 16-byte cp.async into a
//    two-stage ring, so the next tile loads during this tile's products.
//    Rows that are not 16-byte aligned take the scalar-staging template
//    (ASYNC = false, built at the widest head and so good for any d), which
//    the wrapper chooses. Row pitches make every fragment load free of bank
//    conflicts; a bf16 V is read with ldmatrix.trans, which hands each lane
//    its two B values (keys 2t and 2t + 1 of column g) in one register.
//  * Causal: tiles wholly above the diagonal are skipped (p = 0 and a
//    correction factor of 1 leave m, l and acc unchanged), only tiles that
//    cross the diagonal or the end of s are masked, and the flattened grid
//    starts the longest rows first. b h is not limited by a grid dimension.
//  * m = -inf is guarded as in the Pallas kernel; expf, not __expf.

#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;  // query rows per block, 16 a warp
constexpr int BK = 64;          // keys per tile
constexpr int NS = BK / 8;      // 8-key steps (and 8-key score columns) per tile
constexpr int MAX_D = 128;
constexpr int MAX_NT = MAX_D / 8;

struct Args {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    float* lse;  // (b, h, s) row log-sum-exp, or null
    long long q_sb, q_sh, q_ss;
    long long k_sb, k_sh, k_ss;
    long long v_sb, v_sh, v_ss;
    long long o_sb, o_sh, o_ss;
    int bh, h, rep, s, d, n_qt, causal;
    float scale;
};

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
    return __float2bfloat16_rn(0.f);
}

// Elements p[0] and p[1] as f32 (p is 8-byte aligned for f32, 4 for bf16).
__device__ __forceinline__ void load_pair(const float* p, float& x0, float& x1) {
    const float2 w = *reinterpret_cast<const float2*>(p);
    x0 = w.x;
    x1 = w.y;
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float& x0, float& x1) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    x0 = __uint_as_float(w << 16);
    x1 = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ uint32_t tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

// x = hi + lo to about 2^-22 of x, hi and lo TF32 values
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
}

// c += a b over one 16 x 8 x 8 TF32 step, f32 accumulation
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// N = 4 or 2 8 x 8 bf16 tiles, transposed: lanes 8m..8m+7 give the
// row addresses of tile m; each lane gets rows 2t and 2t + 1 of column g.
template <int N>
__device__ __forceinline__ void ldmatrix_t(uint32_t (&r)[N], const void* p) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    if constexpr (N == 4)
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
                     : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
    else
        asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
                     : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

// Rows [r0, r0 + ROWS) of a (s, d) head with row stride ``ss`` into a
// (ROWS, DP) tile of pitch PITCH, in the source's type; rows past s and
// columns past d read as 0. ASYNC: 16-byte cp.async (rows and d 16-byte
// aligned, checked by the wrapper), else plain loads and stores.
template <bool ASYNC, int ROWS, int DP, int PITCH, typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, long long ss, int r0, int s,
                                      int d) {
    if constexpr (ASYNC) {
        constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // elements a chunk
        constexpr int CPR = DP / EPC;                          // chunks a row
        const int d_chunks = d / EPC;
        for (int e = threadIdx.x; e < ROWS * CPR; e += THREADS) {
            const int r = e / CPR, c = e - r * CPR;
            const int row = r0 + r;
            const bool ok = row < s && c < d_chunks;
            const T* from = ok ? src + static_cast<long long>(row) * ss + c * EPC : src;
            cp_async16(dst + r * PITCH + c * EPC, from, ok ? 16 : 0);
        }
    } else {
        for (int e = threadIdx.x; e < ROWS * DP; e += THREADS) {
            const int r = e / DP, c = e - r * DP;
            const int row = r0 + r;
            dst[r * PITCH + c] =
                row < s && c < d ? src[static_cast<long long>(row) * ss + c] : zero<T>();
        }
    }
}

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename TQ, typename TKV, int NT>
struct Tile {
    static constexpr int DP = 8 * NT;                            // d padded (NT even)
    static constexpr int QP = DP + 8;                            // Q and K pitch
    static constexpr int VP = sizeof(TKV) == 4 ? DP + 4 : DP + 8;
    static constexpr int Q_BYTES = BQ * QP * static_cast<int>(sizeof(TQ));
    static constexpr int K_BYTES = BK * QP * static_cast<int>(sizeof(TKV));
    static constexpr int V_BYTES = BK * VP * static_cast<int>(sizeof(TKV));
    static constexpr int SMEM = Q_BYTES + 2 * (K_BYTES + V_BYTES);
    static_assert(NT % 2 == 0, "d is padded to a multiple of 16");
    static_assert(Q_BYTES % 16 == 0 && K_BYTES % 16 == 0 && V_BYTES % 16 == 0,
                  "16-byte aligned stages");
};

template <typename TQ, typename TKV, int NT, bool ASYNC>
__global__ void __launch_bounds__(THREADS, 1) flash_kernel(Args a) {
    using L = Tile<TQ, TKV, NT>;
    constexpr int DP = L::DP, QP = L::QP, VP = L::VP;
    constexpr bool Q_SPLIT = sizeof(TQ) == 4;    // an f32 q is hi + lo
    constexpr bool KV_SPLIT = sizeof(TKV) == 4;  // so are f32 k and v
    extern __shared__ __align__(16) unsigned char smem[];
    TQ* q_s = reinterpret_cast<TQ*>(smem);
    TKV* k_s = reinterpret_cast<TKV*>(smem + L::Q_BYTES);
    TKV* v_s = reinterpret_cast<TKV*>(smem + L::Q_BYTES + 2 * L::K_BYTES);

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;  // fragment row group and column pair
    const int n_blk = static_cast<int>(blockIdx.x);
    const int gi = n_blk % a.bh;            // flattened (batch, query head)
    const int q0 = (a.n_qt - 1 - n_blk / a.bh) * BQ;
    const int bi = gi / a.h, hi = gi - bi * a.h, ki = hi / a.rep;
    const TQ* q = static_cast<const TQ*>(a.q) + bi * a.q_sb + hi * a.q_sh;
    const TKV* k = static_cast<const TKV*>(a.k) + bi * a.k_sb + ki * a.k_sh;
    const TKV* v = static_cast<const TKV*>(a.v) + bi * a.v_sb + ki * a.v_sh;
    TQ* o = static_cast<TQ*>(a.o) + bi * a.o_sb + hi * a.o_sh;

    int n_kt = (a.s + BK - 1) / BK;
    if (a.causal) n_kt = min(n_kt, (min(q0 + BQ, a.s) - 1) / BK + 1);

    stage<ASYNC, BQ, DP, QP>(q_s, q, a.q_ss, q0, a.s, a.d);
    stage<ASYNC, BK, DP, QP>(k_s, k, a.k_ss, 0, a.s, a.d);
    stage<ASYNC, BK, DP, VP>(v_s, v, a.v_ss, 0, a.s, a.d);
    cp_async_commit();

    const int row0 = q0 + 16 * warp + g;  // this lane's rows: row0 and row0 + 8
    float acc[NT][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * BK, buf = kt & 1;
        if (kt + 1 < n_kt) {  // the next tile streams in during this one
            stage<ASYNC, BK, DP, QP>(k_s + (buf ^ 1) * BK * QP, k, a.k_ss, k0 + BK, a.s, a.d);
            stage<ASYNC, BK, DP, VP>(v_s + (buf ^ 1) * BK * VP, v, a.v_ss, k0 + BK, a.s, a.d);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const TKV* kb = k_s + buf * BK * QP;
        const TKV* vb = v_s + buf * BK * VP;

        // S = Q K^T: 8 score columns of 8 keys, d / 8 steps of 8 dims
        float sc[NS][4];
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NT; ++kk) {
            float x[4];  // (g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1)
            load_pair(q_s + (16 * warp + g) * QP + 8 * kk + 2 * t, x[0], x[2]);
            load_pair(q_s + (16 * warp + g + 8) * QP + 8 * kk + 2 * t, x[1], x[3]);
            uint32_t qh[4], ql[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                if constexpr (Q_SPLIT) split(x[e], qh[e], ql[e]);
                else qh[e] = __float_as_uint(x[e]);
            }
#pragma unroll
            for (int j = 0; j < NS; ++j) {
                float y0, y1;
                load_pair(kb + (8 * j + g) * QP + 8 * kk + 2 * t, y0, y1);
                if constexpr (KV_SPLIT) {
                    uint32_t h0, l0, h1, l1;
                    split(y0, h0, l0);
                    split(y1, h1, l1);
                    mma(sc[j], ql, h0, h1);
                    mma(sc[j], qh, l0, l1);
                    mma(sc[j], qh, h0, h1);
                } else {
                    if constexpr (Q_SPLIT) mma(sc[j], ql, __float_as_uint(y0), __float_as_uint(y1));
                    mma(sc[j], qh, __float_as_uint(y0), __float_as_uint(y1));
                }
            }
        }

        // online softmax over the tile, rows row0 (e = 0, 1) and row0 + 8 (e = 2, 3)
        const bool edge = k0 + BK > a.s || (a.causal && k0 + BK - 1 > q0 + 16 * warp);
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = sc[j][e] * a.scale;
                if (edge) {
                    const int kj = k0 + 8 * j + 2 * t + (e & 1), qi = row0 + 8 * (e >> 1);
                    if (kj >= a.s || (a.causal && kj > qi)) x = -INFINITY;
                }
                sc[j][e] = x;
                mx[e >> 1] = fmaxf(mx[e >> 1], x);
            }
        float m_safe[2], corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const float m_new = fmaxf(m[r], quad_max(mx[r]));
            // a row with no valid key yet keeps m = -inf; guard the exp
            m_safe[r] = m_new == -INFINITY ? 0.f : m_new;
            corr[r] = m[r] == -INFINITY ? 0.f : expf(m[r] - m_safe[r]);
            m[r] = m_new;
        }
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = sc[j][e] == -INFINITY ? 0.f : expf(sc[j][e] - m_safe[e >> 1]);
                sc[j][e] = p;
                rs[e >> 1] += p;
            }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(rs[r]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            acc[j][0] *= corr[0];
            acc[j][1] *= corr[0];
            acc[j][2] *= corr[1];
            acc[j][3] *= corr[1];
        }

        // acc += P V: 8 steps of 8 keys, P's A operand straight from S
#pragma unroll
        for (int kk = 0; kk < NS; ++kk) {
            uint32_t ph[4], pl[4];
            split(sc[kk][0], ph[0], pl[0]);
            split(sc[kk][2], ph[1], pl[1]);
            split(sc[kk][1], ph[2], pl[2]);
            split(sc[kk][3], ph[3], pl[3]);
            if constexpr (KV_SPLIT) {
#pragma unroll
                for (int j = 0; j < NT; ++j) {
                    const float y0 = vb[(8 * kk + 2 * t) * VP + 8 * j + g];
                    const float y1 = vb[(8 * kk + 2 * t + 1) * VP + 8 * j + g];
                    uint32_t h0, l0, h1, l1;
                    split(y0, h0, l0);
                    split(y1, h1, l1);
                    mma(acc[j], pl, h0, h1);
                    mma(acc[j], ph, l0, l1);
                    mma(acc[j], ph, h0, h1);
                }
            } else {
                const TKV* vrow = vb + (8 * kk + (lane & 7)) * VP;
#pragma unroll
                for (int j = 0; j + 4 <= NT; j += 4) {
                    uint32_t w[4];
                    ldmatrix_t(w, vrow + 8 * (j + (lane >> 3)));
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        mma(acc[j + i], pl, w[i] << 16, w[i] & 0xffff0000u);
                        mma(acc[j + i], ph, w[i] << 16, w[i] & 0xffff0000u);
                    }
                }
                if constexpr (NT % 4 != 0) {
                    constexpr int j = NT - 2;
                    uint32_t w[2];
                    ldmatrix_t(w, vrow + 8 * (j + ((lane >> 3) & 1)));
#pragma unroll
                    for (int i = 0; i < 2; ++i) {
                        mma(acc[j + i], pl, w[i] << 16, w[i] & 0xffff0000u);
                        mma(acc[j + i], ph, w[i] << 16, w[i] & 0xffff0000u);
                    }
                }
            }
        }
        __syncthreads();  // every warp is done with this stage before it is refilled
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int qi = row0 + 8 * r;
        if (qi >= a.s) continue;
        const float l_floor = fmaxf(l[r], 1e-30f);
        TQ* orow = o + static_cast<long long>(qi) * a.o_ss;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const int c = 8 * j + 2 * t;
            if (c < a.d) orow[c] = from_f32<TQ>(acc[j][2 * r] / l_floor);
            if (c + 1 < a.d) orow[c + 1] = from_f32<TQ>(acc[j][2 * r + 1] / l_floor);
        }
        if (a.lse != nullptr && t == 0)
            a.lse[static_cast<long long>(gi) * a.s + qi] = m[r] + logf(l_floor);
    }
}

template <typename TQ, typename TKV, int NT, bool ASYNC>
int launch_nt(const Args& a, int n_blocks, cudaStream_t stream) {
    constexpr int smem = Tile<TQ, TKV, NT>::SMEM;
    auto kernel = flash_kernel<TQ, TKV, NT, ASYNC>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<n_blocks, THREADS, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int launch_types(const Args& a, int n_blocks, bool async_copy, cudaStream_t stream) {
    if (!async_copy) return launch_nt<TQ, TKV, MAX_NT, false>(a, n_blocks, stream);
    switch ((a.d + 15) / 16) {
        case 1: return launch_nt<TQ, TKV, 2, true>(a, n_blocks, stream);
        case 2: return launch_nt<TQ, TKV, 4, true>(a, n_blocks, stream);
        case 3: return launch_nt<TQ, TKV, 6, true>(a, n_blocks, stream);
        case 4: return launch_nt<TQ, TKV, 8, true>(a, n_blocks, stream);
        case 5: return launch_nt<TQ, TKV, 10, true>(a, n_blocks, stream);
        case 6: return launch_nt<TQ, TKV, 12, true>(a, n_blocks, stream);
        case 7: return launch_nt<TQ, TKV, 14, true>(a, n_blocks, stream);
        default: return launch_nt<TQ, TKV, 16, true>(a, n_blocks, stream);
    }
}

}  // namespace

// q_type and kv_type: 0 = f32, 1 = bf16 (o has q's type); the pairs taken
// are (0, 0), (0, 1) and (1, 1). Strides are in elements: q (b, h, s, d)
// by q_sb, q_sh, q_ss, d contiguous; k and v (b, kv, s, d) likewise.
// async_copy: q, k and v rows (and d) are 16-byte aligned, so the tiles
// stream in with cp.async; 0 takes the scalar-staging template. lse: the
// (b, h, s) f32 row log-sum-exp, written where it is not null.
extern "C" int gpic_flash_attention(
    const void* q, const void* k, const void* v, void* o, float* lse, int q_type, int kv_type,
    int b, int h, int kv, int s, int d,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int causal, float scale, int async_copy, cudaStream_t stream) {
    const long long n_qt = (static_cast<long long>(s) + BQ - 1) / BQ;
    if (b < 1 || h < 1 || kv < 1 || h % kv != 0 || s < 1 || d < 1 || d > MAX_D ||
        static_cast<long long>(b) * h * n_qt > 0x7fffffffLL)
        return static_cast<int>(cudaErrorInvalidValue);
    Args a{q, k, v, o, lse, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           o_sb, o_sh, o_ss, b * h, h, h / kv, s, d, static_cast<int>(n_qt), causal, scale};
    const int n_blocks = static_cast<int>(b * h * n_qt);
    const bool ac = async_copy != 0;
    if (q_type == 0 && kv_type == 0) return launch_types<float, float>(a, n_blocks, ac, stream);
    if (q_type == 0 && kv_type == 1)
        return launch_types<float, __nv_bfloat16>(a, n_blocks, ac, stream);
    if (q_type == 1 && kv_type == 1)
        return launch_types<__nv_bfloat16, __nv_bfloat16>(a, n_blocks, ac, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}
