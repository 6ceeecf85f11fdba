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
// s = 1,024, d = 80, causal, f32) the backward's five products (S rebuilt,
// dP = dO V^T, dV, dQ, dK) are 5 * 2 * (s^2 / 2) d b h = 2.7e10
// operations; as the split-TF32 terms run here (three a product of two f32
// operands) at the 495 TFLOP/s TF32 rate, 0.163 ms. Each kernel rebuilds S
// and dP, so dK/dV runs four products (bound 0.130 ms) and dQ three
// (0.098 ms): seven in all, against one fused kernel that would need dQ by
// float atomics or a (b h, s, s) dS in device memory.
//
// Design (the forward's machinery, flash_tile.cuh):
//  * Every product runs on the tensor cores through mma.sync m16n8k8 TF32
//    with split operands (split_hi_lo): three terms (lo hi + hi lo + hi hi)
//    for two f32 operands, two where one is bf16 (exact in TF32), one for
//    two bf16. P and dS are f32, so always split. Each product sums two
//    8-wide steps in a fresh accumulator and adds it to its long sum in f32
//    (add_to): the tensor cores' own accumulation truncates. Types: the
//    forward's pairs (q f32 or bf16; k, v f32 or bf16; dO in q's type);
//    each gradient comes back in its input's type.
//  * A block is 4 warps and keeps 64 resident rows, 16 a warp, staged once
//    as f32; it streams 32-row tiles of the other side (16-row for dK/dV at
//    d > 112, so that nothing spills) through a two-stage 16-byte cp.async
//    ring in their own type (rows off 16 bytes: the scalar-staging
//    template, built at the widest head and chosen by the wrapper). At
//    d = 80 two blocks fit an SM (86.5 KB of shared memory, at most 219
//    registers a thread). dkdv_kernel: one block per (b, kv head, 64-key tile), K and
//    V resident, Q, dO, L and D streamed over the rep query heads of its
//    kv head and, in each, the query steps that see its keys (causal:
//    from its own tile on). dq_kernel: one block per (b, query head,
//    64-query tile), Q and dO resident, L and D in registers, K and V
//    streamed over the key steps its rows see (causal: up to its
//    diagonal). The blocks with the most steps start first.
//  * Fragments stay in registers. A warp's first two products (S^T = K Q^T
//    and dP^T = V dO^T in dK/dV, S = Q K^T and dP = dO V^T in dQ) leave
//    their 16-row results in the mma accumulator layout; P and dS are
//    formed in place and, with the contracted index of the next product
//    permuted inside each 8-wide step (fragment column t holds index 2t,
//    column t + 4 index 2t + 1), the accumulators are that product's A
//    operands as they stand: dV += P^T dO, dK += dS^T Q, dQ += dS K, with
//    no shared-memory round trip. dK, dV (or dQ) stay in registers until
//    one store.
//  * One streamed tile serves as the first product's B (rows read along
//    d) and the second's (columns read along the streamed rows). An f32
//    tile takes d in its natural order inside each 8-wide step (column t
//    holds index t, t + 4 index t + 4), 4-byte loads, pitch d + 4 (4 mod 8
//    floats); a bf16 tile the paired order (one 4-byte load of indices 2t,
//    2t + 1) and ldmatrix.trans, pitch d + 8 (8 mod 16 elements). Both
//    reads are then free of bank conflicts; the resident tiles take the
//    stream's order (4-byte loads at pitch d + 4, or 8-byte pairs at d + 8).
//  * Causal: steps wholly past the diagonal are not visited, a warp skips
//    a step in which none of its rows sees the other side, and only steps
//    that cross the diagonal or the end of s are masked (P = 0).
//  * No float atomics: the GQA sum of dK and dV runs over the query heads
//    in order inside the block, so a call gives the same bits every time.

#include <cuda_bf16.h>
#include <math.h>

#include "flash_tile.cuh"

namespace {

using namespace flash;

constexpr int BR = 16 * WARPS;  // resident rows a block, 16 a warp
constexpr int MAX_D = 128;
constexpr int MAX_NT = MAX_D / 16;
constexpr int DELTA_THREADS = 256;

// Streamed rows a step: 32, or 16 for dK/dV at the widest heads (NT = 8),
// where dK and dV hold 128 registers a thread and 32 query rows spill.
__host__ __device__ constexpr int step_rows(bool dkdv, int nt) {
    return dkdv && nt >= MAX_NT ? 16 : 32;
}

// 8-wide steps of a product summed in one fresh accumulator (see add_to):
// two, or one for dK/dV at the widest heads, for the same registers.
__host__ __device__ constexpr int group_steps(bool dkdv, int nt) {
    return dkdv && nt >= MAX_NT ? 1 : 2;
}

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

// x = hi + lo for the tensor cores: hi is x rounded to TF32 (cvt.rna), lo =
// x - hi exactly in f32, of which the tensor cores read the top 19 bits (a
// TF32 operand's low 13 bits are ignored), so hi + lo keeps x to about
// 2^-21. One cvt fewer than flash_tile.cuh's split, which the forward keeps
// for its bits; chip_smoke.py holds the gradients against a float64
// backward.
__device__ __forceinline__ void split_hi_lo(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32(x);
    lo = __float_as_uint(x - __uint_as_float(hi));
}

// Shared memory of a kernel whose streamed tiles have type TS, at d padded
// to DP = 16 NT: two resident f32 tiles (BR, RP), then a two-stage ring of
// two streamed tiles of BS rows (BS, SP) and, for dK/dV, of the step's L
// and D.
template <typename TS, int NT, int BS>
struct Layout {
    static constexpr int DP = 16 * NT;
    static constexpr int N8 = DP / 8;                    // 8-wide steps of d
    static constexpr bool PAIRED = sizeof(TS) == 2;      // a bf16 stream
    static constexpr int RP = PAIRED ? DP + 8 : DP + 4;  // resident pitch, floats
    static constexpr int SP = PAIRED ? DP + 8 : DP + 4;  // streamed pitch, elements
    static constexpr int RES = BR * RP;                  // floats of a resident tile
    static constexpr int STR = BS * SP;                  // elements of a streamed tile
    static constexpr int smem(bool rows) {
        return static_cast<int>(2 * RES * sizeof(float) + 4 * STR * sizeof(TS) +
                                (rows ? 4 * BS * sizeof(float) : 0));
    }
    static_assert((RES * sizeof(float)) % 16 == 0 && (STR * sizeof(TS)) % 16 == 0,
                  "16-byte aligned tiles");
};

// Rows [r0, r0 + BR) of an (s, d) head with row stride ``ss`` into an f32
// (BR, DP) tile of pitch RP; rows past s and columns past d read as 0.
template <int DP, int RP, typename T>
__device__ __forceinline__ void stage_f32(float* dst, const T* src, long long ss, int r0,
                                          int s, int d) {
    for (int e = threadIdx.x; e < BR * DP; e += THREADS) {
        const int r = e / DP, c = e - r * DP;
        const int row = r0 + r;
        dst[r * RP + c] =
            row < s && c < d ? to_f32(src[static_cast<long long>(row) * ss + c]) : 0.f;
    }
}

// L and D of the query rows [q0, q0 + BS) (0 past s), by 4-byte cp.async.
template <int BS>
__device__ __forceinline__ void stage_rows(float* l_s, float* d_s, const float* lse,
                                           const float* delta, int q0, int s) {
    const int i = threadIdx.x & (BS - 1);
    const bool ok = q0 + i < s;
    if (threadIdx.x < BS)
        cp_async4(l_s + i, ok ? lse + q0 + i : lse, ok ? 4 : 0);
    else if (threadIdx.x < 2 * BS)
        cp_async4(d_s + i, ok ? delta + q0 + i : delta, ok ? 4 : 0);
}

// A resident A operand (rows [0, 16) at ``base``, pitch RP) for the d step
// kk: rows g and g + 8 at the step's columns t and t + 4 (natural order) or
// 2t and 2t + 1 (PAIRED), as (g, c0), (g + 8, c0), (g, c1), (g + 8, c1).
template <bool PAIRED, int RP>
__device__ __forceinline__ void load_a(const float* base, int kk, int g, int t,
                                       float (&x)[4]) {
    const float* r0 = base + g * RP + 8 * kk;
    const float* r1 = r0 + 8 * RP;
    if constexpr (PAIRED) {
        load_pair(r0 + 2 * t, x[0], x[2]);
        load_pair(r1 + 2 * t, x[1], x[3]);
    } else {
        x[0] = r0[t];
        x[1] = r1[t];
        x[2] = r0[t + 4];
        x[3] = r1[t + 4];
    }
}

// A streamed row's two B values for the d step kk, in the stream's order.
__device__ __forceinline__ void load_b(const float* row, int kk, int t, float& y0, float& y1) {
    y0 = row[8 * kk + t];
    y1 = row[8 * kk + t + 4];
}
__device__ __forceinline__ void load_b(const __nv_bfloat16* row, int kk, int t, float& y0,
                                       float& y1) {
    load_pair(row + 8 * kk + 2 * t, y0, y1);
}

// x as TF32 parts: hi + lo (SPLIT), or its own bits where it is exact in
// TF32 (a bf16 value; lo is then unused)
template <bool SPLIT>
__device__ __forceinline__ void parts(const float (&x)[4], uint32_t (&hi)[4],
                                      uint32_t (&lo)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        if constexpr (SPLIT) {
            split_hi_lo(x[e], hi[e], lo[e]);
        } else {
            hi[e] = __float_as_uint(x[e]);
            lo[e] = 0u;
        }
    }
}

// c += a b over one 8-wide step in split-TF32 terms, the small ones first:
// lo hi + hi lo + hi hi where both are split, one term fewer for each
// operand exact in TF32.
template <bool A_SPLIT, bool B_SPLIT>
__device__ __forceinline__ void mma_terms(float (&c)[4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], float b0, float b1) {
    if constexpr (B_SPLIT) {
        uint32_t h0, l0, h1, l1;
        split_hi_lo(b0, h0, l0);
        split_hi_lo(b1, h1, l1);
        if constexpr (A_SPLIT) mma(c, al, h0, h1);
        mma(c, ah, l0, l1);
        mma(c, ah, h0, h1);
    } else {
        if constexpr (A_SPLIT) mma(c, al, __float_as_uint(b0), __float_as_uint(b1));
        mma(c, ah, __float_as_uint(b0), __float_as_uint(b1));
    }
}

// acc += p in f32 (round to nearest). Every product sums G 8-wide steps
// (group_steps) on the tensor cores into a fresh accumulator p and only
// then adds it to the long sum: the tensor cores' own accumulation
// truncates, and chained over a whole row of s (up to 384 mma into one
// accumulator at s = 1,024) it put the gradients past chip_smoke.py's
// 1e-5 of their max.
__device__ __forceinline__ void add_to(float (&acc)[4], const float (&p)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += p[e];
}

// The second product's A operand, split: a first product's accumulator
// (rows g, g + 8; columns 2t, 2t + 1 of an 8-wide step) in the paired order.
__device__ __forceinline__ void acc_parts(const float (&c)[4], uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
    split_hi_lo(c[0], hi[0], lo[0]);
    split_hi_lo(c[2], hi[1], lo[1]);
    split_hi_lo(c[1], hi[2], lo[2]);
    split_hi_lo(c[3], hi[3], lo[3]);
}

// The next G 8-row groups of c to the front (c[j] = c[j + G]), so that a
// loop over the groups that is not unrolled reads the first ones and c
// stays in registers.
template <int G, int NJ>
__device__ __forceinline__ void rotate(float (&c)[NJ][4]) {
#pragma unroll
    for (int j = 0; j + G < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[j][e] = c[j + G][e];
}

// acc[j] += A X over the streamed rows 8 k0 .. 8 (k0 + G) - 1 of the tile
// xb, for each 8-wide column group j of d; A is G split operands.
// X's B operand is rows 2t and 2t + 1 of column 8 j + g of each 8-row
// group: two 4-byte loads, split, for f32; ldmatrix.trans, exact, for bf16.
template <int N8, int SP, int G>
__device__ __forceinline__ void mma_rows(float (&acc)[N8][4], const uint32_t (&ah)[G][4],
                                         const uint32_t (&al)[G][4], const float* xb, int k0,
                                         int lane) {
    const float* x0 = xb + (8 * k0 + 2 * (lane & 3)) * SP + (lane >> 2);
#pragma unroll
    for (int j = 0; j < N8; ++j) {
        float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int u = 0; u < G; ++u)
            mma_terms<true, true>(p, ah[u], al[u], x0[8 * u * SP + 8 * j],
                                  x0[(8 * u + 1) * SP + 8 * j]);
        add_to(acc[j], p);
    }
}
// acc += A X for one 8-wide column group of a bf16 X: column i of the
// ldmatrix.trans fragments w of the G 8-row groups (exact in TF32).
template <int G, int N>
__device__ __forceinline__ void mma_group(float (&acc)[4], const uint32_t (&ah)[G][4],
                                          const uint32_t (&al)[G][4], const uint32_t (&w)[G][N],
                                          int i) {
    float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int u = 0; u < G; ++u)
        mma_terms<true, false>(p, ah[u], al[u], __uint_as_float(w[u][i] << 16),
                               __uint_as_float(w[u][i] & 0xffff0000u));
    add_to(acc, p);
}
template <int N8, int SP, int G>
__device__ __forceinline__ void mma_rows(float (&acc)[N8][4], const uint32_t (&ah)[G][4],
                                         const uint32_t (&al)[G][4], const __nv_bfloat16* xb,
                                         int k0, int lane) {
    const __nv_bfloat16* xrow = xb + (8 * k0 + (lane & 7)) * SP;
#pragma unroll
    for (int j = 0; j + 4 <= N8; j += 4) {
        uint32_t w[G][4];
#pragma unroll
        for (int u = 0; u < G; ++u)
            ldmatrix_t(w[u], xrow + 8 * u * SP + 8 * (j + (lane >> 3)));
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_group(acc[j + i], ah, al, w, i);
    }
    if constexpr (N8 % 4 != 0) {
        constexpr int j = N8 - 2;
        uint32_t w[G][2];
#pragma unroll
        for (int u = 0; u < G; ++u)
            ldmatrix_t(w[u], xrow + 8 * u * SP + 8 * (j + ((lane >> 3) & 1)));
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_group(acc[j + i], ah, al, w, i);
    }
}

// The first two products of a step for a warp's 16 resident rows: c1 =
// A1 X1^T and c2 = A2 X2^T over d, A resident (f32, split unless exact),
// X streamed rows (split unless bf16).
template <int N8, int RP, int SP, bool PAIRED, bool R_SPLIT, bool S_SPLIT, int G, int NJ,
          typename TS>
__device__ __forceinline__ void two_products(float (&c1)[NJ][4], float (&c2)[NJ][4],
                                             const float* a1, const float* a2, const TS* x1,
                                             const TS* x2, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c1[j][e] = c2[j][e] = 0.f;
    // k0 only moves the loads: a loop, not unrolled, so that the scheduler
    // does not hold every group's partial products at once (ptxas spilled)
#pragma unroll 1
    for (int k0 = 0; k0 < N8; k0 += G) {
        uint32_t xh[G][4], xl[G][4], zh[G][4], zl[G][4];
#pragma unroll
        for (int u = 0; u < G; ++u) {
            float x[4], z[4];
            load_a<PAIRED, RP>(a1, k0 + u, g, t, x);
            load_a<PAIRED, RP>(a2, k0 + u, g, t, z);
            parts<R_SPLIT>(x, xh[u], xl[u]);
            parts<R_SPLIT>(z, zh[u], zl[u]);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            float p1[4] = {0.f, 0.f, 0.f, 0.f}, p2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int u = 0; u < G; ++u) {
                float y0, y1;
                load_b(x1 + (8 * j + g) * SP, k0 + u, t, y0, y1);
                mma_terms<R_SPLIT, S_SPLIT>(p1, xh[u], xl[u], y0, y1);
                load_b(x2 + (8 * j + g) * SP, k0 + u, t, y0, y1);
                mma_terms<R_SPLIT, S_SPLIT>(p2, zh[u], zl[u], y0, y1);
            }
            add_to(c1[j], p1);
            add_to(c2[j], p2);
        }
    }
}

template <typename TQ, typename TKV, int NT, bool ASYNC>
__global__ void __launch_bounds__(THREADS, 1) dkdv_kernel(Args a) {
    constexpr int BS = step_rows(true, NT), NJ = BS / 8, G = group_steps(true, NT);
    using Ly = Layout<TQ, NT, BS>;  // Q, dO, L and D stream; K and V stay
    constexpr int DP = Ly::DP, N8 = Ly::N8, RP = Ly::RP, SP = Ly::SP;
    extern __shared__ __align__(16) unsigned char smem[];
    float* k_s = reinterpret_cast<float*>(smem);
    float* v_s = k_s + Ly::RES;
    TQ* q_s = reinterpret_cast<TQ*>(v_s + Ly::RES);  // [2][BS][SP]
    TQ* o_s = q_s + 2 * Ly::STR;
    float* l_s = reinterpret_cast<float*>(o_s + 2 * Ly::STR);  // [2][BS]
    float* dl_s = l_s + 2 * BS;

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int n_bkv = a.bh / a.rep;
    const int kt = static_cast<int>(blockIdx.x) / n_bkv;  // low key tiles (most work) first
    const int gk = static_cast<int>(blockIdx.x) - kt * n_bkv;
    const int bi = gk / a.kv, ki = gk - bi * a.kv;
    const int k0 = kt * BR, wk0 = k0 + 16 * warp;  // the block's and the warp's first key
    const int qs0 = a.causal ? k0 / BS : 0;         // the first step that sees a key
    const int nq = (a.s + BS - 1) / BS - qs0, n_steps = a.rep * nq;

    // step i: query head ki rep + i / nq, queries from (qs0 + i % nq) BS
    auto issue = [&](int i, int buf) {
        const int r = i / nq, q0 = (qs0 + i - r * nq) * BS, hi = ki * a.rep + r;
        stage<ASYNC, BS, DP, SP>(q_s + buf * Ly::STR,
                                 static_cast<const TQ*>(a.q) + bi * a.q_sb + hi * a.q_sh,
                                 a.q_ss, q0, a.s, a.d);
        stage<ASYNC, BS, DP, SP>(o_s + buf * Ly::STR,
                                 static_cast<const TQ*>(a.dout) + bi * a.do_sb + hi * a.do_sh,
                                 a.do_ss, q0, a.s, a.d);
        const long long row0 = (static_cast<long long>(bi) * a.h + hi) * a.s;
        stage_rows<BS>(l_s + buf * BS, dl_s + buf * BS, a.lse + row0, a.delta + row0, q0,
                       a.s);
        cp_async_commit();
    };
    issue(0, 0);
    stage_f32<DP, RP>(k_s, static_cast<const TKV*>(a.k) + bi * a.k_sb + ki * a.k_sh, a.k_ss,
                      k0, a.s, a.d);
    stage_f32<DP, RP>(v_s, static_cast<const TKV*>(a.v) + bi * a.v_sb + ki * a.v_sh, a.v_ss,
                      k0, a.s, a.d);

    float dk[N8][4], dv[N8][4];
#pragma unroll
    for (int j = 0; j < N8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

    for (int i = 0; i < n_steps; ++i) {
        const int buf = i & 1;
        if (i + 1 < n_steps) {  // the next step streams in during this one
            issue(i + 1, buf ^ 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const int q0 = (qs0 + i % nq) * BS;
        if (!a.causal || wk0 <= q0 + BS - 1) {  // some key of the warp sees the step
            const TQ* qb = q_s + buf * Ly::STR;
            const TQ* ob = o_s + buf * Ly::STR;
            const float* lb = l_s + buf * BS;
            const float* db = dl_s + buf * BS;
            float st[NJ][4], dpt[NJ][4];  // S^T = K Q^T and dP^T = V dO^T
            two_products<N8, RP, SP, Ly::PAIRED, sizeof(TKV) == 4, sizeof(TQ) == 4, G>(
                st, dpt, k_s + 16 * warp * RP, v_s + 16 * warp * RP, qb, ob, lane);
            // P^T = exp(S^T scale - L), dS^T = P^T (dP^T - D) in place: entry e
            // of column group j is key wk0 + g + 8 (e >> 1), query q0 + c
            const bool edge = q0 + BS > a.s || (a.causal && wk0 + 15 > q0);
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int c = 8 * j + 2 * t + (e & 1);
                    float p = expf(st[j][e] * a.scale - lb[c]);
                    if (edge) {
                        const int qi = q0 + c, kj = wk0 + g + 8 * (e >> 1);
                        if (qi >= a.s || (a.causal && kj > qi)) p = 0.f;
                    }
                    dpt[j][e] = p * (dpt[j][e] - db[c]);
                    st[j][e] = p;
                }
            // dV += P^T dO, then dK += dS^T Q, over the step's queries, G
            // 8-row groups at a time (loops not unrolled, as the first
            // products; one loop for both spilled at d = 128)
#pragma unroll 1
            for (int kg = 0; kg < NJ; kg += G) {
                uint32_t ph[G][4], pl[G][4];
#pragma unroll
                for (int u = 0; u < G; ++u) acc_parts(st[u], ph[u], pl[u]);
                mma_rows<N8, SP, G>(dv, ph, pl, ob, kg, lane);
                rotate<G>(st);
            }
#pragma unroll 1
            for (int kg = 0; kg < NJ; kg += G) {
                uint32_t sh[G][4], sl[G][4];
#pragma unroll
                for (int u = 0; u < G; ++u) acc_parts(dpt[u], sh[u], sl[u]);
                mma_rows<N8, SP, G>(dk, sh, sl, qb, kg, lane);
                rotate<G>(dpt);
            }
        }
        __syncthreads();  // every warp is done with this stage before it is refilled
    }

    TKV* gk_out = static_cast<TKV*>(a.dk) + bi * a.dk_sb + ki * a.dk_sh;
    TKV* gv_out = static_cast<TKV*>(a.dv) + bi * a.dv_sb + ki * a.dv_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int kj = wk0 + g + 8 * r;
        if (kj >= a.s) continue;
#pragma unroll
        for (int j = 0; j < N8; ++j) {
            const int c = 8 * j + 2 * t;
            if (c < a.d) {
                gk_out[kj * a.dk_ss + c] = from_f32<TKV>(dk[j][2 * r] * a.scale);
                gv_out[kj * a.dv_ss + c] = from_f32<TKV>(dv[j][2 * r]);
            }
            if (c + 1 < a.d) {
                gk_out[kj * a.dk_ss + c + 1] = from_f32<TKV>(dk[j][2 * r + 1] * a.scale);
                gv_out[kj * a.dv_ss + c + 1] = from_f32<TKV>(dv[j][2 * r + 1]);
            }
        }
    }
}

template <typename TQ, typename TKV, int NT, bool ASYNC>
__global__ void __launch_bounds__(THREADS, 1) dq_kernel(Args a) {
    constexpr int BS = step_rows(false, NT), NJ = BS / 8, G = group_steps(false, NT);
    using Ly = Layout<TKV, NT, BS>;  // K and V stream; Q and dO stay
    constexpr int DP = Ly::DP, N8 = Ly::N8, RP = Ly::RP, SP = Ly::SP;
    extern __shared__ __align__(16) unsigned char smem[];
    float* q_s = reinterpret_cast<float*>(smem);
    float* o_s = q_s + Ly::RES;
    TKV* k_s = reinterpret_cast<TKV*>(o_s + Ly::RES);  // [2][BS][SP]
    TKV* v_s = k_s + 2 * Ly::STR;

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int n_blk = static_cast<int>(blockIdx.x);
    const int gi = n_blk % a.bh;              // flattened (batch, query head)
    const int qt = a.n_t - 1 - n_blk / a.bh;  // the longest rows first
    const int bi = gi / a.h, hi = gi - bi * a.h, ki = hi / a.rep;
    const int q0 = qt * BR, wq0 = q0 + 16 * warp;  // the block's and the warp's first query
    const TKV* k = static_cast<const TKV*>(a.k) + bi * a.k_sb + ki * a.k_sh;
    const TKV* v = static_cast<const TKV*>(a.v) + bi * a.v_sb + ki * a.v_sh;
    int n_ks = (a.s + BS - 1) / BS;
    if (a.causal) n_ks = min(n_ks, (min(q0 + BR, a.s) - 1) / BS + 1);

    auto issue = [&](int kt, int buf) {
        stage<ASYNC, BS, DP, SP>(k_s + buf * Ly::STR, k, a.k_ss, kt * BS, a.s, a.d);
        stage<ASYNC, BS, DP, SP>(v_s + buf * Ly::STR, v, a.v_ss, kt * BS, a.s, a.d);
        cp_async_commit();
    };
    issue(0, 0);
    stage_f32<DP, RP>(q_s, static_cast<const TQ*>(a.q) + bi * a.q_sb + hi * a.q_sh, a.q_ss, q0,
                      a.s, a.d);
    stage_f32<DP, RP>(o_s, static_cast<const TQ*>(a.dout) + bi * a.do_sb + hi * a.do_sh,
                      a.do_ss, q0, a.s, a.d);
    float l_row[2], d_row[2];  // L and D of this lane's rows wq0 + g and wq0 + g + 8
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int qi = wq0 + g + 8 * r;
        const long long row = static_cast<long long>(gi) * a.s + qi;
        l_row[r] = qi < a.s ? a.lse[row] : 0.f;
        d_row[r] = qi < a.s ? a.delta[row] : 0.f;
    }

    float acc[N8][4];
#pragma unroll
    for (int j = 0; j < N8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    for (int kt = 0; kt < n_ks; ++kt) {
        const int buf = kt & 1, k0 = kt * BS;
        if (kt + 1 < n_ks) {  // the next step streams in during this one
            issue(kt + 1, buf ^ 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        if (!a.causal || k0 <= wq0 + 15) {  // some row of the warp sees the step
            const TKV* kb = k_s + buf * Ly::STR;
            const TKV* vb = v_s + buf * Ly::STR;
            float sc[NJ][4], dp[NJ][4];  // S = Q K^T and dP = dO V^T
            two_products<N8, RP, SP, Ly::PAIRED, sizeof(TQ) == 4, sizeof(TKV) == 4, G>(
                sc, dp, q_s + 16 * warp * RP, o_s + 16 * warp * RP, kb, vb, lane);
            // dS = P (dP - D), P = exp(S scale - L), in place: entry e of
            // column group j is query wq0 + g + 8 (e >> 1), key k0 + 8 j + 2t + (e & 1)
            const bool edge = k0 + BS > a.s || (a.causal && k0 + BS - 1 > wq0);
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int r = e >> 1;
                    float p = expf(sc[j][e] * a.scale - l_row[r]);
                    if (edge) {
                        const int kj = k0 + 8 * j + 2 * t + (e & 1), qi = wq0 + g + 8 * r;
                        if (kj >= a.s || (a.causal && kj > qi)) p = 0.f;
                    }
                    sc[j][e] = p * (dp[j][e] - d_row[r]);
                }
            // dQ += dS K over the step's keys, G 8-row groups at a time
#pragma unroll 1
            for (int kg = 0; kg < NJ; kg += G) {
                uint32_t sh[G][4], sl[G][4];
#pragma unroll
                for (int u = 0; u < G; ++u) acc_parts(sc[u], sh[u], sl[u]);
                mma_rows<N8, SP, G>(acc, sh, sl, kb, kg, lane);
                rotate<G>(sc);
            }
        }
        __syncthreads();  // every warp is done with this stage before it is refilled
    }

    TQ* g_out = static_cast<TQ*>(a.dq) + bi * a.dq_sb + hi * a.dq_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int qi = wq0 + g + 8 * r;
        if (qi >= a.s) continue;
#pragma unroll
        for (int j = 0; j < N8; ++j) {
            const int c = 8 * j + 2 * t;
            if (c < a.d) g_out[qi * a.dq_ss + c] = from_f32<TQ>(acc[j][2 * r] * a.scale);
            if (c + 1 < a.d)
                g_out[qi * a.dq_ss + c + 1] = from_f32<TQ>(acc[j][2 * r + 1] * a.scale);
        }
    }
}

// D[row] = sum_c dO[row][c] O[row][c] in f32, one warp a row of the
// (b, h, s) rows; O and dO in q's type.
template <typename T>
__global__ void __launch_bounds__(DELTA_THREADS) delta_kernel(Args a, const void* o_ptr,
                                                              long long o_sb, long long o_sh,
                                                              long long o_ss, float* delta) {
    const int lane = threadIdx.x & 31;
    const long long row =
        static_cast<long long>(blockIdx.x) * (DELTA_THREADS / 32) + (threadIdx.x >> 5);
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

template <int NT, bool ASYNC, typename TQ, typename TKV>
int launch_nt(const Args& a, bool dq, cudaStream_t stream) {
    const long long n_blocks = static_cast<long long>(dq ? a.bh : a.bh / a.rep) * a.n_t;
    const int smem = dq ? Layout<TKV, NT, step_rows(false, NT)>::smem(false)
                        : Layout<TQ, NT, step_rows(true, NT)>::smem(true);
    auto kernel = dq ? dq_kernel<TQ, TKV, NT, ASYNC> : dkdv_kernel<TQ, TKV, NT, ASYNC>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<static_cast<unsigned>(n_blocks), THREADS, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int launch_types(const Args& a, bool dq, bool async_copy, cudaStream_t stream) {
    if (!async_copy) return launch_nt<MAX_NT, false, TQ, TKV>(a, dq, stream);
    switch ((a.d + 15) / 16) {
        case 1: return launch_nt<1, true, TQ, TKV>(a, dq, stream);
        case 2: return launch_nt<2, true, TQ, TKV>(a, dq, stream);
        case 3: return launch_nt<3, true, TQ, TKV>(a, dq, stream);
        case 4: return launch_nt<4, true, TQ, TKV>(a, dq, stream);
        case 5: return launch_nt<5, true, TQ, TKV>(a, dq, stream);
        case 6: return launch_nt<6, true, TQ, TKV>(a, dq, stream);
        case 7: return launch_nt<7, true, TQ, TKV>(a, dq, stream);
        default: return launch_nt<8, true, TQ, TKV>(a, dq, stream);
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
                b * h, h, kv, h / kv, s, d, (s + BR - 1) / BR, causal, scale};
}

int dispatch(const Args& a, int q_type, int kv_type, bool dq, bool async_copy,
             cudaStream_t stream) {
    if (q_type == 0 && kv_type == 0)
        return launch_types<float, float>(a, dq, async_copy, stream);
    if (q_type == 0 && kv_type == 1)
        return launch_types<float, __nv_bfloat16>(a, dq, async_copy, stream);
    if (q_type == 1 && kv_type == 1)
        return launch_types<__nv_bfloat16, __nv_bfloat16>(a, dq, async_copy, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Types as in gpic_flash_attention: 0 = f32, 1 = bf16; dO has q's type.
// Strides are in elements, three a tensor ((b, head, s) with d contiguous).
// D (delta) and L (lse) are (b, h, s) f32, contiguous. async_copy: the
// streamed rows (q and dO for dK/dV, k and v for dQ) and d are 16-byte
// aligned, so the tiles stream in with cp.async; 0 takes the scalar-staging
// template.

// delta = rowsum(dO * O): o and dout (b, h, s, d) in q's type.
extern "C" int gpic_flash_attention_bwd_delta(
    const void* o, const void* dout, float* delta, int q_type, int b, int h, int s, int d,
    long long o_sb, long long o_sh, long long o_ss,
    long long do_sb, long long do_sh, long long do_ss, cudaStream_t stream) {
    const long long rows = static_cast<long long>(b) * h * s;
    const long long n_blocks = (rows + DELTA_THREADS / 32 - 1) / (DELTA_THREADS / 32);
    const int bad = check_shape(b, h, h, s, d, n_blocks);
    if (bad) return bad;
    const long long st[21] = {0, 0, 0, 0, 0, 0, 0, 0, 0, do_sb, do_sh, do_ss};
    const Args a = make_args(nullptr, nullptr, nullptr, dout, nullptr, delta, nullptr, nullptr,
                             nullptr, b, h, h, s, d, st, 0, 0.f);
    if (q_type == 0)
        delta_kernel<float><<<static_cast<unsigned>(n_blocks), DELTA_THREADS, 0, stream>>>(
            a, o, o_sb, o_sh, o_ss, delta);
    else if (q_type == 1)
        delta_kernel<__nv_bfloat16>
            <<<static_cast<unsigned>(n_blocks), DELTA_THREADS, 0, stream>>>(a, o, o_sb, o_sh,
                                                                            o_ss, delta);
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
    int causal, float scale, int async_copy, cudaStream_t stream) {
    const int bad = check_shape(b, h, kv, s, d,
                                static_cast<long long>(b) * kv * ((s + BR - 1) / BR));
    if (bad) return bad;
    const long long st[21] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                              do_sb, do_sh, do_ss, 0, 0, 0,
                              dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss};
    const Args a = make_args(q, k, v, dout, lse, delta, nullptr, dk, dv, b, h, kv, s, d, st,
                             causal, scale);
    return dispatch(a, q_type, kv_type, false, async_copy != 0, stream);
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
    int causal, float scale, int async_copy, cudaStream_t stream) {
    const int bad = check_shape(b, h, kv, s, d,
                                static_cast<long long>(b) * h * ((s + BR - 1) / BR));
    if (bad) return bad;
    const long long st[21] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                              do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss};
    const Args a = make_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr, b, h, kv, s, d,
                             st, causal, scale);
    return dispatch(a, q_type, kv_type, true, async_copy != 0, stream);
}
