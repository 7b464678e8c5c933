// qmm.cu — packed dequant-matmul y[B,N] f32 = x[B,K] bf16 · dequant(W[N,K])ᵀ
// for Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, Q2_K, Q3_K, Q4_K, Q5_K and Q6_K weights,
// and for the IQ / TQ kinds (IQ4_NL, IQ4_XS, IQ2_XXS, IQ2_XS, IQ2_S,
// IQ3_XXS, IQ3_S, IQ1_S, IQ1_M, TQ1_0, TQ2_0), kept packed in device memory.
//
// Replaces: llama_cpp_dsp_tpu/ops/pallas/qmm.py::_kernel with the Q4_0 body
// (_body_q4_0 via _q4_tile_dot), the Q4_1 body (_body_q4_1), the Q5_0 and
// Q5_1 bodies (_body_q5_0, _body_q5_1), the Q8_0 body (_body_q8_0), the
// K-quant bodies _body_q2_K, _body_q3_K, _body_q4_K, _body_q5_K and
// _body_q6_K, and the table bodies _body_iq4 (IQ4_NL, IQ4_XS), _body_tab32
// (IQ2_XXS, IQ3_XXS, IQ3_S, IQ1_S, TQ1_0, TQ2_0) and _body_tab16 (IQ2_XS,
// IQ2_S, IQ1_M). It computes what those bodies compute, not their Mosaic
// plane layout: the weights stay in GGUF block order, with the K-quants'
// packed scales unpacked once at load (ops/qtensor.py):
//   Q2_K: qs u8 [N,K/4], sc/mn u8 [N,S,16], d/dmin f32 [N,S]  (S = K/256)
//         w = (d*sc)*q - dmin*mn per 16-element group; in each 128-element
//         half h, bits 2j..2j+1 of byte l (qs[32h + l]) hold element 32j+l
//   Q3_K: qs u8 [N,K/4] in Q2_K's order, hmask u8 [N,S,32], sc i8 [N,S,16]
//         (-32 applied), d f32 [N,S]; w = (d*sc)*(q - 4 + 4h) per 16-element
//         group, h = bit e/32 of hmask[e%32] for element e of the superblock
//   Q4_K: qs u8 [N,K/2], sc/mn u8 [N,S,8], d/dmin f32 [N,S]
//         w = (d*sc)*q - dmin*mn per 32-element group; in each 64-element
//         chunk j, byte l holds element l of group 2j (low nibble) and of
//         group 2j+1 (high nibble)
//   Q5_K: the Q4_K fields + qh u8 [N,S,32] (bit g of byte l: element 32g+l)
//   Q6_K: ql u8 [N,K/2], qh u8 [N,K/4], sc i8 [N,S,16], d f32 [N,S]
//         w = d*sc*(q-32) per 16-element group; in each 128-element half,
//         element l+32i (l < 32) is ql[l] (i even) or ql[l+32] (i odd), low
//         nibble for i < 2, high for i >= 2, plus bits 2i..2i+1 of qh[l]
//   the table kinds (TableNib): qs u8 [N,K/2] of 4-bit codes in Q4_0's
//         nibble order, d [N,K/G]; w = table[code] * d per G-weight group,
//         the table the kind's <= 16 integers (IQ4: kvalues_iq4nl; the grid
//         and ternary kinds: quant/iq.py IQ_TABLES, an exact decomposition
//         made at load); G = 32 (d f16 for IQ4_NL, f32 else) or 16 (IQ2_XS,
//         IQ2_S, IQ1_M: a block's low nibbles take scale 2b, its high ones
//         2b+1)
//
// Bound on this card: at decode (B <= 8) the weight bytes a product needs
// over the memory rate, counted in GGUF blocks: per 256 weights 144 B
// (Q4_0), 160 (Q4_1), 176 (Q5_0), 192 (Q5_1), 272 (Q8_0), 84 (Q2_K), 110
// (Q3_K), 144 (Q4_K), 176 (Q5_K), 210 (Q6_K), 144 (IQ4_NL), 136 (IQ4_XS),
// 66 (IQ2_XXS), 74 (IQ2_XS), 82 (IQ2_S), 98 (IQ3_XXS), 110 (IQ3_S), 50
// (IQ1_S), 56 (IQ1_M), 54 (TQ1_0) and 66 (TQ2_0). The repacked layout moves
// more for the K-quants: 104 (Q2_K: the unpacked 4-bit scale/min pairs and
// f32 d/dmin cost 20), 116 (Q3_K: the 6-bit scales unpacked to bytes, d in
// f32), 152 (Q4_K), 184 (Q5_K) and 212 (Q6_K); the table carrier moves 160
// (G = 32 with f32 scales: IQ4_XS and the tab32 kinds) or 192 (G = 16),
// IQ4_NL its own 144; the arithmetic is ~2 operations per weight element
// and activation row.
// Design: B <= 8 runs a GEMV, one warp per output row, lanes striding over
// units of the row: a 32-element block for Q4_0/Q8_0 and the Q4_1/Q5_0/Q5_1
// structs (one 16-byte load of packed bits, two for Q8_0, plus the block's
// 4-byte qh word for Q5_0/Q5_1); a 64-element chunk for Q4_K/Q5_K (two 16-byte
// qs loads, consecutive lanes on consecutive chunks; Q5_K adds the 32-byte
// qh of the superblock, shared by its four chunks through L1); for Q6_K a
// 64-element unit of 16 consecutive l of one half, all four i (three
// 16-byte loads: ql[l], ql[l+32], qh[l]), so K = 4096 gives 64 units for 32
// lanes; for Q2_K/Q3_K the same 64-element unit, 16 consecutive l of one
// half and all four shifts j (one 16-byte qs load, Q3_K one more of hmask,
// 8 scale bytes), so K = 3584 gives 56 units and K = 768 twelve; for the
// table kinds a 32-element block (one 16-byte qs load, one or two scales,
// the table values by __byte_perm from four registers). Following
// ggml's vec_dot order each group's dot of the integer values with x is
// scaled once by its effective scale (d·sc), and for Q2_K/Q4_K/Q5_K the
// group's dmin·mn·Σx is subtracted; sums across lanes by warp shuffles; the
// activations stay in L1/L2 and the weights are read once.
// B > 8 (prefill) runs a tiled tensor-core kernel: a 64x64 output tile per
// block, each 32-wide K step dequantizes its weight tile into shared memory
// as bf16 (rounded from the same f32 products as the plain version) and
// multiplies it with WMMA bf16 fragments, f32 accumulation. Both are simple
// first versions: no TMA, no wgmma, no pipelining across K steps.
//
// The MoE selected-expert GEMV (qmm_experts_*) replaces
// llama_cpp_dsp_tpu/ops/pallas/qmm.py::_kernel_experts (entry
// qmm_expert_rows): y[s] = x[s] · dequant(W[sel[s]])ᵀ for an expert stack
// W [E, N, K] whose fields carry a leading expert axis. The TPU kernel's
// scalar-prefetched expert ids drive its BlockSpec index maps; here block
// row blockIdx.y = s reads sel[s] from device memory (clamped to [0, E), so
// no id reads outside the stack), offsets every field pointer by that
// expert's size (`at_expert`) and runs the GEMV's warp-per-row loop with one
// activation row. Bound: the selected experts' packed bytes over the memory
// rate (rows that pick the same expert read it again, as in the TPU kernel).
#include "common.cuh"

#include <mma.h>  // after cuda_bf16.h (common.cuh): bf16 WMMA fragments

namespace {

constexpr int GEMV_WARPS = 4;  // output rows per block

// 8 bf16 in a 16-byte vector → f32 (exact)
__device__ __forceinline__ void bf16x8(const uint4 v, float out[8]) {
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        out[2 * e] = bf16_lo(u[e]);
        out[2 * e + 1] = bf16_hi(u[e]);
    }
}

// byte t of a 16-byte vector
__device__ __forceinline__ uint32_t byte_of(const uint4 v, int t) {
    const uint32_t w = t < 4 ? v.x : t < 8 ? v.y : t < 12 ? v.z : v.w;
    return (w >> (8 * (t & 3))) & 0xffu;
}

// Each weight kind is a struct of its field pointers with
//   UNIT                   elements of one GEMV lane step
//   unit_dot<NB>(row, u, x, K, acc)   acc[b] += the dot of unit u of weight
//                          row `row` with activation rows b < NB
//   dequant16(row, K, k0, out)        bf16 weights k0 .. k0+15 of the row
//                          (k0 % 16 == 0), rounded like the plain version

template <class Q>
struct Legacy {  // Q4_0 / Q8_0 (common.cuh)
    const uint8_t* qs;
    const __half* d;
    static constexpr int UNIT = 32;

    template <int NB>
    __device__ __forceinline__ void unit_dot(int row, int u, const __nv_bfloat16* x, int K,
                                             float acc[NB]) const {
        const int nb = K >> 5;
        block_dot<Q, NB>(qs + (size_t)row * (size_t)(nb * Q::QS_BYTES), d + (size_t)row * nb,
                         u, x, K, acc);
    }

    // the same fields of expert e of an [E, N, K] stack
    __device__ __forceinline__ Legacy at_expert(int e, int N, int K) const {
        const size_t rows = (size_t)e * N, nb = K >> 5;
        return Legacy{qs + rows * nb * Q::QS_BYTES, d + rows * nb};
    }

    __device__ __forceinline__ void dequant16(int row, int K, int k0,
                                              __nv_bfloat16 out[16]) const {
        const int nb = K >> 5, kb = k0 >> 5, h = (k0 >> 4) & 1;
        float w[32];
        Q::unpack(qs + (size_t)row * (size_t)(nb * Q::QS_BYTES), kb, w);
        const float s = __half2float(__ldg(d + (size_t)row * nb + kb));
#pragma unroll
        for (int i = 0; i < 16; ++i) out[i] = __float2bfloat16(w[16 * h + i] * s);
    }
};

// Q4_1 (M), Q5_0 (Q5) and Q5_1 (Q5 and M): 32-element blocks, Q4_0's nibble
// order (byte j: element j low, j+16 high), Q5's fifth bits in a 32-bit
// word per block (bit j: element j), d and m f16 per block. Q5_0 takes
// w = d*(q-16), the _1 kinds w = d*q + m: the integer dot is scaled once by
// d and the _1 kinds add m·Σx, as ggml's vec_dot does. K need not be a
// multiple of 256 (DeepSeek-V2-Lite's expert rows have K = 1408): a row is
// K/32 whole blocks, its qs stride K/2 bytes and qh stride K/8 bytes stay
// 16- and 4-byte multiples, and d/m are read one f16 at a time.
template <bool Q5, bool M>
struct LegacyQ5M {
    const uint8_t* qs;
    const uint32_t* qh;  // Q5 only
    const __half *d, *m;  // m: M only
    static constexpr int UNIT = 32;

    // integer values of block kb of a row: w[i] (i < 16) from byte i's low
    // nibble, w[i+16] from its high one, 16 added where the fifth bit is set
    __device__ __forceinline__ void unpack(size_t blk, float w[32]) const {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(qs + blk * 16));
        const uint32_t h = Q5 ? __ldg(qh + blk) : 0u;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const uint32_t byte = byte_of(q, i);
            uint32_t lo = byte & 0x0fu, hi = byte >> 4;
            if (Q5) {
                lo |= ((h >> i) & 1u) << 4;
                hi |= ((h >> (i + 16)) & 1u) << 4;
            }
            w[i] = (float)lo;
            w[i + 16] = (float)hi;
        }
    }

    template <int NB>
    __device__ __forceinline__ void unit_dot(int row, int u, const __nv_bfloat16* x, int K,
                                             float acc[NB]) const {
        const size_t blk = (size_t)row * (K >> 5) + u;
        float w[32];
        unpack(blk, w);
        const float dd = __half2float(__ldg(d + blk));
        const float mm = M ? __half2float(__ldg(m + blk)) : 0.f;
#pragma unroll
        for (int b = 0; b < NB; ++b) {
            const uint4* xp = reinterpret_cast<const uint4*>(x + (size_t)b * K + (size_t)u * 32);
            float s = 0.f, xs = 0.f;
#pragma unroll
            for (int v = 0; v < 4; ++v) {
                float xf[8];
                bf16x8(__ldg(xp + v), xf);
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    const float wq = Q5 && !M ? w[8 * v + e] - 16.f : w[8 * v + e];
                    s = fmaf(wq, xf[e], s);
                    if (M) xs += xf[e];
                }
            }
            acc[b] = fmaf(dd, s, acc[b]);
            if (M) acc[b] = fmaf(mm, xs, acc[b]);
        }
    }

    __device__ __forceinline__ LegacyQ5M at_expert(int e, int N, int K) const {
        const size_t blk = (size_t)e * N * (K >> 5);  // blocks before expert e
        return LegacyQ5M{qs + blk * 16, Q5 ? qh + blk : qh, d + blk, M ? m + blk : m};
    }

    __device__ __forceinline__ void dequant16(int row, int K, int k0,
                                              __nv_bfloat16 out[16]) const {
        const size_t blk = (size_t)row * (K >> 5) + (k0 >> 5);
        const int h = (k0 >> 4) & 1;
        float w[32];
        unpack(blk, w);
        const float dd = __half2float(__ldg(d + blk));
        const float mm = M ? __half2float(__ldg(m + blk)) : 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) {  // q*d (+ m), two roundings as the plain version
            const float q = w[16 * h + i] - (Q5 && !M ? 16.f : 0.f);
            const float y = M ? __fadd_rn(__fmul_rn(q, dd), mm) : __fmul_rn(q, dd);
            out[i] = __float2bfloat16(y);
        }
    }
};

template <bool Q5>
struct KQuant45 {  // Q4_K, and Q5_K with qh
    const uint8_t *qs, *qh, *sc, *mn;
    const float *d, *dmin;
    static constexpr int UNIT = 64;  // chunk j of superblock s: groups 2j, 2j+1

    template <int NB>
    __device__ __forceinline__ void unit_dot(int row, int u, const __nv_bfloat16* x, int K,
                                             float acc[NB]) const {
        const int s = u >> 2, j = u & 3;
        const size_t sb = (size_t)row * (K >> 8) + s;
        const uint4* qp = reinterpret_cast<const uint4*>(qs + sb * 128 + 32 * j);
        const uint4 q0 = __ldg(qp), q1 = __ldg(qp + 1);
        uint4 h0 = make_uint4(0, 0, 0, 0), h1 = h0;
        if (Q5) {
            const uint4* hp = reinterpret_cast<const uint4*>(qh + sb * 32);
            h0 = __ldg(hp);
            h1 = __ldg(hp + 1);
        }
        const float dd = __ldg(d + sb), dm = __ldg(dmin + sb);
        const float dl0 = dd * (float)__ldg(sc + sb * 8 + 2 * j);
        const float dl1 = dd * (float)__ldg(sc + sb * 8 + 2 * j + 1);
        const float ml0 = dm * (float)__ldg(mn + sb * 8 + 2 * j);
        const float ml1 = dm * (float)__ldg(mn + sb * 8 + 2 * j + 1);
        float s0[NB], s1[NB], x0[NB], x1[NB];  // per row: dots and x sums of the two groups
#pragma unroll
        for (int b = 0; b < NB; ++b) s0[b] = s1[b] = x0[b] = x1[b] = 0.f;
#pragma unroll
        for (int v = 0; v < 4; ++v) {  // elements 8v .. 8v+7 of each group
            float wl[8], wh[8];        // integer values of groups 2j and 2j+1
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                const int l = 8 * v + e;
                const uint32_t byte = byte_of(l < 16 ? q0 : q1, l & 15);
                wl[e] = (float)(byte & 0x0fu);
                wh[e] = (float)(byte >> 4);
                if (Q5) {
                    const uint32_t hb = byte_of(l < 16 ? h0 : h1, l & 15);
                    wl[e] += (float)(((hb >> (2 * j)) & 1u) << 4);
                    wh[e] += (float)(((hb >> (2 * j + 1)) & 1u) << 4);
                }
            }
#pragma unroll
            for (int b = 0; b < NB; ++b) {
                const uint4* xp = reinterpret_cast<const uint4*>(
                    x + (size_t)b * K + (size_t)s * 256 + 64 * j);
                float xf[8], xg[8];
                bf16x8(__ldg(xp + v), xf);      // group 2j
                bf16x8(__ldg(xp + 4 + v), xg);  // group 2j+1
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    s0[b] = fmaf(wl[e], xf[e], s0[b]);
                    x0[b] += xf[e];
                    s1[b] = fmaf(wh[e], xg[e], s1[b]);
                    x1[b] += xg[e];
                }
            }
        }
#pragma unroll
        for (int b = 0; b < NB; ++b)
            acc[b] += dl0 * s0[b] - ml0 * x0[b] + dl1 * s1[b] - ml1 * x1[b];
    }

    __device__ __forceinline__ KQuant45 at_expert(int e, int N, int K) const {
        const size_t sb = (size_t)e * N * (K >> 8);  // superblocks before expert e
        return KQuant45{qs + sb * 128, Q5 ? qh + sb * 32 : qh, sc + sb * 8, mn + sb * 8,
                        d + sb, dmin + sb};
    }

    __device__ __forceinline__ void dequant16(int row, int K, int k0,
                                              __nv_bfloat16 out[16]) const {
        const int r = k0 & 255, g = r >> 5, l0 = r & 31;  // l0: 0 or 16
        const size_t sb = (size_t)row * (K >> 8) + (k0 >> 8);
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(qs + sb * 128 + 32 * (g >> 1) + l0));
        uint4 h = make_uint4(0, 0, 0, 0);
        if (Q5) h = __ldg(reinterpret_cast<const uint4*>(qh + sb * 32 + l0));
        const float dl = __fmul_rn(__ldg(d + sb), (float)__ldg(sc + sb * 8 + g));
        const float ml = __fmul_rn(__ldg(dmin + sb), (float)__ldg(mn + sb * 8 + g));
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const uint32_t byte = byte_of(q, i);
            uint32_t qv = (g & 1) ? byte >> 4 : byte & 0x0fu;
            if (Q5) qv += ((byte_of(h, i) >> g) & 1u) << 4;
            out[i] = __float2bfloat16(__fsub_rn(__fmul_rn((float)qv, dl), ml));
        }
    }
};

struct KQuant6 {  // Q6_K
    const uint8_t *ql, *qh;
    const int8_t* sc;
    const float* d;
    static constexpr int UNIT = 64;  // l in [16lq, 16lq+16) of half hh, i = 0..3

    template <int NB>
    __device__ __forceinline__ void unit_dot(int row, int u, const __nv_bfloat16* x, int K,
                                             float acc[NB]) const {
        const int s = u >> 2, hh = (u >> 1) & 1, lq = u & 1;
        const size_t sb = (size_t)row * (K >> 8) + s;
        const uint8_t* lp = ql + sb * 128 + 64 * hh + 16 * lq;
        const uint4 a = __ldg(reinterpret_cast<const uint4*>(lp));       // ql[l]
        const uint4 c = __ldg(reinterpret_cast<const uint4*>(lp + 32));  // ql[l+32]
        const uint4 h = __ldg(reinterpret_cast<const uint4*>(qh + sb * 64 + 32 * hh + 16 * lq));
        const uint2 sv = __ldg(reinterpret_cast<const uint2*>(sc + sb * 16 + 8 * hh));
        const float dd = __ldg(d + sb);
        float ds[4];  // d*sc of the four 16-groups: sc[8hh + 2i + lq]
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const uint32_t word = i < 2 ? sv.x : sv.y;
            ds[i] = dd * (float)(int8_t)((word >> (8 * (2 * (i & 1) + lq))) & 0xffu);
        }
        float out[NB];
#pragma unroll
        for (int b = 0; b < NB; ++b) out[b] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // element l + 32i of the half
            float w[16];
#pragma unroll
            for (int t = 0; t < 16; ++t) {
                const uint32_t lo = i & 1 ? byte_of(c, t) : byte_of(a, t);
                const uint32_t q4 = i < 2 ? lo & 0x0fu : lo >> 4;
                w[t] = (float)((int)(q4 | (((byte_of(h, t) >> (2 * i)) & 3u) << 4)) - 32);
            }
#pragma unroll
            for (int b = 0; b < NB; ++b) {
                const uint4* xp = reinterpret_cast<const uint4*>(
                    x + (size_t)b * K + (size_t)s * 256 + 128 * hh + 16 * lq + 32 * i);
                float xf[8], xg[8];
                bf16x8(__ldg(xp), xf);
                bf16x8(__ldg(xp + 1), xg);
                float si = 0.f;
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    si = fmaf(w[e], xf[e], si);
                    si = fmaf(w[8 + e], xg[e], si);
                }
                out[b] = fmaf(ds[i], si, out[b]);
            }
        }
#pragma unroll
        for (int b = 0; b < NB; ++b) acc[b] += out[b];
    }

    __device__ __forceinline__ KQuant6 at_expert(int e, int N, int K) const {
        const size_t sb = (size_t)e * N * (K >> 8);
        return KQuant6{ql + sb * 128, qh + sb * 64, sc + sb * 16, d + sb};
    }

    __device__ __forceinline__ void dequant16(int row, int K, int k0,
                                              __nv_bfloat16 out[16]) const {
        const int r = k0 & 255, hh = r >> 7, i = (r >> 5) & 3, l0 = r & 31;  // l0: 0 or 16
        const size_t sb = (size_t)row * (K >> 8) + (k0 >> 8);
        const uint4 a = __ldg(reinterpret_cast<const uint4*>(ql + sb * 128 + 64 * hh +
                                                             32 * (i & 1) + l0));
        const uint4 h = __ldg(reinterpret_cast<const uint4*>(qh + sb * 64 + 32 * hh + l0));
        const float s = (float)__ldg(sc + sb * 16 + 8 * hh + 2 * i + (l0 >> 4));
        const float dd = __ldg(d + sb);
#pragma unroll
        for (int t = 0; t < 16; ++t) {
            const uint32_t A = byte_of(a, t);
            const uint32_t lo = i < 2 ? (A & 0x0fu) : (A >> 4);
            const int q = (int)(lo | (((byte_of(h, t) >> (2 * i)) & 3u) << 4)) - 32;
            out[t] = __float2bfloat16(__fmul_rn(__fmul_rn((float)q, s), dd));  // (q*sc)*d
        }
    }
};

// Q2_K / Q3_K share the 2-bit layout and the GEMV unit: unit u is 16
// consecutive l (lq = u & 1) of half hh = (u >> 1) & 1 of superblock u >> 2,
// all four shifts j, i.e. the 16-groups g = 8hh + 2j + lq. lowbits_unit
// loads its qs bytes and the 8 scale bytes of its half (byte 2j + lq of
// them is group g's), and the x of group j for row b is 16 bf16 at
// b*K + 256s + 128hh + 32j + 16lq.
struct LowUnit {
    int s, hh, lq;
    size_t sb;
    __device__ __forceinline__ LowUnit(int row, int u, int K)
        : s(u >> 2), hh((u >> 1) & 1), lq(u & 1), sb((size_t)row * (K >> 8) + (u >> 2)) {}
    // the 16 x of group j of activation row b (f32)
    __device__ __forceinline__ void x16(const __nv_bfloat16* x, int b, int K, int j,
                                        float xf[16]) const {
        const uint4* xp = reinterpret_cast<const uint4*>(
            x + (size_t)b * K + (size_t)s * 256 + 128 * hh + 32 * j + 16 * lq);
        bf16x8(__ldg(xp), xf);
        bf16x8(__ldg(xp + 1), xf + 8);
    }
};

// byte 2j + lq of an 8-byte vector of per-group bytes (group 8hh + 2j + lq)
__device__ __forceinline__ uint32_t group_byte(const uint2 v, int j, int lq) {
    const uint32_t word = j < 2 ? v.x : v.y;
    return (word >> (8 * (2 * (j & 1) + lq))) & 0xffu;
}

struct KQuant2 {  // Q2_K
    const uint8_t *qs, *sc, *mn;
    const float *d, *dmin;
    static constexpr int UNIT = 64;

    template <int NB>
    __device__ __forceinline__ void unit_dot(int row, int u, const __nv_bfloat16* x, int K,
                                             float acc[NB]) const {
        const LowUnit un(row, u, K);
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(qs + un.sb * 64 + 32 * un.hh +
                                                             16 * un.lq));
        const uint2 sv = __ldg(reinterpret_cast<const uint2*>(sc + un.sb * 16 + 8 * un.hh));
        const uint2 mv = __ldg(reinterpret_cast<const uint2*>(mn + un.sb * 16 + 8 * un.hh));
        const float dd = __ldg(d + un.sb), dm = __ldg(dmin + un.sb);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float dl = dd * (float)group_byte(sv, j, un.lq);
            const float ml = dm * (float)group_byte(mv, j, un.lq);
            float w[16];
#pragma unroll
            for (int t = 0; t < 16; ++t) w[t] = (float)((byte_of(q, t) >> (2 * j)) & 3u);
#pragma unroll
            for (int b = 0; b < NB; ++b) {
                float xf[16];
                un.x16(x, b, K, j, xf);
                float si = 0.f, xs = 0.f;
#pragma unroll
                for (int t = 0; t < 16; ++t) {
                    si = fmaf(w[t], xf[t], si);
                    xs += xf[t];
                }
                acc[b] += dl * si - ml * xs;
            }
        }
    }

    __device__ __forceinline__ KQuant2 at_expert(int e, int N, int K) const {
        const size_t sb = (size_t)e * N * (K >> 8);  // superblocks before expert e
        return KQuant2{qs + sb * 64, sc + sb * 16, mn + sb * 16, d + sb, dmin + sb};
    }

    __device__ __forceinline__ void dequant16(int row, int K, int k0,
                                              __nv_bfloat16 out[16]) const {
        const int r = k0 & 255, g = r >> 4, hh = r >> 7, j = (r >> 5) & 3, lq = g & 1;
        const size_t sb = (size_t)row * (K >> 8) + (k0 >> 8);
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(qs + sb * 64 + 32 * hh + 16 * lq));
        const float dl = __fmul_rn(__ldg(d + sb), (float)__ldg(sc + sb * 16 + g));
        const float ml = __fmul_rn(__ldg(dmin + sb), (float)__ldg(mn + sb * 16 + g));
#pragma unroll
        for (int t = 0; t < 16; ++t) {
            const float qv = (float)((byte_of(q, t) >> (2 * j)) & 3u);
            out[t] = __float2bfloat16(__fsub_rn(__fmul_rn(qv, dl), ml));
        }
    }
};

struct KQuant3 {  // Q3_K
    const uint8_t *qs, *hmask;
    const int8_t* sc;
    const float* d;
    static constexpr int UNIT = 64;

    template <int NB>
    __device__ __forceinline__ void unit_dot(int row, int u, const __nv_bfloat16* x, int K,
                                             float acc[NB]) const {
        const LowUnit un(row, u, K);
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(qs + un.sb * 64 + 32 * un.hh +
                                                             16 * un.lq));
        const uint4 hm = __ldg(reinterpret_cast<const uint4*>(hmask + un.sb * 32 + 16 * un.lq));
        const uint2 sv = __ldg(reinterpret_cast<const uint2*>(sc + un.sb * 16 + 8 * un.hh));
        const float dd = __ldg(d + un.sb);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float dl = dd * (float)(int8_t)group_byte(sv, j, un.lq);
            const int bit = 4 * un.hh + j;
            float w[16];  // q - 4 + 4h, in [-4, 3]
#pragma unroll
            for (int t = 0; t < 16; ++t)
                w[t] = (float)((int)((byte_of(q, t) >> (2 * j)) & 3u) - 4 +
                               4 * (int)((byte_of(hm, t) >> bit) & 1u));
#pragma unroll
            for (int b = 0; b < NB; ++b) {
                float xf[16];
                un.x16(x, b, K, j, xf);
                float si = 0.f;
#pragma unroll
                for (int t = 0; t < 16; ++t) si = fmaf(w[t], xf[t], si);
                acc[b] = fmaf(dl, si, acc[b]);
            }
        }
    }

    __device__ __forceinline__ KQuant3 at_expert(int e, int N, int K) const {
        const size_t sb = (size_t)e * N * (K >> 8);
        return KQuant3{qs + sb * 64, hmask + sb * 32, sc + sb * 16, d + sb};
    }

    __device__ __forceinline__ void dequant16(int row, int K, int k0,
                                              __nv_bfloat16 out[16]) const {
        const int r = k0 & 255, g = r >> 4, hh = r >> 7, j = (r >> 5) & 3, lq = g & 1;
        const size_t sb = (size_t)row * (K >> 8) + (k0 >> 8);
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(qs + sb * 64 + 32 * hh + 16 * lq));
        const uint4 hm = __ldg(reinterpret_cast<const uint4*>(hmask + sb * 32 + 16 * lq));
        const float dl = __fmul_rn(__ldg(d + sb), (float)__ldg(sc + sb * 16 + g));
        const int bit = 4 * hh + j;
#pragma unroll
        for (int t = 0; t < 16; ++t) {
            const int qv = (int)((byte_of(q, t) >> (2 * j)) & 3u) - 4 +
                           4 * (int)((byte_of(hm, t) >> bit) & 1u);
            out[t] = __float2bfloat16(__fmul_rn((float)qv, dl));
        }
    }
};

// scales of the table kinds
__device__ __forceinline__ float scale_at(const float* p) { return __ldg(p); }
__device__ __forceinline__ float scale_at(const __half* p) { return __half2float(__ldg(p)); }

// IQ4_NL, IQ4_XS and the table carrier of the grid / ternary kinds: a
// 32-weight block is 16 bytes of 4-bit codes (byte j: weight j in the low
// nibble, j+16 in the high one), weight = table[code] * the scale of its
// group of G (32, or 16: the low nibbles take scale 2b, the high ones 2b+1,
// the [lo-half | hi-half] split of _body_tab16). The kind's <= 16 int8
// values travel in the struct as four 32-bit words and are looked up with
// __byte_perm (ggml's get_int_from_table_16), so no runtime-indexed array
// spills to local memory. Each group's integer dot is scaled once.
template <int G, class ScaleT>
struct TableNib {
    const uint8_t* qs;
    const ScaleT* d;
    uint32_t tab[4];  // table value v in byte v % 4 of word v / 4
    static constexpr int UNIT = 32;
    static_assert(G == 32 || G == 16, "a scale per 32 or per 16 weights");

    // the 8 codes of a 32-bit qs word → (values of its low nibbles, values
    // of its high nibbles), four int8 each in byte order
    __device__ __forceinline__ int2 lookup(uint32_t q4) const {
        const uint32_t sel = 0x32103210u | ((q4 & 0x88888888u) >> 1);
        uint32_t t[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const uint32_t sh = 16 * i;
            const uint32_t idx = (q4 >> sh) & 0x7777u;  // four selectors, bit 3 apart
            const uint32_t lo = __byte_perm(tab[0], tab[1], idx);  // codes 0-7
            const uint32_t hi = __byte_perm(tab[2], tab[3], idx);  // codes 8-15
            t[i] = __byte_perm(lo, hi, sel >> sh);  // code bit 3 picks hi
        }
        return make_int2((int)__byte_perm(t[0], t[1], 0x6420),   // nibbles 0, 2, 4, 6
                         (int)__byte_perm(t[0], t[1], 0x7531));  // nibbles 1, 3, 5, 7
    }

    // table values of block blk: w[i] weight i (low nibbles), w[16 + i]
    // weight 16 + i (high nibbles)
    __device__ __forceinline__ void values(size_t blk, float w[32]) const {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(qs + blk * 16));
        const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int v = 0; v < 4; ++v) {
            const int2 t = lookup(words[v]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                w[4 * v + i] = (float)(int8_t)((uint32_t)t.x >> (8 * i));
                w[16 + 4 * v + i] = (float)(int8_t)((uint32_t)t.y >> (8 * i));
            }
        }
    }

    template <int NB>
    __device__ __forceinline__ void unit_dot(int row, int u, const __nv_bfloat16* x, int K,
                                             float acc[NB]) const {
        const size_t blk = (size_t)row * (K >> 5) + u;
        float w[32];
        values(blk, w);
        const float s0 = scale_at(d + (G == 32 ? blk : 2 * blk));
        const float s1 = G == 32 ? s0 : scale_at(d + 2 * blk + 1);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
            const uint4* xp = reinterpret_cast<const uint4*>(x + (size_t)b * K + (size_t)u * 32);
            float lo = 0.f, hi = 0.f;
#pragma unroll
            for (int v = 0; v < 2; ++v) {
                float xf[8], xg[8];
                bf16x8(__ldg(xp + v), xf);      // weights 8v .. 8v+7
                bf16x8(__ldg(xp + 2 + v), xg);  // weights 16+8v .. 16+8v+7
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    lo = fmaf(w[8 * v + e], xf[e], lo);
                    hi = fmaf(w[16 + 8 * v + e], xg[e], hi);
                }
            }
            acc[b] = fmaf(s0, lo, fmaf(s1, hi, acc[b]));
        }
    }

    __device__ __forceinline__ TableNib at_expert(int e, int N, int K) const {
        const size_t blk = (size_t)e * N * (K >> 5);  // blocks before expert e
        return TableNib{qs + blk * 16, d + blk * (32 / G), {tab[0], tab[1], tab[2], tab[3]}};
    }

    __device__ __forceinline__ void dequant16(int row, int K, int k0,
                                              __nv_bfloat16 out[16]) const {
        const size_t blk = (size_t)row * (K >> 5) + (k0 >> 5);
        const int h = (k0 >> 4) & 1;
        float w[32];
        values(blk, w);
        const float s = scale_at(d + (G == 32 ? blk : 2 * blk + h));
#pragma unroll
        for (int i = 0; i < 16; ++i) out[i] = __float2bfloat16(__fmul_rn(w[16 * h + i], s));
    }
};

// One warp: y[b, row] = the dot of weight row `row` with activation rows
// b < NB, lanes striding over the row's units, summed by warp shuffles.
template <class W, int NB>
__device__ __forceinline__ void gemv_row(const W& w, const __nv_bfloat16* __restrict__ x,
                                         float* __restrict__ y, int row, int N, int K) {
    const int lane = threadIdx.x & 31;
    float acc[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[b] = 0.f;
    const int nu = K / W::UNIT;
#pragma unroll 2
    for (int u = lane; u < nu; u += 32) w.template unit_dot<NB>(row, u, x, K, acc);
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[b] = warp_sum(acc[b]);
    if (lane == 0) {
#pragma unroll
        for (int b = 0; b < NB; ++b) y[(size_t)b * N + row] = acc[b];
    }
}

template <class W, int NB>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
qmm_gemv(const W w, const __nv_bfloat16* __restrict__ x, float* __restrict__ y, int N, int K) {
    const int row = blockIdx.x * GEMV_WARPS + (threadIdx.x >> 5);
    if (row >= N) return;
    gemv_row<W, NB>(w, x, y, row, N, K);
}

// MoE: block (., s) multiplies activation row s with expert sel[s] of the
// stack (every field offset by at_expert), one warp per output row.
template <class W>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
qmm_expert_gemv(const W w, const int* __restrict__ sel, int E,
                const __nv_bfloat16* __restrict__ x, float* __restrict__ y, int N, int K) {
    const int row = blockIdx.x * GEMV_WARPS + (threadIdx.x >> 5);
    if (row >= N) return;
    const int s = blockIdx.y;
    const int e = min(max(__ldg(sel + s), 0), E - 1);
    gemv_row<W, 1>(w.at_expert(e, N, K), x + (size_t)s * K, y + (size_t)s * N, row, N, K);
}

// ---- tiled tensor-core path (B > 8) ----------------------------------------
constexpr int TM = 64, TN = 64, TK = 32, LDS = TK + 8;  // LDS: bf16 row stride
constexpr int TILE_THREADS = 128;                       // 4 warps, 32x32 each

template <class W>
__global__ void __launch_bounds__(TILE_THREADS)
qmm_tiled(const W w, const __nv_bfloat16* __restrict__ x, float* __restrict__ y, int B, int N,
          int K) {
    using namespace nvcuda;
    __shared__ __align__(32) __nv_bfloat16 xs[TM * LDS];
    __shared__ __align__(32) __nv_bfloat16 ws[TN * LDS];
    __shared__ __align__(32) float cs[TM * (TN + 4)];

    const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
    const int warp = threadIdx.x >> 5;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
    const int r = threadIdx.x >> 1, h = threadIdx.x & 1;  // loader: row, half of the K step

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    const int nb = K >> 5;
    for (int kb = 0; kb < nb; ++kb) {
        {  // activations: 16 bf16 of row m0+r (zeros past B)
            uint4 v0 = make_uint4(0, 0, 0, 0), v1 = v0;
            if (m0 + r < B) {
                const uint4* p = reinterpret_cast<const uint4*>(
                    x + (size_t)(m0 + r) * K + (size_t)kb * 32 + h * 16);
                v0 = __ldg(p);
                v1 = __ldg(p + 1);
            }
            uint4* dst = reinterpret_cast<uint4*>(xs + r * LDS + h * 16);
            dst[0] = v0;
            dst[1] = v1;
        }
        {  // weights: dequantized bf16 of row n0+r (zeros past N)
            __nv_bfloat16 wv[16];
            if (n0 + r < N) {
                w.dequant16(n0 + r, K, kb * 32 + h * 16, wv);
            } else {
#pragma unroll
                for (int i = 0; i < 16; ++i) wv[i] = __float2bfloat16(0.f);
            }
#pragma unroll
            for (int i = 0; i < 16; ++i) ws[r * LDS + h * 16 + i] = wv[i];
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < TK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(a[i], xs + (wm + 16 * i) * LDS + kk, LDS);
#pragma unroll
            for (int j = 0; j < 2; ++j)  // B[k][n] = W[n][k]: column-major over ws rows
                wmma::load_matrix_sync(b[j], ws + (wn + 16 * j) * LDS + kk, LDS);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::store_matrix_sync(cs + (wm + 16 * i) * (TN + 4) + wn + 16 * j, acc[i][j],
                                    TN + 4, wmma::mem_row_major);
    __syncthreads();
    for (int e = threadIdx.x; e < TM * TN; e += TILE_THREADS) {
        const int rr = e / TN, cc = e % TN;
        if (m0 + rr < B && n0 + cc < N) y[(size_t)(m0 + rr) * N + n0 + cc] = cs[rr * (TN + 4) + cc];
    }
}

template <class W, int NB>
void launch_gemv(const W& w, const void* x, void* y, int N, int K, cudaStream_t st) {
    const dim3 grid((N + GEMV_WARPS - 1) / GEMV_WARPS);
    qmm_gemv<W, NB><<<grid, GEMV_WARPS * 32, 0, st>>>(
        w, static_cast<const __nv_bfloat16*>(x), static_cast<float*>(y), N, K);
}

template <class W>
int qmm_launch(const W& w, const void* x, void* y, int B, int N, int K, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (B) {
        case 1: launch_gemv<W, 1>(w, x, y, N, K, st); break;
        case 2: launch_gemv<W, 2>(w, x, y, N, K, st); break;
        case 3: launch_gemv<W, 3>(w, x, y, N, K, st); break;
        case 4: launch_gemv<W, 4>(w, x, y, N, K, st); break;
        case 5: launch_gemv<W, 5>(w, x, y, N, K, st); break;
        case 6: launch_gemv<W, 6>(w, x, y, N, K, st); break;
        case 7: launch_gemv<W, 7>(w, x, y, N, K, st); break;
        case 8: launch_gemv<W, 8>(w, x, y, N, K, st); break;
        default: {
            const dim3 grid((N + TN - 1) / TN, (B + TM - 1) / TM);
            qmm_tiled<W><<<grid, TILE_THREADS, 0, st>>>(
                w, static_cast<const __nv_bfloat16*>(x), static_cast<float*>(y), B, N, K);
        }
    }
    return (int)cudaGetLastError();
}

template <class W>
int qmm_experts_launch(const W& w, const void* x, const void* sel, void* y, int S, int E, int N,
                       int K, void* stream) {
    const dim3 grid((N + GEMV_WARPS - 1) / GEMV_WARPS, S);
    qmm_expert_gemv<W><<<grid, GEMV_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        w, static_cast<const int*>(sel), E, static_cast<const __nv_bfloat16*>(x),
        static_cast<float*>(y), N, K);
    return (int)cudaGetLastError();
}

}  // namespace

// x bf16 [B,K]; y f32 [B,N]; the weight fields as in the header comment
// (Q4_0: qs u8 [N,K/2]; Q8_0: qs i8 [N,K]; both d f16 [N,K/32]; Q4_1 adds
// m f16 [N,K/32], Q5_0 qh u8 [N,K/8], Q5_1 both; the K-quants' fields in
// ops/kernels/qmm.py::_fields order). K % 32 == 0 (K % 256 == 0 for the
// K-quants), every pointer 16-byte aligned (checked by
// the Python wrapper). Each returns cudaGetLastError() after the launch.
KERNELS_API int qmm_q4_0(const void* x, const void* qs, const void* d, void* y, int B, int N,
                         int K, void* stream) {
    const Legacy<Q4_0> w{static_cast<const uint8_t*>(qs), static_cast<const __half*>(d)};
    return qmm_launch(w, x, y, B, N, K, stream);
}

KERNELS_API int qmm_q8_0(const void* x, const void* qs, const void* d, void* y, int B, int N,
                         int K, void* stream) {
    const Legacy<Q8_0> w{static_cast<const uint8_t*>(qs), static_cast<const __half*>(d)};
    return qmm_launch(w, x, y, B, N, K, stream);
}

KERNELS_API int qmm_q4_1(const void* x, const void* qs, const void* d, const void* m, void* y,
                         int B, int N, int K, void* stream) {
    const LegacyQ5M<false, true> w{static_cast<const uint8_t*>(qs), nullptr,
                                   static_cast<const __half*>(d), static_cast<const __half*>(m)};
    return qmm_launch(w, x, y, B, N, K, stream);
}

KERNELS_API int qmm_q5_0(const void* x, const void* qs, const void* qh, const void* d, void* y,
                         int B, int N, int K, void* stream) {
    const LegacyQ5M<true, false> w{static_cast<const uint8_t*>(qs),
                                   static_cast<const uint32_t*>(qh),
                                   static_cast<const __half*>(d), nullptr};
    return qmm_launch(w, x, y, B, N, K, stream);
}

KERNELS_API int qmm_q5_1(const void* x, const void* qs, const void* qh, const void* d,
                         const void* m, void* y, int B, int N, int K, void* stream) {
    const LegacyQ5M<true, true> w{static_cast<const uint8_t*>(qs),
                                  static_cast<const uint32_t*>(qh),
                                  static_cast<const __half*>(d), static_cast<const __half*>(m)};
    return qmm_launch(w, x, y, B, N, K, stream);
}

KERNELS_API int qmm_q2_k(const void* x, const void* qs, const void* sc, const void* mn,
                         const void* d, const void* dmin, void* y, int B, int N, int K,
                         void* stream) {
    const KQuant2 w{static_cast<const uint8_t*>(qs), static_cast<const uint8_t*>(sc),
                    static_cast<const uint8_t*>(mn), static_cast<const float*>(d),
                    static_cast<const float*>(dmin)};
    return qmm_launch(w, x, y, B, N, K, stream);
}

KERNELS_API int qmm_q3_k(const void* x, const void* qs, const void* hmask, const void* sc,
                         const void* d, void* y, int B, int N, int K, void* stream) {
    const KQuant3 w{static_cast<const uint8_t*>(qs), static_cast<const uint8_t*>(hmask),
                    static_cast<const int8_t*>(sc), static_cast<const float*>(d)};
    return qmm_launch(w, x, y, B, N, K, stream);
}

KERNELS_API int qmm_q4_k(const void* x, const void* qs, const void* sc, const void* mn,
                         const void* d, const void* dmin, void* y, int B, int N, int K,
                         void* stream) {
    const KQuant45<false> w{static_cast<const uint8_t*>(qs), nullptr,
                            static_cast<const uint8_t*>(sc), static_cast<const uint8_t*>(mn),
                            static_cast<const float*>(d), static_cast<const float*>(dmin)};
    return qmm_launch(w, x, y, B, N, K, stream);
}

KERNELS_API int qmm_q5_k(const void* x, const void* qs, const void* qh, const void* sc,
                         const void* mn, const void* d, const void* dmin, void* y, int B, int N,
                         int K, void* stream) {
    const KQuant45<true> w{static_cast<const uint8_t*>(qs), static_cast<const uint8_t*>(qh),
                           static_cast<const uint8_t*>(sc), static_cast<const uint8_t*>(mn),
                           static_cast<const float*>(d), static_cast<const float*>(dmin)};
    return qmm_launch(w, x, y, B, N, K, stream);
}

KERNELS_API int qmm_q6_k(const void* x, const void* ql, const void* qh, const void* sc,
                         const void* d, void* y, int B, int N, int K, void* stream) {
    const KQuant6 w{static_cast<const uint8_t*>(ql), static_cast<const uint8_t*>(qh),
                    static_cast<const int8_t*>(sc), static_cast<const float*>(d)};
    return qmm_launch(w, x, y, B, N, K, stream);
}

// MoE selected-expert GEMV: x bf16 [S,K], sel int32 [S], y f32 [S,N]; the
// weight fields as above with a leading expert axis [E, ...]. S <= 65535
// (the grid's y extent; checked by the Python wrapper).
KERNELS_API int qmm_experts_q4_0(const void* x, const void* sel, const void* qs, const void* d,
                                 void* y, int S, int E, int N, int K, void* stream) {
    const Legacy<Q4_0> w{static_cast<const uint8_t*>(qs), static_cast<const __half*>(d)};
    return qmm_experts_launch(w, x, sel, y, S, E, N, K, stream);
}

KERNELS_API int qmm_experts_q8_0(const void* x, const void* sel, const void* qs, const void* d,
                                 void* y, int S, int E, int N, int K, void* stream) {
    const Legacy<Q8_0> w{static_cast<const uint8_t*>(qs), static_cast<const __half*>(d)};
    return qmm_experts_launch(w, x, sel, y, S, E, N, K, stream);
}

KERNELS_API int qmm_experts_q4_1(const void* x, const void* sel, const void* qs, const void* d,
                                 const void* m, void* y, int S, int E, int N, int K,
                                 void* stream) {
    const LegacyQ5M<false, true> w{static_cast<const uint8_t*>(qs), nullptr,
                                   static_cast<const __half*>(d), static_cast<const __half*>(m)};
    return qmm_experts_launch(w, x, sel, y, S, E, N, K, stream);
}

KERNELS_API int qmm_experts_q5_0(const void* x, const void* sel, const void* qs, const void* qh,
                                 const void* d, void* y, int S, int E, int N, int K,
                                 void* stream) {
    const LegacyQ5M<true, false> w{static_cast<const uint8_t*>(qs),
                                   static_cast<const uint32_t*>(qh),
                                   static_cast<const __half*>(d), nullptr};
    return qmm_experts_launch(w, x, sel, y, S, E, N, K, stream);
}

KERNELS_API int qmm_experts_q5_1(const void* x, const void* sel, const void* qs, const void* qh,
                                 const void* d, const void* m, void* y, int S, int E, int N,
                                 int K, void* stream) {
    const LegacyQ5M<true, true> w{static_cast<const uint8_t*>(qs),
                                  static_cast<const uint32_t*>(qh),
                                  static_cast<const __half*>(d), static_cast<const __half*>(m)};
    return qmm_experts_launch(w, x, sel, y, S, E, N, K, stream);
}

KERNELS_API int qmm_experts_q2_k(const void* x, const void* sel, const void* qs, const void* sc,
                                 const void* mn, const void* d, const void* dmin, void* y, int S,
                                 int E, int N, int K, void* stream) {
    const KQuant2 w{static_cast<const uint8_t*>(qs), static_cast<const uint8_t*>(sc),
                    static_cast<const uint8_t*>(mn), static_cast<const float*>(d),
                    static_cast<const float*>(dmin)};
    return qmm_experts_launch(w, x, sel, y, S, E, N, K, stream);
}

KERNELS_API int qmm_experts_q3_k(const void* x, const void* sel, const void* qs,
                                 const void* hmask, const void* sc, const void* d, void* y, int S,
                                 int E, int N, int K, void* stream) {
    const KQuant3 w{static_cast<const uint8_t*>(qs), static_cast<const uint8_t*>(hmask),
                    static_cast<const int8_t*>(sc), static_cast<const float*>(d)};
    return qmm_experts_launch(w, x, sel, y, S, E, N, K, stream);
}

KERNELS_API int qmm_experts_q4_k(const void* x, const void* sel, const void* qs, const void* sc,
                                 const void* mn, const void* d, const void* dmin, void* y, int S,
                                 int E, int N, int K, void* stream) {
    const KQuant45<false> w{static_cast<const uint8_t*>(qs), nullptr,
                            static_cast<const uint8_t*>(sc), static_cast<const uint8_t*>(mn),
                            static_cast<const float*>(d), static_cast<const float*>(dmin)};
    return qmm_experts_launch(w, x, sel, y, S, E, N, K, stream);
}

KERNELS_API int qmm_experts_q5_k(const void* x, const void* sel, const void* qs, const void* qh,
                                 const void* sc, const void* mn, const void* d, const void* dmin,
                                 void* y, int S, int E, int N, int K, void* stream) {
    const KQuant45<true> w{static_cast<const uint8_t*>(qs), static_cast<const uint8_t*>(qh),
                           static_cast<const uint8_t*>(sc), static_cast<const uint8_t*>(mn),
                           static_cast<const float*>(d), static_cast<const float*>(dmin)};
    return qmm_experts_launch(w, x, sel, y, S, E, N, K, stream);
}

KERNELS_API int qmm_experts_q6_k(const void* x, const void* sel, const void* ql, const void* qh,
                                 const void* sc, const void* d, void* y, int S, int E, int N,
                                 int K, void* stream) {
    const KQuant6 w{static_cast<const uint8_t*>(ql), static_cast<const uint8_t*>(qh),
                    static_cast<const int8_t*>(sc), static_cast<const float*>(d)};
    return qmm_experts_launch(w, x, sel, y, S, E, N, K, stream);
}

// The table kinds: x bf16 [B,K], qs u8 [N,K/2], d [N,K/G] (f16 for
// qmm_tab32_f16, f32 else), the kind's table as four words t0..t3 (value v
// in byte v % 4 of word v / 4), y f32 [B,N]. K % 32 == 0. The expert
// entries as the others: sel int32 [S], the fields with a leading [E].
template <int G, class ScaleT>
TableNib<G, ScaleT> table_weight(const void* qs, const void* d, uint32_t t0, uint32_t t1,
                                 uint32_t t2, uint32_t t3) {
    return TableNib<G, ScaleT>{static_cast<const uint8_t*>(qs), static_cast<const ScaleT*>(d),
                               {t0, t1, t2, t3}};
}

KERNELS_API int qmm_tab32_f16(const void* x, const void* qs, const void* d, uint32_t t0,
                              uint32_t t1, uint32_t t2, uint32_t t3, void* y, int B, int N, int K,
                              void* stream) {
    return qmm_launch(table_weight<32, __half>(qs, d, t0, t1, t2, t3), x, y, B, N, K, stream);
}

KERNELS_API int qmm_tab32_f32(const void* x, const void* qs, const void* d, uint32_t t0,
                              uint32_t t1, uint32_t t2, uint32_t t3, void* y, int B, int N, int K,
                              void* stream) {
    return qmm_launch(table_weight<32, float>(qs, d, t0, t1, t2, t3), x, y, B, N, K, stream);
}

KERNELS_API int qmm_tab16_f32(const void* x, const void* qs, const void* d, uint32_t t0,
                              uint32_t t1, uint32_t t2, uint32_t t3, void* y, int B, int N, int K,
                              void* stream) {
    return qmm_launch(table_weight<16, float>(qs, d, t0, t1, t2, t3), x, y, B, N, K, stream);
}

KERNELS_API int qmm_experts_tab32_f16(const void* x, const void* sel, const void* qs,
                                      const void* d, uint32_t t0, uint32_t t1, uint32_t t2,
                                      uint32_t t3, void* y, int S, int E, int N, int K,
                                      void* stream) {
    return qmm_experts_launch(table_weight<32, __half>(qs, d, t0, t1, t2, t3), x, sel, y, S, E,
                              N, K, stream);
}

KERNELS_API int qmm_experts_tab32_f32(const void* x, const void* sel, const void* qs,
                                      const void* d, uint32_t t0, uint32_t t1, uint32_t t2,
                                      uint32_t t3, void* y, int S, int E, int N, int K,
                                      void* stream) {
    return qmm_experts_launch(table_weight<32, float>(qs, d, t0, t1, t2, t3), x, sel, y, S, E, N,
                              K, stream);
}

KERNELS_API int qmm_experts_tab16_f32(const void* x, const void* sel, const void* qs,
                                      const void* d, uint32_t t0, uint32_t t1, uint32_t t2,
                                      uint32_t t3, void* y, int S, int E, int N, int K,
                                      void* stream) {
    return qmm_experts_launch(table_weight<16, float>(qs, d, t0, t1, t2, t3), x, sel, y, S, E, N,
                              K, stream);
}

KERNELS_API const char* kernels_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
