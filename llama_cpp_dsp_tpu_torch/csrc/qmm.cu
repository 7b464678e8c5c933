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
// IQ4_NL its own 144.
// Design, B <= 8 (decode; qmm_tc, one instantiation per weight struct, B a
// runtime argument): the codes enter Hopper's tensor cores exactly, through
// mma.sync.m16n8k16 with bf16 operands and f32 sums. A 16-row weight tile
// is the A operand and x the B operand: its B <= 8 rows are the n = 8
// columns (columns >= B zero, never stored), so B = 8 costs what B = 1
// does. What bounded the CUDA-core GEMV that came before was instructions
// per weight byte: an I2F per element (16 a clock per SM against 128
// FMAs), byte selects, and an FMA and a Σx add per element and activation
// row (B = 4 took ~3.7× B = 1). Here a code word of four codes of
// consecutive k costs two prmt (each code under a fixed bf16 exponent: 128
// + c, exact) and two bf16x2 fmas (the kind's offset away), and its pairs
// (e, e+1), (e+2, e+3) meet x's own words in the fragment; Q8_0's int8 is
// split into nibbles and rebuilt with two fmas a pair (pairs8); the table
// kinds look their values up as bf16 bytes (lookup_bf16, byte tables made
// on the host; one prmt a half-word where the table has <= 8 values).
// Every value fits bf16's 8 significant bits, and bf16 x times a code is
// exact in the f32 accumulator: only the order of the sums differs from
// exact f32. Each k16 step lies inside one scale group; its products go
// into a fresh accumulator, scaled in f32 by the group's d·sc for rows g
// and g + 8, and the mins (Q4_K, Q5_K, Q4_1, Q5_1) are dmin·mn (or m) ×
// the group's Σx, an MMA of ones against the same x fragment: once per
// group and warp, shared by the tile's 16 rows, as _body_q4_K's last
// product shares x's group sums. Q2_K's 4-bit sub-scale times its code is
// at most 45, so it enters the codes (one fma), its min is an MMA of the
// group's mn, and d / dmin scale four sums taken in turn once a superblock
// (a per-16-group f32 epilogue cost it its lead).
// The weight layout stays; the order of k inside a group is free: lane (g,
// t) takes the bytes of rows g and g + 8 that its struct names. The
// K-quants load them straight into registers (4 or 8 bytes a run, a
// streaming hint; TC_P superblocks before their products). The kinds of
// 32-element blocks would read 4 bytes a row and block that way, so they
// go through a per-warp 3-stage cp.async ring instead. A batch is 16 rows
// × 128 qs bytes (whole lines a warp copy), the batch's scales (d, m, qh,
// the table scales; 4-byte pieces where a K that is not a multiple of 256
// leaves a row's scales unaligned) and x's B rows of the batch, two
// batches ahead; ldmatrix.x4 hands lane (g, t) word t of rows g, g + 8 of
// two blocks and x's fragments come from the stage as each unit needs
// them (read from device memory before each batch's wait they stalled
// every batch, and held 32 registers across it). A whole batch runs its
// units straight-line, so the compiler interleaves their chains. The warps
// of a block (4, 8 or 16) and the blocks of a cluster (C <= 4) split K and
// add their sums in a fixed order through shared and distributed shared
// memory: no atomics, the same result every call. The launch takes the
// most warps that run in one wave (the occupancy calculator's count for
// the B and block size), so that 512-6144-row matrices fill the card from
// 16-warp blocks rather than clusters, whose barrier cost ~1 µs a call. A
// ragged N reads row N-1 and stores nothing past N. Every kind takes <= 128
// registers (launch bounds of a 16-warp block).
// Bound: the weight bytes over the memory rate (above). The best kinds
// reach ~2.2-2.4 TB/s at the large shapes (PERF.md); a call's fixed
// latency (first loads ~1 µs after the start, the reduction) rules the
// 2-16 MB matrices, and issue slots (prmt, fma, MMA per unit) the 16-value
// tables.
// B > 8 (prefill) runs a tiled tensor-core kernel: a 64x64 output tile per
// block, each 32-wide K step dequantizes its weight tile into shared memory
// as bf16 (rounded from the same f32 products as the plain version) and
// multiplies it with WMMA bf16 fragments, f32 accumulation. A simple first
// version: no TMA, no wgmma, no pipelining across K steps.
//
// The MoE selected-expert GEMV (qmm_experts_*) replaces
// llama_cpp_dsp_tpu/ops/pallas/qmm.py::_kernel_experts (entry
// qmm_expert_rows): y[s] = x[s] · dequant(W[sel[s]])ᵀ for an expert stack
// W [E, N, K] whose fields carry a leading expert axis. The TPU kernel's
// scalar-prefetched expert ids drive its BlockSpec index maps; here block
// row blockIdx.y = s reads sel[s] from device memory (clamped to [0, E), so
// no id reads outside the stack), offsets every field pointer by that
// expert's size (`at_expert`) and runs a warp-per-row loop (gemv_row, the
// structs' unit_dot) with one activation row: the CUDA-core GEMV that B1 ran
// before its tensor-core kernel, which only B9 uses now. Bound: the selected
// experts' packed bytes over the memory rate (rows that pick the same
// expert read it again, as in the TPU kernel).
#include "common.cuh"

#include <cooperative_groups.h>
#include <mma.h>
#include <string.h>  // after cuda_bf16.h (common.cuh): bf16 WMMA fragments

namespace cg = cooperative_groups;


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

// ---- the tensor-core GEMV's register arithmetic (B <= 8) ------------------
// A code word holds four codes of consecutive logical k (e, e+1, e+2, e+3)
// as bytes. Its bf16 pairs are (e, e+1) and (e+2, e+3): the first fills
// k-slots 2t, 2t+1 of an m16n8k16 A fragment, the second 2t+8, 2t+9, and
// the x fragment takes the same logical k: x's own words (xfrag4 / xfrag8).
constexpr uint32_t ONE2 = 0x3f803f80u;  // bf16x2 (1, 1)
// bf16x2 -(offset) for codes c < 128 put under exponent 134 (128 + c)
constexpr uint32_t NEG128 = 0xc300c300u, NEG132 = 0xc304c304u, NEG136 = 0xc308c308u,
                   NEG144 = 0xc310c310u, NEG160 = 0xc320c320u, NEG2304 = 0xc510c510u;

__device__ __forceinline__ uint32_t hfma2(uint32_t a, uint32_t b, uint32_t c) {  // a*b + c
    uint32_t d;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
    return d;
}

// four codes < 128 → bf16 pairs (e, e+1), (e+2, e+3) less the kind's offset:
// prmt puts each code under 0x43 (the bf16 128 + c, exact), one fma takes
// 128 + offset away; no int → float conversion
__device__ __forceinline__ void pairs7(uint32_t cw, uint32_t neg, uint32_t& p01, uint32_t& p23) {
    p01 = hfma2(__byte_perm(cw, 0x43434343u, 0x4140), ONE2, neg);
    p23 = hfma2(__byte_perm(cw, 0x43434343u, 0x4342), ONE2, neg);
}

// four int8 (Q8_0's bytes, the table kinds' values) → bf16 pairs. An 8-bit
// code does not fit under one exponent (7 mantissa bits), so u = q + 128 is
// split: its high nibble h under 0x45 is 2048 + 16h, its low one l under
// 0x43 is 128 + l; (2048 + 16h − 2304) + (128 + l) = q, each step exact.
// Two fmas a pair against an I2F each element (16 a clock per SM).
__device__ __forceinline__ void pairs8(uint32_t cw, uint32_t& p01, uint32_t& p23) {
    const uint32_t u = cw ^ 0x80808080u;
    const uint32_t lo = u & 0x0f0f0f0fu, hi = (u >> 4) & 0x0f0f0f0fu;
    p01 = hfma2(hfma2(__byte_perm(hi, 0x45454545u, 0x4140), ONE2, NEG2304), ONE2,
                __byte_perm(lo, 0x43434343u, 0x4140));
    p23 = hfma2(hfma2(__byte_perm(hi, 0x45454545u, 0x4342), ONE2, NEG2304), ONE2,
                __byte_perm(lo, 0x43434343u, 0x4342));
}

// bits 0..3 of n to bit 0 of bytes 0..3 (no carries: bit b lands on b, b+7,
// b+14, b+21)
__device__ __forceinline__ uint32_t spread4(uint32_t n) {
    return ((n & 0xfu) * 0x00204081u) & 0x01010101u;
}

// byte i of w as f32, unsigned and signed: under the exponent of 2^23
__device__ __forceinline__ float u8f(uint32_t w, int i) {
    return __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7440 | i)) - 8388608.f;
}
__device__ __forceinline__ float s8f(uint32_t w, int i) {
    return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4b000000u, 0x7440 | i)) - 8388736.f;
}

__device__ __forceinline__ uint32_t word_of(const uint4 v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// c += A·B, A the 16×16 weight tile (a0: row g k-slots 2t.., a1: row g+8,
// a2: row g slots 2t+8.., a3: row g+8), B 16×8 (column g: b0 slots 2t..,
// b1 slots 2t+8..), c rows g / g+8 × columns 2t, 2t+1
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the x fragment of 4 (8) consecutive logical k from k: x[k..k+3] of column
// g as its words (x_k, x_k+1), (x_k+2, x_k+3); zeros for a column >= B
__device__ __forceinline__ void xfrag4(const __nv_bfloat16* xr, int k, bool act, uint32_t& b0,
                                       uint32_t& b1) {
    uint2 v = make_uint2(0u, 0u);
    if (act) v = __ldg(reinterpret_cast<const uint2*>(xr + k));
    b0 = v.x;
    b1 = v.y;
}
__device__ __forceinline__ void xfrag8(const __nv_bfloat16* xr, int k, bool act, uint32_t b[4]) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (act) v = __ldg(reinterpret_cast<const uint4*>(xr + k));
    b[0] = v.x;
    b[1] = v.y;
    b[2] = v.z;
    b[3] = v.w;
}

// f16 halves of a word → f32
__device__ __forceinline__ float f16_lo(uint32_t w) {
    return __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
}
__device__ __forceinline__ float f16_hi(uint32_t w) {
    return __half2float(__ushort_as_half((unsigned short)(w >> 16)));
}

// p-th of 8 consecutive f16 in a 16-byte vector, of 4 f32 in one
__device__ __forceinline__ float f16_of(const uint4 v, int p) {
    const uint32_t w = word_of(v, p >> 1);
    return p & 1 ? f16_hi(w) : f16_lo(w);
}

// 8 or 4 bytes global → shared (cp.async.ca); ok = false writes zeros, reads
// nothing
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool ok) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
                 "r"(ok ? 8 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(ok ? 4 : 0));
}

__device__ __forceinline__ uint4 lds128(uint32_t a) {
    uint4 v;
    asm volatile("ld.shared.v4.u32 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(a)
                 : "memory");
    return v;
}
__device__ __forceinline__ uint2 lds64(uint32_t a) {
    uint2 v;
    asm volatile("ld.shared.v2.u32 {%0,%1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(a) : "memory");
    return v;
}

// The staged tile of a warp: 16 rows of STR bytes, a row's 128 qs bytes
// then its batch of scales. STR / 16 is odd, so ldmatrix's eight rows (and
// a warp's 16-byte reads of eight rows) fall in distinct banks.
constexpr int stage_stride(int scale_bytes, int qbytes = 128) {
    return ((qbytes + scale_bytes + 15) / 16 + 1 - ((qbytes + scale_bytes + 15) / 16) % 2) * 16;
}

// rows n0.. n0+15 (clamped to N - 1) of a per-row array: SPAN bytes each
// from byte0 of the row (rowbytes apart) into the tile at byte off of each
// row (stride STR), CH-byte pieces; pieces from byte `valid` on read
// nothing and land as zeros
template <int SPAN, int STR, int CH>
__device__ __forceinline__ void copy_pieces(uint32_t tile, int off, const uint8_t* base,
                                            size_t rowbytes, size_t byte0, int valid, int n0,
                                            int N, int lane) {
    constexpr int PER = SPAN / CH, NCH = 16 * PER;
#pragma unroll
    for (int i = 0; i < (NCH + 31) / 32; ++i) {
        const int c = lane + 32 * i, row = c / PER, piece = c % PER;
        if (c < NCH) {
            const uint8_t* src =
                base + (size_t)min(n0 + row, N - 1) * rowbytes + byte0 + piece * CH;
            const uint32_t dst = tile + row * STR + off + piece * CH;
            if (CH == 16) {
                cp_async16(dst, src, piece * CH < valid);
            } else if (CH == 8) {
                cp_async8(dst, src, piece * CH < valid);
            } else if (CH == 4) {
                cp_async4(dst, src, piece * CH < valid);
            } else {  // 2 bytes: below cp.async's smallest piece, a load and a store
                const unsigned short v =
                    piece * CH < valid ? __ldg(reinterpret_cast<const unsigned short*>(src)) : 0;
                asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(v) : "memory");
            }
        }
    }
}
// 16-byte pieces (8 for an 8-byte span) where the rows keep that alignment,
// else 4-byte ones, else 2-byte ones: a K that is not a multiple of 256
// gives rows of 88 or 684 bytes of f16 scales (DeepSeek-V2-Lite's 1408 and
// 10944), or of 22 (an odd count of blocks: K = 352)
template <int SPAN, int STR>
__device__ __forceinline__ void copy_rows(uint32_t tile, int off, const uint8_t* base,
                                          size_t rowbytes, size_t byte0, int valid, int n0, int N,
                                          int lane) {
    constexpr int CH = SPAN >= 16 ? 16 : SPAN;
    if (rowbytes % CH == 0) {
        copy_pieces<SPAN, STR, CH>(tile, off, base, rowbytes, byte0, valid, n0, N, lane);
    } else if (rowbytes % 4 == 0) {
        copy_pieces<SPAN, STR, 4>(tile, off, base, rowbytes, byte0, valid, n0, N, lane);
    } else {
        copy_pieces<SPAN, STR, 2>(tile, off, base, rowbytes, byte0, valid, n0, N, lane);
    }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
}

// a scale group's product c (or Σx s) into the sums: rows g (scale fa) and
// g + 8 (fb)
__device__ __forceinline__ void fold(float acc[4], const float c[4], float fa, float fb) {
    acc[0] = fmaf(fa, c[0], acc[0]);
    acc[1] = fmaf(fa, c[1], acc[1]);
    acc[2] = fmaf(fb, c[2], acc[2]);
    acc[3] = fmaf(fb, c[3], acc[3]);
}

// the weight rows as the A operand, x as the B operand: c = A·x for one k16
// step (rows g / g+8 pairs pa*, pb*), and the step's Σx (A all ones) for a
// kind with mins
__device__ __forceinline__ void mma_step(float (&c)[4], uint32_t pa02, uint32_t pa13,
                                         uint32_t pb02, uint32_t pb13, uint32_t x0, uint32_t x1) {
    mma_bf16(c, pa02, pb02, pa13, pb13, x0, x1);
}
__device__ __forceinline__ void sum_x(float (&s)[4], uint32_t x0, uint32_t x1) {
    mma_bf16(s, ONE2, ONE2, ONE2, ONE2, x0, x1);
}

// Each weight kind is a struct of its field pointers with
//   UNIT                   elements of one GEMV lane step (B9, the MoE GEMV)
//   unit_dot<NB>(row, u, x, K, acc)   acc[b] += the dot of unit u of weight
//                          row `row` with activation rows b < NB (B9 only)
//   TC_UNIT, TC_P          elements of one tensor-core GEMV unit, units a
//                          warp loads before it multiplies any (B1, B <= 8)
//   TC_ALIGN               units a K slice is a multiple of (a batch)
//   TC_MINBAT              batches of K each warp takes at the least
//   STAGED                 qs through the shared-memory ring (the kinds of
//                          32-element blocks: QB qs bytes a block, QBYTES a
//                          row's in a batch, qs_row, STR a staged row,
//                          stage_scales / staged_scales a batch's scales as
//                          Sc, tc_raw a unit)
//   Raw, tc_load(row, u, K, t)       lane t's bytes of unit u of a row (the
//                          K-quants, straight from device memory)
//   tc_unit(ra, rb, xr, act, u, t, acc)   the unit's k16 steps for rows g
//                          (ra) and g + 8 (rb), each scale group into a
//                          fresh accumulator, scaled into acc
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

    // tensor-core unit: one 32-block. Q4_0: lane t takes word t (bytes
    // 4t..4t+3: elements 4t.. low, 16+4t.. high), codes q - 8 (offset 136);
    // Q8_0: word t of each 16-byte half (elements 4t.., 16+4t..), the int8
    // route. Both k16 steps share d, so one accumulator. A batch is 128
    // bytes of each row's qs (8 or 4 blocks).
    static constexpr bool Q8 = Q::QS_BYTES == 32;
    static constexpr bool STAGED = true;  // qs through the shared-memory ring
    static constexpr int QB = Q::QS_BYTES, TC_UNIT = 32, TC_P = 128 / QB, TC_ALIGN = TC_P;
    static constexpr int QBYTES = QB * TC_P;  // qs bytes of a row in a batch
    // Q8_0's light batches ran best four to a warp (its TinyLlama shapes, H100)
    static constexpr int TC_MINBAT = Q8 ? 4 : 1;
    struct Raw {
        uint2 q;
        float d;
    };
    struct Sc {  // a batch's d, 8 (Q4_0) or 4 (Q8_0) f16
        uint4 d;
    };
    __device__ __forceinline__ const uint8_t* qs_row(int row, int K) const {
        return qs + (size_t)row * (K >> 5) * QB;
    }
    // the batch's d in the staged tile
    static constexpr int SCALE_BYTES = 2 * TC_P, STR = stage_stride(SCALE_BYTES, QBYTES);
    __device__ __forceinline__ void stage_scales(uint32_t tile, int n0, int N, int K, int u, int n,
                                                 int lane) const {
        copy_rows<SCALE_BYTES, STR>(tile, QBYTES, reinterpret_cast<const uint8_t*>(d),
                                    (size_t)(K >> 5) * 2, (size_t)u * 2, 2 * n, n0, N, lane);
    }
    __device__ __forceinline__ Sc staged_scales(uint32_t row) const {  // row: its scale bytes
        if (TC_P == 4) {
            const uint2 v = lds64(row);
            return Sc{make_uint4(v.x, v.y, 0u, 0u)};
        }
        return Sc{lds128(row)};
    }
    // unit p of a batch: its qs words (Q4_0: word t; Q8_0: word t of each
    // 16-byte half) and its d
    __device__ __forceinline__ Raw tc_raw(uint2 q, const Sc& s, int p) const {
        return Raw{q, f16_of(s.d, p)};
    }
    // x fragments xf: x[32u + 4t..] and x[32u + 16 + 4t..] (xfrag4)
    __device__ __forceinline__ void tc_unit(const Raw& a, const Raw& b, const uint32_t (&xf)[4],
                                            int t, float acc[4]) const {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        uint32_t pa[4], pb[4];
        if (Q8) {
            pairs8(a.q.x, pa[0], pa[1]);
            pairs8(a.q.y, pa[2], pa[3]);
            pairs8(b.q.x, pb[0], pb[1]);
            pairs8(b.q.y, pb[2], pb[3]);
        } else {
            pairs7(a.q.x & 0x0f0f0f0fu, NEG136, pa[0], pa[1]);
            pairs7((a.q.x >> 4) & 0x0f0f0f0fu, NEG136, pa[2], pa[3]);
            pairs7(b.q.x & 0x0f0f0f0fu, NEG136, pb[0], pb[1]);
            pairs7((b.q.x >> 4) & 0x0f0f0f0fu, NEG136, pb[2], pb[3]);
        }
        mma_step(c, pa[0], pa[1], pb[0], pb[1], xf[0], xf[1]);
        mma_step(c, pa[2], pa[3], pb[2], pb[3], xf[2], xf[3]);
        fold(acc, c, a.d, b.d);
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

    // tensor-core unit: one 32-block, lane t word t as Q4_0; the fifth bits
    // of elements 4t.. and 16+4t.. spread into bit 4 of each code byte.
    // Q5_0 takes the offset 144 (q - 16); Q4_1 / Q5_1 add m·Σx.
    static constexpr bool STAGED = true;  // qs through the shared-memory ring
    static constexpr int QB = 16, TC_UNIT = 32, TC_P = 8, TC_ALIGN = 8, QBYTES = 128;
    static constexpr int TC_MINBAT = 1;
    struct Raw {
        uint32_t q, h;
        float d, m;
    };
    struct Sc {  // a batch's qh words, d and m (8 f16 each)
        uint4 h0, h1, d, m;
    };
    __device__ __forceinline__ const uint8_t* qs_row(int row, int K) const {
        return qs + (size_t)row * (K >> 5) * 16;
    }
    // the batch's qh words, d and m in the staged tile
    static constexpr int OQH = 128, OD = OQH + (Q5 ? 32 : 0), OM = OD + 16;
    static constexpr int SCALE_BYTES = OM + (M ? 16 : 0) - 128, STR = stage_stride(SCALE_BYTES);
    __device__ __forceinline__ void stage_scales(uint32_t tile, int n0, int N, int K, int u, int n,
                                                 int lane) const {
        const size_t nb = (size_t)(K >> 5);
        if (Q5)
            copy_rows<32, STR>(tile, OQH, reinterpret_cast<const uint8_t*>(qh), nb * 4,
                               (size_t)u * 4, 4 * n, n0, N, lane);
        copy_rows<16, STR>(tile, OD, reinterpret_cast<const uint8_t*>(d), nb * 2, (size_t)u * 2,
                           2 * n, n0, N, lane);
        if (M)
            copy_rows<16, STR>(tile, OM, reinterpret_cast<const uint8_t*>(m), nb * 2,
                               (size_t)u * 2, 2 * n, n0, N, lane);
    }
    __device__ __forceinline__ Sc staged_scales(uint32_t row) const {
        Sc s;
        s.h0 = s.h1 = s.m = make_uint4(0u, 0u, 0u, 0u);
        if (Q5) {
            s.h0 = lds128(row);
            s.h1 = lds128(row + 16);
        }
        s.d = lds128(row + OD - 128);
        if (M) s.m = lds128(row + OM - 128);
        return s;
    }
    __device__ __forceinline__ Raw tc_raw(uint2 q, const Sc& s, int p) const {
        return Raw{q.x, word_of(p < 4 ? s.h0 : s.h1, p & 3), f16_of(s.d, p),
                   M ? f16_of(s.m, p) : 0.f};
    }
    __device__ __forceinline__ void codes(const Raw& r, int t, uint32_t p[4]) const {
        constexpr uint32_t neg = Q5 && !M ? NEG144 : NEG128;
        uint32_t lo = r.q & 0x0f0f0f0fu, hi = (r.q >> 4) & 0x0f0f0f0fu;
        if (Q5) {
            const uint32_t h = r.h >> (4 * t);
            lo |= spread4(h) << 4;
            hi |= spread4(h >> 16) << 4;
        }
        pairs7(lo, neg, p[0], p[1]);
        pairs7(hi, neg, p[2], p[3]);
    }
    __device__ __forceinline__ void tc_unit(const Raw& a, const Raw& b, const uint32_t (&xf)[4],
                                            int t, float acc[4]) const {
        float c[4] = {0.f, 0.f, 0.f, 0.f}, s[4] = {0.f, 0.f, 0.f, 0.f};
        uint32_t pa[4], pb[4];
        codes(a, t, pa);
        codes(b, t, pb);
        mma_step(c, pa[0], pa[1], pb[0], pb[1], xf[0], xf[1]);
        mma_step(c, pa[2], pa[3], pb[2], pb[3], xf[2], xf[3]);
        fold(acc, c, a.d, b.d);
        if (M) {
            sum_x(s, xf[0], xf[1]);
            sum_x(s, xf[2], xf[3]);
            fold(acc, s, a.m, b.m);
        }
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

    // tensor-core unit: a superblock. Lane t loads bytes 8t..8t+7 of each
    // 32-byte chunk j (and of qh for Q5_K): its word wd gives elements
    // 8t+4wd.. of group 2j (low nibbles) and of group 2j+1 (high nibbles),
    // so each group's two k16 steps stay inside it; qh bit g of each byte is
    // bit 4 of group g's code.
    static constexpr bool STAGED = false;
    static constexpr int TC_UNIT = 256, TC_P = 2, TC_ALIGN = 1, TC_MINBAT = 1;
    struct Raw {
        uint2 q[4], h, sc, mn;
        float d, dm;
    };
    __device__ __forceinline__ Raw tc_load(int row, int u, int K, int t) const {
        const size_t sb = (size_t)row * (K >> 8) + u;
        Raw r;
#pragma unroll
        for (int j = 0; j < 4; ++j)
            r.q[j] = __ldcs(reinterpret_cast<const uint2*>(qs + sb * 128 + 32 * j + 8 * t));
        r.h = Q5 ? __ldcs(reinterpret_cast<const uint2*>(qh + sb * 32 + 8 * t))
                 : make_uint2(0u, 0u);
        r.sc = __ldg(reinterpret_cast<const uint2*>(sc + sb * 8));
        r.mn = __ldg(reinterpret_cast<const uint2*>(mn + sb * 8));
        r.d = __ldg(d + sb);
        r.dm = __ldg(dmin + sb);
        return r;
    }
    __device__ __forceinline__ uint32_t code(const Raw& r, int j, int hn, int wd) const {
        const int g = 2 * j + hn;
        uint32_t cw = ((wd ? r.q[j].y : r.q[j].x) >> (4 * hn)) & 0x0f0f0f0fu;
        if (Q5) cw |= (((wd ? r.h.y : r.h.x) >> g) & 0x01010101u) << 4;
        return cw;
    }
    __device__ __forceinline__ void tc_unit(const Raw& a, const Raw& b, const __nv_bfloat16* xr,
                                            bool act, int u, int t, float acc[4]) const {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int hn = 0; hn < 2; ++hn) {
                const int g = 2 * j + hn;
                uint32_t xf[4];
                xfrag8(xr, 256 * u + 32 * g + 8 * t, act, xf);
                float c[4] = {0.f, 0.f, 0.f, 0.f}, s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
                for (int wd = 0; wd < 2; ++wd) {
                    uint32_t pa02, pa13, pb02, pb13;
                    pairs7(code(a, j, hn, wd), NEG128, pa02, pa13);
                    pairs7(code(b, j, hn, wd), NEG128, pb02, pb13);
                    mma_step(c, pa02, pa13, pb02, pb13, xf[2 * wd], xf[2 * wd + 1]);
                    sum_x(s, xf[2 * wd], xf[2 * wd + 1]);
                }
                const int i = g & 3;
                fold(acc, c, a.d * u8f(g < 4 ? a.sc.x : a.sc.y, i),
                     b.d * u8f(g < 4 ? b.sc.x : b.sc.y, i));
                fold(acc, s, -a.dm * u8f(g < 4 ? a.mn.x : a.mn.y, i),
                     -b.dm * u8f(g < 4 ? b.mn.x : b.mn.y, i));
            }
        }
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

    // tensor-core unit: a superblock; each 16-group (hh, i, lq) is one k16
    // step. Lane t loads word t of each 16-byte run: ql at 64hh + 32(i&1) +
    // 16lq (low nibbles for i < 2, high for i >= 2) and qh at 32hh + 16lq
    // (bits 2i, 2i+1 into bits 4, 5 of the code); codes q - 32 (offset 160).
    static constexpr bool STAGED = false;
    static constexpr int TC_UNIT = 256, TC_P = 2, TC_ALIGN = 1, TC_MINBAT = 1;
    struct Raw {
        uint32_t ql[8], qh[4];
        uint4 sc;
        float d;
    };
    __device__ __forceinline__ Raw tc_load(int row, int u, int K, int t) const {
        const size_t sb = (size_t)row * (K >> 8) + u;
        Raw r;
#pragma unroll
        for (int v = 0; v < 8; ++v)  // v = 4hh + 2(i&1) + lq
            r.ql[v] = __ldcs(reinterpret_cast<const unsigned int*>(ql + sb * 128 + 16 * v + 4 * t));
#pragma unroll
        for (int v = 0; v < 4; ++v)  // v = 2hh + lq
            r.qh[v] = __ldcs(reinterpret_cast<const unsigned int*>(qh + sb * 64 + 16 * v + 4 * t));
        r.sc = __ldg(reinterpret_cast<const uint4*>(sc + sb * 16));
        r.d = __ldg(d + sb);
        return r;
    }
    __device__ __forceinline__ uint32_t code(const Raw& r, int hh, int i, int lq) const {
        const uint32_t w = r.ql[4 * hh + 2 * (i & 1) + lq];
        return ((i < 2 ? w : w >> 4) & 0x0f0f0f0fu) |
               (((r.qh[2 * hh + lq] >> (2 * i)) & 0x03030303u) << 4);
    }
    __device__ __forceinline__ void tc_unit(const Raw& a, const Raw& b, const __nv_bfloat16* xr,
                                            bool act, int u, int t, float acc[4]) const {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
                for (int lq = 0; lq < 2; ++lq) {
                    const int gi = 8 * hh + 2 * i + lq;
                    uint32_t x0, x1, pa02, pa13, pb02, pb13;
                    xfrag4(xr, 256 * u + 128 * hh + 32 * i + 16 * lq + 4 * t, act, x0, x1);
                    pairs7(code(a, hh, i, lq), NEG160, pa02, pa13);
                    pairs7(code(b, hh, i, lq), NEG160, pb02, pb13);
                    float c[4] = {0.f, 0.f, 0.f, 0.f};
                    mma_step(c, pa02, pa13, pb02, pb13, x0, x1);
                    fold(acc, c, a.d * s8f(word_of(a.sc, gi >> 2), gi & 3),
                         b.d * s8f(word_of(b.sc, gi >> 2), gi & 3));
                }
            }
        }
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

    // tensor-core unit: a superblock; each 16-group (hh, j, lq) is one k16
    // step. Lane t loads word t of the qs run at 32hh + 16lq; shift j gives
    // the 2-bit codes of group 8hh + 2j + lq. The 4-bit sub-scale times a
    // code is at most 45, exact in bf16, so it enters the codes: one fma
    // (128 + q)·sc − 128·sc; the min is an MMA of the group's mn (all k)
    // against x. Both sums run over the superblock, scaled once by d, dmin.
    static constexpr bool STAGED = false;
    static constexpr int TC_UNIT = 256, TC_P = 2, TC_ALIGN = 1, TC_MINBAT = 1;
    struct Raw {
        uint32_t q[4];
        uint4 sc, mn;
        float d, dm;
    };
    __device__ __forceinline__ Raw tc_load(int row, int u, int K, int t) const {
        const size_t sb = (size_t)row * (K >> 8) + u;
        Raw r;
#pragma unroll
        for (int v = 0; v < 4; ++v)  // v = 2hh + lq
            r.q[v] = __ldcs(reinterpret_cast<const unsigned int*>(qs + sb * 64 + 16 * v + 4 * t));
        r.sc = __ldg(reinterpret_cast<const uint4*>(sc + sb * 16));
        r.mn = __ldg(reinterpret_cast<const uint4*>(mn + sb * 16));
        r.d = __ldg(d + sb);
        r.dm = __ldg(dmin + sb);
        return r;
    }
    // byte i of w (< 128) as a bf16 pair
    static __device__ __forceinline__ uint32_t bf2_of(uint32_t w, int i) {
        return hfma2(__byte_perm(w, 0x43434343u, 0x4040 | i | (i << 8)), ONE2, NEG128);
    }
    __device__ __forceinline__ void tc_unit(const Raw& a, const Raw& b, const __nv_bfloat16* xr,
                                            bool act, int u, int t, float acc[4]) const {
        // four pairs of sums in turn: chains of 4 dependent MMAs, not 16
        float c[4][4] = {}, m[4][4] = {};
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
#pragma unroll
                for (int lq = 0; lq < 2; ++lq) {
                    const int gi = 8 * hh + 2 * j + lq, v = 2 * hh + lq;
                    uint32_t x0, x1;
                    xfrag4(xr, 256 * u + 128 * hh + 32 * j + 16 * lq + 4 * t, act, x0, x1);
                    const uint32_t sa = bf2_of(word_of(a.sc, gi >> 2), gi & 3);
                    const uint32_t sb = bf2_of(word_of(b.sc, gi >> 2), gi & 3);
                    const uint32_t na = hfma2(sa, NEG128, 0u), nb = hfma2(sb, NEG128, 0u);
                    const uint32_t ca = (a.q[v] >> (2 * j)) & 0x03030303u;
                    const uint32_t cb = (b.q[v] >> (2 * j)) & 0x03030303u;
                    const int e = 2 * (j & 1) + lq;
                    mma_bf16(c[e], hfma2(__byte_perm(ca, 0x43434343u, 0x4140), sa, na),
                             hfma2(__byte_perm(cb, 0x43434343u, 0x4140), sb, nb),
                             hfma2(__byte_perm(ca, 0x43434343u, 0x4342), sa, na),
                             hfma2(__byte_perm(cb, 0x43434343u, 0x4342), sb, nb), x0, x1);
                    const uint32_t ma = bf2_of(word_of(a.mn, gi >> 2), gi & 3);
                    const uint32_t mb = bf2_of(word_of(b.mn, gi >> 2), gi & 3);
                    mma_bf16(m[e], ma, mb, ma, mb, x0, x1);
                }
            }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            fold(acc, c[e], a.d, b.d);
            fold(acc, m[e], -a.dm, -b.dm);
        }
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

    // tensor-core unit: Q2_K's steps, hmask word t of its run at 16lq (bit
    // 4hh + j of each byte into bit 2 of the code); codes q + 4h - 4
    // (offset 132).
    static constexpr bool STAGED = false;
    static constexpr int TC_UNIT = 256, TC_P = 2, TC_ALIGN = 1, TC_MINBAT = 1;
    struct Raw {
        uint32_t q[4], hm[2];
        uint4 sc;
        float d;
    };
    __device__ __forceinline__ Raw tc_load(int row, int u, int K, int t) const {
        const size_t sb = (size_t)row * (K >> 8) + u;
        Raw r;
#pragma unroll
        for (int v = 0; v < 4; ++v)  // v = 2hh + lq
            r.q[v] = __ldcs(reinterpret_cast<const unsigned int*>(qs + sb * 64 + 16 * v + 4 * t));
#pragma unroll
        for (int lq = 0; lq < 2; ++lq)
            r.hm[lq] =
                __ldcs(reinterpret_cast<const unsigned int*>(hmask + sb * 32 + 16 * lq + 4 * t));
        r.sc = __ldg(reinterpret_cast<const uint4*>(sc + sb * 16));
        r.d = __ldg(d + sb);
        return r;
    }
    __device__ __forceinline__ uint32_t code(const Raw& r, int hh, int j, int lq) const {
        return ((r.q[2 * hh + lq] >> (2 * j)) & 0x03030303u) |
               (((r.hm[lq] >> (4 * hh + j)) & 0x01010101u) << 2);
    }
    __device__ __forceinline__ void tc_unit(const Raw& a, const Raw& b, const __nv_bfloat16* xr,
                                            bool act, int u, int t, float acc[4]) const {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
#pragma unroll
                for (int lq = 0; lq < 2; ++lq) {
                    const int gi = 8 * hh + 2 * j + lq;
                    uint32_t x0, x1, pa02, pa13, pb02, pb13;
                    xfrag4(xr, 256 * u + 128 * hh + 32 * j + 16 * lq + 4 * t, act, x0, x1);
                    pairs7(code(a, hh, j, lq), NEG132, pa02, pa13);
                    pairs7(code(b, hh, j, lq), NEG132, pb02, pb13);
                    float c[4] = {0.f, 0.f, 0.f, 0.f};
                    mma_step(c, pa02, pa13, pb02, pb13, x0, x1);
                    fold(acc, c, a.d * s8f(word_of(a.sc, gi >> 2), gi & 3),
                         b.d * s8f(word_of(b.sc, gi >> 2), gi & 3));
                }
            }
        }
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
template <int G, class ScaleT, bool T8 = false>
struct TableNib {
    const uint8_t* qs;
    const ScaleT* d;
    uint32_t tab[4];  // table value v in byte v % 4 of word v / 4
    uint32_t tlo[4], thi[4];  // the low / high byte of bf16(value v), laid out as tab
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
        return TableNib{qs + blk * 16,
                        d + blk * (32 / G),
                        {tab[0], tab[1], tab[2], tab[3]},
                        {tlo[0], tlo[1], tlo[2], tlo[3]},
                        {thi[0], thi[1], thi[2], thi[3]}};
    }

    // the 8 codes of a qs word → bf16 pairs of their values, looked up
    // byte by byte in tlo / thi (no int → bf16 step): p[0] = (e, e+1) and
    // p[1] = (e+2, e+3) of the low nibbles, p[2], p[3] of the high ones. As
    // lookup: each half-word's four nibbles (byte 2i low, high, byte 2i+1
    // low, high) select from the 16 bytes in two 8-byte halves, bit 3 picks;
    // a table of at most 8 values (t8) needs the first half alone.
    __device__ __forceinline__ void lookup_bf16(uint32_t q4, uint32_t (&p)[4]) const {
        uint32_t lo[2], hi[2];
        if constexpr (T8) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const uint32_t idx = (q4 >> (16 * i)) & 0x7777u;
                lo[i] = __byte_perm(tlo[0], tlo[1], idx);
                hi[i] = __byte_perm(thi[0], thi[1], idx);
            }
        } else {
            const uint32_t sel = 0x32103210u | ((q4 & 0x88888888u) >> 1);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const uint32_t idx = (q4 >> (16 * i)) & 0x7777u, s2 = sel >> (16 * i);
                lo[i] = __byte_perm(__byte_perm(tlo[0], tlo[1], idx),
                                    __byte_perm(tlo[2], tlo[3], idx), s2);
                hi[i] = __byte_perm(__byte_perm(thi[0], thi[1], idx),
                                    __byte_perm(thi[2], thi[3], idx), s2);
            }
        }
        p[0] = __byte_perm(lo[0], hi[0], 0x6240);
        p[1] = __byte_perm(lo[1], hi[1], 0x6240);
        p[2] = __byte_perm(lo[0], hi[0], 0x7351);
        p[3] = __byte_perm(lo[1], hi[1], 0x7351);
    }

    // tensor-core unit: one 32-block, lane t word t as Q4_0; the values come
    // as bf16 pairs straight from the byte tables (lookup_bf16: 21 ops for 8
    // codes, where a lookup and the int8 route of Q8_0 take 35). G = 32:
    // both k16 steps share one scale; G = 16: the low-nibble step takes
    // scale 2b, the high 2b+1.
    static constexpr bool STAGED = true;  // qs through the shared-memory ring
    static constexpr int QB = 16, TC_UNIT = 32, TC_P = 8, TC_ALIGN = 8, QBYTES = 128;
    static constexpr int TC_MINBAT = 1;
    struct Raw {
        uint32_t q;
        float s0, s1;
    };
    struct Sc {  // a batch's scales: 8 f16, or 8 (G = 32) or 16 (G = 16) f32
        uint4 v[4];
    };
    __device__ __forceinline__ const uint8_t* qs_row(int row, int K) const {
        return qs + (size_t)row * (K >> 5) * 16;
    }
    // the batch's scales in the staged tile
    static constexpr int SCALE_BYTES = TC_P * (32 / G) * (int)sizeof(ScaleT);
    static constexpr int STR = stage_stride(SCALE_BYTES);
    __device__ __forceinline__ void stage_scales(uint32_t tile, int n0, int N, int K, int u, int n,
                                                 int lane) const {
        constexpr int PB = (32 / G) * (int)sizeof(ScaleT);  // scale bytes a block
        copy_rows<SCALE_BYTES, STR>(tile, 128, reinterpret_cast<const uint8_t*>(d),
                                    (size_t)(K >> 5) * PB, (size_t)u * PB, PB * n, n0, N, lane);
    }
    __device__ __forceinline__ Sc staged_scales(uint32_t row) const {
        Sc s;
#pragma unroll
        for (int i = 0; i < 4; ++i)
            s.v[i] = i < SCALE_BYTES / 16 ? lds128(row + 16 * i) : make_uint4(0u, 0u, 0u, 0u);
        return s;
    }
    __device__ __forceinline__ Raw tc_raw(uint2 q, const Sc& s, int p) const {
        if (sizeof(ScaleT) == 2) {
            const float f = f16_of(s.v[0], p);
            return Raw{q.x, f, f};
        }
        if (G == 32) {
            const float f = __uint_as_float(word_of(s.v[p >> 2], p & 3));
            return Raw{q.x, f, f};
        }
        return Raw{q.x, __uint_as_float(word_of(s.v[p >> 1], 2 * (p & 1))),
                   __uint_as_float(word_of(s.v[p >> 1], 2 * (p & 1) + 1))};
    }
    __device__ __forceinline__ void tc_unit(const Raw& a, const Raw& b, const uint32_t (&xf)[4],
                                            int, float acc[4]) const {
        uint32_t pa[4], pb[4];
        lookup_bf16(a.q, pa);
        lookup_bf16(b.q, pb);
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        mma_step(c, pa[0], pa[1], pb[0], pb[1], xf[0], xf[1]);
        if (G == 16) {
            fold(acc, c, a.s0, b.s0);
            c[0] = c[1] = c[2] = c[3] = 0.f;
        }
        mma_step(c, pa[2], pa[3], pb[2], pb[3], xf[2], xf[3]);
        fold(acc, c, G == 32 ? a.s0 : a.s1, G == 32 ? b.s0 : b.s1);
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
// Only B9 (qmm_expert_gemv, NB = 1) runs it since B1 took the tensor cores.
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

// ---- tensor-core GEMV (B <= 8) ----------------------------------------------
// Block = one 16-row tile, nw = 4, 8 or 16 warps over contiguous slices of
// its K units; a cluster of C blocks (grid x = tiles · C) splits K further
// where 16 warps a tile still leave SMs idle. Lane (g, t) multiplies rows g
// and g + 8 with column g of x (zeros for g >= B); its sums are rows g /
// g + 8 × columns 2t, 2t + 1. The warps' sums meet in shared memory, the
// ranks' in rank 0's (distributed shared memory), each added in a fixed
// order: no atomics, the same result every call.
constexpr int TC_MAX_WARPS = 16;  // warps a block: 4, 8 or 16
constexpr int TC_MAX_CLUSTER = 4;  // 8 cost more than they gained on 1024 × 4096
constexpr int TC_STAGES = 3;
// the staged kinds' ring: a warp's stage holds the 16-row tile and x's B
// rows of the batch; nw warps × TC_STAGES stages
template <class W> __host__ __device__ constexpr int tc_stage_bytes(int B) {
    if constexpr (W::STAGED) {
        return 16 * W::STR + B * (64 * W::TC_P + 32);
    } else {
        return 0;
    }
}
// a block's dynamic shared memory: the warps' rings, then their 4 × 32 sums
template <class W> constexpr int tc_smem(int nw, int B) {
    return nw * (TC_STAGES * tc_stage_bytes<W>(B) + 512);
}
template <class W>
__global__ void __launch_bounds__(TC_MAX_WARPS * 32, 1)  // <= 128 registers
qmm_tc(const W w, const __nv_bfloat16* __restrict__ x, float* __restrict__ y, int B, int N, int K,
       int C) {
    extern __shared__ __align__(16) uint8_t dyn[];  // the warps' rings, then part
    __shared__ float recv[TC_MAX_CLUSTER][4][32];  // rank 0: [rank][i][lane]
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int nw = blockDim.x >> 5, lw = __ffs(nw) - 1;  // 4, 8 or 16 warps
    const int lc = __ffs(C) - 1;  // C is 1, 2 or 4
    const int rank = blockIdx.x & (C - 1), n0 = (blockIdx.x >> lc) * 16;
    // slices of whole batches of TC_ALIGN units (aligned vector loads)
    const int nu = K / W::TC_UNIT, nb = (nu + W::TC_ALIGN - 1) / W::TC_ALIGN;
    const int sl = rank * nw + warp, ls = lc + lw;  // S = C · nw slices, ls = log2 S
    const int u0 = min(nu, W::TC_ALIGN * ((nb * sl) >> ls));
    const int u1 = min(nu, W::TC_ALIGN * ((nb * (sl + 1)) >> ls));
    const bool act = g < B;
    const int SB = tc_stage_bytes<W>(B);  // a warp's ring stage (the staged kinds)
    float* part = reinterpret_cast<float*>(dyn + nw * TC_STAGES * SB);  // [warp][sum i][lane]
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (W::STAGED) {
        // qs, scales and x through a 3-stage cp.async ring a warp. A stage:
        // the 16-row tile (a row: QBYTES qs bytes, then its batch of scales;
        // STR bytes apart: ldmatrix's eight rows hit distinct banks), then
        // x's B rows of the batch (XSTR bytes apart). A warp's qs copy reads
        // whole 128-byte lines; ldmatrix.x4 hands lane (g, t) word t of rows
        // g and g + 8 of two blocks (Q8_0: of a block's two halves).
        constexpr int STR = W::STR, TILE = 16 * STR, STAGES = TC_STAGES;
        constexpr int QBYTES = W::QBYTES, XBYTES = 64 * W::TC_P, XSTR = XBYTES + 32;
        // a stage: TILE + B · XSTR bytes; dyn holds [nw][STAGES][SB]
        const uint32_t base = (uint32_t)__cvta_generic_to_shared(dyn) + warp * STAGES * SB;
        // a row's QBYTES qs bytes are SEGS 16-byte pieces: RPI rows an
        // iteration of the warp's copy, ITER iterations
        constexpr int SEGS = QBYTES / 16, RPI = 32 / SEGS, ITER = 16 / RPI;
        const uint8_t* src[ITER];  // rows lane / SEGS + RPI i of the tile
#pragma unroll
        for (int i = 0; i < ITER; ++i)
            src[i] = w.qs_row(min(n0 + lane / SEGS + RPI * i, N - 1), K);
        const int seg = lane % SEGS, nbat = (u1 - u0 + W::TC_P - 1) / W::TC_P;
        auto copy = [&](int bt) {  // batch bt of the slice into its stage
            const int u = u0 + bt * W::TC_P, n = min(W::TC_P, u1 - u);
            const uint32_t dst = base + (bt % STAGES) * SB;
#pragma unroll
            for (int i = 0; i < ITER; ++i)
                cp_async16(dst + (lane / SEGS + RPI * i) * STR + 16 * seg,
                           src[i] + (size_t)u * W::QB + 16 * seg, 16 * seg < n * W::QB);
            w.stage_scales(dst, n0, N, K, u, n, lane);
            // x: XBYTES / 16 pieces a row, B rows
            for (int c = lane; c < B * (XBYTES / 16); c += 32) {
                const int b = c / (XBYTES / 16), piece = c % (XBYTES / 16);
                cp_async16(dst + TILE + b * XSTR + 16 * piece, x + (size_t)b * K + 32 * u + 8 * piece,
                           16 * piece < 64 * n);
            }
        };
#pragma unroll
        for (int bt = 0; bt < STAGES - 1; ++bt) {
            if (bt < nbat) copy(bt);
            cp_async_commit();
        }
        const int r = (lane & 7) + 8 * ((lane >> 3) & 1), hi = lane >> 4;  // lane's ldmatrix row
        for (int bt = 0; bt < nbat; ++bt) {
            const int n = min(W::TC_P, u1 - u0 - bt * W::TC_P);
            if (bt + STAGES - 1 < nbat) copy(bt + STAGES - 1);
            cp_async_commit();
            cp_async_wait<STAGES - 1>();
            __syncwarp();
            const uint32_t stage = base + (bt % STAGES) * SB;
            const typename W::Sc sa = w.staged_scales(stage + g * STR + QBYTES);
            const typename W::Sc sb = w.staged_scales(stage + (g + 8) * STR + QBYTES);
            // the batch's ldmatrix first, so its units' work is independent
            const uint32_t rows = stage + r * STR;
            uint32_t f[QBYTES / 32][4];
#pragma unroll
            for (int i = 0; i < QBYTES / 32; ++i)  // QB 16: blocks 2i, 2i + 1; QB 32: block i's halves
                ldsm_x4(f[i], rows + 32 * i + 16 * hi);
            const uint32_t xs = stage + TILE + g * XSTR + 8 * t;  // x row g of the batch
            auto unit = [&](int p) {
                const uint32_t* fi = f[W::QB == 16 ? p >> 1 : p];
                const int e = W::QB == 16 ? p & 1 : 0;  // QB 16: regs 2e (row g), 2e + 1 (g + 8)
                const uint2 qa = W::QB == 16 ? make_uint2(fi[2 * e], 0u) : make_uint2(fi[0], fi[2]);
                const uint2 qb =
                    W::QB == 16 ? make_uint2(fi[2 * e + 1], 0u) : make_uint2(fi[1], fi[3]);
                // x[32p + 4t ..] and x[32p + 16 + 4t ..] of column g (zeros past B)
                uint2 x0 = make_uint2(0u, 0u), x1 = make_uint2(0u, 0u);
                if (act) {
                    x0 = lds64(xs + 64 * p);
                    x1 = lds64(xs + 64 * p + 32);
                }
                const uint32_t xf[4] = {x0.x, x0.y, x1.x, x1.y};
                w.tc_unit(w.tc_raw(qa, sa, p), w.tc_raw(qb, sb, p), xf, t, acc);
            };
            if (n == W::TC_P) {  // a whole batch: straight-line units the compiler interleaves
#pragma unroll
                for (int p = 0; p < W::TC_P; ++p) unit(p);
            } else {
#pragma unroll
                for (int p = 0; p < W::TC_P; ++p)
                    if (p < n) unit(p);
            }
            __syncwarp();  // the stage is copied into again
        }
        cp_async_wait<0>();
    } else {
        const int row_a = min(n0 + g, N - 1), row_b = min(n0 + g + 8, N - 1);  // ragged N: row N-1
        const __nv_bfloat16* xr = x + (size_t)(act ? g : 0) * K;
        for (int u = u0; u < u1; u += W::TC_P) {  // TC_P units' loads in flight, then products
            typename W::Raw ra[W::TC_P], rb[W::TC_P];
#pragma unroll
            for (int p = 0; p < W::TC_P; ++p) {
                if (u + p < u1) {
                    ra[p] = w.tc_load(row_a, u + p, K, t);
                    rb[p] = w.tc_load(row_b, u + p, K, t);
                }
            }
#pragma unroll
            for (int p = 0; p < W::TC_P; ++p)
                if (u + p < u1) w.tc_unit(ra[p], rb[p], xr, act, u + p, t, acc);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) part[(warp * 4 + i) * 32 + lane] = acc[i];
    __syncthreads();
    // thread (i, l) of the first 128 adds sum i of lane l over the warps, in order
    const int i = warp & 3, l = lane;
    const bool adder = threadIdx.x < 128;
    float v = 0.f;
    if (adder) {
        for (int wi = 0; wi < nw; ++wi) v += part[(wi * 4 + i) * 32 + l];
    }
    if (C > 1) {  // the ranks' sums in rank 0's shared memory, added in order
        cg::cluster_group cluster = cg::this_cluster();
        float* dst = cluster.map_shared_rank(&recv[0][0][0], 0);
        if (adder) dst[(rank * 4 + i) * 32 + l] = v;
        cluster.sync();
        if (rank != 0) return;
        v = 0.f;
        for (int r = 0; r < C; ++r) v += recv[r][i][l];
    }
    const int row = n0 + (l >> 2) + 8 * (i >> 1), col = 2 * (l & 3) + (i & 1);
    if (adder && col < B && row < N) y[(size_t)col * N + row] = v;
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

// The shape of the grid: the most warps (nw a block, clusters of C) that run
// in one wave, each with TC_MINBAT batches of K or more; where the tiles
// alone fill more than a wave, 4 warps a block (Q8_0: the block size whose
// last wave is fullest). Blocks resident at once come from the occupancy
// calculator for each B and nw (registers, the ring's shared memory).
template <class W>
int launch_tc(const W& w, const void* x, void* y, int B, int N, int K, cudaStream_t st) {
    struct Occ {
        int slots[8][3];  // blocks resident on the card at once: B - 1, 4 / 8 / 16 warps a block
    };
    static const Occ occ = [] {
        Occ o;
        int dev = 0, sms = 132, optin = 48 * 1024;
        if (cudaGetDevice(&dev) == cudaSuccess) {
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
            cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        }
        cudaFuncAttributes fa;
        const int fixed = cudaFuncGetAttributes(&fa, qmm_tc<W>) == cudaSuccess
                              ? (int)fa.sharedSizeBytes : 8 * 1024;
        const int most = optin - fixed;  // the dynamic shared memory a block may take
        if (W::STAGED)
            cudaFuncSetAttribute(qmm_tc<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
        for (int b = 0; b < 8; ++b)
            for (int a = 0; a < 3; ++a) {
                const int nw = 4 << a, bytes = tc_smem<W>(nw, b + 1);
                int per = 0;
                if (nw > TC_MAX_WARPS || bytes > most ||
                    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, qmm_tc<W>, nw * 32,
                                                                  bytes) != cudaSuccess)
                    per = 0;
                o.slots[b][a] = sms * per;
            }
        return o;
    }();
    const int* sl = occ.slots[B - 1];
    const int tiles = (N + 15) / 16;
    const int nb = (K / W::TC_UNIT + W::TC_ALIGN - 1) / W::TC_ALIGN;  // batches of K
    // the most warps that still run in one wave with a batch of K or more
    // each: nw warps a block and clusters of C blocks split K; fewer
    // clusters, then fewer warps, where the count ties
    int nw = 4, C = 1, best = 0;
    for (int c = 1; c <= TC_MAX_CLUSTER; c *= 2)
        for (int a = 0; a < 3; ++a) {
            const int n = 4 << a;
            if (sl[a] < tiles * c || n * c * W::TC_MINBAT > nb || tiles * n * c <= best) continue;
            best = tiles * n * c;
            nw = n;
            C = c;
        }
    if (best == 0 && W::TC_MINBAT > 1) {  // Q8_0 past one wave: the fullest last wave
        float fill = 0.f;
        for (int a = 0; a < 3; ++a) {
            if (sl[a] < 1 || (4 << a) > nb) continue;
            const float waves = (float)tiles / sl[a], f = waves / ceilf(waves);
            if (f > fill * 1.05f) {
                fill = f;
                nw = 4 << a;
            }
        }
    }
    const int smem = tc_smem<W>(nw, B);
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    float* yf = static_cast<float*>(y);
    if (C == 1) {
        qmm_tc<W><<<tiles, nw * 32, smem, st>>>(w, xb, yf, B, N, K, 1);
        return (int)cudaGetLastError();
    }
    cudaLaunchAttribute at;
    at.id = cudaLaunchAttributeClusterDimension;
    at.val.clusterDim.x = C;
    at.val.clusterDim.y = 1;
    at.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(tiles * C, 1, 1);
    cfg.blockDim = dim3(nw * 32, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = &at;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, qmm_tc<W>, w, xb, yf, B, N, K, C);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

template <class W>
int qmm_launch(const W& w, const void* x, void* y, int B, int N, int K, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (B <= 8) return launch_tc(w, x, y, B, N, K, st);
    const dim3 grid((N + TN - 1) / TN, (B + TM - 1) / TM);
    qmm_tiled<W><<<grid, TILE_THREADS, 0, st>>>(w, static_cast<const __nv_bfloat16*>(x),
                                                static_cast<float*>(y), B, N, K);
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
template <int G, class ScaleT, bool T8 = false>
TableNib<G, ScaleT, T8> table_weight(const void* qs, const void* d, uint32_t t0, uint32_t t1,
                                     uint32_t t2, uint32_t t3) {
    TableNib<G, ScaleT, T8> w{static_cast<const uint8_t*>(qs), static_cast<const ScaleT*>(d),
                              {t0, t1, t2, t3}, {0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}};
    for (int v = 0; v < 16; ++v) {  // bf16 of an int8 is the top half of its f32 (exact)
        const float f = (float)(int8_t)((w.tab[v / 4] >> (8 * (v % 4))) & 0xffu);
        uint32_t bits;
        memcpy(&bits, &f, 4);
        w.tlo[v / 4] |= ((bits >> 16) & 0xffu) << (8 * (v % 4));
        w.thi[v / 4] |= (bits >> 24) << (8 * (v % 4));
    }
    return w;
}

// B <= 8: values 8-15 all zero are the padding of a table of at most 8
// (IQ2_*, IQ1_*, TQ*: their codes stay below 8), whose lookups take half
// the prmt (T8); B > 8 (and B9) look up all 16 either way
template <int G, class ScaleT>
int table_launch(const void* x, const void* qs, const void* d, uint32_t t0, uint32_t t1,
                 uint32_t t2, uint32_t t3, void* y, int B, int N, int K, void* stream) {
    if (B <= 8 && (t2 | t3) == 0u)
        return launch_tc(table_weight<G, ScaleT, true>(qs, d, t0, t1, t2, t3), x, y, B, N, K,
                         static_cast<cudaStream_t>(stream));
    return qmm_launch(table_weight<G, ScaleT>(qs, d, t0, t1, t2, t3), x, y, B, N, K, stream);
}

KERNELS_API int qmm_tab32_f16(const void* x, const void* qs, const void* d, uint32_t t0,
                              uint32_t t1, uint32_t t2, uint32_t t3, void* y, int B, int N, int K,
                              void* stream) {
    return table_launch<32, __half>(x, qs, d, t0, t1, t2, t3, y, B, N, K, stream);
}

KERNELS_API int qmm_tab32_f32(const void* x, const void* qs, const void* d, uint32_t t0,
                              uint32_t t1, uint32_t t2, uint32_t t3, void* y, int B, int N, int K,
                              void* stream) {
    return table_launch<32, float>(x, qs, d, t0, t1, t2, t3, y, B, N, K, stream);
}

KERNELS_API int qmm_tab16_f32(const void* x, const void* qs, const void* d, uint32_t t0,
                              uint32_t t1, uint32_t t2, uint32_t t3, void* y, int B, int N, int K,
                              void* stream) {
    return table_launch<16, float>(x, qs, d, t0, t1, t2, t3, y, B, N, K, stream);
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
