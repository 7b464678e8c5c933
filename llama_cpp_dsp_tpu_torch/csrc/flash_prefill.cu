// flash_prefill.cu — causal prefill attention (T > 1) of q[B,T,H,D] f32
// over one slot's cached rows [B,Hkv,S,D] of bf16, f16 or f32. Query t of
// slot b sits at position p = n_past[b] + t and attends the rows j with
// j <= p, and j > p - window on a sliding-window layer (window > 0), or
// j >= floor(p / attn_chunk) * attn_chunk with chunked attention
// (attn_chunk > 0). Scores q·k·scale, then softcap·tanh(s / softcap) when
// softcap > 0; softmax and the value sum in f32. Output [B,T,H,D] f32. Rows
// at or past n_past + T (stale, possibly 1e30) are never read.
//
// Replaces: llama_cpp_dsp_tpu/ops/pallas/attention.py::_prefill_kernel
// (entry flash_prefill). The TPU kernel is a sequential loop over K/V chunks
// inside a (slot, kv head, query tile) program whose GQA group is one
// [TQ·rep, D] operand of the matrix unit. Here both kernels below keep that
// packing: a block's rows are (query, head) pairs of one kv head's group —
// TQ queries by RH = min(rep, rows) heads (a larger group is split over
// blocks) — so each K/V chunk it stages serves every head of the group; a
// grid over (query tile, kv head × head split, slot) runs the tiles in
// parallel, and a block walks only the chunks between its first visible row
// and its last query's position (the causal span, the window, the chunk
// rule), as the TPU kernel skips the chunks before the window and after the
// causal limit.
//
// Bounds on this card, per 1500-token Gemma-3-12B prefill (48 layers, 16
// heads of 256 over 8 kv heads, 40 layers with a 1024-row window): 8.11e11
// useful operations (4·H·D per visible (query, row) pair); at the 989
// TFLOP/s of the bf16 tensor cores that is 0.820 ms, at the 67 TFLOP/s of
// f32 outside them 12.10 ms. The K/V rows are read once per query tile, a
// few bytes per hundred operations, so operations bound it, not bytes.
//
// bf16 and f16 rows: prefill_tc_kernel, on the tensor cores. Each warp owns
// 16 (query, head) rows and their online softmax (m, l) in registers; the
// block's WARPS warps share each K/V chunk. q·kᵀ and p·V are
// mma.sync.m16n8k16 products with f32 accumulators, fed by ldmatrix (.trans
// for V) from shared memory, FlashAttention-2's shape: the score
// accumulator fragment becomes the A operand of p·V in registers.
//   Numerics. A single bf16 pass would round q and p to 8 bits (~2^-9
// relative a term, NMSE ~1e-6 against the f32 plain version), far outside
// the 1e-8 that the check holds this kernel to. So each f32 operand is split
// into two terms of the row type: q·scale = q_hi + q_lo with q_hi = rn(q),
// q_lo = rn(q − q_hi) (done once a block, both kept in shared memory), and
// p = P_hi + P_lo the same way in registers; each score is q_hi·k + q_lo·k
// and each value sum P_hi·V + P_lo·V, in f32. K and V are used as stored (a
// bf16 or f16 value is exact in its own type), the products are exact, and
// the two terms carry 16 bits (22 in f16) of each operand: ~2^-17 relative
// a term, NMSE ~1e-11. The price is twice the tensor-core products: 1.640
// ms of bound per 12B prefill instead of 0.820. For f16 rows the terms are
// f16: a q_lo or P_lo below f16's normal range (6.1e-5) is subnormal and
// keeps an absolute error of at most 2^-25 (a q·scale below 0.125, a p below
// 0.125), which is 2^-25·|k| a score term and 2^-25·|v| / l ≤ 2^-25·|v| a
// value term, below the bf16 split's error at the check's scales (q·scale
// ≤ ~1.3, |k|, |v| ~ 1). q·scale must stay below f16's 65504.
//   K/V chunks of BN rows go to shared memory in their stored type with
// cp.async.cg 16-byte copies, double-buffered: chunk c + 1 is in flight
// while chunk c computes. Rows outside the block's visible span are
// zero-filled by the copy (source size 0), never read. Shared rows are
// 16-byte pieces XOR-swizzled by (row mod 8), so ldmatrix's eight row
// addresses fall on distinct banks. A chunk that a warp's rows see whole
// runs unmasked; only chunks that straddle a bound build the mask, and a
// warp skips a chunk none of its rows sees. Tiles are scheduled longest
// first (the last query tile has the most chunks). Shared memory: q_hi and
// q_lo [BM][D] plus two stages of K and V [BN][D]: 96 KB at D = 128 (BN 64,
// two blocks an SM), 128 KB at D = 256 (BN 32; one block an SM). Registers:
// the output accumulator is D/8 fragments of 4 f32, 128 a thread at D =
// 256, where ptxas reports 255 registers and a 48-byte spill (179-182 at D
// = 128, no spill; `-Xptxas -v`, chip_smoke.py's [build] lines).
//
// f32 rows (-ctk f32 -ctv f32, rare; splitting f32 K and V would take three
// bf16 products a term): prefill_kernel, on the CUDA cores. Eight threads
// own a query row: they take 4 of the chunk's 32 scores each (q·k in f32),
// keep the row's online softmax in registers, reduced over the eight with
// shuffles, write the probabilities to shared memory, and each accumulate
// D/8 output dims of p·V; K and V are staged in f32. Bound: the 67 TFLOP/s.
#include <math.h>

#include "common.cuh"

namespace {

enum RowType : int { BF16 = 0, F16 = 1, F32 = 2 };

struct PrefillArgs {
    const float* q;      // [B,T,H,D]
    const void* k;       // [B,Hkv,S,D]
    const void* v;
    const int* n_past;   // [B]
    float* out;          // [B,T,H,D]
    int T, H, Hkv, S;
    int rh;              // heads of the group a block takes
    int tq;              // queries a block takes (rows / rh)
    int head_blocks;     // blocks a kv head's group is split over
    int window, attn_chunk;
    float scale, softcap;
};

// the first row position p may attend
__device__ __forceinline__ int first_row(const PrefillArgs& a, int p) {
    if (a.window > 0) return max(p - a.window + 1, 0);
    if (a.attn_chunk > 0) return (p / a.attn_chunk) * a.attn_chunk;
    return 0;
}

// a block of `rows` (query, head) rows: heads rh, queries tq, head splits
void set_rows(PrefillArgs& a, int rows) {
    const int rep = a.H / a.Hkv;
    a.rh = min(rep, rows);
    a.tq = rows / a.rh;
    a.head_blocks = (rep + a.rh - 1) / a.rh;
}

// ---------------------------------------------------------------------------
// bf16 / f16 rows: split-operand tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int WARPS = 4;
constexpr int TC_THREADS = 32 * WARPS;
constexpr int BM = 16 * WARPS;  // (query, head) rows a block takes
constexpr float LOG2E = 1.4426950408889634f;

template <int R>
struct Half2;  // a pair of row-type values in one 32-bit word, low half first

template <>
struct Half2<BF16> {
    __device__ __forceinline__ static uint32_t pack(float x, float y) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
        return *reinterpret_cast<const uint32_t*>(&h);
    }
    __device__ __forceinline__ static float2 unpack(uint32_t u) {
        return make_float2(bf16_lo(u), bf16_hi(u));
    }
};

template <>
struct Half2<F16> {
    __device__ __forceinline__ static uint32_t pack(float x, float y) {
        const __half2 h = __floats2half2_rn(x, y);
        return *reinterpret_cast<const uint32_t*>(&h);
    }
    __device__ __forceinline__ static float2 unpack(uint32_t u) {
        return __half22float2(*reinterpret_cast<const __half2*>(&u));
    }
};

// (x, y) = hi + lo, both pairs of the row type
template <int R>
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
    hi = Half2<R>::pack(x, y);
    const float2 h = Half2<R>::unpack(hi);
    lo = Half2<R>::pack(x - h.x, y - h.y);
}

// c += a·b: A 16×16 (row), B 16×8 (col), f32 accumulators
template <int R>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    if constexpr (R == BF16) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
            "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    } else {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
            "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// byte offset of 16-byte piece c of row `row` in a swizzled [rows][D] tile
template <int D>
__device__ __forceinline__ uint32_t swz(int row, int c) {
    return (uint32_t)(row * D + ((c ^ (row & 7)) << 3)) * 2u;
}

template <int D>
constexpr int CHUNK_ROWS = D == 128 ? 64 : 32;  // K/V rows a chunk holds

template <int D>
constexpr size_t TC_SMEM = (size_t)2 * (2 * BM * D + 2 * 2 * CHUNK_ROWS<D> * D);  // bytes

template <int R, int D>
__global__ void __launch_bounds__(TC_THREADS) prefill_tc_kernel(const PrefillArgs a) {
    constexpr int BN = CHUNK_ROWS<D>;
    constexpr int CPR = D / 8;           // 16-byte pieces a row
    constexpr int NS = BN / 8;           // score fragments a warp row-block
    constexpr int NO = D / 8;            // output fragments
    extern __shared__ uint4 smem_tc[];
    unsigned char* sbytes = reinterpret_cast<unsigned char*>(smem_tc);
    const uint32_t s_qhi = (uint32_t)__cvta_generic_to_shared(sbytes);
    const uint32_t s_qlo = s_qhi + BM * D * 2;
    const uint32_t s_k = s_qlo + BM * D * 2;          // [2][BN][D]
    const uint32_t s_v = s_k + 2 * BN * D * 2;        // [2][BN][D]

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int b = blockIdx.z;
    const int hk = blockIdx.y / a.head_blocks;
    const int r0 = (blockIdx.y % a.head_blocks) * a.rh;
    const int t0 = (gridDim.x - 1 - blockIdx.x) * a.tq;  // the longest tiles first
    const int rep = a.H / a.Hkv;
    const int np = a.n_past[b];
    const int nrow = a.tq * a.rh;  // rows of the block in use

    // the block's visible rows [lo, hi)
    const int t_last = min(t0 + a.tq, a.T) - 1;
    const int lo = first_row(a, np + t0);
    const int hi = min(np + t_last + 1, a.S);

    // q·scale, split into hi and lo terms (rows out of range are zero)
    for (int i = tid; i < BM * (D / 4); i += TC_THREADS) {
        const int qr = i / (D / 4), c4 = i % (D / 4);
        const int qt = t0 + qr / a.rh, qh = r0 + qr % a.rh;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (qr < nrow && qt < a.T && qh < rep) {
            x = *reinterpret_cast<const float4*>(
                a.q + (((size_t)b * a.T + qt) * a.H + hk * rep + qh) * D + 4 * c4);
            x.x *= a.scale;
            x.y *= a.scale;
            x.z *= a.scale;
            x.w *= a.scale;
        }
        uint2 h, l;
        split2<R>(x.x, x.y, h.x, l.x);
        split2<R>(x.z, x.w, h.y, l.y);
        const uint32_t off = swz<D>(qr, c4 >> 1) + (c4 & 1) * 8;
        *reinterpret_cast<uint2*>(sbytes + off) = h;
        *reinterpret_cast<uint2*>(sbytes + BM * D * 2 + off) = l;
    }

    // this warp's rows: rows wr0 .. wr0 + 15 of the block; this thread's
    // fragment rows are g and g + 8 of them
    const int wr0 = 16 * warp;
    const int g = lane >> 2, q4 = lane & 3;
    const bool w_any = wr0 < nrow && t0 + wr0 / a.rh < a.T;
    const int w_plo = np + t0 + wr0 / a.rh;                                  // its first position
    const int w_phi = np + min(t0 + (min(wr0 + 15, nrow - 1)) / a.rh, a.T - 1);  // its last
    const int w_first_lo = first_row(a, w_plo), w_first_hi = first_row(a, w_phi);
    int p_r[2], lo_r[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
        p_r[h2] = np + t0 + (wr0 + g + 8 * h2) / a.rh;
        lo_r[h2] = first_row(a, p_r[h2]);
    }

    const size_t kv_base = ((size_t)b * a.Hkv + hk) * (size_t)a.S * D;
    const uint16_t* kg = static_cast<const uint16_t*>(a.k) + kv_base;
    const uint16_t* vg = static_cast<const uint16_t*>(a.v) + kv_base;
    auto load_chunk = [&](int c0, int stage) {
        const uint32_t sk = s_k + stage * BN * D * 2, sv = s_v + stage * BN * D * 2;
        for (int i = tid; i < BN * CPR; i += TC_THREADS) {
            const int cr = i / CPR, c = i % CPR;
            const int j = c0 + cr;
            const bool ok = j >= lo && j < hi;
            const size_t off = (size_t)(ok ? j : 0) * D + 8 * c;
            cp_async16(sk + swz<D>(cr, c), kg + off, ok);
            cp_async16(sv + swz<D>(cr, c), vg + off, ok);
        }
    };

    float o[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's columns

    const int c_begin = (lo / BN) * BN;
    const int n_chunks = (hi - c_begin + BN - 1) / BN;
    load_chunk(c_begin, 0);
    cp_async_commit();
    for (int ci = 0; ci < n_chunks; ++ci) {
        const int c0 = c_begin + ci * BN;
        if (ci + 1 < n_chunks) load_chunk(c0 + BN, (ci + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();  // chunk ci is in
        __syncthreads();
        const uint32_t sk = s_k + (ci & 1) * BN * D * 2, sv = s_v + (ci & 1) * BN * D * 2;
        if (w_any && c0 <= w_phi && c0 + BN - 1 >= w_first_lo) {
            const bool whole = c0 + BN - 1 <= w_plo && c0 >= w_first_hi;

            // s = q_hi·kᵀ + q_lo·kᵀ
            float s[NS][4];
#pragma unroll
            for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                uint32_t qh[4], ql[4];
                const uint32_t qoff = swz<D>(wr0 + (lane & 15), 2 * kk + (lane >> 4));
                ldsm_x4(qh, s_qhi + qoff);
                ldsm_x4(ql, s_qlo + qoff);
#pragma unroll
                for (int n = 0; n < NS; n += 2) {
                    uint32_t kb[4];
                    ldsm_x4(kb, sk + swz<D>(8 * n + (lane & 7) + ((lane >> 4) << 3),
                                            2 * kk + ((lane >> 3) & 1)));
                    mma16816<R>(s[n], qh, kb[0], kb[1]);
                    mma16816<R>(s[n], ql, kb[0], kb[1]);
                    mma16816<R>(s[n + 1], qh, kb[2], kb[3]);
                    mma16816<R>(s[n + 1], ql, kb[2], kb[3]);
                }
            }

            // softcap, the mask of a chunk that straddles a bound, row max
            float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
            for (int n = 0; n < NS; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float x = s[n][e];
                    if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
                    if (!whole) {
                        const int j = c0 + 8 * n + 2 * q4 + (e & 1);
                        if (j > p_r[e >> 1] || j < lo_r[e >> 1]) x = -INFINITY;
                    }
                    s[n][e] = x;
                    mx[e >> 1] = fmaxf(mx[e >> 1], x);
                }
            }
            float alpha[2];
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
                mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 1));
                mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 2));
                const float m_new = fmaxf(m[h2], mx[h2]);
                // m_new = -inf: nothing of this row is visible yet (p = 0, alpha 1)
                const float mb = m_new == -INFINITY ? 0.f : m_new * LOG2E;
                alpha[h2] = m_new == -INFINITY ? 1.f : exp2f(fmaf(m[h2], LOG2E, -mb));
                m[h2] = m_new;
                float rs = 0.f;
#pragma unroll
                for (int n = 0; n < NS; ++n) {
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float p = exp2f(fmaf(s[n][2 * h2 + e], LOG2E, -mb));  // -inf → 0
                        s[n][2 * h2 + e] = p;
                        rs += p;
                    }
                }
                l[h2] = l[h2] * alpha[h2] + rs;
            }
#pragma unroll
            for (int n = 0; n < NO; ++n) {
                o[n][0] *= alpha[0];
                o[n][1] *= alpha[0];
                o[n][2] *= alpha[1];
                o[n][3] *= alpha[1];
            }

            // o += P_hi·V + P_lo·V; the score fragments of keys 16kk .. 16kk + 15
            // are the A operand
#pragma unroll
            for (int kk = 0; kk < BN / 16; ++kk) {
                uint32_t ph[4], pl[4];
                split2<R>(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
                split2<R>(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
                split2<R>(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
                split2<R>(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
                for (int n = 0; n < NO; n += 2) {
                    uint32_t vb[4];
                    ldsm_x4_trans(vb, sv + swz<D>(16 * kk + (lane & 15), n + (lane >> 4)));
                    mma16816<R>(o[n], ph, vb[0], vb[1]);
                    mma16816<R>(o[n], pl, vb[0], vb[1]);
                    mma16816<R>(o[n + 1], ph, vb[2], vb[3]);
                    mma16816<R>(o[n + 1], pl, vb[2], vb[3]);
                }
            }
        }
        __syncthreads();  // every warp is done with this stage before it is refilled
    }

#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
        float lt = l[h2];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        const int row = wr0 + g + 8 * h2;
        const int t = t0 + row / a.rh, r = r0 + row % a.rh;
        if (row < nrow && t < a.T && r < rep) {
            const float inv = 1.f / fmaxf(lt, 1e-30f);
            float* out = a.out + (((size_t)b * a.T + t) * a.H + hk * rep + r) * D + 2 * q4;
#pragma unroll
            for (int n = 0; n < NO; ++n) {
                *reinterpret_cast<float2*>(out + 8 * n) =
                    make_float2(o[n][2 * h2] * inv, o[n][2 * h2 + 1] * inv);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// f32 rows: CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int ROWS = 32;               // (query, head) rows a block takes
constexpr int CH = 32;                 // K/V rows a chunk holds
constexpr int THREADS = 256;
constexpr int TPR = THREADS / ROWS;    // threads a row: 8
constexpr int NC = CH / TPR;           // score columns a thread: 4
constexpr int PAD = 4;                 // floats of padding a shared row

// 4 consecutive elements of a cached row → f32 (exact)
template <int R>
__device__ __forceinline__ float4 load4(const void* base, size_t off) {
    static_assert(R == F32, "the CUDA-core kernel takes f32 rows");
    return *reinterpret_cast<const float4*>(static_cast<const float*>(base) + off);
}

template <int R, int D>
__global__ void __launch_bounds__(THREADS) prefill_kernel(const PrefillArgs a) {
    constexpr int LD = D + PAD;      // shared row stride of q, K and V
    constexpr int NJ = D / (4 * TPR);  // float4 output groups a thread owns
    extern __shared__ float4 smem4[];
    float* qs = reinterpret_cast<float*>(smem4);  // [ROWS][LD]
    float* ks = qs + ROWS * LD;                   // [CH][LD]
    float* vs = ks + CH * LD;                     // [CH][LD]
    float* ps = vs + CH * LD;                     // [ROWS][CH + 1]

    const int tid = threadIdx.x;
    const int row = tid / TPR, sub = tid % TPR;
    const int b = blockIdx.z;
    const int hk = blockIdx.y / a.head_blocks;
    const int r0 = (blockIdx.y % a.head_blocks) * a.rh;
    const int t0 = blockIdx.x * a.tq;
    const int rep = a.H / a.Hkv;
    const int np = a.n_past[b];

    // this thread's query row
    const int t = t0 + row / a.rh, r = r0 + row % a.rh;
    const bool row_ok = row < a.tq * a.rh && t < a.T && r < rep;
    const int p = np + t;
    const int lo_p = row_ok ? first_row(a, p) : 0;

    // the tile's visible rows [lo, hi)
    const int t_last = min(t0 + a.tq, a.T) - 1;
    const int lo = first_row(a, np + t0);
    const int hi = min(np + t_last + 1, a.S);

    // the q tile, scaled (rows out of range are zero)
    for (int i = tid; i < ROWS * (D / 4); i += THREADS) {
        const int qr = i / (D / 4), c4 = i % (D / 4);
        const int qt = t0 + qr / a.rh, qh = r0 + qr % a.rh;
        float4 v4 = make_float4(0.f, 0.f, 0.f, 0.f);
        if (qr < a.tq * a.rh && qt < a.T && qh < rep) {
            v4 = *reinterpret_cast<const float4*>(
                a.q + (((size_t)b * a.T + qt) * a.H + hk * rep + qh) * D + 4 * c4);
            v4.x *= a.scale;
            v4.y *= a.scale;
            v4.z *= a.scale;
            v4.w *= a.scale;
        }
        *reinterpret_cast<float4*>(qs + qr * LD + 4 * c4) = v4;
    }

    const size_t kv_base = ((size_t)b * a.Hkv + hk) * (size_t)a.S * D;
    float m = -INFINITY, l = 0.f;
    float4 acc[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);

    for (int c0 = (lo / CH) * CH; c0 < hi; c0 += CH) {
        __syncthreads();  // the previous chunk's readers are done (and q is in)
        for (int i = tid; i < CH * (D / 4); i += THREADS) {
            const int cr = i / (D / 4), c4 = i % (D / 4);
            const int j = c0 + cr;
            float4 kf = make_float4(0.f, 0.f, 0.f, 0.f), vf = kf;
            if (j >= lo && j < hi) {
                kf = load4<R>(a.k, kv_base + (size_t)j * D + 4 * c4);
                vf = load4<R>(a.v, kv_base + (size_t)j * D + 4 * c4);
            }
            *reinterpret_cast<float4*>(ks + cr * LD + 4 * c4) = kf;
            *reinterpret_cast<float4*>(vs + cr * LD + 4 * c4) = vf;
        }
        __syncthreads();

        // scores of columns sub, sub + TPR, ... of this chunk
        float s[NC];
#pragma unroll
        for (int n = 0; n < NC; ++n) s[n] = 0.f;
        const float* qrow = qs + row * LD;
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
            for (int n = 0; n < NC; ++n) {
                const float4 kv = *reinterpret_cast<const float4*>(ks + (sub + TPR * n) * LD + d);
                s[n] = fmaf(qv.x, kv.x, s[n]);
                s[n] = fmaf(qv.y, kv.y, s[n]);
                s[n] = fmaf(qv.z, kv.z, s[n]);
                s[n] = fmaf(qv.w, kv.w, s[n]);
            }
        }
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NC; ++n) {
            const int j = c0 + sub + TPR * n;
            if (a.softcap > 0.f) s[n] = tanhf(s[n] / a.softcap) * a.softcap;
            if (!(row_ok && j <= p && j >= lo_p && j < a.S)) s[n] = -INFINITY;
            mx = fmaxf(mx, s[n]);
        }
#pragma unroll
        for (int o = TPR / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m, mx);
        float alpha = 1.f, rs = 0.f;
        if (m_new != -INFINITY) {  // else nothing of this row is visible yet
            alpha = expf(m - m_new);  // m = -inf → 0
#pragma unroll
            for (int n = 0; n < NC; ++n) {
                s[n] = expf(s[n] - m_new);  // a masked column → 0
                rs += s[n];
            }
        } else {
#pragma unroll
            for (int n = 0; n < NC; ++n) s[n] = 0.f;
        }
#pragma unroll
        for (int o = TPR / 2; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
        l = l * alpha + rs;
        m = m_new;
#pragma unroll
        for (int n = 0; n < NC; ++n) ps[row * (CH + 1) + sub + TPR * n] = s[n];
        __syncthreads();

        // acc = acc·alpha + p·V over the chunk; this thread's dims are
        // 4·sub + 4·TPR·j .. +3
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            acc[j].x *= alpha;
            acc[j].y *= alpha;
            acc[j].z *= alpha;
            acc[j].w *= alpha;
        }
        const float* prow = ps + row * (CH + 1);
#pragma unroll 4
        for (int c = 0; c < CH; ++c) {
            const float pc = prow[c];
            const float* vrow = vs + c * LD + 4 * sub;
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const float4 vv = *reinterpret_cast<const float4*>(vrow + 4 * TPR * j);
                acc[j].x = fmaf(pc, vv.x, acc[j].x);
                acc[j].y = fmaf(pc, vv.y, acc[j].y);
                acc[j].z = fmaf(pc, vv.z, acc[j].z);
                acc[j].w = fmaf(pc, vv.w, acc[j].w);
            }
        }
    }

    if (row_ok) {
        const float inv = 1.f / fmaxf(l, 1e-30f);
        float* o = a.out + (((size_t)b * a.T + t) * a.H + hk * rep + r) * D + 4 * sub;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            *reinterpret_cast<float4*>(o + 4 * TPR * j) =
                make_float4(acc[j].x * inv, acc[j].y * inv, acc[j].z * inv, acc[j].w * inv);
        }
    }
}


template <int D>
int launch_f32(PrefillArgs a, int B, cudaStream_t st) {
    constexpr int LD = D + PAD;
    constexpr size_t smem = sizeof(float) * ((ROWS + 2 * CH) * LD + ROWS * (CH + 1));
    static bool attr_set = false;  // above 48 KB only once opted in
    if (!attr_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            prefill_kernel<F32, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        attr_set = true;
    }
    set_rows(a, ROWS);
    const dim3 grid((a.T + a.tq - 1) / a.tq, a.Hkv * a.head_blocks, B);
    prefill_kernel<F32, D><<<grid, THREADS, smem, st>>>(a);
    return (int)cudaGetLastError();
}

template <int R, int D>
int launch_tc(PrefillArgs a, int B, cudaStream_t st) {
    constexpr size_t smem = TC_SMEM<D>;
    static_assert(smem <= 232448, "shared memory of one block");
    static bool attr_set = false;
    if (!attr_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            prefill_tc_kernel<R, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        attr_set = true;
    }
    set_rows(a, BM);
    const dim3 grid((a.T + a.tq - 1) / a.tq, a.Hkv * a.head_blocks, B);
    prefill_tc_kernel<R, D><<<grid, TC_THREADS, smem, st>>>(a);
    return (int)cudaGetLastError();
}

template <int D>
int launch_row_type(const PrefillArgs& a, int dtype, int B, cudaStream_t st) {
    switch (dtype) {
        case BF16: return launch_tc<BF16, D>(a, B, st);
        case F16: return launch_tc<F16, D>(a, B, st);
        case F32: return launch_f32<D>(a, B, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// q f32 [B,T,H,D]; k, v [B,Hkv,S,D] of element type dtype (0 bf16, 1 f16,
// 2 f32: the tensor-core kernel for the first two, the CUDA-core kernel for
// f32); n_past int32 [B]; out f32 [B,T,H,D]. D is 128 or 256, H a multiple
// of Hkv; n_past[b] + T <= S.
KERNELS_API int flash_prefill(const void* q, const void* k, const void* v, const void* n_past,
                              void* out, int B, int T, int H, int Hkv, int D, int S, int dtype,
                              int window, int attn_chunk, float scale, float softcap,
                              void* stream) {
    if (Hkv <= 0 || H % Hkv) return (int)cudaErrorInvalidValue;
    PrefillArgs a;
    a.q = static_cast<const float*>(q);
    a.k = k;
    a.v = v;
    a.n_past = static_cast<const int*>(n_past);
    a.out = static_cast<float*>(out);
    a.T = T;
    a.H = H;
    a.Hkv = Hkv;
    a.S = S;
    a.window = window;
    a.attn_chunk = attn_chunk;
    a.scale = scale;
    a.softcap = softcap;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 128: return launch_row_type<128>(a, dtype, B, st);
        case 256: return launch_row_type<256>(a, dtype, B, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
