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
// (entry flash_prefill).
//
// Bound on this card: the f32 operations, 4·H·D per visible (query, row)
// pair, against 67 TFLOP/s; the rows are read from device memory once per
// block of queries, a few bytes per operation. Design: the TPU kernel is a
// sequential loop over K/V chunks inside a (slot, kv head, query tile)
// program whose GQA group is one [TQ·rep, D] operand of the matrix unit;
// here a block takes ROWS = 32 (query, head) pairs of one kv head — TQ
// queries by RH heads of the group, RH = min(rep, 32) (a larger group is
// split over blocks) — so its K/V chunk serves every head of the group, and
// a grid over (query tile, kv head × head split, slot) runs the tiles in
// parallel. The block walks CH-row chunks from the chunk holding the tile's
// first visible row to the one holding its last query's position, as the
// TPU kernel skips the chunks before the window and after the causal limit.
// A chunk of K and V goes to shared memory in f32 (each element converted
// once as it is loaded; rows outside the tile's visible span are zero-filled,
// never read); the q tile sits there too, scaled. Eight threads own a
// query row: they take 4 of the chunk's 32 scores each (q·k on the CUDA
// cores in f32), keep the row's online softmax (m, l) in registers, reduced
// over the eight with shuffles, write the probabilities to shared memory,
// and each accumulate D/8 output dims of p·V. Row strides are padded by 4
// floats so the 16-byte shared loads are free of bank conflicts. No tensor
// cores, no cp.async pipelining: a right first kernel (ROADMAP queue P).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int ROWS = 32;               // (query, head) rows a block takes
constexpr int CH = 32;                 // K/V rows a chunk holds
constexpr int THREADS = 256;
constexpr int TPR = THREADS / ROWS;    // threads a row: 8
constexpr int NC = CH / TPR;           // score columns a thread: 4
constexpr int PAD = 4;                 // floats of padding a shared row

enum RowType : int { BF16 = 0, F16 = 1, F32 = 2 };

struct PrefillArgs {
    const float* q;      // [B,T,H,D]
    const void* k;       // [B,Hkv,S,D]
    const void* v;
    const int* n_past;   // [B]
    float* out;          // [B,T,H,D]
    int T, H, Hkv, S;
    int rh;              // heads of the group a block takes
    int tq;              // queries a block takes (ROWS / rh)
    int head_blocks;     // blocks a kv head's group is split over
    int window, attn_chunk;
    float scale, softcap;
};

// 4 consecutive elements of a cached row → f32 (exact)
template <int R>
__device__ __forceinline__ float4 load4(const void* base, size_t off) {
    if constexpr (R == F32) {
        return *reinterpret_cast<const float4*>(static_cast<const float*>(base) + off);
    } else if constexpr (R == F16) {
        const uint2 u = *reinterpret_cast<const uint2*>(static_cast<const __half*>(base) + off);
        return make_float4(__half2float(__ushort_as_half((unsigned short)(u.x & 0xffffu))),
                           __half2float(__ushort_as_half((unsigned short)(u.x >> 16))),
                           __half2float(__ushort_as_half((unsigned short)(u.y & 0xffffu))),
                           __half2float(__ushort_as_half((unsigned short)(u.y >> 16))));
    } else {
        const uint2 u = *reinterpret_cast<const uint2*>(
            static_cast<const __nv_bfloat16*>(base) + off);
        return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
    }
}

// the first row position p may attend
__device__ __forceinline__ int first_row(const PrefillArgs& a, int p) {
    if (a.window > 0) return max(p - a.window + 1, 0);
    if (a.attn_chunk > 0) return (p / a.attn_chunk) * a.attn_chunk;
    return 0;
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

template <int R, int D>
int launch(const PrefillArgs& a, int B, cudaStream_t st) {
    constexpr int LD = D + PAD;
    constexpr size_t smem = sizeof(float) * ((ROWS + 2 * CH) * LD + ROWS * (CH + 1));
    static bool attr_set = false;  // above 48 KB only once opted in
    if (!attr_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            prefill_kernel<R, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        attr_set = true;
    }
    const dim3 grid((a.T + a.tq - 1) / a.tq, a.Hkv * a.head_blocks, B);
    prefill_kernel<R, D><<<grid, THREADS, smem, st>>>(a);
    return (int)cudaGetLastError();
}

template <int R>
int launch_d(const PrefillArgs& a, int D, int B, cudaStream_t st) {
    switch (D) {
        case 128: return launch<R, 128>(a, B, st);
        case 256: return launch<R, 256>(a, B, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// q f32 [B,T,H,D]; k, v [B,Hkv,S,D] of element type dtype (0 bf16, 1 f16,
// 2 f32); n_past int32 [B]; out f32 [B,T,H,D]. D is 128 or 256, H a
// multiple of Hkv; n_past[b] + T <= S.
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
    const int rep = H / Hkv;
    a.rh = min(rep, ROWS);
    a.tq = ROWS / a.rh;
    a.head_blocks = (rep + a.rh - 1) / a.rh;
    a.window = window;
    a.attn_chunk = attn_chunk;
    a.scale = scale;
    a.softcap = softcap;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case BF16: return launch_d<BF16>(a, D, B, st);
        case F16: return launch_d<F16>(a, D, B, st);
        case F32: return launch_d<F32>(a, D, B, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
