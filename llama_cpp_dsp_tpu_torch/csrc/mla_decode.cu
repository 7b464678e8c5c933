// mla_decode.cu — multi-head latent attention decode (DeepSeek-V2 MLA, T=1):
// out[b,h,:] = softmax_j(scale · q[b,h,:]·c[b,j,:]) · c[b,j,:r] over the valid
// rows j < length_b of one slot's latent stream. q f32 [B,H,C] is
// q_lat ⊕ q_rope ⊕ 0-pad (W_uk already absorbed into q_lat), c bf16
// [B,1,S,C] is the cache's one latent "head" [latent; roped k; 0-pad], and
// the output f32 [B,H,r] is the attention-weighted latent (W_uv is applied
// after, outside the kernel).
//
// Replaces: llama_cpp_dsp_tpu/ops/pallas/attention.py::_mla_decode_kernel
// (entry mla_flash_decode). It computes what that kernel computes: scores of
// all H heads from one read of each cached row, an f32 online softmax, the
// weighted sum over the first r lanes, q taken in f32 and scaled before the
// dot (the TPU kernel's Precision.HIGHEST f32 products).
//
// Bound on this card: the valid rows' bytes (C bf16 each) over the memory
// rate; 4·H·C operations per row (scores and weighted sum) stay below the
// card's f32 rate for H = 16. Design: the TPU grid is one program per batch
// row; here a grid over (split, slot) runs n_splits blocks per slot in
// parallel, and each slot spreads its own valid rows over them (at least
// `min_rows` a block), so a short context still reaches several SMs and a
// long one all of them; a second small kernel merges the splits by
// log-sum-exp (as flash_decode.cu). A block stages a chunk of up to 64 rows
// (bf16) in shared memory, each thread keeping 8 16-byte loads in flight.
// Scores: warp w owns heads w and w + 8, their scaled q held in registers,
// lane l the row words l, l + 32, ...: a row's two dots are lane partials
// and a butterfly sum, so shared memory serves each row word once per warp
// and q never (shared-memory bandwidth, not the f32 operations, would bound
// a loop that reads q there per row); the same warp keeps its heads' online
// softmax.
// Weighted sum: thread t owns latent columns 2t and 2t + 1 for every head
// (H ≤ 16 and r ≤ 512), the probabilities of a row read as four 16-byte
// broadcasts. Rows at or past the length are never read, and an empty split
// writes only its (m = -inf, l = 0). A simple first version on CUDA cores;
// the tensor-core design (H = 16 is one m16 tile) is queued in ROADMAP.md
// queue P.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;            // threads per block
constexpr int NW = NT / 32;        // warps
constexpr int MAX_CHUNK = 64;      // rows staged in shared memory at a time
constexpr int MAX_H = 2 * NW;      // heads: warp w scores heads w and w + NW
constexpr int MAX_QW = 12;         // row words per lane in a dot: C ≤ 2·32·MAX_QW = 768
constexpr int PS = 20;             // floats per row of probabilities (16 heads, 16-byte rows)
constexpr int LD_BATCH = 8;        // 16-byte loads a thread keeps in flight while staging

__global__ void __launch_bounds__(NT)
mla_split(const float* __restrict__ q, const __nv_bfloat16* __restrict__ c,
          const int* __restrict__ lengths, float* __restrict__ ws_acc,
          float* __restrict__ ws_ml, int H, int C, int r, int S, int min_rows, int chunk,
          int n_splits, float scale) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int cw = C / 2;                                        // 32-bit words per row
    uint32_t* rows = reinterpret_cast<uint32_t*>(smem);          // [chunk][cw]
    float* ps = reinterpret_cast<float*>(rows + chunk * cw);     // [chunk][PS] probabilities
    float* ah = ps + chunk * PS;                                 // [MAX_H] this chunk's rescale

    const int sp = blockIdx.x, b = blockIdx.y;
    const int t = threadIdx.x, w = t >> 5, lane = t & 31;
    const int len = min(lengths[b], S);
    // this slot's valid rows spread over the n_splits blocks, min_rows at least
    const int per = max(min_rows, (len + n_splits - 1) / n_splits);
    const int lo = sp * per, hi = min(lo + per, len);

    float acc[MAX_H][2];  // columns 2t, 2t + 1 of each head's weighted latent
#pragma unroll
    for (int h = 0; h < MAX_H; ++h) acc[h][0] = acc[h][1] = 0.f;
    // the running max and sum of warp w's heads w, w + NW (every lane holds them)
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

    if (lo < hi) {
        // the warp's two q rows, scaled, in registers: lane l holds words l + 32i
        float2 qr[2][MAX_QW];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            const int h = w + NW * k;
            const float2* qh = reinterpret_cast<const float2*>(q + ((size_t)b * H + h) * C);
#pragma unroll
            for (int i = 0; i < MAX_QW; ++i) {
                const int word = lane + 32 * i;
                const float2 v = (h < H && word < cw) ? __ldg(qh + word) : make_float2(0.f, 0.f);
                qr[k][i] = make_float2(v.x * scale, v.y * scale);
            }
        }
        const uint4* cb = reinterpret_cast<const uint4*>(c + (size_t)b * S * C);
        const int vecs = C / 8;  // 16-byte vectors per row
        for (int j0 = lo; j0 < hi; j0 += chunk) {
            const int nr = min(chunk, hi - j0);
            __syncthreads();  // the previous chunk's rows and probabilities used
            // the chunk's rows are contiguous: nr·vecs vectors from row j0
            const uint4* src = cb + (size_t)j0 * vecs;
            uint4* dst = reinterpret_cast<uint4*>(rows);
            for (int i0 = t; i0 < nr * vecs; i0 += NT * LD_BATCH) {
                uint4 v[LD_BATCH];
#pragma unroll
                for (int u = 0; u < LD_BATCH; ++u)
                    if (i0 + u * NT < nr * vecs) v[u] = __ldg(src + i0 + u * NT);
#pragma unroll
                for (int u = 0; u < LD_BATCH; ++u)
                    if (i0 + u * NT < nr * vecs) dst[i0 + u * NT] = v[u];
            }
            __syncthreads();
            // scores of the warp's heads: lane partials, a butterfly sum; lane
            // j % 32 keeps row j's (s?0 for rows < 32, s?1 for rows 32..63)
            float s00 = -INFINITY, s01 = -INFINITY, s10 = -INFINITY, s11 = -INFINITY;
            if (w < H) {  // warp-uniform
#pragma unroll 2
                for (int j = 0; j < nr; ++j) {
                    const uint32_t* rj = rows + j * cw;
                    float a0 = 0.f, a1 = 0.f;
#pragma unroll
                    for (int i = 0; i < MAX_QW; ++i) {
                        const int word = lane + 32 * i;
                        if (word < cw) {
                            const uint32_t x = rj[word];
                            const float xl = bf16_lo(x), xh = bf16_hi(x);
                            a0 = fmaf(qr[0][i].x, xl, fmaf(qr[0][i].y, xh, a0));
                            a1 = fmaf(qr[1][i].x, xl, fmaf(qr[1][i].y, xh, a1));
                        }
                    }
                    a0 = warp_sum(a0);
                    a1 = warp_sum(a1);
                    if (lane == (j & 31)) {
                        if (j < 32) {
                            s00 = a0;
                            s10 = a1;
                        } else {
                            s01 = a0;
                            s11 = a1;
                        }
                    }
                }
            }
            // online softmax of the warp's heads over this chunk
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                const int h = w + NW * k;
                if (h < H) {  // warp-uniform
                    const float v0 = lane < nr ? (k ? s10 : s00) : -INFINITY;
                    const float v1 = lane + 32 < nr ? (k ? s11 : s01) : -INFINITY;
                    const float m_new = fmaxf(m_run[k], warp_max(fmaxf(v0, v1)));
                    const float p0 = lane < nr ? expf(v0 - m_new) : 0.f;
                    const float p1 = lane + 32 < nr ? expf(v1 - m_new) : 0.f;
                    if (lane < nr) ps[lane * PS + h] = p0;
                    if (lane + 32 < nr) ps[(lane + 32) * PS + h] = p1;
                    const float alpha = expf(m_run[k] - m_new);  // m_run = -inf first → 0
                    l_run[k] = l_run[k] * alpha + warp_sum(p0 + p1);
                    m_run[k] = m_new;
                    if (lane == 0) ah[h] = alpha;
                }
            }
            __syncthreads();
            // weighted latent sum: thread t owns columns 2t, 2t + 1 < r
#pragma unroll
            for (int h = 0; h < MAX_H; ++h) {
                if (h < H) {
                    const float alpha = ah[h];
                    acc[h][0] *= alpha;
                    acc[h][1] *= alpha;
                }
            }
            if (2 * t < r) {
                for (int j = 0; j < nr; ++j) {
                    const uint32_t x = rows[j * cw + t];
                    const float x0 = bf16_lo(x), x1 = bf16_hi(x);
                    const float4* pj = reinterpret_cast<const float4*>(ps + j * PS);
#pragma unroll
                    for (int g = 0; g < MAX_H / 4; ++g) {
                        const float4 p = pj[g];
                        acc[4 * g][0] = fmaf(p.x, x0, acc[4 * g][0]);
                        acc[4 * g][1] = fmaf(p.x, x1, acc[4 * g][1]);
                        acc[4 * g + 1][0] = fmaf(p.y, x0, acc[4 * g + 1][0]);
                        acc[4 * g + 1][1] = fmaf(p.y, x1, acc[4 * g + 1][1]);
                        acc[4 * g + 2][0] = fmaf(p.z, x0, acc[4 * g + 2][0]);
                        acc[4 * g + 2][1] = fmaf(p.z, x1, acc[4 * g + 2][1]);
                        acc[4 * g + 3][0] = fmaf(p.w, x0, acc[4 * g + 3][0]);
                        acc[4 * g + 3][1] = fmaf(p.w, x1, acc[4 * g + 3][1]);
                    }
                }
            }
        }
    }
    // this split's (acc, m, l) per head; an empty split writes only m = -inf
    // (the merge skips it), and heads ≥ H (probabilities never written) nothing
    if (lo < hi && 2 * t < r) {
#pragma unroll
        for (int h = 0; h < MAX_H; ++h) {
            if (h < H) {
                const size_t slot = ((size_t)b * H + h) * n_splits + sp;
                *reinterpret_cast<float2*>(ws_acc + slot * r + 2 * t) =
                    make_float2(acc[h][0], acc[h][1]);
            }
        }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        const int h = w + NW * k;
        if (h < H && lane == 0) {
            const size_t slot = ((size_t)b * H + h) * n_splits + sp;
            ws_ml[slot * 2] = lo < hi ? m_run[k] : -INFINITY;
            ws_ml[slot * 2 + 1] = lo < hi ? l_run[k] : 0.f;
        }
    }
}

// out[b,h,v] = Σ_s acc_s[v]·e^{m_s−M} / Σ_s l_s·e^{m_s−M}; grid (H, B). The
// splits' (m, l) are staged in shared memory once and their weights made
// once; the column loop then reads only the non-empty splits' partials.
__global__ void __launch_bounds__(NT)
mla_merge(const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
          float* __restrict__ out, int r, int n_splits) {
    extern __shared__ float sm[];
    float* ms = sm;                 // [n_splits] m
    float* ls = ms + n_splits;      // [n_splits] l
    float* wt = ls + n_splits;      // [n_splits] e^{m_s − M}, 0 for an empty split
    const size_t bh = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    const float* ml = ws_ml + bh * n_splits * 2;
    for (int s = threadIdx.x; s < n_splits; s += blockDim.x) {
        ms[s] = ml[2 * s];
        ls[s] = ml[2 * s + 1];
    }
    __syncthreads();
    float mm = -INFINITY;
    for (int s = 0; s < n_splits; ++s) mm = fmaxf(mm, ms[s]);
    for (int s = threadIdx.x; s < n_splits; s += blockDim.x)
        wt[s] = ms[s] == -INFINITY ? 0.f : expf(ms[s] - mm);
    __syncthreads();
    float ll = 0.f;
    for (int s = 0; s < n_splits; ++s) ll += ls[s] * wt[s];
    const float inv = 1.f / fmaxf(ll, 1e-30f);
    const float* acc = ws_acc + bh * n_splits * r;
    for (int v = threadIdx.x; v < r; v += blockDim.x) {
        float aa = 0.f;
        for (int s = 0; s < n_splits; ++s) {
            const float ws = wt[s];
            if (ws != 0.f) aa = fmaf(ws, acc[(size_t)s * r + v], aa);
        }
        out[bh * r + v] = aa * inv;
    }
}

}  // namespace

// q f32 [B,H,C]; c bf16 [B,1,S,C] (16-byte aligned, C % 8 == 0); lengths
// int32 [B]; out f32 [B,H,r]; ws_acc f32 [B*H*n_splits*r], ws_ml f32
// [B*H*n_splits*2] scratch. Slot b's valid rows go to its n_splits blocks
// in runs of max(min_rows, ceil(length_b / n_splits)). H ≤ 16, C ≤ 768,
// r ≤ min(512, C), r even (checked by the Python wrapper). Returns
// cudaGetLastError().
KERNELS_API int mla_decode(const void* q, const void* c, const void* lengths, void* out,
                           void* ws_acc, void* ws_ml, int B, int H, int C, int r, int S,
                           int n_splits, int min_rows, float scale, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    // the longest run a block can get, and so the rows it stages at a time
    const int most = max(min_rows, (S + n_splits - 1) / n_splits);
    const int chunk = min(MAX_CHUNK, most);
    const size_t smem = sizeof(uint32_t) * (size_t)chunk * (C / 2) +
                        sizeof(float) * ((size_t)chunk * PS + MAX_H);
    cudaError_t e = cudaFuncSetAttribute(mla_split, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    mla_split<<<dim3(n_splits, B), NT, smem, st>>>(
        static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(c),
        static_cast<const int*>(lengths), static_cast<float*>(ws_acc),
        static_cast<float*>(ws_ml), H, C, r, S, min_rows, chunk, n_splits, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    mla_merge<<<dim3(H, B), NT, sizeof(float) * 3 * (size_t)n_splits, st>>>(
        static_cast<const float*>(ws_acc), static_cast<const float*>(ws_ml),
        static_cast<float*>(out), r, n_splits);
    return (int)cudaGetLastError();
}
