// attn_fused.cu — one decode attention step in one kernel: the Q4_0
// fused-QKV GEMV, NORM-mode rope of q and k, the in-place write of the new
// K/V row into a bf16 cache [B,Hkv,S,D] at write_pos[b] (dropped when
// write_pos is outside [0, S)), then attention over rows [start_b, pos_b)
// plus the new row, whose term comes from shared memory. T=1, D=128,
// B <= 8. Output [B,H,D] f32.
//
// Replaces: llama_cpp_dsp_tpu/ops/pallas/attn_fused.py::_attn_kernel
// (entry attn_decode_fused).
//
// Bound on this card: the fused QKV weight bytes plus the K/V bytes of the
// valid rows over the memory rate. The TPU kernel chains phases on one
// sequential 1-D grid (weight tiles, then one program per batch row); blocks
// on a GPU run in no order, so a phase cannot wait for another block.
// Design: one block per kv head, for all B rows. The block computes only its
// own rep+2 groups of 128 QKV rows (its rep query heads, its k and its v) —
// 16 warps, one weight row per warp at a time, as in qmm's GEMV — ropes them
// in shared memory, rounds k and v to bf16 and writes them into the cache,
// then streams its head's cached rows with an online softmax seeded by the
// new row. Nothing crosses blocks, so no grid-wide sync is needed.
// Known cost: only Hkv blocks are in flight (32 on a 7B, 8 with GQA), so
// most SMs idle during the weight stream; that occupancy is the first thing
// to fix (ROADMAP.md).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int D = 128;
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;

// dynamic shared memory: qkv rows f32 [NB][(rep+2)*D]
template <int NB>
__global__ void __launch_bounds__(THREADS)
attn_fused_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ qs,
                const __half* __restrict__ dsc, __nv_bfloat16* __restrict__ k_cache,
                __nv_bfloat16* __restrict__ v_cache, const float* __restrict__ cos_t,
                const float* __restrict__ sin_t, const int* __restrict__ lengths,
                const int* __restrict__ starts, const int* __restrict__ write_pos,
                float* __restrict__ out, int H, int Hkv, int S, int K, float scale,
                float softcap) {
    extern __shared__ __align__(16) float qkv[];
    __shared__ float sm_m[WARPS], sm_l[WARPS];
    __shared__ float sm_acc[WARPS][D];

    const int hk = blockIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int rep = H / Hkv;
    const int R = (rep + 2) * D;  // this block's QKV rows

    // phase 1: the block's QKV rows (q heads hk*rep.., then k, then v)
    for (int lr = warp; lr < R; lr += WARPS) {
        int row;
        if (lr < rep * D) row = hk * rep * D + lr;
        else if (lr < (rep + 1) * D) row = H * D + hk * D + (lr - rep * D);
        else row = (H + Hkv) * D + hk * D + (lr - (rep + 1) * D);
        float o[NB];
        warp_row_dot<Q4_0, NB>(qs, dsc, row, K, x, lane, o);
        if (lane == 0) {
#pragma unroll
            for (int b = 0; b < NB; ++b) qkv[b * R + lr] = o[b];
        }
    }
    __syncthreads();

    // phase 2: rope (pairs 2i, 2i+1) on q and k; q → bf16 → f32 * scale;
    // k, v → bf16, written into the cache row write_pos[b]
    for (int e = threadIdx.x; e < NB * (rep + 2) * (D / 2); e += THREADS) {
        const int b = e / ((rep + 2) * (D / 2));
        const int rem = e % ((rep + 2) * (D / 2));
        const int hd = rem / (D / 2), i = rem % (D / 2);
        float* p = qkv + b * R + hd * D + 2 * i;
        float y0 = p[0], y1 = p[1];
        if (hd <= rep) {  // q heads and k are roped, v is not
            const float c = cos_t[b * (D / 2) + i], s = sin_t[b * (D / 2) + i];
            const float x0 = y0, x1 = y1;
            y0 = x0 * c - x1 * s;
            y1 = x0 * s + x1 * c;
        }
        const __nv_bfloat16 r0 = __float2bfloat16(y0), r1 = __float2bfloat16(y1);
        if (hd < rep) {
            p[0] = __bfloat162float(r0) * scale;
            p[1] = __bfloat162float(r1) * scale;
        } else {
            p[0] = __bfloat162float(r0);
            p[1] = __bfloat162float(r1);
            const int wp = write_pos[b];
            if (wp >= 0 && wp < S) {
                __nv_bfloat16* c = (hd == rep ? k_cache : v_cache) +
                                   (((size_t)b * Hkv + hk) * S + wp) * D + 2 * i;
                c[0] = r0;
                c[1] = r1;
            }
        }
    }
    __syncthreads();

    // phase 3: per slot and query head, online softmax over rows
    // [start, pos) of the cache, seeded (in warp 0) with the new row
    for (int b = 0; b < NB; ++b) {
        const int pos = lengths[b] - 1;
        const int hi = min(pos, S);
        const int lo = starts ? max(starts[b], 0) : 0;
        const float* kn = qkv + b * R + rep * D;
        const float* vn = kn + D;
        const size_t kv_base = ((size_t)b * Hkv + hk) * (size_t)S * D;
        for (int r = 0; r < rep; ++r) {
            const float* qh = qkv + b * R + r * D;
            float qv[4], m = -INFINITY, l = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = qh[lane * 4 + i];
            if (warp == 0) {
                float kf[4], vf[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    kf[i] = kn[lane * 4 + i];
                    vf[i] = vn[lane * 4 + i];
                }
                float s = warp_sum(qv[0] * kf[0] + qv[1] * kf[1] + qv[2] * kf[2] + qv[3] * kf[3]);
                if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
                softmax_step(s, vf, m, l, acc);
            }
            for (int row = lo + warp; row < hi; row += WARPS) {
                float kf[4], vf[4];
                load_bf16x4(k_cache + kv_base + (size_t)row * D + lane * 4, kf);
                load_bf16x4(v_cache + kv_base + (size_t)row * D + lane * 4, vf);
                float s = warp_sum(qv[0] * kf[0] + qv[1] * kf[1] + qv[2] * kf[2] + qv[3] * kf[3]);
                if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
                softmax_step(s, vf, m, l, acc);
            }
            if (lane == 0) {
                sm_m[warp] = m;
                sm_l[warp] = l;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) sm_acc[warp][lane * 4 + i] = acc[i];
            __syncthreads();
            if (threadIdx.x < D) {
                const int t = threadIdx.x;
                float mm = -INFINITY;
#pragma unroll
                for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, sm_m[w]);
                float ll = 0.f, aa = 0.f;
#pragma unroll
                for (int w = 0; w < WARPS; ++w) {
                    if (sm_m[w] == -INFINITY) continue;
                    const float e = expf(sm_m[w] - mm);
                    ll += sm_l[w] * e;
                    aa += sm_acc[w][t] * e;
                }
                out[((size_t)b * H + hk * rep + r) * D + t] = aa / fmaxf(ll, 1e-30f);
            }
            __syncthreads();
        }
    }
}

template <int NB>
int launch(const void* x, const void* qs, const void* d, void* kc, void* vc, const void* cs,
           const void* sn, const void* len, const void* st, const void* wp, void* out, int H,
           int Hkv, int S, int K, float scale, float softcap, cudaStream_t stream) {
    const int rep = H / Hkv;
    const size_t smem = (size_t)NB * (rep + 2) * D * sizeof(float);
    static bool attr_set = false;  // one opt-in per instantiation
    if (!attr_set) {
        cudaError_t e = cudaFuncSetAttribute(attn_fused_kernel<NB>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             160 * 1024);
        if (e != cudaSuccess) return (int)e;
        attr_set = true;
    }
    attn_fused_kernel<NB><<<Hkv, THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(qs),
        static_cast<const __half*>(d), static_cast<__nv_bfloat16*>(kc),
        static_cast<__nv_bfloat16*>(vc), static_cast<const float*>(cs),
        static_cast<const float*>(sn), static_cast<const int*>(len), static_cast<const int*>(st),
        static_cast<const int*>(wp), static_cast<float*>(out), H, Hkv, S, K, scale, softcap);
    return (int)cudaGetLastError();
}

}  // namespace

// x bf16 [B,K]; qs u8 [(H+2Hkv)*128, K/2], d f16 [(H+2Hkv)*128, K/32] (the
// row-fused q|k|v Q4_0 weight); k_cache, v_cache bf16 [B,Hkv,S,128] (written
// in place); cos, sin f32 [B,64]; lengths (rows INCLUDING the new one),
// starts (may be null), write_pos int32 [B]; out f32 [B,H,128].
// 1 <= B <= 8, H % Hkv == 0, (H/Hkv + 2) * 128 * 4 * B bytes of shared
// memory (<= 160 KiB: checked by the wrapper).
KERNELS_API int attn_fused_q4_0(const void* x, const void* qs, const void* d, void* k_cache,
                                void* v_cache, const void* cos_t, const void* sin_t,
                                const void* lengths, const void* starts, const void* write_pos,
                                void* out, int B, int H, int Hkv, int S, int K, float scale,
                                float softcap, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ATTN_CASE(NB)                                                                         \
    case NB:                                                                                  \
        return launch<NB>(x, qs, d, k_cache, v_cache, cos_t, sin_t, lengths, starts,          \
                          write_pos, out, H, Hkv, S, K, scale, softcap, st);
    switch (B) {
        ATTN_CASE(1)
        ATTN_CASE(2)
        ATTN_CASE(3)
        ATTN_CASE(4)
        ATTN_CASE(5)
        ATTN_CASE(6)
        ATTN_CASE(7)
        ATTN_CASE(8)
        default: return (int)cudaErrorInvalidValue;
    }
#undef ATTN_CASE
}
