// flash_decode.cu — T=1 attention of q[B,H,D] f32 over a bf16 cache
// k, v [B,Hkv,S,D], rows [start_b, length_b) of each slot; GQA groups of
// rep = H/Hkv query heads share a kv head; optional logit softcap.
// Output [B,H,D] f32.
//
// Replaces: llama_cpp_dsp_tpu/ops/pallas/attention.py::_decode_kernel_allh
// and ::_decode_kernel (entry flash_decode).
//
// Bound on this card: the K/V bytes of the valid rows over the memory rate
// (a few flops per byte). Design (split-S flash decoding): the TPU kernels
// walk the sequence in order on one core; here the sequence is cut into
// splits of `chunk` rows, and a grid over (split, kv head, slot) runs them
// in parallel so short batches still fill the card. Inside a block four
// warps take interleaved rows; a warp reads one 256-byte K row (4 dims per
// lane), sums q·k with shuffles and keeps an f32 online softmax per query
// head. The warps' states merge in shared memory into one (m, l, acc) per
// split, and a second small kernel merges the splits by log-sum-exp. Rows
// outside [start, length) are never read, so ragged lengths and the SWA
// start need no masking pass. q is taken in f32 and scaled before the dot,
// as the TPU kernel does. D = 128 only (the wrapper checks).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int D = 128;
constexpr int WARPS = 4;

__global__ void __launch_bounds__(WARPS * 32)
flash_decode_split(const float* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths,
                   const int* __restrict__ starts, float* __restrict__ ws_acc,
                   float* __restrict__ ws_ml, int H, int Hkv, int S, int chunk, int n_splits,
                   float scale, float softcap) {
    const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int rep = H / Hkv;
    const int len = min(lengths[b], S);
    const int st = starts ? max(starts[b], 0) : 0;
    const int lo = max(split * chunk, st);
    const int hi = min((split + 1) * chunk, len);

    __shared__ float sm_m[WARPS], sm_l[WARPS];
    __shared__ float sm_acc[WARPS][D];

    const size_t kv_base = ((size_t)b * Hkv + hk) * (size_t)S * D;
    for (int r = 0; r < rep; ++r) {
        const int head = hk * rep + r;
        const float4 q4 = *reinterpret_cast<const float4*>(q + ((size_t)b * H + head) * D + lane * 4);
        const float qv[4] = {q4.x * scale, q4.y * scale, q4.z * scale, q4.w * scale};
        float m = -INFINITY, l = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int row = lo + warp; row < hi; row += WARPS) {
            float kf[4], vf[4];
            load_bf16x4(k + kv_base + (size_t)row * D + lane * 4, kf);
            load_bf16x4(v + kv_base + (size_t)row * D + lane * 4, vf);
            float s = qv[0] * kf[0] + qv[1] * kf[1] + qv[2] * kf[2] + qv[3] * kf[3];
            s = warp_sum(s);
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
        {  // merge the warps: thread t owns dim t
            const int t = threadIdx.x;
            float mm = -INFINITY;
#pragma unroll
            for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, sm_m[w]);
            float ll = 0.f, aa = 0.f;
            if (mm != -INFINITY) {
#pragma unroll
                for (int w = 0; w < WARPS; ++w) {
                    if (sm_m[w] == -INFINITY) continue;
                    const float e = expf(sm_m[w] - mm);
                    ll += sm_l[w] * e;
                    aa += sm_acc[w][t] * e;
                }
            }
            const size_t slot = ((size_t)b * H + head) * n_splits + split;
            ws_acc[slot * D + t] = aa;
            if (t == 0) {
                ws_ml[slot * 2] = mm;
                ws_ml[slot * 2 + 1] = ll;
            }
        }
        __syncthreads();
    }
}

__global__ void __launch_bounds__(D)
flash_decode_merge(const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
                   float* __restrict__ out, int n_splits) {
    const size_t bh = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    const int t = threadIdx.x;
    const float* ml = ws_ml + bh * n_splits * 2;
    float mm = -INFINITY;
    for (int s = 0; s < n_splits; ++s) mm = fmaxf(mm, ml[2 * s]);
    float ll = 0.f, aa = 0.f;
    if (mm != -INFINITY) {
        for (int s = 0; s < n_splits; ++s) {
            const float ms = ml[2 * s];
            if (ms == -INFINITY) continue;
            const float e = expf(ms - mm);
            ll += ml[2 * s + 1] * e;
            aa += ws_acc[(bh * n_splits + s) * D + t] * e;
        }
    }
    out[bh * D + t] = aa / fmaxf(ll, 1e-30f);
}

}  // namespace

// q f32 [B,H,D]; k, v bf16 [B,Hkv,S,D]; lengths, starts int32 [B] (starts may
// be null = 0); out f32 [B,H,D]; ws_acc f32 [B*H*n_splits*D], ws_ml f32
// [B*H*n_splits*2] scratch. n_splits = ceil(S / chunk). D must be 128.
KERNELS_API int flash_decode(const void* q, const void* k, const void* v, const void* lengths,
                             const void* starts, void* out, void* ws_acc, void* ws_ml, int B,
                             int H, int Hkv, int S, int chunk, float scale, float softcap,
                             void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int n_splits = (S + chunk - 1) / chunk;
    flash_decode_split<<<dim3(n_splits, Hkv, B), WARPS * 32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lengths),
        static_cast<const int*>(starts), static_cast<float*>(ws_acc), static_cast<float*>(ws_ml),
        H, Hkv, S, chunk, n_splits, scale, softcap);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    flash_decode_merge<<<dim3(H, B), D, 0, st>>>(static_cast<const float*>(ws_acc),
                                                  static_cast<const float*>(ws_ml),
                                                  static_cast<float*>(out), n_splits);
    return (int)cudaGetLastError();
}
