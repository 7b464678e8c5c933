// Shared device helpers for the port's kernels: bf16 unpacking, warp sums
// and maxima, cp.async copies, and the per-block Q4_0 / Q8_0 dot products
// that qmm.cu and attn_fused.cu both run. Weights are in GGUF block order
// (ops/qtensor.py):
//   Q4_0: qs u8 [N, K/2] (byte j of a 32-block: element j low nibble,
//         element j+16 high nibble), d f16 [N, K/32];  w = d * (q - 8)
//   Q8_0: qs i8 [N, K],   d f16 [N, K/32];             w = d * q
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define KERNELS_API extern "C" __attribute__((visibility("default")))

// bf16 halves of a little-endian 32-bit word → f32 (exact)
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// 16 bytes global → shared (cp.async.cg, L2 only); ok = false writes zeros
// and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Unpack one 32-element block of row `qs_row` into w[0..31] (integer values,
// before the block scale).
struct Q4_0 {
    static constexpr int QS_BYTES = 16;  // per 32-element block
    __device__ __forceinline__ static void unpack(const uint8_t* qs_row, int kb, float w[32]) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(qs_row + kb * QS_BYTES));
        const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const uint32_t byte = (words[i] >> (8 * j)) & 0xffu;
                w[i * 4 + j] = (float)((int)(byte & 0x0fu) - 8);
                w[i * 4 + j + 16] = (float)((int)(byte >> 4) - 8);
            }
        }
    }
};

struct Q8_0 {
    static constexpr int QS_BYTES = 32;
    __device__ __forceinline__ static void unpack(const uint8_t* qs_row, int kb, float w[32]) {
        const uint4* p = reinterpret_cast<const uint4*>(qs_row + kb * QS_BYTES);
        const uint4 a = __ldg(p), b = __ldg(p + 1);
        const uint32_t words[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                w[i * 4 + j] = (float)(int8_t)((words[i] >> (8 * j)) & 0xffu);
            }
        }
    }
};

// acc[b] += d_kb * sum_i w_i * x[b, 32*kb + i] for the NB activation rows
// (x bf16 [NB, K], row-major). The block scale is applied once per block,
// after the integer-valued dot, as ggml's vec_dot does.
template <class Q, int NB>
__device__ __forceinline__ void block_dot(const uint8_t* qs_row, const __half* d_row, int kb,
                                          const __nv_bfloat16* x, int K, float acc[NB]) {
    float w[32];
    Q::unpack(qs_row, kb, w);
    const float d = __half2float(__ldg(d_row + kb));
#pragma unroll
    for (int b = 0; b < NB; ++b) {
        const uint4* xp = reinterpret_cast<const uint4*>(x + (size_t)b * K + (size_t)kb * 32);
        float s = 0.f;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
            const uint4 xv = __ldg(xp + v);  // elements 8v .. 8v+7
            const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                s = fmaf(w[v * 8 + 2 * e], bf16_lo(xw[e]), s);
                s = fmaf(w[v * 8 + 2 * e + 1], bf16_hi(xw[e]), s);
            }
        }
        acc[b] = fmaf(d, s, acc[b]);
    }
}

// One warp: the full-K dot of weight row `row` with the NB activation rows.
// Lanes stride over the K/32 blocks; the result is summed across the warp
// and is valid in every lane.
template <class Q, int NB>
__device__ __forceinline__ void warp_row_dot(const uint8_t* qs, const __half* d, int row, int K,
                                             const __nv_bfloat16* x, int lane, float out[NB]) {
    const int nb = K >> 5;
    const uint8_t* qs_row = qs + (size_t)row * (size_t)(nb * Q::QS_BYTES);
    const __half* d_row = d + (size_t)row * nb;
    float acc[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[b] = 0.f;
#pragma unroll 2
    for (int kb = lane; kb < nb; kb += 32) block_dot<Q, NB>(qs_row, d_row, kb, x, K, acc);
#pragma unroll
    for (int b = 0; b < NB; ++b) out[b] = warp_sum(acc[b]);
}

// One online-softmax step: fold score s with value vector v (N dims per
// lane), the value term taken as (p·vscale)·v — vscale is a q8 row's scale,
// 1 for a bf16 row (p·1 is p exactly).
template <int N>
__device__ __forceinline__ void softmax_step(float s, const float (&v)[N], float vscale,
                                             float& m, float& l, float (&acc)[N]) {
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);  // m = -inf on the first step → 0
    const float p = expf(s - m_new);
    l = l * alpha + p;
    const float pv = p * vscale;
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = acc[i] * alpha + pv * v[i];
    m = m_new;
}

template <int N>
__device__ __forceinline__ void softmax_step(float s, const float (&v)[N], float& m, float& l,
                                             float (&acc)[N]) {
    softmax_step(s, v, 1.f, m, l, acc);
}

// 4 bf16 at p (8-byte aligned) → f32
__device__ __forceinline__ void load_bf16x4(const __nv_bfloat16* p, float out[4]) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    out[0] = bf16_lo(u.x);
    out[1] = bf16_hi(u.x);
    out[2] = bf16_lo(u.y);
    out[3] = bf16_hi(u.y);
}
