// qmm.cu — packed dequant-matmul y[B,N] f32 = x[B,K] bf16 · dequant(W[N,K])ᵀ
// for Q4_0 and Q8_0 weights kept packed in device memory.
//
// Replaces: llama_cpp_dsp_tpu/ops/pallas/qmm.py::_kernel with the Q4_0 body
// (_body_q4_0 via _q4_tile_dot) and the Q8_0 body (_body_q8_0).
//
// Bound on this card: at decode (B <= 8) the packed weight bytes over the
// memory rate (7B Q4_0: ~3.7 GB per token, ~1.1 ms at 3.35 TB/s); the
// arithmetic is ~2 operations per weight element and per activation row.
// Design: B <= 8 runs a GEMV, one warp per output row, lanes striding over
// the 32-element blocks with one 16-byte load of packed bits per block (two
// for Q8_0), dequantized in registers and summed with warp shuffles; the
// activations stay in L1/L2 and the weights are read once. B > 8 (prefill)
// runs a tiled tensor-core kernel: a 64x64 output tile per block, each
// 32-wide K step dequantizes its weight tile into shared memory as bf16 and
// multiplies it with WMMA bf16 fragments, f32 accumulation. Both are
// simple first versions: no TMA, no wgmma, no pipelining across K steps.
#include "common.cuh"

#include <mma.h>  // after cuda_bf16.h (common.cuh): bf16 WMMA fragments

namespace {

constexpr int GEMV_WARPS = 4;  // output rows per block

template <class Q, int NB>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
qmm_gemv(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ qs,
         const __half* __restrict__ d, float* __restrict__ y, int N, int K) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int row = blockIdx.x * GEMV_WARPS + warp;
    if (row >= N) return;
    float out[NB];
    warp_row_dot<Q, NB>(qs, d, row, K, x, lane, out);
    if (lane == 0) {
#pragma unroll
        for (int b = 0; b < NB; ++b) y[(size_t)b * N + row] = out[b];
    }
}

// ---- tiled tensor-core path (B > 8) ----------------------------------------
constexpr int TM = 64, TN = 64, TK = 32, LDS = TK + 8;  // LDS: bf16 row stride
constexpr int TILE_THREADS = 128;                       // 4 warps, 32x32 each

// Dequantize elements [16h, 16h+16) of block kb of weight row `row` into
// bf16 (w = d*(q-8) or d*q, rounded to bf16 like the plain version).
template <class Q>
__device__ __forceinline__ void dequant_half(const uint8_t* qs, const __half* d, int row, int K,
                                             int kb, int h, __nv_bfloat16 out[16]) {
    const int nb = K >> 5;
    float w[32];
    Q::unpack(qs + (size_t)row * (size_t)(nb * Q::QS_BYTES), kb, w);
    const float s = __half2float(__ldg(d + (size_t)row * nb + kb));
#pragma unroll
    for (int i = 0; i < 16; ++i) out[i] = __float2bfloat16(w[16 * h + i] * s);
}

template <class Q>
__global__ void __launch_bounds__(TILE_THREADS)
qmm_tiled(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ qs,
          const __half* __restrict__ d, float* __restrict__ y, int B, int N, int K) {
    using namespace nvcuda;
    __shared__ __align__(32) __nv_bfloat16 xs[TM * LDS];
    __shared__ __align__(32) __nv_bfloat16 ws[TN * LDS];
    __shared__ __align__(32) float cs[TM * (TN + 4)];

    const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
    const int warp = threadIdx.x >> 5;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
    const int r = threadIdx.x >> 1, h = threadIdx.x & 1;  // loader: row, half-block

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
                dequant_half<Q>(qs, d, n0 + r, K, kb, h, wv);
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

template <class Q, int NB>
void launch_gemv(const void* x, const void* qs, const void* d, void* y, int N, int K,
                 cudaStream_t st) {
    const dim3 grid((N + GEMV_WARPS - 1) / GEMV_WARPS);
    qmm_gemv<Q, NB><<<grid, GEMV_WARPS * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(qs),
        static_cast<const __half*>(d), static_cast<float*>(y), N, K);
}

template <class Q>
int qmm_launch(const void* x, const void* qs, const void* d, void* y, int B, int N, int K,
               void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (B) {
        case 1: launch_gemv<Q, 1>(x, qs, d, y, N, K, st); break;
        case 2: launch_gemv<Q, 2>(x, qs, d, y, N, K, st); break;
        case 3: launch_gemv<Q, 3>(x, qs, d, y, N, K, st); break;
        case 4: launch_gemv<Q, 4>(x, qs, d, y, N, K, st); break;
        case 5: launch_gemv<Q, 5>(x, qs, d, y, N, K, st); break;
        case 6: launch_gemv<Q, 6>(x, qs, d, y, N, K, st); break;
        case 7: launch_gemv<Q, 7>(x, qs, d, y, N, K, st); break;
        case 8: launch_gemv<Q, 8>(x, qs, d, y, N, K, st); break;
        default: {
            const dim3 grid((N + TN - 1) / TN, (B + TM - 1) / TM);
            qmm_tiled<Q><<<grid, TILE_THREADS, 0, st>>>(
                static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(qs),
                static_cast<const __half*>(d), static_cast<float*>(y), B, N, K);
        }
    }
    return (int)cudaGetLastError();
}

}  // namespace

// x bf16 [B,K]; qs u8 [N,K/2] (Q4_0) or i8 [N,K] (Q8_0); d f16 [N,K/32];
// y f32 [B,N]. K % 32 == 0, every pointer 16-byte aligned (checked by the
// Python wrapper). Returns cudaGetLastError() after the launch.
KERNELS_API int qmm_q4_0(const void* x, const void* qs, const void* d, void* y, int B, int N,
                         int K, void* stream) {
    return qmm_launch<Q4_0>(x, qs, d, y, B, N, K, stream);
}

KERNELS_API int qmm_q8_0(const void* x, const void* qs, const void* d, void* y, int B, int N,
                         int K, void* stream) {
    return qmm_launch<Q8_0>(x, qs, d, y, B, N, K, stream);
}

KERNELS_API const char* kernels_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
