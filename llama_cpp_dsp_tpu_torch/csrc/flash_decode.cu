// flash_decode.cu — T=1 attention of q[B,H,D] f32 over one slot's cached
// rows [start_b, length_b); GQA groups of rep = H/Hkv query heads share a kv
// head; optional logit softcap. Output [B,H,D] f32. Two C entries run the
// cluster kernel of flash_decode_gqa.cuh: flash_decode (dense rows of bf16,
// f16 or f32, B2) and flash_decode_paged_q8 (int8 pools [P,Hkv,ps,D], f32
// scales [P,Hkv,1,ps], block tables [B,max_blocks] int32, B7). The other
// layouts run one templated split kernel:
//   <I8, PAGED=false>  int8 k, v [B,Hkv,S,D], f32 scales
//                      kd, vd [B,Hkv,1,S] (one per row)                    flash_decode_q8
//   <Q4, PAGED=false>  u8 k, v [B,Hkv,S/2,D]: row 2j in the low nibble of
//                      byte row j, 2j+1 in the high one; f32 group scales
//                      kd, vd [B,Hkv,2G,S/2], G = D/32, parity-major
//                      (plane p*G+g, column j: group g of row 2j+p)         flash_decode_q4
//   <BF16|F16|F32, PAGED=true>  pools [P,Hkv,ps,D], block tables
//                      [B,max_blocks] int32                                flash_decode_paged
//
// Replaces: llama_cpp_dsp_tpu/ops/pallas/attention.py::_decode_kernel_q8
// and ::_decode_kernel_q8_allh (flash_decode_q8), ::_decode_kernel_q4
// (flash_decode_q4), ::_decode_kernel_paged and ::_decode_kernel_paged_allh
// (flash_decode_paged); B2's ::_decode_kernel and ::_decode_kernel_allh and
// B7's ::_decode_kernel_paged_q8 and ::_decode_kernel_paged_q8_allh through
// flash_decode_gqa.cuh.
//
// Bound on this card: the K/V bytes of the valid rows (and their scales)
// over the memory rate; a few flops per byte. Design (split-S flash
// decoding): the TPU kernels walk the sequence in order on one core; here
// the sequence is cut into splits of `chunk` rows, and a grid over (split,
// kv head, slot) runs them in parallel so short batches still fill the card.
// Inside a block four warps take interleaved rows; a warp reads one K row (4
// dims per lane: 8 bytes of bf16 or f16, 16 of f32, 4 of int8), sums q·k
// with shuffles and keeps an f32 online softmax per query head. The warps'
// states merge in shared memory into one (m, l, acc) per split, and a second
// small kernel merges the splits by log-sum-exp. Rows outside
// [start, length) are never read, so ragged lengths and the SWA start need
// no masking pass. q is taken in f32 and scaled before the dot, as the TPU
// kernels do. Q8 folds the row scales as the TPU kernels do, never
// dequantizing the cache: the score is (q·kq)·kd[row], then softcap; the
// value term is (p·vd[row])·vq. Q4 takes a byte row (two cache rows) per
// warp step: a lane reads 4 bytes, its 4 dims of both rows, and the scales
// of its dims' group (lane / 8) at the two parity planes; each row's score
// is the sum over groups of kd·(q·(nibble − 8)), and its value term
// (p·vd)·(nibble − 8) per group, as the TPU kernel folds them. The TPU
// kernel's even/odd halves, lane masks and 256-row chunks are Mosaic
// layouts and are not carried over; any even capacity works. PAGED
// addresses row r of slot b through page tables[b, r / ps] (an entry ≥ P
// is clamped to P-1; blocks at or past the length are never read), so a
// split is a run of whole pages and any page size works. The head width D
// is a template parameter, 128 or 256 (Gemma): a lane holds V = D / 32
// consecutive dims of q, of each K / V row and of acc (16 bytes of a bf16
// row at D = 256), and a Q4 lane's dims fall in group lane·V / 32; other
// widths are refused (cudaErrorInvalidValue; the wrappers check first).
#include <math.h>

#include "common.cuh"
#include "flash_decode_gqa.cuh"

extern template int gqa::launch_row<gqa::BF16>(const gqa::Args&, int, int, int, cudaStream_t);
extern template int gqa::launch_row<gqa::F16>(const gqa::Args&, int, int, int, cudaStream_t);
extern template int gqa::launch_row<gqa::F32>(const gqa::Args&, int, int, int, cudaStream_t);
extern template int gqa::launch_row<gqa::I8, true>(const gqa::Args&, int, int, int,
                                                   cudaStream_t);

namespace {

constexpr int WARPS = 4;

// element type of the cached rows (the C entries' `dtype` codes 0-2)
enum RowType : int { BF16 = 0, F16 = 1, F32 = 2, I8 = 3, Q4 = 4 };

struct DecodeArgs {
    const float* q;     // [B,H,D]
    const void* k;      // K rows (bf16, f16, f32, int8 or Q4 byte rows)
    const void* v;      // V rows
    const float* kd;    // I8: K row scales, indexed like rows; Q4: group scales
    const float* vd;    // I8: V row scales; Q4: group scales
    const int* tables;  // PAGED: [B, max_blocks]
    const int* lengths;
    const int* starts;  // may be null = 0
    float* ws_acc;      // [B*H*n_splits*D]
    float* ws_ml;       // [B*H*n_splits*2]
    int H, Hkv;
    int S;              // rows per slot, or the page size when PAGED
    int max_blocks, n_pages;  // PAGED
    int chunk, n_splits;
    float scale, softcap;
};

// Index of row `row` of (slot b, kv head hk) in units of rows: times D for
// the K/V element offset, and the offset of its scale as it is.
template <bool PAGED>
__device__ __forceinline__ size_t row_index(const DecodeArgs& a, int b, int hk, int row) {
    if (PAGED) {
        const int ps = a.S;
        const int page = min(max(a.tables[(size_t)b * a.max_blocks + row / ps], 0),
                             a.n_pages - 1);
        return ((size_t)page * a.Hkv + hk) * ps + (row % ps);
    }
    return ((size_t)b * a.Hkv + hk) * a.S + row;
}

// N consecutive K or V elements of a row → f32 (exact); N is 4 or 8
template <int R, int N>
__device__ __forceinline__ void load_row(const void* base, size_t off, float (&out)[N]) {
#pragma unroll
    for (int h = 0; h < N / 4; ++h) {
        const size_t o = off + 4 * h;
        if constexpr (R == I8) {
            const uint32_t u = *reinterpret_cast<const uint32_t*>(
                static_cast<const int8_t*>(base) + o);
#pragma unroll
            for (int i = 0; i < 4; ++i) out[4 * h + i] = (float)(int8_t)((u >> (8 * i)) & 0xffu);
        } else if constexpr (R == F16) {
            const uint2 u = *reinterpret_cast<const uint2*>(static_cast<const __half*>(base) + o);
            const uint32_t w[2] = {u.x, u.y};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                out[4 * h + i] = __half2float(
                    __ushort_as_half((unsigned short)(w[i / 2] >> (16 * (i % 2)))));
            }
        } else if constexpr (R == F32) {
            const float4 f = *reinterpret_cast<const float4*>(static_cast<const float*>(base) + o);
            out[4 * h] = f.x;
            out[4 * h + 1] = f.y;
            out[4 * h + 2] = f.z;
            out[4 * h + 3] = f.w;
        } else {
            float f[4];
            load_bf16x4(static_cast<const __nv_bfloat16*>(base) + o, f);
#pragma unroll
            for (int i = 0; i < 4; ++i) out[4 * h + i] = f[i];
        }
    }
}

template <int N>
__device__ __forceinline__ float dot(const float (&a)[N], const float (&b)[N]) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) s = fmaf(a[i], b[i], s);
    return s;
}

// The rows [lo, hi) of (slot b, kv head hk) folded into one query head's
// online softmax (m, l, acc) — every layout but Q4.
template <int R, bool PAGED, int D>
__device__ __forceinline__ void fold_rows(const DecodeArgs& a, int b, int hk, int lo, int hi,
                                          int warp, int lane, const float (&qv)[D / 32],
                                          float& m, float& l, float (&acc)[D / 32]) {
    constexpr int V = D / 32;
    for (int row = lo + warp; row < hi; row += WARPS) {
        const size_t idx = row_index<PAGED>(a, b, hk, row);
        float kf[V], vf[V];
        load_row<R>(a.k, idx * D + lane * V, kf);
        load_row<R>(a.v, idx * D + lane * V, vf);
        float s = warp_sum(dot(qv, kf));
        if (R == I8) s *= a.kd[idx];
        if (a.softcap > 0.f) s = tanhf(s / a.softcap) * a.softcap;
        softmax_step(s, vf, R == I8 ? a.vd[idx] : 1.f, m, l, acc);
    }
}

// The Q4 form: a warp takes byte row j (cache rows 2j, 2j+1) per step; a
// lane reads the V bytes of its dims (both rows) and the scales of its dims'
// group at the two parity planes.
template <int D>
__device__ __forceinline__ void fold_rows_q4(const DecodeArgs& a, int b, int hk, int lo, int hi,
                                             int warp, int lane, const float (&qv)[D / 32],
                                             float& m, float& l, float (&acc)[D / 32]) {
    constexpr int V = D / 32, G = D / 32;  // dims a lane holds; scale groups a row
    const int s2 = a.S / 2;
    const size_t bh = (size_t)b * a.Hkv + hk;
    const uint8_t* kq = static_cast<const uint8_t*>(a.k) + bh * s2 * D + lane * V;
    const uint8_t* vq = static_cast<const uint8_t*>(a.v) + bh * s2 * D + lane * V;
    const float* kd = a.kd + (bh * 2 * G + lane * V / 32) * s2;  // the lane's group, parity 0
    const float* vd = a.vd + (bh * 2 * G + lane * V / 32) * s2;
    for (int j = (lo >> 1) + warp; 2 * j < hi; j += WARPS) {
        uint32_t kb[V / 4], vb[V / 4];
#pragma unroll
        for (int h = 0; h < V / 4; ++h) {
            kb[h] = *reinterpret_cast<const uint32_t*>(kq + (size_t)j * D + 4 * h);
            vb[h] = *reinterpret_cast<const uint32_t*>(vq + (size_t)j * D + 4 * h);
        }
#pragma unroll
        for (int par = 0; par < 2; ++par) {
            const int row = 2 * j + par;
            if (row < lo || row >= hi) continue;  // the same for the whole warp
            float kf[V], vf[V];
#pragma unroll
            for (int i = 0; i < V; ++i) {
                const int sh = 8 * (i % 4) + 4 * par;
                kf[i] = (float)((int)((kb[i / 4] >> sh) & 15u) - 8);
                vf[i] = (float)((int)((vb[i / 4] >> sh) & 15u) - 8);
            }
            const size_t sc = (size_t)par * G * s2 + j;
            float s = warp_sum(dot(qv, kf) * kd[sc]);
            if (a.softcap > 0.f) s = tanhf(s / a.softcap) * a.softcap;
            softmax_step(s, vf, vd[sc], m, l, acc);
        }
    }
}

template <int R, bool PAGED, int D>
__global__ void __launch_bounds__(WARPS * 32) decode_split(const DecodeArgs a) {
    constexpr int V = D / 32;
    const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int rep = a.H / a.Hkv;
    const int cap = PAGED ? a.max_blocks * a.S : a.S;
    const int len = min(a.lengths[b], cap);
    const int st = a.starts ? max(a.starts[b], 0) : 0;
    const int lo = max(split * a.chunk, st);
    const int hi = min((split + 1) * a.chunk, len);

    __shared__ float sm_m[WARPS], sm_l[WARPS];
    __shared__ float sm_acc[WARPS][D];

    for (int r = 0; r < rep; ++r) {
        const int head = hk * rep + r;
        float qv[V], m = -INFINITY, l = 0.f, acc[V];
#pragma unroll
        for (int h = 0; h < V / 4; ++h) {
            const float4 q4 = *reinterpret_cast<const float4*>(
                a.q + ((size_t)b * a.H + head) * D + lane * V + 4 * h);
            qv[4 * h] = q4.x * a.scale;
            qv[4 * h + 1] = q4.y * a.scale;
            qv[4 * h + 2] = q4.z * a.scale;
            qv[4 * h + 3] = q4.w * a.scale;
        }
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = 0.f;
        if constexpr (R == Q4) {
            fold_rows_q4<D>(a, b, hk, lo, hi, warp, lane, qv, m, l, acc);
        } else {
            fold_rows<R, PAGED, D>(a, b, hk, lo, hi, warp, lane, qv, m, l, acc);
        }
        if (lane == 0) {
            sm_m[warp] = m;
            sm_l[warp] = l;
        }
#pragma unroll
        for (int i = 0; i < V; ++i) sm_acc[warp][lane * V + i] = acc[i];
        __syncthreads();
        float mm = -INFINITY;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, sm_m[w]);
        float ll = 0.f;
        if (mm != -INFINITY) {
#pragma unroll
            for (int w = 0; w < WARPS; ++w) {
                if (sm_m[w] != -INFINITY) ll += sm_l[w] * expf(sm_m[w] - mm);
            }
        }
        const size_t slot = ((size_t)b * a.H + head) * a.n_splits + split;
        // merge the warps: thread t owns dims t, t + 128, ...
        for (int t = threadIdx.x; t < D; t += WARPS * 32) {
            float aa = 0.f;
            if (mm != -INFINITY) {
#pragma unroll
                for (int w = 0; w < WARPS; ++w) {
                    if (sm_m[w] != -INFINITY) aa += sm_acc[w][t] * expf(sm_m[w] - mm);
                }
            }
            a.ws_acc[slot * D + t] = aa;
        }
        if (threadIdx.x == 0) {
            a.ws_ml[slot * 2] = mm;
            a.ws_ml[slot * 2 + 1] = ll;
        }
        __syncthreads();
    }
}

template <int D>
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

template <int R, bool PAGED, int D>
int launch_d(const DecodeArgs& a, void* out, int B, cudaStream_t st) {
    decode_split<R, PAGED, D><<<dim3(a.n_splits, a.Hkv, B), WARPS * 32, 0, st>>>(a);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    flash_decode_merge<D><<<dim3(a.H, B), D, 0, st>>>(a.ws_acc, a.ws_ml,
                                                      static_cast<float*>(out), a.n_splits);
    return (int)cudaGetLastError();
}

// the instantiation for head width D (128 or 256)
template <int R, bool PAGED>
int launch(const DecodeArgs& a, int D, void* out, int B, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 128: return launch_d<R, PAGED, 128>(a, out, B, st);
        case 256: return launch_d<R, PAGED, 256>(a, out, B, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// pages of element type `dtype` (RowType 0-2)
int launch_paged(const DecodeArgs& a, int dtype, int D, void* out, int B, void* stream) {
    switch (dtype) {
        case BF16: return launch<BF16, true>(a, D, out, B, stream);
        case F16: return launch<F16, true>(a, D, out, B, stream);
        case F32: return launch<F32, true>(a, D, out, B, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

DecodeArgs make_args(const void* q, const void* k, const void* kd, const void* v,
                     const void* vd, const void* tables, const void* lengths,
                     const void* starts, void* ws_acc, void* ws_ml, int H, int Hkv, int S,
                     int max_blocks, int n_pages, int chunk, int n_splits, float scale,
                     float softcap) {
    DecodeArgs a;
    a.q = static_cast<const float*>(q);
    a.k = k;
    a.v = v;
    a.kd = static_cast<const float*>(kd);
    a.vd = static_cast<const float*>(vd);
    a.tables = static_cast<const int*>(tables);
    a.lengths = static_cast<const int*>(lengths);
    a.starts = static_cast<const int*>(starts);
    a.ws_acc = static_cast<float*>(ws_acc);
    a.ws_ml = static_cast<float*>(ws_ml);
    a.H = H;
    a.Hkv = Hkv;
    a.S = S;
    a.max_blocks = max_blocks;
    a.n_pages = n_pages;
    a.chunk = chunk;
    a.n_splits = n_splits;
    a.scale = scale;
    a.softcap = softcap;
    return a;
}

}  // namespace

// B2: k, v [B,Hkv,S,D] of element type dtype (0 bf16, 1 f16, 2 f32); q f32
// [B,H,D]; lengths, starts int32 [B] (starts may be null = 0); out f32
// [B,H,D]; D 128 or 256, H / Hkv ≤ 16. cluster: the blocks of a (kv head,
// slot) pair, 8 or 16, or 0 for the kernel's own choice.
KERNELS_API int flash_decode(const void* q, const void* k, const void* v, const void* lengths,
                             const void* starts, void* out, int B, int H, int Hkv, int D, int S,
                             int dtype, int cluster, float scale, float softcap, void* stream) {
    if (B <= 0 || Hkv <= 0 || H % Hkv || H / Hkv > 16) return (int)cudaErrorInvalidValue;
    const gqa::Args a{static_cast<const float*>(q), k, v, static_cast<const int*>(lengths),
                      static_cast<const int*>(starts), static_cast<float*>(out), H, Hkv, S,
                      scale, softcap};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case BF16: return gqa::launch_row<gqa::BF16>(a, B, D, cluster, st);
        case F16: return gqa::launch_row<gqa::F16>(a, B, D, cluster, st);
        case F32: return gqa::launch_row<gqa::F32>(a, B, D, cluster, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// In the entries below: q f32 [B,H,D]; lengths, starts int32 [B] (starts
// may be null = 0); out f32 [B,H,D]; ws_acc f32 [B*H*n_splits*D], ws_ml f32
// [B*H*n_splits*2] scratch. D is 128 or 256.

// kq, vq int8 [B,Hkv,S,D]; kd, vd f32 [B,Hkv,1,S]; n_splits = ceil(S / chunk).
KERNELS_API int flash_decode_q8(const void* q, const void* kq, const void* kd, const void* vq,
                                const void* vd, const void* lengths, const void* starts,
                                void* out, void* ws_acc, void* ws_ml, int B, int H, int Hkv,
                                int D, int S, int chunk, float scale, float softcap,
                                void* stream) {
    const int n_splits = (S + chunk - 1) / chunk;
    return launch<I8, false>(make_args(q, kq, kd, vq, vd, nullptr, lengths, starts, ws_acc,
                                       ws_ml, H, Hkv, S, 0, 0, chunk, n_splits, scale,
                                       softcap),
                             D, out, B, stream);
}

// kq, vq u8 [B,Hkv,S/2,D] row pairs; kd, vd f32 [B,Hkv,2G,S/2] parity-major
// group scales (G = D/32); S (the capacity in rows) even and chunk even;
// n_splits = ceil(S / chunk).
KERNELS_API int flash_decode_q4(const void* q, const void* kq, const void* kd, const void* vq,
                                const void* vd, const void* lengths, const void* starts,
                                void* out, void* ws_acc, void* ws_ml, int B, int H, int Hkv,
                                int D, int S, int chunk, float scale, float softcap,
                                void* stream) {
    if (S % 2 || chunk % 2) return (int)cudaErrorInvalidValue;
    const int n_splits = (S + chunk - 1) / chunk;
    return launch<Q4, false>(make_args(q, kq, kd, vq, vd, nullptr, lengths, starts, ws_acc,
                                       ws_ml, H, Hkv, S, 0, 0, chunk, n_splits, scale,
                                       softcap),
                             D, out, B, stream);
}

// k, v pools [P,Hkv,ps,D] of element type dtype (0 bf16, 1 f16, 2 f32);
// tables int32 [B,max_blocks]; a split is pages_per_split pages;
// n_splits = ceil(max_blocks / pages_per_split).
KERNELS_API int flash_decode_paged(const void* q, const void* k, const void* v,
                                   const void* tables, const void* lengths, const void* starts,
                                   void* out, void* ws_acc, void* ws_ml, int B, int H, int Hkv,
                                   int D, int ps, int max_blocks, int n_pages,
                                   int pages_per_split, int dtype, float scale, float softcap,
                                   void* stream) {
    const int n_splits = (max_blocks + pages_per_split - 1) / pages_per_split;
    return launch_paged(make_args(q, k, nullptr, v, nullptr, tables, lengths, starts, ws_acc,
                                  ws_ml, H, Hkv, ps, max_blocks, n_pages,
                                  pages_per_split * ps, n_splits, scale, softcap),
                        dtype, D, out, B, stream);
}

// B7: kq, vq int8 pools [P,Hkv,ps,D]; kd, vd f32 [P,Hkv,1,ps]; tables
// int32 [B,max_blocks] (an entry outside [0, P) is clamped into it); q f32
// [B,H,D]; lengths, starts int32 [B] (starts may be null = 0); out f32
// [B,H,D]; D 128 or 256, H / Hkv ≤ 16. cluster: the blocks of a (kv head,
// slot) pair, 8 or 16, or 0 for the kernel's own choice. One launch, no
// workspace.
KERNELS_API int flash_decode_paged_q8(const void* q, const void* kq, const void* kd,
                                      const void* vq, const void* vd, const void* tables,
                                      const void* lengths, const void* starts, void* out,
                                      int B, int H, int Hkv, int D, int ps, int max_blocks,
                                      int n_pages, int cluster, float scale, float softcap,
                                      void* stream) {
    if (B <= 0 || Hkv <= 0 || H % Hkv || H / Hkv > 16 || ps <= 0 || max_blocks <= 0 ||
        n_pages <= 0) {
        return (int)cudaErrorInvalidValue;
    }
    const gqa::Args a{static_cast<const float*>(q), kq, vq, static_cast<const int*>(lengths),
                      static_cast<const int*>(starts), static_cast<float*>(out), H, Hkv,
                      max_blocks * ps, scale, softcap, static_cast<const float*>(kd),
                      static_cast<const float*>(vd), static_cast<const int*>(tables), ps,
                      max_blocks, n_pages};
    return gqa::launch_row<gqa::I8, true>(a, B, D, cluster, static_cast<cudaStream_t>(stream));
}
