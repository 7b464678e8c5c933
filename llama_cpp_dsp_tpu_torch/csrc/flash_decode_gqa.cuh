// flash_decode_gqa.cuh — decode attention (T = 1): q [B,H,D] f32 over each
// slot's cached rows [start_b, length_b), GQA groups of rep = H / Hkv ≤ 16
// query heads a kv head, optional logit softcap → out [B,H,D] f32. Two
// template axes: the row type R (bf16, f16, f32, or I8: int8 codes with one
// f32 scale a row) and the row source (dense k, v [B,Hkv,S,D]; or PAGED
// pools [P,Hkv,ps,D] with row r of slot b in page tables[b, r / ps], an
// entry ≥ P clamped to P − 1, and I8 scales [P,Hkv,1,ps]). Instantiated:
// - B2, dense bf16 / f16 / f32 rows: C entry flash_decode (flash_decode.cu),
//   flash_decode_gqa_{bf16,f16,f32}.cu one row type each;
// - B7, paged I8 rows: C entry flash_decode_paged_q8 (flash_decode.cu),
//   flash_decode_gqa_paged_q8.cu.
// The four translation units compile side by side.
//
// Replaces: llama_cpp_dsp_tpu/ops/pallas/attention.py::_decode_kernel and
// ::_decode_kernel_allh (B2, entry flash_decode); ::_decode_kernel_paged_q8
// and ::_decode_kernel_paged_q8_allh (B7, entry flash_decode_paged_q8).
//
// Bound on this card: the K/V bytes of the valid rows (and I8's row scales)
// over the memory rate, no tensor cores: every element is converted to f32
// exactly and q is scaled in f32 before the dot, as the TPU kernels do, and
// only the order of the sums differs from the plain version. bf16 rows take
// 2·rep f32 FMAs per K/V element pair (≤ 3.5 a byte at rep 7, a third of the
// CUDA cores' rate at 3.35 TB/s). I8 rows take twice that a byte, and each
// code costs a prmt and an FADD besides (exact, no conversion instruction:
// s8x4). At rep 7 (RB 8) a K/V byte pair costs ~23 instructions: 16 FMAs,
// ~5 for the codes, ~2 for the score's shuffles, ~1 for p; to read at 3.35
// TB/s each SM must take ~14.5 bytes a clock, i.e. ~165 instructions a
// clock against the SM's 128, so the I8 tile loop is bound by issue at rep
// 7-8 (and by bytes at rep ≤ 4). At the decode shapes a call is bound by
// neither: a few µs of latency (table and length loads, the first copies,
// the merge) rule it (PERF.md §6). B7 scores with (q·scale · codes) ·
// kd[row], then the softcap, and folds the value term as (p · vd[row]) ·
// codes, as the TPU kernel does.
//
// Design. The TPU kernel walks a slot's rows in order with the whole GQA
// group as one [rep, D] operand. Here:
// - A thread-block cluster of C blocks (8, or 16 where 8 a (kv head, slot)
//   pair leave SMs idle and the capacity or the grid asks for it; launch())
//   owns one kv head of one slot; grid (C, Hkv, B). Each
//   block reads lengths[b] and starts[b] and takes its even share of the
//   valid span, ceil((length − start) / C) rows, so no block folds a row
//   outside [start, length) and ragged slots and SWA starts balance on the
//   card with no host sync. A span shorter than C leaves blocks empty
//   (m = −inf). A span of one tile or less is folded by rank 0 alone, which
//   writes out itself (solo: no merge).
// - A block reads each K and V row of its part once, for all rep heads:
//   the rows stream through a ring of 2-4 tiles of 32 KB of K and V (64 rows
//   of bf16 / f16 at D = 128, 32 otherwise; the ring ≤ 72 KB, so three
//   blocks share an SM; f32 rows at D = 256 take two 68 KB stages; I8 tiles
//   are 64 rows with their scales: 2-4 stages and three blocks an SM up to
//   rep 8 at D = 128, two stages of ~41 KB at D = 256) in shared memory,
//   16-byte cp.async.cg copies; rows past the part are never issued. With
//   no SWA starts a dense rank 0's first tile goes out before the length is
//   read.
// - PAGED: tiles do not line up with pages; each 16-byte chunk finds its
//   own page. The page ids of table entries [w0, w0 + 256) sit in shared
//   memory (w0 = 0 first, read together with the length, so a part's first
//   copy waits for one load, not two in a row); a tile whose pages leave
//   the window moves it (only past 256 pages of a slot). I8 row scales ride
//   the ring beside their rows: a 16-byte copy where four rows (aligned to
//   4) lie in one page at a 16-byte-aligned address, 4-byte copies
//   otherwise, so any page size works.
// - Per tile: (1) scores of all rows × rep heads: LPR lanes share a row, each
//   holding its DQ dims of every head's q in registers (RB·DQ ≤ 64 floats,
//   128 at RB 16; I8 lanes read 8 bytes), summed across the row's lanes by a
//   reduce-scatter (the first log2(RB) shuffle steps trade halves of the
//   heads); rows padded so the lanes of a load phase hit distinct banks;
//   (2) one max and one rescale per tile and head (warp w takes heads w,
//   w + 4, …; a lane rows lane, lane + 32; I8 stores p · vd[row]); (3) p·V:
//   a thread owns 8 dims (two runs of 4; I8 8 bytes in a row) of HPT heads
//   over every RG-th row of the tile, so a V element leaves shared memory
//   once per thread for all its heads.
// - The merge, in the same launch: rank r owns outputs [r·SL, (r + 1)·SL),
//   SL = rep·D / C. Each block pushes its (m, l) to every rank and each
//   slice of its sums to the slice's owner with st.async into the owner's
//   shared memory (distributed shared memory), the bytes counted by the
//   owner's mbarrier; each rank waits for its own bytes only, merges its
//   slice by log-sum-exp and writes out. No block reads another's memory,
//   so none waits for the others before it leaves; the one cluster barrier
//   (arrive at the start, wait before the pushes) only makes sure every
//   block runs and has set its mbarrier. On the H100 this beat both a
//   second merge launch and a merge across a full cluster barrier (PERF.md).
#pragma once

#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace gqa {

namespace cg = cooperative_groups;

// element type of the cached rows (the C entries' `dtype` codes; I8: int8
// codes and an f32 scale a row)
enum RowType : int { BF16 = 0, F16 = 1, F32 = 2, I8 = 3 };

struct Args {
    const float* q;      // [B,H,D]
    const void* k;       // [B,Hkv,S,D]; PAGED [P,Hkv,ps,D]
    const void* v;       // the same
    const int* lengths;  // [B]
    const int* starts;   // [B], or null = 0
    float* out;          // [B,H,D]
    int H, Hkv, S;       // S: rows a slot (PAGED: max_blocks · ps)
    float scale, softcap;
    const float* kd;     // I8: row scales [B,Hkv,1,S]; PAGED [P,Hkv,1,ps]
    const float* vd;
    const int* tables;   // PAGED: [B, max_blocks] page ids
    int ps, max_blocks, n_pages;  // PAGED
};

constexpr int NT = 128;                 // threads a block
constexpr int RING_BYTES = 72 * 1024;   // the K/V ring at most: 3 blocks an SM
constexpr int MAX_CLUSTER = 16;

constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The layout of one instantiation: row type R, head width D, RB ≥ rep
// query heads a block (1, 2, 4, 8 or 16), row source PAGED.
template <int R, int D, int RB, bool PAGED = false>
struct Cfg {
    static constexpr int ES = R == F32 ? 4 : R == I8 ? 1 : 2;  // bytes an element
    static constexpr int CB = R == I8 ? 8 : 16;  // bytes of a row a lane scores at once
    static constexpr int CD = CB / ES;           // elements a score chunk
    static constexpr int CPR = D * ES / 16;      // 16-byte copy chunks a row
    // rows a tile: 32 KB of K and V (32 rows at least, a lane's share of
    // the softmax a whole number of rows); I8 64 rows at either width: at
    // D = 128 its 16 KB tiles leave room for three blocks an SM, which the
    // 7B's 32 clusters of 8 need to run in one wave (128-row tiles: 11.0 µs
    // a layer against 6.6, PERF.md §6), and at D = 256 they beat 32-row ones
    // (0.393 ms a Gemma-3-12B token against 0.413)
    static constexpr int T = R == I8 ? 64 : cmax(32, 16384 / (D * ES));
    // scores: LPR lanes a row, DQ dims a lane (NCH chunks), P rows a pass
    static constexpr int LPR = cmin(cmax(RB * D / 64, NT / T), cmin(32, D * ES / CB));
    static constexpr int DQ = D / LPR;
    static constexpr int NCH = DQ / CD;
    static constexpr int P = NT / LPR;
    static constexpr int G = LPR / RB;  // lanes a head's score ends in
    static constexpr int LOG2RB = RB >= 16 ? 4 : RB >= 8 ? 3 : RB >= 4 ? 2 : RB >= 2 ? 1 : 0;
    // a load phase reads 128 bytes; where a row's lanes read fewer, the
    // phase spans rows: pad them onto other banks
    static constexpr int PAD = LPR * CB < 128 ? LPR * CB : 0;
    static constexpr int STRIDE = D * ES + PAD;  // bytes a row in shared memory
    static constexpr int TILE = T * STRIDE;
    // I8: a tile's K and V row scales, 4 floats of slack so that a 16-byte
    // copy of 4 rows aligned to 4 stays aligned in shared memory
    static constexpr int SCL = R == I8 ? 4 * (T + 4) : 0;
    static constexpr int STAGE = 2 * TILE + 2 * SCL;  // K tile, V tile, K and V scales
    static constexpr int STAGES = cmax(2, cmin(4, RING_BYTES / STAGE));
    static constexpr int RING = STAGES * STAGE;
    static constexpr int TW = PAGED ? 256 : 0;  // the table window's entries
    // p·V: a thread's 8 dims are D0·td.. and D1 further on (I8: 8 bytes in
    // a row, one 8-byte load; else two runs of 4 elements)
    static constexpr int D0 = R == I8 ? 8 : 4;
    static constexpr int D1 = R == I8 ? 4 : D / 2;
    // p·V: DT threads across the dims (8 each), HG head groups of HPT, RG row
    // groups
    static constexpr int DT = D / 8;
    static constexpr int HG = RB > 8 ? 2 : 1;
    static constexpr int HPT = RB / HG;
    static constexpr int RG = NT / DT / HG;
    // the merge: the slices of out that the other blocks push here, and
    // every block's (m, l) of every head
    static constexpr int RECV = RB * D + MAX_CLUSTER;
    // the ring; the merge's mbarrier (16 bytes); scores / probabilities
    // [RB][T]; m, l, alpha [RB]; the merge's received slices and m, l,
    // weights [MAX_CLUSTER][RB]; the table window [TW]
    static constexpr int SMEM =
        RING + 16 + 4 * (RB * T + 3 * RB + RECV + 3 * MAX_CLUSTER * RB + TW);

    static_assert(T % 32 == 0 && T % P == 0 && NCH >= 1 && RG >= 1 && G >= 1, "tile layout");
    static_assert(STRIDE % 16 == 0 && STAGE % 16 == 0 && (!PAGED || T <= TW),
                  "16-byte copies; a tile's pages fit in the window");
    static_assert(RG * RB * D * 4 <= RING, "the row groups' sums fit in the ring");
    static_assert(SMEM <= 232448, "shared memory of one block");
};

// 16 bytes of a row → f32 (exact)
template <int R>
__device__ __forceinline__ void cvt16(const uint4 u, float (&f)[16 / (R == F32 ? 4 : 2)]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        if constexpr (R == F32) {
            f[i] = __uint_as_float(w[i]);
        } else if constexpr (R == BF16) {
            f[2 * i] = bf16_lo(w[i]);
            f[2 * i + 1] = bf16_hi(w[i]);
        } else {
            f[2 * i] = __half2float(__ushort_as_half((unsigned short)(w[i] & 0xffffu)));
            f[2 * i + 1] = __half2float(__ushort_as_half((unsigned short)(w[i] >> 16)));
        }
    }
}

// the 4 int8 codes of w → f32, exactly and with no conversion instruction:
// code ^ 0x80 under the exponent of 2^23, less 2^23 + 128
__device__ __forceinline__ void s8x4(uint32_t w, float* f) {
    const uint32_t x = w ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        f[i] = __uint_as_float(__byte_perm(x, 0x4b000000u, 0x7440 | i)) - 8388736.f;
    }
}

// the score chunk at p (Cfg::CB bytes, aligned) → f32
template <int R>
__device__ __forceinline__ void cvt_chunk(const unsigned char* p, float (&f)[R == I8 ? 8 : 16 / (R == F32 ? 4 : 2)]) {
    if constexpr (R == I8) {
        const uint2 u = *reinterpret_cast<const uint2*>(p);
        s8x4(u.x, f);
        s8x4(u.y, f + 4);
    } else {
        cvt16<R>(*reinterpret_cast<const uint4*>(p), f);
    }
}

// 4 consecutive elements at p (8 or 16 bytes, aligned) → f32
template <int R>
__device__ __forceinline__ void ld4(const unsigned char* p, float* f) {
    if constexpr (R == F32) {
        const float4 x = *reinterpret_cast<const float4*>(p);
        f[0] = x.x;
        f[1] = x.y;
        f[2] = x.z;
        f[3] = x.w;
    } else {
        const uint2 u = *reinterpret_cast<const uint2*>(p);
        const uint32_t w[2] = {u.x, u.y};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            if constexpr (R == BF16) {
                f[2 * i] = bf16_lo(w[i]);
                f[2 * i + 1] = bf16_hi(w[i]);
            } else {
                f[2 * i] = __half2float(__ushort_as_half((unsigned short)(w[i] & 0xffffu)));
                f[2 * i + 1] = __half2float(__ushort_as_half((unsigned short)(w[i] >> 16)));
            }
        }
    }
}

// 4 bytes global → shared (cp.async.ca)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}

// The cluster barrier in two halves (every thread of every block arrives
// once): arrive without ordering, and wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The shared-memory address `addr` (of this block) in block `rank` of the
// cluster.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
    return r;
}

// 4 bytes into another block's shared memory; the bytes count towards that
// block's mbarrier at `mbar` (both cluster addresses).
__device__ __forceinline__ void push(uint32_t addr, float v, uint32_t mbar) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
                 ::"r"(addr), "r"(__float_as_uint(v)), "r"(mbar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t mbar, uint32_t parity) {
    uint32_t ok;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok) : "r"(mbar), "r"(parity) : "memory");
    return ok;
}

template <int R, int D, int RB, bool PAGED>
__global__ void __launch_bounds__(NT) flash_decode_gqa(const Args a) {
    using K = Cfg<R, D, RB, PAGED>;
    constexpr int T = K::T;
    extern __shared__ __align__(16) unsigned char smem[];
    const uint32_t mbar = (uint32_t)__cvta_generic_to_shared(smem + K::RING);
    float* sc = reinterpret_cast<float*>(smem + K::RING + 16);  // [RB][T]
    float* sm_m = sc + RB * T;
    float* sm_l = sm_m + RB;
    float* sm_a = sm_l + RB;
    float* recv = sm_a + RB;                    // [C][SL]: the other parts of my slice
    float* gm = recv + K::RECV;                 // [MAX_CLUSTER][RB]: m of every part
    float* gl = gm + MAX_CLUSTER * RB;          // l of every part
    float* gw = gl + MAX_CLUSTER * RB;          // their weights e^(m_j − m)
    int* win = reinterpret_cast<int*>(gw + MAX_CLUSTER * RB);  // PAGED: [TW] page ids

    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
    const int hk = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
    const int rep = a.H / a.Hkv;
    const uint32_t ring = (uint32_t)__cvta_generic_to_shared(smem);
    // PAGED: the page ids of table entries [w0, w0 + TW), clamped to
    // [0, P − 1]; the first window's loads go out before the length's, so
    // both are in flight together, and land in shared memory after it
    const int* tab = a.tables + (size_t)b * a.max_blocks;
    int w0 = 0;
    int wv[K::TW / NT > 0 ? K::TW / NT : 1];
    auto fetch_window = [&]() {
#pragma unroll
        for (int j = 0; j < K::TW / NT; ++j) {
            const int e = w0 + t + j * NT;
            wv[j] = e < a.max_blocks ? tab[e] : 0;
        }
    };
    auto store_window = [&]() {
#pragma unroll
        for (int j = 0; j < K::TW / NT; ++j) win[t + j * NT] = min(max(wv[j], 0), a.n_pages - 1);
    };
    if constexpr (PAGED) fetch_window();
    // a row's index in units of rows (times D·ES: its K/V bytes; as it is:
    // its I8 scale); PAGED through the window
    const size_t row0 = PAGED ? 0 : ((size_t)b * a.Hkv + hk) * a.S;  // dense row 0 of the pair
    auto row_index = [&](int row) -> size_t {
        if constexpr (PAGED) {
            const int pg = row / a.ps;
            return ((size_t)win[pg - w0] * a.Hkv + hk) * a.ps + (row - pg * a.ps);
        } else {
            return row0 + row;
        }
    };
    const unsigned char* kb = static_cast<const unsigned char*>(a.k) + row0 * (D * K::ES);
    const unsigned char* vb = static_cast<const unsigned char*>(a.v) + row0 * (D * K::ES);
    auto load = [&](int r0, int rows, int stage) {  // rows [r0, r0 + rows) into a stage
        const uint32_t dst = ring + stage * K::STAGE;
        if constexpr (PAGED) {
            // move the window where this tile's pages leave it (uniform
            // across the block: every thread is done with the old window)
            const int p0 = r0 / a.ps, p1 = (r0 + rows - 1) / a.ps;
            if (p0 < w0 || p1 >= w0 + K::TW) {
                __syncthreads();
                w0 = p0;
                fetch_window();
                store_window();
                __syncthreads();
            }
        }
        for (int i = t; i < rows * K::CPR; i += NT) {
            const int r = i / K::CPR, c = i % K::CPR;
            size_t off;
            if constexpr (PAGED) {
                off = row_index(r0 + r) * (D * K::ES) + c * 16;
            } else {
                off = (size_t)(r0 + r) * (D * K::ES) + c * 16;
            }
            const uint32_t so = r * K::STRIDE + c * 16;
            cp_async16(dst + so, kb + off, true);
            cp_async16(dst + K::TILE + so, vb + off, true);
        }
        if constexpr (R == I8) {
            // the rows' K and V scales: row r at float (r − r0) + (r0 & 3) of
            // its array, so a group of 4 rows aligned to 4 (4g .. 4g + 3)
            // starts on 16 bytes: one 16-byte copy where the group lies in
            // the tile and in one page at a 16-byte-aligned scale address,
            // else a 4-byte copy per row of the tile
            const int gfirst = r0 >> 2, ng = ((r0 + rows - 1) >> 2) - gfirst + 1;
            for (int i = t; i < 2 * ng; i += NT) {
                const int ra = 4 * (gfirst + (i >> 1));
                const float* base = (i & 1) ? a.vd : a.kd;
                const uint32_t sd = dst + 2 * K::TILE + (i & 1) * K::SCL + 4 * (ra - 4 * gfirst);
                const size_t si = ra >= r0 ? row_index(ra) : 0;
                if (ra >= r0 && ra + 4 <= r0 + rows && si % 4 == 0 &&
                    (!PAGED || ra / a.ps == (ra + 3) / a.ps)) {
                    cp_async16(sd, base + si, true);
                } else {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        if (ra + e >= r0 && ra + e < r0 + rows) {
                            cp_async4(sd + 4 * e, base + row_index(ra + e));
                        }
                    }
                }
            }
        }
    };
    // with no SWA starts a dense rank 0's part begins at row 0 whatever the
    // length: its first tile goes out before the length is read (rows past
    // it are loaded and never used)
    const bool early = !PAGED && a.starts == nullptr && rank == 0;
    if (early) {
        load(0, min(T, a.S), 0);
        cp_async_commit();
    }

    // the valid span [st, len); one tile or less is folded by rank 0 alone
    // (solo: it writes out itself, no merge); longer ones are cut into C
    // parts
    const int len = min(a.lengths[b], a.S);
    const int st = a.starts ? max(a.starts[b], 0) : 0;
    const int span = max(len - st, 0);
    const bool solo = span <= T;
    if constexpr (PAGED) store_window();
    if (solo && rank > 0) return;
    if (!solo) {
        // the merge's mbarrier: one arrival (here), and the bytes every block
        // of the cluster will push: its slice of the sums (rep·D / C floats)
        // and its (m, l) of every head
        if (t == 0) {
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(mbar));
            asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
            asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                         ::"r"(mbar), "r"(4 * (rep * D + 2 * rep * C)) : "memory");
        }
        cluster_arrive_relaxed();  // this block runs, its mbarrier is set (waited for before any push)
    }

    // scores: this lane's chunks sub + LPR·i of its rows, q of every head
    // (loaded first, so their latency hides behind the lengths' and rows')
    const int sub = t % K::LPR, rslot = t / K::LPR;
    float qv[RB][K::DQ];
#pragma unroll
    for (int h = 0; h < RB; ++h) {
        const float* qh = a.q + ((size_t)b * a.H + hk * rep + h) * D;
#pragma unroll
        for (int i = 0; i < K::NCH; ++i) {
#pragma unroll
            for (int e = 0; e < K::CD; e += 4) {
                float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
                const int dim = (sub + K::LPR * i) * K::CD + e;
                if (h < rep) x = *reinterpret_cast<const float4*>(qh + dim);
                qv[h][i * K::CD + e] = x.x * a.scale;
                qv[h][i * K::CD + e + 1] = x.y * a.scale;
                qv[h][i * K::CD + e + 2] = x.z * a.scale;
                qv[h][i * K::CD + e + 3] = x.w * a.scale;
            }
        }
    }

    // this block's part of the span
    const int part = solo ? span : (span + C - 1) / C;
    const int lo = st + rank * part;
    const int nrows = max(min(lo + part, len) - lo, 0);
    const int ntiles = (nrows + T - 1) / T;
    if constexpr (PAGED) __syncthreads();  // the first window is in

    if (t < RB) {
        sm_m[t] = -INFINITY;
        sm_l[t] = 0.f;
        sm_a[t] = 1.f;
    }
    for (int i = t; i < RB * T; i += NT) {
        if (i / T >= rep) sc[i] = 0.f;  // heads past rep: p = 0, never rewritten
    }

    auto issue = [&](int tile) {  // tile `tile` of the part into its stage
        if (tile < ntiles) load(lo + tile * T, min(T, nrows - tile * T), tile % K::STAGES);
        cp_async_commit();  // an empty group where nothing is left keeps the count
    };

    // p·V: dims D0·td.. and D0·td + D1.. of heads hg·HPT.., rows rg, rg + RG, ...
    const int td = t % K::DT, hg = (t / K::DT) % K::HG, rg = t / K::DT / K::HG;
    float acc[K::HPT][8];
#pragma unroll
    for (int h = 0; h < K::HPT; ++h) {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[h][e] = 0.f;
    }

    for (int s = early ? 1 : 0; s < K::STAGES - 1; ++s) issue(s);
    for (int tile = 0; tile < ntiles; ++tile) {
        cp_async_wait<K::STAGES - 2>();
        __syncthreads();  // tile is in; every thread is done with tile − 1
        issue(tile + K::STAGES - 1);
        const unsigned char* ks = smem + (tile % K::STAGES) * K::STAGE;
        const unsigned char* vs = ks + K::TILE;
        const int n = min(T, nrows - tile * T);
        // I8: the tile's row scales (its first row lo + tile·T ≡ lo mod 4)
        const float* kds = reinterpret_cast<const float*>(ks + 2 * K::TILE) + (lo & 3);
        const float* vds = kds + K::SCL / 4;

        // (1) scores; rows past n hold stale bytes: computed, never stored.
        // A pass past n is skipped by the whole block.
#pragma unroll
        for (int pass = 0; pass < T / K::P; ++pass) {
            if (K::P * pass >= n) break;
            const int row = rslot + K::P * pass;
            float s[RB];
#pragma unroll
            for (int h = 0; h < RB; ++h) s[h] = 0.f;
#pragma unroll
            for (int i = 0; i < K::NCH; ++i) {
                float kf[K::CD];
                cvt_chunk<R>(ks + row * K::STRIDE + (sub + K::LPR * i) * K::CB, kf);
#pragma unroll
                for (int h = 0; h < RB; ++h) {
#pragma unroll
                    for (int e = 0; e < K::CD; ++e) {
                        s[h] = fmaf(qv[h][i * K::CD + e], kf[e], s[h]);
                    }
                }
            }
            // sum over the row's LPR lanes (RB ≤ LPR): the first log2(RB)
            // steps halve the heads a lane keeps (lane bit o picks the upper
            // half) and trade the other half with lane ^ o, the last steps are
            // plain butterflies; lane sub ends with head sub / G's score
#pragma unroll
            for (int step = 0; step < K::LOG2RB; ++step) {
                const int k = RB >> step, o = K::LPR >> (step + 1);
                const bool up = sub & o;
#pragma unroll
                for (int i = 0; i < k / 2; ++i) {
                    const float keep = up ? s[i + k / 2] : s[i];
                    const float give = up ? s[i] : s[i + k / 2];
                    s[i] = keep + __shfl_xor_sync(0xffffffffu, give, o);
                }
            }
#pragma unroll
            for (int o = K::G / 2; o > 0; o >>= 1) s[0] += __shfl_xor_sync(0xffffffffu, s[0], o);
            if (row < n && sub % K::G == 0 && sub / K::G < rep) {
                float x = s[0];
                if constexpr (R == I8) x *= kds[row];
                if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
                sc[(sub / K::G) * T + row] = x;
            }
        }
        __syncthreads();

        // (2) one max and one rescale per head and tile; a lane takes rows
        // lane, lane + 32, ...
        const int w = t >> 5, lane = t & 31;
        for (int h = w; h < rep; h += NT / 32) {
            float x[T / 32], mt = -INFINITY;
#pragma unroll
            for (int i = 0; i < T / 32; ++i) {
                x[i] = lane + 32 * i < n ? sc[h * T + lane + 32 * i] : -INFINITY;
                mt = fmaxf(mt, x[i]);
            }
            const float m_old = sm_m[h];
            const float m_new = fmaxf(m_old, warp_max(mt));
            float ps = 0.f;
#pragma unroll
            for (int i = 0; i < T / 32; ++i) {
                x[i] = lane + 32 * i < n ? expf(x[i] - m_new) : 0.f;
                ps += x[i];
            }
            ps = warp_sum(ps);  // every lane has read sm_m[h]
            // I8 stores p · vd[row]: the value term's row scale (l sums p)
#pragma unroll
            for (int i = 0; i < T / 32; ++i) {
                if constexpr (R == I8) {
                    sc[h * T + lane + 32 * i] = lane + 32 * i < n ? x[i] * vds[lane + 32 * i] : 0.f;
                } else {
                    sc[h * T + lane + 32 * i] = x[i];
                }
            }
            if (lane == 0) {
                const float alpha = expf(m_old - m_new);  // m_old = −inf → 0
                sm_a[h] = alpha;
                sm_l[h] = sm_l[h] * alpha + ps;
                sm_m[h] = m_new;
            }
        }
        __syncthreads();

        // (3) acc = acc·alpha + p·V
#pragma unroll
        for (int h = 0; h < K::HPT; ++h) {
            const float al = sm_a[hg * K::HPT + h];
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[h][e] *= al;
        }
#pragma unroll 2
        for (int row = rg; row < n; row += K::RG) {
            float vf[8];
            if constexpr (R == I8) {
                const uint2 u = *reinterpret_cast<const uint2*>(vs + row * K::STRIDE + 8 * td);
                s8x4(u.x, vf);
                s8x4(u.y, vf + 4);
            } else {
                ld4<R>(vs + row * K::STRIDE + 4 * td * K::ES, vf);
                ld4<R>(vs + row * K::STRIDE + (D / 2 + 4 * td) * K::ES, vf + 4);
            }
#pragma unroll
            for (int h = 0; h < K::HPT; ++h) {
                const float p = sc[(hg * K::HPT + h) * T + row];
#pragma unroll
                for (int e = 0; e < 8; ++e) acc[h][e] = fmaf(p, vf[e], acc[h][e]);
            }
        }
    }
    cp_async_wait<0>();
    __syncthreads();

    // the row groups' sums → sums[0 .. rep·D) (the ring is free now)
    float* sums = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int h = 0; h < K::HPT; ++h) {
        float* o = sums + (size_t)(rg * RB + hg * K::HPT + h) * D + K::D0 * td;
        *reinterpret_cast<float4*>(o) = make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
        *reinterpret_cast<float4*>(o + K::D1) =
            make_float4(acc[h][4], acc[h][5], acc[h][6], acc[h][7]);
    }
    __syncthreads();

    float* o = a.out + ((size_t)b * a.H + hk * rep) * D;
    if (solo) {
        for (int e = t; e < rep * D; e += NT) {
            float s = 0.f;
#pragma unroll
            for (int g = 0; g < K::RG; ++g) s += sums[g * RB * D + e];
            o[e] = s / fmaxf(sm_l[e / D], 1e-30f);
        }
        return;
    }

    // the merge: rank r owns outputs [r·SL, (r + 1)·SL), SL = rep·D / C
    // (rep·D is a multiple of 128). Every block pushes its (m, l) to every
    // rank and each slice of its sums to the slice's owner (st.async, counted
    // by the owner's mbarrier); each rank waits for its own bytes only, then
    // merges its slice by log-sum-exp and writes out. No block reads
    // another's memory, so none waits for the others before it leaves.
    const int sl = rep * D / C;
    cluster_wait();  // every block of the cluster runs, its mbarrier is set
    for (int i = t; i < C * rep; i += NT) {
        const int j = i / rep, h = i % rep;
        const uint32_t mb = cluster_addr(mbar, j);
        push(cluster_addr((uint32_t)__cvta_generic_to_shared(gm + rank * RB + h), j), sm_m[h], mb);
        push(cluster_addr((uint32_t)__cvta_generic_to_shared(gl + rank * RB + h), j), sm_l[h], mb);
    }
    for (int e = t; e < rep * D; e += NT) {
        float s = 0.f;
#pragma unroll
        for (int g = 0; g < K::RG; ++g) s += sums[g * RB * D + e];
        const int j = e / sl;
        push(cluster_addr((uint32_t)__cvta_generic_to_shared(recv + rank * sl + e - j * sl), j),
             s, cluster_addr(mbar, j));
    }
    // every part's bytes have landed here (a count that never completes is
    // a fault: trap rather than hang)
    for (int spin = 0; !mbar_try_wait(mbar, 0); ++spin) {
        if (spin > (1 << 22)) __trap();
    }
    for (int i = t; i < C * rep; i += NT) {
        const int j = i / rep, h = i % rep;
        float mm = -INFINITY;
        for (int u = 0; u < C; ++u) mm = fmaxf(mm, gm[u * RB + h]);
        const float mj = gm[j * RB + h];
        gw[j * RB + h] = mj == -INFINITY ? 0.f : expf(mj - mm);  // an empty part: 0
    }
    __syncthreads();
    for (int e = rank * sl + t; e < (rank + 1) * sl; e += NT) {
        const int h = e / D;
        float ll = 0.f, aa = 0.f;
#pragma unroll
        for (int j = 0; j < MAX_CLUSTER; ++j) {
            if (j < C) {
                const float wj = gw[j * RB + h];
                ll += gl[j * RB + h] * wj;
                aa += recv[j * sl + e - rank * sl] * wj;
            }
        }
        o[e] = aa / fmaxf(ll, 1e-30f);
    }
}

template <int R, int D, int RB, bool PAGED>
int launch(const Args& a, int B, int cluster, cudaStream_t st) {
    using K = Cfg<R, D, RB, PAGED>;
    void (*kern)(const Args) = flash_decode_gqa<R, D, RB, PAGED>;
    struct Setup {
        int err, sms;
        bool fits16;
    };
    // once per instantiation: opt in to its shared memory and to 16-block
    // clusters, and ask whether a 16-block cluster of it fits on this card
    static const Setup setup = [kern] {
        Setup s{0, 0, false};
        int dev = 0, n = 0;
        cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             K::SMEM);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e == cudaSuccess) e = cudaGetDevice(&dev);
        if (e == cudaSuccess) {
            e = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev);
        }
        if (e == cudaSuccess) {
            cudaLaunchAttribute at;
            at.id = cudaLaunchAttributeClusterDimension;
            at.val.clusterDim.x = MAX_CLUSTER;
            at.val.clusterDim.y = 1;
            at.val.clusterDim.z = 1;
            cudaLaunchConfig_t cfg = {};
            cfg.gridDim = dim3(MAX_CLUSTER, 1, 1);
            cfg.blockDim = dim3(NT, 1, 1);
            cfg.dynamicSmemBytes = K::SMEM;
            cfg.attrs = &at;
            cfg.numAttrs = 1;
            s.fits16 = cudaOccupancyMaxActiveClusters(&n, kern, &cfg) == cudaSuccess && n > 0;
            cudaGetLastError();  // a size that does not fit is an answer, not a fault
        }
        s.err = (int)e;
        return s;
    }();
    if (setup.err) return setup.err;
    // 16 blocks a pair where 16 fit and 8 leave SMs idle, and either a part
    // of 8 could hold more than a tile or 8 fill under a quarter of the
    // SMs: a short span at 16 pays ~0.6 µs more for its idle blocks
    // (PERF.md §6)
    int c = cluster;
    if (c == 0) {
        const int blocks8 = 8 * a.Hkv * B;
        c = setup.fits16 && blocks8 < setup.sms && (a.S > 8 * K::T || 4 * blocks8 <= setup.sms)
                ? MAX_CLUSTER
                : 8;
    }
    if (c != 8 && !(c == MAX_CLUSTER && setup.fits16)) return (int)cudaErrorInvalidValue;

    cudaLaunchAttribute at;
    at.id = cudaLaunchAttributeClusterDimension;
    at.val.clusterDim.x = c;
    at.val.clusterDim.y = 1;
    at.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c, a.Hkv, B);
    cfg.blockDim = dim3(NT, 1, 1);
    cfg.dynamicSmemBytes = K::SMEM;
    cfg.stream = st;
    cfg.attrs = &at;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

template <int R, int D, bool PAGED>
int launch_rep(const Args& a, int B, int cluster, cudaStream_t st) {
    const int rep = a.H / a.Hkv;
    if (rep <= 1) return launch<R, D, 1, PAGED>(a, B, cluster, st);
    if (rep <= 2) return launch<R, D, 2, PAGED>(a, B, cluster, st);
    if (rep <= 4) return launch<R, D, 4, PAGED>(a, B, cluster, st);
    if (rep <= 8) return launch<R, D, 8, PAGED>(a, B, cluster, st);
    if (rep <= 16) return launch<R, D, 16, PAGED>(a, B, cluster, st);
    return (int)cudaErrorInvalidValue;
}

// rows of type R from source PAGED: D 128 or 256; cluster 8, 16 or 0
// (choose)
template <int R, bool PAGED = false>
int launch_row(const Args& a, int B, int D, int cluster, cudaStream_t st) {
    switch (D) {
        case 128: return launch_rep<R, 128, PAGED>(a, B, cluster, st);
        case 256: return launch_rep<R, 256, PAGED>(a, B, cluster, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace gqa
