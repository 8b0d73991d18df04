// GQA flash attention for bfloat16 inputs on the tensor cores (sm_90a),
// in the FlashAttention-2 style: warp-level mma.sync products with fp32
// accumulation, K/V tiles multi-buffered by cp.async, the probabilities
// kept in registers. flash.cu includes this header after struct
// FlashParams, and flash_attention_launch sends every bfloat16 call here.
//
// Same function as flash.cu's float32 kernel (and the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention it
// replaces): out = softmax(q k^T * scale + mask) v per (batch, query
// head), query head h reading KV head h / (Hq / Hkv), the causal mask with
// q at the cache tail (offset Sk - Sq), an optional sliding window, ragged
// Sq and Sk. Numerics: the scores, the online softmax (2^x on the
// special-function unit, scale * log2(e) folded in) and every sum are
// fp32; P is rounded to bf16 before the PV product, as the reference
// model's attention rounds its probabilities to v's type
// (src/repro/models/attention.py:83); the output is rounded to bf16
// once. A row with no visible key keeps l = 0 and gives exactly 0, as
// attention_ref does.
//
// What bounds it on this card: operations, 4 d per visible (query, key)
// pair, against the bf16 tensor-core rate; at the serving shapes moving
// q, k, v and out once takes a half to a third of that time.
//
// Design. One block of 4 warps (128 threads) per (64-row q tile, query
// head, batch); q tiles are walked heaviest first (blockIdx.x 0 takes the
// last tile, which sees the most keys under the causal mask). Each warp
// owns 16 query rows. Q, K and V tiles land in shared memory through
// 16-byte cp.async.cg, rows padded by 8 elements so that the 8 rows an
// ldmatrix phase reads fall in distinct banks; rows past Sq / Sk are
// zero-filled (src-size 0). K and V are in two or three stages: tiles
// j + 1 (and j + 2) are in flight while tile j is multiplied, behind one
// barrier a tile. S = Q K^T is mma.sync m16n8k16 on ldmatrix.x4
// fragments of Q (held in registers for the whole K loop at d <= 128,
// read from shared memory per tile at d = 256) and of K. The
// fp32 S accumulator becomes P in registers: the m16n8 C fragment of two
// neighbouring 8-key blocks is the A fragment of an m16n8k16 product, so P
// is packed to bf16 pairs and multiplied with V fragments from
// ldmatrix.x4.trans. Each thread holds two rows of its warp's 16, so a
// row's max is two shuffles inside its quad; its sum stays a per-thread
// partial until the end. Whole K tiles outside the causal / window
// predicate are never visited; the per-element mask runs only on tiles
// that the diagonal, the window edge or Sk crosses.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash_mma {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;   // q rows of a block, 16 a warp
constexpr int PAD = 8;           // bf16 elements of padding per tile row
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared; with valid false the 16 bytes are zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
    const int n = valid ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}

// c (16x8 fp32) += a (16x16 bf16, row-major) * b (16x8 bf16, col-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                 "{%0, %1, %2, %3};\n"
                 : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
                   "r"(b0), "r"(b1));
}

// 2^x on the special-function unit; -inf gives 0, results under 2^-126
// flush to 0 (far below a bf16 probability's resolution next to 1)
__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// two floats rounded to nearest even; lo in the low half (lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// rows [r0, r0 + ROWS) of a (seq, HD) view with seq stride ss into a
// padded shared tile; rows at or past n are zero-filled
template <int ROWS, int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* base,
                                          long long ss, int r0, int n,
                                          int tid) {
    constexpr int CH = HD / 8;                 // 16-byte chunks a row
    static_assert(ROWS * CH % THREADS == 0, "tile chunks");
#pragma unroll
    for (int it = 0; it < ROWS * CH / THREADS; ++it) {
        const int i = tid + it * THREADS;
        const int r = i / CH, c = (i % CH) * 8;
        const bool ok = r0 + r < n;
        const __nv_bfloat16* src = ok ? base + (long long)(r0 + r) * ss + c
                                      : base;
        cp_async16(smem_u32(tile + r * (HD + PAD) + c), src, ok);
    }
}

template <int HD, int BK, int STAGES>
constexpr int smem_bytes() {   // Q, then K and V in STAGES stages each
    return (BQ + 2 * STAGES * BK) * (HD + PAD) * (int)sizeof(__nv_bfloat16);
}

template <int HD, int BK, int STAGES>
__global__ void __launch_bounds__(THREADS)
flash_mma_bf16(const FlashParams p, const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o) {
    constexpr int LD = HD + PAD;
    constexpr int KS = HD / 16;          // 16-deep steps of Q K^T
    constexpr int NS = BK / 8;           // 8-key blocks of a score tile
    constexpr int ND = HD / 8;           // 8-wide blocks of the output
    constexpr bool QREG = HD <= 128;     // Q fragments held in registers
    static_assert(HD % 16 == 0 && BK % 16 == 0 && STAGES >= 2, "tiles");
    extern __shared__ __align__(16) unsigned char smem_mma[];
    auto* Qs = reinterpret_cast<__nv_bfloat16*>(smem_mma);  // [BQ][LD]
    __nv_bfloat16* Ks = Qs + BQ * LD;              // [STAGES][BK][LD]
    __nv_bfloat16* Vs = Ks + STAGES * BK * LD;     // [STAGES][BK][LD]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, tig = lane & 3;   // mma fragment row / column
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest first
    const int h = blockIdx.y, b = blockIdx.z;
    const int hk = h / (p.Hq / p.Hkv);
    const int off = p.Sk - p.Sq;         // q positions sit at the cache tail

    const __nv_bfloat16* qb = q + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* kb = k + b * p.k_sb + hk * p.k_sh;
    const __nv_bfloat16* vb = v + b * p.v_sb + hk * p.v_sh;
    __nv_bfloat16* ob = o + b * p.o_sb + h * p.o_sh;

    // the K tiles the block predicate leaves: [kt_lo, kt_hi]
    const int q_first = q0 + off;
    const int q_last = min(q0 + BQ, p.Sq) - 1 + off;
    int kt_lo = 0, kt_hi = (p.Sk + BK - 1) / BK - 1;
    if (p.causal) {
        kt_hi = q_last < 0 ? -1 : min(kt_hi, q_last / BK);
        if (p.has_window && q_first - p.window + 1 > 0)
            kt_lo = (q_first - p.window + 1) / BK;
    }

    // each thread: rows g and g + 8 of its warp's 16, columns 2 tig, +1
    // of every 8-wide block
    float acc[ND][4];
#pragma unroll
    for (int j = 0; j < ND; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    if (kt_lo <= kt_hi) {
        const float sl2 = p.scale * LOG2E;
        const int qrow0 = q0 + warp * 16 + g + off;   // row g's position
        // Q, then the first STAGES - 1 K/V tiles, one copy group each
        load_tile<BQ, HD>(Qs, qb, p.q_ss, q0, p.Sq, tid);
        cp_async_commit();
#pragma unroll
        for (int i = 0; i < STAGES - 1; ++i) {
            if (kt_lo + i <= kt_hi) {
                load_tile<BK, HD>(Ks + i * BK * LD, kb, p.k_ss,
                                  (kt_lo + i) * BK, p.Sk, tid);
                load_tile<BK, HD>(Vs + i * BK * LD, vb, p.v_ss,
                                  (kt_lo + i) * BK, p.Sk, tid);
            }
            cp_async_commit();               // empty past kt_hi
        }

        // ldmatrix.x4 lane -> row address: Q (A operand), K (B, keys as
        // columns), V (B through .trans, keys as rows)
        const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
        const int a_col = (lane >> 4) * 8;
        const int k_row = (lane & 7) + (lane >> 4) * 8;
        const int k_col = ((lane >> 3) & 1) * 8;
        const __nv_bfloat16* Qw = Qs + (warp * 16 + a_row) * LD + a_col;

        uint32_t qf[QREG ? KS : 1][4];
        cp_async_wait<STAGES - 1>();         // Q has landed
        __syncthreads();
        if constexpr (QREG) {
#pragma unroll
            for (int ks = 0; ks < KS; ++ks)
                ldmatrix_x4(qf[ks], smem_u32(Qw + ks * 16));
        }

        int st = 0;                          // stage of tile kt
        for (int kt = kt_lo; kt <= kt_hi; ++kt) {
            cp_async_wait<STAGES - 2>();     // tile kt has landed ...
            __syncthreads();                 // ... for every thread, and
                                             // tile kt - 1 is read: refill
            const int nt = kt + STAGES - 1;  // its stage with tile nt
            const int ns = st == 0 ? STAGES - 1 : st - 1;
            if (nt <= kt_hi) {
                load_tile<BK, HD>(Ks + ns * BK * LD, kb, p.k_ss, nt * BK,
                                  p.Sk, tid);
                load_tile<BK, HD>(Vs + ns * BK * LD, vb, p.v_ss, nt * BK,
                                  p.Sk, tid);
            }
            cp_async_commit();               // empty past kt_hi
            const __nv_bfloat16* Kt = Ks + st * BK * LD;
            const __nv_bfloat16* Vt = Vs + st * BK * LD;
            st = st + 1 == STAGES ? 0 : st + 1;
            const int k0 = kt * BK;

            float s[NS][4];
#pragma unroll
            for (int j = 0; j < NS; ++j)
                s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
                uint32_t a[4];
                if constexpr (QREG) {
                    a[0] = qf[ks][0]; a[1] = qf[ks][1];
                    a[2] = qf[ks][2]; a[3] = qf[ks][3];
                } else {
                    ldmatrix_x4(a, smem_u32(Qw + ks * 16));
                }
#pragma unroll
                for (int j = 0; j < NS; j += 2) {
                    uint32_t r[4];
                    ldmatrix_x4(r, smem_u32(Kt + (j * 8 + k_row) * LD
                                            + ks * 16 + k_col));
                    mma_bf16(s[j], a, r[0], r[1]);
                    mma_bf16(s[j + 1], a, r[2], r[3]);
                }
            }

            // scale into the log2 domain; mask only where the tile is cut
            const bool edge =
                k0 + BK > p.Sk ||
                (p.causal && (k0 + BK - 1 > q_first ||
                              (p.has_window && k0 <= q_last - p.window)));
#pragma unroll
            for (int j = 0; j < NS; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float x = s[j][e] * sl2;
                    if (edge) {
                        const int qpos = qrow0 + (e >> 1) * 8;
                        const int kpos = k0 + j * 8 + 2 * tig + (e & 1);
                        bool ok = kpos < p.Sk;
                        if (p.causal) {
                            ok = ok && kpos <= qpos;
                            if (p.has_window)
                                ok = ok && qpos - kpos < p.window;
                        }
                        if (!ok) x = -INFINITY;
                    }
                    s[j][e] = x;
                }

            // online softmax, rows g (r = 0) and g + 8 (r = 1)
            float alpha[2], base[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                float mx = -INFINITY;
#pragma unroll
                for (int j = 0; j < NS; ++j)
                    mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
                const float mn = fmaxf(m[r], mx);
                // no visible key yet: subtract 0, so p = exp2(-inf) = 0
                base[r] = mn == -INFINITY ? 0.f : mn;
                alpha[r] = exp2_approx(m[r] - base[r]);  // 0 while m is -inf
                m[r] = mn;
            }
            float sum[2] = {0.f, 0.f};
#pragma unroll
            for (int j = 0; j < NS; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    s[j][e] = exp2_approx(s[j][e] - base[e >> 1]);
                    sum[e >> 1] += s[j][e];
                }
#pragma unroll
            for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
            for (int j = 0; j < ND; ++j) {
                acc[j][0] *= alpha[0]; acc[j][1] *= alpha[0];
                acc[j][2] *= alpha[1]; acc[j][3] *= alpha[1];
            }

            // O += P V: the C fragments of key blocks 2 kk, 2 kk + 1 are
            // the A fragment of 16 keys
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                const uint32_t a[4] = {
                    pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                    pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                    pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                    pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
                for (int j = 0; j < ND; j += 2) {
                    uint32_t r[4];
                    ldmatrix_x4_trans(r, smem_u32(Vt + (kk * 16 + a_row) * LD
                                                  + j * 8 + a_col));
                    mma_bf16(acc[j], a, r[0], r[1]);
                    mma_bf16(acc[j + 1], a, r[2], r[3]);
                }
            }
        }
    }

    // the row sums across the quad, then out = acc / l (0 where l = 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const float inv0 = l[0] > 0.f ? 1.f / l[0] : 0.f;
    const float inv1 = l[1] > 0.f ? 1.f / l[1] : 0.f;
    const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
        const int c = j * 8 + 2 * tig;
        if (r0 < p.Sq)
            *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r0 * p.o_ss + c)
                = __floats2bfloat162_rn(acc[j][0] * inv0, acc[j][1] * inv0);
        if (r1 < p.Sq)
            *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r1 * p.o_ss + c)
                = __floats2bfloat162_rn(acc[j][2] * inv1, acc[j][3] * inv1);
    }
}

template <int HD, int BK, int STAGES>
int launch(const FlashParams& p, const void* q, const void* k, const void* v,
           void* o, cudaStream_t stream) {
    constexpr int bytes = smem_bytes<HD, BK, STAGES>();
    auto kern = flash_mma_bf16<HD, BK, STAGES>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
    kern<<<grid, THREADS, bytes, stream>>>(
        p, static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o));
    return (int)cudaGetLastError();
}

// Tiles per head dim: Q 64 x d, K/V tiles of 64 keys in three stages at
// d <= 64 (36 KB, 65 KB of shared memory: three blocks an SM, and a second
// tile in flight helps the short grids of a few queries) and in two
// stages at d 128 (87 KB). At d 256 the output accumulator alone takes
// 128 registers a thread and K tiles of 64 spill (ptxas: 255 registers,
// 56 bytes), so d 256 takes K tiles of 32 in two stages (101 KB).
inline int dispatch(const FlashParams& p, const void* q, const void* k,
                    const void* v, void* o, cudaStream_t s) {
    switch (p.d) {
        case 32: return launch<32, 64, 3>(p, q, k, v, o, s);
        case 64: return launch<64, 64, 3>(p, q, k, v, o, s);
        case 128: return launch<128, 64, 2>(p, q, k, v, o, s);
        case 256: return launch<256, 32, 2>(p, q, k, v, o, s);
        default: return -1;
    }
}

}  // namespace flash_mma
