// GQA flash attention (causal, sliding window, q at the cache tail) for
// sm_90a: float32 inputs on the CUDA cores (this file's kernel), bfloat16
// inputs on the tensor cores (flash_mma.cuh). One kernel per dtype.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention (body
// _flash_kernel). Same function: out = softmax(q k^T * scale + mask) v per
// (batch, query head), query head h reading KV head h / (Hq / Hkv), the
// causal mask with q at the tail of the keys (offset Sk - Sq) and an
// optional sliding window; the output in the inputs' type. Float32 inputs:
// every product and sum in float32 on the CUDA cores (no TF32, bf16 or
// 3xTF32 tensor-core products: the reference tolerance for float32 is
// 2e-6). Bfloat16 inputs: products on the tensor cores with float32
// accumulation, softmax and sums in float32, the probabilities rounded to
// bfloat16 before the PV product (flash_mma.cuh).
//
// What bounds it on this card: attention is 4 * Sq * Sk * d operations
// per (batch, head) pair against (Sq + 2 Sk + Sq) * d elements moved, so
// at the serving shapes it is bound by operations, not bytes. The float32
// kernel's ceiling is the float32 CUDA-core rate (one FFMA a lane a clock).
// So the design keeps the FMA pipe fed: few instructions besides FFMA.
//
// Design of the float32 kernel (flash_kernel<HD>), the SGEMM craft:
//  * Register micro-tiles fed by 16-byte shared loads. Q, K and V tiles are
//    row-major in shared memory, rows padded by 4 floats (16-byte aligned,
//    and neighbouring rows start in neighbouring 16-byte bank groups). The
//    256 threads are RG row groups x CG column lanes; thread (ty, tx) owns
//    query rows ty + RG i (i < TR), keys tx + CG j (j < TC) of a score tile
//    and output columns 4 tx + 4 CG jj (jj < TD) as float4s. A step of 4
//    along d reads TR float4s of Q and TC of K for 4 TR TC FFMAs. The
//    probabilities go to shared memory transposed (P^T, [BK][BQ + 4], the
//    thread's TR rows side by side), so the PV product reads TR / 4
//    float4s of P and TD of V per key for 4 TR TD FFMAs. The CG lanes of a
//    row are one half-warp (or quarter), so row maxima and sums are
//    shuffles; a row's running max and sum wait in shared memory between
//    tiles, which keeps the registers for the micro-tiles (no spill).
//  * cp.async for Q, K and V (16-byte cp.async.cg, rows past Sq / Sk
//    zero-filled): one K buffer and one V buffer form a two-slot ring
//    over the sequence K0, V0, K1, V1, ...: V[j] is copied while S = Q K[j]^T
//    and the softmax run, K[j + 1] while O += P V[j] runs. The ring rides on
//    the two barriers a tile that P^T needs anyway (written by one thread,
//    read by another), and it keeps shared memory to one tile of each, so
//    two blocks (16 warps) fit an SM at d <= 128.
//  * Whole K tiles outside the causal / window predicate are never
//    visited; the element mask runs only on tiles that the diagonal, the
//    window edge or Sk crosses. Scores stay raw until the softmax, which
//    takes 2^(s * scale * log2 e - m) with one FFMA and one MUFU.EX2 (m
//    kept in that base-2 domain). Masked scores give p = 0, so a row with
//    no visible key keeps l = 0 and gives exactly 0, as attention_ref
//    does.
//  * Blocks are ranked q tile first, heaviest q tile first (under the
//    causal mask the last q tile sees the most keys), so the light tiles
//    fill the tail of the grid.
//  * Split-KV for short grids (kernel.py::flash_plan): with n_split > 1
//    each (q tile, head, batch) gets n_split blocks, block s taking the
//    s-th contiguous share of the visible K tiles. Each writes its
//    (m, l, acc) to a float32 scratch, takes a ticket of its q tile (one
//    int32 a tile, in a scratch that the wrapper keeps per device and
//    stream and that the kernel leaves zero), and the last block combines
//    the partials in split order. One launch a call; the outputs are
//    bit-identical from call to call.
// Tiles per head dim (Tiles<HD> below, mirrored by kernel.py's
// F32_TILES): shared memory of 46 KB (d 32), 104 KB (d 64), 77 KB (d 128)
// and 218 KB (d 256). At d 256 a 64-row Q tile and a 64-key K tile take
// 1 KB a row each, so one block (8 warps) fits an SM; smaller tiles would
// halve the FFMAs per shared load.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

struct FlashParams {            // mirrored by _FlashParams in kernel.py
    int B, Hq, Hkv, Sq, Sk, d;
    int causal, has_window, window;
    float scale;
    long long q_sb, q_sh, q_ss;   // element strides: batch, head, seq
    long long k_sb, k_sh, k_ss;
    long long v_sb, v_sh, v_ss;
    long long o_sb, o_sh, o_ss;
    int bf16;                     // 0: float32 tensors, 1: bfloat16
    // float32 kernel only: blocks a (q tile, head, batch); with n_split > 1
    // the splits' (m, l, acc) scratch and the q tiles' tickets (zero)
    int n_split;
    float* partials;
    int* tickets;
};

#include "flash_mma.cuh"          // the bfloat16 kernel (tensor cores)

namespace {

constexpr int THREADS = 256;
constexpr int PAD = 4;            // floats of padding a shared row
constexpr double LOG2E = 1.4426950408889634;

// CG column lanes (so 256 / CG row groups), TR rows and TC score columns
// a thread, and the blocks an SM the launch bounds promise
template <int CG_, int TR_, int TC_, int MIN_BLOCKS_>
struct TileShape {
    static constexpr int CG = CG_, RG = THREADS / CG_, TR = TR_, TC = TC_;
    static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
};
template <int HD> struct Tiles;
template <> struct Tiles<32> : TileShape<8, 4, 4, 2> {};
template <> struct Tiles<64> : TileShape<16, 8, 4, 2> {};
template <> struct Tiles<128> : TileShape<16, 4, 2, 2> {};
template <> struct Tiles<256> : TileShape<16, 4, 4, 1> {};

// Steps of 4 along d that the score loop unrolls: at d 64 the 8 x 4
// scores and the 8 x 4 accumulators fill the 128 registers that two
// blocks an SM leave a thread, and a deeper unroll spills
template <int HD>
__host__ __device__ constexpr int score_unroll() { return HD == 64 ? 1 : 4; }

template <int HD>
struct Cfg : Tiles<HD> {
    using T = Tiles<HD>;
    static constexpr int BQ = T::RG * T::TR;   // q rows of a block
    static constexpr int BK = T::CG * T::TC;   // keys of a K tile
    static constexpr int TD = HD / (4 * T::CG);   // float4 output columns
    static constexpr int LQ = HD + PAD;        // row stride of Q, K, V
    static constexpr int LP = BQ + PAD;        // row stride of P^T
    static constexpr int SMEM_FLOATS =
        BQ * LQ + 2 * BK * LQ + BK * LP + 2 * BQ;
    static_assert(TD >= 1 && T::TR % 4 == 0 && HD % 32 == 0, "tiles");
};

// A tile copy: thread t copies the 16-byte chunk t % (HD / 4) of the
// tile's rows t / (HD / 4) + RPI x for x = 0, 1, ... (RPI rows a pass).
// ``dst`` (shared) and ``src`` (global) address the thread's first chunk,
// ``row`` is that chunk's row in the view; rows at or past n are
// zero-filled (``safe``, any valid address, stands in for their source).
template <int ROWS, int HD>
__device__ __forceinline__ void load_rows(uint32_t dst, const float* src,
                                          long long ss, int row, int n,
                                          const float* safe) {
    constexpr int RPI = THREADS / (HD / 4);
    static_assert(THREADS % (HD / 4) == 0 && ROWS % RPI == 0, "tile copy");
#pragma unroll
    for (int x = 0; x < ROWS / RPI; ++x) {
        const bool ok = row + x * RPI < n;
        flash_mma::cp_async16(dst + x * RPI * (HD + PAD) * 4,
                              ok ? src + x * RPI * ss : safe, ok);
    }
}

// The visible K tiles [lo, hi] of q tile qt (hi < lo: none), as
// kernel.py::FlashPlan.k_tiles computes them
template <int BQ, int BK>
__device__ __forceinline__ void visible_tiles(const FlashParams& p, int qt,
                                              int& lo, int& hi) {
    const int off = p.Sk - p.Sq;
    const int q_first = qt * BQ + off;
    const int q_last = min(qt * BQ + BQ, p.Sq) - 1 + off;
    lo = 0;
    hi = (p.Sk + BK - 1) / BK - 1;
    if (p.causal) {
        hi = q_last < 0 ? -1 : min(hi, q_last / BK);
        if (p.has_window && q_first - p.window + 1 > 0)
            lo = (q_first - p.window + 1) / BK;
    }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, Tiles<HD>::MIN_BLOCKS)
flash_kernel(const FlashParams p, const float* __restrict__ q,
             const float* __restrict__ k, const float* __restrict__ v,
             float* __restrict__ o) {
    using C = Cfg<HD>;
    constexpr int BQ = C::BQ, BK = C::BK, TR = C::TR, TC = C::TC;
    constexpr int TD = C::TD, RG = C::RG, CG = C::CG;
    constexpr int LQ = C::LQ, LP = C::LP;
    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;              // [BQ][LQ]
    float* Ks = Qs + BQ * LQ;      // [BK][LQ]
    float* Vs = Ks + BK * LQ;      // [BK][LQ]
    float* Pt = Vs + BK * LQ;      // [BK][LP]: row ty + RG i at ty TR + i
    float* Ms = Pt + BK * LP;      // [BQ] the rows' running max (base 2)
    float* Ls = Ms + BQ;           // [BQ] and sum, at ty TR + i too
    // what the K loop and the epilogue need of the block map, kept here
    // rather than in registers: the K and V head views, the output rows,
    // the split's slot, the q tile's ticket
    __shared__ struct {
        const float* kh;
        const float* vh;
        float* out;
        float* slot;
        const float* first;
        int* ticket;
        int last;
    } blk;

    const int tid = threadIdx.x, ty = tid / CG, tx = tid % CG;
    // block -> (q tile, split, head, batch): q tiles slowest, the heaviest
    // (last) first; a tile's splits side by side
    const int nqt = (p.Sq + BQ - 1) / BQ;
    const int per_tile = p.n_split * p.Hq * p.B;
    const int qt = nqt - 1 - (int)(blockIdx.x / per_tile);
    const int rank = (int)(blockIdx.x % per_tile);
    const int split = rank % p.n_split;
    const int item = rank / p.n_split;           // head + Hq * batch
    const int h = item % p.Hq, b = item / p.Hq;
    const int hk = h / (p.Hq / p.Hkv);
    const int off = p.Sk - p.Sq;                 // q at the cache tail
    const int q0 = qt * BQ;
    constexpr int SLOT = BQ * (HD + 2);          // floats of a split's slot
    const long long tile_id = (long long)qt * p.Hq * p.B + item;
    if (tid == 0) {
        blk.kh = k + b * p.k_sb + hk * p.k_sh;
        blk.vh = v + b * p.v_sb + hk * p.v_sh;
        blk.out = o + b * p.o_sb + h * p.o_sh + (long long)q0 * p.o_ss;
        blk.first = p.partials + tile_id * p.n_split * SLOT;
        blk.slot = p.partials + (tile_id * p.n_split + split) * SLOT;
        blk.ticket = p.tickets + tile_id;
    }

    // the thread's chunk of every tile copy: row lr, column lc
    const int lr = tid / (HD / 4), lc = tid % (HD / 4) * 4;
    const float* qb = q + b * p.q_sb + h * p.q_sh + lr * p.q_ss + lc;
    const uint32_t Qd = flash_mma::smem_u32(Qs + lr * LQ + lc);
    const uint32_t Kd = flash_mma::smem_u32(Ks + lr * LQ + lc);
    const uint32_t Vd = flash_mma::smem_u32(Vs + lr * LQ + lc);

    int lo, hi;
    visible_tiles<BQ, BK>(p, qt, lo, hi);
    const int n = max(hi - lo + 1, 0);
    const int kt_lo = lo + split * n / p.n_split;
    const int kt_hi = lo + (split + 1) * n / p.n_split - 1;
    const int q_first = q0 + off;
    const int q_last = min(q0 + BQ, p.Sq) - 1 + off;

    // a row's max and sum live in shared memory (out of the registers
    // that the products need), written by the row's lane 0
    float4 acc[TR][TD];
#pragma unroll
    for (int i = 0; i < TR; ++i) {
        if (tx == 0) {
            Ms[ty * TR + i] = -INFINITY;
            Ls[ty * TR + i] = 0.f;
        }
#pragma unroll
        for (int jj = 0; jj < TD; ++jj) acc[i][jj] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

    if (kt_lo <= kt_hi) {
        const float sl2 = (float)((double)p.scale * LOG2E);
        load_rows<BQ, HD>(Qd, qb + q0 * p.q_ss, p.q_ss, q0 + lr, p.Sq, q);
        load_rows<BK, HD>(Kd, k + b * p.k_sb + hk * p.k_sh
                                  + (kt_lo * BK + lr) * p.k_ss + lc,
                          p.k_ss, kt_lo * BK + lr, p.Sk, k);
        flash_mma::cp_async_commit();
        for (int kt = kt_lo; kt <= kt_hi; ++kt) {
            const int k0 = kt * BK;
            flash_mma::cp_async_wait<0>();   // K tile kt (and Q) landed ...
            __syncthreads();                 // ... for all; last PV done
            load_rows<BK, HD>(Vd, blk.vh + (k0 + lr) * p.v_ss + lc, p.v_ss,
                              k0 + lr, p.Sk, v);
            flash_mma::cp_async_commit();

            // S = Q K^T, a TR x TC micro-tile a thread, 4 along d a step
            float s[TR][TC];
#pragma unroll
            for (int i = 0; i < TR; ++i)
#pragma unroll
                for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
#pragma unroll (score_unroll<HD>())
            for (int dd = 0; dd < HD; dd += 4) {
                float4 kf[TC];
#pragma unroll
                for (int j = 0; j < TC; ++j)
                    kf[j] = *reinterpret_cast<const float4*>(
                        Ks + (tx + CG * j) * LQ + dd);
#pragma unroll
                for (int i = 0; i < TR; ++i) {
                    const float4 qf = *reinterpret_cast<const float4*>(
                        Qs + (ty + RG * i) * LQ + dd);
#pragma unroll
                    for (int j = 0; j < TC; ++j) {
                        s[i][j] = fmaf(qf.x, kf[j].x, s[i][j]);
                        s[i][j] = fmaf(qf.y, kf[j].y, s[i][j]);
                        s[i][j] = fmaf(qf.z, kf[j].z, s[i][j]);
                        s[i][j] = fmaf(qf.w, kf[j].w, s[i][j]);
                    }
                }
            }

            // the element mask, only where the tile is cut
            const bool edge =
                k0 + BK > p.Sk ||
                (p.causal && (k0 + BK - 1 > q_first ||
                              (p.has_window && k0 <= q_last - p.window)));
            if (edge) {
#pragma unroll
                for (int i = 0; i < TR; ++i) {
                    const int qpos = q0 + ty + RG * i + off;
#pragma unroll
                    for (int j = 0; j < TC; ++j) {
                        const int kpos = k0 + tx + CG * j;
                        bool ok = kpos < p.Sk;
                        if (p.causal) {
                            ok = ok && kpos <= qpos;
                            if (p.has_window) ok = ok && qpos - kpos < p.window;
                        }
                        if (!ok) s[i][j] = -INFINITY;
                    }
                }
            }

            // online softmax in base 2: p = 2^(s sl2 - m), P^T to shared
            float mrow[TR], lrow[TR];
#pragma unroll
            for (int i = 0; i < TR; i += 4) {
                const float4 a = *reinterpret_cast<const float4*>(
                    Ms + ty * TR + i);
                const float4 c = *reinterpret_cast<const float4*>(
                    Ls + ty * TR + i);
                mrow[i] = a.x; mrow[i + 1] = a.y;
                mrow[i + 2] = a.z; mrow[i + 3] = a.w;
                lrow[i] = c.x; lrow[i + 1] = c.y;
                lrow[i + 2] = c.z; lrow[i + 3] = c.w;
            }
#pragma unroll
            for (int i = 0; i < TR; ++i) {
                float mx = s[i][0];
#pragma unroll
                for (int j = 1; j < TC; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
                for (int w = CG / 2; w > 0; w >>= 1)
                    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
                const float mn = fmaxf(mrow[i], mx * sl2);
                // no visible key yet: subtract 0, so p = 2^-inf = 0
                const float base = mn == -INFINITY ? 0.f : mn;
                const float alpha = flash_mma::exp2_approx(mrow[i] - base);
                float sum = 0.f;
#pragma unroll
                for (int j = 0; j < TC; ++j) {
                    s[i][j] = flash_mma::exp2_approx(fmaf(s[i][j], sl2, -base));
                    sum += s[i][j];
                }
#pragma unroll
                for (int w = CG / 2; w > 0; w >>= 1)
                    sum += __shfl_xor_sync(0xffffffffu, sum, w);
                mrow[i] = mn;
                lrow[i] = lrow[i] * alpha + sum;
#pragma unroll
                for (int jj = 0; jj < TD; ++jj) {
                    acc[i][jj].x *= alpha; acc[i][jj].y *= alpha;
                    acc[i][jj].z *= alpha; acc[i][jj].w *= alpha;
                }
            }
            __syncwarp();                    // the row's lanes read m, l
#pragma unroll
            for (int i = 0; i < TR; i += 4) {
                if (tx == 0) {
                    *reinterpret_cast<float4*>(Ms + ty * TR + i) = make_float4(
                        mrow[i], mrow[i + 1], mrow[i + 2], mrow[i + 3]);
                    *reinterpret_cast<float4*>(Ls + ty * TR + i) = make_float4(
                        lrow[i], lrow[i + 1], lrow[i + 2], lrow[i + 3]);
                }
#pragma unroll
                for (int j = 0; j < TC; ++j)
                    *reinterpret_cast<float4*>(
                        Pt + (tx + CG * j) * LP + ty * TR + i) =
                        make_float4(s[i][j], s[i + 1][j], s[i + 2][j],
                                    s[i + 3][j]);
            }

            flash_mma::cp_async_wait<0>();   // V tile kt landed ...
            __syncthreads();                 // ... for all; P^T written
            if (kt < kt_hi)                  // K is read: refill it
                load_rows<BK, HD>(Kd, blk.kh + (k0 + BK + lr) * p.k_ss + lc,
                                  p.k_ss, k0 + BK + lr, p.Sk, k);
            flash_mma::cp_async_commit();

            // O += P V: per key, TR / 4 float4s of P^T, TD float4s of V
#pragma unroll 4
            for (int c = 0; c < BK; ++c) {
                float pr[TR];
#pragma unroll
                for (int i = 0; i < TR; i += 4) {
                    const float4 pf = *reinterpret_cast<const float4*>(
                        Pt + c * LP + ty * TR + i);
                    pr[i] = pf.x; pr[i + 1] = pf.y;
                    pr[i + 2] = pf.z; pr[i + 3] = pf.w;
                }
#pragma unroll
                for (int jj = 0; jj < TD; ++jj) {
                    const float4 vf = *reinterpret_cast<const float4*>(
                        Vs + c * LQ + 4 * tx + 4 * CG * jj);
#pragma unroll
                    for (int i = 0; i < TR; ++i) {
                        acc[i][jj].x = fmaf(pr[i], vf.x, acc[i][jj].x);
                        acc[i][jj].y = fmaf(pr[i], vf.y, acc[i][jj].y);
                        acc[i][jj].z = fmaf(pr[i], vf.z, acc[i][jj].z);
                        acc[i][jj].w = fmaf(pr[i], vf.w, acc[i][jj].w);
                    }
                }
            }
        }
    }

    __syncthreads();                         // blk, and the rows' m and l
    float* ob = blk.out;                     // row q0 of the output
    if (p.n_split == 1) {
#pragma unroll
        for (int i = 0; i < TR; ++i) {
            const int r = ty + RG * i;
            if (q0 + r >= p.Sq) continue;
            const float li = Ls[ty * TR + i];
#pragma unroll
            for (int jj = 0; jj < TD; ++jj) {   // no visible key: l = 0 -> 0
                const float4 a = acc[i][jj];
                *reinterpret_cast<float4*>(
                    ob + (long long)r * p.o_ss + 4 * tx + 4 * CG * jj) =
                    li > 0.f ? make_float4(a.x / li, a.y / li, a.z / li,
                                           a.w / li)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
            }
        }
        return;
    }

    // split-KV: this split's (m, l, acc) to its slot, [BQ] m, [BQ] l, then
    // [BQ][HD] acc; the q tile's last block combines the slots in order
    float* part = blk.slot;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
        const int r = ty + RG * i;
        if (tx == 0) {
            part[r] = Ms[ty * TR + i];
            part[BQ + r] = Ls[ty * TR + i];
        }
#pragma unroll
        for (int jj = 0; jj < TD; ++jj)
            *reinterpret_cast<float4*>(part + 2 * BQ + r * HD + 4 * tx
                                       + 4 * CG * jj) = acc[i][jj];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) blk.last = atomicAdd(blk.ticket, 1) == p.n_split - 1;
    __syncthreads();
    if (!blk.last) return;
    __threadfence();
    const float* first = blk.first;          // the q tile's split 0
#pragma unroll
    for (int i = 0; i < TR; ++i) {
        const int r = ty + RG * i;
        float mx = -INFINITY;
        for (int sp = 0; sp < p.n_split; ++sp)
            mx = fmaxf(mx, __ldcg(first + sp * SLOT + r));
        const float base = mx == -INFINITY ? 0.f : mx;
        float L = 0.f;
        float4 O[TD];
#pragma unroll
        for (int jj = 0; jj < TD; ++jj) O[jj] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int sp = 0; sp < p.n_split; ++sp) {
            const float* sl = first + sp * SLOT;
            const float w = flash_mma::exp2_approx(__ldcg(sl + r) - base);
            L = fmaf(__ldcg(sl + BQ + r), w, L);
#pragma unroll
            for (int jj = 0; jj < TD; ++jj) {
                const float4 a = __ldcg(reinterpret_cast<const float4*>(
                    sl + 2 * BQ + r * HD + 4 * tx + 4 * CG * jj));
                O[jj].x = fmaf(a.x, w, O[jj].x);
                O[jj].y = fmaf(a.y, w, O[jj].y);
                O[jj].z = fmaf(a.z, w, O[jj].z);
                O[jj].w = fmaf(a.w, w, O[jj].w);
            }
        }
        if (q0 + r >= p.Sq) continue;
#pragma unroll
        for (int jj = 0; jj < TD; ++jj)      // no visible key: L = 0 -> 0
            *reinterpret_cast<float4*>(
                ob + (long long)r * p.o_ss + 4 * tx + 4 * CG * jj) =
                L > 0.f ? make_float4(O[jj].x / L, O[jj].y / L, O[jj].z / L,
                                      O[jj].w / L)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (tid == 0) *blk.ticket = 0;
}

template <int HD>
int f32_smem_bytes() {
    return Cfg<HD>::SMEM_FLOATS * (int)sizeof(float);
}

template <int HD>
int launch(const FlashParams& p, const void* q, const void* k, const void* v,
           void* o, cudaStream_t stream) {
    using C = Cfg<HD>;
    const int bytes = f32_smem_bytes<HD>();
    auto kern = flash_kernel<HD>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    if (p.n_split < 1 || (p.n_split > 1 && (!p.partials || !p.tickets)))
        return -1;
    const long long blocks = (long long)((p.Sq + C::BQ - 1) / C::BQ)
                             * p.n_split * p.Hq * p.B;
    if (blocks > 0x7fffffffLL) return -1;
    kern<<<(unsigned)blocks, THREADS, bytes, stream>>>(
        p, static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o));
    return (int)cudaGetLastError();
}

template <int HD>
int resident(int device, int* blocks) {
    const int bytes = f32_smem_bytes<HD>();
    auto kern = flash_kernel<HD>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        THREADS, bytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    *blocks = per_sm * sms;
    return 0;
}

}  // namespace

// Launch on ``stream``; returns 0 or the cudaError_t of the launch (-1 for
// an unsupported head dim or a split plan without its scratch). Output o
// must not alias the inputs.
extern "C" int flash_attention_launch(const FlashParams* p, const void* q,
                                      const void* k, const void* v, void* o,
                                      void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (p->bf16) return flash_mma::dispatch(*p, q, k, v, o, s);
    switch (p->d) {
        case 32: return launch<32>(*p, q, k, v, o, s);
        case 64: return launch<64>(*p, q, k, v, o, s);
        case 128: return launch<128>(*p, q, k, v, o, s);
        case 256: return launch<256>(*p, q, k, v, o, s);
        default: return -1;
    }
}

// Blocks of the float32 kernel for head dim d that fit on ``device`` at
// once (occupancy x SMs); -1 for an unsupported head dim.
extern "C" int flash_f32_resident_blocks(int device, int d, int* blocks) {
    switch (d) {
        case 32: return resident<32>(device, blocks);
        case 64: return resident<64>(device, blocks);
        case 128: return resident<128>(device, blocks);
        case 256: return resident<256>(device, blocks);
        default: return -1;
    }
}
