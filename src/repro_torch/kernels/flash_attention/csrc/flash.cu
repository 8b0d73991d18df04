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
// every product and sum in float32 (below). Bfloat16 inputs: products on
// the tensor cores with float32 accumulation, softmax and sums in float32,
// the probabilities rounded to bfloat16 before the PV product
// (flash_mma.cuh).
//
// What bounds it on this card: attention is 4 * Sq * Sk * d operations
// per (batch, head) pair against (Sq + 2 Sk + Sq) * d elements moved, so
// at the serving shapes it is bound by operations, not bytes. The float32
// kernel multiplies in float32 on the CUDA cores (no TF32, no bf16
// products: the reference tolerance for float32 is 2e-6), so its ceiling
// is the float32 CUDA-core rate.
//
// Design of the float32 kernel. One block of 256 threads per (q tile,
// query head, batch); a loop over the K tiles replaces the TPU's
// sequential grid axis, with the running max m, denominator l and
// accumulator acc of each row in float32
// registers. K tiles that the causal / window predicate rules out are
// skipped (the reference's block-level predicate). Q and K tiles are held
// transposed in shared memory (rows padded by one float: no bank
// conflicts), V row-major, and the probabilities of the tile in a padded
// shared array; each thread owns a TR x TC patch of scores and a TR x TD
// patch of the output, the 16 threads of a half-warp sharing rows, so row
// maxima and sums are half-warp shuffles. Masked scores give p = 0 (not
// exp(0) as the TPU kernel's masked rows of a live tile do), so a row
// with no visible key keeps l = 0 and gives exactly 0, as attention_ref
// does. Ragged q rows and keys (lengths that are not tile multiples) are
// masked here; the wrapper passes element strides, so the (B, S, H, d)
// model layout needs no copy.
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
};

#include "flash_mma.cuh"          // the bfloat16 kernel (tensor cores)

namespace {

constexpr int THREADS = 256;   // 16 row groups x 16 column lanes

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <int HD, int BQ, int BK>
constexpr size_t smem_floats() {
    return (size_t)HD * (BQ + 1) + (size_t)HD * (BK + 1) + (size_t)BK * HD
           + (size_t)BQ * (BK + 1);
}

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const FlashParams p, const T* __restrict__ q,
             const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o) {
    constexpr int TR = BQ / 16;   // rows of a thread
    constexpr int TC = BK / 16;   // score columns of a thread
    constexpr int TD = HD / 16;   // output columns of a thread
    constexpr int QS = BQ + 1;    // padded strides
    constexpr int KS = BK + 1;
    extern __shared__ float smem[];
    float* Qt = smem;             // [HD][QS]  Q tile, transposed
    float* Kt = Qt + HD * QS;     // [HD][KS]  K tile, transposed
    float* Vs = Kt + HD * KS;     // [BK][HD]  V tile
    float* Ps = Vs + BK * HD;     // [BQ][KS]  probabilities of the tile

    const int tid = threadIdx.x;
    const int ty = tid >> 4, tx = tid & 15;
    const int q0 = blockIdx.x * BQ;
    const int h = blockIdx.y, b = blockIdx.z;
    const int hk = h / (p.Hq / p.Hkv);
    const int off = p.Sk - p.Sq;  // q positions sit at the cache tail

    const T* qb = q + b * p.q_sb + h * p.q_sh;
    const T* kb = k + b * p.k_sb + hk * p.k_sh;
    const T* vb = v + b * p.v_sb + hk * p.v_sh;
    T* ob = o + b * p.o_sb + h * p.o_sh;

    for (int i = tid; i < BQ * HD; i += THREADS) {
        const int r = i / HD, dd = i % HD;
        float x = 0.f;
        if (q0 + r < p.Sq) x = to_float(qb[(long long)(q0 + r) * p.q_ss + dd]);
        Qt[dd * QS + r] = x;
    }

    float m[TR], l[TR], acc[TR][TD];
#pragma unroll
    for (int i = 0; i < TR; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.f;
#pragma unroll
        for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
    }

    // the tile's first and last real q positions, for the block predicate
    const int q_first = q0 + off;
    const int q_last = min(q0 + BQ, p.Sq) - 1 + off;
    const int nk = (p.Sk + BK - 1) / BK;
    for (int kt = 0; kt < nk; ++kt) {
        const int k0 = kt * BK;
        if (p.causal) {                       // uniform across the block
            if (k0 > q_last) break;           // later tiles lie later still
            if (p.has_window && k0 + BK - 1 <= q_first - p.window) continue;
        }
        __syncthreads();                      // last tile's Vs/Ps reads done
        for (int i = tid; i < BK * HD; i += THREADS) {
            const int c = i / HD, dd = i % HD;
            float kx = 0.f, vx = 0.f;
            if (k0 + c < p.Sk) {
                kx = to_float(kb[(long long)(k0 + c) * p.k_ss + dd]);
                vx = to_float(vb[(long long)(k0 + c) * p.v_ss + dd]);
            }
            Kt[dd * KS + c] = kx;
            Vs[c * HD + dd] = vx;
        }
        __syncthreads();

        float s[TR][TC];
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
            for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int dd = 0; dd < HD; ++dd) {
            float qv[TR], kv[TC];
#pragma unroll
            for (int i = 0; i < TR; ++i) qv[i] = Qt[dd * QS + ty * TR + i];
#pragma unroll
            for (int j = 0; j < TC; ++j) kv[j] = Kt[dd * KS + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < TR; ++i)
#pragma unroll
                for (int j = 0; j < TC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < TR; ++i) {
            const int qpos = q0 + ty * TR + i + off;
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < TC; ++j) {
                const int kpos = k0 + tx + 16 * j;
                bool ok = kpos < p.Sk;
                if (p.causal) {
                    ok = ok && kpos <= qpos;
                    if (p.has_window) ok = ok && (qpos - kpos) < p.window;
                }
                s[i][j] = ok ? s[i][j] * p.scale : -INFINITY;
                mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int w = 8; w > 0; w >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
            const float mn = fmaxf(m[i], mx);
            float alpha = 1.f, sum = 0.f;
            if (mn != -INFINITY) {            // some key of the row is visible
                alpha = expf(m[i] - mn);      // 0 while m[i] is still -inf
#pragma unroll
                for (int j = 0; j < TC; ++j) {
                    s[i][j] = expf(s[i][j] - mn);   // masked: exp(-inf) = 0
                    sum += s[i][j];
                }
            } else {
#pragma unroll
                for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
            }
#pragma unroll
            for (int w = 8; w > 0; w >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, w);
            m[i] = mn;
            l[i] = l[i] * alpha + sum;
#pragma unroll
            for (int j = 0; j < TD; ++j) acc[i][j] *= alpha;
#pragma unroll
            for (int j = 0; j < TC; ++j)
                Ps[(ty * TR + i) * KS + tx + 16 * j] = s[i][j];
        }
        __syncthreads();

#pragma unroll 4
        for (int c = 0; c < BK; ++c) {
            float pv[TR], vv[TD];
#pragma unroll
            for (int i = 0; i < TR; ++i) pv[i] = Ps[(ty * TR + i) * KS + c];
#pragma unroll
            for (int j = 0; j < TD; ++j) vv[j] = Vs[c * HD + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < TR; ++i)
#pragma unroll
                for (int j = 0; j < TD; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
        const int r = q0 + ty * TR + i;
        if (r < p.Sq) {
            T* orow = ob + (long long)r * p.o_ss;
#pragma unroll
            for (int j = 0; j < TD; ++j)   // no visible key: l = 0 -> 0
                store(orow + tx + 16 * j, l[i] > 0.f ? acc[i][j] / l[i] : 0.f);
        }
    }
}

template <typename T, int HD, int BQ, int BK>
int launch(const FlashParams& p, const void* q, const void* k, const void* v,
           void* o, cudaStream_t stream) {
    static_assert(BQ % 16 == 0 && BK % 16 == 0 && HD % 16 == 0, "tiles");
    const int bytes = (int)(smem_floats<HD, BQ, BK>() * sizeof(float));
    auto kern = flash_kernel<T, HD, BQ, BK>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
    kern<<<grid, THREADS, bytes, stream>>>(
        p, static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o));
    return (int)cudaGetLastError();
}

// Tiles per head dim: shared memory of 41 KB (d 32), 66 KB (d 64), 75 KB
// (d 128, BK 32) and 105 KB (d 256, BQ = BK = 32), so two to five blocks
// fit an SM; above 48 KB the launch opts in to more dynamic shared memory.
template <typename T>
int dispatch(const FlashParams& p, const void* q, const void* k,
             const void* v, void* o, cudaStream_t s) {
    switch (p.d) {
        case 32: return launch<T, 32, 64, 64>(p, q, k, v, o, s);
        case 64: return launch<T, 64, 64, 64>(p, q, k, v, o, s);
        case 128: return launch<T, 128, 64, 32>(p, q, k, v, o, s);
        case 256: return launch<T, 256, 32, 32>(p, q, k, v, o, s);
        default: return -1;
    }
}

}  // namespace

// Launch on ``stream``; returns 0 or the cudaError_t of the launch (-1 for
// an unsupported head dim). Output o must not alias the inputs.
extern "C" int flash_attention_launch(const FlashParams* p, const void* q,
                                      const void* k, const void* v, void* o,
                                      void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return p->bf16 ? flash_mma::dispatch(*p, q, k, v, o, s)
                   : dispatch<float>(*p, q, k, v, o, s);
}
