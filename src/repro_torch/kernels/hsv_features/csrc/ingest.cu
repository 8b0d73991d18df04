// Fused camera-side ingest for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/hsv_features/kernel.py::ingest_batch
// (body _ingest_kernel). For each camera c and frame t of a
// (C, T, N, 3) float32 RGB batch it computes RGB->HSV, the Value-channel
// EMA background with a one-frame-lagged global gain, the foreground
// mask, per-color hue mask x foreground x joint (sat, val) bin counts,
// colour totals, the foreground total, the Eq. 14-15 utility and the
// updated (bg, gain) state, plus an optional foreground bounding box.
//
// What bounds it: memory. Each pixel of each frame is 12 bytes of RGB
// read once and a few dozen float operations, so at the main path's
// shape (C=8, T=8, 720x1280) the least traffic is the RGB once plus the
// background read and written once (about 767 MB), against well under
// 0.1 ms of arithmetic at the card's float32 rate.
//
// What the design does about it: every pixel is read from device memory
// exactly once per frame and all reductions stay on chip (histograms as
// int32 counters in shared memory, sums and bounding boxes reduced per
// warp and per block before one global update). The only serial
// dependency is the gain: frame t's gain is clip(sum v / max(sum base,
// 1e-6)) over frame t-1, so each frame is one launch over (pixel tiles,
// cameras) and a one-block-per-camera launch turns that frame's per-block
// partial sums into the next gain; the background EMA is per pixel and
// needs no order. That reads and writes the background lane once per
// frame (about 1.18 GB a step at the main shape) instead of once per
// step; keeping it in registers across frames is later work.
//
// Launches per call: 1 init + T x (frame + gain) + 1 finalize, all on the
// caller's stream, no host synchronisation.
//
// Parity with the reference (each one is also stated in the tests; the
// per-pixel helpers live in hsv_common.cuh, shared with hist.cu):
//  * hue uses the floor-mod of JAX, fmodf then +6 where the remainder is
//    non-zero and negative (fmodf alone keeps the dividend's sign);
//  * the joint bin truncates the scaled float to int, then clips;
//  * pixels past N (the ragged last tile) are never read or counted;
//  * bg_valid == 0: frame 0 seeds the background with its own Value;
//  * build with -fmad=false and IEEE division, no fast math: otherwise
//    (1-a)*base + a*comp contracts into an FMA that rounds differently;
//  * counts, totals and foreground totals are exact int32 counters, so
//    their order of accumulation does not matter; the gain's sums are
//    taken per block in double and reduced in a fixed order (run-to-run
//    deterministic), in another order than XLA's float32 sum, so a pixel
//    whose |v/gain - base| lies within rounding of the threshold can flip.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hsv_common.cuh"

#define GAIN_MIN 0.25f
#define GAIN_MAX 4.0f
#define THREADS 256
#define WARPS (THREADS / 32)

extern "C" {

// Mirrors the ctypes Structure in kernel.py field for field.
struct IngestParams {
    int C, T, N;                 // cameras, frames, pixels per frame
    int nc, bs, bv;              // colors, saturation bins, value bins
    int n_ranges[MAX_COLORS];    // hue ranges per color
    float hue_lo[MAX_COLORS * MAX_RANGES];
    float hue_hi[MAX_COLORS * MAX_RANGES];
    float sscale, vscale;        // float32(bs / 256.0), float32(bv / 256.0)
    float alpha, one_minus_alpha, threshold;
    int use_fg, bg_valid, op_and, width;
    int tile;                    // pixels per block
};

}  // extern "C"

__global__ void init_kernel(IngestParams p, const float* __restrict__ gain0,
                            float* __restrict__ gain, int* __restrict__ counts,
                            int* __restrict__ totals, int* __restrict__ fgtot,
                            int* __restrict__ bbox) {
    const long long nframes = (long long)p.C * p.T;
    const long long ncnt = nframes * p.nc * p.bs * p.bv;
    const long long n = ncnt > nframes * 4 ? ncnt : nframes * 4;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < n; i += stride) {
        if (i < ncnt) counts[i] = 0;
        if (i < nframes * p.nc) totals[i] = 0;
        if (i < nframes) fgtot[i] = 0;
        if (i < nframes * 4) bbox[i] = (i % 2 == 0) ? p.N : -1;
        if (i < p.C) gain[i] = gain0[i];
    }
}

__global__ void __launch_bounds__(THREADS)
frame_kernel(IngestParams p, int t, const float* __restrict__ rgb,
             const float* __restrict__ bg0, float* __restrict__ bg,
             const float* __restrict__ gain, int* __restrict__ counts,
             int* __restrict__ totals, int* __restrict__ fgtot,
             int* __restrict__ bbox, double* __restrict__ partials) {
    __shared__ int s_counts[MAX_COUNTERS];
    __shared__ int s_totals[MAX_COLORS];
    __shared__ int s_misc[5];               // fg total, bbox (4)
    __shared__ double s_sum[2][WARPS];

    const int c = blockIdx.y;
    const int nb = p.bs * p.bv;
    const int ncnt = p.nc * nb;
    for (int i = threadIdx.x; i < ncnt; i += blockDim.x) s_counts[i] = 0;
    if (threadIdx.x < MAX_COLORS) s_totals[threadIdx.x] = 0;
    if (threadIdx.x == 0) {
        s_misc[0] = 0;
        s_misc[1] = p.N; s_misc[2] = -1; s_misc[3] = p.N; s_misc[4] = -1;
    }
    __syncthreads();

    const float g = fminf(fmaxf(gain[c], GAIN_MIN), GAIN_MAX);
    const size_t frame = (size_t)c * p.T + t;
    const float* px = rgb + frame * (size_t)p.N * 3;
    const float* base0 = bg0 + (size_t)c * p.N;
    float* bgc = bg + (size_t)c * p.N;

    const int start = blockIdx.x * p.tile;
    const int end = min(start + p.tile, p.N);
    double sv = 0.0, sb = 0.0;
    int fg_n = 0;
    int tot[MAX_COLORS] = {0, 0, 0, 0};
    int rmin = p.N, rmax = -1, cmin = p.N, cmax = -1;

    for (int i = start + threadIdx.x; i < end; i += blockDim.x) {
        const float r = px[3 * (size_t)i];
        const float gg = px[3 * (size_t)i + 1];
        const float b = px[3 * (size_t)i + 2];
        float h, s, v;
        rgb_to_hsv(r, gg, b, h, s, v);

        const float base = t == 0 ? (p.bg_valid ? base0[i] : v) : bgc[i];
        const float comp = v / g;
        const bool fg = p.use_fg ? fabsf(comp - base) > p.threshold : true;
        bgc[i] = p.one_minus_alpha * base + p.alpha * comp;
        sv += (double)v;
        sb += (double)base;
        if (!fg) continue;

        fg_n += 1;
        const int joint = joint_bin(s, v, p.sscale, p.vscale, p.bs, p.bv);
        for (int k = 0; k < p.nc; ++k) {
            if (in_hue(h, k, p)) {
                atomicAdd(&s_counts[k * nb + joint], 1);
                tot[k] += 1;
            }
        }
        if (p.width > 0) {
            const int row = i / p.width, col = i % p.width;
            rmin = min(rmin, row); rmax = max(rmax, row);
            cmin = min(cmin, col); cmax = max(cmax, col);
        }
    }

    // warp, then block reductions; one global update per block
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int off = 16; off > 0; off >>= 1) {
        sv += __shfl_down_sync(full, sv, off);
        sb += __shfl_down_sync(full, sb, off);
    }
    fg_n = __reduce_add_sync(full, fg_n);
    for (int k = 0; k < MAX_COLORS; ++k) tot[k] = __reduce_add_sync(full, tot[k]);
    rmin = __reduce_min_sync(full, rmin);
    rmax = __reduce_max_sync(full, rmax);
    cmin = __reduce_min_sync(full, cmin);
    cmax = __reduce_max_sync(full, cmax);
    if (lane == 0) {
        s_sum[0][warp] = sv;
        s_sum[1][warp] = sb;
        atomicAdd(&s_misc[0], fg_n);
        for (int k = 0; k < p.nc; ++k) atomicAdd(&s_totals[k], tot[k]);
        atomicMin(&s_misc[1], rmin); atomicMax(&s_misc[2], rmax);
        atomicMin(&s_misc[3], cmin); atomicMax(&s_misc[4], cmax);
    }
    __syncthreads();

    int* cnt = counts + frame * ncnt;
    for (int i = threadIdx.x; i < ncnt; i += blockDim.x)
        if (s_counts[i]) atomicAdd(&cnt[i], s_counts[i]);
    if (threadIdx.x == 0) {
        double a = 0.0, bsum = 0.0;
        for (int w = 0; w < WARPS; ++w) { a += s_sum[0][w]; bsum += s_sum[1][w]; }
        double* part = partials + ((size_t)c * gridDim.x + blockIdx.x) * 2;
        part[0] = a;
        part[1] = bsum;
        if (s_misc[0]) atomicAdd(&fgtot[frame], s_misc[0]);
        for (int k = 0; k < p.nc; ++k)
            if (s_totals[k]) atomicAdd(&totals[frame * p.nc + k], s_totals[k]);
        if (p.width > 0 && s_misc[2] >= 0) {
            int* bb = bbox + frame * 4;
            atomicMin(&bb[0], s_misc[1]); atomicMax(&bb[1], s_misc[2]);
            atomicMin(&bb[2], s_misc[3]); atomicMax(&bb[3], s_misc[4]);
        }
    }
}

// One block per camera: the frame's per-block partial sums, reduced in a
// fixed order, give the gain the next frame divides by.
__global__ void __launch_bounds__(THREADS)
gain_kernel(int ntiles, const double* __restrict__ partials,
            float* __restrict__ gain) {
    __shared__ double s_sum[2][THREADS];
    const int c = blockIdx.x;
    double a = 0.0, b = 0.0;
    for (int j = threadIdx.x; j < ntiles; j += blockDim.x) {
        a += partials[((size_t)c * ntiles + j) * 2];
        b += partials[((size_t)c * ntiles + j) * 2 + 1];
    }
    s_sum[0][threadIdx.x] = a;
    s_sum[1][threadIdx.x] = b;
    __syncthreads();
    for (int w = THREADS / 2; w > 0; w >>= 1) {
        if (threadIdx.x < w) {
            s_sum[0][threadIdx.x] += s_sum[0][threadIdx.x + w];
            s_sum[1][threadIdx.x] += s_sum[1][threadIdx.x + w];
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        const float sv = (float)s_sum[0][0];
        const float sbase = (float)s_sum[1][0];
        gain[c] = fminf(fmaxf(sv / fmaxf(sbase, 1e-6f), GAIN_MIN), GAIN_MAX);
    }
}

// One block per (camera, frame): float32 outputs, Eq. 14-15 utility and
// the empty-frame bounding box.
__global__ void finalize_kernel(IngestParams p, const int* __restrict__ counts,
                                const int* __restrict__ totals,
                                const int* __restrict__ fgtot,
                                const float* __restrict__ M,
                                const float* __restrict__ norm,
                                float* __restrict__ counts_f,
                                float* __restrict__ totals_f,
                                float* __restrict__ fgtot_f,
                                float* __restrict__ util,
                                int* __restrict__ bbox) {
    const size_t frame = blockIdx.x;
    const int nb = p.bs * p.bv;
    const int ncnt = p.nc * nb;
    for (int i = threadIdx.x; i < ncnt; i += blockDim.x)
        counts_f[frame * ncnt + i] = (float)counts[frame * ncnt + i];
    if (threadIdx.x < p.nc)
        totals_f[frame * p.nc + threadIdx.x] = (float)totals[frame * p.nc + threadIdx.x];
    if (threadIdx.x != 0) return;
    fgtot_f[frame] = (float)fgtot[frame];
    float best = 0.0f;
    for (int k = 0; k < p.nc; ++k) {
        const float tot = fmaxf((float)totals[frame * p.nc + k], 1.0f);
        float u = 0.0f;
        for (int j = 0; j < nb; ++j)
            u += ((float)counts[frame * ncnt + k * nb + j] / tot) * M[k * nb + j];
        u = u / fmaxf(norm[k], 1e-9f);
        if (k == 0) best = u;
        else best = p.op_and ? fminf(best, u) : fmaxf(best, u);
    }
    util[frame] = best;
    if (p.width > 0 && bbox[frame * 4 + 1] < 0)
        for (int q = 0; q < 4; ++q) bbox[frame * 4 + q] = -1;
}

extern "C" int ingest_batch_launch(
        const IngestParams* params, const float* rgb, const float* bg0,
        const float* gain0, const float* M, const float* norm,
        float* counts_f, float* totals_f, float* fgtot_f, float* util,
        float* bg, float* gain, int* bbox, int* counts, int* totals,
        int* fgtot, double* partials, void* stream_handle) {
    const IngestParams p = *params;
    cudaStream_t stream = (cudaStream_t)stream_handle;
    const int ntiles = (p.N + p.tile - 1) / p.tile;
    const long long nframes = (long long)p.C * p.T;
    long long ninit = nframes * p.nc * p.bs * p.bv;
    if (ninit < nframes * 4) ninit = nframes * 4;
    const int init_blocks = (int)((ninit + THREADS - 1) / THREADS);
    init_kernel<<<init_blocks, THREADS, 0, stream>>>(p, gain0, gain, counts,
                                                     totals, fgtot, bbox);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(ntiles, p.C);
    for (int t = 0; t < p.T; ++t) {
        frame_kernel<<<grid, THREADS, 0, stream>>>(
            p, t, rgb, bg0, bg, gain, counts, totals, fgtot, bbox, partials);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        gain_kernel<<<p.C, THREADS, 0, stream>>>(ntiles, partials, gain);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    finalize_kernel<<<p.C * p.T, 64, 0, stream>>>(
        p, counts, totals, fgtot, M, norm, counts_f, totals_f, fgtot_f, util,
        bbox);
    return (int)cudaGetLastError();
}
