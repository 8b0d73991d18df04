// Per-frame HSV histograms with a precomputed foreground mask, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/hsv_features/kernel.py::hsv_hist
// (body _hsv_hist_kernel). For each frame t of a (T, N, 3) float32 RGB
// batch and its (T, N) foreground weights w it computes RGB->HSV, the
// joint (sat, val) bin, and per color k the counts
//   counts[t, k, bin] = sum of w over pixels of that bin whose hue lies
//                       in one of color k's ranges,
// the color totals sum(w * hue_mask_k) and the foreground total sum(w).
// The TPU kernel takes one frame and a grid over 4096-pixel tiles; here
// one launch covers every tile of every frame.
//
// What bounds it: memory. Each pixel is 12 bytes of RGB and 1 byte of
// mask (4 with a float weight) read once and ~20 float operations, so at
// the main shape (64 frames of 720x1280) the least traffic is 767 MB
// (943 MB with float weights), against ~0.02 ms of arithmetic.
//
// What the design does about it: every pixel is read once; all sums
// stay on chip until one global update per block. Two weight types:
//  * uint8 (a bool mask, the documented type): int32 counters in shared
//    memory, warp-reduced totals, one atomicAdd per non-zero counter per
//    block into an int32 scratch, and a finalize pass to float32. Integer
//    sums are exact and independent of order.
//  * float32 weights: float sums depend on their order, so no atomics.
//    Each thread owns a column of a shared (counters x threads) array and
//    adds its pixels in a fixed order; the block sums each counter's
//    column in thread order into a per-block partial, and a second launch
//    sums the partials in tile order. The result is run-to-run
//    deterministic; it differs from the plain version's sums by rounding
//    only (exact for 0/1 weights below 2^24 pixels).
// Pixels past N in the last tile are never read. Built with -fmad=false
// and IEEE division like ingest.cu; the per-pixel helpers are shared
// with it (hsv_common.cuh).
//
// Launches per call: uint8 weights, a memset + count + finalize; float
// weights, partials + reduce. All on the caller's stream, no host sync.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hsv_common.cuh"

#define THREADS 256
#define FTHREADS 64                  // threads of the float-weight kernel
#define FSTRIDE (FTHREADS + 1)       // padded column stride, no bank clash

extern "C" {

// Mirrors the ctypes Structure in kernel.py field for field.
struct HistParams {
    int T, N;                    // frames, pixels per frame
    int nc, bs, bv;              // colors, saturation bins, value bins
    int n_ranges[MAX_COLORS];    // hue ranges per color
    float hue_lo[MAX_COLORS * MAX_RANGES];
    float hue_hi[MAX_COLORS * MAX_RANGES];
    float sscale, vscale;        // float32(bs / 256.0), float32(bv / 256.0)
    int tile;                    // pixels per block
    int float_weights;           // 0: uint8 mask, 1: float32 weights
};

}  // extern "C"

// Per-frame counter layout, in scratch and partials alike:
// [0, nc*nb) counts, [nc*nb, nc*nb + nc) color totals, then the fg total.
__device__ __forceinline__ int n_counters(const HistParams& p) {
    return p.nc * p.bs * p.bv + p.nc + 1;
}

__global__ void __launch_bounds__(THREADS)
hist_count_kernel(HistParams p, const float* __restrict__ rgb,
                  const uint8_t* __restrict__ fg, int* __restrict__ acc) {
    __shared__ int s_counts[MAX_COUNTERS];
    __shared__ int s_totals[MAX_COLORS + 1];          // colors, fg total
    const int nb = p.bs * p.bv;
    const int ncnt = p.nc * nb;
    for (int i = threadIdx.x; i < ncnt; i += blockDim.x) s_counts[i] = 0;
    if (threadIdx.x <= MAX_COLORS) s_totals[threadIdx.x] = 0;
    __syncthreads();

    const size_t frame = blockIdx.y;
    const float* px = rgb + frame * (size_t)p.N * 3;
    const uint8_t* w = fg + frame * (size_t)p.N;
    const int start = blockIdx.x * p.tile;
    const int end = min(start + p.tile, p.N);
    int fg_n = 0;
    int tot[MAX_COLORS] = {0, 0, 0, 0};
    for (int i = start + threadIdx.x; i < end; i += blockDim.x) {
        float h, s, v;
        rgb_to_hsv(px[3 * (size_t)i], px[3 * (size_t)i + 1],
                   px[3 * (size_t)i + 2], h, s, v);
        if (!w[i]) continue;
        fg_n += 1;
        const int joint = joint_bin(s, v, p.sscale, p.vscale, p.bs, p.bv);
        for (int k = 0; k < p.nc; ++k) {
            if (in_hue(h, k, p)) {
                atomicAdd(&s_counts[k * nb + joint], 1);
                tot[k] += 1;
            }
        }
    }

    const unsigned full = 0xffffffffu;
    fg_n = __reduce_add_sync(full, fg_n);
    for (int k = 0; k < MAX_COLORS; ++k) tot[k] = __reduce_add_sync(full, tot[k]);
    if ((threadIdx.x & 31) == 0) {
        for (int k = 0; k < p.nc; ++k) atomicAdd(&s_totals[k], tot[k]);
        atomicAdd(&s_totals[MAX_COLORS], fg_n);
    }
    __syncthreads();

    int* out = acc + frame * n_counters(p);
    for (int i = threadIdx.x; i < ncnt; i += blockDim.x)
        if (s_counts[i]) atomicAdd(&out[i], s_counts[i]);
    if (threadIdx.x < p.nc && s_totals[threadIdx.x])
        atomicAdd(&out[ncnt + threadIdx.x], s_totals[threadIdx.x]);
    if (threadIdx.x == 0 && s_totals[MAX_COLORS])
        atomicAdd(&out[ncnt + p.nc], s_totals[MAX_COLORS]);
}

// int32 counters -> the float32 outputs, one thread per counter.
__global__ void hist_finalize_kernel(HistParams p, const int* __restrict__ acc,
                                     float* __restrict__ counts,
                                     float* __restrict__ totals,
                                     float* __restrict__ fgtot) {
    const int nctr = n_counters(p);
    const int ncnt = p.nc * p.bs * p.bv;
    const long long n = (long long)p.T * nctr;
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < n; i += (long long)gridDim.x * blockDim.x) {
        const long long t = i / nctr;
        const int c = (int)(i % nctr);
        const float x = (float)acc[i];
        if (c < ncnt) counts[t * ncnt + c] = x;
        else if (c < ncnt + p.nc) totals[t * p.nc + (c - ncnt)] = x;
        else fgtot[t] = x;
    }
}

__global__ void __launch_bounds__(FTHREADS)
hist_float_kernel(HistParams p, const float* __restrict__ rgb,
                  const float* __restrict__ fg, float* __restrict__ partials) {
    extern __shared__ float col[];       // [counter][FSTRIDE], own column
    const int nb = p.bs * p.bv;
    const int ncnt = p.nc * nb;
    const int nctr = n_counters(p);
    for (int i = threadIdx.x; i < nctr * FSTRIDE; i += blockDim.x) col[i] = 0.0f;
    __syncthreads();

    const size_t frame = blockIdx.y;
    const float* px = rgb + frame * (size_t)p.N * 3;
    const float* w = fg + frame * (size_t)p.N;
    const int start = blockIdx.x * p.tile;
    const int end = min(start + p.tile, p.N);
    float* mine = col + threadIdx.x;
    for (int i = start + threadIdx.x; i < end; i += blockDim.x) {
        float h, s, v;
        rgb_to_hsv(px[3 * (size_t)i], px[3 * (size_t)i + 1],
                   px[3 * (size_t)i + 2], h, s, v);
        const float wi = w[i];
        mine[(ncnt + p.nc) * FSTRIDE] += wi;
        const int joint = joint_bin(s, v, p.sscale, p.vscale, p.bs, p.bv);
        for (int k = 0; k < p.nc; ++k) {
            if (in_hue(h, k, p)) {
                mine[(k * nb + joint) * FSTRIDE] += wi;
                mine[(ncnt + k) * FSTRIDE] += wi;
            }
        }
    }
    __syncthreads();

    float* part = partials + (frame * gridDim.x + blockIdx.x) * (size_t)nctr;
    for (int c = threadIdx.x; c < nctr; c += blockDim.x) {
        float a = 0.0f;
        for (int j = 0; j < FTHREADS; ++j) a += col[c * FSTRIDE + j];
        part[c] = a;
    }
}

// One block per frame: each counter's per-tile partials summed in tile
// order.
__global__ void __launch_bounds__(THREADS)
hist_reduce_kernel(HistParams p, int ntiles, const float* __restrict__ partials,
                   float* __restrict__ counts, float* __restrict__ totals,
                   float* __restrict__ fgtot) {
    const int nctr = n_counters(p);
    const int ncnt = p.nc * p.bs * p.bv;
    const size_t t = blockIdx.x;
    const float* part = partials + t * (size_t)ntiles * nctr;
    for (int c = threadIdx.x; c < nctr; c += blockDim.x) {
        float a = 0.0f;
        for (int j = 0; j < ntiles; ++j) a += part[(size_t)j * nctr + c];
        if (c < ncnt) counts[t * ncnt + c] = a;
        else if (c < ncnt + p.nc) totals[t * p.nc + (c - ncnt)] = a;
        else fgtot[t] = a;
    }
}

extern "C" int hsv_hist_launch(const HistParams* params, const float* rgb,
                               const void* fg, float* counts, float* totals,
                               float* fgtot, int* acc, float* partials,
                               void* stream_handle) {
    const HistParams p = *params;
    cudaStream_t stream = (cudaStream_t)stream_handle;
    const int ntiles = (p.N + p.tile - 1) / p.tile;
    const int nctr = p.nc * p.bs * p.bv + p.nc + 1;
    const dim3 grid(ntiles, p.T);
    cudaError_t err;
    if (!p.float_weights) {
        err = cudaMemsetAsync(acc, 0, sizeof(int) * (size_t)p.T * nctr, stream);
        if (err != cudaSuccess) return (int)err;
        hist_count_kernel<<<grid, THREADS, 0, stream>>>(
            p, rgb, (const uint8_t*)fg, acc);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        const long long n = (long long)p.T * nctr;
        long long blocks = (n + THREADS - 1) / THREADS;
        if (blocks > 65535) blocks = 65535;
        hist_finalize_kernel<<<(int)blocks, THREADS, 0, stream>>>(
            p, acc, counts, totals, fgtot);
        return (int)cudaGetLastError();
    }
    const int smem = (int)(sizeof(float) * (size_t)nctr * FSTRIDE);
    err = cudaFuncSetAttribute(hist_float_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    hist_float_kernel<<<grid, FTHREADS, smem, stream>>>(
        p, rgb, (const float*)fg, partials);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    hist_reduce_kernel<<<p.T, THREADS, 0, stream>>>(p, ntiles, partials, counts,
                                                    totals, fgtot);
    return (int)cudaGetLastError();
}
