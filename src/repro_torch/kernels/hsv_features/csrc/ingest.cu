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
// What bounds it. The least traffic is the RGB once plus the background
// read and written once: about 767 MB at the main path's shape (C=8, T=8,
// 720x1280), 0.229 ms at 3.35 TB/s. The arithmetic is not negligible: the
// per-pixel helpers (hsv_common.cuh) take three IEEE divisions and a
// three-way branch on the channel that holds the maximum, op for op as the
// reference rounds them, so at this card's issue rate the pixel work alone
// is of the same order as the bytes. The one serial dependency is the
// gain: frame t divides by clip(sum v / max(sum base, 1e-6)) over all of
// camera c's pixels of frame t-1, so no pixel of frame t can start before
// frame t-1 is done.
//
// What the design does about it: ONE persistent launch a call.
//  * A cooperative grid, sized to what is resident on the card (four
//    256-thread blocks an SM, __launch_bounds__) and capped by the work.
//    Work items are (camera, pixel tile) pairs, item `it` = camera
//    it / ntiles, tile it % ntiles, visited by block it mod grid on every
//    frame (kernel.py::WorkPlan mirrors the formula), so a thread meets
//    the same pixels, and the same background, on every frame.
//  * Between frames a grid barrier (cooperative_groups' grid sync, T + 1
//    a call). Each item writes its double (sum v, sum base) partials for
//    frame t to a slot of its own, (camera, frame, tile), never reused;
//    after the barrier every block that owns camera c reduces c's
//    partials in one fixed order, so every block gets the same float gain,
//    run after run.
//  * Each warp streams its chunks of a tile through shared memory with
//    cp.async, two chunks in flight, 16 bytes a copy: RGB with an L2
//    evict-first policy, the background lane (29.5 MB at the main shape)
//    loaded and stored with L2 evict-last, so that the 88 MB a frame of
//    streaming RGB pushes less of it out of the 50 MB L2 between frames.
//    A tile whose rows are not 16-byte aligned (a ragged N, an offset
//    view) is read with scalar loads; so is a ragged chunk's tail.
//  * The hue test reads a shared table padded to a fixed number of
//    ranges (branch-free); histograms are int32 counters in shared memory,
//    flushed once per item and frame; sums and bounding boxes are reduced
//    per warp and per block before one global update. The kernel zeroes
//    its own accumulators first and writes the float outputs, the totals,
//    the utility and the empty-frame bounding box after a last barrier: no
//    memset, no second kernel.
//
// Parity with the reference (each one is also stated in the tests; the
// per-pixel helpers live in hsv_common.cuh, shared with hist.cu):
//  * hue uses the floor-mod of JAX, fmodf then +6 where the remainder is
//    non-zero and negative (fmodf alone keeps the dividend's sign);
//  * the joint bin truncates the scaled float to int, then clips;
//  * pixels past N are never read or counted;
//  * bg_valid == 0: frame 0 seeds the background with its own Value;
//  * build with -fmad=false and IEEE division, no fast math: otherwise
//    (1-a)*base + a*comp contracts into an FMA that rounds differently;
//  * counts and foreground totals are exact int32 counters, so their order
//    of accumulation does not matter (a color's total is the exact sum of
//    its counts); the gain's sums are
//    taken per thread and block in double and reduced in a fixed order
//    (run-to-run deterministic), in another order than XLA's float32
//    sum, so a pixel whose |v/gain - base| lies within rounding of the
//    threshold can flip.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hsv_common.cuh"

namespace cg = cooperative_groups;

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
    int tile;                    // pixels per work item, a multiple of 4
};

}  // extern "C"

#define WARP_CHUNK 128   // pixels a warp stages in shared memory at a time
#define STAGES 2         // chunks a warp has staged or in flight

// --- cache policies and hinted accesses ---------------------------------
// RGB and the caller's bg0 are read once (L2 evict-first); the background
// lane is read and written on every frame (L2 evict-last). volatile: an
// access to the lane must not be merged with or moved past another
// frame's access to the same address.

__device__ __forceinline__ uint64_t l2_policy_evict_last() {
    uint64_t pol;
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
                 : "=l"(pol));
    return pol;
}

__device__ __forceinline__ uint64_t l2_policy_evict_first() {
    uint64_t pol;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                 : "=l"(pol));
    return pol;
}

__device__ __forceinline__ float ld_hint(const float* p, uint64_t pol) {
    float x;
    asm volatile("ld.global.L2::cache_hint.f32 %0, [%1], %2;"
                 : "=f"(x) : "l"(p), "l"(pol));
    return x;
}

__device__ __forceinline__ void st_hint(float* p, float x, uint64_t pol) {
    asm volatile("st.global.L2::cache_hint.f32 [%0], %1, %2;"
                 :: "l"(p), "f"(x), "l"(pol) : "memory");
}

// 16 bytes from global to shared memory, asynchronously, through L2 only.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           uint64_t pol) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile(
        "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;"
        :: "r"(dst), "l"(gmem), "l"(pol) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all_but_newest() {
    asm volatile("cp.async.wait_group %0;" :: "n"(STAGES - 1) : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
    return ((uintptr_t)p & 15) == 0;
}

// --- per pixel ----------------------------------------------------------

struct Acc {                     // one thread's share of an item's frame
    double sv, sb;               // sum of Value, sum of background
    int fg;                      // foreground pixels
    int rmin, rmax, cmin, cmax;  // foreground bounding box (BBOX only)
};

// One pixel: HSV, foreground against `base` (the pixel's own Value when
// `seed`), its share of the sums, counts and bounding box; returns the
// pixel's updated background. A color's total is the sum of its counts,
// so it is not counted here.
template <bool BBOX>
__device__ __forceinline__ float ingest_pixel(
        const IngestParams& p, int i, float r, float gg, float b, float base,
        bool seed, float g, int nb, int* s_counts, const PaddedHues& hues,
        Acc& a) {
    float h, s, v;
    rgb_to_hsv(r, gg, b, h, s, v);
    if (seed) base = v;
    const float comp = v / g;
    const bool fg = p.use_fg ? fabsf(comp - base) > p.threshold : true;
    a.sv += (double)v;
    a.sb += (double)base;
    if (fg) {
        a.fg += 1;
        const int joint = joint_bin(s, v, p.sscale, p.vscale, p.bs, p.bv);
#pragma unroll
        for (int k = 0; k < MAX_COLORS; ++k)
            if (k < p.nc && in_hue(h, k, hues))
                atomicAdd(&s_counts[k * nb + joint], 1);
        if (BBOX) {
            const int row = i / p.width, col = i % p.width;
            a.rmin = min(a.rmin, row); a.rmax = max(a.rmax, row);
            a.cmin = min(a.cmin, col); a.cmax = max(a.cmax, col);
        }
    }
    return p.one_minus_alpha * base + p.alpha * comp;
}

// Shared-memory staging, one slice per warp: RGB and the background of
// WARP_CHUNK pixels in each of STAGES buffers, so that a warp's next
// chunks are in flight while it computes this one, and warps never wait
// for each other.
struct Stage {
    float rgb[WARPS][STAGES][WARP_CHUNK * 3];
    float bg[WARPS][STAGES][WARP_CHUNK];
};

// Pixels [start, end) of camera c's frame t. The tile is cut into chunks
// of WARP_CHUNK pixels; warp w takes chunks w, w + WARPS, ..., lane l
// pixels l, l + 32, ... of each, so a thread meets the same pixels on
// every frame. A chunk is staged by cp.async from 16-byte aligned rows,
// so the tile's RGB and background are read once, at full width; a tile
// whose rows are not 16-byte aligned (a ragged N, an offset view) is read
// with scalar loads, and so is a ragged chunk's tail of up to three
// pixels.
template <bool BBOX>
__device__ __forceinline__ void ingest_tile(
        const IngestParams& p, int c, int t, int start, int end,
        const float* __restrict__ rgb, const float* __restrict__ bg0,
        float* __restrict__ bg, float g, int nb, int* s_counts, Stage& st,
        const PaddedHues& hues, uint64_t keep, uint64_t once, Acc& a) {
    const float* px = rgb + ((size_t)c * p.T + t) * (size_t)p.N * 3;
    float* row = bg + (size_t)c * p.N;
    const bool seed = t == 0 && !p.bg_valid;     // base := own Value
    const bool first = t == 0 && p.bg_valid;     // base from bg0
    const float* src = first ? bg0 + (size_t)c * p.N : row;
    const uint64_t src_pol = first ? once : keep;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nchunks = (end - start + WARP_CHUNK - 1) / WARP_CHUNK;
    auto pixel = [&](int i, float r, float gg, float b, float base) {
        st_hint(row + i, ingest_pixel<BBOX>(p, i, r, gg, b, base, seed, g, nb,
                                            s_counts, hues, a),
                keep);
    };
    auto global_pixel = [&](int i) {
        const float* q = px + 3 * (size_t)i;
        pixel(i, ld_hint(q, once), ld_hint(q + 1, once), ld_hint(q + 2, once),
              seed ? 0.0f : ld_hint(src + i, src_pol));
    };
    const bool staged = aligned16(px + 3 * (size_t)start)
                        && (seed || aligned16(src + start));
    if (!staged) {
        for (int m = warp; m < nchunks; m += WARPS) {
            const int c0 = start + m * WARP_CHUNK;
            const int n = min(WARP_CHUNK, end - c0);
            for (int j = lane; j < n; j += 32) global_pixel(c0 + j);
        }
        return;
    }
    auto issue = [&](int m, int buf) {
        if (m < nchunks) {
            const int c0 = start + m * WARP_CHUNK;
            const int n4 = min(WARP_CHUNK, end - c0) & ~3;
            const char* gr = reinterpret_cast<const char*>(px + 3 * (size_t)c0);
            char* sr = reinterpret_cast<char*>(st.rgb[warp][buf]);
            for (int u = lane; u < n4 * 3 / 4; u += 32)
                cp_async16(sr + 16 * u, gr + 16 * u, once);
            const char* gb = reinterpret_cast<const char*>(src + c0);
            char* sb = reinterpret_cast<char*>(st.bg[warp][buf]);
            for (int u = lane; !seed && u < n4 / 4; u += 32)
                cp_async16(sb + 16 * u, gb + 16 * u, src_pol);
        }
        cp_async_commit();                       // an empty group at the end
    };
    for (int q = 0; q < STAGES - 1; ++q) issue(warp + q * WARPS, q);
    int buf = 0;
    for (int m = warp; m < nchunks; m += WARPS, buf = (buf + 1) % STAGES) {
        issue(m + (STAGES - 1) * WARPS, (buf + STAGES - 1) % STAGES);
        cp_async_wait_all_but_newest();
        __syncwarp();
        const int c0 = start + m * WARP_CHUNK;
        const int n = min(WARP_CHUNK, end - c0), n4 = n & ~3;
        const float* sr = st.rgb[warp][buf];
#pragma unroll 1
        for (int j = lane; j < n; j += 32) {
            if (j < n4)
                pixel(c0 + j, sr[3 * j], sr[3 * j + 1], sr[3 * j + 2],
                      seed ? 0.0f : st.bg[warp][buf][j]);
            else
                global_pixel(c0 + j);
        }
        __syncwarp();           // this buffer is refilled STAGES chunks on
    }
}

// Camera c's gain after a frame, from that frame's per-tile partials
// `part` ((ntiles, 2) doubles), reduced in one fixed order by the whole
// block; every thread gets it.
__device__ float camera_gain(const double* part, int ntiles,
                             double (*s_sum)[WARPS], float* s_gain) {
    double a = 0.0, b = 0.0;
    for (int j = threadIdx.x; j < ntiles; j += THREADS) {
        a += __ldcg(part + 2 * j);
        b += __ldcg(part + 2 * j + 1);
    }
    for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_down_sync(0xffffffffu, a, off);
        b += __shfl_down_sync(0xffffffffu, b, off);
    }
    if ((threadIdx.x & 31) == 0) {
        s_sum[0][threadIdx.x >> 5] = a;
        s_sum[1][threadIdx.x >> 5] = b;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        double x = 0.0, y = 0.0;
        for (int w = 0; w < WARPS; ++w) { x += s_sum[0][w]; y += s_sum[1][w]; }
        const float sv = (float)x, sbase = (float)y;
        *s_gain = fminf(fmaxf(sv / fmaxf(sbase, 1e-6f), GAIN_MIN), GAIN_MAX);
    }
    __syncthreads();
    return *s_gain;
}

// The whole call. `acc` is int32 scratch: counts (C*T*nc*nb), then
// foreground totals (C*T); `partials` is (C, T, ntiles, 2) doubles. Both
// are filled by the kernel itself.
template <bool BBOX>
__global__ void __launch_bounds__(THREADS, 4)
ingest_kernel(const __grid_constant__ IngestParams p,
              const float* __restrict__ rgb, const float* __restrict__ bg0,
              const float* __restrict__ gain0, const float* __restrict__ M,
              const float* __restrict__ norm, float* __restrict__ counts_f,
              float* __restrict__ totals_f, float* __restrict__ fgtot_f,
              float* __restrict__ util, float* __restrict__ bg,
              float* __restrict__ gain, int* __restrict__ bbox,
              int* __restrict__ acc, double* __restrict__ partials) {
    cg::grid_group grid = cg::this_grid();
    __shared__ __align__(16) Stage st;
    __shared__ PaddedHues s_hues;
    __shared__ int s_counts[MAX_COUNTERS];
    __shared__ int s_misc[5];               // fg total, bbox (4)
    __shared__ double s_sum[2][WARPS];
    __shared__ float s_util[MAX_COLORS];
    __shared__ float s_gain;

    const int nb = p.bs * p.bv;
    const int ncnt = p.nc * nb;
    const int ntiles = (p.N + p.tile - 1) / p.tile;
    const int nitems = p.C * ntiles;
    const long long nframes = (long long)p.C * p.T;
    int* counts = acc;
    int* fgtot = counts + nframes * ncnt;
    const uint64_t keep = l2_policy_evict_last();
    const uint64_t once = l2_policy_evict_first();

    // 1. zero the accumulators, open the bounding boxes; the hue table
    fill_padded_hues(s_hues, p);
    {
        const long long nacc = nframes * (ncnt + 1);
        const long long n = nacc > nframes * 4 ? nacc : nframes * 4;
        const long long stride = (long long)gridDim.x * THREADS;
        for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
             i < n; i += stride) {
            if (i < nacc) acc[i] = 0;
            if (i < nframes * 4) bbox[i] = (i % 2 == 0) ? p.N : -1;
        }
    }
    grid.sync();

    // 2. the frames, one barrier after each
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int t = 0; t < p.T; ++t) {
        for (int it = blockIdx.x; it < nitems; it += gridDim.x) {
            const int c = it / ntiles, j = it % ntiles;
            float g = t == 0 ? __ldg(gain0 + c)
                             : camera_gain(partials + ((size_t)c * p.T + t - 1)
                                                      * ntiles * 2,
                                           ntiles, s_sum, &s_gain);
            g = fminf(fmaxf(g, GAIN_MIN), GAIN_MAX);
            for (int i = threadIdx.x; i < ncnt; i += THREADS) s_counts[i] = 0;
            if (threadIdx.x == 0) {
                s_misc[0] = 0;
                s_misc[1] = p.N; s_misc[2] = -1; s_misc[3] = p.N; s_misc[4] = -1;
            }
            __syncthreads();

            Acc a = {0.0, 0.0, 0, p.N, -1, p.N, -1};
            const int start = j * p.tile;
            const int end = min(start + p.tile, p.N);
            ingest_tile<BBOX>(p, c, t, start, end, rgb, bg0, bg, g, nb,
                              s_counts, st, s_hues, keep, once, a);

            // warp, then block reductions; one global update per item
            for (int off = 16; off > 0; off >>= 1) {
                a.sv += __shfl_down_sync(full, a.sv, off);
                a.sb += __shfl_down_sync(full, a.sb, off);
            }
            const int fg_n = __reduce_add_sync(full, a.fg);
            if (lane == 0) {
                s_sum[0][warp] = a.sv;
                s_sum[1][warp] = a.sb;
                atomicAdd(&s_misc[0], fg_n);
            }
            if (BBOX) {
                const int rmin = __reduce_min_sync(full, a.rmin);
                const int rmax = __reduce_max_sync(full, a.rmax);
                const int cmin = __reduce_min_sync(full, a.cmin);
                const int cmax = __reduce_max_sync(full, a.cmax);
                if (lane == 0) {
                    atomicMin(&s_misc[1], rmin); atomicMax(&s_misc[2], rmax);
                    atomicMin(&s_misc[3], cmin); atomicMax(&s_misc[4], cmax);
                }
            }
            __syncthreads();

            const size_t frame = (size_t)c * p.T + t;
            int* cnt = counts + frame * ncnt;
            for (int i = threadIdx.x; i < ncnt; i += THREADS)
                if (s_counts[i]) atomicAdd(&cnt[i], s_counts[i]);
            if (threadIdx.x == 0) {
                double x = 0.0, y = 0.0;
                for (int w = 0; w < WARPS; ++w) { x += s_sum[0][w]; y += s_sum[1][w]; }
                double* part = partials + (frame * ntiles + j) * 2;
                part[0] = x;
                part[1] = y;
                if (s_misc[0]) atomicAdd(&fgtot[frame], s_misc[0]);
                if (BBOX && s_misc[2] >= 0) {
                    int* bb = bbox + frame * 4;
                    atomicMin(&bb[0], s_misc[1]); atomicMax(&bb[1], s_misc[2]);
                    atomicMin(&bb[2], s_misc[3]); atomicMax(&bb[3], s_misc[4]);
                }
            }
            __syncthreads();    // shared memory is reused by the next item
        }
        grid.sync();
    }

    // 3. per (camera, frame): float outputs, totals (each color's counts
    // summed, exact), Eq. 14-15 utility, the empty-frame bounding box, and
    // the gain after each camera's last frame
    for (long long f = blockIdx.x; f < nframes; f += gridDim.x) {
        const int c = (int)(f / p.T), t = (int)(f % p.T);
        for (int i = threadIdx.x; i < ncnt; i += THREADS) {
            const int x = __ldcg(counts + f * ncnt + i);
            s_counts[i] = x;
            counts_f[f * ncnt + i] = (float)x;
        }
        __syncthreads();
        if (threadIdx.x < p.nc) {
            const int k = threadIdx.x;
            int n = 0;
            for (int j = 0; j < nb; ++j) n += s_counts[k * nb + j];
            totals_f[f * p.nc + k] = (float)n;
            const float tot = fmaxf((float)n, 1.0f);
            float u = 0.0f;
            for (int j = 0; j < nb; ++j)
                u += ((float)s_counts[k * nb + j] / tot) * M[k * nb + j];
            s_util[k] = u / fmaxf(norm[k], 1e-9f);
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            fgtot_f[f] = (float)__ldcg(fgtot + f);
            float best = s_util[0];
            for (int k = 1; k < p.nc; ++k)
                best = p.op_and ? fminf(best, s_util[k]) : fmaxf(best, s_util[k]);
            util[f] = best;
            if (BBOX && __ldcg(bbox + f * 4 + 1) < 0)
                for (int q = 0; q < 4; ++q) bbox[f * 4 + q] = -1;
        }
        if (t == p.T - 1) {
            const float gg = camera_gain(partials + (size_t)f * ntiles * 2,
                                         ntiles, s_sum, &s_gain);
            if (threadIdx.x == 0) gain[c] = gg;
        }
        __syncthreads();    // shared memory is reused by the next frame
    }
}

// Blocks of the ingest kernel that fit on `device` at once: the largest
// grid a cooperative launch takes.
// (The smaller of the two instantiations' occupancies.)
extern "C" int ingest_resident_blocks(int device, int* blocks) {
    int per_sm = 0, per_sm_bbox = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ingest_kernel<false>, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm_bbox, ingest_kernel<true>, THREADS, 0);
    if (per_sm_bbox < per_sm) per_sm = per_sm_bbox;
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    *blocks = per_sm * sms;
    return 0;
}

// One cooperative launch of `grid` blocks on the caller's stream, no host
// synchronisation. Returns the launch's CUDA error (for example
// cudaErrorCooperativeLaunchTooLarge when grid exceeds what is resident).
extern "C" int ingest_batch_launch(
        const IngestParams* params, int grid, const float* rgb,
        const float* bg0, const float* gain0, const float* M,
        const float* norm, float* counts_f, float* totals_f, float* fgtot_f,
        float* util, float* bg, float* gain, int* bbox, int* acc,
        double* partials, void* stream_handle) {
    IngestParams p = *params;
    void* args[] = {&p, &rgb, &bg0, &gain0, &M, &norm, &counts_f, &totals_f,
                    &fgtot_f, &util, &bg, &gain, &bbox, &acc, &partials};
    const void* fn = p.width > 0 ? (const void*)ingest_kernel<true>
                                  : (const void*)ingest_kernel<false>;
    return (int)cudaLaunchCooperativeKernel(
        fn, dim3(grid), dim3(THREADS), args, 0, (cudaStream_t)stream_handle);
}
