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
// one launch covers every frame.
//
// What bounds it. A pixel whose weight is zero adds exactly nothing to any
// output (the plain version multiplies a 0/1 hue mask by the weight), so
// its RGB need not be read. The least traffic is the weights (1 byte a
// pixel for a bool mask, 4 for float32) plus every 32-byte sector of RGB
// that holds a pixel with a non-zero weight (kernel.py::hist_bytes_read):
// at the main shape (64 frames of 720x1280, 5.7 % foreground in 8x8
// blocks) ~100 MB with a bool mask, ~277 MB with float weights; a dense
// mask needs all 767 / 944 MB. The per-pixel helpers (two IEEE divisions,
// a floor-mod and a three-way choice of channel, op for op as the
// reference rounds them) take about as long as the dense bytes: on dense
// calls the kernel is bound by its instructions, not its bytes.
//
// What the design does about it: ONE launch a call, weights before pixels.
//  * Frame t gets G = blocks_per_frame blocks (kernel.py::hist_plan: four
//    resident grids over all frames, rounded down, so the last grid is
//    full); block g of a frame takes the frame's 1024-pixel chunks
//    g, g + G, ... and thread x the quad of pixels 4x .. 4x + 3 of each, so
//    a warp takes 128 neighbouring pixels a step and a frame region's
//    foreground spreads over the frame's blocks.
//  * Each thread loads its quads' weights first, a 4-byte word (bool) or
//    a float4 (float32), 8 or 4 steps ahead. A step whose 128 weights are
//    all zero (__ballot_sync) loads no RGB; otherwise a thread loads only
//    the float4s of its quad's 48 RGB bytes that hold a pixel with a
//    non-zero weight, so the sectors read are exactly those
//    hist_bytes_read counts. Frames whose rows are not 16-byte aligned
//    (N % 4 != 0, an offset view) and a frame's last, ragged quad take
//    scalar loads with the same pixel-to-thread map.
//  * A sparse step pushes its non-zero pixels onto a per-warp queue in
//    shared memory and the warp works on 32 of them at a time, so a
//    foreground run of 8 pixels does not hold 30 idle lanes; a dense step
//    works in place. The hue's three-way choice is made by selects
//    (hsv_common.cuh::rgb_to_hsv, shared with ingest.cu).
//  * bool mask: int32 counters in shared memory (shared atomics: integer
//    sums are exact in any order). float32 weights: one private
//    histogram per warp (counters x 4 bytes, not growing with the block);
//    lanes that hit the same counter in a step are combined by the lowest
//    such lane in lane order (__match_any_sync, then shuffles), so the
//    order of every float addition follows from the shapes and the
//    weights, never from scheduling; a pixel in one color's hues takes
//    one such step, not one a color.
//  * No memset, no second kernel: each block writes its partial counters
//    to a slot of its own, then takes a ticket of its frame (one int32 a
//    frame, in a scratch that the wrapper keeps per device and stream).
//    The frame's last block sums the G partials in block order, writes
//    the float32 outputs (a color's total is the sum of its counts, in
//    bin order) and sets the ticket back to 0, so the scratch is zero
//    again when the call ends and the next call on that stream finds it
//    so. Calls on two streams use two scratches.
// Pixels past N are never read. Built with -fmad=false and IEEE division
// like ingest.cu; the per-pixel helpers and the padded hue table are
// shared with it (hsv_common.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hsv_common.cuh"

#define THREADS 256
#define WARPS (THREADS / 32)
#define QUAD 4                        // pixels a thread takes from a chunk
#define CHUNK (THREADS * QUAD)        // pixels a block takes at a time

extern "C" {

// Mirrors the ctypes Structure in kernel.py field for field.
struct HistParams {
    int T, N;                    // frames, pixels per frame
    int nc, bs, bv;              // colors, saturation bins, value bins
    int n_ranges[MAX_COLORS];    // hue ranges per color
    float hue_lo[MAX_COLORS * MAX_RANGES];
    float hue_hi[MAX_COLORS * MAX_RANGES];
    float sscale, vscale;        // float32(bs / 256.0), float32(bv / 256.0)
    int blocks_per_frame;        // G: blocks that share a frame's chunks
    int float_weights;           // 0: uint8 mask, 1: float32 weights
};

}  // extern "C"

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
    return ((uintptr_t)p & (bytes - 1)) == 0;
}

// One quad's weights: a bool mask's four bytes, or four float32.
template <bool FLOAT> struct Quad;

template <> struct Quad<false> {
    uint32_t v = 0;              // byte j: pixel j's mask
    __device__ __forceinline__ bool on(int j) const {
        return (v >> (8 * j)) & 0xffu;
    }
    __device__ __forceinline__ float w(int) const { return 1.0f; }
    __device__ __forceinline__ bool any() const { return v != 0u; }
    __device__ __forceinline__ void load(const uint8_t* wf, int i0, int N,
                                         bool vec) {
        if (vec && i0 + QUAD <= N) {
            v = __ldg(reinterpret_cast<const unsigned*>(wf + i0));
            return;
        }
        v = 0u;
        for (int j = 0; j < QUAD; ++j)
            if (i0 + j < N && wf[i0 + j]) v |= 1u << (8 * j);
    }
};

template <> struct Quad<true> {
    float4 v = {0.0f, 0.0f, 0.0f, 0.0f};
    __device__ __forceinline__ float w(int j) const {
        return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
    }
    // -0.0 == 0 is skipped too (the sums start at +0.0); NaN is not
    __device__ __forceinline__ bool on(int j) const { return w(j) != 0.0f; }
    __device__ __forceinline__ bool any() const {
        return on(0) || on(1) || on(2) || on(3);
    }
    __device__ __forceinline__ void load(const float* wf, int i0, int N,
                                         bool vec) {
        if (vec && i0 + QUAD <= N) {
            v = __ldg(reinterpret_cast<const float4*>(wf + i0));
            return;
        }
        float x[QUAD];
        for (int j = 0; j < QUAD; ++j) x[j] = i0 + j < N ? wf[i0 + j] : 0.0f;
        v = make_float4(x[0], x[1], x[2], x[3]);
    }
};

// The RGB of a quad's pixels whose weight is non-zero; the others' values
// are left 0 and never used. `vec`: the frame's RGB is 16-byte aligned.
template <bool FLOAT>
__device__ __forceinline__ void load_rgb(const float* fr, int i0, int N,
                                         bool vec, const Quad<FLOAT>& q,
                                         float (&px)[3 * QUAD]) {
    const float4 zero = {0.0f, 0.0f, 0.0f, 0.0f};
    if (vec && i0 + QUAD <= N) {
        const float4* s = reinterpret_cast<const float4*>(fr + 3 * (size_t)i0);
        const float4 a = q.on(0) || q.on(1) ? __ldg(s) : zero;
        const float4 b = q.on(1) || q.on(2) ? __ldg(s + 1) : zero;
        const float4 c = q.on(2) || q.on(3) ? __ldg(s + 2) : zero;
        px[0] = a.x; px[1] = a.y; px[2] = a.z; px[3] = a.w;
        px[4] = b.x; px[5] = b.y; px[6] = b.z; px[7] = b.w;
        px[8] = c.x; px[9] = c.y; px[10] = c.z; px[11] = c.w;
        return;
    }
#pragma unroll
    for (int j = 0; j < QUAD; ++j) {
        const bool on = q.on(j);         // false past N: the weight is 0
        const float* s = fr + 3 * ((size_t)i0 + j);
        px[3 * j] = on ? __ldg(s) : 0.0f;
        px[3 * j + 1] = on ? __ldg(s + 1) : 0.0f;
        px[3 * j + 2] = on ? __ldg(s + 2) : 0.0f;
    }
}

// Adds w to counter `key` of a warp's private histogram for every lane
// whose key is >= 0 (all 32 lanes call it). Lanes with the same key are
// summed by the lowest of them in lane order, starting from +0.0, and
// that one sum is added: the order of every addition is fixed by the
// lanes' keys alone.
__device__ __forceinline__ void warp_add(float* hist, int key, float w,
                                         int lane) {
    const unsigned full = 0xffffffffu;
    const unsigned active = __ballot_sync(full, key >= 0);
    if (!active) return;
    if (__popc(active) == 1) {
        if (key >= 0) hist[key] += w;
        return;
    }
    const unsigned peers = __match_any_sync(full, key);
    const bool leader = key >= 0 && __ffs(peers) - 1 == lane;
    unsigned rest = leader ? peers : 0u;
    float s = 0.0f;
    while (__any_sync(full, rest != 0u)) {
        const int src = rest ? __ffs(rest) - 1 : lane;
        const float x = __shfl_sync(full, w, src);
        if (rest) {
            s += x;
            rest &= rest - 1;
        }
    }
    if (leader) hist[key] += s;
}

#define QCAP (32 + 32 * QUAD)  // a warp's queue: < 32 left + one step's
#define DIRECT (3 * 32)        // more non-zero pixels in a step: no queue

struct Shared {
    int last;                           // this block is its frame's last
    PaddedHues hues;    // at offset 4, so its bounds start 8-aligned and
                        // a color's two ranges load as 8-byte pairs
    float4 queue[WARPS][QCAP];          // a warp's pending pixels: r, g, b, w
    float whist[WARPS][MAX_COUNTERS];   // float weights: one a warp
    int counts[MAX_COUNTERS];           // bool mask: one a block
    float fin[MAX_COUNTERS];            // the last block's frame counts
    float red_f[WARPS];
    int red_i[WARPS];
};

// One pixel of weight w (`on`: w is non-zero): HSV, bin and hue, added to
// the block's counters (bool) or the warp's histogram (float). Called by
// all lanes of a warp together.
template <bool FLOAT>
__device__ __forceinline__ void pixel(const HistParams& p, Shared& sh,
                                      float r, float g, float b, float w,
                                      bool on, int nb, int lane, int warp,
                                      float& fsum, int& fn) {
    int joint = 0;
    float h = 0.0f;
    if (on) {
        float s, v;
        rgb_to_hsv(r, g, b, h, s, v);
        joint = joint_bin(s, v, p.sscale, p.vscale, p.bs, p.bv);
    }
    if (FLOAT) {
        if (on) fsum += w;
        unsigned cm = 0u;                // the colors whose hues hold h
#pragma unroll
        for (int k = 0; k < MAX_COLORS; ++k)
            if (on && k < p.nc && in_hue(h, k, sh.hues)) cm |= 1u << k;
        if (!__any_sync(0xffffffffu, (cm & (cm - 1u)) != 0u)) {
            warp_add(sh.whist[warp], cm ? (__ffs(cm) - 1) * nb + joint : -1,
                     w, lane);
        } else {
#pragma unroll
            for (int k = 0; k < MAX_COLORS; ++k)
                if (k < p.nc)
                    warp_add(sh.whist[warp],
                             (cm >> k) & 1u ? k * nb + joint : -1, w, lane);
        }
    } else if (on) {
        fn += 1;
#pragma unroll
        for (int k = 0; k < MAX_COLORS; ++k)
            if (k < p.nc && in_hue(h, k, sh.hues))
                atomicAdd(&sh.counts[k * nb + joint], 1);
    }
}

// One step of a warp: its lanes' quads, weights q already loaded. A step
// with no non-zero weight loads nothing. Otherwise each lane loads the RGB
// of its non-zero pixels; a step with more than DIRECT of them works on
// its pixels in place (pixel j of every lane, j by j), a sparser one
// pushes them onto the warp's queue (pixel j of each lane in lane order,
// j by j) and works on the queue's top 32 while it holds 32, so that
// every lane has a pixel. `top` is the queue's height, < 32 between
// steps; the order of every float addition follows from the weights and
// the shapes alone.
template <bool FLOAT>
__device__ __forceinline__ void step(const HistParams& p, Shared& sh,
                                     const float* fr, int i0, bool vec_rgb,
                                     const Quad<FLOAT>& q, int nb, int lane,
                                     int warp, int& top, float& fsum,
                                     int& fn) {
    const unsigned full = 0xffffffffu;
    unsigned bal[QUAD];
    int n = 0;
#pragma unroll
    for (int j = 0; j < QUAD; ++j) {
        bal[j] = __ballot_sync(full, q.on(j));
        n += __popc(bal[j]);
    }
    if (n == 0) return;
    float px[3 * QUAD];
    load_rgb<FLOAT>(fr, i0, p.N, vec_rgb, q, px);
    if (n > DIRECT) {
#pragma unroll
        for (int j = 0; j < QUAD; ++j)
            pixel<FLOAT>(p, sh, px[3 * j], px[3 * j + 1], px[3 * j + 2],
                         q.w(j), q.on(j), nb, lane, warp, fsum, fn);
        return;
    }
    float4* qu = sh.queue[warp];
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int j = 0; j < QUAD; ++j) {
        if (q.on(j))
            qu[top + __popc(bal[j] & below)] =
                make_float4(px[3 * j], px[3 * j + 1], px[3 * j + 2], q.w(j));
        top += __popc(bal[j]);
    }
    __syncwarp();
    while (top >= 32) {
        top -= 32;
        const float4 e = qu[top + lane];
        pixel<FLOAT>(p, sh, e.x, e.y, e.z, e.w, true, nb, lane, warp, fsum,
                     fn);
    }
    __syncwarp();               // the next step's pushes overwrite the pops
}

// The whole call: grid T * G blocks, block b = frame b / G, share b % G.
// `partials` holds (T, G, nc*nb + 1) 4-byte slots (int32 or float32),
// each written before it is read; `tickets` (T,) int32 is zero on entry
// and on exit.
template <bool FLOAT>
__global__ void __launch_bounds__(THREADS, 4)
hist_kernel(const __grid_constant__ HistParams p,
            const float* __restrict__ rgb, const void* __restrict__ fg,
            float* __restrict__ counts, float* __restrict__ totals,
            float* __restrict__ fgtot, uint32_t* __restrict__ partials,
            int* __restrict__ tickets) {
    constexpr int U = FLOAT ? 4 : 8;     // quads whose weights are in flight
    using W = typename std::conditional<FLOAT, float, uint8_t>::type;
    __shared__ __align__(16) Shared sh;
    const int G = p.blocks_per_frame;
    const int t = blockIdx.x / G, g = blockIdx.x % G;
    const int nb = p.bs * p.bv, ncnt = p.nc * nb, nslot = ncnt + 1;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

    fill_padded_hues(sh.hues, p);
    for (int i = threadIdx.x; i < ncnt; i += THREADS) {
        if (FLOAT) {
#pragma unroll
            for (int w = 0; w < WARPS; ++w) sh.whist[w][i] = 0.0f;
        } else {
            sh.counts[i] = 0;
        }
    }
    __syncthreads();

    const float* fr = rgb + (size_t)t * p.N * 3;
    const W* wf = reinterpret_cast<const W*>(fg) + (size_t)t * p.N;
    const bool vec_rgb = aligned(fr, 16);
    const bool vec_w = aligned(wf, (int)sizeof(W) * QUAD);
    const int nch = (p.N + CHUNK - 1) / CHUNK;
    float fsum = 0.0f;
    int fn = 0, top = 0;
    for (int c0 = g; c0 < nch; c0 += U * G) {
        Quad<FLOAT> wq[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int c = c0 + u * G;
            if (c < nch) wq[u].load(wf, c * CHUNK + QUAD * threadIdx.x, p.N,
                                    vec_w);
        }
#pragma unroll 1
        for (int u = 0; u < U && c0 + u * G < nch; ++u) {
            step<FLOAT>(p, sh, fr, (c0 + u * G) * CHUNK + QUAD * threadIdx.x,
                        vec_rgb, wq[0], nb, lane, warp, top, fsum, fn);
#pragma unroll
            for (int v = 0; v + 1 < U; ++v) wq[v] = wq[v + 1];
        }
    }

    if (top > 0) {                      // the queue's last pixels
        const float4 e = lane < top ? sh.queue[warp][lane]
                                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        pixel<FLOAT>(p, sh, e.x, e.y, e.z, e.w, lane < top, nb, lane, warp,
                     fsum, fn);
    }

    // the block's partial: counters, then the foreground total
    const unsigned full = 0xffffffffu;
    if (FLOAT) {
        for (int off = 16; off > 0; off >>= 1)
            fsum += __shfl_down_sync(full, fsum, off);
        if (lane == 0) sh.red_f[warp] = fsum;
    } else {
        fn = __reduce_add_sync(full, fn);
        if (lane == 0) sh.red_i[warp] = fn;
    }
    __syncthreads();
    uint32_t* part = partials + ((size_t)t * G + g) * nslot;
    for (int i = threadIdx.x; i < ncnt; i += THREADS) {
        if (FLOAT) {
            float a = 0.0f;
#pragma unroll
            for (int w = 0; w < WARPS; ++w) a += sh.whist[w][i];
            part[i] = __float_as_uint(a);
        } else {
            part[i] = (uint32_t)sh.counts[i];
        }
    }
    if (threadIdx.x == 0) {
        if (FLOAT) {
            float a = 0.0f;
            for (int w = 0; w < WARPS; ++w) a += sh.red_f[w];
            part[ncnt] = __float_as_uint(a);
        } else {
            int a = 0;
            for (int w = 0; w < WARPS; ++w) a += sh.red_i[w];
            part[ncnt] = (uint32_t)a;
        }
    }

    // the frame's ticket: its last block reduces the G partials
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) sh.last = atomicAdd(&tickets[t], 1) == G - 1;
    __syncthreads();
    if (!sh.last) return;
    __threadfence();
    const uint32_t* fp = partials + (size_t)t * G * nslot;
    for (int i = threadIdx.x; i < nslot; i += THREADS) {
        float x;
        if (FLOAT) {
            float a = 0.0f;
            for (int b = 0; b < G; ++b)
                a += __uint_as_float(__ldcg(fp + (size_t)b * nslot + i));
            x = a;
        } else {
            int a = 0;
            for (int b = 0; b < G; ++b)
                a += (int)__ldcg(fp + (size_t)b * nslot + i);
            x = (float)a;
        }
        if (i < ncnt) {
            counts[(size_t)t * ncnt + i] = x;
            sh.fin[i] = x;
        } else {
            fgtot[t] = x;
        }
    }
    __syncthreads();
    if (threadIdx.x < p.nc) {
        const int k = threadIdx.x;
        float a = 0.0f;
        for (int j = 0; j < nb; ++j) a += sh.fin[k * nb + j];
        totals[(size_t)t * p.nc + k] = a;
    }
    if (threadIdx.x == 0) tickets[t] = 0;
}

// Blocks of the histogram kernel that fit on `device` at once (the
// smaller of the two instantiations' occupancies, times the SMs).
extern "C" int hist_resident_blocks(int device, int* blocks) {
    int per_sm = 0, per_sm_f = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, hist_kernel<false>, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm_f, hist_kernel<true>, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm_f < per_sm) per_sm = per_sm_f;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    *blocks = per_sm * sms;
    return 0;
}

// One launch of T * blocks_per_frame blocks on the caller's stream, no
// host synchronisation. Returns the launch's CUDA error.
extern "C" int hsv_hist_launch(const HistParams* params, const float* rgb,
                               const void* fg, float* counts, float* totals,
                               float* fgtot, uint32_t* partials, int* tickets,
                               void* stream_handle) {
    const HistParams p = *params;
    const unsigned grid = (unsigned)p.T * (unsigned)p.blocks_per_frame;
    cudaStream_t stream = (cudaStream_t)stream_handle;
    if (p.float_weights)
        hist_kernel<true><<<grid, THREADS, 0, stream>>>(
            p, rgb, fg, counts, totals, fgtot, partials, tickets);
    else
        hist_kernel<false><<<grid, THREADS, 0, stream>>>(
            p, rgb, fg, counts, totals, fgtot, partials, tickets);
    return (int)cudaGetLastError();
}
