// Per-pixel device helpers shared by the CUDA ingest and histogram
// kernels (ingest.cu, hist.cu). Both translation units are built with
// -fmad=false and IEEE division, so each helper rounds exactly as the
// reference's float32 formulas do; neither kernel may reorder them.
#pragma once

#include <cuda_runtime.h>

#define MAX_COLORS 4
#define MAX_RANGES 2
#define MAX_COUNTERS 256

// JAX's floor-mod by 6: fmodf keeps the dividend's sign, so a non-zero
// negative remainder is moved up by 6.
__device__ __forceinline__ float floor_mod6(float x) {
    float m = fmodf(x, 6.0f);
    return (m != 0.0f && m < 0.0f) ? m + 6.0f : m;
}

// RGB in [0, 255] -> hue in degrees/2 [0, 180), saturation and value in
// [0, 255], op for op as the reference's _rgb_to_hsv_block. The hue's
// three-way choice on the maximum channel is made with selects: the
// same operations on the same operands, so the same roundings, with one
// division where a warp whose lanes differ in their maximum channel
// would run up to three behind branches.
__device__ __forceinline__ void rgb_to_hsv(float r, float g, float b,
                                           float& h, float& s, float& v) {
    v = fmaxf(fmaxf(r, g), b);
    const float cr = v - fminf(fminf(r, g), b);
    s = v > 0.0f ? cr / fmaxf(v, 1e-9f) * 255.0f : 0.0f;
    const float sc = cr > 0.0f ? cr : 1.0f;
    const bool is_r = v == r, is_g = !is_r && v == g;
    const float q = (is_r ? g - b : is_g ? b - r : r - g) / sc;
    h = is_r ? floor_mod6(q) : q + (is_g ? 2.0f : 4.0f);
    h = cr > 0.0f ? h * 30.0f : 0.0f;
}

// Joint (sat, val) bin: the scaled float is truncated toward zero, then
// clipped, as core/utility.py::joint_bin_index does.
__device__ __forceinline__ int joint_bin(float s, float v, float sscale,
                                         float vscale, int bs, int bv) {
    const int sbin = min(max((int)(s * sscale), 0), bs - 1);
    const int vbin = min(max((int)(v * vscale), 0), bv - 1);
    return sbin * bv + vbin;
}

// The query's hue ranges as in_hue reads them, every color padded to
// MAX_RANGES ranges with the empty range [0, 0): a padded range adds
// "h >= 0 && h < 0", false for every h, to the OR, so in_hue answers as
// on the query's own ranges, while its loop has a fixed trip count
// (unrolled, no branches) and reads shared memory instead of indexed
// kernel parameters. Each kernel fills one in shared memory at its start
// (fill_padded_hues).
struct PaddedHues {
    struct Ranges {              // n_ranges[k] == MAX_RANGES for every k
        __device__ constexpr int operator[](int) const { return MAX_RANGES; }
    } n_ranges;
    float hue_lo[MAX_COLORS * MAX_RANGES];
    float hue_hi[MAX_COLORS * MAX_RANGES];
};

// Threads 0 .. MAX_COLORS * MAX_RANGES - 1 of a block fill `hues` from a
// kernel's parameter struct P (nc, n_ranges[MAX_COLORS],
// hue_lo/hue_hi[MAX_COLORS * MAX_RANGES]); the caller synchronises.
template <class P>
__device__ __forceinline__ void fill_padded_hues(PaddedHues& hues,
                                                 const P& p) {
    if (threadIdx.x < MAX_COLORS * MAX_RANGES) {
        const int q = threadIdx.x % MAX_RANGES, k = threadIdx.x / MAX_RANGES;
        const bool real = k < p.nc && q < p.n_ranges[k];
        hues.hue_lo[threadIdx.x] = real ? p.hue_lo[threadIdx.x] : 0.0f;
        hues.hue_hi[threadIdx.x] = real ? p.hue_hi[threadIdx.x] : 0.0f;
    }
}

// Whether hue h lies in one of color k's half-open ranges [lo, hi). It
// reads only a PaddedHues table, never a kernel's parameters: both
// kernels (ingest.cu, hist.cu) test hues through it, and no kernel
// instantiates a hue test on a parameter struct (a loop over indexed
// parameters with a trip count unknown at compile time was the largest
// single cost of ingest.cu's first builds).
__device__ __forceinline__ bool in_hue(float h, int k, const PaddedHues& t) {
    bool in = false;
    for (int q = 0; q < t.n_ranges[k]; ++q) {
        const int j = k * MAX_RANGES + q;
        in = in || (h >= t.hue_lo[j] && h < t.hue_hi[j]);
    }
    return in;
}
