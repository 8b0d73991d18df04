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
// [0, 255], op for op as the reference's _rgb_to_hsv_block.
__device__ __forceinline__ void rgb_to_hsv(float r, float g, float b,
                                           float& h, float& s, float& v) {
    v = fmaxf(fmaxf(r, g), b);
    const float cr = v - fminf(fminf(r, g), b);
    s = v > 0.0f ? cr / fmaxf(v, 1e-9f) * 255.0f : 0.0f;
    const float sc = cr > 0.0f ? cr : 1.0f;
    if (v == r) h = floor_mod6((g - b) / sc);
    else if (v == g) h = (b - r) / sc + 2.0f;
    else h = (r - g) / sc + 4.0f;
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

// Whether hue h lies in one of color k's half-open ranges [lo, hi).
// P is a kernel's parameter struct with n_ranges[MAX_COLORS] and
// hue_lo/hue_hi[MAX_COLORS * MAX_RANGES].
template <class P>
__device__ __forceinline__ bool in_hue(float h, int k, const P& p) {
    bool in = false;
    for (int q = 0; q < p.n_ranges[k]; ++q) {
        const int j = k * MAX_RANGES + q;
        in = in || (h >= p.hue_lo[j] && h < p.hue_hi[j]);
    }
    return in;
}
