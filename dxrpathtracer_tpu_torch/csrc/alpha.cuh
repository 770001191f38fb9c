// The any-hit opacity test of alpha-tested materials (RayTrace.hlsl:
// 485-507), shared by csrc/traverse.cu and csrc/sungrid.cu: a triangle
// whose material has an opacity map is a hit only where the bilinear wrap
// tap of the map's channel 0 at the hit's UV is >= 0.35. Its 256 B shading
// row (scene/types.py pack_tri_shade) gives has_opacity, the opacity
// texture's (base, w, h) and the three vertex UVs in one read. The plain
// version is accel/traverse.py::AlphaTest; the expressions and their order
// are scene/textures.py::bilinear_from_meta's. Build with --fmad=false.
//
// A kernel source includes this header before its own anonymous namespace;
// buildlib keys a build on the bytes of every header a source includes.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// the packed shading row (scene/types.py): 14 f32 per vertex block with the
// UV at +6, the packed material meta (int32) from slot 44: the opacity
// texture's (base, w, h) at meta[12..14], has_opacity at meta[18]
constexpr int kShadeRow = 64;
constexpr int kShadeVtx = 14;
constexpr int kShadeUv = 6;
constexpr int kShadeMeta = 44;
constexpr int kMetaOpacity = 12;  // 3 * PACKED_SLOTS.index("opacity")
constexpr int kMetaHasOpacity = 18;
constexpr float kAlphaCutoff = 0.35f;

struct AlphaScene {
    const float* __restrict__ tri_shade;  // (T, 64) f32 shading rows
    const float* __restrict__ texels;     // (texels, 4) f32 atlas pool
};

// floor-mod (the sign of the divisor, as torch.remainder and jnp.mod)
__device__ __forceinline__ int32_t floor_mod(int32_t a, int32_t b) {
    const int32_t r = a % b;
    return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// The alpha test of triangle id at barycentrics (u, v): true when the
// triangle's material has no opacity map or its opacity there is >= 0.35.
__device__ __forceinline__ bool alpha_accept(const AlphaScene& a,
                                             int32_t id, float u, float v) {
    const float* __restrict__ row =
        a.tri_shade + static_cast<int64_t>(id) * kShadeRow;
    const int32_t* __restrict__ meta =
        reinterpret_cast<const int32_t*>(row + kShadeMeta);
    if (__ldg(meta + kMetaHasOpacity) == 0) return true;
    const int32_t base = __ldg(meta + kMetaOpacity);
    const int32_t w = __ldg(meta + kMetaOpacity + 1);
    const int32_t h = __ldg(meta + kMetaOpacity + 2);
    const float bw = 1.0f - u - v;
    float uv[2];
#pragma unroll
    for (int c = 0; c < 2; ++c)
        uv[c] = __ldg(row + kShadeUv + c) * bw
                + __ldg(row + kShadeVtx + kShadeUv + c) * u
                + __ldg(row + 2 * kShadeVtx + kShadeUv + c) * v;
    const float x = uv[0] * static_cast<float>(w) - 0.5f;
    const float y = uv[1] * static_cast<float>(h) - 0.5f;
    const float x0 = floorf(x);
    const float y0 = floorf(y);
    const float fx = x - x0;
    const float fy = y - y0;
    const int32_t x0i = floor_mod(__float2int_rz(x0), w);
    const int32_t x1i = floor_mod(x0i + 1, w);
    const int32_t y0i = floor_mod(__float2int_rz(y0), h);
    const int32_t y1i = floor_mod(y0i + 1, h);
    auto texel = [&](int32_t yi, int32_t xi) {
        return __ldg(a.texels + static_cast<int64_t>(base + yi * w + xi) * 4);
    };
    const float t00 = texel(y0i, x0i);
    const float t10 = texel(y0i, x1i);
    const float t01 = texel(y1i, x0i);
    const float t11 = texel(y1i, x1i);
    const float top = t00 + (t10 - t00) * fx;
    const float bot = t01 + (t11 - t01) * fx;
    return top + (bot - top) * fy >= kAlphaCutoff;
}

}  // namespace
