// Software-raster primaries for sm_90a: the closest hit of each camera ray
// over the triangles binned to its screen tile.
//
// What it replaces. dxrpathtracer_tpu/render/swraster.py::raster_closest_hit
// (:360), which XLA runs on the TPU as a 64-level dense table, a 256-level
// deep table and a pair-major tail with a segmented associative scan (fixed
// shapes for XLA), then one re-test of each pixel's winner for u and v. All
// of it computes one thing: for each ray of a 128-pixel tile, the least t
// of a Moller-Trumbore hit in [t_min, t_max) among the tile's triangles,
// the lowest triangle id on equal t.
//
// What bounds it on the card. Operations: each (tile, triangle) pair is 128
// tests of ~55 f32 operations (387,959 pairs at 1080p on the Sponza-class
// stand-in's default camera: 2.7 G operations), against 36 B of triangle
// row and 4 B of id a pair and 49 B a ray.
//
// What the design does about it. The port keeps one CSR list per tile
// (render/swraster.py::build_raster_bins), so one block of 128 threads
// takes one tile, a thread its pixel (the lanes arrive in tile order: a
// tile's rays are 128 consecutive lanes). The block walks its list in
// chunks of 128 triangles: each thread stages one row in shared memory,
// then every thread tests every staged row against its own ray, the rows
// read as broadcasts. A lane keeps the least (t, id); u and v of the
// winning test are kept with it (the re-test of the JAX function is the
// same expression on the same inputs, so its bits are these). The list has
// no depth cap: a deep tile only takes more chunks.
//
// Exactness. Build with --fmad=false and without fast-math: every product is
// rounded on its own and the division is IEEE, as in the plain torch version
// (render/swraster.py::raster_closest_hit_plain) and the JAX package's
// expression, in the same order.
//
// Plain C interface for ctypes: the launcher returns the CUDA error code of
// the launch (0 on success) and never synchronises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;   // pixels (threads) per tile
constexpr int kChunk = 128;  // triangles staged at once
constexpr float kEps = 1e-12f;

__global__ void __launch_bounds__(kTile)
raster_kernel(const int32_t* __restrict__ tile_start,
              const int32_t* __restrict__ tri_id,
              const float* __restrict__ table,
              const float* __restrict__ ray_o,
              const float* __restrict__ ray_d,
              const float* __restrict__ t_min,
              const float* __restrict__ t_max,
              const uint8_t* __restrict__ active,
              float* __restrict__ out_t, int32_t* __restrict__ out_tri,
              float* __restrict__ out_u, float* __restrict__ out_v) {
    __shared__ float rows[9][kChunk];
    __shared__ int32_t ids[kChunk];
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
    const bool act = active[i] != 0;
    const float ox = ray_o[3 * i], oy = ray_o[3 * i + 1], oz = ray_o[3 * i + 2];
    const float dx = ray_d[3 * i], dy = ray_d[3 * i + 1], dz = ray_d[3 * i + 2];
    const float tmin = t_min[i], tmax = t_max[i];
    float best_t = 0.0f, best_u = 0.0f, best_v = 0.0f;
    int32_t best_id = -1;
    const int32_t start = tile_start[blockIdx.x];
    const int32_t end = tile_start[blockIdx.x + 1];
    for (int32_t base = start; base < end; base += kChunk) {
        const int cnt = min(kChunk, end - base);
        __syncthreads();  // the previous chunk's rows are read
        if (threadIdx.x < cnt) {
            const int32_t id = tri_id[base + threadIdx.x];
            const float* row = table + 9 * static_cast<int64_t>(id);
            ids[threadIdx.x] = id;
#pragma unroll
            for (int f = 0; f < 9; ++f) rows[f][threadIdx.x] = __ldg(row + f);
        }
        __syncthreads();
        if (!act) continue;
        for (int j = 0; j < cnt; ++j) {
            const float v0x = rows[0][j], v0y = rows[1][j], v0z = rows[2][j];
            const float e1x = rows[3][j], e1y = rows[4][j], e1z = rows[5][j];
            const float e2x = rows[6][j], e2y = rows[7][j], e2z = rows[8][j];
            const float px = dy * e2z - dz * e2y;
            const float py = dz * e2x - dx * e2z;
            const float pz = dx * e2y - dy * e2x;
            const float det = e1x * px + e1y * py + e1z * pz;
            const bool det_ok = fabsf(det) > kEps;
            const float inv_det =
                det_ok ? 1.0f / (det == 0.0f ? 1.0f : det) : 0.0f;
            const float sx = ox - v0x;
            const float sy = oy - v0y;
            const float sz = oz - v0z;
            const float u = (sx * px + sy * py + sz * pz) * inv_det;
            const float qx = sy * e1z - sz * e1y;
            const float qy = sz * e1x - sx * e1z;
            const float qz = sx * e1y - sy * e1x;
            const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
            const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
            const bool ok = det_ok && u >= 0.0f && v >= 0.0f
                            && u + v <= 1.0f && t >= tmin && t < tmax;
            const int32_t id = ids[j];
            // the least t, the lowest id on equal t (-0 == +0)
            if (ok && (best_id < 0 || t < best_t
                       || (t == best_t && id < best_id))) {
                best_t = t;
                best_id = id;
                best_u = u;
                best_v = v;
            }
        }
    }
    const bool hit = best_id >= 0;
    out_t[i] = hit ? best_t : tmax;
    out_tri[i] = best_id;
    out_u[i] = hit ? best_u : 0.0f;
    out_v[i] = hit ? best_v : 0.0f;
}

}  // namespace

// The closest hit of each of the n_tiles * 128 rays (tile g: lanes
// [128 g, 128 g + 128)) among the triangles of its tile's CSR list
// (tri_id[tile_start[g]:tile_start[g + 1]], rows of the (rows, 9) f32
// table v0, e1, e2) in [t_min, t_max): t, the triangle's id, u, v; t_max,
// -1, 0, 0 where none is hit or the lane is inactive.
extern "C" int dxrpt_raster_closest_hit(
        const int32_t* tile_start, const int32_t* tri_id, int64_t n_tiles,
        const float* table, int64_t rows, const float* ray_o,
        const float* ray_d, const float* t_min, const float* t_max,
        const uint8_t* active, float* out_t, int32_t* out_tri, float* out_u,
        float* out_v, void* stream) {
    if (n_tiles <= 0) return 0;
    if (rows < 1 || n_tiles > 0x7FFFFFFF)
        return static_cast<int>(cudaErrorInvalidValue);
    raster_kernel<<<static_cast<unsigned>(n_tiles), kTile, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        tile_start, tri_id, table, ray_o, ray_d, t_min, t_max, active, out_t,
        out_tri, out_u, out_v);
    return static_cast<int>(cudaGetLastError());
}

// Warps of the kernel that one SM of the current device holds at once, or
// minus the CUDA error code.
extern "C" int dxrpt_raster_resident_warps() {
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, raster_kernel, kTile, 0);
    return err != cudaSuccess ? -static_cast<int>(err)
                              : blocks * (kTile / 32);
}
