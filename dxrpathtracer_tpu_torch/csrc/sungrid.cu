// Sun-shadow visibility through the sun-space grid, for sm_90a.
//
// What it replaces. dxrpathtracer_tpu/accel/sunspace.py::sun_any_hit (:267),
// which XLA runs on the TPU as a lockstep while_loop over all sun rays with
// compaction phases. Every sun ray of a frame has the same direction, so in a
// basis whose third axis is the sun each ray is vertical: its origin projects
// to one cell of an S x S grid (closed form, no descent), and the cell's
// index entry heads one chain of 512 B records, each holding 12 world-space
// triangles in the leaf layout of accel/bvh.py plus [next code, suffix-zmax,
// own-zmax]. A ray walks its chain until a triangle blocks it (visibility
// 0), the chain ends, or the suffix-zmax (the highest sun depth of this
// record and everything after it) falls below the ray's own sun depth plus
// t_min: nothing further along can lie between it and the sun. A record
// whose own-zmax is below that depth is skipped untested.
//
// What bounds it on the card. Each ray reads its 33 B, one 4 B index entry,
// and then one dependent 512 B record per chain step, and writes 4 B. The
// records of a frame (about 50 MB for a quarter-million triangles) sit
// mostly in the 50 MB L2, and a step tests 12 triangles at 54 f32 operations
// each, so the work is the records' latency and their triangle tests.
//
// What the design does about it. One thread per ray, the grid one thread
// per ray: neighbouring pixels' shadow rays project to neighbouring cells
// and often walk the same chain, so a warp's record loads coalesce in L1 and
// L2. The chain's tail words are read first and decide whether the 480 B of
// triangles is read at all; the triangles come in as 16 B vectors. A ray
// stops at the first blocking triangle (any hit), as the reference's
// ACCEPT_FIRST_HIT_AND_END_SEARCH shadow rays do.
//
// Exactness. Build with --fmad=false and without fast-math. The projection
// sums left to right, thr = (origin . w) + t_min, the cell is floor, then
// clip, then conversion to int32 (NaN to 0), and the triangle test is the
// same expression as csrc/traverse.cu's, so visibility equals the plain torch
// version (accel/sunspace.py) and the per-ray any_hit on every lane.
//
// Plain C interface for ctypes: the launcher returns the CUDA error code of
// the launch (0 on success) and never synchronises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kRecord = 128;       // f32 slots per record
constexpr int kLeafSize = 12;      // triangles per record
constexpr int kNextSlot = 10 * kLeafSize;
constexpr int32_t kDone = 0x7FFFFFFF;
constexpr float kEps = 1e-12f;

__device__ __forceinline__ float nan_min(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

__device__ __forceinline__ float nan_max(float a, float b) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

__device__ __forceinline__ float component(const float4& v, int c) {
    return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

// The sun-plane cell coordinate of a projected point: floor((p - g0) * inv),
// clipped to [0, S - 1], then converted to int32 (NaN converts to 0).
__device__ __forceinline__ int32_t cell(float p, float g0, float inv, int s) {
    const float f = floorf((p - g0) * inv);
    return __float2int_rz(nan_min(nan_max(f, 0.0f),
                                  static_cast<float>(s - 1)));
}

// Whether one of the record's 12 triangles blocks the ray within
// [tmin, tmax): Moller-Trumbore as csrc/traverse.cu's `triangle`.
__device__ __forceinline__ bool record_blocks(
        const float4* __restrict__ rec, float ox, float oy, float oz,
        float dx, float dy, float dz, float tmin, float tmax) {
#pragma unroll 1
    for (int q = 0; q < 3; ++q) {
        float4 fld[10];
#pragma unroll
        for (int f = 0; f < 10; ++f) fld[f] = __ldg(rec + f * 3 + q);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const float v0x = component(fld[0], c);
            const float v0y = component(fld[1], c);
            const float v0z = component(fld[2], c);
            const float e1x = component(fld[3], c);
            const float e1y = component(fld[4], c);
            const float e1z = component(fld[5], c);
            const float e2x = component(fld[6], c);
            const float e2y = component(fld[7], c);
            const float e2z = component(fld[8], c);
            const int32_t id = __float_as_int(component(fld[9], c));
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
            if (id >= 0 && det_ok && u >= 0.0f && v >= 0.0f
                && u + v <= 1.0f && t >= tmin && t < tmax)
                return true;
        }
    }
    return false;
}

// params: gx0, gy0, inv_fx, inv_fy; basis: rows ax, ay, w.
__global__ void __launch_bounds__(kBlock)
sungrid_kernel(const float* __restrict__ table,
               const int32_t* __restrict__ index,
               const float* __restrict__ params,
               const float* __restrict__ basis, int grid_size,
               int32_t max_iters, const float* __restrict__ ray_o,
               const float* __restrict__ ray_d,
               const float* __restrict__ t_min,
               const float* __restrict__ t_max,
               const uint8_t* __restrict__ active, int64_t n,
               float* __restrict__ out) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
    if (i >= n) return;
    if (!active[i]) {
        out[i] = 1.0f;
        return;
    }
    const float ox = ray_o[3 * i], oy = ray_o[3 * i + 1], oz = ray_o[3 * i + 2];
    const float dx = ray_d[3 * i], dy = ray_d[3 * i + 1], dz = ray_d[3 * i + 2];
    const float tmin = t_min[i], tmax = t_max[i];
    float b[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) b[k] = __ldg(basis + k);
    const float px = ox * b[0] + oy * b[1] + oz * b[2];
    const float py = ox * b[3] + oy * b[4] + oz * b[5];
    // an occluder needs a sun depth above the origin's depth + t_min
    const float thr = (ox * b[6] + oy * b[7] + oz * b[8]) + tmin;
    const int s = grid_size;
    const int32_t cx = cell(px, __ldg(params), __ldg(params + 2), s);
    const int32_t cy = cell(py, __ldg(params + 1), __ldg(params + 3), s);
    int64_t flat = static_cast<int64_t>(cy) * s + cx;
    flat = flat < 0 ? 0 : (flat >= static_cast<int64_t>(s) * s
                           ? static_cast<int64_t>(s) * s - 1 : flat);
    int32_t cur = __ldg(index + flat);
    float vis = 1.0f;
    for (int32_t it = 0; it < max_iters && cur != kDone; ++it) {
        const float* __restrict__ rec =
            table + static_cast<int64_t>(~cur) * kRecord;
        const int32_t next = __float_as_int(__ldg(rec + kNextSlot));
        const float suffix_zmax = __ldg(rec + kNextSlot + 1);
        const float own_zmax = __ldg(rec + kNextSlot + 2);
        if (suffix_zmax < thr) break;  // nothing further can block
        if (own_zmax >= thr
            && record_blocks(reinterpret_cast<const float4*>(rec), ox, oy,
                             oz, dx, dy, dz, tmin, tmax)) {
            vis = 0.0f;
            break;
        }
        cur = next;
    }
    out[i] = vis;
}

}  // namespace

// out[i] = 0 where a triangle of the grid blocks active ray i within
// [t_min, t_max), else 1. table: (rows, 128) f32 chain records; index:
// (grid_size^2,) i32 chain heads; params (4,) and basis (3, 3) f32.
extern "C" int dxrpt_sun_any_hit(const float* table, const int32_t* index,
                                 const float* params, const float* basis,
                                 int32_t grid_size, int32_t max_iters,
                                 const float* ray_o, const float* ray_d,
                                 const float* t_min, const float* t_max,
                                 const uint8_t* active, int64_t n, float* out,
                                 void* stream) {
    if (n <= 0) return 0;
    if (grid_size < 1 || max_iters < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const int64_t blocks = (n + kBlock - 1) / kBlock;
    sungrid_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        table, index, params, basis, grid_size, max_iters, ray_o, ray_d,
        t_min, t_max, active, n, out);
    return static_cast<int>(cudaGetLastError());
}
