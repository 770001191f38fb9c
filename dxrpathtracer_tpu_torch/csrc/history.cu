// Temporal hit reuse's revalidation for sm_90a: each lane's predicted
// triangle (last sample's hit or occluder) tested against this sample's ray.
//
// What it replaces. dxrpathtracer_tpu/accel/history.py::_intersect_pred
// (:50), which XLA runs on the TPU as one (N, 9) row gather and an
// elementwise Moller-Trumbore: row max(pred, 0) of the (T, 9) f32 table
// (v0, e1, e2), the leaf test's expression, and ok where the prediction is
// a triangle, |det| > 1e-12, u, v >= 0, u + v <= 1 and t in [t_min, t_max).
//
// What bounds it on the card. Bytes: each lane reads its prediction (4 B),
// its ray (33 B) and one 36 B table row, and writes 13 B; its ~55 f32
// operations are few against that. Neighbouring lanes of a tile-ordered
// frame predict the same or neighbouring triangles, so many rows come from
// L2; the least the card moves is each distinct row once.
//
// What the design does about it. One thread per lane, no shared memory and
// no synchronisation: consecutive threads read consecutive ray and
// prediction words, and each reads its nine row words through the
// read-only path. t, u and v are written on every lane (an inactive lane or
// one without a prediction tests row 0, as the JAX function does), so the
// outputs match the plain version bit for bit on every lane.
//
// Exactness. Build with --fmad=false and without fast-math: every product is
// rounded on its own and the division is IEEE, as in the plain torch version
// (accel/history.py::revalidate_plain) and the JAX package's expression, in
// the same order.
//
// Plain C interface for ctypes: the launcher returns the CUDA error code of
// the launch (0 on success) and never synchronises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr float kEps = 1e-12f;

__global__ void __launch_bounds__(kBlock)
revalidate_kernel(const float* __restrict__ table, int64_t rows,
                  const int32_t* __restrict__ pred,
                  const float* __restrict__ ray_o,
                  const float* __restrict__ ray_d,
                  const float* __restrict__ t_min,
                  const float* __restrict__ t_max,
                  const uint8_t* __restrict__ active, int64_t n,
                  uint8_t* __restrict__ out_ok, float* __restrict__ out_t,
                  float* __restrict__ out_u, float* __restrict__ out_v) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
    if (i >= n) return;
    const int32_t p = pred[i];
    int64_t r = p > 0 ? p : 0;
    if (r > rows - 1) r = rows - 1;
    const float* row = table + 9 * r;
    const float v0x = __ldg(row), v0y = __ldg(row + 1), v0z = __ldg(row + 2);
    const float e1x = __ldg(row + 3), e1y = __ldg(row + 4);
    const float e1z = __ldg(row + 5);
    const float e2x = __ldg(row + 6), e2y = __ldg(row + 7);
    const float e2z = __ldg(row + 8);
    const float ox = ray_o[3 * i], oy = ray_o[3 * i + 1], oz = ray_o[3 * i + 2];
    const float dx = ray_d[3 * i], dy = ray_d[3 * i + 1], dz = ray_d[3 * i + 2];
    const float px = dy * e2z - dz * e2y;
    const float py = dz * e2x - dx * e2z;
    const float pz = dx * e2y - dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const bool det_ok = fabsf(det) > kEps;
    const float inv_det = det_ok ? 1.0f / (det == 0.0f ? 1.0f : det) : 0.0f;
    const float sx = ox - v0x;
    const float sy = oy - v0y;
    const float sz = oz - v0z;
    const float u = (sx * px + sy * py + sz * pz) * inv_det;
    const float qx = sy * e1z - sz * e1y;
    const float qy = sz * e1x - sx * e1z;
    const float qz = sx * e1y - sy * e1x;
    const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
    const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
    const bool ok = active[i] != 0 && p >= 0 && p < rows && det_ok
                    && u >= 0.0f && v >= 0.0f && u + v <= 1.0f
                    && t >= t_min[i] && t < t_max[i];
    out_ok[i] = ok ? 1 : 0;
    out_t[i] = t;
    out_u[i] = u;
    out_v[i] = v;
}

}  // namespace

// ok[i] = 1 where lane i's predicted triangle pred[i] (a row of the (rows, 9)
// f32 table v0, e1, e2; -1 for none) is hit by its active ray at t in
// [t_min[i], t_max[i]); t, u and v of the test on every lane.
extern "C" int dxrpt_history_revalidate(
        const float* table, int64_t rows, const int32_t* pred,
        const float* ray_o, const float* ray_d, const float* t_min,
        const float* t_max, const uint8_t* active, int64_t n, uint8_t* ok,
        float* t, float* u, float* v, void* stream) {
    if (n <= 0) return 0;
    if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t blocks = (n + kBlock - 1) / kBlock;
    revalidate_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        table, rows, pred, ray_o, ray_d, t_min, t_max, active, n, ok, t, u,
        v);
    return static_cast<int>(cudaGetLastError());
}

// Warps of the kernel that one SM of the current device holds at once, or
// minus the CUDA error code.
extern "C" int dxrpt_history_resident_warps() {
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, revalidate_kernel, kBlock, 0);
    return err != cudaSuccess ? -static_cast<int>(err)
                              : blocks * (kBlock / 32);
}
