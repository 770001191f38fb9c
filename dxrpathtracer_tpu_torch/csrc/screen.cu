// The two broadcast screens of the per-ray shadow and bounce walks, for
// sm_90a: the dense-proxy test (proxy_blocked) and the AABB-cut test
// (cut_clear); and the proxy's nearest hit (proxy_closest), which seeds the
// per-ray closest-hit walk's t_max.
//
// What they replace. dxrpathtracer_tpu/accel/proxy.py::proxy_blocked (:154)
// and ::cut_clear (:346), which XLA runs on the TPU as one fused (N, K)
// broadcast: every lane against the K largest opaque triangles (a
// Moller-Trumbore test each, any-reduced: a hit is a definitive occlusion),
// and every lane against C covering boxes of morton-contiguous triangle
// chunks (a slab test each with a relative + absolute slack; a lane that
// overlaps no box provably hits nothing).
//
// What bounds them on the card. The triangles (9 x K f32, 4.6 KB at K = 128)
// and the boxes (6 x C f32, 3 KB at C = 128) are the same for every lane;
// each lane reads its ray once (33 B) and writes one byte. A lane tests up
// to K triangles at 54 f32 operations each, or C boxes at 29, so the work
// is operations, not bytes: at most K * 54 per lane, fewer where a lane
// stops early. On the frame's terminal rays most lanes are blocked by one
// of the first few triangles and the rest need all K.
//
// What the design does about it. The block first copies the triangle or
// box columns into shared memory (the one block barrier), where lanes read
// them as broadcasts or, in the proxy's second phase, as consecutive words
// (no bank conflicts). A lane's verdict is an any-reduction, so a lane may
// stop at the first blocking triangle or the first box it may overlap, and
// the order of the tests cannot change it.
//  - The cut: one thread per lane, each box in turn.
//  - The proxy: a warp runs as long as its slowest lane, and a lane that no
//    triangle blocks tests all K, so one thread per lane over K keeps most
//    of a warp idle behind its unblocked lanes. Two phases in one launch
//    instead. Phase 1: each active lane tests its own ray against the first
//    kPhase1 triangles, which are the largest (the proxy is sorted by area),
//    so most blocked lanes stop there. Phase 2: the warp takes its active
//    lanes that are still undecided (a ballot), one ray at a time; lane l
//    tests triangles kPhase1 + l, kPhase1 + l + 32, ..., and the warp stops
//    that ray at the first round in which some lane finds a blocker
//    (__any_sync). Inactive lanes never enter it. kPhase1 = 16 measured
//    faster than 32 on the H100 (PERF.md).
//
//  - The proxy's nearest hit (dxrpathtracer_tpu/accel/proxy.py::
//    proxy_closest, :112): a closest hit needs every column, so there is no
//    early exit and no divergence to share out: one thread per lane walks
//    all K columns from shared memory, keeping the least t and the lowest
//    slot on equal t (a strict < over ascending slots), as JAX's min and
//    lowest-slot select give. Its work is K * 54 operations a lane.
//
// Exactness. Build with --fmad=false and without fast-math: every product is
// rounded on its own and the division is IEEE, as in the plain torch version
// (accel/proxy.py) and the JAX package's expressions, in the same order.
// min/max propagate NaN as torch.minimum/jnp.minimum do (PTX min.NaN).
//
// Plain C interface for ctypes: each launcher returns the CUDA error code of
// the launch (0 on success) and never synchronises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr float kEps = 1e-12f;
constexpr float kBig = 3e38f;  // the plain version's key of a lane's miss
constexpr unsigned kFull = 0xFFFFFFFFu;
// proxy triangles a lane tests on its own before its warp shares out the
// rest (phase 1)
constexpr int kPhase1 = 16;

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

struct Segment {
    float ox, oy, oz, dx, dy, dz, tmin, tmax;
};

// Whether column j of `cols` (9 rows of k) is hit in the segment, with the
// hit's t, u and v: Moller-Trumbore as the plain version computes it.
__device__ __forceinline__ bool proxy_test(const float* cols, int k, int j,
                                           const Segment& r, float& t_out,
                                           float& u_out, float& v_out) {
    const float v0x = cols[j], v0y = cols[k + j], v0z = cols[2 * k + j];
    const float e1x = cols[3 * k + j], e1y = cols[4 * k + j];
    const float e1z = cols[5 * k + j];
    const float e2x = cols[6 * k + j], e2y = cols[7 * k + j];
    const float e2z = cols[8 * k + j];
    const float px = r.dy * e2z - r.dz * e2y;
    const float py = r.dz * e2x - r.dx * e2z;
    const float pz = r.dx * e2y - r.dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const bool det_ok = fabsf(det) > kEps;
    const float inv_det = det_ok ? 1.0f / (det == 0.0f ? 1.0f : det) : 0.0f;
    const float sx = r.ox - v0x;
    const float sy = r.oy - v0y;
    const float sz = r.oz - v0z;
    const float u = (sx * px + sy * py + sz * pz) * inv_det;
    const float qx = sy * e1z - sz * e1y;
    const float qy = sz * e1x - sx * e1z;
    const float qz = sx * e1y - sy * e1x;
    const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
    const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
    t_out = t;
    u_out = u;
    v_out = v;
    return det_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f
           && t >= r.tmin && t < r.tmax;
}

// Whether column j of `cols` blocks the segment.
__device__ __forceinline__ bool proxy_hit(const float* cols, int k, int j,
                                          const Segment& r) {
    float t, u, v;
    return proxy_test(cols, k, j, r, t, u, v);
}

// tris: (9, k) f32 columns v0x v0y v0z e1x e1y e1z e2x e2y e2z.
__global__ void __launch_bounds__(kBlock)
proxy_kernel(const float* __restrict__ tris, int k,
             const float* __restrict__ ray_o, const float* __restrict__ ray_d,
             const float* __restrict__ t_min, const float* __restrict__ t_max,
             const uint8_t* __restrict__ active, int64_t n,
             uint8_t* __restrict__ out) {
    extern __shared__ float cols[];
    for (int j = threadIdx.x; j < 9 * k; j += blockDim.x) cols[j] = tris[j];
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
    // every lane of the warp stays to the end: phase 2 needs all 32
    const bool act = i < n && active[i] != 0;
    Segment mine{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (act)
        mine = Segment{ray_o[3 * i], ray_o[3 * i + 1], ray_o[3 * i + 2],
                       ray_d[3 * i], ray_d[3 * i + 1], ray_d[3 * i + 2],
                       t_min[i], t_max[i]};
    // phase 1: the lane's own ray against the first triangles
    const int head = min(k, kPhase1);
    bool blocked = false;
    if (act)
        for (int j = 0; j < head && !blocked; ++j)
            blocked = proxy_hit(cols, k, j, mine);
    // phase 2: the warp, one undecided ray at a time, 32 triangles a round
    uint32_t todo = __ballot_sync(kFull, act && !blocked && k > head);
    while (todo != 0) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const Segment r{__shfl_sync(kFull, mine.ox, src),
                        __shfl_sync(kFull, mine.oy, src),
                        __shfl_sync(kFull, mine.oz, src),
                        __shfl_sync(kFull, mine.dx, src),
                        __shfl_sync(kFull, mine.dy, src),
                        __shfl_sync(kFull, mine.dz, src),
                        __shfl_sync(kFull, mine.tmin, src),
                        __shfl_sync(kFull, mine.tmax, src)};
        bool hit = false;
        for (int base = head; base < k && !hit; base += 32) {
            const int j = base + lane;
            hit = __any_sync(kFull, j < k && proxy_hit(cols, k, j, r));
        }
        if (lane == src) blocked = hit;
    }
    if (i < n) out[i] = blocked ? 1 : 0;
}

// tris: (9, k) f32 columns as proxy_kernel's; ids: their (k,) triangle ids.
__global__ void __launch_bounds__(kBlock)
proxy_closest_kernel(const float* __restrict__ tris,
                     const int32_t* __restrict__ ids, int k,
                     const float* __restrict__ ray_o,
                     const float* __restrict__ ray_d,
                     const float* __restrict__ t_min,
                     const float* __restrict__ t_max,
                     const uint8_t* __restrict__ active, int64_t n,
                     float* __restrict__ out_t, int32_t* __restrict__ out_tri,
                     float* __restrict__ out_u, float* __restrict__ out_v) {
    extern __shared__ float cols[];
    for (int j = threadIdx.x; j < 9 * k; j += blockDim.x) cols[j] = tris[j];
    __syncthreads();
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
    if (i >= n) return;
    const float tmax = t_max[i];
    float best = kBig, bu = 0.0f, bv = 0.0f;
    int slot = -1;
    if (active[i]) {
        const Segment r{ray_o[3 * i], ray_o[3 * i + 1], ray_o[3 * i + 2],
                        ray_d[3 * i], ray_d[3 * i + 1], ray_d[3 * i + 2],
                        t_min[i], tmax};
        for (int j = 0; j < k; ++j) {
            float t, u, v;
            // strict < over ascending slots: the lowest slot wins a tie
            if (proxy_test(cols, k, j, r, t, u, v) && t < best) {
                best = t;
                bu = u;
                bv = v;
                slot = j;
            }
        }
    }
    const bool win = slot >= 0;
    out_t[i] = win ? best : tmax;
    out_tri[i] = win ? ids[slot] : -1;
    // + 0.0f: -0 becomes +0, as the reference's masked sum gives
    out_u[i] = win ? bu + 0.0f : 0.0f;
    out_v[i] = win ? bv + 0.0f : 0.0f;
}

// boxes: (6, c) f32 columns lox loy loz hix hiy hiz.
__global__ void __launch_bounds__(kBlock)
cut_kernel(const float* __restrict__ boxes, int c,
           const float* __restrict__ ray_o, const float* __restrict__ ray_d,
           const float* __restrict__ t_min, const float* __restrict__ t_max,
           const uint8_t* __restrict__ active, int64_t n,
           uint8_t* __restrict__ out) {
    extern __shared__ float cols[];
    for (int j = threadIdx.x; j < 6 * c; j += blockDim.x) cols[j] = boxes[j];
    __syncthreads();
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
    if (i >= n) return;
    if (!active[i]) {
        out[i] = 0;
        return;
    }
    const float ox = ray_o[3 * i], oy = ray_o[3 * i + 1], oz = ray_o[3 * i + 2];
    float inv[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const float d = ray_d[3 * i + a];
        // the sign-preserving nudge of near-zero components
        inv[a] = 1.0f / (fabsf(d) < kEps ? (d < 0.0f ? -kEps : kEps) : d);
    }
    const float tmin = t_min[i], tmax = t_max[i];
    bool maybe_hit = false;
    for (int j = 0; j < c && !maybe_hit; ++j) {
        const float t0x = (cols[j] - ox) * inv[0];
        const float t1x = (cols[3 * c + j] - ox) * inv[0];
        const float t0y = (cols[c + j] - oy) * inv[1];
        const float t1y = (cols[4 * c + j] - oy) * inv[1];
        const float t0z = (cols[2 * c + j] - oz) * inv[2];
        const float t1z = (cols[5 * c + j] - oz) * inv[2];
        const float enter =
            nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                    nan_max(nan_min(t0z, t1z), tmin));
        const float exit =
            nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                    nan_min(nan_max(t0z, t1z), tmax));
        const float slack = 1e-4f * fabsf(exit) + 1e-6f;
        maybe_hit = enter <= exit + slack;
    }
    out[i] = maybe_hit ? 0 : 1;
}

// Columns up to this many f32 fit the default 48 KB of shared memory.
constexpr int kMaxColumnFloats = 12 * 1024;

}  // namespace

// out[i] = 1 where an active lane's segment [t_min, t_max) hits one of the k
// proxy triangles (tris: (9, k) f32), else 0.
extern "C" int dxrpt_proxy_blocked(const float* tris, int32_t k,
                                   const float* ray_o, const float* ray_d,
                                   const float* t_min, const float* t_max,
                                   const uint8_t* active, int64_t n,
                                   uint8_t* out, void* stream) {
    if (n <= 0) return 0;
    if (k < 1 || 9 * k > kMaxColumnFloats)
        return static_cast<int>(cudaErrorInvalidValue);
    const int64_t blocks = (n + kBlock - 1) / kBlock;
    proxy_kernel<<<static_cast<unsigned>(blocks), kBlock,
                   9 * k * sizeof(float),
                   static_cast<cudaStream_t>(stream)>>>(
        tris, k, ray_o, ray_d, t_min, t_max, active, n, out);
    return static_cast<int>(cudaGetLastError());
}

// Each active lane's nearest hit among the k proxy triangles (tris: (9, k)
// f32, ids: (k,) i32) in [t_min, t_max), the lowest slot on equal t: t, the
// triangle's id, u and v; t_max, -1, 0, 0 where none is hit.
extern "C" int dxrpt_proxy_closest(const float* tris, const int32_t* ids,
                                   int32_t k, const float* ray_o,
                                   const float* ray_d, const float* t_min,
                                   const float* t_max, const uint8_t* active,
                                   int64_t n, float* out_t, int32_t* out_tri,
                                   float* out_u, float* out_v, void* stream) {
    if (n <= 0) return 0;
    if (k < 1 || 9 * k > kMaxColumnFloats)
        return static_cast<int>(cudaErrorInvalidValue);
    const int64_t blocks = (n + kBlock - 1) / kBlock;
    proxy_closest_kernel<<<static_cast<unsigned>(blocks), kBlock,
                           9 * k * sizeof(float),
                           static_cast<cudaStream_t>(stream)>>>(
        tris, ids, k, ray_o, ray_d, t_min, t_max, active, n, out_t, out_tri,
        out_u, out_v);
    return static_cast<int>(cudaGetLastError());
}

// out[i] = 1 where an active lane's segment overlaps none of the c boxes
// (boxes: (6, c) f32) by the slab test with slack, else 0.
extern "C" int dxrpt_cut_clear(const float* boxes, int32_t c,
                               const float* ray_o, const float* ray_d,
                               const float* t_min, const float* t_max,
                               const uint8_t* active, int64_t n, uint8_t* out,
                               void* stream) {
    if (n <= 0) return 0;
    if (c < 1 || 6 * c > kMaxColumnFloats)
        return static_cast<int>(cudaErrorInvalidValue);
    const int64_t blocks = (n + kBlock - 1) / kBlock;
    cut_kernel<<<static_cast<unsigned>(blocks), kBlock, 6 * c * sizeof(float),
                 static_cast<cudaStream_t>(stream)>>>(
        boxes, c, ray_o, ray_d, t_min, t_max, active, n, out);
    return static_cast<int>(cudaGetLastError());
}

// Warps of the proxy (proxy 1, with k columns), proxy_closest (proxy 2,
// with k columns) or cut (proxy 0, with k boxes) kernel that one SM of the
// current device holds at once, or minus the CUDA error code.
extern "C" int dxrpt_screen_resident_warps(int32_t proxy, int32_t k) {
    int blocks = 0;
    const cudaError_t err =
        proxy == 2 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &blocks, proxy_closest_kernel, kBlock,
                         9 * k * sizeof(float))
        : proxy ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &blocks, proxy_kernel, kBlock, 9 * k * sizeof(float))
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &blocks, cut_kernel, kBlock, 6 * k * sizeof(float));
    return err != cudaSuccess ? -static_cast<int>(err)
                              : blocks * (kBlock / 32);
}
