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
// each, so the work is the records' latency and their triangle tests. About
// half of a frame's sun rays are inactive, and chains run from 1 to 20
// records: with one thread per ray, half of every warp idles and a warp
// walks as long as its longest chain.
//
// What the design does about it. Persistent warps, each on its own (no
// block barrier, no shared memory), as many as the SMs hold at once. Each
// warp owns one contiguous range of ray ids and keeps a warp-local cursor
// into it.
//  - Fetch: the warp reads the next 32 `active` flags of its range (one
//    coalesced 32 B read) and one ballot gives the active ones. An inactive
//    ray gets its 1 right there and never takes lanes.
//  - Walk: a group of kGroup lanes walks one ray, 32 / kGroup rays a warp
//    at a time. Per step the group reads the record's tail (one 16 B read,
//    broadcast) and, in the same round trip, lane j of the group reads the
//    ten fields of triangles j, j + kGroup, ... (slot k of field f is word
//    12 f + k, so a group's lanes read consecutive words), tests them, and
//    one warp-wide ballot, masked to each group's lanes, gives every group
//    its record's verdict. With kGroup = 1 a lane reads each field as 16 B
//    vectors, four triangles at a time, and stops at the first four that
//    hold a blocker.
//  - Refill: a group whose ray ends (a blocker, the chain's end, the suffix
//    cut or max_iters) writes the ray's visibility and takes the warp's next
//    active ray, so a warp is held only by the last rays of its range, not
//    by its longest chain.
// A ray stops at the first record that holds a blocker, whatever order that
// record's 12 tests run in, so the visibility is an OR over the same
// triangles as the one-lane walk's.
// Measured on the H100 (PERF.md): one lane a ray (kGroup = 1) took 15-19 %
// less time than four (kGroup = 4) on the frame's and the bake's sun
// classes. Against one thread per ray in blocks, which the block scheduler
// hands out as SMs free up, the fixed ranges win where the record steps
// spread evenly over them (the bake's depth-2 class: the busiest range
// holds 2.0x the mean range's steps) and lose where they crowd into a few
// (the bake's depth-1 class: 3.1x).
//
// Alpha testing (the kAlpha instantiation, entry dxrpt_sun_any_hit_alpha):
// a triangle that passes the geometric test blocks the ray only if the
// alpha test of csrc/alpha.cuh accepts it at the hit's (u, v), inside the
// walk and before a blocker ends it, as the JAX package's
// sun_any_hit(accept_fn=...) applies its accept_fn in the leaf test
// (accel/sunspace.py:267-268, traverse.py::_intersect_leaf). No JAX caller
// passes one, and no route of the port sends sun rays here; its plain
// version is accel/sunspace.py::sun_any_hit_plain with accept_fn. The
// opaque instantiation compiles without any of it.
//
// Exactness. Build with --fmad=false and without fast-math. The projection
// sums left to right, thr = (origin . w) + t_min, the cell is floor, then
// clip, then conversion to int32 (NaN to 0), and the triangle test is the
// same expression as csrc/traverse.cu's, so visibility equals the plain torch
// version (accel/sunspace.py) and the per-ray any_hit on every lane.
//
// Plain C interface for ctypes: the launcher returns the CUDA error code of
// the launch (0 on success) and never synchronises.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "alpha.cuh"

namespace {

constexpr int kGroup = 1;            // lanes that walk one ray together
constexpr int kWarps = 4;            // warps per block, each on its own
constexpr int kBlock = kWarps * 32;
constexpr int kRecord = 128;         // f32 slots per record
constexpr int kLeafSize = 12;        // triangles per record
constexpr int kFields = 10;          // v0, e1, e2 (x, y, z each), triangle id
constexpr int kTail = kFields * kLeafSize;  // next code, suffix-, own-zmax
constexpr int kSlots = kLeafSize / kGroup;  // triangles per lane per record
// slots a lane reads at once: a lane alone on its ray reads each field in
// 16 B vectors of four slots, a lane of a group all of its slots
constexpr int kBatch = kGroup == 1 ? 4 : kSlots;
constexpr int32_t kDone = 0x7FFFFFFF;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned kGroupBits = (1u << kGroup) - 1u;
constexpr float kEps = 1e-12f;
static_assert(32 % kGroup == 0 && kLeafSize % kGroup == 0
                  && kSlots % kBatch == 0,
              "a group divides the warp and the record");

// the first lane of every group
constexpr unsigned leader_lanes() {
    unsigned m = 0;
    for (int l = 0; l < 32; l += kGroup) m |= 1u << l;
    return m;
}
constexpr unsigned kLeaders = leader_lanes();

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

// The sun-plane cell coordinate of a projected point: floor((p - g0) * inv),
// clipped to [0, S - 1], then converted to int32 (NaN converts to 0).
__device__ __forceinline__ int32_t cell(float p, float g0, float inv, int s) {
    const float f = floorf((p - g0) * inv);
    return __float2int_rz(nan_min(nan_max(f, 0.0f),
                                  static_cast<float>(s - 1)));
}

struct Ray {
    float ox, oy, oz, dx, dy, dz, tmin, tmax;
};

// Whether the triangle (v0, e1, e2, id) blocks the ray within [tmin, tmax):
// Moller-Trumbore as csrc/traverse.cu's `triangle`, then, with kAlpha, the
// alpha test at its (u, v).
template <bool kAlpha>
__device__ __forceinline__ bool triangle_blocks(
        float v0x, float v0y, float v0z, float e1x, float e1y, float e1z,
        float e2x, float e2y, float e2z, int32_t id, const Ray& r,
        const AlphaScene& alpha) {
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
    bool ok = id >= 0 && det_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f
              && t >= r.tmin && t < r.tmax;
    if (kAlpha && ok) ok = alpha_accept(alpha, id, u, v);
    return ok;
}

// Slots first + kGroup * s (s < kN) of the record's ten fields.
template <int kN>
__device__ __forceinline__ void load_slots(const float* __restrict__ rec,
                                           int first,
                                           float (&fld)[kFields][kN]) {
    if constexpr (kGroup == 1) {
        static_assert(kN == 4, "one 16 B vector per field");
#pragma unroll
        for (int f = 0; f < kFields; ++f) {
            const float4 v = __ldg(
                reinterpret_cast<const float4*>(rec + f * kLeafSize + first));
            fld[f][0] = v.x;
            fld[f][1] = v.y;
            fld[f][2] = v.z;
            fld[f][3] = v.w;
        }
    } else {
#pragma unroll
        for (int f = 0; f < kFields; ++f)
#pragma unroll
            for (int s = 0; s < kN; ++s)
                fld[f][s] = __ldg(rec + f * kLeafSize + first + kGroup * s);
    }
}

// Whether one of the loaded slots blocks the ray (every slot is tested).
template <bool kAlpha, int kN>
__device__ __forceinline__ bool slots_block(const float (&fld)[kFields][kN],
                                            const Ray& r,
                                            const AlphaScene& alpha) {
    bool hit = false;
#pragma unroll
    for (int s = 0; s < kN; ++s)
        hit |= triangle_blocks<kAlpha>(
            fld[0][s], fld[1][s], fld[2][s], fld[3][s], fld[4][s], fld[5][s],
            fld[6][s], fld[7][s], fld[8][s], __float_as_int(fld[9][s]), r,
            alpha);
    return hit;
}

// params: gx0, gy0, inv_fx, inv_fy; basis: rows ax, ay, w. Warp w owns rays
// [w * span, (w + 1) * span) of n; span is a multiple of 32. alpha: the
// scene's shading rows and texels (read by the kAlpha instantiation only).
template <bool kAlpha>
__global__ void __launch_bounds__(kBlock)
sungrid_kernel(AlphaScene alpha, const float* __restrict__ table,
               const int32_t* __restrict__ index,
               const float* __restrict__ params,
               const float* __restrict__ basis, int grid_size,
               int32_t max_iters, const float* __restrict__ ray_o,
               const float* __restrict__ ray_d,
               const float* __restrict__ t_min,
               const float* __restrict__ t_max,
               const uint8_t* __restrict__ active, int64_t n, int64_t span,
               float* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int64_t warp =
        static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
    const int64_t begin = warp * span;
    if (begin >= n) return;  // the whole warp
    const int64_t end = begin + span < n ? begin + span : n;
    const int lead = lane & ~(kGroup - 1);  // the group's first lane
    const int j = lane - lead;              // the lane's place in its group
    const unsigned leaders_below = kLeaders & ((1u << lead) - 1u);

    // the warp's cursor (warp-uniform): the next ray id to fetch, and the
    // active rays of the last fetch that no group has taken yet
    int64_t fetch = begin;
    int64_t fetched = begin;  // ray id of bit 0 of `pending`
    unsigned pending = 0;

    // the group's ray (the same in each of its lanes)
    bool busy = false;
    int64_t ray = 0;
    Ray r{};
    float thr = 0.0f;
    int32_t cur = kDone;
    int32_t it = 0;

    for (;;) {
        // refill: every idle group takes the warp's next active ray
        for (;;) {
            const unsigned idle = ~__ballot_sync(kFull, busy) & kLeaders;
            if (idle == 0) break;
            if (pending == 0) {
                if (fetch >= end) break;
                const int64_t i = fetch + lane;
                const bool in = i < end;
                const bool on = in && active[i] != 0;
                if (in && !on) out[i] = 1.0f;
                pending = __ballot_sync(kFull, on);
                fetched = fetch;
                fetch += 32;
                continue;
            }
            const int takes = min(__popc(idle), __popc(pending));
            const int rank = __popc(idle & leaders_below);
            if (!busy && rank < takes) {
                unsigned m = pending;
                for (int k = 0; k < rank; ++k) m &= m - 1u;
                ray = fetched + (__ffs(m) - 1);
                r.ox = __ldg(ray_o + 3 * ray);
                r.oy = __ldg(ray_o + 3 * ray + 1);
                r.oz = __ldg(ray_o + 3 * ray + 2);
                r.dx = __ldg(ray_d + 3 * ray);
                r.dy = __ldg(ray_d + 3 * ray + 1);
                r.dz = __ldg(ray_d + 3 * ray + 2);
                r.tmin = __ldg(t_min + ray);
                r.tmax = __ldg(t_max + ray);
                const float px = r.ox * __ldg(basis) + r.oy * __ldg(basis + 1)
                                 + r.oz * __ldg(basis + 2);
                const float py = r.ox * __ldg(basis + 3)
                                 + r.oy * __ldg(basis + 4)
                                 + r.oz * __ldg(basis + 5);
                // an occluder needs a sun depth above the origin's + t_min
                thr = (r.ox * __ldg(basis + 6) + r.oy * __ldg(basis + 7)
                       + r.oz * __ldg(basis + 8)) + r.tmin;
                const int s = grid_size;
                const int32_t cx =
                    cell(px, __ldg(params), __ldg(params + 2), s);
                const int32_t cy =
                    cell(py, __ldg(params + 1), __ldg(params + 3), s);
                int64_t flat = static_cast<int64_t>(cy) * s + cx;
                flat = flat < 0 ? 0
                                : (flat >= static_cast<int64_t>(s) * s
                                       ? static_cast<int64_t>(s) * s - 1
                                       : flat);
                cur = __ldg(index + flat);
                it = 0;
                busy = cur != kDone;
                if (!busy && j == 0) out[ray] = 1.0f;  // an empty cell
            }
            for (int k = 0; k < takes; ++k) pending &= pending - 1u;
        }
        if (__ballot_sync(kFull, busy) == 0) break;  // the range is done

        // one record step of every busy group
        bool hit = false, walk_on = false;
        int32_t next = kDone;
        if (busy) {
            const float* __restrict__ rec =
                table + static_cast<int64_t>(~cur) * kRecord;
            const float4 tail =
                __ldg(reinterpret_cast<const float4*>(rec + kTail));
            float fld[kFields][kBatch];
            load_slots<kBatch>(rec, j, fld);
            next = __float_as_int(tail.x);
            walk_on = !(tail.y < thr);  // suffix-zmax: nothing further
            if (walk_on && tail.z >= thr) {  // own-zmax: test the record
                hit = slots_block<kAlpha, kBatch>(fld, r, alpha);
#pragma unroll 1
                for (int b = 1; b < kSlots / kBatch && !hit; ++b) {
                    load_slots<kBatch>(rec, j + kGroup * kBatch * b, fld);
                    hit = slots_block<kAlpha, kBatch>(fld, r, alpha);
                }
            }
        }
        const unsigned hits = __ballot_sync(kFull, hit);
        if (busy) {
            const bool blocked = ((hits >> lead) & kGroupBits) != 0u;
            ++it;
            if (blocked || !walk_on || next == kDone || it >= max_iters) {
                if (j == 0) out[ray] = blocked ? 0.0f : 1.0f;
                busy = false;
            } else {
                cur = next;
            }
        }
    }
}

// Warps of the kernel that one SM of the current device holds at once.
template <bool kAlpha>
cudaError_t resident_per_sm(int* warps) {
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, sungrid_kernel<kAlpha>, kBlock, 0);
    *warps = blocks * kWarps;
    return err;
}

// The persistent warps of the current device (its resident warps per SM
// times its SMs), worked out at the first launch on each device and kept
// (for each instantiation).
template <bool kAlpha>
cudaError_t resident_grid(int64_t* warps) {
    constexpr int kMaxDevices = 64;
    static std::atomic<int64_t> cache[kMaxDevices];  // 0: not yet known
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    int64_t w = cache[device].load(std::memory_order_relaxed);
    if (w == 0) {
        int sms = 0, per_sm = 0;
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
        if (err == cudaSuccess) err = resident_per_sm<kAlpha>(&per_sm);
        if (err != cudaSuccess) return err;
        if (per_sm < 1) return cudaErrorLaunchOutOfResources;
        w = static_cast<int64_t>(per_sm) * sms;
        cache[device].store(w, std::memory_order_relaxed);
    }
    *warps = w;
    return cudaSuccess;
}

template <bool kAlpha>
int launch(const AlphaScene& alpha, const float* table, const int32_t* index,
           const float* params, const float* basis, int32_t grid_size,
           int32_t max_iters, const float* ray_o, const float* ray_d,
           const float* t_min, const float* t_max, const uint8_t* active,
           int64_t n, float* out, void* stream) {
    if (n <= 0) return 0;
    if (grid_size < 1 || max_iters < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    int64_t resident = 0;
    const cudaError_t err = resident_grid<kAlpha>(&resident);
    if (err != cudaSuccess) return static_cast<int>(err);
    // each warp takes an equal run of whole 32-ray fetches, and no more
    // warps are launched than the rays fill
    const int64_t fetches = (n + 31) / 32;
    const int64_t per_warp = (fetches + resident - 1) / resident;
    const int64_t warps = (fetches + per_warp - 1) / per_warp;
    const int64_t blocks = (warps + kWarps - 1) / kWarps;
    sungrid_kernel<kAlpha><<<static_cast<unsigned>(blocks), kBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        alpha, table, index, params, basis, grid_size, max_iters, ray_o,
        ray_d, t_min, t_max, active, n, per_warp * 32, out);
    return static_cast<int>(cudaGetLastError());
}

template <bool kAlpha>
int resident_warps() {
    int warps = 0;
    const cudaError_t err = resident_per_sm<kAlpha>(&warps);
    return err != cudaSuccess ? -static_cast<int>(err) : warps;
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
    return launch<false>(AlphaScene{nullptr, nullptr}, table, index, params,
                         basis, grid_size, max_iters, ray_o, ray_d, t_min,
                         t_max, active, n, out, stream);
}

// The same with the alpha test: tri_shade (T, 64) f32 shading rows and
// texels (texels, 4) f32, the scene's (both non-null).
extern "C" int dxrpt_sun_any_hit_alpha(
        const float* table, const int32_t* index, const float* params,
        const float* basis, int32_t grid_size, int32_t max_iters,
        const float* tri_shade, const float* texels, const float* ray_o,
        const float* ray_d, const float* t_min, const float* t_max,
        const uint8_t* active, int64_t n, float* out, void* stream) {
    if (tri_shade == nullptr || texels == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    return launch<true>(AlphaScene{tri_shade, texels}, table, index, params,
                        basis, grid_size, max_iters, ray_o, ray_d, t_min,
                        t_max, active, n, out, stream);
}

// Warps of the opaque kernel that one SM of the current device holds at
// once (the persistent launch is this times the SM count), or minus the
// CUDA error code.
extern "C" int dxrpt_sungrid_resident_warps() {
    return resident_warps<false>();
}

// The same for the alpha-tested kernel.
extern "C" int dxrpt_sungrid_alpha_resident_warps() {
    return resident_warps<true>();
}
