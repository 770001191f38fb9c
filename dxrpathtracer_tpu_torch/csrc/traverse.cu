// Wide-BVH traversal for Hopper (sm_90a): the whole walk of every ray in one
// launch. W32 tables: one warp walks one ray, lane k testing child slot k,
// and persistent warps fetch their rays from a counter. W8 tables: one
// thread walks one ray, reading its records as 16 B vectors.
//
// What it replaces. The TPU kernel dxrpathtracer_tpu/accel/pallas_body.py::
// _kernel computes ONE lockstep step of the W8 walk for a tile of rays; the
// lax.while_loop around it in dxrpathtracer_tpu/accel/traverse.py::_traverse
// gathers each lane's next 512 B record and calls it again until every lane
// is done. Here the loop and the step are one kernel, and the step also
// handles the W32 layout with bf16 child boxes that _traverse's XLA body
// decodes (accel/traverse.py:107-142). The walk is the JAX package's, step
// for step: the same (node, remaining-children mask) stack, the same slab and
// Moller-Trumbore expressions, the same tie rules (lowest child slot, lowest
// leaf slot), so hits agree bit for bit, equal-t ties included.
//
// What bounds it on the card. Each step is one dependent 512 B record load
// whose address comes from the previous step, and a test of every child
// slot (27 f32 operations each) or every leaf triangle (55 each). The tables
// (about 17-19 MB each for a quarter-million triangles) sit in the 50 MB L2,
// so what limits the walk is the number of instructions per visit, how well
// the record loads coalesce and how much latency the resident warps hide.
//
// What the design does about it.
//  - W32 (every bounce and shadow ray past the first hit): the record was
//    laid out for 32 lanes, and a warp is 32 lanes. One warp takes one ray
//    and lane k tests child k; the record arrives in 7 coalesced loads per
//    lane (lanes k and k+16 share a bf16 pair word), the nearest child is
//    one redux.sync minimum plus one ballot, and control flow is uniform in
//    the warp, so scattered bounces no longer diverge. A leaf puts triangle
//    s on lane s. The walk state is warp-uniform and its (node, mask) stack
//    lives in the lanes' registers (entry e in lane e % 32), so nothing is
//    in local memory. The grid is exactly the warps the card holds at once;
//    each warp takes 32 rays at a time from a counter (one atomic, by lane
//    0) and walks the active ones in turn, so inactive rays and ragged walk
//    lengths cost little.
//  - W8 (camera rays and the first sun rays, coherent: neighbouring threads
//    read the same records): one thread per ray, each record read as 16 B
//    vectors, the grid one thread per ray. Measured on the H100 against
//    8 lanes per ray (the W32 scheme, four rays per warp) and against 4 B
//    loads, it was the fastest of the three (PERF.md, the W8 A/B).
//
// Alpha testing (kAlpha instantiations). A triangle that passes the
// geometric test is then alpha-tested, as DXR's any-hit shader does at each
// candidate (RayTrace.hlsl:485-507) and as the JAX package's in-loop
// accept_fn does (accel/traverse.py::_intersect_leaf): its 256 B shading row
// (scene/types.py pack_tri_shade) gives the material's has_opacity, the
// opacity texture's (base, w, h) and the three vertex UVs in one read; an
// opacity-mapped triangle takes one bilinear wrap tap of channel 0 at the
// hit's UV and is accepted iff the opacity is >= 0.35. A rejected triangle
// is no candidate; any-hit ends at the first accepted hit. On W8 tables
// built with alpha flags the leaf id's ALPHA_TID_BIT skips the row read for
// opaque triangles; W32 tables carry no flags, so every candidate reads its
// row. The JAX package's default route instead re-traverses past rejected
// hits from outside the loop (integrator.py::_punch_through_closest, for the
// TPU's lockstep loop, where an in-loop tap is paid on every leaf slot of
// every lane); a walk per thread or per warp pays the tap only at
// candidates. The opaque instantiations compile without any of this. The
// test itself (`alpha_accept`) is csrc/alpha.cuh's, shared with the grid.
//
// Exactness. Build with --fmad=false and without fast-math: every product
// is rounded on its own and every division is IEEE, as in the plain torch
// version. min/max propagate NaN as torch.minimum/jnp.minimum do (PTX
// min.NaN/max.NaN). The warp minimum reproduces the sequential strict-<
// scan: the lowest slot among the keys equal to the minimum wins (-0 == +0),
// and the winner's values are taken from the winning lane.

#include <atomic>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "alpha.cuh"

namespace {

constexpr int kRecord = 128;      // f32 slots per record
constexpr int kLeafSize = 12;     // triangles per leaf record
constexpr int kMaxStack = 64;     // (node, mask) entries; the wrapper checks
constexpr int kBlock = 128;       // threads per block
constexpr unsigned kWarp = 0xFFFFFFFFu;
constexpr float kBig = 3e38f;     // "no hit" key
constexpr float kEps = 1e-12f;    // determinant threshold
constexpr int32_t kAlphaTidBit = 1 << 30;
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

// One ray's slab test of one child box: (t_near, t_far).
__device__ __forceinline__ void slab(const float lo[3], const float hi[3],
                                     float ox, float oy, float oz, float ivx,
                                     float ivy, float ivz, float tmin,
                                     float best_t, float& tn, float& tf) {
    const float tx0 = (lo[0] - ox) * ivx;
    const float tx1 = (hi[0] - ox) * ivx;
    const float ty0 = (lo[1] - oy) * ivy;
    const float ty1 = (hi[1] - oy) * ivy;
    const float tz0 = (lo[2] - oz) * ivz;
    const float tz1 = (hi[2] - oz) * ivz;
    tn = nan_max(nan_max(nan_min(tx0, tx1), nan_min(ty0, ty1)),
                 nan_max(nan_min(tz0, tz1), tmin));
    tf = nan_min(nan_min(nan_max(tx0, tx1), nan_max(ty0, ty1)),
                 nan_min(nan_max(tz0, tz1), best_t));
}

struct Ray {
    float ox, oy, oz, dx, dy, dz, ivx, ivy, ivz, tmin;
};

struct Hit {
    float t;
    int32_t tri;
    float u, v;
};

// Moller-Trumbore of one leaf triangle, fields f of the record at
// rec[f * kLeafSize + s]: whether it is a hit nearer than best_t (and at or
// past tmin), with its t, u, v and id.
__device__ __forceinline__ bool triangle(const float f[10], const Ray& r,
                                         float best_t, bool strip_alpha,
                                         float& t, float& u, float& v,
                                         int32_t& id) {
    const float v0x = f[0], v0y = f[1], v0z = f[2];
    const float e1x = f[3], e1y = f[4], e1z = f[5];
    const float e2x = f[6], e2y = f[7], e2z = f[8];
    id = __float_as_int(f[9]);
    if (strip_alpha && id >= 0) id &= ~kAlphaTidBit;
    const float px = r.dy * e2z - r.dz * e2y;
    const float py = r.dz * e2x - r.dx * e2z;
    const float pz = r.dx * e2y - r.dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const bool det_ok = fabsf(det) > kEps;
    const float inv_det = det_ok ? 1.0f / (det == 0.0f ? 1.0f : det) : 0.0f;
    const float sx = r.ox - v0x;
    const float sy = r.oy - v0y;
    const float sz = r.oz - v0z;
    u = (sx * px + sy * py + sz * pz) * inv_det;
    const float qx = sy * e1z - sz * e1y;
    const float qy = sz * e1x - sx * e1z;
    const float qz = sx * e1y - sy * e1x;
    v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
    // every slot is held against the best t from before the leaf; alpha
    // testing's per-triangle accept_fn verdict joins this test
    return id >= 0 && det_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f
           && t >= r.tmin && t < best_t;
}

// ---------------------------------------------------------------------------
// W32: one warp per ray
// ---------------------------------------------------------------------------

// f32 <-> int32 whose signed order is the float order (-0 just below +0);
// defined for every value but NaN.
__device__ __forceinline__ int32_t ordered(float f) {
    const int32_t b = __float_as_int(f);
    return b ^ ((b >> 31) & 0x7FFFFFFF);
}

__device__ __forceinline__ float from_ordered(int32_t i) {
    return __int_as_float(i ^ ((i >> 31) & 0x7FFFFFFF));
}

// The warp minimum of keys that are never NaN, and the lowest lane whose
// key equals it (-0 == +0): a strict < scan over ascending lanes.
__device__ __forceinline__ int warp_argmin(float key, float& min_key) {
    min_key = from_ordered(__reduce_min_sync(kWarp, ordered(key)));
    return __ffs(__ballot_sync(kWarp, key == min_key)) - 1;
}

// One ray's whole walk on a W32 table by the 32 lanes of a warp; every lane
// returns the hit.
template <bool kFirstHit, bool kAlpha>
__device__ __forceinline__ Hit walk_w32(int lane,
                                        const float* __restrict__ table,
                                        int32_t done, int32_t root_code,
                                        int32_t stack_depth,
                                        int32_t max_iters, bool strip_alpha,
                                        const AlphaScene& alpha,
                                        const Ray r, float t_max) {
    static_assert(kMaxStack == 64, "the stack holds two entries per lane");
    // lane k's child in a bf16 pair word is its low half (k < 16) or its
    // high half; one byte permute widens it exactly to f32 (low: w << 16,
    // high: w & 0xFFFF0000)
    const uint32_t widen = lane < 16 ? 0x1044u : 0x3244u;
    const int j = lane & 15;
    // entry e of the (node, mask) stack: lane e % 32, slot e / 32
    int32_t node0 = 0, node1 = 0;
    uint32_t mask0 = 0u, mask1 = 0u;
    Hit best{t_max, -1, 0.0f, 0.0f};
    int32_t cur = root_code;
    uint32_t pmask = kWarp;
    int32_t sp = 0;

    for (int32_t it = 0; it < max_iters && cur != done; ++it) {
        const bool is_leaf = cur < 0;
        const float* __restrict__ rec =
            table + static_cast<int64_t>(is_leaf ? ~cur : cur) * kRecord;
        bool any_child = false;
        int32_t near_code = 0;
        uint32_t rest_mask = 0;

        if (!is_leaf) {
            // ---- internal: lane k slab-tests child k if pmask allows ----
            // bf16 pairs, de-interleaved: word j holds child j in its low 16
            // bits and child j + 16 in its high 16 bits
            float box[6];
#pragma unroll
            for (int f = 0; f < 6; ++f)
                box[f] = __uint_as_float(__byte_perm(
                    __float_as_uint(__ldg(rec + f * 16 + j)), 0u, widen));
            const int32_t code = __float_as_int(__ldg(rec + 96 + lane));
            float tn, tf;
            slab(box, box + 3, r.ox, r.oy, r.oz, r.ivx, r.ivy, r.ivz, r.tmin,
                 best.t, tn, tf);
            // empty slots have inverted bounds: masked from the record,
            // since the slab result overflows to inf for steep rays
            const bool hit = (box[0] <= box[3]) && (tn <= tf)
                             && ((pmask >> lane) & 1u);
            const uint32_t hit_mask = __ballot_sync(kWarp, hit);
            if (hit_mask != 0) {
                // the lowest slot among the keys equal to the minimum, as
                // _traverse's bank rule picks
                float near_key;
                const int near_slot = warp_argmin(hit ? tn : kBig, near_key);
                near_code = __shfl_sync(kWarp, code, near_slot);
                any_child = near_key < kBig;
                rest_mask = hit_mask & ~(1u << near_slot);
            }
        } else {
            // ---- leaf: Moller-Trumbore, triangle s on lane s ----
            float key = __int_as_float(0x7f800000);  // +inf: no slot
            float t = 0.0f, u = 0.0f, v = 0.0f;
            int32_t id = -1;
            if (lane < kLeafSize) {
                float f[10];
#pragma unroll
                for (int k = 0; k < 10; ++k)
                    f[k] = __ldg(rec + k * kLeafSize + lane);
                bool ok = triangle(f, r, best.t, strip_alpha, t, u, v, id);
                // a W32 table carries no alpha flags: every candidate
                // reads its material
                if (kAlpha && ok) ok = alpha_accept(alpha, id, u, v);
                key = ok ? t : kBig;
            }
            if (__ballot_sync(kWarp, key < kBig) != 0) {
                float m;
                const int wl = warp_argmin(key, m);
                best.t = __shfl_sync(kWarp, t, wl);
                best.tri = __shfl_sync(kWarp, id, wl);
                // + 0.0f: -0 becomes +0, as the reference's masked sum gives
                best.u = __shfl_sync(kWarp, u, wl) + 0.0f;
                best.v = __shfl_sync(kWarp, v, wl) + 0.0f;
            }
        }

        // ---- stack: ONE (node, mask) push when siblings remain ----
        if (!is_leaf && any_child && rest_mask != 0) {
            if (sp < stack_depth && lane == (sp & 31)) {
                if (sp < 32) {
                    node0 = cur;
                    mask0 = rest_mask;
                } else {
                    node1 = cur;
                    mask1 = rest_mask;
                }
            }
            ++sp;
        }
        // ---- next cursor: descend nearest, else pop (parent, mask) ----
        uint32_t next_mask = kWarp;
        if (!is_leaf && any_child) {
            cur = near_code;
        } else if (sp > 0) {
            const int top = sp - 1;
            if (top < stack_depth) {
                cur = __shfl_sync(kWarp, top < 32 ? node0 : node1, top & 31);
                next_mask = __shfl_sync(kWarp, top < 32 ? mask0 : mask1,
                                        top & 31);
            } else {
                cur = 0;
                next_mask = 0u;
            }
            sp = top;
        } else {
            cur = done;
        }
        pmask = next_mask;
        if (kFirstHit && best.tri >= 0) {
            cur = done;  // accept the first hit and end the search
            sp = 0;
        }
    }
    return best;
}

template <bool kFirstHit, bool kAlpha>
__global__ void __launch_bounds__(kBlock)
warp_kernel(const float* __restrict__ table, int32_t done, int32_t root_code,
            int32_t stack_depth, int32_t max_iters, bool strip_alpha,
            AlphaScene alpha, const float* __restrict__ ray_o, const float* __restrict__ ray_d,
            const float* __restrict__ inv_d, const float* __restrict__ t_min,
            const float* __restrict__ t_max,
            const uint8_t* __restrict__ active, int64_t n,
            unsigned long long* __restrict__ next_ray,
            float* __restrict__ out_t, int32_t* __restrict__ out_tri,
            float* __restrict__ out_u, float* __restrict__ out_v) {
    const int lane = static_cast<int>(threadIdx.x) & 31;
    const unsigned long long total = static_cast<unsigned long long>(n);
    for (;;) {
        // 32 rays for the warp: ray first + k belongs to lane k
        unsigned long long first = 0;
        if (lane == 0) first = atomicAdd(next_ray, 32ull);
        first = __shfl_sync(kWarp, first, 0);
        if (first >= total) break;
        const int64_t mine = static_cast<int64_t>(first) + lane;
        const bool in = mine < n;
        Hit res{in ? __ldg(t_max + mine) : 0.0f, -1, 0.0f, 0.0f};
        uint32_t todo = __ballot_sync(kWarp, in && active[mine] != 0);
        while (todo != 0) {
            const int j = __ffs(todo) - 1;
            todo &= todo - 1;
            const int64_t i = static_cast<int64_t>(first) + j;
            // every lane reads the same words: one broadcast load each
            const Ray r{__ldg(ray_o + 3 * i), __ldg(ray_o + 3 * i + 1),
                        __ldg(ray_o + 3 * i + 2), __ldg(ray_d + 3 * i),
                        __ldg(ray_d + 3 * i + 1), __ldg(ray_d + 3 * i + 2),
                        __ldg(inv_d + 3 * i), __ldg(inv_d + 3 * i + 1),
                        __ldg(inv_d + 3 * i + 2), __ldg(t_min + i)};
            const Hit h = walk_w32<kFirstHit, kAlpha>(
                lane, table, done, root_code, stack_depth, max_iters,
                strip_alpha, alpha, r, __ldg(t_max + i));
            if (lane == j) res = h;
        }
        if (in) {
            out_t[mine] = res.t;
            out_tri[mine] = res.tri;
            out_u[mine] = res.u;
            out_v[mine] = res.v;
        }
    }
}

// ---------------------------------------------------------------------------
// W8: one thread per ray
// ---------------------------------------------------------------------------

__device__ __forceinline__ float component(const float4& v, int c) {
    return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

template <bool kFirstHit, bool kAlpha>
__global__ void __launch_bounds__(kBlock)
thread_kernel(const float* __restrict__ table, int32_t done,
              int32_t root_code, int32_t stack_depth, int32_t max_iters,
              bool strip_alpha, AlphaScene alpha,
              const float* __restrict__ ray_o,
              const float* __restrict__ ray_d,
              const float* __restrict__ inv_d,
              const float* __restrict__ t_min,
              const float* __restrict__ t_max,
              const uint8_t* __restrict__ active, int64_t n,
              float* __restrict__ out_t, int32_t* __restrict__ out_tri,
              float* __restrict__ out_u, float* __restrict__ out_v) {
    constexpr uint32_t full = 0xFFu;
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
    if (i >= n) return;
    const Ray r{ray_o[3 * i], ray_o[3 * i + 1], ray_o[3 * i + 2],
                ray_d[3 * i], ray_d[3 * i + 1], ray_d[3 * i + 2],
                inv_d[3 * i], inv_d[3 * i + 1], inv_d[3 * i + 2], t_min[i]};
    Hit best{t_max[i], -1, 0.0f, 0.0f};
    int32_t cur = active[i] ? root_code : done;
    uint32_t pmask = full;
    int32_t sp = 0;
    int32_t snode[kMaxStack];
    uint32_t smask[kMaxStack];

    for (int32_t it = 0; it < max_iters && cur != done; ++it) {
        const bool is_leaf = cur < 0;
        const float4* __restrict__ rec = reinterpret_cast<const float4*>(
            table + static_cast<int64_t>(is_leaf ? ~cur : cur) * kRecord);
        bool any_child = false;
        int32_t near_code = 0;
        uint32_t rest_mask = 0;

        if (!is_leaf) {
            // ---- internal: slab-test the children pmask allows ----
            uint32_t hit_mask = 0;
            float near_key = __int_as_float(0x7f800000);  // +inf
            int near_slot = 0;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                // children 4h..4h+3: loX loY loZ hiX hiY hiZ code, a vector
                // of four each
                float4 fld[7];
#pragma unroll
                for (int f = 0; f < 7; ++f) fld[f] = __ldg(rec + f * 2 + h);
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int k = h * 4 + c;
                    float box[6];
#pragma unroll
                    for (int f = 0; f < 6; ++f) box[f] = component(fld[f], c);
                    float tn, tf;
                    slab(box, box + 3, r.ox, r.oy, r.oz, r.ivx, r.ivy, r.ivz,
                         r.tmin, best.t, tn, tf);
                    // empty slots have inverted bounds: masked from the
                    // record, since the slab result overflows to inf for
                    // steep rays
                    const bool hit = (box[0] <= box[3]) && (tn <= tf)
                                     && ((pmask >> k) & 1u);
                    const float key = hit ? tn : kBig;
                    if (hit) hit_mask |= 1u << k;
                    // strict < over ascending slots: the lowest slot wins
                    if (key < near_key) {
                        near_key = key;
                        near_slot = k;
                        near_code = __float_as_int(component(fld[6], c));
                    }
                }
            }
            any_child = near_key < kBig;
            rest_mask = hit_mask & ~(1u << near_slot);
        } else {
            // ---- leaf: Moller-Trumbore over the 12 inline triangles ----
            float ck = __int_as_float(0x7f800000);
            int32_t ctid = 0;
            float cu = 0.0f, cv = 0.0f;
#pragma unroll 1
            for (int q = 0; q < 3; ++q) {
                // triangles 4q..4q+3: each of the 10 fields a vector of four
                float4 fld[10];
#pragma unroll
                for (int f = 0; f < 10; ++f) fld[f] = __ldg(rec + f * 3 + q);
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    float f[10];
#pragma unroll
                    for (int k = 0; k < 10; ++k) f[k] = component(fld[k], c);
                    float t, u, v;
                    int32_t id;
                    bool ok = triangle(f, r, best.t, strip_alpha, t, u, v,
                                       id);
                    // with alpha flags, an unflagged triangle is opaque
                    if (kAlpha && ok
                        && (!strip_alpha
                            || (__float_as_int(f[9]) & kAlphaTidBit)))
                        ok = alpha_accept(alpha, id, u, v);
                    const float key = ok ? t : kBig;
                    if (key < ck) {
                        ck = key;
                        ctid = id;
                        cu = u;
                        cv = v;
                    }
                }
            }
            if (ck < kBig) {
                best.t = ck;
                best.tri = ctid;
                // + 0.0f: -0 becomes +0, as the reference's masked sum gives
                best.u = cu + 0.0f;
                best.v = cv + 0.0f;
            }
        }

        // ---- stack: ONE (node, mask) push when siblings remain ----
        if (!is_leaf && any_child && rest_mask != 0) {
            if (sp < stack_depth) {
                snode[sp] = cur;
                smask[sp] = rest_mask;
            }
            ++sp;
        }
        // ---- next cursor: descend nearest, else pop (parent, mask) ----
        uint32_t next_mask = full;
        if (!is_leaf && any_child) {
            cur = near_code;
        } else if (sp > 0) {
            const int top = sp - 1;
            cur = top < stack_depth ? snode[top] : 0;
            next_mask = top < stack_depth ? smask[top] : 0u;
            sp = top;
        } else {
            cur = done;
        }
        pmask = next_mask;
        if (kFirstHit && best.tri >= 0) {
            cur = done;  // accept the first hit and end the search
            sp = 0;
        }
    }

    out_t[i] = best.t;
    out_tri[i] = best.tri;
    out_u[i] = best.u;
    out_v[i] = best.v;
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <bool kFirstHit, bool kAlpha>
const void* kernel_for(int width) {
    if (width == 32) return reinterpret_cast<const void*>(
        warp_kernel<kFirstHit, kAlpha>);
    return reinterpret_cast<const void*>(thread_kernel<kFirstHit, kAlpha>);
}

// Blocks of the (width, first_hit, alpha) kernel that one SM holds at once.
cudaError_t resident_blocks(int width, bool first_hit, bool alpha,
                            int* blocks) {
    const void* fn =
        first_hit ? (alpha ? kernel_for<true, true>(width)
                           : kernel_for<true, false>(width))
                  : (alpha ? kernel_for<false, true>(width)
                           : kernel_for<false, false>(width));
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kBlock,
                                                         0);
}

// The W32 persistent grid on the current device: its resident blocks per SM
// times its SMs, worked out at the first launch on each device and kept.
cudaError_t resident_grid(bool first_hit, bool alpha, int64_t* grid) {
    constexpr int kMaxDevices = 64;
    static std::atomic<int64_t> cache[4][kMaxDevices];  // 0: not yet known
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    std::atomic<int64_t>& known =
        cache[(first_hit ? 1 : 0) + (alpha ? 2 : 0)][device];
    int64_t g = known.load(std::memory_order_relaxed);
    if (g == 0) {
        int sms = 0, per_sm = 0;
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
        if (err == cudaSuccess)
            err = resident_blocks(32, first_hit, alpha, &per_sm);
        if (err != cudaSuccess) return err;
        if (per_sm < 1) return cudaErrorLaunchOutOfResources;
        g = static_cast<int64_t>(per_sm) * sms;
        known.store(g, std::memory_order_relaxed);
    }
    *grid = g;
    return cudaSuccess;
}

template <bool kFirstHit, bool kAlpha>
cudaError_t launch(cudaStream_t stream, int width, int64_t n,
                   const float* table, int32_t done, int32_t root_code,
                   int32_t stack_depth, int32_t max_iters, bool strip_alpha,
                   const AlphaScene& alpha,
                   const float* o, const float* d, const float* inv_d,
                   const float* t_min, const float* t_max,
                   const uint8_t* active, unsigned long long* next_ray,
                   float* out_t, int32_t* out_tri, float* out_u,
                   float* out_v) {
    const int64_t blocks = (n + kBlock - 1) / kBlock;  // one thread per ray
    if (width == 8) {
        thread_kernel<kFirstHit, kAlpha>
            <<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(
                table, done, root_code, stack_depth, max_iters, strip_alpha,
                alpha, o, d, inv_d, t_min, t_max, active, n, out_t, out_tri,
                out_u, out_v);
        return cudaGetLastError();
    }
    // W32: the warps the card holds at once, and no more blocks than the
    // rays fill (a block takes kBlock rays per round)
    int64_t resident = 0;
    const cudaError_t err = resident_grid(kFirstHit, kAlpha, &resident);
    if (err != cudaSuccess) return err;
    const unsigned grid =
        static_cast<unsigned>(blocks < resident ? blocks : resident);
    warp_kernel<kFirstHit, kAlpha><<<grid, kBlock, 0, stream>>>(
        table, done, root_code, stack_depth, max_iters, strip_alpha, alpha, o,
        d, inv_d, t_min, t_max, active, n, next_ray, out_t, out_tri, out_u,
        out_v);
    return cudaGetLastError();
}

}  // namespace

// Walks n rays through a W8 or W32 table. next_ray: one zeroed 64-bit
// counter on the device, from which the W32 warps take their rays.
// tri_shade and texels: the scene's shading rows and texel pool for the
// alpha test, or both null for an opaque walk.
extern "C" int dxrpt_traverse(const float* table, int32_t num_rows,
                              int32_t root_code, int32_t stack_depth,
                              int64_t max_iters, int32_t width,
                              int32_t first_hit, int32_t strip_alpha,
                              const float* tri_shade, const float* texels,
                              const float* ray_o, const float* ray_d,
                              const float* inv_d, const float* t_min,
                              const float* t_max, const uint8_t* active,
                              int64_t n, void* next_ray, float* out_t,
                              int32_t* out_tri, float* out_u, float* out_v,
                              void* stream) {
    if (n <= 0) return 0;
    // a walk visits each (node, mask) at most once: max_iters, about twice
    // the table's rows, fits 32 bits for any table that fits the card
    const bool alpha = tri_shade != nullptr;
    if (stack_depth < 1 || stack_depth > kMaxStack
        || (width != 8 && width != 32) || max_iters < 1
        || max_iters > INT32_MAX || alpha != (texels != nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const int32_t iters = static_cast<int32_t>(max_iters);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto* counter = static_cast<unsigned long long*>(next_ray);
    const bool strip = strip_alpha != 0;
    const AlphaScene scene{tri_shade, texels};
    auto go = [&](auto first, auto with_alpha) {
        return launch<decltype(first)::value, decltype(with_alpha)::value>(
            s, width, n, table, num_rows, root_code, stack_depth, iters,
            strip, scene, ray_o, ray_d, inv_d, t_min, t_max, active, counter,
            out_t, out_tri, out_u, out_v);
    };
    using T = std::true_type;
    using F = std::false_type;
    const cudaError_t err =
        first_hit ? (alpha ? go(T{}, T{}) : go(T{}, F{}))
                  : (alpha ? go(F{}, T{}) : go(F{}, F{}));
    return static_cast<int>(err);
}

// Warps of the (width, first_hit, alpha) kernel that one SM holds at once
// (for W32 the persistent grid is this times the SM count); a negative CUDA
// error code on failure.
extern "C" int dxrpt_traverse_resident_warps(int32_t width,
                                             int32_t first_hit,
                                             int32_t alpha) {
    if (width != 8 && width != 32)
        return -static_cast<int>(cudaErrorInvalidValue);
    int blocks = 0;
    const cudaError_t err =
        resident_blocks(width, first_hit != 0, alpha != 0, &blocks);
    if (err != cudaSuccess) return -static_cast<int>(err);
    return blocks * (kBlock / 32);
}
