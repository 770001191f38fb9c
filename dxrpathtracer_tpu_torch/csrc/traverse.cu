// Per-ray wide-BVH traversal for Hopper (sm_90a): one CUDA thread per ray
// walks the whole tree in one launch.
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
// leaf slot), so tri ids agree exactly, equal-t ties included.
//
// What bounds it on the card. Each step is one dependent 512 B record load
// whose address comes from the previous step: about 30-160 of them per ray,
// latency-bound, and neighbouring threads rarely read the same record, so
// there is no reuse across threads. This first version is one simple thread
// per ray with its stack in local memory, because it has to be right first.
// Making it fast is later work: warp-cooperative record loads, treelet
// prefetch into shared memory, persistent threads that refill idle lanes.
//
// Exactness. Build with --fmad=false and without fast-math: every product
// is rounded on its own and every division is IEEE, as in the plain torch
// version. min/max propagate NaN as torch.minimum/jnp.minimum do.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRecord = 128;      // f32 slots per record
constexpr int kLeafSize = 12;     // triangles per leaf record
constexpr int kMaxStack = 64;     // (node, mask) entries; the wrapper checks
constexpr float kBig = 3e38f;     // "no hit" key
constexpr float kEps = 1e-12f;    // determinant threshold
constexpr int32_t kAlphaTidBit = 1 << 30;

__device__ __forceinline__ float nan_min(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}

__device__ __forceinline__ float nan_max(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

// Child k of an internal record: its box and its code.
template <int W>
__device__ __forceinline__ void load_child(const float* __restrict__ rec,
                                           int k, float lo[3], float hi[3],
                                           int32_t& code) {
    if constexpr (W == 8) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            lo[a] = __ldg(rec + a * 8 + k);
            hi[a] = __ldg(rec + 24 + a * 8 + k);
        }
        code = __float_as_int(__ldg(rec + 48 + k));
    } else {
        // bf16 pairs, de-interleaved: slot j holds child j in its low 16 bits
        // and child j + W/2 in its high 16 bits; both widen exactly to f32.
        constexpr int H = W / 2;
        const int j = k % H;
        const bool high = k >= H;
        float v[6];
#pragma unroll
        for (int f = 0; f < 6; ++f) {
            const uint32_t u = __float_as_uint(__ldg(rec + f * H + j));
            v[f] = __uint_as_float(high ? (u & 0xFFFF0000u) : (u << 16));
        }
        lo[0] = v[0]; lo[1] = v[1]; lo[2] = v[2];
        hi[0] = v[3]; hi[1] = v[4]; hi[2] = v[5];
        code = __float_as_int(__ldg(rec + 3 * W + k));
    }
}

template <int W, bool kFirstHit>
__global__ void __launch_bounds__(128)
traverse_kernel(const float* __restrict__ table, int32_t done,
                int32_t root_code, int32_t stack_depth, int64_t max_iters,
                bool strip_alpha,
                const float* __restrict__ ray_o,
                const float* __restrict__ ray_d,
                const float* __restrict__ inv_d,
                const float* __restrict__ t_min,
                const float* __restrict__ t_max,
                const uint8_t* __restrict__ active, int64_t n,
                float* __restrict__ out_t, int32_t* __restrict__ out_tri,
                float* __restrict__ out_u, float* __restrict__ out_v) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
    if (i >= n) return;
    const uint32_t full = (W == 32) ? 0xFFFFFFFFu : ((1u << W) - 1u);

    const float ox = ray_o[3 * i], oy = ray_o[3 * i + 1], oz = ray_o[3 * i + 2];
    const float dx = ray_d[3 * i], dy = ray_d[3 * i + 1], dz = ray_d[3 * i + 2];
    const float ivx = inv_d[3 * i], ivy = inv_d[3 * i + 1];
    const float ivz = inv_d[3 * i + 2];
    const float tmin = t_min[i];

    float best_t = t_max[i];
    int32_t best_tri = -1;
    float best_u = 0.0f, best_v = 0.0f;

    int32_t cur = active[i] ? root_code : done;
    uint32_t pmask = full;
    int32_t sp = 0;
    int32_t snode[kMaxStack];
    uint32_t smask[kMaxStack];

    for (int64_t it = 0; it < max_iters && cur != done; ++it) {
        const bool is_leaf = cur < 0;
        const float* __restrict__ rec =
            table + static_cast<int64_t>(is_leaf ? ~cur : cur) * kRecord;
        bool any_child = false;
        int32_t near_code = 0;
        uint32_t rest_mask = 0;

        if (!is_leaf) {
            // ---- internal: slab-test the children pmask allows ----
            uint32_t hit_mask = 0;
            float near_key = __int_as_float(0x7f800000);  // +inf
            int near_slot = 0;
#pragma unroll 8
            for (int k = 0; k < W; ++k) {
                float lo[3], hi[3];
                int32_t code;
                load_child<W>(rec, k, lo, hi, code);
                const float tx0 = (lo[0] - ox) * ivx;
                const float tx1 = (hi[0] - ox) * ivx;
                const float ty0 = (lo[1] - oy) * ivy;
                const float ty1 = (hi[1] - oy) * ivy;
                const float tz0 = (lo[2] - oz) * ivz;
                const float tz1 = (hi[2] - oz) * ivz;
                const float tn = nan_max(
                    nan_max(nan_min(tx0, tx1), nan_min(ty0, ty1)),
                    nan_max(nan_min(tz0, tz1), tmin));
                const float tf = nan_min(
                    nan_min(nan_max(tx0, tx1), nan_max(ty0, ty1)),
                    nan_min(nan_max(tz0, tz1), best_t));
                // empty slots have inverted bounds: masked from the record,
                // since the slab result overflows to inf for steep rays
                const bool hit = (lo[0] <= hi[0]) && (tn <= tf)
                                 && ((pmask >> k) & 1u);
                const float key = hit ? tn : kBig;
                if (hit) hit_mask |= 1u << k;
                // strict < over ascending slots: the lowest slot wins ties
                // (for W32 this is _traverse's bank rule as well)
                if (key < near_key) {
                    near_key = key;
                    near_slot = k;
                    near_code = code;
                }
            }
            any_child = near_key < kBig;
            rest_mask = hit_mask & ~(1u << near_slot);
        } else {
            // ---- leaf: Moller-Trumbore over the 12 inline triangles ----
            float ck = __int_as_float(0x7f800000);
            int32_t ctid = 0;
            float cu = 0.0f, cv = 0.0f;
#pragma unroll 4
            for (int s = 0; s < kLeafSize; ++s) {
                const float v0x = __ldg(rec + s);
                const float v0y = __ldg(rec + kLeafSize + s);
                const float v0z = __ldg(rec + 2 * kLeafSize + s);
                const float e1x = __ldg(rec + 3 * kLeafSize + s);
                const float e1y = __ldg(rec + 4 * kLeafSize + s);
                const float e1z = __ldg(rec + 5 * kLeafSize + s);
                const float e2x = __ldg(rec + 6 * kLeafSize + s);
                const float e2y = __ldg(rec + 7 * kLeafSize + s);
                const float e2z = __ldg(rec + 8 * kLeafSize + s);
                int32_t tid = __float_as_int(__ldg(rec + 9 * kLeafSize + s));
                if (strip_alpha && tid >= 0) tid &= ~kAlphaTidBit;

                const float px = dy * e2z - dz * e2y;
                const float py = dz * e2x - dx * e2z;
                const float pz = dx * e2y - dy * e2x;
                const float det = e1x * px + e1y * py + e1z * pz;
                const bool det_ok = fabsf(det) > kEps;
                const float inv_det =
                    det_ok ? 1.0f / (det == 0.0f ? 1.0f : det) : 0.0f;
                const float tx = ox - v0x;
                const float ty = oy - v0y;
                const float tz = oz - v0z;
                const float u = (tx * px + ty * py + tz * pz) * inv_det;
                const float qx = ty * e1z - tz * e1y;
                const float qy = tz * e1x - tx * e1z;
                const float qz = tx * e1y - ty * e1x;
                const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
                const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
                // every slot is held against the best t from before the leaf
                const bool ok = tid >= 0 && det_ok && u >= 0.0f && v >= 0.0f
                                && u + v <= 1.0f && t >= tmin && t < best_t;
                const float key = ok ? t : kBig;
                if (key < ck) {
                    ck = key;
                    ctid = tid;
                    cu = u;
                    cv = v;
                }
            }
            if (ck < kBig) {
                best_t = ck;
                best_tri = ctid;
                // + 0.0f: -0 becomes +0, as the reference's masked sum gives
                best_u = cu + 0.0f;
                best_v = cv + 0.0f;
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
        if (kFirstHit && best_tri >= 0) {
            cur = done;  // accept the first hit and end the search
            sp = 0;
        }
    }

    out_t[i] = best_t;
    out_tri[i] = best_tri;
    out_u[i] = best_u;
    out_v[i] = best_v;
}

template <int W, bool kFirstHit>
void launch(cudaStream_t stream, int64_t n, const float* table, int32_t done,
            int32_t root_code, int32_t stack_depth, int64_t max_iters,
            bool strip_alpha, const float* o, const float* d,
            const float* inv_d, const float* t_min, const float* t_max,
            const uint8_t* active, float* out_t, int32_t* out_tri,
            float* out_u, float* out_v) {
    constexpr int kBlock = 128;
    const unsigned grid = static_cast<unsigned>((n + kBlock - 1) / kBlock);
    traverse_kernel<W, kFirstHit><<<grid, kBlock, 0, stream>>>(
        table, done, root_code, stack_depth, max_iters, strip_alpha, o, d,
        inv_d, t_min, t_max, active, n, out_t, out_tri, out_u, out_v);
}

}  // namespace

extern "C" int dxrpt_traverse(const float* table, int32_t num_rows,
                              int32_t root_code, int32_t stack_depth,
                              int64_t max_iters, int32_t width,
                              int32_t first_hit, int32_t strip_alpha,
                              const float* ray_o, const float* ray_d,
                              const float* inv_d, const float* t_min,
                              const float* t_max, const uint8_t* active,
                              int64_t n, float* out_t, int32_t* out_tri,
                              float* out_u, float* out_v, void* stream) {
    if (n <= 0) return 0;
    if (stack_depth < 1 || stack_depth > kMaxStack)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool strip = strip_alpha != 0;
    if (width == 8 && first_hit) {
        launch<8, true>(s, n, table, num_rows, root_code, stack_depth,
                        max_iters, strip, ray_o, ray_d, inv_d, t_min, t_max,
                        active, out_t, out_tri, out_u, out_v);
    } else if (width == 8) {
        launch<8, false>(s, n, table, num_rows, root_code, stack_depth,
                         max_iters, strip, ray_o, ray_d, inv_d, t_min, t_max,
                         active, out_t, out_tri, out_u, out_v);
    } else if (width == 32 && first_hit) {
        launch<32, true>(s, n, table, num_rows, root_code, stack_depth,
                         max_iters, strip, ray_o, ray_d, inv_d, t_min, t_max,
                         active, out_t, out_tri, out_u, out_v);
    } else if (width == 32) {
        launch<32, false>(s, n, table, num_rows, root_code, stack_depth,
                          max_iters, strip, ray_o, ray_d, inv_d, t_min, t_max,
                          active, out_t, out_tri, out_u, out_v);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
