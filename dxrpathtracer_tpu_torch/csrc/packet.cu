// Packet traversal of a W8 BVH table, for sm_90a: 128 coherent rays walk the
// tree together, closest hit or any hit.
//
// What it replaces. dxrpathtracer_tpu/accel/packet.py::_packet_traverse
// (:58), which XLA runs on the TPU as a while_loop over (packets, 128) lane
// blocks (packet_closest_hit :434, packet_any_hit :484). A packet is 128
// rays whose pixels form one tile (render/integrator.py's tile order), so
// they visit nearly the same nodes: the packet walks the union of their
// walks, one record read for all 128. At an internal node every live ray
// slab-tests the 8 children; a child is entered when some live ray hits it
// within [t_min, its best t], nearest first by the packet's least entry t
// (the lowest slot on ties), and the rest of the hit children are pushed as
// ONE (node, remaining-children mask) entry. At a leaf every live ray tests
// the 12 triangles. A live ray is an active one, and in any-hit mode one
// that has not yet found a hit; an any-hit packet stops once all of its
// active rays have.
//
// What bounds it on the card. A packet step reads one 512 B record and does
// 8 x 128 slab tests (27 f32 operations each) or 12 x 128 triangle tests
// (55 each); the tables (about 17 MB for a quarter-million triangles) sit in
// the 50 MB L2. So the work is operations, and what the packet saves is
// record reads: one per packet step instead of one per ray step.
//
// What the design does about it. One 128-thread block per packet, one thread
// per ray. Each step the block's first warp copies the record into shared
// memory as 32 16-byte vectors (one coalesced load), and every thread reads
// its words from there (broadcasts). The cull and the child order are block
// reductions: per child slot, a ballot and a warp minimum of the ordered-int
// entry distance in each warp, combined through shared memory. The walk
// state (node, mask, stack height) is block-uniform and every thread
// computes the step's verdicts alike; thread 0 alone keeps the (node, mask)
// stack (in its local memory, as csrc/traverse.cu's W8 walk does) and hands
// the next node and mask to the block through shared memory. A leaf's triangle tests are each thread's own.
//
// Exactness. Build with --fmad=false and without fast-math: every product is
// rounded on its own and every division is IEEE, as in the plain torch
// version (accel/packet.py), with the same slab and Moller-Trumbore
// expressions in the same order and the same tie rules (lowest child slot,
// lowest leaf slot); min/max propagate NaN (PTX min.NaN). Hits equal the
// plain version's bit for bit; against the per-ray walk t is equal, and the
// triangle may differ only where two triangles give the same t.
//
// Plain C interface for ctypes: the launcher returns the CUDA error code of
// the launch (0 on success) and never synchronises.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kPacket = 128;      // rays per packet = threads per block
constexpr int kWarps = kPacket / 32;
constexpr int kRecord = 128;      // f32 slots per record
constexpr int kLeafSize = 12;     // triangles per leaf record
constexpr int kWidth = 8;         // children per W8 internal record
constexpr int kMaxStack = 64;     // (node, mask) entries; the wrapper checks
constexpr unsigned kFull = 0xFFFFFFFFu;
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

// f32 <-> int32 whose signed order is the float order (-0 just below +0);
// defined for every value but NaN.
__device__ __forceinline__ int32_t ordered(float f) {
    const int32_t b = __float_as_int(f);
    return b ^ ((b >> 31) & 0x7FFFFFFF);
}

__device__ __forceinline__ float from_ordered(int32_t i) {
    return __int_as_float(i ^ ((i >> 31) & 0x7FFFFFFF));
}

struct Hit {
    float t;
    int32_t tri;
    float u, v;
};

template <bool kFirstHit>
__global__ void __launch_bounds__(kPacket)
packet_kernel(const float* __restrict__ table, int32_t done,
              int32_t root_code, int32_t stack_depth, int32_t max_iters,
              bool strip_alpha, const float* __restrict__ ray_o,
              const float* __restrict__ ray_d,
              const float* __restrict__ inv_d,
              const float* __restrict__ t_min,
              const float* __restrict__ t_max,
              const uint8_t* __restrict__ active,
              float* __restrict__ out_t, int32_t* __restrict__ out_tri,
              float* __restrict__ out_u, float* __restrict__ out_v) {
    __shared__ float4 rec4[kRecord / 4];
    __shared__ uint32_t warp_hits[kWarps][kWidth];
    __shared__ int32_t warp_min[kWarps][kWidth];
    __shared__ int32_t walk_cur;
    __shared__ uint32_t walk_mask;
    const float* rec = reinterpret_cast<const float*>(rec4);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kPacket
                      + threadIdx.x;

    const float ox = ray_o[3 * i], oy = ray_o[3 * i + 1], oz = ray_o[3 * i + 2];
    const float dx = ray_d[3 * i], dy = ray_d[3 * i + 1], dz = ray_d[3 * i + 2];
    const float ivx = inv_d[3 * i], ivy = inv_d[3 * i + 1];
    const float ivz = inv_d[3 * i + 2];
    const float tmin = t_min[i];
    const bool act = active[i] != 0;
    Hit best{t_max[i], -1, 0.0f, 0.0f};

    // the walk state: every thread holds the node and its mask; thread 0
    // alone keeps the stack and its height, and hands each step's next
    // node and mask to the block through shared memory
    int32_t cur = __syncthreads_or(act) ? root_code : done;
    uint32_t pmask = (1u << kWidth) - 1u;
    int32_t sp = 0;
    int32_t snode[kMaxStack];   // thread 0's
    uint32_t smask[kMaxStack];

    for (int32_t it = 0; it < max_iters && cur != done; ++it) {
        const bool is_leaf = cur < 0;
        const int64_t row = is_leaf ? ~cur : cur;
        __syncthreads();  // the last step's reads of shared memory are done
        if (threadIdx.x < kRecord / 4)
            rec4[threadIdx.x] = __ldg(reinterpret_cast<const float4*>(
                table + row * kRecord) + threadIdx.x);
        __syncthreads();
        const bool live = act && (!kFirstHit || best.tri < 0);
        const float prune_t = best.t;
        bool any_child = false;
        int32_t near_code = 0;
        uint32_t rest_mask = 0;

        if (!is_leaf) {
            // ---- internal: every live ray slab-tests the allowed slots ----
#pragma unroll
            for (int j = 0; j < kWidth; ++j) {
                // empty slots have inverted bounds in the record; a slot the
                // mask leaves out is not tested (block-uniform branches)
                if (!(rec[j] <= rec[24 + j]) || !((pmask >> j) & 1u))
                    continue;
                const float tx0 = (rec[j] - ox) * ivx;
                const float tx1 = (rec[24 + j] - ox) * ivx;
                const float ty0 = (rec[8 + j] - oy) * ivy;
                const float ty1 = (rec[32 + j] - oy) * ivy;
                const float tz0 = (rec[16 + j] - oz) * ivz;
                const float tz1 = (rec[40 + j] - oz) * ivz;
                const float tn =
                    nan_max(nan_max(nan_min(tx0, tx1), nan_min(ty0, ty1)),
                            nan_max(nan_min(tz0, tz1), tmin));
                const float tf =
                    nan_min(nan_min(nan_max(tx0, tx1), nan_max(ty0, ty1)),
                            nan_min(nan_max(tz0, tz1), prune_t));
                const bool ray_hit = live && tn <= tf;
                const uint32_t ballot = __ballot_sync(kFull, ray_hit);
                const int32_t m = __reduce_min_sync(
                    kFull, ordered(ray_hit ? tn : kBig));
                if (lane == 0) {
                    warp_hits[warp][j] = ballot;
                    warp_min[warp][j] = m;
                }
            }
            __syncthreads();
            // the packet's verdict per slot, and the nearest by a strict <
            // scan over ascending slots (the lowest slot wins ties)
            uint32_t hit_mask = 0;
            float near_key = __int_as_float(0x7f800000);  // +inf
            int near_slot = 0;
#pragma unroll
            for (int j = 0; j < kWidth; ++j) {
                float key = kBig;
                if (rec[j] <= rec[24 + j] && ((pmask >> j) & 1u)) {
                    uint32_t any = 0;
                    int32_t m = warp_min[0][j];
#pragma unroll
                    for (int w = 0; w < kWarps; ++w) {
                        any |= warp_hits[w][j];
                        m = min(m, warp_min[w][j]);
                    }
                    if (any != 0) {
                        key = from_ordered(m);
                        hit_mask |= 1u << j;
                    }
                }
                if (key < near_key) {
                    near_key = key;
                    near_slot = j;
                    near_code = __float_as_int(rec[48 + j]);
                }
            }
            any_child = near_key < kBig;
            rest_mask = hit_mask & ~(1u << near_slot);
        } else {
            // ---- leaf: each live ray tests the 12 triangles ----
            float ck = __int_as_float(0x7f800000);
            int32_t ctid = 0;
            float cu = 0.0f, cv = 0.0f;
            if (live) {
#pragma unroll 4
                for (int s = 0; s < kLeafSize; ++s) {
                    const float v0x = rec[s], v0y = rec[kLeafSize + s];
                    const float v0z = rec[2 * kLeafSize + s];
                    const float e1x = rec[3 * kLeafSize + s];
                    const float e1y = rec[4 * kLeafSize + s];
                    const float e1z = rec[5 * kLeafSize + s];
                    const float e2x = rec[6 * kLeafSize + s];
                    const float e2y = rec[7 * kLeafSize + s];
                    const float e2z = rec[8 * kLeafSize + s];
                    int32_t id = __float_as_int(rec[9 * kLeafSize + s]);
                    if (strip_alpha && id >= 0) id &= ~kAlphaTidBit;
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
                    // every slot is held against the best t from before the
                    // leaf
                    const bool ok = id >= 0 && det_ok && u >= 0.0f
                                    && v >= 0.0f && u + v <= 1.0f
                                    && t >= tmin && t < prune_t;
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

        // ---- the walk state, by thread 0: ONE (node, mask) push when
        // siblings remain; descend the nearest child, else pop ----
        const bool all_found =
            kFirstHit && !__syncthreads_or(act && best.tri < 0);
        if (threadIdx.x == 0) {
            if (!is_leaf && any_child && rest_mask != 0) {
                if (sp < stack_depth) {
                    snode[sp] = cur;
                    smask[sp] = rest_mask;
                }
                ++sp;
            }
            int32_t next = done;
            uint32_t next_mask = (1u << kWidth) - 1u;
            if (!is_leaf && any_child) {
                next = near_code;
            } else if (sp > 0) {
                const int top = sp - 1;
                next = top < stack_depth ? snode[top] : 0;
                next_mask = top < stack_depth ? smask[top] : 0u;
                sp = top;
            }
            if (all_found) {
                next = done;  // every active ray has found a hit
                sp = 0;
            }
            walk_cur = next;
            walk_mask = next_mask;
        }
        __syncthreads();
        cur = walk_cur;
        pmask = walk_mask;
    }

    out_t[i] = best.t;
    out_tri[i] = best.tri;
    out_u[i] = best.u;
    out_v[i] = best.v;
}

template <bool kFirstHit>
cudaError_t launch(cudaStream_t stream, int64_t packets, const float* table,
                   int32_t done, int32_t root_code, int32_t stack_depth,
                   int32_t max_iters, bool strip_alpha, const float* o,
                   const float* d, const float* inv_d, const float* t_min,
                   const float* t_max, const uint8_t* active, float* out_t,
                   int32_t* out_tri, float* out_u, float* out_v) {
    packet_kernel<kFirstHit>
        <<<static_cast<unsigned>(packets), kPacket, 0, stream>>>(
            table, done, root_code, stack_depth, max_iters, strip_alpha, o, d,
            inv_d, t_min, t_max, active, out_t, out_tri, out_u, out_v);
    return cudaGetLastError();
}

}  // namespace

// Walks n rays (n a multiple of 128; rays 128p..128p+127 are packet p)
// through a W8 table: closest hit, or any hit when first_hit is set.
extern "C" int dxrpt_packet_traverse(const float* table, int32_t num_rows,
                                     int32_t root_code, int32_t stack_depth,
                                     int64_t max_iters, int32_t first_hit,
                                     int32_t strip_alpha, const float* ray_o,
                                     const float* ray_d, const float* inv_d,
                                     const float* t_min, const float* t_max,
                                     const uint8_t* active, int64_t n,
                                     float* out_t, int32_t* out_tri,
                                     float* out_u, float* out_v,
                                     void* stream) {
    if (n <= 0) return 0;
    if (n % kPacket != 0 || stack_depth < 1 || stack_depth > kMaxStack
        || max_iters < 1 || max_iters > INT32_MAX)
        return static_cast<int>(cudaErrorInvalidValue);
    const int32_t iters = static_cast<int32_t>(max_iters);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool strip = strip_alpha != 0;
    const int64_t packets = n / kPacket;
    const cudaError_t err =
        first_hit ? launch<true>(s, packets, table, num_rows, root_code,
                                 stack_depth, iters, strip, ray_o, ray_d,
                                 inv_d, t_min, t_max, active, out_t, out_tri,
                                 out_u, out_v)
                  : launch<false>(s, packets, table, num_rows, root_code,
                                  stack_depth, iters, strip, ray_o, ray_d,
                                  inv_d, t_min, t_max, active, out_t, out_tri,
                                  out_u, out_v);
    return static_cast<int>(err);
}
