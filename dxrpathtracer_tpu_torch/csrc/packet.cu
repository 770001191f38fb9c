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
// record reads: one per packet step instead of one per ray step. What costs
// more than the operations is each step's dependent chain (record load,
// verdict, next node) and the lanes that hold dead rays.
//
// What the design does about it. One warp walks one packet, and a block
// holds kWarps independent packets: nothing in the kernel waits on another
// warp (no block barrier). A step puts the tests of 128 rays on 32 lanes,
// so what the design fights is the length of each step's dependent chain,
// which a long walk pays once per step.
//  - The rays: lane l's four slots hold rays 32 r + l (r = 0..3), so each
//    row's loads coalesce, with origin, direction, 1/d, t_min and best hit
//    in registers. A slot's test runs whether its ray is live or not and its
//    result is masked (no branch per ray), so the four rays' chains overlap.
//    In any-hit mode the live rays are compacted into the fewest rows (a
//    ballot per row, their ids through the warp's shared list) at the start
//    and after a leaf that leaves a row empty: a ray that finds its hit is
//    written out at once and drops out, and an inactive ray never walks.
//  - The record: each lane loads one 16-byte vector of it (one coalesced
//    512 B load) into the warp's own shared-memory slot; after __syncwarp
//    every lane reads its words from there as broadcasts. The slot is
//    double-buffered, so one __syncwarp a step orders the next step's store
//    after every lane's reads of the last.
//  - The verdict: per slot a lane ORs and mins over its own rays (the entry
//    t as an ordered int), then one __reduce_or_sync of the lanes' slot
//    masks and one __reduce_min_sync per slot give the packet's. OR and min
//    are the same over the 128 rays in any grouping, so the verdict is the
//    plain version's by construction; the nearest child is the same strict
//    < scan over ascending slots.
//  - The walk state (node, mask, stack height) is warp-uniform; the (node,
//    mask) stack lives in the lanes' registers, entry e in lane e % 32 (as
//    csrc/traverse.cu's W32 walk keeps it), pushed by one lane, popped by a
//    shuffle: no local-memory stack frame.
//  - An any-hit packet ends when no ray is left live, and a packet with no
//    active ray ends at once.
//
// The split alpha route's two modes (render/integrator.py), for a table with
// alpha flags (ALPHA_TID_BIT in the leaf ids). They replace
// _packet_traverse's exclude_alpha (:234) and collect_alpha (:254-310).
//  - Opaque-only (kExclude): a flagged triangle is skipped at the leaf
//    (a warp-uniform branch), so it neither wins nor bounds a ray.
//  - K candidates (kCand = K, a closest walk): a flagged hit is kept in the
//    ray's sorted buffer of K (t, tri, u, v) candidates instead, and a full
//    buffer bounds the ray at its last candidate's t. A leaf gives each ray
//    its two nearest flagged hits (JAX's LEAF_EXTRACT = 2; the lowest slot
//    on ties), each carried down the buffer by JAX's compare-and-swap
//    chain, and a ray with a third in the leaf sets its overflow bit. The
//    buffer is 128 rays x K x 4 words a warp (16 KiB at K = 8): it lives in
//    shared memory, each lane's rays in their own columns (no bank
//    conflict, no __syncwarp), and a block holds kCandWarps packets so that
//    it stays under the static 48 KiB. The leaf runs ray by ray (each ray's
//    two nearest in registers for one ray at a time) rather than slot by
//    slot.
// Measured on the H100 (PERF.md): masking instead of branching per
// ray and the any-hit compaction each shortened the walk; persistent warps
// taking packets from a counter, a register cap, and unrolling the leaf's
// triangle loop each lengthened it.
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
#include <cuda_runtime.h>

namespace {

constexpr int kPacket = 128;      // rays per packet
constexpr int kRays = kPacket / 32;  // rays per lane
constexpr int kWarps = 4;         // packets (warps) per block
constexpr int kCandWarps = 2;     // ... of the K-candidate walk
constexpr int kMaxCands = 8;      // K = 1..8 are instantiated
constexpr int kRecord = 128;      // f32 slots per record
constexpr int kLeafSize = 12;     // triangles per leaf record
constexpr int kWidth = 8;         // children per W8 internal record
constexpr int kMaxStack = 64;     // (node, mask) entries; the wrapper checks
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kAllSlots = (1u << kWidth) - 1u;
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

// The K-candidate buffer of the block's warps: [warp][slot k][field][ray],
// the fields t, tri (as bits), u and v.
template <int kCand, int kW>
__device__ __forceinline__ float* candidate_buffer() {
    __shared__ float buf[kW][kCand * 4][kPacket];
    return &buf[0][0][0];
}

template <bool kFirstHit, bool kExclude, int kCand>
__global__ void __launch_bounds__((kCand > 0 ? kCandWarps : kWarps) * 32)
packet_kernel(const float* __restrict__ table, int32_t done,
              int32_t root_code, int32_t stack_depth, int32_t max_iters,
              bool strip_alpha, const float* __restrict__ ray_o,
              const float* __restrict__ ray_d,
              const float* __restrict__ inv_d,
              const float* __restrict__ t_min,
              const float* __restrict__ t_max,
              const uint8_t* __restrict__ active, int64_t packets,
              float* __restrict__ out_t, int32_t* __restrict__ out_tri,
              float* __restrict__ out_u, float* __restrict__ out_v,
              float* __restrict__ cand_t, int32_t* __restrict__ cand_tri,
              float* __restrict__ cand_u, float* __restrict__ cand_v,
              uint8_t* __restrict__ overflow) {
    static_assert(kMaxStack == 64, "the stack holds two entries per lane");
    static_assert(!(kFirstHit && kCand > 0), "candidates: closest walks");
    constexpr int kW = kCand > 0 ? kCandWarps : kWarps;
    // each warp's record (double-buffered) and list of live ray ids
    __shared__ float4 rec4[kW][2][kRecord / 4];
    __shared__ int32_t live_ids[kW][kPacket];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int64_t packet = static_cast<int64_t>(blockIdx.x) * kW + warp;
    if (packet >= packets) return;  // the whole warp
    const int64_t base = packet * kPacket;

    // the lane's rays: slot r holds ray id[r] of the packet, at first
    // 32 r + lane; bit r of `live` is set while slot r's ray walks, and
    // slots r >= rows (warp-uniform) hold none
    int32_t id[kRays];
    float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
    float ivx[kRays], ivy[kRays], ivz[kRays], tmin[kRays];
    float bt[kRays], bu[kRays], bv[kRays];
    int32_t btri[kRays];
    uint32_t live = 0;
    int rows = kRays;
    auto load = [&](int r) {
        const int64_t i = base + id[r];
        ox[r] = __ldg(ray_o + 3 * i);
        oy[r] = __ldg(ray_o + 3 * i + 1);
        oz[r] = __ldg(ray_o + 3 * i + 2);
        dx[r] = __ldg(ray_d + 3 * i);
        dy[r] = __ldg(ray_d + 3 * i + 1);
        dz[r] = __ldg(ray_d + 3 * i + 2);
        ivx[r] = __ldg(inv_d + 3 * i);
        ivy[r] = __ldg(inv_d + 3 * i + 1);
        ivz[r] = __ldg(inv_d + 3 * i + 2);
        tmin[r] = __ldg(t_min + i);
        bt[r] = __ldg(t_max + i);
        btri[r] = -1;
        bu[r] = 0.0f;
        bv[r] = 0.0f;
    };
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
        id[r] = 32 * r + lane;
        load(r);
        live |= (active[base + id[r]] != 0 ? 1u : 0u) << r;
    }
    // K candidates: slot k's field f of ray c at cand[(4 k + f) * 128 + c],
    // empty (t 3e38, tri -1, u = v = 0) at first; kt[r] is the ray's last
    // candidate's t once its buffer is full, else 3e38; bit r of ovf is
    // its overflow bit
    float* cand = nullptr;
    float kt[kRays];
    uint32_t ovf = 0;
    if constexpr (kCand > 0) {
        cand = candidate_buffer<kCand, kW>() + warp * kCand * 4 * kPacket;
#pragma unroll
        for (int r = 0; r < kRays; ++r) {
            kt[r] = kBig;
            for (int k = 0; k < kCand; ++k) {
                float* c = cand + 4 * k * kPacket + 32 * r + lane;
                c[0] = kBig;
                c[kPacket] = __int_as_float(-1);
                c[2 * kPacket] = 0.0f;
                c[3 * kPacket] = 0.0f;
            }
        }
    }
    // the bound of ray r's tests: its best t, and with candidates the last
    // candidate's t of a full buffer
    auto bound = [&](int r) {
        if constexpr (kCand > 0) return nan_min(bt[r], kt[r]);
        return bt[r];
    };
    // any hit: the live rays packed into the fewest rows, slot r of lane l
    // taking entry 32 r + l of the list of live ids (in their order)
    auto compact = [&]() {
        const uint32_t below = (1u << lane) - 1u;
        int n = 0;
#pragma unroll
        for (int r = 0; r < kRays; ++r) {
            if (r >= rows) break;
            const bool l = (live >> r) & 1u;
            const uint32_t b = __ballot_sync(kFull, l);
            if (l) live_ids[warp][n + __popc(b & below)] = id[r];
            n += __popc(b);
        }
        __syncwarp();
        rows = (n + 31) / 32;
        live = 0;
#pragma unroll
        for (int r = 0; r < kRays; ++r) {
            const int e = 32 * r + lane;
            if (e < n) {
                id[r] = live_ids[warp][e];
                load(r);
                live |= 1u << r;
            }
        }
        __syncwarp();  // the list is read before it is written again
    };
    if (kFirstHit) {
        // an inactive ray is a miss, written now; a ray with a hit is
        // written at its leaf, and the rays still live at the end
#pragma unroll
        for (int r = 0; r < kRays; ++r) {
            if (!((live >> r) & 1u)) {
                const int64_t i = base + id[r];
                out_t[i] = bt[r];
                out_tri[i] = -1;
                out_u[i] = 0.0f;
                out_v[i] = 0.0f;
            }
        }
        compact();
    }

    // the warp-uniform walk state; stack entry e lives in lane e % 32, as
    // node0/mask0 (e < 32) or node1/mask1
    int32_t cur = __any_sync(kFull, live != 0) ? root_code : done;
    uint32_t pmask = kAllSlots;
    int32_t sp = 0;
    int32_t node0 = 0, node1 = 0;
    uint32_t mask0 = 0u, mask1 = 0u;

    for (int32_t it = 0; it < max_iters && cur != done; ++it) {
        const bool is_leaf = cur < 0;
        const int64_t row = is_leaf ? ~cur : cur;
        float4* buf = rec4[warp][it & 1];
        buf[lane] = __ldg(reinterpret_cast<const float4*>(
            table + row * kRecord) + lane);
        __syncwarp();
        const float* rec = reinterpret_cast<const float*>(buf);
        bool any_child = false;
        int32_t near_code = 0;
        uint32_t rest_mask = 0;

        if (!is_leaf) {
            // ---- internal: per allowed slot, each lane slab-tests its
            // rays (a dead ray's result is masked); per slot the lanes'
            // least entry t as an ordered int ----
            uint32_t lane_hits = 0;
            int32_t lane_min[kWidth];
#pragma unroll
            for (int j = 0; j < kWidth; ++j) {
                lane_min[j] = ordered(kBig);
                // empty slots have inverted bounds in the record; a slot the
                // mask leaves out is not tested (warp-uniform branches)
                const float lox = rec[j], hix = rec[24 + j];
                if (!(lox <= hix) || !((pmask >> j) & 1u)) continue;
                const float loy = rec[8 + j], hiy = rec[32 + j];
                const float loz = rec[16 + j], hiz = rec[40 + j];
#pragma unroll
                for (int r = 0; r < kRays; ++r) {
                    if (r >= rows) break;
                    const float tx0 = (lox - ox[r]) * ivx[r];
                    const float tx1 = (hix - ox[r]) * ivx[r];
                    const float ty0 = (loy - oy[r]) * ivy[r];
                    const float ty1 = (hiy - oy[r]) * ivy[r];
                    const float tz0 = (loz - oz[r]) * ivz[r];
                    const float tz1 = (hiz - oz[r]) * ivz[r];
                    const float tn = nan_max(
                        nan_max(nan_min(tx0, tx1), nan_min(ty0, ty1)),
                        nan_max(nan_min(tz0, tz1), tmin[r]));
                    const float tf = nan_min(
                        nan_min(nan_max(tx0, tx1), nan_max(ty0, ty1)),
                        nan_min(nan_max(tz0, tz1), bound(r)));
                    const bool hit = ((live >> r) & 1u) && tn <= tf;
                    lane_hits |= hit ? 1u << j : 0u;
                    lane_min[j] =
                        hit ? min(lane_min[j], ordered(tn)) : lane_min[j];
                }
            }
            // the packet's verdict per slot, and the nearest by a strict <
            // scan over ascending slots (the lowest slot wins ties)
            const uint32_t hit_mask = __reduce_or_sync(kFull, lane_hits);
            float near_key = __int_as_float(0x7f800000);  // +inf
            int near_slot = 0;
#pragma unroll
            for (int j = 0; j < kWidth; ++j) {
                const float key =
                    from_ordered(__reduce_min_sync(kFull, lane_min[j]));
                if (key < near_key) {
                    near_key = key;
                    near_slot = j;
                }
            }
            near_code = __float_as_int(rec[48 + near_slot]);
            any_child = near_key < kBig;
            rest_mask = hit_mask & ~(1u << near_slot);
        } else if (kCand > 0 && live != 0) {
            // ---- leaf, K candidates: ray by ray, each live ray tests the
            // 12 triangles against its bound from before the leaf; the
            // least unflagged t (ck) and the two least flagged hits (a0,
            // a1; strict <: the lowest slot wins ties), then the flagged
            // hits into the buffer, nearest first ----
#pragma unroll
            for (int r = 0; r < kRays; ++r) {
                if (!((live >> r) & 1u)) continue;
                const float pr = bound(r);
                float ck = __int_as_float(0x7f800000);  // +inf
                float a0t = ck, a1t = ck, a0u = 0.0f, a0v = 0.0f;
                float a1u = 0.0f, a1v = 0.0f;
                int32_t a0i = 0, a1i = 0, na = 0;
#pragma unroll 1
                for (int s = 0; s < kLeafSize; ++s) {
                    int32_t tid = __float_as_int(rec[9 * kLeafSize + s]);
                    if (tid < 0) continue;  // an empty slot (warp-uniform)
                    const bool flagged = (tid & kAlphaTidBit) != 0;
                    tid &= ~kAlphaTidBit;
                    const float v0x = rec[s], v0y = rec[kLeafSize + s];
                    const float v0z = rec[2 * kLeafSize + s];
                    const float e1x = rec[3 * kLeafSize + s];
                    const float e1y = rec[4 * kLeafSize + s];
                    const float e1z = rec[5 * kLeafSize + s];
                    const float e2x = rec[6 * kLeafSize + s];
                    const float e2y = rec[7 * kLeafSize + s];
                    const float e2z = rec[8 * kLeafSize + s];
                    const float px = dy[r] * e2z - dz[r] * e2y;
                    const float py = dz[r] * e2x - dx[r] * e2z;
                    const float pz = dx[r] * e2y - dy[r] * e2x;
                    const float det = e1x * px + e1y * py + e1z * pz;
                    const bool det_ok = fabsf(det) > kEps;
                    const float inv_det =
                        det_ok ? 1.0f / (det == 0.0f ? 1.0f : det) : 0.0f;
                    const float sx = ox[r] - v0x;
                    const float sy = oy[r] - v0y;
                    const float sz = oz[r] - v0z;
                    const float u = (sx * px + sy * py + sz * pz) * inv_det;
                    const float qx = sy * e1z - sz * e1y;
                    const float qy = sz * e1x - sx * e1z;
                    const float qz = sx * e1y - sy * e1x;
                    const float v =
                        (dx[r] * qx + dy[r] * qy + dz[r] * qz) * inv_det;
                    const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
                    if (!(det_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f
                          && t >= tmin[r] && t < pr && t < kBig))
                        continue;
                    if (flagged) {
                        ++na;
                        if (t < a0t) {
                            a1t = a0t; a1i = a0i; a1u = a0u; a1v = a0v;
                            a0t = t; a0i = tid; a0u = u + 0.0f;
                            a0v = v + 0.0f;
                        } else if (t < a1t) {
                            a1t = t; a1i = tid; a1u = u + 0.0f;
                            a1v = v + 0.0f;
                        }
                    } else if (t < ck) {
                        ck = t;
                        btri[r] = tid;
                        bu[r] = u + 0.0f;
                        bv[r] = v + 0.0f;
                    }
                }
                if (ck < kBig) bt[r] = ck;
                float* c = cand + 32 * r + lane;
                // a candidate takes the first slot whose t it is strictly
                // below; the occupant it displaces goes on down, and an
                // empty slot's occupant ends the chain (JAX's take chain)
                auto insert = [&](float ct, int32_t ci, float cu, float cv) {
#pragma unroll
                    for (int k = 0; k < kCand; ++k) {
                        float* e = c + 4 * k * kPacket;
                        const float st = e[0];
                        if (!(ct < st)) continue;
                        const int32_t si = __float_as_int(e[kPacket]);
                        const float su = e[2 * kPacket];
                        const float sv = e[3 * kPacket];
                        e[0] = ct;
                        e[kPacket] = __int_as_float(ci);
                        e[2 * kPacket] = cu;
                        e[3 * kPacket] = cv;
                        if (si < 0) return;
                        ct = st; ci = si; cu = su; cv = sv;
                    }
                };
                if (na >= 1) insert(a0t, a0i, a0u, a0v);
                if (na >= 2) insert(a1t, a1i, a1u, a1v);
                if (na > 2) ovf |= 1u << r;
                const float* last = c + 4 * (kCand - 1) * kPacket;
                kt[r] = __float_as_int(last[kPacket]) >= 0 ? last[0] : kBig;
            }
        } else if (live != 0) {
            // ---- leaf: each live ray tests the 12 triangles, each held
            // against its best t from before the leaf; ck is the least
            // candidate t so far (a strict <: the lowest slot wins ties) ----
            float ck[kRays];
#pragma unroll
            for (int r = 0; r < kRays; ++r)
                ck[r] = __int_as_float(0x7f800000);  // +inf
#pragma unroll 1
            for (int s = 0; s < kLeafSize; ++s) {
                const float v0x = rec[s], v0y = rec[kLeafSize + s];
                const float v0z = rec[2 * kLeafSize + s];
                const float e1x = rec[3 * kLeafSize + s];
                const float e1y = rec[4 * kLeafSize + s];
                const float e1z = rec[5 * kLeafSize + s];
                const float e2x = rec[6 * kLeafSize + s];
                const float e2y = rec[7 * kLeafSize + s];
                const float e2z = rec[8 * kLeafSize + s];
                int32_t tid = __float_as_int(rec[9 * kLeafSize + s]);
                // opaque-only: a flagged triangle is not tested
                if (kExclude && tid >= 0 && (tid & kAlphaTidBit)) continue;
                if (strip_alpha && tid >= 0) tid &= ~kAlphaTidBit;
                if (tid < 0) continue;  // an empty slot (warp-uniform)
#pragma unroll
                for (int r = 0; r < kRays; ++r) {
                    if (r >= rows) break;
                    const float px = dy[r] * e2z - dz[r] * e2y;
                    const float py = dz[r] * e2x - dx[r] * e2z;
                    const float pz = dx[r] * e2y - dy[r] * e2x;
                    const float det = e1x * px + e1y * py + e1z * pz;
                    const bool det_ok = fabsf(det) > kEps;
                    const float inv_det =
                        det_ok ? 1.0f / (det == 0.0f ? 1.0f : det) : 0.0f;
                    const float sx = ox[r] - v0x;
                    const float sy = oy[r] - v0y;
                    const float sz = oz[r] - v0z;
                    const float u = (sx * px + sy * py + sz * pz) * inv_det;
                    const float qx = sy * e1z - sz * e1y;
                    const float qy = sz * e1x - sx * e1z;
                    const float qz = sx * e1y - sy * e1x;
                    const float v =
                        (dx[r] * qx + dy[r] * qy + dz[r] * qz) * inv_det;
                    const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
                    // a candidate below the "no hit" key, nearer than the
                    // last: the slot the plain version's min picks
                    if (((live >> r) & 1u) && det_ok && u >= 0.0f
                        && v >= 0.0f && u + v <= 1.0f && t >= tmin[r]
                        && t < bt[r] && t < kBig && t < ck[r]) {
                        ck[r] = t;
                        btri[r] = tid;
                        // + 0.0f: -0 becomes +0, as the reference's masked
                        // sum gives
                        bu[r] = u + 0.0f;
                        bv[r] = v + 0.0f;
                    }
                }
            }
#pragma unroll
            for (int r = 0; r < kRays; ++r) {
                if (!(ck[r] < kBig)) continue;
                bt[r] = ck[r];
                if (kFirstHit) {
                    // the ray has its hit and stops walking
                    const int64_t i = base + id[r];
                    out_t[i] = bt[r];
                    out_tri[i] = btri[r];
                    out_u[i] = bu[r];
                    out_v[i] = bv[r];
                    live &= ~(1u << r);
                }
            }
        }

        // ---- the walk state: ONE (node, mask) push when siblings remain;
        // descend the nearest child, else pop ----
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
        uint32_t next_mask = kAllSlots;
        if (!is_leaf && any_child) {
            cur = near_code;
        } else if (sp > 0) {
            const int top = sp - 1;
            if (top < stack_depth) {
                cur = __shfl_sync(kFull, top < 32 ? node0 : node1, top & 31);
                next_mask = __shfl_sync(kFull, top < 32 ? mask0 : mask1,
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
        if (kFirstHit && is_leaf) {
            const int n = __reduce_add_sync(kFull, __popc(live));
            if (n == 0) {
                cur = done;  // every active ray has found a hit
                sp = 0;
            } else if ((n + 31) / 32 < rows) {
                compact();
            }
        }
    }

    // closest hit: every ray's hit (a miss keeps t_max and -1); any hit:
    // the rays still live are misses
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
        if (kFirstHit && !(r < rows && ((live >> r) & 1u))) continue;
        const int64_t i = base + id[r];
        out_t[i] = bt[r];
        out_tri[i] = btri[r];
        out_u[i] = bu[r];
        out_v[i] = bv[r];
        if constexpr (kCand > 0) {
            const float* c = cand + 32 * r + lane;
            for (int k = 0; k < kCand; ++k) {
                const float* e = c + 4 * k * kPacket;
                cand_t[i * kCand + k] = e[0];
                cand_tri[i * kCand + k] = __float_as_int(e[kPacket]);
                cand_u[i * kCand + k] = e[2 * kPacket];
                cand_v[i * kCand + k] = e[3 * kPacket];
            }
            overflow[i] = (ovf >> r) & 1u;
        }
    }
}

template <bool kFirstHit, bool kExclude, int kCand>
cudaError_t launch(cudaStream_t stream, int64_t packets, const float* table,
                   int32_t done, int32_t root_code, int32_t stack_depth,
                   int32_t max_iters, bool strip_alpha, const float* o,
                   const float* d, const float* inv_d, const float* t_min,
                   const float* t_max, const uint8_t* active, float* out_t,
                   int32_t* out_tri, float* out_u, float* out_v,
                   float* cand_t = nullptr, int32_t* cand_tri = nullptr,
                   float* cand_u = nullptr, float* cand_v = nullptr,
                   uint8_t* overflow = nullptr) {
    constexpr int kW = kCand > 0 ? kCandWarps : kWarps;
    const int64_t blocks = (packets + kW - 1) / kW;
    packet_kernel<kFirstHit, kExclude, kCand>
        <<<static_cast<unsigned>(blocks), kW * 32, 0, stream>>>(
            table, done, root_code, stack_depth, max_iters, strip_alpha, o, d,
            inv_d, t_min, t_max, active, packets, out_t, out_tri, out_u,
            out_v, cand_t, cand_tri, cand_u, cand_v, overflow);
    return cudaGetLastError();
}

template <bool kFirstHit, bool kExclude, int kCand>
int resident_warps() {
    constexpr int kW = kCand > 0 ? kCandWarps : kWarps;
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, packet_kernel<kFirstHit, kExclude, kCand>, kW * 32, 0);
    return err != cudaSuccess ? -static_cast<int>(err) : blocks * kW;
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
        first_hit ? launch<true, false, 0>(s, packets, table, num_rows,
                                           root_code, stack_depth, iters,
                                           strip, ray_o, ray_d, inv_d, t_min,
                                           t_max, active, out_t, out_tri,
                                           out_u, out_v)
                  : launch<false, false, 0>(s, packets, table, num_rows,
                                            root_code, stack_depth, iters,
                                            strip, ray_o, ray_d, inv_d, t_min,
                                            t_max, active, out_t, out_tri,
                                            out_u, out_v);
    return static_cast<int>(err);
}

// The alpha modes on a table with alpha flags. k_cands 0: the opaque-only
// walk (closest, or any hit when first_hit is set), flagged triangles
// ignored; the cand_* and overflow pointers are not read. k_cands = K in
// 1..8: the K-candidate closest walk (first_hit must be 0), which also
// writes cand_t/cand_tri/cand_u/cand_v (n, K) row-major and overflow (n,).
extern "C" int dxrpt_packet_traverse_alpha(
    const float* table, int32_t num_rows, int32_t root_code,
    int32_t stack_depth, int64_t max_iters, int32_t first_hit,
    int32_t k_cands, const float* ray_o, const float* ray_d,
    const float* inv_d, const float* t_min, const float* t_max,
    const uint8_t* active, int64_t n, float* out_t, int32_t* out_tri,
    float* out_u, float* out_v, float* cand_t, int32_t* cand_tri,
    float* cand_u, float* cand_v, uint8_t* overflow, void* stream) {
    if (n <= 0) return 0;
    if (n % kPacket != 0 || stack_depth < 1 || stack_depth > kMaxStack
        || max_iters < 1 || max_iters > INT32_MAX || k_cands < 0
        || k_cands > kMaxCands || (k_cands > 0 && first_hit))
        return static_cast<int>(cudaErrorInvalidValue);
    const int32_t iters = static_cast<int32_t>(max_iters);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t p = n / kPacket;
#define DXRPT_CANDS(K)                                                      \
    case K:                                                                 \
        return static_cast<int>(launch<false, false, K>(                    \
            s, p, table, num_rows, root_code, stack_depth, iters, true,     \
            ray_o, ray_d, inv_d, t_min, t_max, active, out_t, out_tri,      \
            out_u, out_v, cand_t, cand_tri, cand_u, cand_v, overflow));
    switch (k_cands) {
        case 0:
            return static_cast<int>(
                first_hit ? launch<true, true, 0>(s, p, table, num_rows,
                                                  root_code, stack_depth,
                                                  iters, true, ray_o, ray_d,
                                                  inv_d, t_min, t_max, active,
                                                  out_t, out_tri, out_u,
                                                  out_v)
                          : launch<false, true, 0>(s, p, table, num_rows,
                                                   root_code, stack_depth,
                                                   iters, true, ray_o, ray_d,
                                                   inv_d, t_min, t_max,
                                                   active, out_t, out_tri,
                                                   out_u, out_v));
        DXRPT_CANDS(1)
        DXRPT_CANDS(2)
        DXRPT_CANDS(3)
        DXRPT_CANDS(4)
        DXRPT_CANDS(5)
        DXRPT_CANDS(6)
        DXRPT_CANDS(7)
        DXRPT_CANDS(8)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef DXRPT_CANDS
}

// Warps of the closest-hit (first_hit 0) or any-hit kernel that one SM of the
// current device holds at once, or minus the CUDA error code.
extern "C" int dxrpt_packet_resident_warps(int32_t first_hit) {
    return first_hit ? resident_warps<true, false, 0>()
                     : resident_warps<false, false, 0>();
}

// The same for the alpha modes: the opaque-only walk (k_cands 0; closest,
// or any hit when first_hit is set) or the K-candidate walk.
extern "C" int dxrpt_packet_mode_resident_warps(int32_t first_hit,
                                                int32_t k_cands) {
    switch (k_cands) {
        case 0:
            return first_hit ? resident_warps<true, true, 0>()
                             : resident_warps<false, true, 0>();
        case 1: return resident_warps<false, false, 1>();
        case 2: return resident_warps<false, false, 2>();
        case 3: return resident_warps<false, false, 3>();
        case 4: return resident_warps<false, false, 4>();
        case 5: return resident_warps<false, false, 5>();
        case 6: return resident_warps<false, false, 6>();
        case 7: return resident_warps<false, false, 7>();
        case 8: return resident_warps<false, false, 8>();
        default: return -static_cast<int>(cudaErrorInvalidValue);
    }
}
