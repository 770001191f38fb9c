"""Packet traversal of a W8 table: the CUDA kernel's wrapper and its plain
version.

The port of dxrpathtracer_tpu/accel/packet.py (packet_closest_hit,
packet_any_hit, packet_any_hit_rec, packet_closest_hit_alpha:
`_packet_traverse` with its exclude_alpha and collect_alpha modes). Rays
128p..128p+127 form packet p; the caller makes each packet coherent
(render/integrator.py tiles the pixels 8 x 16 per packet). A packet walks
the union of its rays' walks: at an internal node a child is entered when
some live ray (active, and in any-hit mode not yet blocked) hits it within
[t_min, its bound], nearest first by the packet's least entry t (lowest
slot on ties), the rest pushed as one (node, mask) entry; at a leaf every
live ray tests the 12 triangles. Closest hits are the per-ray walk's up to
the triangle of an equal-t tie; any-hit visibility is equal.

Two modes serve the split alpha route (render/integrator.py): on a table
with alpha flags, exclude_alpha ignores the flagged triangles (neither hit
nor bound), and the K-candidate walk (`packet_closest_hit_alpha`) keeps
each ray's K nearest flagged hits in a sorted buffer beside its nearest
unflagged hit, a full buffer bounding the ray at its last candidate. The
order in which a packet meets its leaves decides the overflow bit, so this
is the packet walk, the JAX package's visit order and all.

`packet_closest_hit`, `packet_any_hit`, `packet_any_hit_rec` and
`packet_closest_hit_alpha` launch csrc/packet.cu (one warp per packet, four
rays per lane) for CUDA tensors and run `packet_traverse_plain` (the JAX
package's step, over the packets still walking) for CPU tensors; they route
on the device alone.
"""

import ctypes
from pathlib import Path

import torch

from ..app.profiler import spanned
from ..buildlib import build_shared_library, nvcc
from .bvh import LEAF_SIZE, RECORD, FlatBVH
from .traverse import (_BIG, ALPHA_TID_BIT, MAX_STACK, NVCC_FLAGS, HitRecord,
                       _argmin_block, _pow2, moller_trumbore, safe_inv,
                       slab_interval, stack_step)

KERNEL_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "packet.cu"
PACKET = 128
# Candidates a leaf visit of the K-candidate walk extracts (the JAX
# package's DXRPT_LEAF_EXTRACT, a TPU tuning knob, at its default).
LEAF_EXTRACT = 2
MAX_CANDS = 8  # the kernel's K-candidate instantiations are K = 1..8

# Launches of the packet kernel since the process started (or since a
# caller last reset them): closest and any hit, their opaque-only modes and
# the K-candidate walk. Only `_launch_kernel` and `_launch_alpha_kernel`
# add to them.
KERNEL_LAUNCHES = {"closest": 0, "any": 0, "closest_opaque": 0,
                   "any_opaque": 0, "candidates": 0}

_kernel = None
BUILD_LOG = ""  # nvcc's -Xptxas -v report of the loaded library's build


def kernel_library():
    """csrc/packet.cu compiled for sm_90a, built at first use."""
    global _kernel, BUILD_LOG
    if _kernel is None:
        path, BUILD_LOG = build_shared_library(
            KERNEL_SOURCE, "packet", [nvcc(), *NVCC_FLAGS])
        lib = ctypes.CDLL(str(path))
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.dxrpt_packet_traverse.restype = ctypes.c_int
        lib.dxrpt_packet_traverse.argtypes = [
            p, i32, i32, i32, i64, i32, i32,   # table, walk constants
            p, p, p, p, p, p, i64,             # rays
            p, p, p, p,                        # outputs
            p]                                 # stream
        lib.dxrpt_packet_traverse_alpha.restype = ctypes.c_int
        lib.dxrpt_packet_traverse_alpha.argtypes = [
            p, i32, i32, i32, i64, i32, i32,   # table, walk constants
            p, p, p, p, p, p, i64,             # rays
            p, p, p, p,                        # outputs
            p, p, p, p, p,                     # candidates, overflow
            p]                                 # stream
        lib.dxrpt_packet_mode_resident_warps.restype = ctypes.c_int
        lib.dxrpt_packet_mode_resident_warps.argtypes = [i32, i32]
        _kernel = lib
    return _kernel


def resident_warps(first_hit: bool, k_cands: int = 0) -> int:
    """Warps of the opaque-only (k_cands 0) or K-candidate kernel that one
    SM of the current CUDA device holds at once."""
    warps = kernel_library().dxrpt_packet_mode_resident_warps(
        int(first_hit), int(k_cands))
    if warps <= 0:
        raise RuntimeError(f"packet kernel occupancy query failed: CUDA "
                           f"error {-warps}")
    return warps


def _check_table(bvh: FlatBVH, dev):
    if (bvh.table.dtype != torch.float32 or bvh.table.device != dev
            or tuple(bvh.table.shape) != (bvh.num_rows, RECORD)
            or not bvh.table.is_contiguous()):
        raise ValueError(f"bvh.table: want contiguous f32 ({bvh.num_rows}, "
                         f"{RECORD}) on {dev}")
    if bvh.stack_depth > MAX_STACK:
        raise ValueError(f"BVH needs a {bvh.stack_depth}-entry stack; the "
                         f"kernel holds {MAX_STACK}")


def _launch_kernel(bvh: FlatBVH, ray_o, ray_d, inv_d, t_min, t_max, active,
                   first_hit: bool) -> HitRecord:
    """One launch over all packets on the current stream; does not
    synchronise."""
    n, dev = ray_o.shape[0], ray_o.device
    _check_table(bvh, dev)
    out_t = torch.empty(n, dtype=torch.float32, device=dev)
    out_tri = torch.empty(n, dtype=torch.int32, device=dev)
    out_u = torch.empty(n, dtype=torch.float32, device=dev)
    out_v = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return HitRecord(out_t, out_tri, out_u, out_v)
    max_iters = bvh.num_rows * 2 + bvh.stack_depth + 4
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = kernel_library().dxrpt_packet_traverse(
            bvh.table.data_ptr(), bvh.num_rows, bvh.root_code,
            bvh.stack_depth, max_iters, int(first_hit),
            int(bvh.has_alpha_flags), ray_o.data_ptr(), ray_d.data_ptr(),
            inv_d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
            active.data_ptr(), n, out_t.data_ptr(), out_tri.data_ptr(),
            out_u.data_ptr(), out_v.data_ptr(), stream)
        KERNEL_LAUNCHES["any" if first_hit else "closest"] += 1
    if rc != 0:
        raise RuntimeError(f"packet kernel launch failed: CUDA error {rc}")
    return HitRecord(out_t, out_tri, out_u, out_v)


def _launch_alpha_kernel(bvh: FlatBVH, ray_o, ray_d, inv_d, t_min, t_max,
                         active, first_hit: bool, k_cands: int):
    """One launch of the opaque-only walk (k_cands 0; flagged triangles
    ignored) or of the K-candidate closest walk over all packets on the
    current stream; does not synchronise. Returns what
    `packet_traverse_plain` returns for the same mode."""
    n, dev = ray_o.shape[0], ray_o.device
    _check_table(bvh, dev)
    if not bvh.has_alpha_flags:
        raise ValueError("the alpha modes need a table with alpha flags")
    if k_cands and first_hit:
        raise ValueError("the K-candidate walk is a closest-hit walk")
    f32 = torch.float32
    rec = HitRecord(*(torch.empty(n, dtype=dt, device=dev)
                      for dt in (f32, torch.int32, f32, f32)))
    cands = None
    if k_cands:
        kc = (n, k_cands)
        cands = {"t": torch.empty(kc, dtype=f32, device=dev),
                 "tri": torch.empty(kc, dtype=torch.int32, device=dev),
                 "u": torch.empty(kc, dtype=f32, device=dev),
                 "v": torch.empty(kc, dtype=f32, device=dev),
                 "overflow": torch.empty(n, dtype=torch.bool, device=dev)}
    if n > 0:
        ptr = lambda k: cands[k].data_ptr() if cands else None  # noqa: E731
        max_iters = bvh.num_rows * 2 + bvh.stack_depth + 4
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = kernel_library().dxrpt_packet_traverse_alpha(
                bvh.table.data_ptr(), bvh.num_rows, bvh.root_code,
                bvh.stack_depth, max_iters, int(first_hit), int(k_cands),
                ray_o.data_ptr(), ray_d.data_ptr(), inv_d.data_ptr(),
                t_min.data_ptr(), t_max.data_ptr(), active.data_ptr(), n,
                *(x.data_ptr() for x in (rec.t, rec.tri_id, rec.u, rec.v)),
                *(ptr(k) for k in ("t", "tri", "u", "v", "overflow")),
                stream)
            KERNEL_LAUNCHES["candidates" if k_cands else
                            "any_opaque" if first_hit
                            else "closest_opaque"] += 1
        if rc != 0:
            raise RuntimeError(f"packet kernel launch failed: CUDA error "
                               f"{rc}")
    return (rec, cands) if k_cands else rec


def _packet_step(bvh: FlatBVH, s: dict, first_hit: bool, pow2,
                 exclude_alpha: bool = False, k_cands: int = 0) -> dict:
    """One step of every packet in `s` (all walking): `_packet_traverse`'s
    body. Per packet: cur, pmask, sp (m,), snode, smask (S, m); per ray
    (m, 128): ox..tmin, act, bt, btri, bu, bv; with k_cands, per ray the
    sorted candidates ct, ctri, cu, cv (m, k_cands, 128) and ovf (m, 128).
    exclude_alpha: flagged triangles neither win nor prune; k_cands: they
    go to the candidates instead (see `packet_closest_hit_alpha`)."""
    i32 = torch.int32
    dev = s["cur"].device
    done = bvh.num_rows
    cur = s["cur"]
    is_leaf = cur < 0
    is_int = ~is_leaf  # every packet in `s` is walking
    row = torch.where(is_leaf, ~cur, cur)
    rec = bvh.table.index_select(0, row.long())         # (m, RECORD)
    ray_live = s["act"]
    if first_hit:
        ray_live = ray_live & (s["btri"] < 0)
    prune_t = s["bt"]
    if k_cands:
        # a full buffer prunes at its farthest candidate too: nothing
        # beyond it can enter the buffer or win
        full = s["ctri"][:, -1] >= 0
        prune_t = torch.minimum(prune_t,
                                torch.where(full, s["ct"][:, -1], _BIG))

    # ---- internal: slab-test 8 children x 128 rays ----
    lox, loy, loz = rec[:, 0:8], rec[:, 8:16], rec[:, 16:24]
    hix, hiy, hiz = rec[:, 24:32], rec[:, 32:40], rec[:, 40:48]
    codes = rec[:, 48:56].view(i32)
    c = lambda x: x[:, :, None]  # noqa: E731  (m, 8 or L) -> (m, 8 or L, 1)
    r = lambda x: x[:, None, :]  # noqa: E731  (m, K) -> (m, 1, K)
    tn, tf = slab_interval(
        (c(lox), c(loy), c(loz)), (c(hix), c(hiy), c(hiz)),
        (r(s["ox"]), r(s["oy"]), r(s["oz"])),
        (r(s["ivx"]), r(s["ivy"]), r(s["ivz"])), r(s["tmin"]), r(prune_t))
    # empty slots carry inverted bounds in the record (tested there: the
    # slab result of a steep ray can overflow to a "hit")
    valid8 = lox <= hix
    slot_pow2 = pow2[:8][None, :]
    gate = (s["pmask"][:, None] & slot_pow2) != 0
    ray_hit8 = (tn <= tf) & ray_live[:, None, :]          # (m, 8, 128)
    hit8 = is_int[:, None] & valid8 & gate & ray_hit8.any(dim=2)
    # near-to-far by the packet's least entry distance
    tn_min = torch.where(ray_hit8, tn, _BIG).amin(dim=2)   # (m, 8)
    keys8 = torch.where(hit8, tn_min, _BIG)
    hit_mask = torch.where(hit8, slot_pow2, 0).sum(dim=1).to(i32)
    near_key, near_code, near_bit = _argmin_block(keys8, codes, 8, 0, pow2)
    any_child = near_key < _BIG
    rest_mask = hit_mask & ~near_bit

    # ---- leaf: 12 triangles x 128 rays ----
    L = LEAF_SIZE
    v0x, v0y, v0z = rec[:, 0:L], rec[:, L:2 * L], rec[:, 2 * L:3 * L]
    e1x, e1y, e1z = rec[:, 3 * L:4 * L], rec[:, 4 * L:5 * L], rec[:, 5 * L:6 * L]
    e2x, e2y, e2z = rec[:, 6 * L:7 * L], rec[:, 7 * L:8 * L], rec[:, 8 * L:9 * L]
    tid = rec[:, 9 * L:10 * L].view(i32)
    aflag = None
    if bvh.has_alpha_flags:
        aflag = (tid >= 0) & ((tid & ALPHA_TID_BIT) != 0)
        tid = torch.where(tid >= 0, tid & ~ALPHA_TID_BIT, tid)
    det_ok, u, v, t = moller_trumbore(
        (r(s["ox"]), r(s["oy"]), r(s["oz"])),
        (r(s["dx"]), r(s["dy"]), r(s["dz"])),
        (c(v0x), c(v0y), c(v0z)), (c(e1x), c(e1y), c(e1z)),
        (c(e2x), c(e2y), c(e2z)))
    ok = (is_leaf[:, None, None] & c(tid >= 0) & det_ok
          & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t >= r(s["tmin"])) & (t < r(prune_t)) & r(ray_live))
    slot = torch.arange(L, dtype=i32, device=dev)[None, :, None]
    extra = {}
    if k_cands:
        extra = _collect(s, ok & c(aflag), t, u, v, tid, slot, k_cands)
        ok = ok & ~c(aflag)
    elif exclude_alpha and aflag is not None:
        ok = ok & ~c(aflag)
    # per ray, the least t over the 12 slots, the lowest slot on ties
    ck, ctid, cu, cv = _leaf_min(ok, t, u, v, tid, slot)
    win = ck < _BIG
    btri = torch.where(win, ctid, s["btri"])
    bu = torch.where(win, cu, s["bu"])
    bv = torch.where(win, cv, s["bv"])
    bt = torch.where(win, ck, s["bt"])

    cur_next, pmask, sp, snode, smask = stack_step(
        cur, s["sp"], s["snode"], s["smask"], torch.ones_like(is_leaf),
        is_leaf, any_child, near_code, rest_mask, done, 0xFF)
    if first_hit:
        # the packet stops once every active ray has found a hit
        all_found = ~(s["act"] & (btri < 0)).any(dim=1)
        cur_next = torch.where(all_found, done, cur_next).to(i32)
        sp = torch.where(all_found, 0, sp).to(i32)
    return dict(s, cur=cur_next, pmask=pmask, sp=sp, snode=snode,
                smask=smask, bt=bt, btri=btri, bu=bu, bv=bv, **extra)


def _leaf_min(ok, t, u, v, tid, slot):
    """Per ray, the least t of the slots `ok` marks (the lowest slot on
    ties): (t or _BIG, its tri id, u, v), each (m, 128); a masked sum
    keeps the JAX package's bits (-0 becomes +0)."""
    key = torch.where(ok, t, _BIG)                        # (m, L, K)
    ck = key.amin(dim=1)
    min_slot = torch.where(key <= ck[:, None, :], slot, LEAF_SIZE).amin(dim=1)
    first = ok & (slot == min_slot[:, None, :])
    ctid = torch.where(first, tid[:, :, None], 0).sum(dim=1).to(torch.int32)
    cu = torch.where(first, u, 0.0).sum(dim=1)
    cv = torch.where(first, v, 0.0).sum(dim=1)
    return ck, ctid, cu, cv


def _collect(s, ok_a, t, u, v, tid, slot, k_cands):
    """The K-candidate buffers after one leaf (`_packet_traverse`'s
    collect_alpha): up to LEAF_EXTRACT nearest flagged hits of the leaf,
    nearest first, each carried down the sorted buffer (it takes the first
    slot whose t it is below, strictly, and the occupant it displaces goes
    on; an empty slot's occupant ends the carry); flagged hits left in the
    leaf after that set the overflow bit."""
    bufs = {k: list(s[k].unbind(1)) for k in ("ct", "ctri", "cu", "cv")}
    ok_rem = ok_a
    for _ in range(LEAF_EXTRACT):
        cand_t, cand_tri, cand_u, cand_v = _leaf_min(ok_rem, t, u, v, tid,
                                                     slot)
        key = torch.where(ok_rem, t, _BIG)
        min_slot = torch.where(key <= cand_t[:, None, :], slot,
                               LEAF_SIZE).amin(dim=1)
        ok_rem = ok_rem & ~(slot == min_slot[:, None, :])
        valid = cand_t < _BIG
        for k in range(k_cands):
            st, stri = bufs["ct"][k], bufs["ctri"][k]
            su, sv = bufs["cu"][k], bufs["cv"][k]
            take = valid & (cand_t < st)
            bufs["ct"][k] = torch.where(take, cand_t, st)
            bufs["ctri"][k] = torch.where(take, cand_tri, stri)
            bufs["cu"][k] = torch.where(take, cand_u, su)
            bufs["cv"][k] = torch.where(take, cand_v, sv)
            cand_t = torch.where(take, st, cand_t)
            cand_tri = torch.where(take, stri, cand_tri)
            cand_u = torch.where(take, su, cand_u)
            cand_v = torch.where(take, sv, cand_v)
            valid = (take & (stri >= 0)) | (valid & ~take)
    out = {k: torch.stack(b, dim=1) for k, b in bufs.items()}
    out["ovf"] = s["ovf"] | ok_rem.any(dim=1)
    return out


def _count_visits(bvh: FlatBVH, s: dict, first_hit: bool, pow2,
                  stats: dict, exclude_alpha: bool = False):
    """Adds the visits of one step of the packets in `s` to `stats`
    (with exclude_alpha, a leaf's flagged triangles are not tested)."""
    cur = s["cur"]
    leaf = cur < 0
    row = torch.where(leaf, ~cur, cur).long()
    rec = bvh.table.index_select(0, row)
    live = s["act"] & (s["btri"] < 0) if first_hit else s["act"]
    n_live = live.sum(dim=1)
    slots = ((rec[:, 0:8] <= rec[:, 24:32])
             & ((s["pmask"][:, None] & pow2[:8][None, :]) != 0)).sum(dim=1)
    ids = rec[:, 9 * LEAF_SIZE:10 * LEAF_SIZE].view(torch.int32)
    tested = ids >= 0
    if exclude_alpha and bvh.has_alpha_flags:
        tested = tested & ((ids & ALPHA_TID_BIT) == 0)
    tris = tested.sum(dim=1)
    stats["leaf"] += int(leaf.sum())
    stats["internal"] += int((~leaf).sum())
    stats["touched"][row] = True
    stats["slot_tests"] += int(torch.where(leaf, 0, n_live * slots).sum())
    stats["tri_tests"] += int(torch.where(leaf, n_live * tris, 0).sum())


CAND_FIELDS = ("ct", "ctri", "cu", "cv")


def packet_traverse_plain(bvh: FlatBVH, ray_o, ray_d, inv_d, t_min, t_max,
                          active, first_hit: bool,
                          stats: dict | None = None,
                          exclude_alpha: bool = False, k_cands: int = 0):
    """`_packet_step` until every packet is done (or the JAX package's
    bound, num_rows*2 + stack_depth + 4 steps); a packet that finishes
    leaves the stepped set. With `stats`, adds the packets' internal and
    leaf visits, the table rows touched (a (rows,) bool mask) and the tests
    the walk needs to it: "slot_tests", live rays x filled, allowed slots
    of each internal visit, and "tri_tests", live rays x filled (and, with
    exclude_alpha, unflagged) triangles of each leaf visit (a live ray is
    active and, for any hit, has no hit yet). Returns the HitRecord, and
    with k_cands (a closest walk) (HitRecord, candidates) as
    `packet_closest_hit_alpha` does."""
    n, dev = ray_o.shape[0], ray_o.device
    p, K = n // PACKET, PACKET
    i32 = torch.int32
    done = bvh.num_rows
    pk = lambda x: x.reshape(p, K)  # noqa: E731
    act = pk(active)
    s = dict(
        idx=torch.arange(p, device=dev),
        ox=pk(ray_o[:, 0]), oy=pk(ray_o[:, 1]), oz=pk(ray_o[:, 2]),
        dx=pk(ray_d[:, 0]), dy=pk(ray_d[:, 1]), dz=pk(ray_d[:, 2]),
        ivx=pk(inv_d[:, 0]), ivy=pk(inv_d[:, 1]), ivz=pk(inv_d[:, 2]),
        tmin=pk(t_min), act=act,
        cur=torch.where(act.any(dim=1), bvh.root_code, done).to(i32),
        pmask=torch.full((p,), 0xFF, dtype=i32, device=dev),
        sp=torch.zeros(p, dtype=i32, device=dev),
        snode=torch.zeros((bvh.stack_depth, p), dtype=i32, device=dev),
        smask=torch.zeros((bvh.stack_depth, p), dtype=i32, device=dev),
        bt=pk(t_max).clone(),
        btri=torch.full((p, K), -1, dtype=i32, device=dev),
        bu=torch.zeros((p, K), device=dev),
        bv=torch.zeros((p, K), device=dev))
    kept = ["bt", "btri", "bu", "bv"]
    if k_cands:
        kc = (p, k_cands, K)
        s.update(ct=torch.full(kc, _BIG, device=dev),
                 ctri=torch.full(kc, -1, dtype=i32, device=dev),
                 cu=torch.zeros(kc, device=dev),
                 cv=torch.zeros(kc, device=dev),
                 ovf=torch.zeros((p, K), dtype=torch.bool, device=dev))
        kept += [*CAND_FIELDS, "ovf"]
    out = {k: s[k].clone() for k in kept}
    if stats is not None:
        stats.setdefault("touched", torch.zeros(bvh.num_rows,
                                                dtype=torch.bool, device=dev))
        for k in ("internal", "leaf", "slot_tests", "tri_tests"):
            stats.setdefault(k, 0)
    pow2 = _pow2(dev)
    max_iters = bvh.num_rows * 2 + bvh.stack_depth + 4
    it = 0
    walking = s["cur"] != done
    while it < max_iters and bool(walking.any()):
        sel = walking.nonzero()[:, 0]
        s = {k: (v[:, sel] if k in ("snode", "smask") else v[sel])
             for k, v in s.items()}
        if stats is not None:
            _count_visits(bvh, s, first_hit, pow2, stats,
                          exclude_alpha=exclude_alpha)
        s = _packet_step(bvh, s, first_hit, pow2,
                         exclude_alpha=exclude_alpha, k_cands=k_cands)
        for k in kept:
            out[k][s["idx"]] = s[k]
        walking = s["cur"] != done
        it += 1
    rec = HitRecord(t=out["bt"].reshape(n), tri_id=out["btri"].reshape(n),
                    u=out["bu"].reshape(n), v=out["bv"].reshape(n))
    if not k_cands:
        return rec
    lanes = lambda x: x.transpose(1, 2).reshape(n, k_cands)  # noqa: E731
    return rec, {"t": lanes(out["ct"]), "tri": lanes(out["ctri"]),
                 "u": lanes(out["cu"]), "v": lanes(out["cv"]),
                 "overflow": out["ovf"].reshape(n)}


def _rays(bvh: FlatBVH, ray_o, ray_d, t_min, t_max, active):
    """The rays as the kernel takes them (contiguous f32 (n, 3) x 3 with
    1/d, f32 (n,) x 2, bool (n,))."""
    n, dev = ray_o.shape[0], ray_o.device
    if n % PACKET != 0:
        raise ValueError(f"packet traversal needs N % {PACKET} == 0, got {n}")
    if bvh.width != 8:
        raise ValueError(f"packet traversal walks W8 tables, got W{bvh.width}")
    f32 = torch.float32
    ray_o = ray_o.to(f32).contiguous()
    ray_d = ray_d.to(f32).contiguous()
    t_min = torch.as_tensor(t_min, dtype=f32, device=dev).expand(n).contiguous()
    t_max = torch.as_tensor(t_max, dtype=f32, device=dev).expand(n).contiguous()
    active = (torch.ones(n, dtype=torch.bool, device=dev) if active is None
              else active.contiguous())
    return ray_o, ray_d, safe_inv(ray_d).contiguous(), t_min, t_max, active


def _packet(bvh: FlatBVH, ray_o, ray_d, t_min, t_max, active,
            first_hit: bool, exclude_alpha: bool = False, k_cands: int = 0):
    rays = _rays(bvh, ray_o, ray_d, t_min, t_max, active)
    dev = rays[0].device
    if k_cands and not 1 <= k_cands <= MAX_CANDS:
        raise ValueError(f"k_cands must be in 1..{MAX_CANDS}, got {k_cands}")
    if k_cands and not bvh.has_alpha_flags:
        raise ValueError("the K-candidate walk needs a table with alpha flags")
    if dev.type == "cuda":
        if exclude_alpha or k_cands:
            return _launch_alpha_kernel(bvh, *rays, first_hit, k_cands)
        return _launch_kernel(bvh, *rays, first_hit)
    if dev.type == "cpu":
        return packet_traverse_plain(bvh, *rays, first_hit,
                                     exclude_alpha=exclude_alpha,
                                     k_cands=k_cands)
    raise ValueError(f"no packet traversal for device {dev}")


@spanned("traverse.packet_closest")
def packet_closest_hit(bvh: FlatBVH, ray_o, ray_d, t_min, t_max,
                       active=None, exclude_alpha: bool = False) -> HitRecord:
    """Closest hit over coherent packets of a W8 table (N % 128 == 0); misses
    keep t == t_max and tri_id == -1. Every triangle is opaque;
    exclude_alpha=True ignores the triangles the table flags (the split
    alpha route's opaque-only walk)."""
    return _packet(bvh, ray_o, ray_d, t_min, t_max, active, False,
                   exclude_alpha=exclude_alpha and bvh.has_alpha_flags)


def packet_closest_hit_alpha(bvh: FlatBVH, ray_o, ray_d, t_min, t_max,
                             active=None, k_cands: int = 4):
    """The closest-hit walk that also collects each ray's k_cands nearest
    flagged (alpha-tested) hits, for a table with alpha flags: (HitRecord of
    the nearest unflagged hit, {"t", "tri", "u", "v": (N, k_cands) sorted
    nearest first, tri ids without the flag, empty slots tri -1 and
    t 3e38; "overflow": (N,) bool}). Flagged hits neither win nor prune the
    walk, but a full buffer prunes it at its last candidate's t. A leaf
    gives up to LEAF_EXTRACT candidates; overflow marks a ray that left
    more in some leaf (never on a table of leaf_size <= LEAF_EXTRACT).
    1 <= k_cands <= MAX_CANDS."""
    return _packet(bvh, ray_o, ray_d, t_min, t_max, active, False,
                   k_cands=k_cands)


def packet_any_hit(bvh: FlatBVH, ray_o, ray_d, t_min, t_max, active=None):
    """Any-hit visibility over coherent packets: (N,) f32, 1 = unoccluded,
    as traverse.any_hit."""
    return packet_any_hit_rec(bvh, ray_o, ray_d, t_min, t_max, active)[0]


@spanned("traverse.packet_any")
def packet_any_hit_rec(bvh: FlatBVH, ray_o, ray_d, t_min, t_max,
                       active=None, exclude_alpha: bool = False):
    """packet_any_hit that also returns the occluder: (visibility, the
    triangle that ended the ray's walk, -1 where the lane is unoccluded or
    inactive), for the history-seeded sun rays (accel/history.py);
    exclude_alpha=True ignores flagged triangles, as packet_closest_hit."""
    n, dev = ray_o.shape[0], ray_o.device
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    rec = _packet(bvh, ray_o, ray_d, t_min, t_max, active, True,
                  exclude_alpha=exclude_alpha and bvh.has_alpha_flags)
    occluded = active & rec.hit
    return (torch.where(occluded, 0.0, 1.0),
            torch.where(occluded, rec.tri_id, -1))
