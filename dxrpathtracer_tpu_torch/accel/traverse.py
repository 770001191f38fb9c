"""Per-ray wide-BVH traversal: the CUDA kernel's wrapper and its plain version.

The port of dxrpathtracer_tpu/accel/traverse.py (closest_hit, any_hit,
HitRecord). Every ray walks the tree with the JAX package's (node, mask)
scheme: an internal visit slab-tests the children the mask allows, descends
the nearest hit child (lowest slot on equal keys) and pushes ONE
(node, remaining-children mask) entry; a pop re-visits the parent with that
mask, so the stack holds one entry per tree level (FlatBVH.stack_depth). A
leaf visit runs Moller-Trumbore on its 12 triangles. Any-hit stops at the
first hit. Results, equal-t ties included, are those of `_traverse`.

Alpha testing: given an `AlphaTest` (the scene's shading rows and texel
pool), a triangle that passes the geometric test is a candidate only if the
opacity test accepts it, inside the walk, as the JAX package's
`closest_hit/any_hit(accept_fn=...)` compute (`_intersect_leaf`'s
`ok & accept_fn(tid, u, v)`); any-hit stops at the first accepted hit.

Two implementations of that walk:
  - csrc/traverse.cu: the whole walk of every ray in one launch
    (`_launch_kernel`): on W32 tables one warp per ray, lane k testing
    child k, in persistent warps that take their rays from a counter; on W8
    tables one thread per ray. It replaces the JAX package's only TPU
    kernel, accel/pallas_body.py::_kernel, together with the while_loop
    around it.
  - `traverse_step_plain` / `traverse_plain`: the same step in plain torch,
    lockstep over all lanes, expression for expression `_kernel` for W8 and
    `_traverse`'s XLA body for W32.

`closest_hit`, `any_hit` and `any_hit_rec` (which also returns the
occluder) launch the kernel for CUDA tensors and run the plain version for
CPU tensors; they route on the device alone. The kernel
has eight instantiations: W8 or W32, closest or any hit, opaque or
alpha-tested.
"""

import ctypes
import dataclasses
from pathlib import Path

import torch

from ..app.profiler import spanned
from ..buildlib import build_shared_library, nvcc
from ..scene.textures import bilinear_from_meta
from ..scene.types import (PACKED_SLOTS, TRI_SHADE_META, TRI_SHADE_VTX,
                           TRI_SHADE_WIDTH)
from .bvh import ALPHA_TID_BIT, LEAF_SIZE, RECORD, FlatBVH

KERNEL_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "traverse.cu"
# --fmad=false keeps every slab and Moller-Trumbore product rounded on its
# own, as the plain version's separate ops are; IEEE division stays (no
# fast-math).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC"]
MAX_STACK = 64  # kMaxStack in csrc/traverse.cu

# Launches of the traversal kernel since the process started (or since a
# caller last cleared it), by instantiation (width, first_hit, alpha); their
# sum is all launches. Only `_launch_kernel` adds to it.
KERNEL_LAUNCHES: dict[tuple[int, bool, bool], int] = {}

_BIG = 3e38
_EPS = 1e-12
ALPHA_CUTOFF = 0.35  # opacity < 0.35 ignores the hit (RayTrace.hlsl:485-507)
_UV = 6              # the UV's slot in a shading row's vertex block
_OPACITY = 3 * PACKED_SLOTS.index("opacity")  # its (base, w, h) in the meta
_HAS_OPACITY = 18    # has_opacity in the packed material meta


@dataclasses.dataclass(frozen=True)
class HitRecord:
    t: torch.Tensor       # (N,) f32 hit distance (t_max where missed)
    tri_id: torch.Tensor  # (N,) i32 original triangle index, -1 on miss
    u: torch.Tensor       # (N,) f32 barycentric u (of v1)
    v: torch.Tensor       # (N,) f32 barycentric v (of v2)

    @property
    def hit(self):
        return self.tri_id >= 0


@dataclasses.dataclass(frozen=True)
class AlphaTest:
    """The any-hit opacity test of alpha-tested materials (RayTrace.hlsl:
    485-507): what the kernel's alpha instantiations read, and, called as
    accept_fn(tid, u, v), its plain version: JAX `_make_alpha_test`'s
    accept. A triangle is accepted when its material has no opacity map or
    the bilinear wrap tap of the map's channel 0 at the hit's UV is >= 0.35.
    The UVs and the material meta come from the triangle's shading row
    (the same values as the JAX package's uvs and packed_meta gathers)."""

    tri_shade: torch.Tensor  # (T, 64) f32 packed shading rows
    texels: torch.Tensor     # (texels, 4) f32 atlas pool

    def __call__(self, tid, u, v):
        flat = torch.clamp_min(tid, 0).reshape(-1).long()
        rec = self.tri_shade.index_select(0, flat).reshape(
            *tid.shape, TRI_SHADE_WIDTH)
        meta = rec.view(torch.int32)[..., TRI_SHADE_META:TRI_SHADE_META + 20]
        w = (1.0 - u - v)[..., None]
        K = TRI_SHADE_VTX
        uv = (rec[..., _UV:_UV + 2] * w + rec[..., K + _UV:K + _UV + 2]
              * u[..., None] + rec[..., 2 * K + _UV:2 * K + _UV + 2]
              * v[..., None])
        opacity = bilinear_from_meta(
            self.texels, meta[..., _OPACITY], meta[..., _OPACITY + 1],
            meta[..., _OPACITY + 2], uv)[..., 0]
        return torch.where(meta[..., _HAS_OPACITY] != 0,
                           opacity >= ALPHA_CUTOFF, True)


def safe_inv(d):
    """1/d with zero components nudged to ±eps (avoids 0*inf = NaN in slab
    tests) — `_safe_inv` of the JAX package."""
    nudged = torch.where(d < 0.0, -_EPS, _EPS).to(d.dtype)
    return 1.0 / torch.where(d.abs() < _EPS, nudged, d)


def slab_interval(lo, hi, o, iv, t_lo, t_hi):
    """The slab test's (t_near, t_far) of boxes `lo`/`hi` (xyz triples) for
    rays `o` (xyz) with reciprocal directions `iv`, clipped to [t_lo, t_hi];
    every argument broadcasts. The JAX package's expression in its order,
    min/max propagating NaN."""
    t0 = [(lo[a] - o[a]) * iv[a] for a in range(3)]
    t1 = [(hi[a] - o[a]) * iv[a] for a in range(3)]
    near = [torch.minimum(t0[a], t1[a]) for a in range(3)]
    far = [torch.maximum(t0[a], t1[a]) for a in range(3)]
    tn = torch.maximum(torch.maximum(near[0], near[1]),
                       torch.maximum(near[2], t_lo))
    tf = torch.minimum(torch.minimum(far[0], far[1]),
                       torch.minimum(far[2], t_hi))
    return tn, tf


def moller_trumbore(o, d, v0, e1, e2):
    """(det_ok, u, v, t) of rays `o`/`d` (xyz triples) against triangles
    `v0`, `e1`, `e2` (xyz triples); every argument broadcasts. The JAX
    package's `_intersect_leaf` expression in its order (each product
    rounded on its own), no backface cull."""
    ox, oy, oz = o
    dx, dy, dz = d
    v0x, v0y, v0z = v0
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    det_ok = det.abs() > _EPS
    inv_det = torch.where(det_ok, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    return det_ok, u, v, t


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

_kernel = None
BUILD_LOG = ""  # nvcc's -Xptxas -v report of the loaded library's build


def kernel_library():
    """csrc/traverse.cu compiled for sm_90a, built at first use."""
    global _kernel, BUILD_LOG
    if _kernel is None:
        path, BUILD_LOG = build_shared_library(
            KERNEL_SOURCE, "traverse", [nvcc(), *NVCC_FLAGS])
        lib = ctypes.CDLL(str(path))
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.dxrpt_traverse.restype = ctypes.c_int
        lib.dxrpt_traverse.argtypes = [
            p, i32, i32, i32, i64, i32, i32, i32,   # table, walk constants
            p, p,                                   # alpha: rows, texels
            p, p, p, p, p, p, i64,                  # rays
            p,                                      # next-ray counter
            p, p, p, p,                             # outputs
            p]                                      # stream
        lib.dxrpt_traverse_resident_warps.restype = ctypes.c_int
        lib.dxrpt_traverse_resident_warps.argtypes = [i32, i32, i32]
        _kernel = lib
    return _kernel


def resident_warps(width: int, first_hit: bool, alpha: bool = False) -> int:
    """Warps of the kernel's (width, first_hit, alpha) instantiation that one
    SM of the current CUDA device holds at once (for W32, whose warps
    persist, the grid is this times the SM count)."""
    warps = kernel_library().dxrpt_traverse_resident_warps(
        width, int(first_hit), int(alpha))
    if warps <= 0:
        raise RuntimeError(f"traversal kernel occupancy query failed: CUDA "
                           f"error {-warps}")
    return warps


def _check(name, x, n, dtype, device, cols=None):
    shape = (n,) if cols is None else (n, cols)
    if x.dtype != dtype or tuple(x.shape) != shape or x.device != device:
        raise ValueError(f"{name}: want {dtype} {shape} on {device}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch_kernel(bvh: FlatBVH, ray_o, ray_d, inv_d, t_min, t_max, active,
                   first_hit: bool, alpha: AlphaTest | None = None
                   ) -> HitRecord:
    """One launch of the kernel over all rays, on the current stream; does
    not synchronise. With `alpha`, the alpha-tested instantiation."""
    dev = ray_o.device
    n = ray_o.shape[0]
    for name, x, dtype, cols in (
            ("ray_o", ray_o, torch.float32, 3),
            ("ray_d", ray_d, torch.float32, 3),
            ("inv_d", inv_d, torch.float32, 3),
            ("t_min", t_min, torch.float32, None),
            ("t_max", t_max, torch.float32, None),
            ("active", active, torch.bool, None)):
        _check(name, x, n, dtype, dev, cols)
    _check("bvh.table", bvh.table, bvh.num_rows, torch.float32, dev, RECORD)
    alpha_ptrs = (None, None)
    if alpha is not None:
        _check("alpha.tri_shade", alpha.tri_shade, alpha.tri_shade.shape[0],
               torch.float32, dev, TRI_SHADE_WIDTH)
        _check("alpha.texels", alpha.texels, alpha.texels.shape[0],
               torch.float32, dev, 4)
        alpha_ptrs = (alpha.tri_shade.data_ptr(), alpha.texels.data_ptr())
    if bvh.width not in (8, 32):
        raise ValueError(f"unsupported BVH width {bvh.width}")
    if bvh.stack_depth > MAX_STACK:
        raise ValueError(f"BVH needs a {bvh.stack_depth}-entry stack; the "
                         f"kernel holds {MAX_STACK}")
    lib = kernel_library()
    out_t = torch.empty(n, dtype=torch.float32, device=dev)
    out_tri = torch.empty(n, dtype=torch.int32, device=dev)
    out_u = torch.empty(n, dtype=torch.float32, device=dev)
    out_v = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return HitRecord(out_t, out_tri, out_u, out_v)
    # the persistent W32 warps take their next rays from this counter
    next_ray = torch.zeros(1, dtype=torch.int64, device=dev)
    max_iters = bvh.num_rows * 2 + bvh.stack_depth + 4
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dxrpt_traverse(
            bvh.table.data_ptr(), bvh.num_rows, bvh.root_code,
            bvh.stack_depth, max_iters, bvh.width, int(first_hit),
            int(bvh.has_alpha_flags), *alpha_ptrs,
            ray_o.data_ptr(), ray_d.data_ptr(), inv_d.data_ptr(),
            t_min.data_ptr(), t_max.data_ptr(), active.data_ptr(), n,
            next_ray.data_ptr(),
            out_t.data_ptr(), out_tri.data_ptr(), out_u.data_ptr(),
            out_v.data_ptr(), stream)
        key = (bvh.width, bool(first_hit), alpha is not None)
        KERNEL_LAUNCHES[key] = KERNEL_LAUNCHES.get(key, 0) + 1
    if rc != 0:
        raise RuntimeError(f"traversal kernel launch failed: CUDA error {rc}")
    return HitRecord(out_t, out_tri, out_u, out_v)


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LaneState:
    """Per-lane walk state, the carry of `_traverse`'s while_loop."""

    ox: torch.Tensor
    oy: torch.Tensor
    oz: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    ivx: torch.Tensor
    ivy: torch.Tensor
    ivz: torch.Tensor
    tmin: torch.Tensor
    cur: torch.Tensor     # (m,) i32 node code; bvh.num_rows when done
    pmask: torch.Tensor   # (m,) i32 children still to test at `cur`
    sp: torch.Tensor      # (m,) i32 stack height
    snode: torch.Tensor   # (S, m) i32 stacked nodes
    smask: torch.Tensor   # (S, m) i32 their remaining-children masks
    bt: torch.Tensor      # (m,) f32 best t
    btri: torch.Tensor    # (m,) i32 best triangle, -1 none
    bu: torch.Tensor
    bv: torch.Tensor


def _wrap_i32(x):
    """int64 -> the int32 with the same low 32 bits."""
    x = x & 0xFFFFFFFF
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _pow2(device):
    """(32,) int32: 1 << k with k = 31 wrapping to INT_MIN."""
    return _wrap_i32(torch.ones(32, dtype=torch.int64, device=device)
                     << torch.arange(32, device=device))


def _full_mask(width: int) -> int:
    """All-children pmask for a fresh internal visit (W=32 fills int32)."""
    return -1 if width == 32 else (1 << width) - 1


def init_lanes(bvh: FlatBVH, ray_o, ray_d, inv_d, t_min, t_max,
               active) -> LaneState:
    n = ray_o.shape[0]
    dev = ray_o.device
    i32 = torch.int32
    s = bvh.stack_depth
    return LaneState(
        ox=ray_o[:, 0], oy=ray_o[:, 1], oz=ray_o[:, 2],
        dx=ray_d[:, 0], dy=ray_d[:, 1], dz=ray_d[:, 2],
        ivx=inv_d[:, 0], ivy=inv_d[:, 1], ivz=inv_d[:, 2],
        tmin=t_min,
        cur=torch.where(active, bvh.root_code, bvh.num_rows).to(i32),
        pmask=torch.full((n,), _full_mask(bvh.width), dtype=i32, device=dev),
        sp=torch.zeros(n, dtype=i32, device=dev),
        snode=torch.zeros((s, n), dtype=i32, device=dev),
        smask=torch.zeros((s, n), dtype=i32, device=dev),
        bt=t_max.to(torch.float32),
        btri=torch.full((n,), -1, dtype=i32, device=dev),
        bu=torch.zeros(n, dtype=torch.float32, device=dev),
        bv=torch.zeros(n, dtype=torch.float32, device=dev))


def _child_banks(bvh: FlatBVH, rec):
    """[(lo_xyz, hi_xyz, codes, slot_offset, bank_width)] of gathered
    internal records: one f32 bank for W8; for W32 two bf16 banks decoded
    with integer ops (low half `u << 16`, high half `u & 0xFFFF0000`)."""
    w = bvh.width
    if w == 8:
        lo = (rec[:, 0:8], rec[:, 8:16], rec[:, 16:24])
        hi = (rec[:, 24:32], rec[:, 32:40], rec[:, 40:48])
        return [(lo, hi, rec[:, 48:56].view(torch.int32), 0, 8)]
    h = w // 2
    u = rec[:, 0:3 * w].view(torch.int32).to(torch.int64)
    banks = []
    for bank in range(2):
        bits = (u << 16) if bank == 0 else (u & 0xFFFF0000)
        fld = _wrap_i32(bits).view(torch.float32)
        f = [fld[:, k * h:(k + 1) * h] for k in range(6)]
        codes = rec[:, 3 * w + bank * h:3 * w + (bank + 1) * h].view(torch.int32)
        banks.append(((f[0], f[1], f[2]), (f[3], f[4], f[5]), codes,
                      bank * h, h))
    return banks


def _argmin_block(keys, codes, width: int, slot_offset: int, pow2):
    """Min over the child axis (lowest slot on ties): (key, code, slot bit)."""
    near_key = keys.amin(dim=1)
    is_min = keys <= near_key[:, None]
    slot = torch.arange(width, dtype=torch.int32, device=keys.device)[None, :]
    near_slot = torch.where(is_min, slot, width).amin(dim=1)
    first = slot == near_slot[:, None]
    near_code = torch.where(first, codes, 0).sum(dim=1).to(torch.int32)
    # clamp the no-hit sentinel so the shift stays defined
    shift = torch.clamp_max(near_slot + slot_offset, 31)
    return near_key, near_code, pow2[shift.long()]


def stack_step(cur, sp, snode, smask, alive, is_leaf, any_child, near_code,
               rest_mask, done: int, full_mask: int):
    """The walk's stack and cursor update (per lane, or per packet): ONE
    (node, remaining-children mask) push where an internal visit leaves
    hit siblings, then descend the nearest child, else pop the top entry
    (the parent, revisited with its mask), else done. cur, sp (m,); snode,
    smask (S, m). Returns (cur, pmask, sp, snode, smask), int32."""
    i32 = torch.int32
    is_int = alive & ~is_leaf
    levels = torch.arange(snode.shape[0], dtype=i32,
                          device=cur.device)[:, None]
    do_push = is_int & any_child & (rest_mask != 0)
    at_sp = (levels == sp[None, :]) & do_push[None, :]
    snode = torch.where(at_sp, cur[None, :], snode)
    smask = torch.where(at_sp, rest_mask[None, :], smask)
    sp_pushed = sp + do_push.to(i32)
    need_pop = is_leaf | (is_int & ~any_child)
    at_top = levels == (sp_pushed - 1)[None, :]
    top_node = torch.where(at_top, snode, 0).sum(dim=0).to(i32)
    top_mask = torch.where(at_top, smask, 0).sum(dim=0).to(i32)
    can_pop = sp_pushed > 0
    popped = torch.where(can_pop, top_node, done)
    nxt = torch.where(is_int & any_child, near_code,
                      torch.where(need_pop, popped, done))
    nxt = torch.where(alive, nxt, done).to(i32)
    pmask = torch.where(need_pop & can_pop, top_mask, full_mask).to(i32)
    sp = torch.where(need_pop & can_pop, sp_pushed - 1, sp_pushed).to(i32)
    return nxt, pmask, sp, snode, smask


def traverse_step_plain(bvh: FlatBVH, s: LaneState, first_hit: bool = False,
                        accept_fn=None) -> LaneState:
    """One lockstep step of every lane (`_kernel` / `_traverse`'s body).
    accept_fn(tid, u, v) -> bool, on the (k,) ids and barycentrics of the
    triangles that pass the geometric test: a triangle is a candidate only
    where it accepts (the alpha test), or None."""
    dev = s.cur.device
    i32 = torch.int32
    done = bvh.num_rows
    pow2 = _pow2(dev)
    alive = s.cur != done
    is_leaf = alive & (s.cur < 0)
    is_int = alive & (s.cur >= 0)
    row = torch.where(is_leaf, ~s.cur, torch.where(is_int, s.cur, 0))
    rec = bvh.table.index_select(0, row.long())        # (m, RECORD)

    ox, oy, oz = s.ox[:, None], s.oy[:, None], s.oz[:, None]
    ivx, ivy, ivz = s.ivx[:, None], s.ivy[:, None], s.ivz[:, None]
    tmin, best_t = s.tmin[:, None], s.bt[:, None]

    # ---- internal: slab-test all children, bank by bank ----
    hit_mask = torch.zeros_like(s.pmask)
    near_key = near_code = near_bit = None
    for (lox, loy, loz), (hix, hiy, hiz), codes, off, hw in \
            _child_banks(bvh, rec):
        tn, tf = slab_interval((lox, loy, loz), (hix, hiy, hiz),
                               (ox, oy, oz), (ivx, ivy, ivz), tmin, best_t)
        # empty slots carry inverted bounds; mask them from the record (the
        # slab result overflows to inf for steep rays)
        valid = lox <= hix
        slot_pow2 = pow2[off:off + hw][None, :]
        gate = (s.pmask[:, None] & slot_pow2) != 0
        hit = is_int[:, None] & valid & (tn <= tf) & gate
        keys = torch.where(hit, tn, _BIG)
        hit_mask = hit_mask | torch.where(hit, slot_pow2, 0).sum(dim=1).to(i32)
        nk, nc, nb = _argmin_block(keys, codes, hw, off, pow2)
        if near_key is None:
            near_key, near_code, near_bit = nk, nc, nb
        else:
            # strict < keeps the lower bank on ties (lowest slot wins)
            take = nk < near_key
            near_code = torch.where(take, nc, near_code)
            near_bit = torch.where(take, nb, near_bit)
            near_key = torch.minimum(nk, near_key)
    any_child = near_key < _BIG
    rest_mask = hit_mask & ~near_bit

    # ---- leaf: Moller-Trumbore over the 12 inline triangles ----
    L = LEAF_SIZE
    v0x, v0y, v0z = rec[:, 0:L], rec[:, L:2 * L], rec[:, 2 * L:3 * L]
    e1x, e1y, e1z = rec[:, 3 * L:4 * L], rec[:, 4 * L:5 * L], rec[:, 5 * L:6 * L]
    e2x, e2y, e2z = rec[:, 6 * L:7 * L], rec[:, 7 * L:8 * L], rec[:, 8 * L:9 * L]
    tid = rec[:, 9 * L:10 * L].view(i32)
    if bvh.has_alpha_flags:
        tid = torch.where(tid >= 0, tid & ~ALPHA_TID_BIT, tid)
    det_ok, u, v, t = moller_trumbore(
        (ox, oy, oz), (s.dx[:, None], s.dy[:, None], s.dz[:, None]),
        (v0x, v0y, v0z), (e1x, e1y, e1z), (e2x, e2y, e2z))
    ok = (is_leaf[:, None] & (tid >= 0) & det_ok
          & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t >= tmin) & (t < best_t))
    if accept_fn is not None:
        # ok & accept_fn(tid, u, v), the test taken at the candidates only
        cand = ok.nonzero(as_tuple=True)
        ok = ok.index_put(cand, accept_fn(tid[cand], u[cand], v[cand]))
    key = torch.where(ok, t, _BIG)
    ck = key.amin(dim=1)
    slot = torch.arange(L, dtype=i32, device=dev)[None, :]
    min_slot = torch.where(key <= ck[:, None], slot, L).amin(dim=1)
    first = slot == min_slot[:, None]
    ctid = torch.where(first, tid, 0).sum(dim=1).to(i32)
    cu = torch.where(first, u, 0.0).sum(dim=1)
    cv = torch.where(first, v, 0.0).sum(dim=1)
    win = ck < _BIG
    btri = torch.where(win, ctid, s.btri)
    bu = torch.where(win, cu, s.bu)
    bv = torch.where(win, cv, s.bv)
    bt = torch.where(win, ck, s.bt)

    cur, pmask, sp, snode, smask = stack_step(
        s.cur, s.sp, s.snode, s.smask, alive, is_leaf, any_child, near_code,
        rest_mask, done, _full_mask(bvh.width))

    if first_hit:
        # accept the first hit and end the search
        found = btri >= 0
        cur = torch.where(found, done, cur).to(i32)
        sp = torch.where(found, 0, sp)

    return dataclasses.replace(s, cur=cur, pmask=pmask, sp=sp.to(i32),
                               snode=snode, smask=smask, bt=bt, btri=btri,
                               bu=bu, bv=bv)


def traverse_plain(bvh: FlatBVH, ray_o, ray_d, inv_d, t_min, t_max, active,
                   first_hit: bool = False, accept_fn=None) -> HitRecord:
    """Loops `traverse_step_plain` until every lane is done (or the safety
    bound of `_traverse`, num_rows*2 + stack_depth + 4 steps, is reached)."""
    s = init_lanes(bvh, ray_o, ray_d, inv_d, t_min, t_max, active)
    max_iters = bvh.num_rows * 2 + bvh.stack_depth + 4
    it = 0
    while it < max_iters and bool((s.cur != bvh.num_rows).any()):
        s = traverse_step_plain(bvh, s, first_hit, accept_fn)
        it += 1
    return HitRecord(t=s.bt, tri_id=s.btri, u=s.bu, v=s.bv)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _traverse(bvh: FlatBVH, ray_o, ray_d, t_min, t_max, active,
              first_hit: bool, alpha: AlphaTest | None) -> HitRecord:
    n = ray_o.shape[0]
    dev = ray_o.device
    ray_o = ray_o.to(torch.float32).contiguous()
    ray_d = ray_d.to(torch.float32).contiguous()
    t_min = torch.as_tensor(t_min, dtype=torch.float32, device=dev)
    t_min = t_min.expand(n).contiguous()
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev)
    t_max = t_max.expand(n).contiguous()
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    active = active.contiguous()
    inv_d = safe_inv(ray_d).contiguous()
    if dev.type == "cuda":
        return _launch_kernel(bvh, ray_o, ray_d, inv_d, t_min, t_max, active,
                              first_hit, alpha)
    if dev.type == "cpu":
        return traverse_plain(bvh, ray_o, ray_d, inv_d, t_min, t_max, active,
                              first_hit, alpha)
    raise ValueError(f"no traversal for device {dev}")


@spanned("traverse.closest")
def closest_hit(bvh: FlatBVH, ray_o, ray_d, t_min, t_max, active=None,
                alpha: AlphaTest | None = None) -> HitRecord:
    """Closest-hit traversal of a flat ray batch.

    ray_o/ray_d: (N, 3); t_min/t_max: scalar or (N,); active: (N,) bool or
    None; alpha: the alpha test, or None (every triangle opaque:
    FORCE_OPAQUE). Misses keep t == t_max and tri_id == -1.
    """
    return _traverse(bvh, ray_o, ray_d, t_min, t_max, active, False, alpha)


def any_hit(bvh: FlatBVH, ray_o, ray_d, t_min, t_max, active=None,
            alpha: AlphaTest | None = None):
    """Any-hit (shadow) traversal; returns visibility (N,) f32 in {0, 1},
    1 when unoccluded (ShadowPayload, RayTrace.hlsl:73-76,533-541)."""
    return any_hit_rec(bvh, ray_o, ray_d, t_min, t_max, active, alpha)[0]


@spanned("traverse.any")
def any_hit_rec(bvh: FlatBVH, ray_o, ray_d, t_min, t_max, active=None,
                alpha: AlphaTest | None = None):
    """any_hit that also returns the occluder: (visibility, the triangle
    that ended the walk, -1 where the lane is unoccluded or inactive), for
    the history-seeded sun rays (accel/history.py)."""
    rec = _traverse(bvh, ray_o, ray_d, t_min, t_max, active, True, alpha)
    return torch.where(rec.hit, 0.0, 1.0), rec.tri_id
