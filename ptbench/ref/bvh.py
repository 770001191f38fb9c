"""The reference's own acceleration structure and per-ray walk.

Independent of the program's tables: a binary tree over triangles sorted by
size class, then by the Morton code of their centroids, four triangles a
leaf, the leaves padded
to a power of two and laid out as a complete heap (node i has children 2i+1
and 2i+2), built on the host with numpy. The walk is plain torch, lockstep
over the rays that are still walking: pop a node; an internal node
slab-tests both children and pushes the hit ones, the nearer last; a leaf
runs Moller-Trumbore on its triangles. Ray-triangle arithmetic is the
program's (dxrpathtracer_tpu_torch/accel/traverse.py:112-164, copied below),
with each triangle's edges taken in float32 from its vertices as the
program's tables store them, so a hit found on both sides has the same t,
u and v. The tree differs, so of two triangles at exactly the same t the
two sides may report different ones.
"""

import dataclasses

import numpy as np
import torch

LEAF = 4
_BIG = 3e38
_EPS = 1e-12
STACK = 64


@dataclasses.dataclass
class RefBVH:
    lo: torch.Tensor        # (nodes, 3) f32 box minima (NaN: empty)
    hi: torch.Tensor        # (nodes, 3)
    leaf_tris: torch.Tensor  # (leaves, LEAF) int64, -1 for an empty slot
    v0: torch.Tensor        # (T, 3) f32
    e1: torch.Tensor        # (T, 3) f32
    e2: torch.Tensor        # (T, 3) f32
    first_leaf: int         # heap index of leaf 0

    def to(self, device):
        return dataclasses.replace(
            self, **{f.name: getattr(self, f.name).to(device)
                     for f in dataclasses.fields(self)
                     if isinstance(getattr(self, f.name), torch.Tensor)})


def _morton3(q):
    """30-bit Morton codes of (N, 3) integer cells in [0, 1024)."""
    def spread(x):
        x = x.astype(np.uint64) & 0x3FF
        x = (x | (x << 16)) & 0x30000FF
        x = (x | (x << 8)) & 0x300F00F
        x = (x | (x << 4)) & 0x30C30C3
        x = (x | (x << 2)) & 0x9249249
        return x
    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


def build(positions, tri_idx) -> RefBVH:
    pos = np.asarray(positions, np.float32)
    tri = np.asarray(tri_idx, np.int64)
    v0, v1, v2 = pos[tri[:, 0]], pos[tri[:, 1]], pos[tri[:, 2]]
    e1 = (v1 - v0).astype(np.float32)
    e2 = (v2 - v0).astype(np.float32)
    tlo = np.minimum(np.minimum(v0, v1), v2)
    thi = np.maximum(np.maximum(v0, v1), v2)
    cen = (tlo.astype(np.float64) + thi) * 0.5
    c_lo, c_hi = cen.min(axis=0), cen.max(axis=0)
    q = np.clip((cen - c_lo) / np.maximum(c_hi - c_lo, 1e-30) * 1023.0,
                0, 1023).astype(np.int64)
    # triangles of one size class (a factor of two in box diagonal) are
    # kept together, the largest first, each class in Morton order: a few
    # large triangles (walls, floors) then widen only a few leaves and
    # their ancestors, not leaves all over the tree
    diag = np.linalg.norm(thi.astype(np.float64) - tlo, axis=1)
    extent = max(float(np.linalg.norm(c_hi - c_lo)), 1e-30)
    size_class = np.clip(np.floor(np.log2(np.maximum(diag / extent, 1e-9))),
                         -20, 0).astype(np.int64)
    order = np.lexsort((_morton3(q), -size_class))
    t = tri.shape[0]
    n_leaf = max(1, -(-t // LEAF))
    leaves = 1 << int(np.ceil(np.log2(n_leaf))) if n_leaf > 1 else 1
    leaf_tris = np.full((leaves * LEAF,), -1, np.int64)
    leaf_tris[:t] = order
    leaf_tris = leaf_tris.reshape(leaves, LEAF)
    # leaf boxes, widened by a little so that rounding in the slab test
    # never drops a triangle the exact test would reach
    big = np.float32(3e38)
    pad_lo = np.where(leaf_tris[..., None] >= 0,
                      tlo[np.maximum(leaf_tris, 0)], big)
    pad_hi = np.where(leaf_tris[..., None] >= 0,
                      thi[np.maximum(leaf_tris, 0)], -big)
    lvl_lo = pad_lo.min(axis=1)
    lvl_hi = pad_hi.max(axis=1)
    scale = float(np.abs(np.concatenate([tlo, thi])).max()) if t else 1.0
    slack = np.float32(scale * 1e-6)
    empty = lvl_lo > lvl_hi
    lvl_lo = np.where(empty, lvl_lo, lvl_lo - slack)
    lvl_hi = np.where(empty, lvl_hi, lvl_hi + slack)
    levels = [(lvl_lo, lvl_hi)]
    while levels[-1][0].shape[0] > 1:
        lo, hi = levels[-1]
        levels.append((np.minimum(lo[0::2], lo[1::2]),
                       np.maximum(hi[0::2], hi[1::2])))
    lo = np.concatenate([lv[0] for lv in reversed(levels)]).astype(np.float32)
    hi = np.concatenate([lv[1] for lv in reversed(levels)]).astype(np.float32)
    # a box over empty slots only: NaN, which no slab test passes
    none = (lo > hi).any(axis=1)
    lo[none] = np.nan
    hi[none] = np.nan
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return RefBVH(lo=f(lo), hi=f(hi), leaf_tris=f(leaf_tris), v0=f(v0),
                  e1=f(e1), e2=f(e2), first_leaf=leaves - 1)


def safe_inv(d):
    """dxrpathtracer_tpu_torch/accel/traverse.py:112-116."""
    nudged = torch.where(d < 0.0, -_EPS, _EPS).to(d.dtype)
    return 1.0 / torch.where(d.abs() < _EPS, nudged, d)


def moller_trumbore(o, d, v0, e1, e2):
    """dxrpathtracer_tpu_torch/accel/traverse.py:135-164: (det_ok, u, v, t),
    each product rounded on its own, no backface cull."""
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


def _slab(lo, hi, o, iv, t_lo, t_hi):
    t0 = (lo - o) * iv
    t1 = (hi - o) * iv
    tn = torch.maximum(torch.minimum(t0, t1).amax(dim=-1), t_lo)
    tf = torch.minimum(torch.maximum(t0, t1).amin(dim=-1), t_hi)
    return tn, tf


def trace(bvh: RefBVH, ray_o, ray_d, t_min, t_max, active=None,
          any_hit: bool = False, accept=None):
    """(t, tri_id, u, v) of the closest accepted hit in [t_min, t_max) of
    each ray (t = t_max and tri_id = -1 where none), or with any_hit=True
    of the first one found. accept(tri_id, u, v) -> bool, or None."""
    n, dev = ray_o.shape[0], ray_o.device
    f32 = torch.float32
    ray_o = ray_o.to(f32)
    ray_d = ray_d.to(f32)
    t_min = torch.as_tensor(t_min, dtype=f32, device=dev).expand(n)
    best_t = torch.as_tensor(t_max, dtype=f32, device=dev).expand(n).clone()
    best_tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros(n, dtype=f32, device=dev)
    best_v = torch.zeros(n, dtype=f32, device=dev)
    inv = safe_inv(ray_d)
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    stack = torch.zeros((n, STACK), dtype=torch.int64, device=dev)
    sp = active.to(torch.int64)  # the root (0) sits at stack[:, 0]
    idx = active.nonzero()[:, 0]
    first_leaf = bvh.first_leaf
    while idx.numel():
        o, d, iv = ray_o[idx], ray_d[idx], inv[idx]
        tmin, bt = t_min[idx], best_t[idx]
        s = sp[idx] - 1
        node = stack[idx, s]
        is_leaf = node >= first_leaf
        # internal: both children, the nearer pushed last (popped first)
        c0 = torch.where(is_leaf, 0, 2 * node + 1)
        c1 = c0 + torch.where(is_leaf, 0, 1)
        tn0, tf0 = _slab(bvh.lo[c0], bvh.hi[c0], o, iv, tmin, bt)
        tn1, tf1 = _slab(bvh.lo[c1], bvh.hi[c1], o, iv, tmin, bt)
        h0 = ~is_leaf & (tn0 <= tf0)
        h1 = ~is_leaf & (tn1 <= tf1)
        swap = h0 & h1 & (tn1 > tn0)  # c1 farther: push it first
        far = torch.where(swap, c1, c0)
        near = torch.where(swap, c0, c1)
        far_hit = torch.where(swap, h1, h0)
        near_hit = torch.where(swap, h0, h1)
        stack[idx, s] = far
        s2 = s + far_hit.to(torch.int64)
        stack[idx, s2] = near
        s3 = s2 + near_hit.to(torch.int64)
        # leaf: Moller-Trumbore over its triangles
        leaf = torch.where(is_leaf, node - first_leaf, 0)
        tid = bvh.leaf_tris[leaf]                       # (k, LEAF)
        st = torch.clamp_min(tid, 0)
        v0, e1, e2 = bvh.v0[st], bvh.e1[st], bvh.e2[st]
        split = lambda a: (a[..., 0], a[..., 1], a[..., 2])  # noqa: E731
        det_ok, u, v, t = moller_trumbore(
            split(o[:, None, :]), split(d[:, None, :]), split(v0),
            split(e1), split(e2))
        ok = (is_leaf[:, None] & (tid >= 0) & det_ok & (u >= 0.0)
              & (v >= 0.0) & (u + v <= 1.0) & (t >= tmin[:, None])
              & (t < bt[:, None]))
        if accept is not None:
            cand = ok.nonzero(as_tuple=True)
            if cand[0].numel():
                ok = ok.index_put(cand, accept(tid[cand], u[cand], v[cand]))
        key = torch.where(ok, t, _BIG)
        ck, slot = key.min(dim=1)
        win = ck < _BIG
        pick = lambda a: a.gather(1, slot[:, None])[:, 0]  # noqa: E731
        best_t[idx] = torch.where(win, ck, bt)
        best_tri[idx] = torch.where(win, pick(tid), best_tri[idx])
        best_u[idx] = torch.where(win, pick(u), best_u[idx])
        best_v[idx] = torch.where(win, pick(v), best_v[idx])
        if any_hit:
            s3 = torch.where(win, 0, s3)
        sp[idx] = s3
        idx = idx[s3 > 0]
    return best_t, best_tri, best_u, best_v
