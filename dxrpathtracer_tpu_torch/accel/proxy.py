"""The dense-proxy and AABB-cut screens of the per-ray walks: the CUDA
kernels' wrappers, their plain versions and their host builders.

The port of dxrpathtracer_tpu/accel/proxy.py. Two broadcast stages take
lanes out of a per-ray walk before it starts, and neither changes a result:
  - the dense proxy: every lane against the K largest-area opaque triangles
    of the scene (`build_dense_proxy`). A proxy hit is a real occluder, so an
    any-hit lane that hits one is blocked without a walk (`proxy_blocked`,
    `screened_any`).
  - the AABB cut: C covering boxes of morton-contiguous triangle chunks
    (`build_aabb_cut`). A segment that overlaps none of them (by a slab test
    with slack that leaves fp-marginal lanes to the walk) hits nothing, so
    the lane is a miss without a walk (`cut_clear`). The session turns it on
    per scene where a host probe of surface-hemisphere rays finds at least
    CUT_MIN_CLEAR of them clear (`probe_clear_fraction`).

The proxy also seeds closest hits (`seeded_closest`, behind
DXRPT_PROXY_SEED as in the JAX package): `proxy_closest` finds each lane's
nearest proxy hit, whose t bounds the per-ray walk; where the walk finds
nothing under the bound, the proxy hit stands.

All three tests are one kernel source, csrc/screen.cu (`_launch`): one
thread per lane, the columns in shared memory. `proxy_blocked`,
`proxy_closest` and `cut_clear` launch it for CUDA tensors and run
`proxy_blocked_plain` / `proxy_closest_plain` / `cut_clear_plain` (the JAX
package's expressions in the same order, over lane chunks) for CPU tensors;
they route on the device alone.

Three faults of the JAX module are not carried over: `build_aabb_cut` keeps
at least one box for any chunk count (JAX's leaves zero boxes for c <= 0, and
every lane is then "clear"), `probe_clear_fraction` keeps the sign of a
near-zero direction component as `cut_clear` does (JAX's flips negative
ones), and `screened_any` applies its cut itself (JAX's `cut` parameter is
never passed).
"""

import ctypes
import dataclasses
from pathlib import Path

import numpy as np
import torch

from ..app.profiler import spanned
from ..buildlib import build_shared_library, nvcc
from .bvh import morton_codes_30
from .traverse import (NVCC_FLAGS, HitRecord, moller_trumbore, safe_inv,
                       slab_interval)

KERNEL_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "screen.cu"
PROXY_K = 128         # proxy triangles (the JAX session's default)
CUT_C = 128           # covering boxes (the JAX session's default)
CUT_MIN_CLEAR = 0.10  # probe fraction that turns the cut on
# csrc/screen.cu holds 12 * 1024 column floats in shared memory: 9 per
# proxy triangle, 6 per box
MAX_COLUMNS = 12 * 1024 // 9

# Launches of each screen kernel since the process started (or since a
# caller last reset them). Only `_launch` adds to them.
KERNEL_LAUNCHES = {"proxy_blocked": 0, "proxy_closest": 0, "cut_clear": 0}

_EPS = 1e-12
_BIG = 3e38
# The seeded walk's bound over the proxy hit: JAX's pt * (1.0 + 1e-5), the
# weakly typed constant rounded to f32 before the product.
SEED_SLACK = np.float32(1.0 + 1e-5)
_CHUNK = 1 << 15  # lanes per plain broadcast: (chunk, K) temporaries stay small


@dataclasses.dataclass(frozen=True)
class DenseProxy:
    """K proxy triangles as columns: tris (9, K) f32 rows v0x v0y v0z e1x e1y
    e1z e2x e2y e2z, and their original ids (K,) i32, largest area first."""

    tris: torch.Tensor
    tri_id: torch.Tensor

    @property
    def k(self) -> int:
        return self.tris.shape[1]

    def to(self, device) -> "DenseProxy":
        return DenseProxy(self.tris.to(device), self.tri_id.to(device))


@dataclasses.dataclass(frozen=True)
class AABBCut:
    """C covering boxes as columns: boxes (6, C) f32 rows lox loy loz hix hiy
    hiz."""

    boxes: torch.Tensor

    @property
    def c(self) -> int:
        return self.boxes.shape[1]

    def to(self, device) -> "AABBCut":
        return AABBCut(self.boxes.to(device))


# ---------------------------------------------------------------------------
# Host builders (numpy, once per scene)
# ---------------------------------------------------------------------------

def build_dense_proxy(positions, tri_idx, tri_alpha=None,
                      k: int = PROXY_K) -> DenseProxy | None:
    """The K largest-area triangles, alpha-tested ones (tri_alpha, (T,) bool)
    left out: a proxy hit must be a definitive opaque occlusion. v0/e1/e2 are
    f32 as the leaf packer makes them (e1 = v1 - v0 in f32), so a proxy t is
    the walk's t of the same triangle; the area ranking is f64. None for a
    scene with fewer than 8 eligible triangles."""
    pos = np.asarray(positions, np.float32)
    tri = np.asarray(tri_idx)
    v0 = pos[tri[:, 0]]
    e1 = pos[tri[:, 1]] - v0
    e2 = pos[tri[:, 2]] - v0
    area2 = np.linalg.norm(np.cross(e1.astype(np.float64),
                                    e2.astype(np.float64)), axis=1)
    if tri_alpha is not None:
        area2 = np.where(np.asarray(tri_alpha, bool), -1.0, area2)
    k = min(k, int((area2 > 0).sum()))
    if k < 8:
        return None
    if k > MAX_COLUMNS:
        raise ValueError(f"a proxy of {k} triangles exceeds the kernel's "
                         f"{MAX_COLUMNS}")
    sel = np.argpartition(area2, -k)[-k:].astype(np.int32)
    sel = sel[np.argsort(-area2[sel], kind="stable")]
    cols = np.stack([v0[sel, 0], v0[sel, 1], v0[sel, 2],
                     e1[sel, 0], e1[sel, 1], e1[sel, 2],
                     e2[sel, 0], e2[sel, 1], e2[sel, 2]]).astype(np.float32)
    return DenseProxy(torch.from_numpy(cols), torch.from_numpy(sel))


def build_aabb_cut(positions, tri_idx, c: int = CUT_C) -> AABBCut | None:
    """Morton-sort the triangle centroids, split the order into c contiguous
    chunks (at least one, at most T // 4) and box each chunk, expanded
    outward by 1e-5 of the scene diagonal and rounded outward to f32: every
    triangle lies in a box. None for a scene of fewer than 8 triangles."""
    pos = np.asarray(positions, np.float64)
    tri = np.asarray(tri_idx)
    t = tri.shape[0]
    if t < 8:
        return None
    c = max(1, min(int(c), t // 4))
    if c > MAX_COLUMNS:
        raise ValueError(f"a cut of {c} boxes exceeds the kernel's "
                         f"{MAX_COLUMNS}")
    v = pos[tri]                      # (T, 3, 3)
    cent = v.mean(axis=1)
    order = np.argsort(morton_codes_30(cent.astype(np.float32)),
                       kind="stable")
    bounds_lo = np.empty((c, 3), np.float64)
    bounds_hi = np.empty((c, 3), np.float64)
    edges = np.linspace(0, t, c + 1).astype(np.int64)
    for i in range(c):
        chunk = v[order[edges[i]:edges[i + 1]]]
        bounds_lo[i] = chunk.min(axis=(0, 1))
        bounds_hi[i] = chunk.max(axis=(0, 1))
    diag = np.linalg.norm(pos[tri.reshape(-1)].max(0)
                          - pos[tri.reshape(-1)].min(0))
    eps = 1e-5 * max(diag, 1e-6)
    lo = (bounds_lo - eps).astype(np.float32)
    hi = (bounds_hi + eps).astype(np.float32)
    # the f64 -> f32 cast may round toward the inside: step outward
    lo = np.where(lo > bounds_lo, np.nextafter(lo, -np.inf), lo)
    hi = np.where(hi < bounds_hi, np.nextafter(hi, np.inf), hi)
    return AABBCut(torch.from_numpy(
        np.ascontiguousarray(np.concatenate([lo.T, hi.T]), np.float32)))


def nudged_reciprocal(d: np.ndarray) -> np.ndarray:
    """1 / d with components of magnitude below 1e-12 replaced by 1e-12 of
    their own sign (-0 counts as positive), as `cut_clear` computes it."""
    return 1.0 / np.where(np.abs(d) < _EPS, np.where(d < 0.0, -_EPS, _EPS), d)


def probe_clear_fraction(cut: AABBCut, positions, tri_idx, m: int = 4096,
                         seed: int = 0) -> float:
    """The share of m surface-hemisphere rays (a random point of a random
    triangle, a uniform direction about its normal, either side) that
    overlap none of the cut's boxes: the population of the depth >= 2
    screens. Deterministic (seeded), numpy only."""
    rng = np.random.default_rng(seed)
    pos = np.asarray(positions, np.float64)
    tri = np.asarray(tri_idx)
    pick = rng.integers(0, tri.shape[0], m)
    a = pos[tri[pick, 0]]
    b = pos[tri[pick, 1]]
    c = pos[tri[pick, 2]]
    r1 = np.sqrt(rng.random(m))
    r2 = rng.random(m)
    p = a * (1 - r1)[:, None] + b * (r1 * (1 - r2))[:, None] + (
        c * (r1 * r2)[:, None])
    n = np.cross(b - a, c - a)
    nl = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(nl, 1e-20)
    d = rng.normal(size=(m, 3))
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-20)
    side = np.where(rng.random(m) < 0.5, 1.0, -1.0)[:, None]
    flip = np.sign(np.sum(d * n, axis=1, keepdims=True))
    d = d * np.where(flip == 0, 1.0, flip) * side
    diag = np.linalg.norm(pos.max(0) - pos.min(0))
    o = p + n * side * (1e-4 * diag)
    boxes = cut.boxes.cpu().numpy().astype(np.float64)
    lo, hi = boxes[:3].T, boxes[3:].T  # (C, 3)
    inv = nudged_reciprocal(d)
    t0 = (lo[None] - o[:, None]) * inv[:, None]   # (m, C, 3)
    t1 = (hi[None] - o[:, None]) * inv[:, None]
    enter = np.minimum(t0, t1).max(axis=2)
    exit_ = np.maximum(t0, t1).min(axis=2)
    hit = (enter <= exit_) & (exit_ >= 0.0)
    return float((~hit.any(axis=1)).mean())


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

_kernel = None
BUILD_LOG = ""  # nvcc's -Xptxas -v report of the loaded library's build


def kernel_library():
    """csrc/screen.cu compiled for sm_90a, built at first use."""
    global _kernel, BUILD_LOG
    if _kernel is None:
        path, BUILD_LOG = build_shared_library(
            KERNEL_SOURCE, "screen", [nvcc(), *NVCC_FLAGS])
        lib = ctypes.CDLL(str(path))
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        for fn in (lib.dxrpt_proxy_blocked, lib.dxrpt_cut_clear):
            fn.restype = ctypes.c_int
            fn.argtypes = [p, i32, p, p, p, p, p, i64, p, p]
        lib.dxrpt_proxy_closest.restype = ctypes.c_int
        lib.dxrpt_proxy_closest.argtypes = [p, p, i32, p, p, p, p, p, i64,
                                            p, p, p, p, p]
        _kernel = lib
    return _kernel


def _rays(ray_o, ray_d, t_min, t_max, active):
    """The rays as the kernels take them: f32 (n, 3), (n, 3), (n,), (n,) and
    bool (n,), contiguous, on ray_o's device."""
    n, dev = ray_o.shape[0], ray_o.device
    f32 = torch.float32
    rays = (ray_o.to(f32).contiguous(), ray_d.to(f32).contiguous(),
            torch.as_tensor(t_min, dtype=f32, device=dev).expand(n).contiguous(),
            torch.as_tensor(t_max, dtype=f32, device=dev).expand(n).contiguous(),
            (torch.ones(n, dtype=torch.bool, device=dev) if active is None
             else active.contiguous()))
    for name, x, shape, dtype in zip(
            ("ray_o", "ray_d", "t_min", "t_max", "active"), rays,
            ((n, 3), (n, 3), (n,), (n,), (n,)), (f32, f32, f32, f32,
                                                 torch.bool)):
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != dev:
            raise ValueError(f"{name}: want {dtype} {shape} on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    return rays


def _launch(name: str, columns, rays):
    """One launch of the `name` screen over all lanes on the current stream;
    does not synchronise. columns: (9, K) or (6, C) f32 on the rays'
    device."""
    ray_o = rays[0]
    n, dev = ray_o.shape[0], ray_o.device
    rows = 9 if name == "proxy_blocked" else 6
    if (columns.dtype != torch.float32 or columns.dim() != 2
            or columns.shape[0] != rows or columns.device != dev
            or not columns.is_contiguous()):
        raise ValueError(f"{name}: want contiguous f32 ({rows}, k) columns "
                         f"on {dev}, got {columns.dtype} "
                         f"{tuple(columns.shape)} on {columns.device}")
    if not 1 <= columns.shape[1] <= MAX_COLUMNS:
        raise ValueError(f"{name}: {columns.shape[1]} columns, the kernel "
                         f"takes 1..{MAX_COLUMNS}")
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out
    fn = getattr(kernel_library(), f"dxrpt_{name}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(columns.data_ptr(), columns.shape[1],
                *(x.data_ptr() for x in rays), n, out.data_ptr(), stream)
        KERNEL_LAUNCHES[name] += 1
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return out


def _launch_closest(proxy: DenseProxy, rays) -> HitRecord:
    """One launch of the proxy's closest-hit test over all lanes on the
    current stream; does not synchronise."""
    ray_o = rays[0]
    n, dev = ray_o.shape[0], ray_o.device
    cols, ids = proxy.tris, proxy.tri_id
    if (cols.dtype != torch.float32 or cols.dim() != 2 or cols.shape[0] != 9
            or cols.device != dev or not cols.is_contiguous()
            or ids.dtype != torch.int32 or tuple(ids.shape) != (cols.shape[1],)
            or ids.device != dev or not ids.is_contiguous()):
        raise ValueError(f"proxy_closest: want contiguous f32 (9, k) columns "
                         f"and i32 (k,) ids on {dev}")
    if not 1 <= proxy.k <= MAX_COLUMNS:
        raise ValueError(f"proxy_closest: {proxy.k} columns, the kernel "
                         f"takes 1..{MAX_COLUMNS}")
    out = HitRecord(t=torch.empty(n, dtype=torch.float32, device=dev),
                    tri_id=torch.empty(n, dtype=torch.int32, device=dev),
                    u=torch.empty(n, dtype=torch.float32, device=dev),
                    v=torch.empty(n, dtype=torch.float32, device=dev))
    if n == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = kernel_library().dxrpt_proxy_closest(
            cols.data_ptr(), ids.data_ptr(), proxy.k,
            *(x.data_ptr() for x in rays), n, out.t.data_ptr(),
            out.tri_id.data_ptr(), out.u.data_ptr(), out.v.data_ptr(), stream)
        KERNEL_LAUNCHES["proxy_closest"] += 1
    if rc != 0:
        raise RuntimeError(f"proxy_closest kernel launch failed: CUDA error "
                           f"{rc}")
    return out


# ---------------------------------------------------------------------------
# The plain versions
# ---------------------------------------------------------------------------

def _count_tests(stats, hit, active):
    """Adds to stats["tests"] the columns the kernel tests: for each active
    lane, up to and including its first hit, else all of them."""
    if stats is not None:
        first = torch.where(hit.any(dim=1), hit.to(torch.uint8).argmax(dim=1)
                            + 1, hit.shape[1])
        stats["tests"] = stats.get("tests", 0) + int(first[active].sum())


def proxy_blocked_plain(proxy: DenseProxy, ray_o, ray_d, t_min, t_max,
                        active, stats: dict | None = None):
    """JAX `proxy_blocked`'s (N, K) broadcast Moller-Trumbore, chunked over
    lanes: True where an active lane's [t_min, t_max) hits a proxy
    triangle. With `stats`, adds the triangle tests the kernel makes
    ("tests") to it."""
    cols = [c[None, :] for c in proxy.tris]  # (1, K) each
    out = []
    for i in range(0, ray_o.shape[0], _CHUNK):
        sl = slice(i, i + _CHUNK)
        det_ok, u, v, t = moller_trumbore(
            [ray_o[sl, c:c + 1] for c in range(3)],
            [ray_d[sl, c:c + 1] for c in range(3)],
            cols[0:3], cols[3:6], cols[6:9])
        ok = (det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
              & (t >= t_min[sl, None]) & (t < t_max[sl, None]))
        _count_tests(stats, ok, active[sl])
        out.append(active[sl] & ok.any(dim=1))
    return torch.cat(out) if out else active.clone()


def proxy_closest_plain(proxy: DenseProxy, ray_o, ray_d, t_min, t_max,
                        active, stats: dict | None = None) -> HitRecord:
    """JAX `proxy_closest`'s (N, K) broadcast Moller-Trumbore, chunked over
    lanes: each active lane's least t among the proxy triangles hit in
    [t_min, t_max), the lowest slot (the largest triangle) on equal t; a
    lane with no hit keeps t = t_max, tri_id = -1, u = v = 0. With
    `stats`, adds the triangle tests the kernel makes ("tests": K per
    active lane) to it."""
    cols = [c[None, :] for c in proxy.tris]  # (1, K) each
    k = proxy.k
    slot = torch.arange(k, dtype=torch.int32, device=ray_o.device)[None, :]
    parts = []
    for i in range(0, ray_o.shape[0], _CHUNK):
        sl = slice(i, i + _CHUNK)
        det_ok, u, v, t = moller_trumbore(
            [ray_o[sl, c:c + 1] for c in range(3)],
            [ray_d[sl, c:c + 1] for c in range(3)],
            cols[0:3], cols[3:6], cols[6:9])
        ok = (det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
              & (t >= t_min[sl, None]) & (t < t_max[sl, None])
              & active[sl, None])
        key = torch.where(ok, t, _BIG)
        best = key.amin(dim=1)
        min_slot = torch.where(key <= best[:, None], slot, k).amin(dim=1)
        first = slot == min_slot[:, None]
        win = best < _BIG
        tri = torch.where(first, proxy.tri_id[None, :], 0).sum(dim=1)
        pu = torch.where(first, u, 0.0).sum(dim=1)
        pv = torch.where(first, v, 0.0).sum(dim=1)
        parts.append((torch.where(win, best, t_max[sl]),
                      torch.where(win, tri, -1).to(torch.int32),
                      torch.where(win, pu, 0.0), torch.where(win, pv, 0.0)))
    if stats is not None:
        stats["tests"] = stats.get("tests", 0) + int(active.sum()) * k
    if not parts:
        return HitRecord(t_max.clone(), torch.full_like(t_max, -1,
                                                        dtype=torch.int32),
                         torch.zeros_like(t_max), torch.zeros_like(t_max))
    return HitRecord(*(torch.cat([p[j] for p in parts]) for j in range(4)))


def cut_clear_plain(cut: AABBCut, ray_o, ray_d, t_min, t_max, active,
                    stats: dict | None = None):
    """JAX `cut_clear`'s (N, C) slab test with slack, chunked over lanes:
    True where an active lane's segment overlaps no box. With `stats`, adds
    the box tests the kernel makes ("tests") to it."""
    cols = [c[None, :] for c in cut.boxes]  # (1, C) each
    out = []
    for i in range(0, ray_o.shape[0], _CHUNK):
        sl = slice(i, i + _CHUNK)
        inv = safe_inv(ray_d[sl])
        enter, exit_ = slab_interval(
            cols[0:3], cols[3:6], [ray_o[sl, c:c + 1] for c in range(3)],
            [inv[:, c:c + 1] for c in range(3)], t_min[sl, None],
            t_max[sl, None])
        slack = 1e-4 * exit_.abs() + 1e-6
        maybe_hit = enter <= exit_ + slack
        _count_tests(stats, maybe_hit, active[sl])
        out.append(active[sl] & ~maybe_hit.any(dim=1))
    return torch.cat(out) if out else active.clone()


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _route(name, columns, plain, screen, ray_o, ray_d, t_min, t_max, active):
    rays = _rays(ray_o, ray_d, t_min, t_max, active)
    dev = rays[0].device
    if dev.type == "cuda":
        return _launch(name, columns, rays)
    if dev.type == "cpu":
        return plain(screen, *rays)
    raise ValueError(f"no {name} for device {dev}")


def proxy_blocked(proxy: DenseProxy, ray_o, ray_d, t_min, t_max,
                  active=None):
    """(N,) bool: True where a proxy triangle occludes an active lane's
    segment [t_min, t_max) — a definitive any-hit verdict; False leaves the
    lane to the walk."""
    return _route("proxy_blocked", proxy.tris, proxy_blocked_plain, proxy,
                  ray_o, ray_d, t_min, t_max, active)


def proxy_closest(proxy: DenseProxy, ray_o, ray_d, t_min, t_max,
                  active=None) -> HitRecord:
    """Each active lane's nearest proxy hit in [t_min, t_max) (the lowest
    slot, the largest triangle, on equal t): a HitRecord with t = t_max and
    tri_id = -1 where no proxy triangle is hit."""
    rays = _rays(ray_o, ray_d, t_min, t_max, active)
    dev = rays[0].device
    if dev.type == "cuda":
        return _launch_closest(proxy, rays)
    if dev.type == "cpu":
        return proxy_closest_plain(proxy, *rays)
    raise ValueError(f"no proxy_closest for device {dev}")


@spanned("traverse.proxy_seed")
def seeded_closest(closest_fn, proxy: DenseProxy, ray_o, ray_d, t_min,
                   t_max, active) -> HitRecord:
    """Proxy-seeded closest hit: closest_fn(o, d, t_min, t_max, active), a
    per-ray walk, runs with t_max = the proxy hit's t * SEED_SLACK where a
    proxy triangle is hit. The slack lets the walk find the proxy triangle
    itself (it is in the table), so found hits are the unseeded walk's;
    only where the walk still finds nothing (the two evaluations of one
    sliver disagreeing by more than 1e-5 relative) does the proxy hit
    stand."""
    rays = _rays(ray_o, ray_d, t_min, t_max, active)
    seed = proxy_closest(proxy, *rays)
    slack = torch.tensor(SEED_SLACK, device=seed.t.device)
    bound = torch.where(seed.tri_id >= 0, seed.t * slack, seed.t)
    rec = closest_fn(rays[0], rays[1], rays[2], bound, rays[4])
    hit = rec.tri_id >= 0
    return HitRecord(t=torch.where(hit, rec.t, seed.t),
                     tri_id=torch.where(hit, rec.tri_id, seed.tri_id),
                     u=torch.where(hit, rec.u, seed.u),
                     v=torch.where(hit, rec.v, seed.v))


@spanned("traverse.cut")
def cut_clear(cut: AABBCut, ray_o, ray_d, t_min, t_max, active=None):
    """(N,) bool: True where an active lane's segment overlaps none of the
    cut's boxes — a definitive miss; False leaves the lane to the walk."""
    return _route("cut_clear", cut.boxes, cut_clear_plain, cut, ray_o, ray_d,
                  t_min, t_max, active)


@spanned("traverse.screened")
def screened_any(any_fn, ray_o, ray_d, t_min, t_max, active,
                 proxy: DenseProxy | None = None, cut: AABBCut | None = None):
    """Any-hit visibility (N,) f32, 1 = unoccluded, with the screens in
    front of `any_fn(o, d, t_min, t_max, active)`: lanes the cut clears and
    lanes a proxy triangle blocks skip the walk. Equal to any_fn alone on
    every lane."""
    act = active
    if cut is not None:
        act = act & ~cut_clear(cut, ray_o, ray_d, t_min, t_max, act)
    if proxy is None:
        return any_fn(ray_o, ray_d, t_min, t_max, act)
    blocked = proxy_blocked(proxy, ray_o, ray_d, t_min, t_max, act)
    vis = any_fn(ray_o, ray_d, t_min, t_max, act & ~blocked)
    return torch.where(blocked, 0.0, vis)
