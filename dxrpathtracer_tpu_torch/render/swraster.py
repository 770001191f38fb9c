"""Software-raster primaries: binned ray casting of the depth-1 camera rays,
an exact alternate of their closest-hit walk.

The port of dxrpathtracer_tpu/render/swraster.py. Camera rays are
structured: each passes through a known screen tile. So, once per camera
(on the host, numpy): project every triangle with the view-projection
matrix in f64, clip it at the near plane (camera rays start on it, so no
hit has clip-w below near), pad its screen box by half a pixel and list the
(tile, triangle) pairs it covers (`project_tri_bboxes`, `bin_pairs_host`,
copied as they are). Then per sample, every ray tests the triangles of its
tile with the walk's Moller-Trumbore and keeps the least t, the lowest
triangle id on equal t (`raster_closest_hit`).

Exactness: the binning is conservative (a triangle a ray can hit projects
into that ray's tile) and the test is the walk's, on the same (v0, e1, e2)
rows (accel/history.build_tri_table), so the winner is the walk's hit; only
where two triangles are hit at the same t may the raster pick the other
(the lower id; the walk takes the first it meets).

The device layout is the port's own (`build_raster_bins`): one CSR list per
tile, tile offsets and triangle ids in the tile-sorted order of
`bin_pairs_host`, with no depth cap and no padding. (The JAX package splits
each list into a 64-level dense table, a 256-level deep table and a
pair-major tail with a segmented scan, to give XLA fixed shapes.) Tile g
covers the packet tile of lanes [128 g, 128 g + 128) after
integrator._tile_order.

`raster_closest_hit` launches csrc/swraster.cu (a block of 128 threads per
tile, one per pixel) for CUDA tensors and runs `raster_closest_hit_plain`
(the pairs' tests in (pairs, 128) blocks, then a minimum per tile and
pixel) for CPU tensors; it routes on the device alone.
"""

import ctypes
import dataclasses
from pathlib import Path

import numpy as np
import torch

from ..accel.traverse import NVCC_FLAGS, HitRecord, moller_trumbore
from ..app.profiler import spanned
from ..buildlib import build_shared_library, nvcc

KERNEL_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "swraster.cu"

# Launches of the raster kernel since the process started (or since a
# caller last reset it). Only `_launch_kernel` adds to it.
KERNEL_LAUNCHES = 0

_BIG = 3e38
_ID_BIG = 2 ** 31 - 1
_PAIR_CHUNK = 1 << 12  # pairs per plain block: (chunk, 128) temporaries

_kernel = None
BUILD_LOG = ""  # nvcc's -Xptxas -v report of the loaded library's build


@dataclasses.dataclass(frozen=True)
class RasterBins:
    """The (tile, triangle) pairs of one camera as CSR lists: the triangles
    of tile g are tri_id[tile_start[g]:tile_start[g + 1]], in ascending
    triangle order; tri_table is build_tri_table's (T, 9) f32 rows."""

    tile_start: torch.Tensor  # (n_tiles + 1,) i32
    tri_id: torch.Tensor      # (P,) i32
    tri_table: torch.Tensor   # (T, 9) f32 v0, e1, e2
    ty: int = 8               # the packet tile's rows and columns
    tx: int = 16
    # True when only opaque triangles were binned (the split alpha route's
    # opaque-only step); such bins never answer a ray that must see
    # alpha-tested triangles as opaque
    opaque_only: bool = False

    @property
    def n_tiles(self) -> int:
        return self.tile_start.shape[0] - 1

    @property
    def pairs(self) -> int:
        return self.tri_id.shape[0]

    def to(self, device) -> "RasterBins":
        return dataclasses.replace(self, tile_start=self.tile_start.to(device),
                                   tri_id=self.tri_id.to(device),
                                   tri_table=self.tri_table.to(device))


# ---------------------------------------------------------------------------
# Host binning (numpy, once per camera)
# ---------------------------------------------------------------------------

def project_tri_bboxes(positions, tri_idx, view_proj, near, width,
                       total_height):
    """Host projection: conservative continuous-pixel boxes of every
    triangle (clipped at w = near, padded by 0.5 px) and whether it can be
    on screen. Returns (ok, pxmin, pxmax, pymin, pymax)."""
    f64 = np.float64
    v = positions[tri_idx]                      # (T, 3, 3)
    vp = np.asarray(view_proj, f64)
    hom = v.astype(f64) @ vp[:3, :] + vp[3, :]  # (T, 3, 4) row-vector
    w = hom[..., 3]

    # Candidate projected points: vertices with w >= near + near-plane edge
    # crossings (6 masked slots). Clipping at w = near is exact, not
    # heuristic: primary rays start on the near plane, so no hit can have
    # clip-w below it.
    T = len(v)
    pts_x = np.zeros((T, 6), f64)
    pts_y = np.zeros((T, 6), f64)
    valid = np.zeros((T, 6), bool)
    for i in range(3):
        j = (i + 1) % 3
        wi, wj = w[:, i], w[:, j]
        ok = wi >= near
        safe_w = np.maximum(wi, near)
        valid[:, 2 * i] = ok
        pts_x[:, 2 * i] = np.where(ok, hom[:, i, 0] / safe_w, 0.0)
        pts_y[:, 2 * i] = np.where(ok, hom[:, i, 1] / safe_w, 0.0)
        cross = ok != (wj >= near)
        denom = np.where(wi == wj, 1.0, wi - wj)
        tpar = np.where(cross, (wi - near) / denom, 0.0)
        cx = hom[:, i, 0] + (hom[:, j, 0] - hom[:, i, 0]) * tpar
        cy = hom[:, i, 1] + (hom[:, j, 1] - hom[:, i, 1]) * tpar
        valid[:, 2 * i + 1] = cross
        pts_x[:, 2 * i + 1] = np.where(cross, cx / near, 0.0)
        pts_y[:, 2 * i + 1] = np.where(cross, cy / near, 0.0)

    big = 1e30
    xmin = np.where(valid, pts_x, big).min(1)
    xmax = np.where(valid, pts_x, -big).max(1)
    ymin = np.where(valid, pts_y, big).min(1)
    ymax = np.where(valid, pts_y, -big).max(1)

    # NDC -> continuous pixel/sample coords (raygen mapping with the FULL
    # image height: ncd_x = px/(W/2) - 1, ncd_y = -(py/(H/2) - 1)); +-0.5 px
    # conservative pad absorbs f64-projection-vs-f32-ray slack. Jitter needs
    # no extra pad: tiles partition continuous sample coordinates.
    pxmin = (xmin + 1.0) * width * 0.5 - 0.5
    pxmax = (xmax + 1.0) * width * 0.5 + 0.5
    pymin = (1.0 - ymax) * total_height * 0.5 - 0.5   # global rows
    pymax = (1.0 - ymin) * total_height * 0.5 + 0.5
    ok = valid.any(1) & (pxmax >= 0) & (pxmin < width)
    return ok, pxmin, pxmax, pymin, pymax


def bin_pairs_host(bboxes, width, slab_h, row0, ty, tx):
    """Conservative (tile, tri) pair emission for one row slab from the
    shared projection (project_tri_bboxes); host numpy.

    Returns (pair_tri, pair_tile, pair_first, seg_last) with pairs sorted by
    tile. Tile g covers pixels [gy*ty, gy*ty+ty) x [gx*tx, gx*tx+tx) of the
    SLAB-LOCAL image, g = gy * (width // tx) + gx — exactly the packet tile
    of lanes [g*ty*tx, (g+1)*ty*tx) after integrator._tile_order.
    """
    ok, pxmin, pxmax, pymin_g, pymax_g = bboxes
    pymin = pymin_g - row0   # slab-local
    pymax = pymax_g - row0
    T = len(pxmin)

    ntx = width // tx
    nty = slab_h // ty
    n_tiles = ntx * nty
    on = ok & (pymax >= 0) & (pymin < slab_h)
    with np.errstate(invalid="ignore"):
        cx0 = np.clip(np.floor(pxmin / tx), 0, ntx - 1).astype(np.int64)
        cx1 = np.clip(np.floor(pxmax / tx), 0, ntx - 1).astype(np.int64)
        cy0 = np.clip(np.floor(pymin / ty), 0, nty - 1).astype(np.int64)
        cy1 = np.clip(np.floor(pymax / ty), 0, nty - 1).astype(np.int64)
    nx = np.where(on, cx1 - cx0 + 1, 0)
    nyc = np.where(on, cy1 - cy0 + 1, 0)
    counts = nx * nyc
    offsets = np.concatenate([[0], np.cumsum(counts)])
    P = int(offsets[-1])

    # vectorized expansion: pair p of triangle i has k = p - offsets[i]
    tri_of = np.repeat(np.arange(T, dtype=np.int64), counts)
    k = np.arange(P, dtype=np.int64) - np.repeat(offsets[:-1], counts)
    nx_of = nx[tri_of]
    gy = cy0[tri_of] + k // nx_of
    gx = cx0[tri_of] + k % nx_of
    tile = gy * ntx + gx

    order = np.argsort(tile, kind="stable")
    tile_s = tile[order]
    tri_s = tri_of[order]
    first = np.ones(P, bool)
    if P > 1:
        first[1:] = tile_s[1:] != tile_s[:-1]
    seg_last = np.full(n_tiles, -1, np.int64)
    if P:
        starts = np.flatnonzero(first)
        ends = np.concatenate([starts[1:] - 1, [P - 1]])
        seg_last[tile_s[starts]] = ends
    return (tri_s.astype(np.int32), tile_s.astype(np.int32), first,
            seg_last.astype(np.int32))


def build_raster_bins(positions, tri_idx, view_proj, near, width, height,
                      ty, tx, tri_table, opaque_tris=None, row0: int = 0,
                      rows=None) -> RasterBins:
    """The CSR bins of a width x height frame in (ty, tx) tiles (CPU
    tensors) for the camera `view_proj` (4x4, row-vector convention) with
    near plane `near`; `tri_table` is build_tri_table's rows, numpy or a
    tensor (kept as given). opaque_tris ((T,) bool) bins only the
    triangles it marks, as the JAX session masks the projected boxes for
    the split alpha route; the bins are then opaque_only. With `rows`, the
    bins of the row block [row0, row0 + rows) alone (a row shard of
    parallel/mesh.py, its tiles in its own lane order); the projection
    spans the whole frame either way."""
    positions = np.asarray(positions)
    tri_idx = np.asarray(tri_idx)
    rows = height if rows is None else int(rows)
    bboxes = project_tri_bboxes(positions, tri_idx, view_proj, near, width,
                                height)
    if opaque_tris is not None:
        ok, *rest = bboxes
        bboxes = (ok & np.asarray(opaque_tris, bool), *rest)
    tri_s, tile_s, _, _ = bin_pairs_host(bboxes, width, rows, int(row0), ty,
                                         tx)
    n_tiles = (width // tx) * (rows // ty)
    if len(tri_s) >= 2 ** 31:
        raise ValueError(f"{len(tri_s)} raster pairs exceed int32")
    start = np.zeros(n_tiles + 1, np.int64)
    np.cumsum(np.bincount(tile_s, minlength=n_tiles), out=start[1:])
    if not isinstance(tri_table, torch.Tensor):
        tri_table = torch.from_numpy(np.ascontiguousarray(tri_table,
                                                          np.float32))
    return RasterBins(tile_start=torch.from_numpy(start.astype(np.int32)),
                      tri_id=torch.from_numpy(tri_s), tri_table=tri_table,
                      ty=int(ty), tx=int(tx),
                      opaque_only=opaque_tris is not None)


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

def kernel_library():
    """csrc/swraster.cu compiled for sm_90a, built at first use."""
    global _kernel, BUILD_LOG
    if _kernel is None:
        path, BUILD_LOG = build_shared_library(
            KERNEL_SOURCE, "swraster", [nvcc(), *NVCC_FLAGS])
        lib = ctypes.CDLL(str(path))
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.dxrpt_raster_closest_hit.restype = ctypes.c_int
        lib.dxrpt_raster_closest_hit.argtypes = [
            p, p, i64, p, i64,         # tile_start, tri_id, n_tiles, table, rows
            p, p, p, p, p,             # rays
            p, p, p, p,                # outputs
            p]                         # stream
        lib.dxrpt_raster_resident_warps.restype = ctypes.c_int
        lib.dxrpt_raster_resident_warps.argtypes = []
        _kernel = lib
    return _kernel


def resident_warps() -> int:
    """Warps of the raster kernel that one SM of the current CUDA device
    holds at once."""
    warps = kernel_library().dxrpt_raster_resident_warps()
    if warps <= 0:
        raise RuntimeError(f"raster kernel occupancy query failed: CUDA "
                           f"error {-warps}")
    return warps


def _lanes(bins: RasterBins, ray_o, ray_d, t_min, t_max, active):
    """The rays as the kernel takes them (contiguous f32 (n, 3) x 2,
    f32 (n,) x 2, bool (n,) on ray_o's device), checked against the
    bins."""
    n, dev = ray_o.shape[0], ray_o.device
    f32 = torch.float32
    k = bins.ty * bins.tx
    if n != bins.n_tiles * k:
        raise ValueError(f"raster_closest_hit: {n} lanes, the bins hold "
                         f"{bins.n_tiles} tiles of {k}")
    rays = (ray_o.to(f32).contiguous(), ray_d.to(f32).contiguous(),
            torch.as_tensor(t_min, dtype=f32, device=dev).expand(n).contiguous(),
            torch.as_tensor(t_max, dtype=f32, device=dev).expand(n).contiguous(),
            (torch.ones(n, dtype=torch.bool, device=dev) if active is None
             else active.contiguous()))
    for name, x, shape, dtype in zip(
            ("ray_o", "ray_d", "t_min", "t_max", "active"), rays,
            ((n, 3), (n, 3), (n,), (n,), (n,)),
            (f32, f32, f32, f32, torch.bool)):
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != dev:
            raise ValueError(f"{name}: want {dtype} {shape} on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    for name, x, dtype in (("tile_start", bins.tile_start, torch.int32),
                           ("tri_id", bins.tri_id, torch.int32),
                           ("tri_table", bins.tri_table, f32)):
        if x.dtype != dtype or x.device != dev or not x.is_contiguous():
            raise ValueError(f"bins.{name}: want contiguous {dtype} on {dev}, "
                             f"got {x.dtype} on {x.device}")
    return rays


def _launch_kernel(bins: RasterBins, ray_o, ray_d, t_min, t_max,
                   active) -> HitRecord:
    """One launch over every tile on the current stream; does not
    synchronise."""
    global KERNEL_LAUNCHES
    if bins.ty * bins.tx != 128:
        raise ValueError(f"the raster kernel takes 128-pixel tiles, got "
                         f"{bins.ty}x{bins.tx}")
    n, dev = ray_o.shape[0], ray_o.device
    out = HitRecord(t=torch.empty(n, dtype=torch.float32, device=dev),
                    tri_id=torch.empty(n, dtype=torch.int32, device=dev),
                    u=torch.empty(n, dtype=torch.float32, device=dev),
                    v=torch.empty(n, dtype=torch.float32, device=dev))
    if n == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = kernel_library().dxrpt_raster_closest_hit(
            bins.tile_start.data_ptr(), bins.tri_id.data_ptr(), bins.n_tiles,
            bins.tri_table.data_ptr(), bins.tri_table.shape[0],
            ray_o.data_ptr(), ray_d.data_ptr(), t_min.data_ptr(),
            t_max.data_ptr(), active.data_ptr(), out.t.data_ptr(),
            out.tri_id.data_ptr(), out.u.data_ptr(), out.v.data_ptr(),
            stream)
        KERNEL_LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"raster kernel launch failed: CUDA error {rc}")
    return out


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def _mt_rows(rows, o, d, tmin, tmax):
    """(t, u, v, ok) of triangle rows (m, 9) against rays broadcast to them:
    o, d xyz triples and tmin, tmax of a shape that broadcasts with
    (m, 1)."""
    det_ok, u, v, t = moller_trumbore(
        o, d, [rows[:, c:c + 1] for c in range(3)],
        [rows[:, c:c + 1] for c in range(3, 6)],
        [rows[:, c:c + 1] for c in range(6, 9)])
    ok = (det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t >= tmin) & (t < tmax))
    return t, u, v, ok


def raster_closest_hit_plain(bins: RasterBins, ray_o, ray_d, t_min, t_max,
                             active, stats: dict | None = None) -> HitRecord:
    """Every pair's triangle against its tile's K rays in (pairs, K) blocks,
    the least t per tile and pixel (scatter_reduce amin), the lowest
    triangle id at that t, then the winner re-tested against its ray for
    t, u and v (JAX raster_closest_hit's exact re-test). With `stats`, adds
    the tests the kernel makes ("tests": the active lanes of each pair's
    tile) and the pair count ("pairs") to it."""
    n, dev = ray_o.shape[0], ray_o.device
    k = bins.ty * bins.tx
    nt = bins.n_tiles
    blk = lambda x: x.reshape(nt, k)  # noqa: E731
    comps = [blk(ray_o[:, c]) for c in range(3)] + [
        blk(ray_d[:, c]) for c in range(3)] + [blk(t_min), blk(t_max)]
    act = blk(active)
    start = bins.tile_start.long()
    tile_of = torch.repeat_interleave(
        torch.arange(nt, device=dev), start[1:] - start[:-1])
    tris = bins.tri_id.long()
    best_t = torch.full((nt, k), _BIG, dtype=torch.float32, device=dev)
    best_id = torch.full((nt, k), _ID_BIG, dtype=torch.int32, device=dev)

    def tests(sl):
        g = tile_of[sl]
        c = [x[g] for x in comps]
        t, _, _, ok = _mt_rows(bins.tri_table[tris[sl]], c[0:3], c[3:6],
                               c[6], c[7])
        return g, t, ok & act[g]

    for i in range(0, tris.shape[0], _PAIR_CHUNK):
        g, t, ok = tests(slice(i, i + _PAIR_CHUNK))
        best_t.scatter_reduce_(0, g[:, None].expand(-1, k),
                               torch.where(ok, t, _BIG), "amin")
    for i in range(0, tris.shape[0], _PAIR_CHUNK):
        sl = slice(i, i + _PAIR_CHUNK)
        g, t, ok = tests(sl)
        at_best = ok & (t == best_t[g])
        ids = torch.where(at_best, bins.tri_id[sl, None], _ID_BIG)
        best_id.scatter_reduce_(0, g[:, None].expand(-1, k), ids, "amin")
    if stats is not None:
        per_tile = act.sum(dim=1)
        stats["tests"] = stats.get("tests", 0) + int(per_tile[tile_of].sum())
        stats["pairs"] = stats.get("pairs", 0) + int(tris.shape[0])

    tri_id = torch.where(best_t < _BIG, best_id, -1).reshape(n)
    hit = tri_id >= 0
    rows = bins.tri_table[torch.clamp_min(tri_id, 0).long()]
    rt, ru, rv, _ = _mt_rows(rows, [ray_o[:, c:c + 1] for c in range(3)],
                             [ray_d[:, c:c + 1] for c in range(3)],
                             t_min[:, None], t_max[:, None])
    return HitRecord(t=torch.where(hit, rt[:, 0], t_max),
                     tri_id=tri_id.to(torch.int32),
                     u=torch.where(hit, ru[:, 0], 0.0),
                     v=torch.where(hit, rv[:, 0], 0.0))


@spanned("traverse.raster")
def raster_closest_hit(bins: RasterBins, ray_o, ray_d, t_min, t_max,
                       active=None) -> HitRecord:
    """Closest hit of camera rays in packet-tile order (each 128
    consecutive lanes one tile of `bins`) through the binned pairs; misses
    keep t == t_max and tri_id == -1. The walk's hit up to the triangle of
    an equal-t tie (the lower id here)."""
    rays = _lanes(bins, ray_o, ray_d, t_min, t_max, active)
    dev = rays[0].device
    if dev.type == "cuda":
        return _launch_kernel(bins, *rays)
    if dev.type == "cpu":
        return raster_closest_hit_plain(bins, *rays)
    raise ValueError(f"no raster_closest_hit for device {dev}")
