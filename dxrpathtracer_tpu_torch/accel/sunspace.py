"""Sun-space occlusion grid for sun shadow rays: the host builder, the CUDA
kernel's wrapper and its plain version.

The port of dxrpathtracer_tpu/accel/sunspace.py (SunGrid, sun_basis,
build_sun_grid, build_sun_grid_for_scene, sun_any_hit). The sun direction is
fixed until the next restart, so every sun shadow ray of a frame is a
translate of one ray: in a basis (ax, ay, w) with w the sun direction each
is vertical. The grid bins the triangles by their projected (ax, ay) boxes
into an S x S cell index whose entries head chains of 512 B records (12
world-space triangles in the leaf layout of accel/bvh.py, plus the next
record's code, the chain's suffix-zmax and the record's own zmax, records
sorted by zmax descending). A ray's cell is closed form; its walk ends at
the first blocking triangle, at the chain's end, or where no later triangle
can lie above it. The grid is a conservative index, and the triangle test
is the walk's own, so visibility equals traverse.any_hit on every lane.

`sun_any_hit` launches csrc/sungrid.cu (persistent warps, each walking its
own range of rays, a lane taking the range's next active ray when its ray
ends) for CUDA tensors and runs `sun_any_hit_plain` (the JAX package's
step, over the lanes still walking) for CPU tensors; it routes on the device
alone. Given an `AlphaTest` (traverse.py) it applies the alpha test inside
the walk, on each candidate before it ends the walk, as the JAX package's
`sun_any_hit(accept_fn=...)` does: the kernel's alpha instantiation on CUDA
tensors, the plain walk with the test as its accept_fn on CPU tensors. No
JAX caller passes an accept_fn and no route of the port passes an alpha
test (alpha-tested sun rays stay on the per-ray walk): it is there for the
API. The JAX module's TPU machinery (lane quarantine, compaction phases,
UNROLL) has no counterpart.
"""

import ctypes
import dataclasses
from pathlib import Path

import numpy as np
import torch

from ..app.profiler import spanned
from ..buildlib import build_shared_library, nvcc
from ..scene.types import TRI_SHADE_WIDTH
from .bvh import LEAF_SIZE, RECORD
from .traverse import NVCC_FLAGS, AlphaTest, moller_trumbore

KERNEL_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "sungrid.cu"
DONE = 0x7FFFFFFF           # index / next code: empty, chain end
_L = LEAF_SIZE
_NEXT_SLOT = 10 * _L        # i32 next code (~row), DONE at the chain's end
_SUFZ_SLOT = 10 * _L + 1    # f32 max sun depth of this record and its tail
_OWNZ_SLOT = 10 * _L + 2    # f32 max sun depth of this record alone

# Launches of the grid kernel since the process started (or since a caller
# last reset it), opaque and alpha-tested. Only `_launch_kernel` adds to
# them.
KERNEL_LAUNCHES = 0
ALPHA_KERNEL_LAUNCHES = 0


@dataclasses.dataclass(frozen=True)
class SunGrid:
    table: torch.Tensor   # (R, RECORD) f32 chain records (layout above)
    index: torch.Tensor   # (S*S,) i32 chain-head code per cell (y*S + x)
    params: torch.Tensor  # (4,) f32: gx0, gy0, inv_fx, inv_fy
    basis: torch.Tensor   # (3, 3) f32 rows: ax, ay, w (w = unit sun dir)
    num_rows: int = 0
    grid_size: int = 512

    def to(self, device) -> "SunGrid":
        return dataclasses.replace(
            self, table=self.table.to(device), index=self.index.to(device),
            params=self.params.to(device), basis=self.basis.to(device))


# ---------------------------------------------------------------------------
# The host builder (numpy; the JAX package's, line for line)
# ---------------------------------------------------------------------------

def sun_basis(sun_dir: np.ndarray) -> np.ndarray:
    """Orthonormal (ax, ay, w) with w = normalized sun_dir, f32."""
    f32 = np.float32
    w = np.asarray(sun_dir, f32)
    w = w / f32(np.linalg.norm(w))
    up = np.asarray([0.0, 0.0, 1.0] if abs(float(w[2])) < 0.9
                    else [1.0, 0.0, 0.0], f32)
    ax = np.cross(up, w).astype(f32)
    ax = ax / f32(np.linalg.norm(ax))
    ay = np.cross(w, ax).astype(f32)
    return np.stack([ax, ay, w]).astype(f32)


def build_sun_grid(v0, v1, v2, sun_dir, leaf_cap: int = 24, dup_max: int = 9,
                   grid_size: int = 512) -> SunGrid:
    """The grid (CPU tensors) over (T, 3) world-space triangle vertices.

    grid_size: finest cells per axis (a power of 8 splits evenly; the
               recursion splits 8x8 per level in index space).
    leaf_cap:  stop subdividing at this many triangles.
    dup_max:   a triangle overlapping more than this many child ranges of a
               node joins the node's resident chain, which every cell below
               the node reaches through its chain's tail, instead.
    Projected boxes and zmax are inflated by 1e-5 of the projected diagonal
    (+ 1e-6), and binning uses the query's own f32 expressions, so every
    triangle a vertical ray can hit is on the ray's chain."""
    f32 = np.float32
    v0 = np.asarray(v0, f32)
    v1 = np.asarray(v1, f32)
    v2 = np.asarray(v2, f32)
    T = v0.shape[0]
    if T == 0:
        raise ValueError("build_sun_grid: no triangles")
    S = int(grid_size)
    basis = sun_basis(sun_dir)
    ax, ay, w = basis

    px = np.stack([v0 @ ax, v1 @ ax, v2 @ ax])  # (3, T)
    py = np.stack([v0 @ ay, v1 @ ay, v2 @ ay])
    pz = np.stack([v0 @ w, v1 @ w, v2 @ w])
    lox, hix = px.min(axis=0), px.max(axis=0)
    loy, hiy = py.min(axis=0), py.max(axis=0)
    gx0, gx1 = f32(lox.min()), f32(hix.max())
    gy0, gy1 = f32(loy.min()), f32(hiy.max())
    diag = float(np.hypot(gx1 - gx0, gy1 - gy0))
    pad = f32(1e-5 * diag + 1e-6)
    lox = (lox - pad).astype(f32)
    hix = (hix + pad).astype(f32)
    loy = (loy - pad).astype(f32)
    hiy = (hiy + pad).astype(f32)
    zmax_t = (pz.max(axis=0) + pad).astype(f32)

    inv_fx = f32(S) / max(f32(gx1) - f32(gx0) + 2 * pad, f32(1e-9))
    inv_fy = f32(S) / max(f32(gy1) - f32(gy0) + 2 * pad, f32(1e-9))
    ox0 = f32(gx0 - pad)
    oy0 = f32(gy0 - pad)
    fcx0 = np.clip(np.floor((lox - ox0) * inv_fx), 0, S - 1).astype(np.int64)
    fcx1 = np.clip(np.floor((hix - ox0) * inv_fx), 0, S - 1).astype(np.int64)
    fcy0 = np.clip(np.floor((loy - oy0) * inv_fy), 0, S - 1).astype(np.int64)
    fcy1 = np.clip(np.floor((hiy - oy0) * inv_fy), 0, S - 1).astype(np.int64)

    e1 = v1 - v0
    e2 = v2 - v0

    # the records in emission order: each one's triangles and its
    # (next code, suffix-zmax, own zmax); the table is filled at the end
    row_tris = []
    row_links = []

    def emit_chain(idx, tail_code, tail_zmax):
        """Records for `idx` (sorted by zmax, descending), the last linked
        to `tail_code`. Returns (head code, head suffix-zmax)."""
        if idx.size == 0:
            return tail_code, tail_zmax
        idx = idx[np.argsort(-zmax_t[idx], kind="stable")]
        own_zmax = np.maximum.reduceat(zmax_t[idx], np.arange(0, idx.size, _L))
        nxt, sufz = tail_code, tail_zmax
        for ci in range(own_zmax.size - 1, -1, -1):
            own = own_zmax[ci]
            sufz = max(sufz, own)
            row_tris.append(idx[ci * _L:(ci + 1) * _L])
            row_links.append((nxt, sufz, own))
            nxt = np.int32(~np.int32(len(row_tris) - 1))
        return nxt, sufz

    index = np.full(S * S, DONE, np.int32)
    NEG_INF = f32(-3e38)

    def fill(ix0, ix1, iy0, iy1, code):
        for yy in range(iy0, iy1):
            index[yy * S + ix0:yy * S + ix1] = code

    def build_node(idx, ix0, ix1, iy0, iy1, suffix_code, suffix_zmax):
        span = ix1 - ix0
        if idx.size <= leaf_cap or span < 8:
            # one chain for the whole range (a span under 8 has no 8x8 split)
            code, _ = emit_chain(idx, suffix_code, suffix_zmax)
            fill(ix0, ix1, iy0, iy1, code)
            return
        step = span // 8
        # child ranges per triangle; child 7 takes the remainder of a span
        # not divisible by 8
        cx0 = np.clip((fcx0[idx] - ix0) // step, 0, 7)
        cx1 = np.clip((fcx1[idx] - ix0) // step, 0, 7)
        cy0 = np.clip((fcy0[idx] - iy0) // step, 0, 7)
        cy1 = np.clip((fcy1[idx] - iy0) // step, 0, 7)
        nspan = (cx1 - cx0 + 1) * (cy1 - cy0 + 1)
        resident = nspan > dup_max
        res_code, res_zmax = emit_chain(idx[resident], suffix_code,
                                        suffix_zmax)
        small = idx[~resident]
        scx0, scx1 = cx0[~resident], cx1[~resident]
        scy0, scy1 = cy0[~resident], cy1[~resident]
        for cy in range(8):
            ym = (scy0 <= cy) & (cy <= scy1)
            jy0 = iy0 + cy * step
            jy1 = iy1 if cy == 7 else jy0 + step
            for cx in range(8):
                m = ym & (scx0 <= cx) & (cx <= scx1)
                jx0 = ix0 + cx * step
                jx1 = ix1 if cx == 7 else jx0 + step
                if not m.any():
                    fill(jx0, jx1, jy0, jy1, res_code)
                    continue
                build_node(small[m], jx0, jx1, jy0, jy1,
                           res_code, res_zmax)

    build_node(np.arange(T, dtype=np.int64), 0, S, 0, S, DONE, NEG_INF)
    rows = max(len(row_tris), 1)
    tri_of = np.full((rows, _L), -1, np.int64)  # -1: an empty slot
    for r, chunk in enumerate(row_tris):
        tri_of[r, :chunk.size] = chunk
    filled = tri_of >= 0
    pick = np.where(filled, tri_of, 0)
    table = np.zeros((rows, RECORD), f32)
    for f, col in enumerate((v0[:, 0], v0[:, 1], v0[:, 2], e1[:, 0], e1[:, 1],
                             e1[:, 2], e2[:, 0], e2[:, 1], e2[:, 2])):
        table[:, f * _L:(f + 1) * _L] = np.where(filled, col[pick], f32(0))
    table[:, 9 * _L:10 * _L] = tri_of.astype(np.int32).view(f32)
    if row_links:
        links = np.asarray(row_links, dtype=object)
        table[:len(row_links), _NEXT_SLOT] = np.asarray(
            links[:, 0], np.int32).view(f32)
        table[:len(row_links), _SUFZ_SLOT] = np.asarray(links[:, 1], f32)
        table[:len(row_links), _OWNZ_SLOT] = np.asarray(links[:, 2], f32)
    params = np.asarray([ox0, oy0, inv_fx, inv_fy], f32)
    return SunGrid(table=torch.from_numpy(table),
                   index=torch.from_numpy(index),
                   params=torch.from_numpy(params),
                   basis=torch.from_numpy(np.ascontiguousarray(basis)),
                   num_rows=int(table.shape[0]), grid_size=S)


def build_sun_grid_for_scene(scene, sun_dir, **kw) -> SunGrid:
    """The grid (CPU tensors) over a Scene's triangles (read on the host)."""
    pos = scene.positions.cpu().numpy()
    tri = scene.tri_idx.cpu().numpy()
    return build_sun_grid(pos[tri[:, 0]], pos[tri[:, 1]], pos[tri[:, 2]],
                          sun_dir, **kw)


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

_kernel = None
BUILD_LOG = ""  # nvcc's -Xptxas -v report of the loaded library's build


def kernel_library():
    """csrc/sungrid.cu compiled for sm_90a, built at first use."""
    global _kernel, BUILD_LOG
    if _kernel is None:
        path, BUILD_LOG = build_shared_library(
            KERNEL_SOURCE, "sungrid", [nvcc(), *NVCC_FLAGS])
        lib = ctypes.CDLL(str(path))
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.dxrpt_sun_any_hit.restype = ctypes.c_int
        lib.dxrpt_sun_any_hit.argtypes = [p, p, p, p, i32, i32,
                                          p, p, p, p, p, i64, p, p]
        lib.dxrpt_sun_any_hit_alpha.restype = ctypes.c_int
        lib.dxrpt_sun_any_hit_alpha.argtypes = [p, p, p, p, i32, i32, p, p,
                                                p, p, p, p, p, i64, p, p]
        for name in ("dxrpt_sungrid_resident_warps",
                     "dxrpt_sungrid_alpha_resident_warps"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = []
        _kernel = lib
    return _kernel


def resident_warps(alpha: bool = False) -> int:
    """Warps of the grid kernel (opaque, or the alpha-tested one) that one
    SM of the current CUDA device holds at once (its persistent launch is
    this times the SM count)."""
    lib = kernel_library()
    warps = (lib.dxrpt_sungrid_alpha_resident_warps() if alpha
             else lib.dxrpt_sungrid_resident_warps())
    if warps <= 0:
        raise RuntimeError(f"sun grid kernel occupancy query failed: CUDA "
                           f"error {-warps}")
    return warps


def _launch_kernel(grid: SunGrid, ray_o, ray_d, t_min, t_max, active,
                   alpha: AlphaTest | None = None):
    """One launch over all rays on the current stream; does not
    synchronise. With `alpha`, the alpha-tested instantiation."""
    global KERNEL_LAUNCHES, ALPHA_KERNEL_LAUNCHES
    n, dev = ray_o.shape[0], ray_o.device
    s = grid.grid_size
    checks = [("grid.table", grid.table, (grid.num_rows, RECORD),
               torch.float32),
              ("grid.index", grid.index, (s * s,), torch.int32),
              ("grid.params", grid.params, (4,), torch.float32),
              ("grid.basis", grid.basis, (3, 3), torch.float32)]
    if alpha is not None:
        checks += [("alpha.tri_shade", alpha.tri_shade,
                    (alpha.tri_shade.shape[0], TRI_SHADE_WIDTH),
                    torch.float32),
                   ("alpha.texels", alpha.texels,
                    (alpha.texels.shape[0], 4), torch.float32)]
    for name, x, shape, dtype in checks:
        if (tuple(x.shape) != shape or x.dtype != dtype or x.device != dev
                or not x.is_contiguous()):
            raise ValueError(f"{name}: want contiguous {dtype} {shape} on "
                             f"{dev}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    head = (grid.table.data_ptr(), grid.index.data_ptr(),
            grid.params.data_ptr(), grid.basis.data_ptr(), s,
            grid.num_rows + 8)
    tail = (ray_o.data_ptr(), ray_d.data_ptr(), t_min.data_ptr(),
            t_max.data_ptr(), active.data_ptr(), n, out.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib = kernel_library()
        if alpha is None:
            rc = lib.dxrpt_sun_any_hit(*head, *tail, stream)
            KERNEL_LAUNCHES += 1
        else:
            rc = lib.dxrpt_sun_any_hit_alpha(
                *head, alpha.tri_shade.data_ptr(), alpha.texels.data_ptr(),
                *tail, stream)
            ALPHA_KERNEL_LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"sun grid kernel launch failed: CUDA error {rc}")
    return out


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def _record_blocks(rec, o, d, t_min, t_max, accept_fn=None):
    """(m, 12) bool: which of each record's 12 triangles block its ray
    within [t_min, t_max) — JAX `_intersect_leaf`'s test, expression for
    expression, and `& accept_fn(tid, u, v)` with an accept_fn."""
    L = _L
    v0x, v0y, v0z = rec[:, 0:L], rec[:, L:2 * L], rec[:, 2 * L:3 * L]
    e1x, e1y, e1z = rec[:, 3 * L:4 * L], rec[:, 4 * L:5 * L], rec[:, 5 * L:6 * L]
    e2x, e2y, e2z = rec[:, 6 * L:7 * L], rec[:, 7 * L:8 * L], rec[:, 8 * L:9 * L]
    tid = rec[:, 9 * L:10 * L].view(torch.int32)
    det_ok, u, v, t = moller_trumbore(
        [o[:, c:c + 1] for c in range(3)], [d[:, c:c + 1] for c in range(3)],
        (v0x, v0y, v0z), (e1x, e1y, e1z), (e2x, e2y, e2z))
    ok = ((tid >= 0) & det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t >= t_min[:, None]) & (t < t_max[:, None]))
    if accept_fn is not None:
        # ok & accept_fn(tid, u, v), the test taken at the candidates only
        cand = ok.nonzero(as_tuple=True)
        ok = ok.index_put(cand, accept_fn(tid[cand], u[cand], v[cand]))
    return ok


def sun_any_hit_plain(grid: SunGrid, ray_o, ray_d, t_min, t_max, active,
                      stats: dict | None = None, accept_fn=None):
    """The JAX package's walk: each step reads every walking lane's record,
    abandons the chain where its suffix-zmax is below the lane's threshold,
    tests the record where its own zmax is not, and moves on; a blocked lane
    stops. accept_fn(tid, u, v) -> bool, any callable (an AlphaTest, or a
    test's own), takes part in each record's test as in the JAX package's
    leaf test: a triangle blocks only where it accepts. Returns (N,) f32
    visibility. With `stats`, adds the record visits
    ("visits"), the records tested ("tested"), the filled triangles tested
    up to the first blocking one ("tri_tests"), the rows touched
    ("touched", a (rows,) bool mask), each lane's record visits
    ("lane_steps", (N,) int64) and the distinct (32-lane warp, step, record)
    triples of the visits ("warp_records") to it."""
    n, dev = ray_o.shape[0], ray_o.device
    S = grid.grid_size
    b, p = grid.basis, grid.params
    ox, oy, oz = ray_o[:, 0], ray_o[:, 1], ray_o[:, 2]
    px = ox * b[0, 0] + oy * b[0, 1] + oz * b[0, 2]
    py = ox * b[1, 0] + oy * b[1, 1] + oz * b[1, 2]
    thr = (ox * b[2, 0] + oy * b[2, 1] + oz * b[2, 2]) + t_min

    def cell(q, g0, inv):
        f = torch.clamp(torch.floor((q - g0) * inv), 0, S - 1)
        return torch.nan_to_num(f, nan=0.0).to(torch.int64)

    flat = torch.clamp(cell(py, p[1], p[3]) * S + cell(px, p[0], p[2]),
                       0, S * S - 1)
    head = grid.index[flat]
    blocked = torch.zeros(n, dtype=torch.bool, device=dev)
    lanes = (active & (head != DONE)).nonzero()[:, 0]
    cur = head[lanes]
    if stats is not None:
        stats.setdefault("touched", torch.zeros(grid.num_rows,
                                                dtype=torch.bool, device=dev))
        stats.setdefault("lane_steps", torch.zeros(n, dtype=torch.int64,
                                                   device=dev))
        for k in ("visits", "tested", "tri_tests", "warp_records"):
            stats.setdefault(k, 0)
    it = 0
    while lanes.numel() and it < grid.num_rows + 8:
        row = (~cur).long()
        rec = grid.table[row]
        walk_on = ~(rec[:, _SUFZ_SLOT] < thr[lanes])  # NaN walks on
        test = walk_on & (rec[:, _OWNZ_SLOT] >= thr[lanes])
        hit = torch.zeros_like(test)
        sel = test.nonzero()[:, 0]
        ok = torch.zeros((0, _L), dtype=torch.bool, device=dev)
        if sel.numel():
            ln = lanes[sel]
            ok = _record_blocks(rec[sel], ray_o[ln], ray_d[ln], t_min[ln],
                                t_max[ln], accept_fn)
            hit[sel] = ok.any(dim=1)
        if stats is not None:
            filled = rec[sel, 9 * _L:10 * _L].view(torch.int32) >= 0
            # the kernel's slots up to its first blocking triangle
            upto = torch.cumsum(ok.int(), dim=1) - ok.int() == 0
            stats["visits"] += int(row.numel())
            stats["tested"] += int(sel.numel())
            stats["tri_tests"] += int((filled & upto).sum())
            stats["touched"][row] = True
            stats["lane_steps"][lanes] += 1
            stats["warp_records"] += int(torch.unique(
                lanes // 32 * grid.num_rows + row).numel())
        blocked[lanes[hit]] = True
        nxt = rec[:, _NEXT_SLOT].view(torch.int32)
        keep = walk_on & ~hit & (nxt != DONE)
        lanes, cur = lanes[keep], nxt[keep]
        it += 1
    return torch.where(blocked, 0.0, 1.0)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

@spanned("traverse.sun_grid")
def sun_any_hit(grid: SunGrid, ray_o, ray_d, t_min, t_max, active=None,
                alpha=None):
    """Sun shadow visibility (N,) f32 in {0, 1}, 1 = unoccluded. ray_d must
    be the sun direction the grid was built for (broadcast): the triangle
    test runs in world space with these very components, so the result
    equals traverse.any_hit's on the same rays (with the same alpha test).
    alpha: None (every triangle opaque), an AlphaTest (the kernel's alpha
    instantiation on CUDA tensors), or on CPU tensors any accept_fn(tid, u,
    v) callable; another callable on CUDA tensors raises."""
    n, dev = ray_o.shape[0], ray_o.device
    f32 = torch.float32
    ray_o = ray_o.to(f32).contiguous()
    ray_d = ray_d.to(f32).contiguous()
    t_min = torch.as_tensor(t_min, dtype=f32, device=dev).expand(n).contiguous()
    t_max = torch.as_tensor(t_max, dtype=f32, device=dev).expand(n).contiguous()
    active = (torch.ones(n, dtype=torch.bool, device=dev) if active is None
              else active.contiguous())
    if dev.type == "cuda":
        if alpha is not None and not isinstance(alpha, AlphaTest):
            raise TypeError(f"the grid kernel's alpha test is an AlphaTest, "
                            f"not {type(alpha).__name__}")
        return _launch_kernel(grid, ray_o, ray_d, t_min, t_max, active,
                              alpha)
    if dev.type == "cpu":
        return sun_any_hit_plain(grid, ray_o, ray_d, t_min, t_max, active,
                                 accept_fn=alpha)
    raise ValueError(f"no sun grid walk for device {dev}")
