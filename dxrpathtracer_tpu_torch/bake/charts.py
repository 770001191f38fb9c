"""Charted lightmap atlas — the xatlas-equivalent chart segmentation/packing.

A copy of dxrpathtracer_tpu/bake/charts.py (host numpy only), so that both
packages bake against the same atlas byte for byte.

The reference unwraps lightmap UVs with xatlas (Model.cpp:608-719,
Externals/xatlas) before baking; round 1/2 shipped an analytic per-triangle
pair packer (bake/lightmap_uv.py) whose uniform texel density covered only
~69% of the atlas and under-sampled large triangles. This module is the real
replacement:

  1. charts grow by BFS over edge-connected triangles whose normals stay
     within a cone of the seed normal (planar projection stays injective for
     near-planar surfaces; a per-chart area-vs-union check catches folds and
     demotes offending charts to per-triangle fallbacks),
  2. each chart is projected onto its seed plane, so chart UVs are in WORLD
     units — one global scale makes texel density proportional to world area
     by construction (fixing the pair packer's uniform-density flaw),
  3. every chart packs through one occupancy grid by bottom-left-fill
     against exact MULTI-SPAN per-column masks (biggest first, first-fit
     lowest-(y, x)), with the pack width iterated toward a square layout
     and a world-space gutter derived from the requested texel gutter.
     Multi-span masks claim only a chart's true dilated footprint — holes
     inside concave charts stay free and later charts nest into them
     (the single-span profile packer this replaces trapped ~13 coverage
     points of interior air on theInn — PERF_NOTES.md round 3).

The texel -> (triangle, barycentric) inverse map — which the analytic atlas
got in closed form — becomes a host-side rasterization over chart triangles
(the reference's SurfaceMap.hlsl:35-94 raster pass, done in numpy), followed
by N-ring dilation that copies edge texels into the gutter so bilinear
lightmap sampling never bleeds background into seams (Mesh.hlsl:155-162).
"""

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class ChartedAtlas:
    """Charted lightmap UV layout for T triangles."""

    num_tris: int
    tri_uv: np.ndarray      # (T, 3, 2) f32 atlas UVs per corner (v0, v1, v2)
    num_charts: int
    coverage: float         # fraction of atlas texels covered by triangles
    gutter_texels: float
    ref_resolution: int

    def triangle_uvs(self) -> np.ndarray:
        return self.tri_uv


def _weld_indices(positions: np.ndarray, tri_idx: np.ndarray,
                  tol: float = 1e-5):
    """Remap triangle indices so vertices at the same position share one id.
    FBX exports split vertices at every normal/UV seam, which would otherwise
    make every triangle its own connectivity island (xatlas welds the same
    way before charting)."""
    q = np.round(positions / tol).astype(np.int64)
    _, first = np.unique(q, axis=0, return_inverse=True)
    return first[tri_idx]


def _triangle_adjacency(positions: np.ndarray, tri_idx: np.ndarray):
    """(E, 2) pairs of triangles sharing a (position-welded) edge."""
    t = tri_idx.shape[0]
    tri_idx = _weld_indices(positions, tri_idx)
    edges = np.concatenate([tri_idx[:, [0, 1]], tri_idx[:, [1, 2]],
                            tri_idx[:, [2, 0]]], axis=0)
    edges = np.sort(edges, axis=1)
    owner = np.tile(np.arange(t, dtype=np.int64), 3)
    key = edges[:, 0].astype(np.int64) * (tri_idx.max() + 1) + edges[:, 1]
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    own_s = owner[order]
    same = key_s[1:] == key_s[:-1]
    return np.stack([own_s[:-1][same], own_s[1:][same]], axis=1)


def _grow_charts(positions, tri_idx, normals, areas, max_angle_deg=40.0,
                 max_chart_tris=4000):
    """Greedy BFS chart growth; returns (T,) chart id per triangle."""
    t = tri_idx.shape[0]
    pairs = _triangle_adjacency(positions, tri_idx)
    # CSR adjacency
    deg = np.zeros(t + 1, np.int64)
    np.add.at(deg, pairs[:, 0] + 1, 1)
    np.add.at(deg, pairs[:, 1] + 1, 1)
    ptr = np.cumsum(deg)
    # fill adjacency via one stable argsort over both edge directions
    src = np.concatenate([pairs[:, 0], pairs[:, 1]])
    dst = np.concatenate([pairs[:, 1], pairs[:, 0]])
    order = np.argsort(src, kind="stable")
    adj = dst[order]

    cos_max = math.cos(math.radians(max_angle_deg))
    chart = np.full(t, -1, np.int64)
    seed_order = np.argsort(-areas, kind="stable")
    next_chart = 0
    from collections import deque
    for seed in seed_order:
        if chart[seed] >= 0:
            continue
        cid = next_chart
        next_chart += 1
        n0 = normals[seed]
        chart[seed] = cid
        queue = deque([seed])
        size = 1
        while queue and size < max_chart_tris:
            cur = queue.popleft()
            for nb in adj[ptr[cur]:ptr[cur + 1]]:
                if chart[nb] >= 0:
                    continue
                if normals[nb] @ n0 >= cos_max:
                    chart[nb] = cid
                    queue.append(nb)
                    size += 1
                    if size >= max_chart_tris:
                        break
    return chart, next_chart


def _plane_basis(n):
    up = np.array([0.0, 0.0, 1.0]) if abs(n[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
    t1 = np.cross(up, n)
    t1 /= max(np.linalg.norm(t1), 1e-20)
    t2 = np.cross(n, t1)
    return t1, t2


def _chart_overlap_frac(uv2, res=64):
    """Folded-chart detector: how much of the chart's total triangle area
    exceeds its rasterized UNION area (a fold stacks area on top of itself,
    so sum(|tri area|) > union). Counting texels claimed by >= 2 triangles
    misfires on charts of SKINNY triangles, whose shared-edge texels
    dominate the rasterization (a connected ring of 8 thin triangles read
    as 15% 'overlap'); the area ratio only sees genuine double coverage.
    uv2: (C, 3, 2). Returns ~0 for fold-free charts."""
    lo = uv2.min(axis=(0, 1))
    hi = uv2.max(axis=(0, 1))
    ext = np.maximum(hi - lo, 1e-12)
    q = (uv2 - lo) / ext * (res - 1)
    covered = np.zeros((res, res), bool)
    for tri in q:
        bb_lo = np.floor(tri.min(axis=0)).astype(int)
        bb_hi = np.ceil(tri.max(axis=0)).astype(int) + 1
        xs = np.arange(bb_lo[0], min(bb_hi[0], res))
        ys = np.arange(bb_lo[1], min(bb_hi[1], res))
        if xs.size == 0 or ys.size == 0:
            continue
        px, py = np.meshgrid(xs + 0.5, ys + 0.5, indexing="ij")
        d = np.stack([px, py], -1) - tri[0]
        e1 = tri[1] - tri[0]
        e2 = tri[2] - tri[0]
        det = e1[0] * e2[1] - e1[1] * e2[0]
        if abs(det) < 1e-12:
            continue
        u = (d[..., 0] * e2[1] - d[..., 1] * e2[0]) / det
        v = (e1[0] * d[..., 1] - e1[1] * d[..., 0]) / det
        inside = (u >= -1e-6) & (v >= -1e-6) & (u + v <= 1.0 + 1e-6)
        covered[bb_lo[0]:bb_lo[0] + xs.size,
                bb_lo[1]:bb_lo[1] + ys.size] |= inside
    e1 = q[:, 1] - q[:, 0]
    e2 = q[:, 2] - q[:, 0]
    area_sum = 0.5 * np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]).sum()
    # the inclusive raster OVERestimates the union by ~a one-texel perimeter
    # band, biasing away from false fold reports on skinny charts
    union = max(float(covered.sum()), 1.0)
    return max(area_sum / union - 1.0, 0.0)


def _min_bbox_area(pts, _angles=np.linspace(0.0, math.pi / 2.0, 16,
                                            endpoint=False)):
    """Minimal-area bounding-box area of a 2D point set over 16 rotations
    (the same candidate set the packer's per-chart rotation step uses)."""
    cs, sn = np.cos(_angles), np.sin(_angles)
    xr = pts[:, 0:1] * cs[None, :] - pts[:, 1:2] * sn[None, :]
    yr = pts[:, 0:1] * sn[None, :] + pts[:, 1:2] * cs[None, :]
    w = xr.max(axis=0) - xr.min(axis=0)
    h = yr.max(axis=0) - yr.min(axis=0)
    return float((w * h).min())


def _merge_charts(positions, tri_idx, chart_of, chart_uv, n_charts,
                  gutter_world, max_chart_tris=4000, overlap_tol=0.02,
                  rounds=8, bbox_tol=1.0):
    """Hinge-unfold chart merging — the LSCM-class defragmentation pass.

    Hard-edged meshes fragment the cone-limited BFS growth into thousands of
    2-4 triangle charts (theInn: 2956 charts for 19k tris), and per-chart
    gutters + bbox slack then bound atlas coverage (~0.83 — PERF_NOTES.md).
    Two charts meeting at a fold line can be joined EXACTLY by unfolding one
    into the other's plane: in chart-UV space that is a rigid 2D transform
    mapping B's image of the shared (welded) vertices onto A's. This is the
    analytic special case of LSCM that architectural geometry is made of;
    chains of merges unroll cylinders/arches one hinge at a time.

    A merge commits only if
      - every shared welded vertex lands within 0.5 gutter of its image in
        A (sub-texel internal seams: bilinear taps across the fold then mix
        GEOMETRIC neighbors, which is seamless, and any sub-texel gap is
        healed by the rasterizer's dilation), and
      - the union passes the fold detector (no stacked area), so B cannot
        swing back over A, and
      - the union's min-area bbox is no larger than the parts' bboxes
        combined (bbox_tol): unguarded chain unfolds SPRAWL — arcs unroll
        into crescents, stair chains into diagonals — and measured 10
        coverage points WORSE on theInn (bbox fill 0.74 -> 0.55) because
        the sprawl traps pocket air while consuming the small charts that
        used to fill pockets. The guard keeps exactly the merges that pay:
        near-coplanar plates joining into larger rectangles.

    Mutates chart_of / chart_uv in place; returns the new chart id bound
    (stale ids keep no triangles)."""
    wtri = _weld_indices(positions, tri_idx)                   # (T, 3)
    # cross-chart shared edges -> per chart-pair shared welded vertices
    edges = np.concatenate([wtri[:, [0, 1]], wtri[:, [1, 2]],
                            wtri[:, [2, 0]]], axis=0)
    edges = np.sort(edges, axis=1)
    owner = np.tile(np.arange(tri_idx.shape[0], dtype=np.int64), 3)
    key = edges[:, 0] * (wtri.max() + 1) + edges[:, 1]
    order = np.argsort(key, kind="stable")
    same = key[order][1:] == key[order][:-1]
    ta, tb = owner[order][:-1][same], owner[order][1:][same]
    ea = edges[order][:-1][same]                               # (E, 2) welded

    for _ in range(rounds):
        ca, cb = chart_of[ta], chart_of[tb]
        cross = ca != cb
        if not cross.any():
            break
        lo_c = np.minimum(ca[cross], cb[cross])
        hi_c = np.maximum(ca[cross], cb[cross])
        ev = ea[cross]
        # boundary edge count per chart pair (merge priority: longest seam)
        pair_key = lo_c * (n_charts + 1) + hi_c
        # group cross edges by pair
        p_order = np.argsort(pair_key, kind="stable")
        pk_s = pair_key[p_order]
        starts = np.nonzero(np.r_[True, pk_s[1:] != pk_s[:-1]])[0]
        counts = np.diff(np.r_[starts, pk_s.size])

        # chart triangle lists + total areas (for merge ordering)
        g_order = np.argsort(chart_of, kind="stable")
        bounds = np.searchsorted(chart_of[g_order], np.arange(n_charts + 1))
        tri_count = np.diff(bounds)

        # candidate merges, longest shared seam first
        cand = np.argsort(-counts, kind="stable")
        merged_into = np.arange(n_charts, dtype=np.int64)
        touched = np.zeros(n_charts, bool)
        n_merged = 0
        for qi in cand:
            s0 = starts[qi]
            a = int(pk_s[s0] // (n_charts + 1))
            b = int(pk_s[s0] % (n_charts + 1))
            if touched[a] or touched[b]:
                continue  # one hinge per chart per round (UVs move)
            if tri_count[a] + tri_count[b] > max_chart_tris:
                continue
            shared_w = np.unique(ev[p_order[s0:s0 + counts[qi]]])
            if shared_w.size < 2:
                continue
            sel_a = g_order[bounds[a]:bounds[a + 1]]
            sel_b = g_order[bounds[b]:bounds[b + 1]]
            # UV of each shared welded vertex in both charts (first corner)
            uva = np.zeros((shared_w.size, 2))
            uvb = np.zeros((shared_w.size, 2))
            okw = True
            for si, w in enumerate(shared_w):
                ia = np.nonzero(wtri[sel_a] == w)
                ib = np.nonzero(wtri[sel_b] == w)
                if ia[0].size == 0 or ib[0].size == 0:
                    okw = False
                    break
                uva[si] = chart_uv[sel_a[ia[0][0]], ia[1][0]]
                uvb[si] = chart_uv[sel_b[ib[0][0]], ib[1][0]]
            if not okw:
                continue
            # anchors: the two farthest-apart shared vertices in A's UV
            d2 = ((uva[:, None, :] - uva[None, :, :]) ** 2).sum(-1)
            i0, i1 = np.unravel_index(int(np.argmax(d2)), d2.shape)
            av = uva[i1] - uva[i0]
            la = float(np.hypot(*av))
            bv = uvb[i1] - uvb[i0]
            lb = float(np.hypot(*bv))
            if la < 1e-9 or lb < 1e-9:
                continue
            anchor_b = uvb[i0].copy()
            committed = False
            for mirror in (False, True):
                ub = uvb.copy()
                buv = chart_uv[sel_b].reshape(-1, 2).copy()
                if mirror:
                    # reflect B across its anchor line (both anchors lie ON
                    # the line, so they — and the rotation below — are
                    # unchanged; only off-line vertices flip sides)
                    u = bv / lb
                    m00 = 2 * u[0] * u[0] - 1
                    m01 = 2 * u[0] * u[1]
                    m11 = 2 * u[1] * u[1] - 1
                    for arr in (ub, buv):
                        rel = arr - anchor_b
                        arr[:] = anchor_b + np.stack(
                            [rel[:, 0] * m00 + rel[:, 1] * m01,
                             rel[:, 0] * m01 + rel[:, 1] * m11], axis=-1)
                cs = (bv @ av) / (lb * la)
                sn = (bv[0] * av[1] - bv[1] * av[0]) / (lb * la)
                for arr in (ub, buv):
                    rel = arr - anchor_b
                    arr[:] = uva[i0] + np.stack(
                        [rel[:, 0] * cs - rel[:, 1] * sn,
                         rel[:, 0] * sn + rel[:, 1] * cs], axis=-1)
                # all shared vertices must land sub-texel close
                res = np.abs(ub - uva).max() if shared_w.size else 0.0
                if res > 0.5 * gutter_world:
                    continue
                union_uv = np.concatenate(
                    [chart_uv[sel_a], buv.reshape(-1, 3, 2)], axis=0)
                if _chart_overlap_frac(union_uv) > overlap_tol:
                    continue
                pts_a = chart_uv[sel_a].reshape(-1, 2)
                ba = _min_bbox_area(pts_a)
                bb = _min_bbox_area(buv)
                bu_area = _min_bbox_area(union_uv.reshape(-1, 2))
                if bu_area > bbox_tol * (ba + bb):
                    continue
                chart_uv[sel_b] = buv.reshape(-1, 3, 2)
                chart_of[sel_b] = a
                merged_into[b] = a
                touched[a] = touched[b] = True
                tri_count[a] += tri_count[b]
                tri_count[b] = 0
                n_merged += 1
                committed = True
                break
            if not committed:
                continue
        if n_merged == 0:
            break
    return n_charts


def _chart_spans(uvs, w_cols, cell, pad, rows):
    """Exact MULTI-SPAN per-column occupancy of a chart's triangles.

    The single [bottom, top] envelope this replaces claimed every interior
    hole of a concave chart (an L, a ring, a wall with a doorway), trapping
    ~13 coverage points of air on theInn (PERF_NOTES.md round 3). Here each
    TRIANGLE contributes its own exact per-column y-interval (vertices in
    the strip + edge/boundary crossings — same machinery as the old
    profiles, tagged by owning triangle), the intervals are unioned per
    column, padded by the gutter on every side, and quantized outward — so
    a chart's claim is its true dilated footprint and later (smaller)
    charts can nest into its real holes.

    uvs: (C, 3, 2) chart-local, shifted so the padded chart starts at 0.
    Returns (cols (S,) i64, lo (S,) i64, hi (S,) i64) cell spans,
    lo inclusive / hi exclusive, clipped to [0, rows]."""
    c_tris = uvs.shape[0]
    # edges (3C, 2 endpoints, 2 xy) tagged by owning triangle; the first
    # endpoints px cover all three vertices of every triangle
    e = np.concatenate([uvs[:, [0, 1]], uvs[:, [1, 2]], uvs[:, [2, 0]]],
                       axis=0)
    own = np.tile(np.arange(c_tris, dtype=np.int64), 3)
    px, py = e[:, 0, 0], e[:, 0, 1]
    qx, qy = e[:, 1, 0], e[:, 1, 1]

    lo_arr = np.full(c_tris * w_cols, np.inf)
    hi_arr = np.full(c_tris * w_cols, -np.inf)

    def add(cols, tris, ys):
        keys = tris * w_cols + np.clip(cols, 0, w_cols - 1)
        np.minimum.at(lo_arr, keys, ys)
        np.maximum.at(hi_arr, keys, ys)

    # vertex contributions: each vertex lands in its own column
    add((px / cell).astype(np.int64), own, py)

    # crossing contributions: where an edge crosses a column boundary x=b,
    # the interpolated y bounds both adjacent columns (vectorized over ALL
    # crossings of all edges at once)
    lo_x = np.minimum(px, qx)
    hi_x = np.maximum(px, qx)
    b0 = np.ceil(lo_x / cell).astype(np.int64)
    b1 = np.floor(hi_x / cell).astype(np.int64)
    cnt = np.where((b1 >= b0) & (hi_x - lo_x > 1e-20), b1 - b0 + 1, 0)
    total = int(cnt.sum())
    if total:
        eidx = np.repeat(np.arange(e.shape[0]), cnt)
        start = np.cumsum(cnt) - cnt
        bs = b0[eidx] + (np.arange(total) - start[eidx])
        t = np.clip((bs * cell - px[eidx]) / (qx[eidx] - px[eidx] + 1e-30),
                    0.0, 1.0)
        yb = py[eidx] + t * (qy[eidx] - py[eidx])
        add(bs - 1, own[eidx], yb)
        add(bs, own[eidx], yb)

    keys = np.nonzero(np.isfinite(lo_arr))[0]
    cols = keys % w_cols
    lo_s = lo_arr[keys] - pad
    hi_s = hi_arr[keys] + pad

    # horizontal gutter: replicate every interval into columns within
    # ceil(pad/cell) (the multi-span form of the old sliding min/max window)
    r = max(int(math.ceil(pad / cell)), 0)
    if r > 0:
        offs = np.arange(-r, r + 1, dtype=np.int64)
        cols = (cols[:, None] + offs[None, :]).ravel()
        lo_s = np.repeat(lo_s, 2 * r + 1)
        hi_s = np.repeat(hi_s, 2 * r + 1)
        keep = (cols >= 0) & (cols < w_cols)
        cols, lo_s, hi_s = cols[keep], lo_s[keep], hi_s[keep]

    # quantize outward (conservative), then union intervals per column
    lo_c = np.clip(np.floor(lo_s / cell).astype(np.int64), 0, rows)
    hi_c = np.clip(np.ceil(hi_s / cell).astype(np.int64), 0, rows)
    ok = hi_c > lo_c
    cols, lo_c, hi_c = cols[ok], lo_c[ok], hi_c[ok]
    if cols.size == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    order = np.lexsort((lo_c, cols))
    cols, lo_c, hi_c = cols[order], lo_c[order], hi_c[order]
    out_c, out_l, out_h = [], [], []
    cur_col, cur_lo, cur_hi = int(cols[0]), int(lo_c[0]), int(hi_c[0])
    for i in range(1, cols.size):
        c, l, h = int(cols[i]), int(lo_c[i]), int(hi_c[i])
        if c == cur_col and l <= cur_hi:
            cur_hi = max(cur_hi, h)
        else:
            out_c.append(cur_col)
            out_l.append(cur_lo)
            out_h.append(cur_hi)
            cur_col, cur_lo, cur_hi = c, l, h
    out_c.append(cur_col)
    out_l.append(cur_lo)
    out_h.append(cur_hi)
    return (np.asarray(out_c, np.int64), np.asarray(out_l, np.int64),
            np.asarray(out_h, np.int64))


def _grid_fill(occ, spans_list, heights_cells, band: int = 128,
               stride: int = 1):
    """Place charts into ANY free pocket of the occupancy grid (the skyline
    can only stack on top; this recovers the trapped air under and between
    the big charts). occ: (R, C) bool; spans_list[i] = (cols, lo, hi)
    multi-span cell intervals of chart i (lo inclusive, hi exclusive; a
    column may carry several disjoint spans, so chart HOLES stay free and
    later charts can nest inside them). Returns (placements (N, 2) cell
    coords or -1, occ updated in place).

    First-fit lowest-(y, x), searched in row bands from the bottom so the
    cost scales with where the chart lands, not the grid height; the
    column-prefix-sum table is patched incrementally per placement (a full
    rebuild per chart measured 50 s of a 141 s theInn build).

    stride: test candidate POSITIONS every `stride` cells only. The claim
    quantization (what coverage pays for — tools/atlas_loss_probe.py measured
    span overhead 16% vs pack air 2%) is set by the CELL size; position
    granularity only costs pack air, so a fine grid with strided search buys
    the quantization win at 1/stride^2 the search cost."""
    r, c = occ.shape
    out = np.full((len(spans_list), 2), -1, np.int64)
    cum = np.zeros((r + 1, c), np.int32)
    np.cumsum(occ, axis=0, out=cum[1:], dtype=np.int32)
    for i, (cs, lo, hi) in enumerate(spans_list):
        if cs.size == 0:
            continue
        # tallest spans first: they kill dead bands fastest, enabling the
        # every-16-spans early exit below
        korder = np.argsort(lo - hi, kind="stable")
        cs, lo, hi = cs[korder], lo[korder], hi[korder]
        w = int(cs.max()) + 1
        h = heights_cells[i]
        if w > c or h >= r:
            continue
        ymax = r - h
        xmax = c - w + 1
        if ymax <= 0 or xmax <= 0:
            continue
        nx = (xmax + stride - 1) // stride
        found = None
        for y0 in range(0, ymax, band):
            yb = min(band, ymax - y0)
            ny = (yb + stride - 1) // stride
            ok = np.ones((ny, nx), bool)
            dead = False
            for k in range(cs.size):
                ck = cs[k]
                ok &= (cum[hi[k] + y0:hi[k] + y0 + yb:stride,
                           ck:ck + xmax:stride]
                       - cum[lo[k] + y0:lo[k] + y0 + yb:stride,
                             ck:ck + xmax:stride]) == 0
                if (k & 15) == 15 and not ok.any():
                    dead = True
                    break
            if dead:
                continue
            ys, xs = np.nonzero(ok)
            if ys.size:
                j = np.lexsort((xs, ys))[0]
                found = (int(ys[j]) * stride + y0, int(xs[j]) * stride)
                break
        if found is None:
            continue
        y, x = found
        out[i] = (x, y)
        for k in range(cs.size):
            occ[y + lo[k]:y + hi[k], x + cs[k]] = True
        c0 = x + int(cs.min())
        c1 = x + int(cs.max()) + 1
        np.cumsum(occ[:, c0:c1], axis=0, out=cum[1:, c0:c1], dtype=np.int32)
    return out


def _blf_pack(uvs_of, chart_uv, chart_of, pad_w, pad_h, pad, total,
              grid_cols, f, pos_stride=1):
    """One bottom-left-fill pass at width factor `f`.

    pad: world-space HALF-separation each chart claims on every side (two
    adjacent charts end up >= 2*pad apart — outward quantization only GROWS
    claims, so the bound is exact at any cell size).

    Returns (origin (N, 2) world-unit chart origins, side, balance) where
    side is the final square edge and balance = used_h / atlas_w (the
    caller's width-iteration signal)."""
    n_charts = pad_w.shape[0]
    atlas_w = max(math.sqrt(total) * f, pad_w.max() + 1e-12)
    cell = atlas_w / grid_cols
    order = np.argsort(-(pad_w * pad_h), kind="stable")
    rows = grid_cols * 3  # generous: narrow passes stack high
    spans = []
    hcells = []
    for c in order:
        w_cols = max(int(math.ceil(pad_w[c] / cell)), 1)
        sp = _chart_spans(uvs_of[c], min(w_cols, grid_cols), cell, pad, rows)
        spans.append(sp)
        hcells.append(int(sp[2].max()) if sp[2].size else 1)
    occ = np.zeros((rows, grid_cols), bool)
    placed = _grid_fill(occ, spans, hcells, stride=pos_stride)

    origin = np.zeros((n_charts, 2))
    # anything the grid could not fit goes on a shelf above everything
    # (only reachable at extreme width factors)
    ys = np.nonzero(occ.any(axis=1))[0]
    top_y = (int(ys.max()) + 1) * cell if ys.size else 0.0
    x = 0.0
    shelf_h = 0.0
    for j, c in enumerate(order):
        if uvs_of[c].shape[0] == 0:
            continue  # id emptied by a merge — no geometry to place
        if placed[j][0] >= 0:
            origin[c] = (placed[j][0] * cell + pad, placed[j][1] * cell + pad)
            continue
        if x + pad_w[c] > atlas_w and x > 0.0:
            top_y += shelf_h
            x = 0.0
            shelf_h = 0.0
        origin[c] = (x + pad, top_y + pad)
        x += pad_w[c]
        shelf_h = max(shelf_h, pad_h[c])

    final = chart_uv + origin[chart_of][:, None, :]
    ext = final.reshape(-1, 2).max(axis=0) + pad
    side = float(max(ext[0], ext[1]))
    return origin, side, float(ext[1]) / atlas_w


def build_charted_atlas(positions, tri_idx, gutter_texels: float = 2.0,
                        ref_resolution: int = 1024, max_angle_deg: float = 60.0,
                        max_chart_tris: int = 4000,
                        overlap_tolerance: float = 0.02,
                        grid_cols: int = 2048,
                        pack_iters: int = 4,
                        pos_stride: int = 0) -> ChartedAtlas:
    """Chart, project, and pack lightmap UVs for the given mesh.

    grid_cols: packing-grid resolution — sets the CLAIM quantization, the
    dominant coverage loss (tools/atlas_loss_probe.py: span overhead 16% vs
    pack air 2% at 512 cols). Cost ~ (grid_cols/pos_stride)²; 512 is fast
    for tests.
    pack_iters: width-iteration passes of the BLF packer.
    pos_stride: candidate-position stride in cells (0 = auto grid_cols/1024:
    fine claims, coarse placement — placement granularity only costs the
    ~2% pack-air term)."""
    if pos_stride <= 0:
        pos_stride = max(1, grid_cols // 1024)
    positions = np.asarray(positions, np.float64)
    tri_idx = np.asarray(tri_idx, np.int64)
    t = tri_idx.shape[0]
    v0 = positions[tri_idx[:, 0]]
    v1 = positions[tri_idx[:, 1]]
    v2 = positions[tri_idx[:, 2]]
    n_raw = np.cross(v1 - v0, v2 - v0)
    areas = 0.5 * np.linalg.norm(n_raw, axis=1)
    normals = n_raw / np.maximum(np.linalg.norm(n_raw, axis=1, keepdims=True),
                                 1e-20)

    chart, n_charts = _grow_charts(positions, tri_idx, normals, areas,
                                   max_angle_deg, max_chart_tris)

    # --- project each chart; split folded charts into per-tri fallbacks ---
    chart_uv = np.zeros((t, 3, 2), np.float64)   # world-unit chart-local UVs
    chart_of = chart.copy()
    next_chart = n_charts
    for cid in range(n_charts):
        sel = np.nonzero(chart == cid)[0]
        n0 = normals[sel[np.argmax(areas[sel])]]
        t1, t2 = _plane_basis(n0)
        verts = positions[tri_idx[sel]]                       # (C, 3, 3)
        uv2 = np.stack([verts @ t1, verts @ t2], axis=-1)     # (C, 3, 2)
        if sel.size > 1 and _chart_overlap_frac(uv2) > overlap_tolerance:
            # folded/self-overlapping: demote to one chart per triangle,
            # each projected onto its own plane (always injective)
            for j, ti in enumerate(sel):
                tb1, tb2 = _plane_basis(normals[ti])
                vv = positions[tri_idx[ti]]
                chart_uv[ti] = np.stack([vv @ tb1, vv @ tb2], axis=-1)
                chart_of[ti] = cid if j == 0 else next_chart
                if j > 0:
                    next_chart += 1
        else:
            chart_uv[sel] = uv2
    n_charts = next_chart

    # --- hinge-unfold merging: defragment the hard-edge splits (theInn:
    # 2956 charts of mostly 2-4 tris; every chart pays gutter + bbox air).
    # Residual bound uses a pre-pack gutter estimate (atlas side ~
    # sqrt(2x triangle area), i.e. ~50% coverage — conservative: a smaller
    # true side only TIGHTENS the seam bound used during merging).
    g_est = (gutter_texels
             * math.sqrt(max(2.0 * float(areas.sum()), 1e-20))
             / ref_resolution)
    _merge_charts(positions, tri_idx, chart_of, chart_uv, n_charts, g_est,
                  max_chart_tris, overlap_tolerance)

    # --- rotate each chart to its minimum-area bbox; land in landscape ---
    ids = np.unique(chart_of)
    bbox_w = np.zeros(n_charts)
    bbox_h = np.zeros(n_charts)
    angles = np.linspace(0.0, math.pi / 2.0, 16, endpoint=False)
    cs, sn = np.cos(angles), np.sin(angles)
    # chart_of sorted grouping (vectorized per-chart loops over index lists)
    group_order = np.argsort(chart_of, kind="stable")
    bounds = np.searchsorted(chart_of[group_order], np.arange(n_charts + 1))
    for cid in ids:
        sel = group_order[bounds[cid]:bounds[cid + 1]]
        uv = chart_uv[sel].reshape(-1, 2)
        # minimal-area bbox over 16 candidate rotations
        xr = uv[:, 0:1] * cs[None, :] - uv[:, 1:2] * sn[None, :]
        yr = uv[:, 0:1] * sn[None, :] + uv[:, 1:2] * cs[None, :]
        wz = xr.max(axis=0) - xr.min(axis=0)
        hz = yr.max(axis=0) - yr.min(axis=0)
        k = int(np.argmin(wz * hz))
        uv = np.stack([xr[:, k] - xr[:, k].min(),
                       yr[:, k] - yr[:, k].min()], axis=-1)
        ext = uv.max(axis=0)
        if ext[1] > ext[0]:  # rotate 90 deg to landscape (shelves like wide)
            uv = np.stack([uv[:, 1], ext[0] - uv[:, 0]], axis=-1)
            ext = ext[::-1]
        chart_uv[sel] = uv.reshape(-1, 3, 2)
        bbox_w[cid], bbox_h[cid] = ext[0], ext[1]

    # --- world-space gutter from the requested texel gutter ---
    # Each chart claims HALF the gutter on every side (pad): two charts then
    # sit >= gutter_texels apart — enough for dilate-ring ownership +
    # bilinear reach — instead of the 2x-gutter the full-pad layout paid
    # (span overhead is the dominant coverage loss; atlas_loss_probe.py).
    area_sum = float(((bbox_w + 1e-12) * (bbox_h + 1e-12)).sum())
    scale0 = 1.0 / max(math.sqrt(area_sum), 1e-20)   # rough atlas-per-world
    g = gutter_texels / (ref_resolution * scale0)
    pad = 0.5 * g
    pad_w = bbox_w + 2.0 * pad
    pad_h = bbox_h + 2.0 * pad

    # --- pack: bottom-left-fill EVERY chart through the occupancy grid ---
    # All charts, biggest first, first-fit lowest-(y, x) against exact
    # per-column profiles, so small charts nest into the trapped air under
    # and between big placements as they are packed (skyline-for-big +
    # grid-fill-for-small measured 0.795 packing efficiency on theInn; full
    # BLF at the balanced width measures ~0.94 — PERF_NOTES.md round 3).
    #
    # The atlas is square (side = max extent), so a tall-and-narrow or
    # short-and-wide layout wastes the envelope: iterate the pack width by
    # the measured height/width imbalance, keeping the best final side.
    total = float((pad_w * pad_h).sum())

    uvs_of = [None] * n_charts
    for c in range(n_charts):
        uvs_of[c] = chart_uv[group_order[bounds[c]:bounds[c + 1]]] + pad

    # The coverage peak in f is sharp (±0.01 moves it several points) and
    # does NOT transfer across grid resolutions, so the iteration runs at
    # the full grid resolution.
    best = None
    f = 1.0
    seen = set()
    for _ in range(max(pack_iters, 1)):
        key = round(f, 3)
        if key in seen:
            break
        seen.add(key)
        origin_f, side_f, balance = _blf_pack(
            uvs_of, chart_uv, chart_of, pad_w, pad_h, pad, total, grid_cols,
            f, pos_stride)
        if best is None or side_f < best[0]:
            best = (side_f, origin_f)
        # move toward used_h == atlas_w (area is ~conserved, so the
        # balanced width is ~ sqrt(atlas_w * used_h))
        f *= math.sqrt(min(max(balance, 0.25), 4.0))
    _, origin = best

    final_raw = chart_uv + origin[chart_of][:, None, :]
    ext = final_raw.reshape(-1, 2).max(axis=0) + pad
    side = float(max(ext[0], ext[1]))
    final = final_raw / side
    # expected texel coverage = projected world triangle area / atlas area
    # (both in world units since `side` is the atlas edge in world units)
    coverage = float(areas.sum() / (side * side))

    return ChartedAtlas(num_tris=t, tri_uv=final.astype(np.float32),
                        num_charts=int(np.unique(chart_of).size),
                        coverage=coverage,
                        gutter_texels=gutter_texels,
                        ref_resolution=ref_resolution)


def rasterize_texel_map(tri_uv: np.ndarray, resolution: int,
                        dilate: int = 2):
    """Rasterize the atlas: per texel (tri_id, bary_u, bary_v), -1 outside,
    then dilate `dilate` rings so gutter texels copy their nearest edge texel
    (bilinear lightmap sampling then never bleeds background; the dilated
    texels bake the same surface point as the edge they copy).

    Returns (tri (S,S) i32, bu (S,S) f32, bv (S,S) f32, coverage_frac)."""
    s = resolution
    tri_map = np.full((s, s), -1, np.int32)
    bu = np.zeros((s, s), np.float32)
    bv = np.zeros((s, s), np.float32)
    q = np.asarray(tri_uv, np.float64) * s  # texel coords; texel centers +0.5
    for ti in range(q.shape[0]):
        tri = q[ti]
        lo = np.floor(tri.min(axis=0) - 0.5).astype(int)
        hi = np.ceil(tri.max(axis=0) + 0.5).astype(int)
        lo = np.maximum(lo, 0)
        hi = np.minimum(hi, s - 1)
        if (hi < lo).any():
            continue
        xs = np.arange(lo[0], hi[0] + 1)
        ys = np.arange(lo[1], hi[1] + 1)
        px, py = np.meshgrid(xs + 0.5, ys + 0.5, indexing="ij")
        e1 = tri[1] - tri[0]
        e2 = tri[2] - tri[0]
        det = e1[0] * e2[1] - e1[1] * e2[0]
        if abs(det) < 1e-12:
            continue
        dx = px - tri[0][0]
        dy = py - tri[0][1]
        u = (dx * e2[1] - dy * e2[0]) / det
        v = (e1[0] * dy - e1[1] * dx) / det
        inside = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        if not inside.any():
            continue
        # u weights v1, v2 (HitAttributes convention); atlas u axis is
        # texel COLUMN, so tri_map is indexed [col, row] here -> transpose
        # at the end to match the (row, col) image convention.
        sub = tri_map[lo[0]:hi[0] + 1, lo[1]:hi[1] + 1]
        take = inside & (sub < 0)
        sub[take] = ti
        bu[lo[0]:hi[0] + 1, lo[1]:hi[1] + 1][take] = u[take]
        bv[lo[0]:hi[0] + 1, lo[1]:hi[1] + 1][take] = v[take]

    coverage = float((tri_map >= 0).mean())

    # --- gutter dilation (copy nearest covered texel's mapping) ---
    for _ in range(dilate):
        empty = tri_map < 0
        for sx, sy in ((1, 0), (-1, 0), (0, 1), (0, -1),
                       (1, 1), (1, -1), (-1, 1), (-1, -1)):
            shifted = np.roll(np.roll(tri_map, sx, 0), sy, 1)
            sbu = np.roll(np.roll(bu, sx, 0), sy, 1)
            sbv = np.roll(np.roll(bv, sx, 0), sy, 1)
            adopt = empty & (tri_map < 0) & (shifted >= 0)
            tri_map = np.where(adopt, shifted, tri_map)
            bu = np.where(adopt, sbu, bu)
            bv = np.where(adopt, sbv, bv)

    # stored [col(x=u), row(y=v)] -> image convention [row, col]
    return tri_map.T.copy(), bu.T.copy(), bv.T.copy(), coverage
