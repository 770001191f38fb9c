"""Adversarial inputs for the BVH walk: scenes and rays whose walks reach
every tie rule of the traversal. numpy only (but for the three helpers that
use the port, `alpha_case_scene`, `packet_stack_height` and `grid_scene`'s
BoxTest), made from a seed.

Two cases, each a triangle scene (v0, v1, v2: (T, 3) float32) and a ray set
(o, d: (N, 3) float32; tmin, tmax: (N,) float32; active: (N,) bool):

  - "ties": a floor of unit quads in the plane y = 0, a 4 x 2 x 4 block of
    touching unit cubes above it (every inner face twice, coplanar), and
    small triangles each repeated three times (equal t, so the lowest leaf
    slot wins). The rays: axis-aligned rays on a half-unit lattice (zero
    direction components, some of them -0, so `safe_inv` gives 1e12 and
    coplanar boxes give equal slab keys; integer lattice points run along
    shared edges and faces); rays that start on an outer face (hits and slab
    keys at t = +0 or -0; each start point lies on one triangle only, so no
    two triangles tie at zero t); rays aimed at the repeated triangles; and
    random rays.
  - "soup": the triangle soup of tests/test_pallas_body.py and its rays.

Every ray set mixes t_min in {0, 1e-4, 0.5} and t_max in {3.5, 7.5, 1e30}
and leaves about a fifth of its rays inactive. Used by
tests/test_torch_traverse.py (the port's plain walk against the JAX package)
and chip_smoke.py (the CUDA kernel against the plain walk, on the card).

`alpha_cases` adds four alpha-test cases, each a list of meshes (material 0
opaque, material 1 alpha-tested), its opacity mask and rays:

  - "alpha_cutoff": a card whose mask holds bands of exactly 0.35 (an
    opacity of exactly 0.35 passes), of the float just below (fails), of 1
    and of 0;
  - "alpha_stack": 16 stacked cards, each shifted so that a ray crosses the
    mask's transparent part on the first few to all of them: chains of up
    to 16 rejections, where the in-loop test and the JAX package's
    punch-through (at most 8 rounds) part ways;
  - "alpha_coplanar": an opaque and an alpha-tested quad in one plane, hit
    at equal t;
  - "alpha_edge_on": a card seen edge-on and at grazing angles.
Used by tests/test_torch_alpha.py and chip_smoke.py.

The engines' edge cases (tests/test_torch_packet.py, tests/test_torch_proxy.py
and chip_smoke.py E1):

  - `packet_edge_cases`, for the 128-ray packet walk on a given W8 table:
    a packet with no active ray (beside a full one) and packets with one
    active ray (at lanes 0, 77 and 127), their rays from the centre of the
    scene in every direction, a packet whose rays all hit in the
    first leaf the walk reaches (any hit ends there), and a packet that
    reaches the deepest stack the table needs (rays in every direction from
    the box of its deepest leaf; `packet_stack_height` measures it on the
    plain walk); `pad_to_packets` pads a ray set with inactive rays to
    whole packets;
  - `proxy_edge_rays`, for the dense-proxy screen: n not a multiple of 32,
    a fifth inactive, t_max <= t_min on some lanes, and axis-aligned
    directions whose zero components are +0 or -0; with `soup` and the
    BoxTest scene they give K = 8, 24 and 1,365 (the kernel's most);
  - `grid_edge_cases`, for the sun-space grid walk on a given grid (the
    grids of `GRID_SCENES`: three seeded soups, one of them with a 96-cell
    grid and one with a steep sun, and BoxTest): origins on cell borders,
    outside the grid's box and with a NaN component, empty cells, thr equal
    to a record's suffix- and own-zmax, the longest chain, t_max <= t_min,
    inactive lanes and ragged n (tests/test_torch_sunspace.py and
    chip_smoke.py E1).

The seeded and binned routes' (tests/test_torch_history.py,
tests/test_torch_swraster.py and chip_smoke.py S):

  - `history_predictions`: temporal-history predictions that mix true hits,
    -1, random triangles and hits beyond t_max, with inactive lanes;
  - `raster_edge_scene`: for the software raster, a tile deeper than 320
    triangles, a repeated quad (equal t), a triangle through the near
    plane and empty tiles.

The split alpha route's (tests/test_torch_kcand.py and chip_smoke.py K):

  - `kcand_case_meshes` and `kcand_cases`: one alpha scene (a floor, the
    16 stacked, shifted cards of "alpha_stack" with its band mask, two
    coincident alpha cards and an opaque quad in their plane) and named ray
    sets for its opaque-only and K-candidate walks: "overflow" (down the
    stack, on the leaf-12 alpha table, where one leaf holds more than two
    candidates of a ray), "all_rejected" (down the stack where the first
    nine cards reject: a full buffer of K = 8 rejected candidates),
    "equal_t" (through the coincident cards: candidates at equal t),
    "inactive" (a packet with no active ray beside a full one) and "k1"
    (the stack at K = 1); each with its alpha table's leaf size and K.
"""

import numpy as np

from ..scene.procedural import make_plane

CUBE_LO = np.array([-2.0, 1.0, -2.0], np.float32)   # the block of cubes
CUBE_DIMS = (4, 2, 4)
FLOOR_HALF = 8                                       # floor spans [-8, 8]^2
REPEATED = 64                                        # triangles, 3 copies each
PACKET = 128                                         # rays per packet
RAY_FIELDS = ("o", "d", "tmin", "tmax", "active")


def soup(seed=0, m=2500):
    """The triangle soup of tests/test_pallas_body.py."""
    rng = np.random.default_rng(seed)
    v0 = (rng.standard_normal((m, 3)) * 4).astype(np.float32)
    v1 = v0 + rng.standard_normal((m, 3)).astype(np.float32) * 0.8
    v2 = v0 + rng.standard_normal((m, 3)).astype(np.float32) * 0.8
    return v0, v1, v2


def _unit(rng, n):
    d = rng.standard_normal((n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _limits(rng, n):
    """t_min, t_max and active for n rays."""
    tmin = rng.choice(np.float32([0.0, 1e-4, 0.5]), size=n)
    tmax = rng.choice(np.float32([3.5, 7.5, 1e30]), size=n, p=[0.2, 0.2, 0.6])
    return tmin, tmax, rng.random(n) > 0.2


def soup_rays(seed=5, n=2048):
    """The rays of tests/test_pallas_body.py with mixed limits."""
    rng = np.random.default_rng(seed)
    o = (rng.standard_normal((n, 3)) * 5).astype(np.float32)
    d = _unit(rng, n)
    tmin, tmax, active = _limits(np.random.default_rng(seed + 100), n)
    return dict(o=o, d=d, tmin=tmin, tmax=tmax, active=active)


def _quad(a, b, c, d):
    """Two triangles (a, b, c) and (a, c, d) of the quad a-b-c-d."""
    return [(a, b, c), (a, c, d)]


def _cube(lo):
    x0, y0, z0 = lo
    x1, y1, z1 = x0 + 1, y0 + 1, z0 + 1
    p = [(x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0),
         (x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)]
    faces = ((0, 3, 2, 1), (4, 5, 6, 7), (0, 4, 7, 3), (1, 2, 6, 5),
             (0, 1, 5, 4), (3, 7, 6, 2))
    return [t for f in faces for t in _quad(*(p[i] for i in f))]


def tie_scene(seed=0):
    """Floor, block of touching cubes and thrice-repeated triangles (the
    last 3 * REPEATED of the scene)."""
    tris = []
    for i in range(-FLOOR_HALF, FLOOR_HALF):
        for k in range(-FLOOR_HALF, FLOOR_HALF):
            tris += _quad((i, 0, k), (i, 0, k + 1), (i + 1, 0, k + 1),
                          (i + 1, 0, k))
    nx, ny, nz = CUBE_DIMS
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                tris += _cube(CUBE_LO + np.float32([i, j, k]))
    t = np.asarray(tris, np.float32)                  # (T, 3, 3)
    rng = np.random.default_rng(seed)
    c = np.stack([rng.uniform(-6, 6, REPEATED), rng.uniform(4, 6, REPEATED),
                  rng.uniform(-6, 6, REPEATED)], 1).astype(np.float32)
    small = c[:, None, :] + (rng.standard_normal((REPEATED, 3, 3))
                             * 0.4).astype(np.float32)
    t = np.concatenate([t, np.repeat(small, 3, axis=0)])
    return t[:, 0].copy(), t[:, 1].copy(), t[:, 2].copy()


def _signed_zeros(rng, d):
    """d with a random half of its zero components turned into -0."""
    flip = (d == 0) & (rng.random(d.shape) < 0.5)
    return np.where(flip, np.float32(-0.0), d).astype(np.float32)


def tie_rays(scene, seed=1, n_axis=1024, n_face=512, n_repeat=512,
             n_random=512):
    """Rays of the "ties" case on `scene` = tie_scene() (see the module
    docstring)."""
    rng = np.random.default_rng(seed)
    v0, v1, v2 = scene
    lattice = np.arange(-5.0, 5.5, 0.5, dtype=np.float32)  # integers included

    # axis-aligned: from 10 units out along one axis, straight back in
    axis = rng.integers(0, 3, n_axis)
    sign = rng.choice(np.float32([-1.0, 1.0]), n_axis)
    o_ax = rng.choice(lattice, (n_axis, 3))
    o_ax[:, 1] = rng.choice(np.arange(-1.0, 4.5, 0.5, dtype=np.float32),
                            n_axis)
    o_ax[np.arange(n_axis), axis] = -10.0 * sign
    d_ax = np.zeros((n_axis, 3), np.float32)
    d_ax[np.arange(n_axis), axis] = sign

    # on an outer face, never on an edge: the floor, the cubes' tops and
    # their -x side, each start point on one triangle only
    which = rng.integers(0, 3, n_face)
    u = rng.uniform(0.05, 0.45, (n_face, 2)).astype(np.float32)
    cell = rng.integers(0, 4, (n_face, 2)).astype(np.float32)
    floor = np.stack([rng.uniform(-7.9, 7.9, n_face), np.zeros(n_face),
                      rng.uniform(-7.9, 7.9, n_face)], 1)
    top = np.stack([CUBE_LO[0] + cell[:, 0] + u[:, 0] + 0.5 * (u[:, 1] > 0.25),
                    np.full(n_face, CUBE_LO[1] + CUBE_DIMS[1]),
                    CUBE_LO[2] + cell[:, 1] + u[:, 1]], 1)
    side = np.stack([np.full(n_face, CUBE_LO[0]),
                     CUBE_LO[1] + cell[:, 0] % 2 + u[:, 0],
                     CUBE_LO[2] + cell[:, 1] + u[:, 1]
                     + 0.5 * (u[:, 0] > 0.25)], 1)
    o_face = np.choose(which[:, None], [floor, top, side]).astype(np.float32)
    d_face = _unit(rng, n_face)

    # aimed at the repeated triangles
    pick = rng.integers(len(v0) - 3 * REPEATED, len(v0), n_repeat)
    w = rng.dirichlet(np.ones(3), n_repeat).astype(np.float32)
    target = w[:, :1] * v0[pick] + w[:, 1:2] * v1[pick] + w[:, 2:] * v2[pick]
    o_rep = target + _unit(rng, n_repeat) * rng.uniform(
        2.0, 8.0, (n_repeat, 1)).astype(np.float32)
    d_rep = target - o_rep
    d_rep /= np.linalg.norm(d_rep, axis=1, keepdims=True)

    o_rnd = np.stack([rng.uniform(-9, 9, n_random),
                      rng.uniform(-1, 7, n_random),
                      rng.uniform(-9, 9, n_random)], 1).astype(np.float32)
    d_rnd = _unit(rng, n_random)

    o = np.concatenate([o_ax, o_face, o_rep, o_rnd]).astype(np.float32)
    d = np.concatenate([d_ax, d_face, d_rep, d_rnd]).astype(np.float32)
    d = _signed_zeros(rng, d)
    tmin, tmax, active = _limits(rng, len(o))
    # rays that start on a face take t_min 0 most of the time, so that
    # their hits at t = +-0 count
    face = slice(n_axis, n_axis + n_face)
    tmin[face] = np.where(rng.random(n_face) < 0.75, np.float32(0.0),
                          tmin[face])
    return dict(o=o, d=d, tmin=tmin, tmax=tmax, active=active)


def _band_mask(values, size=64):
    """(size, size, 1) f32 mask of vertical bands, one per value, in u."""
    cols = np.repeat(np.asarray(values, np.float32), size // len(values))
    return np.broadcast_to(cols[None, :, None], (size, size, 1)).copy()


def _down_rays(rng, n, x, z, y0=5.0, tilt=0.2):
    """n rays from height y0 down onto the points (x, z), a little tilted."""
    o = np.stack([x, np.full(n, y0), z], 1).astype(np.float32)
    d = np.stack([rng.uniform(-tilt, tilt, n), -np.ones(n),
                  rng.uniform(-tilt, tilt, n)], 1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _alpha_rays(rng, o, d, tmax=1e30):
    n = len(o)
    tmin = rng.choice(np.float32([0.0, 1e-4]), size=n)
    return dict(o=o.astype(np.float32), d=d.astype(np.float32), tmin=tmin,
                tmax=np.full(n, tmax, np.float32), active=rng.random(n) > 0.1)


def alpha_cases(seed=0, n=2048):
    """{name: (meshes, mask, rays)} of the four alpha cases (see the module
    docstring); the meshes' material 1 is alpha-tested by `mask`."""
    rng = np.random.default_rng(seed)
    floor = make_plane((20.0, 20.0), (0.0, -10.0, 0.0), material_idx=0)
    out = {}

    below = np.nextafter(np.float32(0.35), np.float32(0.0))
    o, d = _down_rays(rng, n, rng.uniform(-1.2, 1.2, n),
                      rng.uniform(-1.2, 1.2, n))
    out["alpha_cutoff"] = (
        [floor, make_plane((2.0, 2.0), (0.0, 0.0, 0.0), material_idx=1)],
        _band_mask([0.35, below, 1.0, 0.0]), _alpha_rays(rng, o, d))

    # card k at y = -0.5 k, shifted -0.08 k in x: a ray at x0 crosses card
    # k at u = (x0 + 0.08 k + 1) / 2, opaque from u = 0.75 on
    stack = [make_plane((2.0, 2.0), (-0.08 * k, -0.5 * k, 0.0),
                        material_idx=1) for k in range(16)]
    o, d = _down_rays(rng, n, rng.uniform(-1.0, 0.6, n),
                      rng.uniform(-0.9, 0.9, n), tilt=0.02)
    out["alpha_stack"] = ([floor] + stack, _band_mask([0.0, 0.0, 0.0, 1.0]),
                          _alpha_rays(rng, o, d))

    yy, xx = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    checker = (((yy // 8 + xx // 8) % 2).astype(np.float32))[..., None]
    o, d = _down_rays(rng, n, rng.uniform(-1.5, 1.5, n),
                      rng.uniform(-1.5, 1.5, n))
    out["alpha_coplanar"] = (
        [floor, make_plane((2.0, 2.0), (0.5, 0.0, 0.0), material_idx=0),
         make_plane((2.0, 2.0), (-0.5, 0.0, 0.0), material_idx=1)],
        checker, _alpha_rays(rng, o, d))

    # in the card's plane y = 0 (det exactly 0), and grazing it
    m = n // 2
    o_in = np.stack([rng.uniform(-3, -1.5, m), np.zeros(m),
                     rng.uniform(-0.9, 0.9, m)], 1)
    d_in = np.stack([np.ones(m), np.zeros(m), rng.uniform(-0.3, 0.3, m)], 1)
    o_gr = np.stack([rng.uniform(-3, -1.5, n - m),
                     rng.choice([-1e-3, -1e-6, 1e-6, 1e-3], n - m),
                     rng.uniform(-0.9, 0.9, n - m)], 1)
    d_gr = np.stack([np.ones(n - m),
                     rng.choice([-1e-3, -1e-6, 0.0, 1e-6, 1e-3], n - m),
                     rng.uniform(-0.3, 0.3, n - m)], 1)
    d = np.concatenate([d_in, d_gr])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    out["alpha_edge_on"] = (
        [floor, make_plane((2.0, 2.0), (0.0, 0.0, 0.0), material_idx=1)],
        checker, _alpha_rays(rng, np.concatenate([o_in, o_gr]), d))
    return out


def alpha_case_scene(meshes, mask):
    """The port's Scene (CPU tensors) of an alpha case."""
    from ..scene.build import build_scene
    from ..scene.registry import alpha_materials
    from ..scene.textures import AtlasBuilder
    builder = AtlasBuilder()
    materials = alpha_materials(builder, "alpha_case_opacity", mask)
    return build_scene(meshes, materials=materials, atlas_builder=builder)


def cases(seed=0):
    """{name: ((v0, v1, v2), rays)} of both cases."""
    scene = tie_scene(seed)
    return {"ties": (scene, tie_rays(scene, seed + 1)),
            "soup": (soup(seed), soup_rays(seed + 5))}


# ---------------------------------------------------------------------------
# The engines' edge cases
# ---------------------------------------------------------------------------

def pad_to_packets(rays):
    """`rays` with inactive rays (copies of the first) appended up to a
    whole number of packets."""
    n = len(rays["o"])
    pad = -n % PACKET
    out = {f: np.concatenate([rays[f], np.repeat(rays[f][:1], pad, 0)])
           for f in RAY_FIELDS}
    out["active"][n:] = False
    return out


def _children(table, row):
    """[(slot, code, lo, hi)] of the filled slots of internal record `row`."""
    rec = table[row]
    codes = rec[48:56].view(np.int32)
    lo, hi = rec[0:24].reshape(3, 8), rec[24:48].reshape(3, 8)
    return [(j, int(codes[j]), lo[:, j], hi[:, j]) for j in range(8)
            if rec[j] <= rec[24 + j]]


def _leaves(table, root_code):
    """[(leaf row, internal depth, box lo, box hi, path)] of every leaf of
    a W8 table, the path a list of (internal row, slot) from the root."""
    if root_code < 0:
        return [(~root_code, 0, None, None, [])]
    out, todo = [], [(root_code, [])]
    while todo:
        row, path = todo.pop()
        for j, code, lo, hi in _children(table, row):
            step = path + [(row, j)]
            if code < 0:
                out.append((~code, len(step), lo, hi, step))
            else:
                todo.append((code, step))
    return out


def _sole_descent(table, path, point):
    """Whether `point` lies in the box of the path's slot at every level
    and in no sibling's box: a walk from it with t_min 0 enters that slot
    first at every level (its entry t, 0, is the one least)."""
    for row, slot in path:
        inside = [j for j, _, lo, hi in _children(table, row)
                  if np.all(lo <= point) and np.all(point <= hi)]
        if inside != [slot]:
            return False
    return True


def _packet(o, d):
    """A packet of rays from the point o along the unit directions d, all
    active, t in [0, 1e30)."""
    n = len(d)
    return dict(o=np.broadcast_to(np.float32(o), (n, 3)).astype(np.float32),
                d=np.asarray(d, np.float32), tmin=np.zeros(n, np.float32),
                tmax=np.full(n, 1e30, np.float32), active=np.ones(n, bool))


def _first_leaf_packet(table, root_code, v0, v1, v2, rng):
    """A packet from one point whose walk enters, nearest first, the leaf
    of one of its triangles before any other leaf; every ray aims at an
    interior point of that triangle, so every ray hits in that leaf."""
    e1, e2 = v1 - v0, v2 - v0
    for row, _, _, _, path in sorted(_leaves(table, root_code),
                                     key=lambda x: x[1]):
        ids = table[row, 108:120].view(np.int32)
        for tid in ids[ids >= 0] & ~(1 << 30):
            n = np.cross(e1[tid], e2[tid]).astype(np.float64)
            area = np.linalg.norm(n)
            if area < 1e-6:
                continue
            c = (v0[tid] + (e1[tid] + e2[tid]) / 3.0).astype(np.float64)
            for h in (1e-2, 1e-3, 1e-4):
                o = (c + n / area * h * np.sqrt(area)).astype(np.float32)
                if not _sole_descent(table, path, o):
                    continue
                w = rng.dirichlet(np.ones(3) * 4.0, PACKET)
                w = 0.1 + 0.7 * w  # interior barycentrics, clear of edges
                w /= w.sum(1, keepdims=True)
                p = (w[:, :1] * v0[tid] + w[:, 1:2] * v1[tid]
                     + w[:, 2:] * v2[tid]).astype(np.float64)
                d = p - o
                d /= np.linalg.norm(d, axis=1, keepdims=True)
                return _packet(o, d)
    raise ValueError("no triangle's leaf is the sole first descent")


def deepest_leaf(table, root_code):
    """(internal depth, box centre) of the deepest leaf of a W8 table."""
    leaves = _leaves(table, root_code)
    _, depth, lo, hi, _ = max(leaves, key=lambda x: x[1])
    if lo is None:
        return 0, np.zeros(3, np.float32)
    return depth, ((lo.astype(np.float64) + hi) / 2).astype(np.float32)


def packet_edge_cases(v0, v1, v2, table, root_code, seed=0):
    """{name: rays} of the packet walk's edge cases on a W8 table (a
    (rows, 128) float32 array) over triangles v0, v1, v2; each a whole
    number of packets (see the module docstring)."""
    rng = np.random.default_rng(seed)
    table = np.asarray(table, np.float32)
    v0, v1, v2 = (np.asarray(v, np.float32) for v in (v0, v1, v2))
    lo = np.minimum(np.minimum(v0, v1), v2).min(0)
    hi = np.maximum(np.maximum(v0, v1), v2).max(0)
    # rays from the centre of the scene's box in every direction
    eye = (lo + hi) / 2
    d = _unit(rng, 3 * PACKET)
    full = _packet(eye, d[:2 * PACKET])
    full["active"][:PACKET] = False
    one = _packet(eye, d)
    one["active"][:] = False
    one["active"][[0, PACKET + 77, 3 * PACKET - 1]] = True
    _, deep_o = deepest_leaf(table, root_code)
    return {"no_active": full, "one_active": one,
            "first_leaf": _first_leaf_packet(table, root_code, v0, v1, v2,
                                             rng),
            "deep_stack": _packet(deep_o, _unit(rng, PACKET))}


def proxy_edge_rays(seed=0, n=4109):
    """Rays for the proxy screen's edge cases around the soup (see the
    module docstring): random and axis-aligned rays (signed zeros), mixed
    limits with t_max <= t_min on some lanes, a fifth inactive."""
    rng = np.random.default_rng(seed)
    m = n // 4
    o = (rng.standard_normal((n, 3)) * 5).astype(np.float32)
    d = _unit(rng, n)
    axis = rng.integers(0, 3, m)
    d_ax = np.zeros((m, 3), np.float32)
    d_ax[np.arange(m), axis] = rng.choice(np.float32([-1.0, 1.0]), m)
    d[:m] = _signed_zeros(rng, d_ax)
    tmin, tmax, active = _limits(rng, n)
    # t_max <= t_min: equal on some lanes, below on others
    bad = rng.random(n) < 0.1
    tmax = np.where(bad, np.where(rng.random(n) < 0.5, tmin,
                                  tmin - np.float32(0.25)), tmax)
    return dict(o=o, d=d, tmin=tmin, tmax=tmax.astype(np.float32),
                active=active)


def packet_stack_height(bvh, rays, first_hit=False):
    """The most (node, mask) entries a packet of `rays` (o, d, t_min, t_max,
    active tensors) holds in the plain packet walk on `bvh`."""
    from ..accel import packet, traverse
    most = 0
    step = packet.stack_step

    def recording(*args):
        nonlocal most
        out = step(*args)
        most = max(most, int(out[2].max()))  # (cur, pmask, sp, ...)
        return out

    o, d, tmin, tmax, act = rays
    packet.stack_step = recording
    try:
        packet.packet_traverse_plain(bvh, o, d, traverse.safe_inv(d), tmin,
                                     tmax, act, first_hit)
    finally:
        packet.stack_step = step
    return most


# ---------------------------------------------------------------------------
# The sun-space grid's edge cases
# ---------------------------------------------------------------------------

GRID_SUN = (0.3, 0.9, -0.2)
# the grids of tests/test_torch_sunspace.py: name: (soup seed or "boxtest",
# triangles, sun, grid size)
GRID_SCENES = {"soup512": (1, 500, GRID_SUN, 512),
               "soup96": (4, 1500, GRID_SUN, 96),
               "steep_sun": (2, 800, (0.1, -0.2, 0.95), 512),
               "boxtest": ("boxtest", 0, None, 512)}
GRID_NEXT, GRID_SUFZ, GRID_OWNZ = 120, 121, 122  # a record's tail slots
GRID_DONE = 0x7FFFFFFF


def grid_scene(name):
    """(v0, v1, v2, unit sun, grid size) of a grid of GRID_SCENES: a seeded
    soup, or BoxTest (the port's scene, loaded) and its sun."""
    seed, t, sun, size = GRID_SCENES[name]
    if seed == "boxtest":
        from ..app.settings import Scenes
        from ..scene.registry import load_scene
        scene, preset = load_scene(Scenes.BoxTest)
        pos, tri = scene.positions.numpy(), scene.tri_idx.numpy()
        v0, v1, v2 = pos[tri[:, 0]], pos[tri[:, 1]], pos[tri[:, 2]]
        sun = preset.sun_direction
    else:
        rng = np.random.default_rng(seed)
        base = rng.uniform(-10, 10, (t, 1, 3)).astype(np.float32)
        tris = base + rng.normal(0, 0.8, (t, 3, 3)).astype(np.float32)
        v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    sun = np.asarray(sun, np.float32)
    sun = sun / np.linalg.norm(sun)
    return (v0.astype(np.float32), v1.astype(np.float32),
            v2.astype(np.float32), sun, size)


def grid_project(o, basis):
    """(px, py, sun depth) of origins o as the grid walk sums them: f32,
    left to right, each product and sum rounded on its own."""
    o = np.asarray(o, np.float32)
    b = np.asarray(basis, np.float32)
    return tuple((o[:, 0] * b[k, 0] + o[:, 1] * b[k, 1]) + o[:, 2] * b[k, 2]
                 for k in range(3))


def grid_cells(o, params, basis, size):
    """(cx, cy) int64 of origins o: floor, clip, NaN to 0, as the walk."""
    px, py, _ = grid_project(o, basis)
    p = np.asarray(params, np.float32)
    out = []
    for q, g0, inv in ((px, p[0], p[2]), (py, p[1], p[3])):
        with np.errstate(invalid="ignore"):
            f = np.clip(np.floor((q - g0) * inv), 0, size - 1)
        out.append(np.nan_to_num(f, nan=0.0).astype(np.int64))
    return tuple(out)


def grid_chain(table, code):
    """The rows of the chain that starts at `code`, in walk order."""
    rows = []
    while code != GRID_DONE:
        rows.append(~code)
        code = int(table[~code, GRID_NEXT:GRID_NEXT + 1].view(np.int32)[0])
    return rows


def _chain_lengths(table):
    """(rows,) length of the chain from each row (a record's next row
    always precedes it in the table)."""
    nxt = table[:, GRID_NEXT].view(np.int32)
    length = np.zeros(len(table), np.int64)
    for r in range(len(table)):
        length[r] = 1 + (length[~nxt[r]] if nxt[r] != GRID_DONE else 0)
    return length


def _origins(basis, px, py, depth):
    """f32 origins whose projections are about (px, py, depth)."""
    b = np.asarray(basis, np.float64)
    return (np.asarray(px, np.float64)[:, None] * b[0]
            + np.asarray(py, np.float64)[:, None] * b[1]
            + np.asarray(depth, np.float64)[:, None] * b[2]).astype(np.float32)


def _cell_centres(params, cx, cy):
    p = np.asarray(params, np.float64)
    return (p[0] + (np.asarray(cx) + 0.5) / p[2],
            p[1] + (np.asarray(cy) + 0.5) / p[3])


def _ulp_search(o, coord, value_of, want, tries=96):
    """Each origin of o moved by the fewest whole ulps (at most `tries`)
    along coordinate `coord` at which want(value_of(o)) holds; (moved o,
    found mask)."""
    o = o.copy()
    found = want(value_of(o))
    up, down = o[:, coord].copy(), o[:, coord].copy()
    for _ in range(tries):
        if found.all():
            break
        up = np.nextafter(up, np.float32(np.inf))
        down = np.nextafter(down, np.float32(-np.inf))
        for cand in (up, down):
            trial = o.copy()
            trial[:, coord] = cand
            ok = ~found & want(value_of(trial))
            o[ok] = trial[ok]
            found |= ok
    return o, found


def _ray_set(o, d, tmin, tmax, active):
    n = len(o)
    return dict(o=np.asarray(o, np.float32),
                d=np.broadcast_to(np.asarray(d, np.float32), (n, 3)).copy(),
                tmin=np.broadcast_to(np.float32(tmin), (n,)).astype(
                    np.float32),
                tmax=np.broadcast_to(np.float32(tmax), (n,)).astype(
                    np.float32),
                active=np.broadcast_to(np.asarray(active, bool), (n,)).copy())


def grid_edge_cases(table, index, params, basis, size, sun=None, seed=0):
    """{name: rays} of the grid walk's edge cases on a grid (its table,
    index, params and basis as numpy arrays, its cells per axis), every ray
    along `sun`, the direction the grid was built for (by default its basis
    row 2, which may differ from it in the last bit):

      - "borders": origins whose (p - g0) * inv is an exact integer on one
        axis, the other or both (cell borders), moved there ulp by ulp;
      - "outside": origins outside the grid's box on one axis or both, which
        clip to edge cells;
      - "nan": a NaN origin component (the cell is 0, thr is NaN);
      - "empty_cell": origins in cells whose index is DONE;
      - "thr_suffix" / "thr_own": thr = (o . w) + t_min exactly equal to a
        chain record's suffix-zmax / own-zmax, records all along chains;
      - "longest_chain": origins in the cells of the longest chain, below
        every record, half of them with t_max so small that nothing blocks
        them (they walk the whole chain);
      - "limits": t_max == t_min and t_max < t_min on some lanes, a third
        inactive, the first 32 all inactive (a fetch with no active ray);
      - "ragged": 37 random rays (n a multiple of neither 32 nor 4); and
        "single": one ray.
    The sets that keep only the rays a search placed ("borders", the thr
    sets, "longest_chain") may come out shorter than asked."""
    f32 = np.float32
    rng = np.random.default_rng(seed)
    table = np.asarray(table, f32)
    index = np.asarray(index, np.int32)
    params = np.asarray(params, f32)
    basis = np.asarray(basis, f32)
    sun = basis[2] if sun is None else np.asarray(sun, f32)
    span_x, span_y = size / float(params[2]), size / float(params[3])
    own = table[:, GRID_OWNZ]
    zlo, zhi = float(own.min()) - 4.0, float(own.max()) + 1.0

    def random_xy(m, margin=0.0):
        return (params[0] + rng.uniform(-margin, 1 + margin, m) * span_x,
                params[1] + rng.uniform(-margin, 1 + margin, m) * span_y)

    def limits(m):
        tmin = rng.choice(f32([0.0, 1e-4, 0.5]), m)
        tmax = rng.choice(f32([2.0, 1e30]), m, p=[0.3, 0.7])
        return tmin, tmax

    out = {}
    # cell borders: the up axis of the basis (the zero component of row 0)
    # moves py alone, another coordinate px
    c_y = int(np.flatnonzero(basis[0] == 0)[0])
    c_x = int(np.argmax(np.where(np.arange(3) == c_y, -1, np.abs(basis[0]))))
    m = 95
    kx = rng.integers(1, size, m)
    ky = rng.integers(1, size, m)
    bx = params[0] + kx.astype(np.float64) / float(params[2])
    by = params[1] + ky.astype(np.float64) / float(params[3])
    cx0, cy0 = _cell_centres(params, rng.integers(0, size, m),
                             rng.integers(0, size, m))
    which = np.arange(m) % 3  # 0: x border, 1: y border, 2: both
    o = _origins(basis, np.where(which != 1, bx, cx0),
                 np.where(which != 0, by, cy0), rng.uniform(zlo, zhi, m))

    def integral(axis):
        g0, inv = params[axis], params[2 + axis]

        def value(oo):
            return (grid_project(oo, basis)[axis] - g0) * inv
        return value, lambda f: f == np.floor(f)

    vx, wx = integral(0)
    vy, wy = integral(1)
    on_x, on_y = which != 1, which != 0
    o[on_x], fx = _ulp_search(o[on_x], c_x, vx, wx)
    o[on_y], fy = _ulp_search(o[on_y], c_y, vy, wy)
    keep = np.ones(m, bool)
    keep[np.flatnonzero(on_x)[~fx]] = False
    keep[np.flatnonzero(on_y)[~fy]] = False
    # moving along c_y leaves px as it was: the x borders hold
    keep &= ~on_x | wx(vx(o))
    tmin, tmax = limits(m)
    o, tmin, tmax = o[keep], tmin[keep], tmax[keep]
    out["borders"] = _ray_set(o, sun, tmin, tmax, True)

    m = 63
    px, py = random_xy(m)
    side = rng.integers(0, 3, m)  # 0: x outside, 1: y outside, 2: both
    far_x = np.where(rng.random(m) < 0.5, params[0] - rng.uniform(
        0.01, 2, m) * span_x, params[0] + rng.uniform(1.01, 3, m) * span_x)
    far_y = np.where(rng.random(m) < 0.5, params[1] - rng.uniform(
        0.01, 2, m) * span_y, params[1] + rng.uniform(1.01, 3, m) * span_y)
    o = _origins(basis, np.where(side != 1, far_x, px),
                 np.where(side != 0, far_y, py), rng.uniform(zlo, zhi, m))
    tmin, tmax = limits(m)
    out["outside"] = _ray_set(o, sun, tmin, tmax, True)

    m = 33
    px, py = random_xy(m)
    o = _origins(basis, px, py, rng.uniform(zlo, zhi, m))
    o[np.arange(m), rng.integers(0, 3, m)] = np.nan
    tmin, tmax = limits(m)
    out["nan"] = _ray_set(o, sun, tmin, tmax, True)

    empty = np.flatnonzero(index == GRID_DONE)
    if empty.size:
        pick = rng.choice(empty, min(63, empty.size), replace=False)
        cx, cy = _cell_centres(params, pick % size, pick // size)
        o = _origins(basis, cx, cy,
                     rng.uniform(zlo, zhi, pick.size))
        tmin, tmax = limits(pick.size)
        out["empty_cell"] = _ray_set(o, sun, tmin, tmax, True)

    # thr on a record's suffix- and own-zmax: origins in cells whose chains
    # hold 2 or more records, below the record, t_min searched ulp by ulp
    lengths = _chain_lengths(table)
    heads = np.flatnonzero(index != GRID_DONE)
    long_heads = heads[lengths[~index[heads]] >= 2]
    pool = long_heads if long_heads.size else heads
    for name, slot in (("thr_suffix", GRID_SUFZ), ("thr_own", GRID_OWNZ)):
        m = 63
        cells = rng.choice(pool, m)
        rows = np.array([rng.choice(grid_chain(table, int(index[c])))
                         for c in cells])
        target = table[rows, slot]
        cx, cy = _cell_centres(params, cells % size, cells // size)
        o = _origins(basis, cx, cy,
                     target.astype(np.float64) - rng.uniform(0.5, 3.0, m))
        depth = grid_project(o, basis)[2]
        tmin = (target - depth).astype(f32)
        hit = (depth + tmin) == target
        for _ in range(64):
            if hit.all():
                break
            tmin = np.where(hit, tmin, np.where((depth + tmin) < target,
                                                np.nextafter(tmin, f32(np.inf)),
                                                np.nextafter(tmin,
                                                             f32(-np.inf))))
            hit = (depth + tmin) == target
        gx, gy = grid_cells(o, params, basis, size)
        keep = hit & (gy * size + gx == cells)
        tmax = rng.choice(f32([2.0, 1e30]), m)
        out[name] = _ray_set(o[keep], sun, tmin[keep], tmax[keep], True)

    # the longest chain, walked to its end by the rays that nothing blocks
    head_len = lengths[~index[heads]]
    longest = heads[head_len == head_len.max()]
    m = 65
    cells = rng.choice(longest, m)
    p = np.asarray(params, np.float64)
    cx = p[0] + (cells % size + rng.uniform(0.1, 0.9, m)) / p[2]
    cy = p[1] + (cells // size + rng.uniform(0.1, 0.9, m)) / p[3]
    o = _origins(basis, cx, cy,
                 np.full(m, float(own.min()) - 2.0))
    gx, gy = grid_cells(o, params, basis, size)
    keep = gy * size + gx == cells
    tmax = np.where(np.arange(m) % 2 == 0, f32(1e-6), f32(1e30))
    out["longest_chain"] = _ray_set(o[keep], sun, 0.0, tmax[keep], True)

    m = 161
    px, py = random_xy(m)
    o = _origins(basis, px, py, rng.uniform(zlo, zhi, m))
    tmin, tmax = limits(m)
    bad = rng.random(m) < 0.3
    tmax = np.where(bad, np.where(rng.random(m) < 0.5, tmin,
                                  tmin - f32(0.25)), tmax).astype(f32)
    active = rng.random(m) > 1 / 3
    active[:32] = False
    out["limits"] = _ray_set(o, sun, tmin, tmax, active)

    for name, m in (("ragged", 37), ("single", 1)):
        px, py = random_xy(m, 0.05)
        o = _origins(basis, px, py, rng.uniform(zlo, zhi, m))
        tmin, tmax = limits(m)
        out[name] = _ray_set(o, sun, tmin, tmax, True)
    return out


def concat_rays(sets):
    """One ray set of the sets (a dict of ray dicts), in order; (rays,
    {name: slice})."""
    slices, start = {}, 0
    for name, rays in sets.items():
        slices[name] = slice(start, start + len(rays["o"]))
        start += len(rays["o"])
    return ({f: np.concatenate([r[f] for r in sets.values()])
             for f in RAY_FIELDS}, slices)


# ---------------------------------------------------------------------------
# The seeded and binned routes' edge cases
# ---------------------------------------------------------------------------

def history_predictions(rays, hit_id, hit_t, occ_id, ntri, seed=0):
    """Predictions for temporal hit reuse on `rays` given the rays' true
    closest hits (hit_id, hit_t) and occluders (occ_id): per lane a true
    hit (2/5), -1 (1/5), a random triangle, mostly one the ray misses
    (1/5), or a true hit beyond t_max (1/5: t_max cut to half the hit's
    t); a fifth of the lanes made inactive. Returns (rays with that t_max
    and activity, closest predictions, occluder predictions)."""
    rng = np.random.default_rng(seed)
    n = len(hit_id)
    cat = rng.integers(0, 5, n)
    rand = rng.integers(0, ntri, n).astype(np.int32)
    out = {f: np.array(rays[f]) for f in RAY_FIELDS}
    beyond = (cat == 4) & (hit_id >= 0)
    out["tmax"] = np.where(beyond, hit_t * np.float32(0.5),
                           out["tmax"]).astype(np.float32)
    out["active"] = out["active"] & (rng.random(n) > 0.2)

    def mix(true):
        return np.select([cat <= 1, cat == 2, cat == 3], [true, -1, rand],
                         true).astype(np.int32)
    return out, mix(hit_id), mix(occ_id)


def _quad_tris(x0, x1, y0, y1, z):
    """Two triangles of an axis-aligned quad at depth z, (2, 3, 3)."""
    a, b = [x0, y0, z], [x1, y0, z]
    c, d = [x1, y1, z], [x0, y1, z]
    return np.array([[a, b, c], [a, c, d]], np.float32)


RASTER_STACK = 400  # quads stacked in front of one screen tile


def raster_edge_scene():
    """(v0, v1, v2) for the software raster's edge cases, seen by a camera
    at the origin looking down +z (FirstPersonCamera's default pose): a
    stack of RASTER_STACK small quads at z = 3 + 0.01 i in front of the
    screen's centre (one tile's list holds all 800 triangles: more than the
    JAX package's 64 + 256 levels before its tail), a quad repeated twice
    at z = 2 (equal t: the lower id wins), and last a floor triangle that
    crosses the near plane (binned by the clip at w = near). Triangle ids:
    the stack 0..799, the repeated quad 800..803, the floor 804. The top
    of the frame sees nothing (its tiles are empty)."""
    tris = [_quad_tris(-0.15, 0.15, -0.15, 0.05, 3.0 + 0.01 * i)
            for i in range(RASTER_STACK)]
    tris += [_quad_tris(-0.3, 0.3, 0.1, 0.3, 2.0)] * 2
    tris.append(np.array([[[-5, -1, -5], [5, -1, -5], [0, -1, 20]]],
                         np.float32))
    t = np.concatenate(tris)
    return t[:, 0].copy(), t[:, 1].copy(), t[:, 2].copy()


KCAND_STACK = 16  # stacked alpha cards of the K-candidate cases


def kcand_case_meshes():
    """(meshes, mask) of the K-candidate cases' scene: the floor (material
    0, triangles 0-1), KCAND_STACK cards stacked as in "alpha_stack"
    (material 1, triangles 2..), two coincident alpha cards at x = 4 and an
    opaque quad in their plane beside them."""
    floor = make_plane((20.0, 20.0), (0.0, -10.0, 0.0), material_idx=0)
    stack = [make_plane((2.0, 2.0), (-0.08 * k, -0.5 * k, 0.0),
                        material_idx=1) for k in range(KCAND_STACK)]
    twins = [make_plane((2.0, 2.0), (4.0, 0.0, 0.0), material_idx=1)
             for _ in range(2)]
    beside = make_plane((2.0, 2.0), (4.0, 0.0, 1.5), material_idx=0)
    return ([floor] + stack + twins + [beside],
            _band_mask([0.0, 0.0, 0.0, 1.0]))


def kcand_cases(seed=0, n=512):
    """{name: (rays, alpha table leaf size, K)} on `kcand_case_meshes`'
    scene (see the module docstring); every ray set is whole packets."""
    rng = np.random.default_rng(seed)
    out = {}
    # a ray at x0 crosses stacked card k at u = (x0 + 0.08 k + 1) / 2, the
    # mask opaque from u = 0.75 on
    o, d = _down_rays(rng, n, rng.uniform(-1.0, 0.6, n),
                      rng.uniform(-0.9, 0.9, n), tilt=0.02)
    out["overflow"] = (pad_to_packets(_alpha_rays(rng, o, d)), 12, 8)
    o, d = _down_rays(rng, n, rng.uniform(-0.98, -0.3, n),
                      rng.uniform(-0.9, 0.9, n), tilt=0.005)
    out["all_rejected"] = (pad_to_packets(_alpha_rays(rng, o, d)), 2, 8)
    o, d = _down_rays(rng, n, rng.uniform(3.1, 4.9, n),
                      rng.uniform(-0.9, 2.4, n), tilt=0.05)
    out["equal_t"] = (pad_to_packets(_alpha_rays(rng, o, d)), 2, 4)
    o, d = _down_rays(rng, 2 * PACKET, rng.uniform(-1.0, 0.6, 2 * PACKET),
                      rng.uniform(-0.9, 0.9, 2 * PACKET), tilt=0.02)
    rays = _alpha_rays(rng, o, d)
    rays["active"][:PACKET] = False
    rays["active"][PACKET:] = True
    out["inactive"] = (rays, 2, 8)
    o, d = _down_rays(rng, n, rng.uniform(-1.0, 0.6, n),
                      rng.uniform(-0.9, 0.9, n), tilt=0.02)
    out["k1"] = (pad_to_packets(_alpha_rays(rng, o, d)), 2, 1)
    return out
