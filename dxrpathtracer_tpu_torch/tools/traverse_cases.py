"""Adversarial inputs for the BVH walk: scenes and rays whose walks reach
every tie rule of the traversal. numpy only, made from a seed.

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
"""

import numpy as np

from ..scene.procedural import make_plane

CUBE_LO = np.array([-2.0, 1.0, -2.0], np.float32)   # the block of cubes
CUBE_DIMS = (4, 2, 4)
FLOOR_HALF = 8                                       # floor spans [-8, 8]^2
REPEATED = 64                                        # triangles, 3 copies each


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
