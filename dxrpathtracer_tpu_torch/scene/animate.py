"""Dynamic (animated) geometry: a rigid turntable of the whole scene on its
device, and the per-frame W8 table built there too.

The port of dxrpathtracer_tpu/scene/animate.py. The reference rebuilds its
acceleration structures on the GPU (DXRPathTracer.cpp:2331-2488), which is
what makes animated geometry possible on that stack; here every frame
rotates the scene's tensors (`rotate_scene_y`) and builds the morton W8
table from them on the same device (accel/device_build.py), so geometry
never goes back to the host. `Turntable.frame` is one displayed frame of a
turn on a RenderSession, the one entry that users reach through `python -m
dxrpathtracer_tpu_torch animate`. Traced (app/profiler.py), it is the span
`turntable`, its stages `turntable.rotate`, `.build`, `.geometry`,
`.samples` and `.display`.

Bits: the rotation's cos and sin are glibc's float32 cosf/sinf of the
float32 angle, called through ctypes: XLA:CPU's float32 cos/sin are those
functions (equal on 200,000 angles in [0, 2pi)), which are not correctly
rounded (about 1.3 % of those angles differ from the float64 value rounded
to float32), so the port's own sin/cos (core/math3.py) would rotate some
frames by another last bit. Every product and sum is its own torch op, each
rounded once, as the JAX reference does without FMA.
"""

import ctypes
import ctypes.util
import dataclasses
import functools

import numpy as np
import torch

from ..accel.bvh import FlatBVH
from ..accel.device_build import LBVHPlan, build_bvh_device, lbvh_plan
from ..app.profiler import span
from .types import TRI_SHADE_VTX, Scene


@functools.cache
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    for name in ("cosf", "sinf"):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return lib


def _cos_sin(theta) -> tuple[float, float]:
    """(cos, sin) of the float32 angle `theta` as float32 values."""
    lib = _libm()
    t = float(np.float32(theta))
    return lib.cosf(t), lib.sinf(t)


def _rotate_y_points(p, c, s, center):
    """Rotate (N, 3) points about the vertical axis through `center`."""
    x = p[:, 0] - center[0]
    z = p[:, 2] - center[2]
    return torch.stack([center[0] + c * x + s * z, p[:, 1],
                        center[2] - s * x + c * z], 1)


def _rotate_y_dirs(d, c, s):
    return torch.stack([c * d[:, 0] + s * d[:, 2], d[:, 1],
                        -s * d[:, 0] + c * d[:, 2]], 1)


def rotate_scene_y(scene: Scene, theta, center) -> Scene:
    """Rigid rotation by `theta` (radians, float32) of all geometry and the
    spot lights about the vertical axis through `center` (3 floats, taken
    as float32), on the scene's device. The packed tri_shade rows' vertex
    blocks are rebuilt from the rotated attributes; their material and
    meta tail ([3*TRI_SHADE_VTX:], int32 payloads) is kept bit for bit."""
    c, s = _cos_sin(theta)
    center = [float(v) for v in np.asarray(center, np.float32)]
    pos = _rotate_y_points(scene.positions, c, s, center)
    nrm = _rotate_y_dirs(scene.normals, c, s)
    tan = _rotate_y_dirs(scene.tangents, c, s)
    bit = _rotate_y_dirs(scene.bitangents, c, s)

    i32 = torch.int32
    tri = scene.tri_idx.long()
    blocks = []
    for vslot in range(3):
        sel = tri[:, vslot]
        blk = torch.cat([pos[sel], nrm[sel], scene.uvs[sel], tan[sel],
                         bit[sel]], 1)
        assert blk.shape[1] == TRI_SHADE_VTX
        blocks.append(blk.view(i32))
    tail = scene.tri_shade.view(i32)[:, 3 * TRI_SHADE_VTX:]
    tri_shade = torch.cat(blocks + [tail], 1).view(torch.float32)

    lights = dataclasses.replace(
        scene.lights,
        position=_rotate_y_points(scene.lights.position, c, s, center),
        direction=_rotate_y_dirs(scene.lights.direction, c, s))
    return dataclasses.replace(scene, positions=pos, normals=nrm,
                               tangents=tan, bitangents=bit,
                               tri_shade=tri_shade, lights=lights)


def turntable_center(positions: np.ndarray) -> np.ndarray:
    """The turntable's axis point: the middle of the scene's x and z
    extents, at y = 0 (float32, as the JAX `animate` command takes it)."""
    lo, hi = positions.min(axis=0), positions.max(axis=0)
    return np.array([(lo[0] + hi[0]) / 2, 0.0, (lo[2] + hi[2]) / 2],
                    np.float32)


def triangle_vertices(scene: Scene):
    """(v0, v1, v2), each (T, 3), of the scene's triangles, on its device."""
    tri = scene.tri_idx.long()
    return tuple(scene.positions[tri[:, k]] for k in range(3))


def turntable_geometry(scene: Scene, theta, center,
                       plan: LBVHPlan) -> tuple[Scene, FlatBVH]:
    """One animation frame: the scene rotated by `theta` and its W8 table
    built on the device (no alpha flags: a walk with the alpha test then
    tests every candidate's material)."""
    with span("turntable.rotate"):
        rotated = rotate_scene_y(scene, theta, center)
    with span("turntable.build"):
        bvh = build_bvh_device(*triangle_vertices(rotated), plan)
    return rotated, bvh


class Turntable:
    """A turn of `frames_per_turn` frames of a RenderSession's scene about
    the vertical axis through its x/z centre (`turntable_center`), the W8
    table rebuilt on the session's device every frame. Holds the unturned
    scene, the axis point and the LBVH plan of its triangle count."""

    def __init__(self, session, frames_per_turn: int):
        self.session = session
        self.frames_per_turn = int(frames_per_turn)
        self.base = session.scene
        self.center = turntable_center(session.scene_host.positions.numpy())
        self.plan = lbvh_plan(session.scene.num_triangles)

    def angle(self, f: int) -> np.float32:
        """Frame f's angle, 2 pi f / frames_per_turn, as float32."""
        return np.float32(2.0 * np.pi * f / self.frames_per_turn)

    def frame(self, f: int, spp: int) -> torch.Tensor:
        """Displayed frame f of the turn: the scene rotated by `angle(f)`,
        its table built on the device, the session switched to both
        (`use_geometry`: the accumulation restarts at sample 0) and `spp`
        samples rendered; returns `display_image()`, on the device."""
        sess = self.session
        with span("turntable"):
            scene, bvh = turntable_geometry(self.base, self.angle(f),
                                            self.center, self.plan)
            with span("turntable.geometry"):
                sess.use_geometry(scene, bvh)
            with span("turntable.samples"):
                sess.render_to_completion(spp)
            with span("turntable.display"):
                return sess.display_image()
