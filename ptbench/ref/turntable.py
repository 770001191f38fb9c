"""The reference of a turntable cell: one displayed frame of a turn, the
accumulation of chosen pixels over its samples.

Frame f of a turn of F frames turns the whole scene by the float32 angle
2 pi f / F about the vertical axis through the middle of its x and z
extents (at y = 0): positions, normals, tangents, bitangents and the spot
lights' positions and directions. A new tree (ref/bvh.py) is built over
the turned triangles, and the frame's samples 0 .. spp - 1 are rendered
with ref/integrator.py under the unturned camera, sun and sky
(ref/common.world's) and folded as ref/frame.accumulate folds them.

Departures, each the program's own rounding (dxrpathtracer_tpu_torch/
scene/animate.py:64-81, `rotate_scene_y`), copied so that the turned
vertices are the program's bit for bit:
  - cos and sin are glibc's float32 cosf and sinf of the float32 angle,
    called through ctypes, not torch's or numpy's;
  - each product and sum is its own torch op in float32, in the program's
    order (no fused multiply-add), about the float32 axis point.
The tree is the reference's, not the program's morton W8 table, so of two
triangles hit at exactly the same t the two sides may report different
ones. With `storage` below float32 (the control, ptbench/calibrate.py) the
turned normals, tangents and bitangents are rounded to it again, as every
other table of ref/scene.py is; the positions and lights are not, as there.
"""

import ctypes
import ctypes.util
import dataclasses
import functools

import numpy as np
import torch

from .bvh import build as build_bvh
from .common import chunks, world
from .integrator import raygen, trace_paths
from .scene import _stored

LANES = 1 << 19  # paths traced per call


@functools.cache
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    for name in ("cosf", "sinf"):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return lib


def angle(frame: int, frames_per_turn: int) -> np.float32:
    return np.float32(2.0 * np.pi * frame / frames_per_turn)


def axis_point(positions: np.ndarray) -> np.ndarray:
    """The middle of the x and z extents of (V, 3) float32 positions, at
    y = 0, in float32."""
    lo, hi = positions.min(axis=0), positions.max(axis=0)
    return np.array([(lo[0] + hi[0]) / 2, 0.0, (lo[2] + hi[2]) / 2],
                    np.float32)


def _points(p, c, s, center):
    x = p[:, 0] - center[0]
    z = p[:, 2] - center[2]
    return torch.stack([center[0] + c * x + s * z, p[:, 1],
                        center[2] - s * x + c * z], 1)


def _dirs(d, c, s):
    return torch.stack([c * d[:, 0] + s * d[:, 2], d[:, 1],
                        -s * d[:, 0] + c * d[:, 2]], 1)


def turn_scene(scene, theta, center, storage=torch.float32):
    """The RefScene turned by the float32 angle `theta` about the vertical
    axis through `center`."""
    lib = _libm()
    c, s = lib.cosf(float(theta)), lib.sinf(float(theta))
    center = [float(v) for v in np.asarray(center, np.float32)]
    lights = dict(scene.lights)
    if scene.num_lights:
        lights["position"] = _points(lights["position"], c, s, center)
        lights["direction"] = _dirs(lights["direction"], c, s)
    return dataclasses.replace(
        scene, positions=_points(scene.positions, c, s, center),
        normals=_stored(_dirs(scene.normals, c, s), storage),
        tangents=_stored(_dirs(scene.tangents, c, s), storage),
        bitangents=_stored(_dirs(scene.bitangents, c, s), storage),
        lights=lights)


def accumulate(desc, config, traffic, pixel_idx, frame: int, device,
               storage=torch.float32):
    """(P, 3) f32: the accumulation at the pixels `pixel_idx` ((P,) int64,
    row major) of displayed frame `frame` of the configuration's turn:
    its samples 0 .. samples_per_frame - 1 from a zero image."""
    turn = config["turntable"]
    spp = int(turn["samples_per_frame"])
    scene, _, cube, s, view = world(desc, config, traffic, device, storage)
    center = axis_point(scene.positions.cpu().numpy())
    scene = turn_scene(scene, angle(frame, int(turn["frames_per_turn"])),
                       center, storage)
    bvh = build_bvh(scene.positions.cpu().numpy(),
                    scene.tri_idx.cpu().numpy()).to(device)
    width, height = int(config["width"]), int(config["height"])
    pix = torch.as_tensor(pixel_idx, dtype=torch.int64, device=device)
    p = pix.shape[0]
    lanes_pix = pix.repeat(spp)
    lanes_smp = (torch.arange(spp, dtype=torch.int64, device=device)
                 .repeat_interleave(p))
    radiance = torch.empty((spp * p, 3), dtype=torch.float32, device=device)
    for lo, hi in chunks(spp * p, LANES):
        o, d, t_max = raygen(s, view, width, height, lanes_pix[lo:hi],
                             lanes_smp[lo:hi])
        radiance[lo:hi] = trace_paths(
            scene, bvh, cube, s, view, o, d, t_max, lanes_pix[lo:hi],
            width * height, lanes_smp[lo:hi], first_set_idx=1)
    radiance = radiance.reshape(spp, p, 3)
    accum = torch.zeros((p, 3), dtype=torch.float32, device=device)
    for k in range(spp):
        idx = np.float32(k)
        lerp_factor = float(idx / (idx + np.float32(1.0)))
        accum = radiance[k] + (accum - radiance[k]) * lerp_factor
        if storage != torch.float32:
            accum = accum.to(storage).to(torch.float32)
    return accum
