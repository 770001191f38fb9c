"""Clustered spot-light binning — froxel grid light masks.

The port of dxrpathtracer_tpu/render/clusters.py (the reference's cluster
pass, RenderClusters/UpdateLights, DXRPathTracer.cpp:1574-1747 +
Clusters.hlsl:54-128): a 16x16-pixel x 16-Z froxel grid holds a spot-light
mask per cluster. Every (froxel, light) pair is tested with the reference's
sphere/cone predicate (SphereConeIntersection, DXRPathTracer.cpp:200-217)
against the froxel's bounding sphere; the InterlockedOr becomes a sum over
the light axis, each light owning one bit.

The froxel spheres are host numpy (camera-rate work); the masks are torch
ops on the lights' device. Masks are int64 (bit 31 stays positive; torch's
uint32 has few CPU ops) and equal the JAX package's uint32 as integers. The
cone's cos, sin and arccos and the sqrt round once from float64 (core/math3)
so that CPU and card give the same bits.

Z partition parity: zTile = saturate((depthVS - near) / (far - near)) * NumZTiles
(Shading.hlsl:128-133).
"""

import numpy as np
import torch

from ..app.settings import CLUSTER_TILE_SIZE, NUM_Z_TILES
from ..core.math3 import arccos, cos, dot, sin, sqrt


def froxel_bounding_spheres(width, height, camera):
    """(n_clusters, 4) [center xyz | radius] world-space bounding spheres of
    every froxel, host-side numpy (camera-update-rate work, like the
    reference's per-frame cluster bounds setup), and the grid dims."""
    nx = -(-width // CLUSTER_TILE_SIZE)
    ny = -(-height // CLUSTER_TILE_SIZE)
    nz = NUM_Z_TILES
    near, far = camera.near_clip, camera.far_clip

    world = camera.world_matrix()
    right3, up3, fwd3 = world[0, :3], world[1, :3], world[2, :3]
    cam_pos = camera.position

    tan_half_fov = np.tan(camera.fov * 0.5)
    tan_half_fov_x = tan_half_fov * camera.aspect

    xs = np.arange(nx)
    ys = np.arange(ny)
    zs = np.arange(nz)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    gx = gx.reshape(-1)
    gy = gy.reshape(-1)
    gz = gz.reshape(-1)

    # Linear view-space depth slabs (Shading.hlsl:128-130)
    z0 = near + (far - near) * gz / nz
    z1 = near + (far - near) * (gz + 1) / nz

    # NDC extents of the tile (pixel tiles may overhang the right/bottom edge)
    x0 = np.minimum(gx * CLUSTER_TILE_SIZE / width, 1.0) * 2.0 - 1.0
    x1 = np.minimum((gx + 1) * CLUSTER_TILE_SIZE / width, 1.0) * 2.0 - 1.0
    # y NDC flips vs pixel rows
    y0 = 1.0 - np.minimum((gy + 1) * CLUSTER_TILE_SIZE / height, 1.0) * 2.0
    y1 = 1.0 - np.minimum(gy * CLUSTER_TILE_SIZE / height, 1.0) * 2.0

    def corner(xn, yn, z):
        vx = xn * tan_half_fov_x * z
        vy = yn * tan_half_fov * z
        return (cam_pos[None, :] + vx[:, None] * right3[None, :]
                + vy[:, None] * up3[None, :] + z[:, None] * fwd3[None, :])

    corners = np.stack([corner(xc, yc, zc)
                        for xc in (x0, x1) for yc in (y0, y1) for zc in (z0, z1)])
    center = corners.mean(axis=0)
    radius = np.linalg.norm(corners - center[None], axis=-1).max(axis=0)
    return np.concatenate([center, radius[:, None]], -1).astype(np.float32), (nx, ny, nz)


def sphere_cone_intersection(cone_tip, cone_dir, cone_height, cone_angle,
                             centers, radii):
    """SphereConeIntersection (DXRPathTracer.cpp:200-217) over every
    (cluster, light) pair.

    cone_*: per-light (L, ...) tensors; centers (C, 3), radii (C,).
    Returns (C, L) bool.
    """
    v = centers[:, None, :] - cone_tip[None, :, :]          # (C, L, 3)
    a = dot(v, cone_dir[None, :, :])                         # (C, L)
    beyond = a > (cone_height[None, :] + radii[:, None])

    cos_h = cos(cone_angle * 0.5)[None, :]
    sin_h = sin(cone_angle * 0.5)[None, :]
    b = a * sin_h / cos_h
    c = sqrt(torch.clamp_min(dot(v, v) - a * a, 0.0))
    e = (c - b) * cos_h
    return (~beyond) & (e < radii[:, None])


# ClusterRasterizationModes (AppSettings.cs / DXRPathTracer.cpp:1651-1747):
# the reference rasterizes low-res light-cone proxies, so its modes trade
# missed froxels for speed (Normal < MSAA4x < MSAA8x < Conservative). The
# analytic binning's equivalent accuracy ladder scales the froxel bounding
# radius tested against the cone: 0 = froxel center point only, 1/2 =
# fractional radius, 3 = full bounding sphere (conservative, the default).
_CLUSTER_MODE_RADIUS_SCALE = (0.0, 0.5, 0.75, 1.0)


def build_cluster_masks(lights, froxel_spheres, mode: int = 3):
    """(n_clusters,) int64 light masks (bit i: light i) from SpotLights (on
    the device the masks are built on) and froxel_bounding_spheres' host
    array.

    A light's bounding cone uses the outer attenuation angle and its range
    (UpdateLights, DXRPathTracer.cpp:1606-1612). `mode` is
    ClusterRasterizationMode — see _CLUSTER_MODE_RADIUS_SCALE.
    """
    dev = lights.position.device
    n_lights = lights.num_lights
    spheres = torch.from_numpy(np.ascontiguousarray(froxel_spheres)).to(dev)
    centers = spheres[:, :3]
    scale = _CLUSTER_MODE_RADIUS_SCALE[int(np.clip(mode, 0, 3))]
    radii = spheres[:, 3] * scale
    n_clusters = centers.shape[0]
    if n_lights == 0:
        return torch.zeros(n_clusters, dtype=torch.int64, device=dev)

    tip = lights.position[:n_lights]
    # Stored direction is surface->light convention negated at load; the cone
    # axis points WITH the light (away from the aperture): -direction
    axis = -lights.direction[:n_lights]
    height = lights.range[:n_lights]
    # outer cone angle = 2 * acos(AngularAttenuationY)
    angle = 2.0 * arccos(torch.clamp(lights.angular_attenuation_y[:n_lights],
                                     -1.0, 1.0))

    hit = sphere_cone_intersection(tip, axis, height, angle, centers, radii)
    bits = hit.to(torch.int64) << torch.arange(n_lights, device=dev)[None, :]
    # Each light owns a distinct bit, so summing equals InterlockedOr.
    return bits.sum(dim=1)
