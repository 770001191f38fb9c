"""Multi-device rendering: pixel rows, samples, or both, over a list of
devices.

The port of dxrpathtracer_tpu/parallel/mesh.py. Rays are independent, so a
frame splits with no collective in the hot loop: the scene, both tables,
the sky, the frame constants and the engines' structures are replicated
(each goes to a shard's device through its own `.to`, free where it is
there already), the accumulation is sharded, and each shard traces only
its own rows or its own samples. The image is gathered on readback.

One process drives every shard, as the JAX single controller does: a step
launches shard after shard from the host, with no synchronisation between
them. A device may appear more than once in a mesh, which is how one card
holds several shards.

  - A mesh (`RenderMesh`) is a frozen grid of `torch.device`s, 1-D or 2-D
    (samples, rows), with its axis names. `make_render_mesh()` takes every
    CUDA device and raises where there is none; the CPU is only ever
    named (`["cpu"] * n`).
  - A sharded array is a list of per-shard tensors, nested as the mesh's
    devices: array dim k is split over mesh axis k, as the JAX package's
    PartitionSpec(axis0, axis1) places it. `shard_accum` splits and places
    one; `gather_shards` concatenates it back on one device (the
    readback's all-gather).
  - Pixel indices and NDC stay the frame's in every row shard
    (render_sample's `row_offset`, `total_height`), and texel indices the
    lightmap's in every bake shard (bake_sample's `row_offset`,
    `total_texels`), so a sharded render equals the unsharded one. Where a
    shard's height changes the packet tiles (integrator._packet_tile_dims)
    other packets form, and a grazing lane may find another hit.

The JAX package's padding of each shard's raster bins to equal static
shapes (`stack_raster_slabs` with `pad_to`) is a shard_map requirement:
here each shard keeps its own RasterBins (`raster_shards`).
"""

import dataclasses

import numpy as np
import torch

from ..bake.baker import MAX_SLAB_TEXELS, bake_sample
from ..render.integrator import _packet_tile_dims, render_sample
from ..render.swraster import build_raster_bins


@dataclasses.dataclass(frozen=True)
class RenderMesh:
    """Devices on a 1-D or 2-D grid with one name per axis. `devices` is a
    tuple of torch.device (1-D) or a tuple of such tuples (2-D, axis 0
    first); any nesting of device names is accepted and normalised."""

    devices: tuple
    axis_names: tuple

    def __post_init__(self):
        names = tuple(self.axis_names)
        if len(names) not in (1, 2) or len(set(names)) != len(names):
            raise ValueError(f"a mesh has one or two distinct axes, got "
                             f"{names}")
        grid = np.asarray(self.devices, dtype=object)
        if grid.ndim != len(names) or grid.size == 0:
            raise ValueError(f"devices of shape {grid.shape} for axes "
                             f"{names}")
        devs = (tuple(torch.device(d) for d in grid) if grid.ndim == 1
                else tuple(tuple(torch.device(d) for d in row)
                           for row in grid))
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", names)

    @property
    def shape(self) -> dict:
        """{axis name: shards along it}."""
        dims = ((len(self.devices),) if len(self.axis_names) == 1
                else (len(self.devices), len(self.devices[0])))
        return dict(zip(self.axis_names, dims))

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def flat(self) -> list:
        """Every shard's device, axis 0 outermost."""
        if len(self.axis_names) == 1:
            return list(self.devices)
        return [d for row in self.devices for d in row]


def make_render_mesh(devices=None, axis_name: str = "rows") -> RenderMesh:
    """A 1-D mesh over `devices`, by default every CUDA device (raises
    where there is none). A device may be named more than once."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("make_render_mesh: no CUDA device (name the "
                               "devices, e.g. ['cpu'] * 4, to shard on "
                               "them)")
        devices = [torch.device("cuda", i) for i in range(n)]
    return RenderMesh(tuple(devices), (axis_name,))


def _check_axis(mesh: RenderMesh, axis_name: str):
    if axis_name not in mesh.axis_names:
        raise ValueError(f"the mesh has axes {mesh.axis_names}, not "
                         f"{axis_name!r}")


def _row_block(mesh: RenderMesh, axis_name: str, height: int) -> int:
    _check_axis(mesh, axis_name)
    n = mesh.shape[axis_name]
    if height % n != 0:
        raise ValueError(f"height {height} does not divide over {n} shards "
                         f"of axis {axis_name!r}")
    return height // n


def shard_accum(mesh: RenderMesh, accum, axis_name: str = "rows"):
    """An array split over the mesh and placed on its devices: dim k over
    mesh axis k (`axis_name` names axis 0). A (H, W, 3) image on a row
    mesh gives each shard its rows; a (n, H, W, 3) stack on a sample mesh
    gives each a (1, H, W, 3) block; a (S, H, W, 3) stack on a (samples,
    rows) mesh gives shard (s, r) sample s's rows r."""
    if mesh.axis_names[0] != axis_name:
        raise ValueError(f"axis 0 of the mesh is {mesh.axis_names[0]!r}, "
                         f"not {axis_name!r}")

    def split(x, dim, devs):
        n = len(devs)
        if x.shape[dim] % n != 0:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not "
                             f"divide over {n} shards")
        return list(torch.chunk(x, n, dim=dim))

    if len(mesh.axis_names) == 1:
        return [b.to(d).contiguous() for b, d in
                zip(split(accum, 0, mesh.devices), mesh.devices)]
    return [[b.to(d).contiguous() for b, d in zip(split(row, 1, devs), devs)]
            for row, devs in zip(split(accum, 0, mesh.devices),
                                 mesh.devices)]


def gather_shards(mesh: RenderMesh, shards, device="cpu"):
    """The array of a sharded list on one device: blocks concatenate along
    dim k over mesh axis k (rows join, a sample stack keeps its leading
    axis)."""
    device = torch.device(device)
    if len(mesh.axis_names) == 1:
        return torch.cat([b.to(device) for b in shards], dim=0)
    return torch.cat([torch.cat([b.to(device) for b in row], dim=1)
                      for row in shards], dim=0)


def sample_parallel_image(accum):
    """The equal-weight mean over the leading (sample) axis of a gathered
    sample-parallel accumulation: every shard holds the same number of
    samples, so the mean of its running means is the mean over all."""
    return accum.mean(dim=0)


def _on(x, device):
    """A replicated structure on a shard's device (None stays None)."""
    return None if x is None else x.to(device)


def raster_shards(mesh: RenderMesh, positions, tri_idx, view_proj, near,
                  width: int, height: int, tri_table, opaque_tris=None,
                  axis_name: str = "rows") -> list:
    """One RasterBins per row shard of a width x height frame (the bins of
    its row block in the packet tiles of its height, on its device), for
    make_sharded_step's `raster`: the counterpart of the JAX package's
    stack_raster_slabs, without its padding to equal shapes. None where a
    shard's height takes no 128-pixel tile."""
    rows = _row_block(mesh, axis_name, height)
    dims = _packet_tile_dims(rows, width)
    if dims is None:
        return None
    return [build_raster_bins(positions, tri_idx, view_proj, near, width,
                              height, *dims, tri_table,
                              opaque_tris=opaque_tris, row0=i * rows,
                              rows=rows).to(dev)
            for i, dev in enumerate(mesh.devices)]


def make_sharded_step(mesh: RenderMesh, settings, width: int, height: int,
                      axis_name: str = "rows"):
    """A row-sharded render step over a 1-D mesh.

    Returns step(scene, bvh, accum, sky_cube, frame, ray_bvh=None,
    sun_grid=None, raster=None, alpha_bvh=None, proxy=None, cut=None) ->
    the new sharded accumulation, where `accum` is a row-sharded (H, W, 3)
    image (shard_accum), `raster` one RasterBins per shard
    (raster_shards) and every other argument is replicated. `ray_bvh`
    defaults to `bvh`. Shard i renders rows [i*H/n, (i+1)*H/n)."""
    rows = _row_block(mesh, axis_name, height)

    def step(scene, bvh, accum, sky_cube, frame, ray_bvh=None,
             sun_grid=None, raster=None, alpha_bvh=None, proxy=None,
             cut=None):
        out = []
        for i, dev in enumerate(mesh.devices):
            out.append(render_sample(
                scene.to(dev), bvh.to(dev), _on(ray_bvh or bvh, dev),
                sky_cube.to(dev), settings, frame.to(dev), width, rows,
                accum[i], sun_grid=_on(sun_grid, dev), proxy=_on(proxy, dev),
                cut=_on(cut, dev),
                raster=None if raster is None else raster[i],
                alpha_bvh=_on(alpha_bvh, dev), row_offset=i * rows,
                total_height=height))
        return out

    return step


def _slab_rows(rows: int, resolution: int) -> int:
    """Baker's slab rows, within a shard of `rows` texel rows."""
    slab = max(1, min(rows, MAX_SLAB_TEXELS // resolution))
    while rows % slab != 0:
        slab -= 1
    return slab


def make_sharded_bake_step(mesh: RenderMesh, settings, resolution: int,
                           axis_name: str = "rows"):
    """A texel-row-sharded lightmap bake step over a 1-D mesh (the
    reference's DispatchRays(4096, 4096), DXRPathTracer.cpp:1974-1985).

    Returns step(scene, bvh, accum, sky_cube, frame, pos, nrm,
    sample_index, sun_grid=None, proxy=None) -> the new sharded
    accumulation, where `accum` (S, S, 4), `pos` (S, S, 4) and `nrm`
    (S, S, 3) are row-sharded (shard_accum) and the rest replicated. Each
    shard walks its rows in slabs of at most MAX_SLAB_TEXELS, Baker's slab
    rows where they divide the shard, so where the slab boundaries are
    Baker.bake_step's the sharded bake equals it. Bake rays take the table
    given as `bvh` (the session's W32 `bvh_ray`, as Baker passes)."""
    rows = _row_block(mesh, axis_name, resolution)
    slab = _slab_rows(rows, resolution)
    total = resolution * resolution

    def step(scene, bvh, accum, sky_cube, frame, pos, nrm, sample_index,
             sun_grid=None, proxy=None):
        out = []
        for i, dev in enumerate(mesh.devices):
            args = (scene.to(dev), bvh.to(dev), sky_cube.to(dev), settings,
                    frame.to(dev))
            grid, prox = _on(sun_grid, dev), _on(proxy, dev)
            block = accum[i].clone()
            for r in range(0, rows, slab):
                block[r:r + slab] = bake_sample(
                    *args, pos[i][r:r + slab], nrm[i][r:r + slab],
                    block[r:r + slab], int(sample_index),
                    row_offset=i * rows + r, total_texels=total,
                    sun_grid=grid, proxy=prox)
            out.append(block)
        return out

    return step


def make_sample_parallel_step(mesh: RenderMesh, settings, width: int,
                              height: int, axis_name: str = "samples"):
    """A sample-parallel render step over a 1-D mesh of n shards: shard d
    renders the whole frame at global CMJ sample step*n + d into its own
    running mean, which after k steps holds k samples.

    Returns step(scene, bvh, accum, sky_cube, frame, ray_bvh=None,
    sun_grid=None) -> the new sharded accumulation, where
    `frame.curr_sample_idx` is the step index and `accum` a (n, H, W, 3)
    stack sharded on its first axis (shard_accum). The image after k steps
    is sample_parallel_image(gather_shards(mesh, accum))."""
    _check_axis(mesh, axis_name)
    n = mesh.shape[axis_name]

    def step(scene, bvh, accum, sky_cube, frame, ray_bvh=None,
             sun_grid=None):
        step_idx = int(frame.curr_sample_idx)
        out = []
        for d, dev in enumerate(mesh.devices):
            f = dataclasses.replace(frame.to(dev),
                                    curr_sample_idx=step_idx * n + d)
            out.append(render_sample(
                scene.to(dev), bvh.to(dev), _on(ray_bvh or bvh, dev),
                sky_cube.to(dev), settings, f, width, height, accum[d][0],
                sun_grid=_on(sun_grid, dev),
                accum_sample_idx=step_idx)[None])
        return out

    return step


def make_grid_step(mesh: RenderMesh, settings, width: int, height: int,
                   sample_axis: str = "samples", row_axis: str = "rows"):
    """A render step over a 2-D (sample_axis, row_axis) mesh: shard (s, r)
    renders rows [r*H/R, (r+1)*H/R) of global CMJ sample step*S + s into
    its own running mean.

    Returns step(scene, bvh, accum, sky_cube, frame, ray_bvh=None,
    sun_grid=None) -> the new sharded accumulation, where
    `frame.curr_sample_idx` is the step index and `accum` a (S, H, W, 3)
    stack sharded over (sample_axis, row_axis) (shard_accum). The image is
    sample_parallel_image(gather_shards(mesh, accum))."""
    if mesh.axis_names != (sample_axis, row_axis):
        raise ValueError(f"want a ({sample_axis!r}, {row_axis!r}) mesh, got "
                         f"{mesh.axis_names}")
    s_dev = mesh.shape[sample_axis]
    rows = _row_block(mesh, row_axis, height)

    def step(scene, bvh, accum, sky_cube, frame, ray_bvh=None,
             sun_grid=None):
        step_idx = int(frame.curr_sample_idx)
        out = []
        for s, devs in enumerate(mesh.devices):
            row_out = []
            for r, dev in enumerate(devs):
                f = dataclasses.replace(frame.to(dev),
                                        curr_sample_idx=step_idx * s_dev + s)
                row_out.append(render_sample(
                    scene.to(dev), bvh.to(dev), _on(ray_bvh or bvh, dev),
                    sky_cube.to(dev), settings, f, width, rows,
                    accum[s][r][0], sun_grid=_on(sun_grid, dev),
                    row_offset=r * rows, total_height=height,
                    accum_sample_idx=step_idx)[None])
            out.append(row_out)
        return out

    return step
