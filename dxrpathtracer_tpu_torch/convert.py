"""Turn the JAX package's host arrays into the port's objects.

The parity tests build one scene, its BVH tables, the sky cube and the frame
constants with dxrpathtracer_tpu, read them back as numpy arrays, and feed the
very same values to both packages through these functions. The learned
denoiser's weights are the port's copy of the JAX package's data file, read
with np.load. This module imports no JAX: callers pass plain numpy arrays and
Python numbers.
"""

from pathlib import Path

import numpy as np
import torch

from .accel.bvh import LEAF_SIZE, FlatBVH
from .accel.proxy import AABBCut, DenseProxy
from .accel.sunspace import SunGrid
from .render.integrator import (FrameConstants, _packet_tile_dims,
                                _tile_order, _untile_order)
from .scene.types import LIGHT_ARRAYS, SCENE_ARRAYS, Scene, SpotLights


def scene_from_numpy(arrays: dict[str, np.ndarray],
                     lights: SpotLights | None = None) -> Scene:
    """Scene (CPU tensors, copies) from a dict holding every name in
    scene.types.SCENE_ARRAYS; no spot lights unless given."""
    return Scene.from_numpy({k: np.array(arrays[k]) for k in SCENE_ARRAYS},
                            lights=lights)


def reference_scene_arrays(scene) -> dict[str, np.ndarray]:
    """The JAX package's Scene with host leaves (its load_scene and registry
    scenes) as the port's named arrays: SCENE_ARRAYS, then "light_" +
    LIGHT_ARRAYS and "num_lights". Reads attributes only; imports no JAX."""
    out = dict(
        positions=scene.positions, normals=scene.normals, uvs=scene.uvs,
        tangents=scene.tangents, bitangents=scene.bitangents,
        tri_idx=scene.tri_idx, tri_material=scene.tri_material,
        tri_shade=scene.tri_shade, texels=scene.textures.texels,
        texture_meta=scene.textures.meta,
        packed_meta=scene.materials.packed_meta,
        has_opacity=scene.materials.has_opacity)
    for k in LIGHT_ARRAYS:
        out["light_" + k] = getattr(scene.lights, k)
    out["num_lights"] = scene.lights.num_lights
    return {k: np.asarray(v) for k, v in out.items()}


def scene_from_reference_arrays(arrays: dict[str, np.ndarray]) -> Scene:
    """The port's Scene from `reference_scene_arrays`' dict (or the same
    names read back from an .npz)."""
    lights = SpotLights.from_numpy(
        {k: arrays["light_" + k] for k in LIGHT_ARRAYS},
        int(arrays["num_lights"]))
    return scene_from_numpy(arrays, lights=lights)


def bvh_from_numpy(table, num_rows: int, max_depth: int, root_code: int,
                   width: int, has_alpha_flags: bool = False,
                   leaf_size: int = LEAF_SIZE) -> FlatBVH:
    """FlatBVH (CPU tensor) from a (rows, 128) f32 table and its constants
    (the JAX FlatBVH's num_rows, max_depth, root_code, width,
    has_alpha_flags and leaf_size)."""
    table = np.array(table, np.float32)  # a writable copy
    if table.shape != (num_rows, 128):
        raise ValueError(f"table shape {table.shape} != ({num_rows}, 128)")
    return FlatBVH(table=torch.from_numpy(table), num_rows=int(num_rows),
                   max_depth=int(max_depth), root_code=int(root_code),
                   width=int(width), has_alpha_flags=bool(has_alpha_flags),
                   leaf_size=int(leaf_size))


def sun_grid_from_reference(grid) -> SunGrid:
    """SunGrid (CPU tensors) from the JAX package's SunGrid (or any object
    with its attributes: table, index, params, basis, num_rows,
    grid_size)."""
    return SunGrid(
        table=torch.from_numpy(np.array(grid.table, np.float32)),
        index=torch.from_numpy(np.array(grid.index, np.int32)),
        params=torch.from_numpy(np.array(grid.params, np.float32)),
        basis=torch.from_numpy(np.array(grid.basis, np.float32)),
        num_rows=int(grid.num_rows), grid_size=int(grid.grid_size))


_PROXY_COLUMNS = ("v0x", "v0y", "v0z", "e1x", "e1y", "e1z", "e2x", "e2y",
                  "e2z")


def proxy_from_reference(proxy) -> DenseProxy:
    """DenseProxy (CPU tensors) from the JAX package's DenseProxy: its
    (1, K) columns v0x..e2z and tri_id."""
    cols = np.stack([np.asarray(getattr(proxy, c), np.float32).reshape(-1)
                     for c in _PROXY_COLUMNS])
    return DenseProxy(torch.from_numpy(cols), torch.from_numpy(
        np.array(proxy.tri_id, np.int32).reshape(-1)))


def cut_from_reference(cut) -> AABBCut:
    """AABBCut (CPU tensors) from the JAX package's AABBCut: its (1, C)
    columns lox..hiz."""
    return AABBCut(torch.from_numpy(np.stack([
        np.asarray(getattr(cut, c), np.float32).reshape(-1)
        for c in ("lox", "loy", "loz", "hix", "hiy", "hiz")])))


def frame_from_numpy(inv_view_projection, camera_pos_ws, sun_direction_ws,
                     sun_irradiance, sun_render_color, cos_sun_angular_radius,
                     sin_sun_angular_radius,
                     curr_sample_idx: int) -> FrameConstants:
    """FrameConstants (CPU tensors) from host values."""
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))
    return FrameConstants(
        inv_view_projection=f32(inv_view_projection).reshape(4, 4),
        camera_pos_ws=f32(camera_pos_ws).reshape(3),
        sun_direction_ws=f32(sun_direction_ws).reshape(3),
        sun_irradiance=f32(sun_irradiance).reshape(3),
        sun_render_color=f32(sun_render_color).reshape(3),
        cos_sun_angular_radius=f32(cos_sun_angular_radius).reshape(()),
        sin_sun_angular_radius=f32(sin_sun_angular_radius).reshape(()),
        curr_sample_idx=int(curr_sample_idx))


def history_from_reference(hist_slabs, width: int, height: int,
                           packet_tiles: bool = True) -> dict:
    """The JAX session's temporal history (`_hist_slabs`: one {"prim_tri",
    "sun_tri"} dict of (slab_h * width,) ids per row slab, each in its
    slab's packet-tile order) as the port's session keeps it: (H*W,) int32
    CPU tensors in the whole frame's lane order. `packet_tiles` says
    whether enable_packet_traversal is on (it tiles both packages' lanes
    where a 128-pixel tile divides the slab, or the frame)."""
    slab_h = height // len(hist_slabs)
    if slab_h * len(hist_slabs) != height:
        raise ValueError(f"{len(hist_slabs)} slabs do not divide {height} "
                         f"rows")
    slab_dims = (_packet_tile_dims(slab_h, width)
                 if packet_tiles and slab_h * width % 128 == 0 else None)
    dims = _packet_tile_dims(height, width) if packet_tiles else None
    out = {}
    for k in ("prim_tri", "sun_tri"):
        rows = []
        for slab in hist_slabs:
            x = torch.from_numpy(np.array(slab[k], np.int32).reshape(-1))
            if x.shape[0] != slab_h * width:
                raise ValueError(f"{k}: a slab of {x.shape[0]} lanes, want "
                                 f"{slab_h * width}")
            if slab_dims is not None:
                x = _untile_order(x, slab_h, width, *slab_dims)
            rows.append(x)
        x = torch.cat(rows)
        out[k] = (x if dims is None
                  else _tile_order(x, height, width, *dims)).contiguous()
    return out


# The learned denoiser's trained weights: the port's own copy of the JAX
# package's file, byte for byte.
DENOISER_WEIGHTS = (Path(__file__).resolve().parent / "data"
                    / "denoiser_weights.npz")


def load_denoiser_weights(path=None) -> list[tuple[np.ndarray, np.ndarray]]:
    """[(w HWIO, b), ...] from a weight file (num_layers, w0, b0, ...):
    `path`, by default the port's DENOISER_WEIGHTS."""
    with np.load(DENOISER_WEIGHTS if path is None else path) as z:
        return [(z[f"w{i}"], z[f"b{i}"]) for i in range(int(z["num_layers"]))]


def denoiser_params_from_numpy(params) -> dict[str, torch.Tensor]:
    """The JAX package's [(w HWIO, b), ...] as render.learned_denoise
    .DenoiserNet's state dict (conv weights OIHW)."""
    state = {}
    for i, (w, b) in enumerate(params):
        w = np.asarray(w, np.float32)
        if w.ndim != 4 or w.shape[:2] != (3, 3):
            raise ValueError(f"layer {i}: want a 3x3 HWIO kernel, got "
                             f"{w.shape}")
        state[f"layers.{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
        state[f"layers.{i}.bias"] = torch.from_numpy(np.array(b, np.float32))
    return state
