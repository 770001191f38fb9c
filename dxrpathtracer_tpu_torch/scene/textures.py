"""Texture pool + material table construction — bindless-heap emulation.

The port of dxrpathtracer_tpu/scene/textures.py. The reference binds every
material texture through one shader-visible descriptor heap and samples by
dynamic index (RayTrace.hlsl:171-221, DescriptorTables.hlsl:12-18). Here every
texture keeps its native resolution, texels are concatenated row-major into one
(total, 4) float32 pool, and a per-texture (base, width, height) row turns
(texture, uv) into flat texel indices. The pool is built on the host (numpy,
`AtlasBuilder`); the tap (`bilinear_from_meta`) is torch.

Filtering parity: every path-tracer fetch is `SampleLevel(sampler, uv, 0.0f)`
with a wrap-addressed linear sampler, i.e. bilinear at mip 0.

Default texture values parity (Model.cpp:74-83 + Content/Textures/*.dds texel
values): albedo 0xC0, normal (0.498, 0.498, 1.0), roughness 0x40,
metallic/emissive black.
"""

import dataclasses

import numpy as np
import torch

from .types import MaterialTable

# Decoded 1x1 default texel values from the reference's Content/Textures/*.dds.
DEFAULT_BASECOLOR_UNORM = 192.0 / 255.0   # DefaultBaseColor.dds (0xC0)
DEFAULT_NORMAL = (127.0 / 255.0, 127.0 / 255.0, 1.0)  # DefaultNormalMap.dds
DEFAULT_ROUGHNESS_UNORM = 64.0 / 255.0    # DefaultRoughness.dds (0x40)


def srgb_to_linear(c):
    c = np.asarray(c, np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4).astype(np.float32)


@dataclasses.dataclass
class TextureDesc:
    """Host-side description of one texture before packing."""

    name: str
    data: np.ndarray  # (H, W, 4) float32, already in linear space


class AtlasBuilder:
    """Accumulates textures (deduplicated by name) and packs the texel pool.

    Mirrors LoadMaterialResources (Model.cpp:104-149): textures are shared by
    name across materials; missing names fall back to the default texel values.
    Textures keep their native resolution up to `max_resolution` (box-filtered
    down past that).
    """

    def __init__(self, max_resolution: int = 4096):
        self.max_resolution = int(max_resolution)
        self._by_name: dict[str, int] = {}
        self._textures: list[TextureDesc] = []
        # Reserve default textures at fixed indices.
        self.default_albedo = self.add_constant("__default_albedo", (DEFAULT_BASECOLOR_UNORM,) * 3)
        self.default_albedo_srgb = self.add_constant(
            "__default_albedo_srgb", tuple(srgb_to_linear(DEFAULT_BASECOLOR_UNORM) for _ in range(3)))
        self.default_normal = self.add_constant("__default_normal", DEFAULT_NORMAL)
        self.default_roughness = self.add_constant("__default_roughness", (DEFAULT_ROUGHNESS_UNORM,) * 3)
        self.default_black = self.add_constant("__default_black", (0.0, 0.0, 0.0))
        self.default_white = self.add_constant("__default_white", (1.0, 1.0, 1.0))

    def add_constant(self, name: str, rgb, alpha: float = 1.0) -> int:
        data = np.zeros((1, 1, 4), np.float32)
        data[..., :3] = np.asarray(rgb, np.float32)
        data[..., 3] = alpha
        return self.add(name, data)

    def add(self, name: str, data: np.ndarray) -> int:
        if name in self._by_name:
            return self._by_name[name]
        data = np.asarray(data, np.float32)
        if data.ndim == 2:
            data = data[..., None]
        if data.shape[-1] == 1:
            data = np.concatenate([np.repeat(data, 3, axis=-1), np.ones_like(data)], axis=-1)
        elif data.shape[-1] == 2:
            # Two-channel data (BC5 normal maps: X in R, Y in G). Pad blue
            # with 0 and alpha with 1; the integrator reconstructs nz.
            one = np.ones_like(data[..., :1])
            data = np.concatenate([data, 0.0 * one, one], axis=-1)
        elif data.shape[-1] == 3:
            data = np.concatenate([data, np.ones_like(data[..., :1])], axis=-1)
        idx = len(self._textures)
        self._textures.append(TextureDesc(name, data))
        self._by_name[name] = idx
        return idx

    def _cap(self, img: np.ndarray) -> np.ndarray:
        """Box-filter down only when a side exceeds max_resolution."""
        h, w = img.shape[:2]
        m = self.max_resolution
        while h > m or w > m:  # halve (exact 2x2 box) until within the cap
            h2, w2 = h - (h % 2), w - (w % 2)
            img = img[:h2, :w2]
            img = (img[0::2, 0::2] + img[1::2, 0::2]
                   + img[0::2, 1::2] + img[1::2, 1::2]) * 0.25
            h, w = img.shape[:2]
        return img

    def build(self) -> tuple[np.ndarray, np.ndarray]:
        """Pack all textures, native resolution, into one flat texel pool.
        Returns (texels (total, 4) f32, meta (num_textures, 3) int32)."""
        n = len(self._textures)
        metas = np.zeros((n, 3), np.int32)
        rows, base = [], 0
        for i, tex in enumerate(self._textures):
            img = self._cap(tex.data)
            h, w = img.shape[:2]
            metas[i] = (base, w, h)
            rows.append(np.ascontiguousarray(img, np.float32).reshape(h * w, 4))
            base += h * w
        texels = np.concatenate(rows, axis=0) if rows else np.zeros((1, 4), np.float32)
        return texels, metas


def bilinear_from_meta(texels, base, w, h, uv):
    """Bilinear wrap tap at mip 0 with (base, w, h) already in hand (the
    shading step reads them from the packed material-meta row). texels
    (total, 4); base/w/h (...,) int32; uv (..., 2) f32 -> (..., 4) f32.
    D3D texel-center convention: sample coord = uv * size - 0.5."""
    wf = w.to(torch.float32)
    hf = h.to(torch.float32)
    x = uv[..., 0] * wf - 0.5
    y = uv[..., 1] * hf - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    # torch.remainder is floor-mod (the sign of the divisor), like jnp.mod
    x0i = torch.remainder(x0.to(torch.int32), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.remainder(y0.to(torch.int32), h)
    y1i = torch.remainder(y0i + 1, h)

    def fetch(yi, xi):
        return texels[(base + yi * w + xi).long()]

    t00 = fetch(y0i, x0i)
    t10 = fetch(y0i, x1i)
    t01 = fetch(y1i, x0i)
    t11 = fetch(y1i, x1i)
    top = t00 + (t10 - t00) * fx
    bot = t01 + (t11 - t01) * fx
    return top + (bot - top) * fy


def default_material_table(num_materials: int, builder: AtlasBuilder,
                           srgb_albedo: bool = False) -> MaterialTable:
    """All-default materials (what BoxTest resolves to: Model.cpp:761-768 names
    White.png/Hex.png which are absent from Content, falling back to defaults)."""
    m = num_materials
    alb = builder.default_albedo_srgb if srgb_albedo else builder.default_albedo
    full = lambda v: np.full((m,), v, np.int32)
    return MaterialTable(
        albedo=full(alb),
        normal=full(builder.default_normal),
        roughness=full(builder.default_roughness),
        metallic=full(builder.default_black),
        opacity=full(builder.default_white),
        emissive=full(builder.default_black),
        has_opacity=np.zeros((m,), bool),
    )
