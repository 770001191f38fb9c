"""Load-time subdivision of alpha-tested triangles (host numpy).

The port of dxrpathtracer_tpu/scene/alphasplit.py, as it is: every triangle
of an opacity-mapped material is subdivided adaptively (4-way at the edge
midpoints, recursing only into mixed regions, to `max_level`), and each
piece is classified against the opacity map by a summed-area count of the
texels >= the cutoff over its UV box, padded by one texel each way for the
bilinear footprint and wrapped:

  no texel >= 0.35   -> dropped (no tap inside it can accept a hit);
  every texel >= 0.35 -> moved to an opaque clone of the material (every
                         tap accepts);
  otherwise           -> kept alpha-tested.

Geometry is kept: the pieces tile their parent, their corner attributes the
parent's linear interpolation. The scene registry calls `maybe_split_alpha`
where the JAX package does (the alpha stand-in, the FBX route, the SunTemple
stand-in with its foliage maps), only where DXRPT_ALPHA_SPLIT is "1"
(DXRPT_ALPHA_SPLIT_LEVEL sets max_level, 4 by default).
"""

import dataclasses
import logging
import os

import numpy as np

from .procedural import MeshData

log = logging.getLogger(__name__)

SLOTS = ("albedo", "normal", "roughness", "metallic", "opacity", "emissive")
ATTRS = ("positions", "normals", "uvs", "tangents", "bitangents")


def _integral_ge(img, threshold):
    """Summed-area table of (opacity >= threshold) for O(1) rect counts."""
    b = (img >= threshold).astype(np.int64)
    sat = np.zeros((b.shape[0] + 1, b.shape[1] + 1), np.int64)
    np.cumsum(np.cumsum(b, axis=0), axis=1, out=sat[1:, 1:])
    return sat


def _rect_count(sat, y0, y1, x0, x1):
    return sat[y1, x1] - sat[y0, x1] - sat[y1, x0] + sat[y0, x0]


class _Classifier:
    """Conservative min/max-opacity classifier over UV boxes (wrapped, with
    the bilinear footprint's one-texel pad)."""

    def __init__(self, opacity_img, threshold):
        self.h, self.w = opacity_img.shape[:2]
        self.sat = _integral_ge(opacity_img[..., 0], threshold)

    def classify(self, uvs):
        """uvs: (3, 2) corner UVs -> 'transparent', 'opaque' or 'mixed'."""
        w, h = self.w, self.h
        # continuous texel coordinates of the footprint, -1/+2 texel pad
        xs = uvs[:, 0] * w - 0.5
        ys = uvs[:, 1] * h - 0.5
        x0 = int(np.floor(xs.min())) - 1
        x1 = int(np.ceil(xs.max())) + 2
        y0 = int(np.floor(ys.min())) - 1
        y1 = int(np.ceil(ys.max())) + 2
        if x1 - x0 >= w or y1 - y0 >= h:
            area = w * h
            cnt = _rect_count(self.sat, 0, h, 0, w)
        else:
            # wrap: the box in at most four in-range pieces
            area = cnt = 0
            xa, ya = x0 % w, y0 % h
            xw, yh = x1 - x0, y1 - y0
            for yy0, yy1 in ((ya, min(ya + yh, h)), (0, max(0, ya + yh - h))):
                for xx0, xx1 in ((xa, min(xa + xw, w)),
                                 (0, max(0, xa + xw - w))):
                    if yy1 <= yy0 or xx1 <= xx0:
                        continue
                    area += (yy1 - yy0) * (xx1 - xx0)
                    cnt += _rect_count(self.sat, yy0, yy1, xx0, xx1)
        if cnt == 0:
            return "transparent"
        if cnt == area:
            return "opaque"
        return "mixed"


def _subdivide(attr3, cls, level, max_level, out):
    """Adaptive 4-way midpoint subdivision of one triangle (attr3: each
    attribute's (3, ...) corner values); appends (kind, attr3) pieces."""
    kind = cls.classify(attr3["uvs"])
    if kind != "mixed" or level >= max_level:
        out.append((kind, attr3))
        return
    mids = {k: (v[[0, 1, 2]] + v[[1, 2, 0]]) * 0.5 for k, v in attr3.items()}
    corners = [(0, "m01", "m20"), ("m01", 1, "m12"), ("m20", "m12", 2),
               ("m01", "m12", "m20")]
    name_of = {"m01": 0, "m12": 1, "m20": 2}
    for tri in corners:
        sub = {k: np.stack([v[c] if isinstance(c, int)
                            else mids[k][name_of[c]] for c in tri], axis=0)
               for k, v in attr3.items()}
        _subdivide(sub, cls, level + 1, max_level, out)


def split_alpha_meshes(meshes, materials, builder, threshold=0.35,
                       max_level=4):
    """Subdivide and classify every mesh of an opacity-mapped material.
    Returns (meshes, materials, stats {dropped, opaque, mixed, source}):
    dropped pieces are gone, opaque ones form meshes of an opaque clone of
    their material (appended to the table: the same texture slots,
    has_opacity False), mixed ones keep their material. `builder` is the
    scene's AtlasBuilder, which holds the opacity maps. (Without any
    opacity-mapped material the JAX function returns only the meshes and
    materials; this one returns zero stats as well.)"""
    stats = dict(dropped=0, opaque=0, mixed=0, source=0)
    has_op = np.asarray(materials.has_opacity)
    if not has_op.any():
        return meshes, materials, stats

    slot_arrays = {s: list(np.asarray(getattr(materials, s))) for s in SLOTS}
    has_list = list(has_op)
    opaque_clone = {}

    def clone_of(mat_idx):
        if mat_idx not in opaque_clone:
            for s in SLOTS:
                slot_arrays[s].append(slot_arrays[s][mat_idx])
            has_list.append(False)
            opaque_clone[mat_idx] = len(has_list) - 1
        return opaque_clone[mat_idx]

    classifiers = {}

    def classifier_for(mat_idx):
        if mat_idx not in classifiers:
            tex_idx = int(np.asarray(materials.opacity)[mat_idx])
            img = builder._cap(builder._textures[tex_idx].data)
            classifiers[mat_idx] = _Classifier(img, threshold)
        return classifiers[mat_idx]

    out_meshes = []
    for mesh in meshes:
        if not has_list[mesh.material_idx]:
            out_meshes.append(mesh)
            continue
        cls = classifier_for(mesh.material_idx)
        idx = np.asarray(mesh.indices, np.int64).reshape(-1, 3)
        stats["source"] += len(idx)
        leaves = {"opaque": [], "mixed": []}
        for tri in idx:
            attr3 = {k: getattr(mesh, k)[tri] for k in ATTRS}
            pieces = []
            _subdivide(attr3, cls, 0, max_level, pieces)
            for kind, a in pieces:
                if kind == "transparent":
                    stats["dropped"] += 1
                else:
                    leaves[kind].append(a)
        for kind, tris in leaves.items():
            if not tris:
                continue
            stats[kind] += len(tris)
            mat = (clone_of(mesh.material_idx) if kind == "opaque"
                   else mesh.material_idx)
            out_meshes.append(MeshData(
                **{k: np.concatenate([a[k] for a in tris]).astype(np.float32)
                   for k in ATTRS},
                indices=np.arange(3 * len(tris), dtype=np.int32),
                material_idx=mat))

    new_materials = dataclasses.replace(
        materials, **{s: np.asarray(slot_arrays[s]) for s in SLOTS},
        has_opacity=np.asarray(has_list, bool))
    return out_meshes, new_materials, stats


def maybe_split_alpha(meshes, materials, builder, threshold=0.35,
                      max_level=None):
    """The registry's entry: `split_alpha_meshes` where DXRPT_ALPHA_SPLIT is
    "1" (off by default, as in the JAX package), at max_level
    DXRPT_ALPHA_SPLIT_LEVEL (4) unless given. Returns (meshes, materials,
    stats or None when off)."""
    if os.environ.get("DXRPT_ALPHA_SPLIT") != "1":
        return meshes, materials, None
    if max_level is None:
        max_level = int(os.environ.get("DXRPT_ALPHA_SPLIT_LEVEL", "4"))
    out_meshes, out_materials, stats = split_alpha_meshes(
        meshes, materials, builder, threshold=threshold, max_level=max_level)
    log.info("alpha split: %d source tris -> %d opaque + %d mixed "
             "(%d transparent dropped)", stats["source"], stats["opaque"],
             stats["mixed"], stats["dropped"])
    return out_meshes, out_materials, stats
