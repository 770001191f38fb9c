"""Wide-BVH tables built by the repository's native SAH builder.

The counterpart of dxrpathtracer_tpu/accel/lbvh.py (FlatBVH, build_bvh,
build_bvh_for_scene) plus accel/native.py. The tables are the JAX package's,
byte for byte: both packages run `native/sah_builder.cpp`, compiled with
`-ffp-contract=off` so its SAH cost comparisons round as its numpy mirror does.
The port compiles it into its own build directory (buildlib.BUILD_DIR) and
never into `native/`, whose libraries are tracked. A failed build raises.

Every node, internal or leaf, is one 128-float (512 B) record:
  W8 internal: [0:8) loX [8:16) loY [16:24) loZ [24:32) hiX [32:40) hiY
      [40:48) hiZ [48:56) bitcast(child codes); empty slots have inverted
      bounds (lo=3e38 > hi=-3e38) and code 0.
  W32 internal: [0:96) six fields of bf16 child bounds, de-interleaved pairs
      (slot j holds child j in its low 16 bits and child j+16 in its high 16
      bits), rounded outward so a bf16 box contains the f32 box;
      [96:128) bitcast(child codes).
  leaf (both widths, L = 12 triangles): [0:L) v0x [L:2L) v0y [2L:3L) v0z
      [3L:6L) e1 xyz [6L:9L) e2 xyz [9L:10L) bitcast(tri_id), -1 when empty;
      a table built with tri_alpha ORs ALPHA_TID_BIT into the ids of
      alpha-tested triangles.
  child code: >= 0 -> internal row; < 0 -> ~leaf row.
"""

import ctypes
import dataclasses
import threading

import numpy as np
import torch

from ..buildlib import REPO_ROOT, build_shared_library

WIDTH = 8          # children per classic internal node
LEAF_SIZE = 12     # triangles per leaf record
RECORD = 128       # f32 slots per record (512 B)
ALPHA_TID_BIT = 1 << 30  # leaf tri-id flag of alpha-tested triangles

SAH_SOURCE = REPO_ROOT / "native" / "sah_builder.cpp"
SAH_COMMAND = ["g++", "-O3", "-ffp-contract=off", "-shared", "-fPIC",
               "-std=c++17"]


@dataclasses.dataclass(frozen=True)
class FlatBVH:
    table: torch.Tensor   # (num_rows, RECORD) f32 records
    num_rows: int
    max_depth: int        # tree depth + 2 (the JAX package's convention)
    root_code: int        # >= 0 internal row; < 0 ~leaf row (single leaf)
    width: int = WIDTH    # 8 (f32 boxes) or 32 (bf16 boxes)
    has_alpha_flags: bool = False  # leaf tri ids carry ALPHA_TID_BIT

    def to(self, device) -> "FlatBVH":
        return dataclasses.replace(self, table=self.table.to(device))

    @property
    def stack_depth(self) -> int:
        """(node, mask) stack entries a walk needs: one per tree level."""
        return self.max_depth + 2


_lib = None
_lib_lock = threading.Lock()  # the builder keeps one global build in flight
_F32P = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_I64P = ctypes.POINTER(ctypes.c_int64)


def sah_library():
    """The native SAH builder, compiled at first use."""
    global _lib
    if _lib is None:
        path, _ = build_shared_library(SAH_SOURCE, "sah_builder", SAH_COMMAND)
        lib = ctypes.CDLL(str(path))
        tri3 = [_F32P, _F32P, _F32P, ctypes.c_int64, ctypes.c_int64]
        lib.sah_count3.restype = ctypes.c_int64
        lib.sah_count3.argtypes = tri3 + [_I64P, _I64P, _I64P]
        lib.sah_build3.restype = ctypes.c_int
        lib.sah_build3.argtypes = tri3 + [_F32P, ctypes.c_int64]
        lib.sah_count_wide3.restype = ctypes.c_int64
        lib.sah_count_wide3.argtypes = tri3 + [ctypes.c_int64, _I64P, _I64P,
                                               _I64P]
        lib.sah_build_wide3.restype = ctypes.c_int
        lib.sah_build_wide3.argtypes = tri3 + [ctypes.c_int64, _F32P,
                                               ctypes.c_int64]
        _lib = lib
    return _lib


def leaf_rows(table: np.ndarray, root_code: int, width: int) -> np.ndarray:
    """The leaf row ids of a packed table, level by level from the root.
    Child codes sit at [48:56) (W8) or [96:128) (W32); empty slots store
    code 0, which no child can have (row 0 is the root)."""
    if root_code < 0:
        return np.asarray([~root_code], np.int64)
    lo = 48 if width == 8 else 3 * width
    frontier, leaves = np.asarray([root_code], np.int64), []
    while frontier.size:
        codes = table[frontier, lo:lo + width].view(np.int32).reshape(-1)
        leaves.append(~codes[codes < 0].astype(np.int64))
        frontier = codes[codes > 0].astype(np.int64)
    return np.concatenate(leaves)


def flag_alpha_tris(table: np.ndarray, root_code: int, width: int,
                    tri_alpha: np.ndarray) -> np.ndarray:
    """ORs ALPHA_TID_BIT into the leaf tri ids of the triangles whose
    material is alpha-tested (`flag_alpha_tris` of the JAX package), in
    place; empty slots (-1) stay."""
    rows = leaf_rows(table, root_code, width)
    ids = table[rows, 9 * LEAF_SIZE:10 * LEAF_SIZE].view(np.int32).copy()
    valid = ids >= 0
    flag = np.zeros_like(valid)
    flag[valid] = np.asarray(tri_alpha, bool)[ids[valid]]
    ids[flag] |= ALPHA_TID_BIT
    table[rows, 9 * LEAF_SIZE:10 * LEAF_SIZE] = ids.view(np.float32)
    return table


def build_bvh(v0, v1, v2, width: int = WIDTH,
              leaf_size: int = LEAF_SIZE, tri_alpha=None) -> FlatBVH:
    """Binned-SAH BVH over (T, 3) triangle vertices -> FlatBVH on the CPU.
    tri_alpha: (T,) bool, whose set triangles get ALPHA_TID_BIT in their
    leaf ids (the table then has_alpha_flags), or None."""
    if width not in (8, 32):
        raise ValueError(f"width must be 8 or 32, got {width}")
    if not 0 < leaf_size <= LEAF_SIZE:
        raise ValueError(f"leaf_size must be in 1..{LEAF_SIZE}")
    v0, v1, v2 = (np.ascontiguousarray(v, np.float32) for v in (v0, v1, v2))
    t = v0.shape[0]
    if t == 0:
        raise ValueError("cannot build a BVH over zero triangles")
    lib = sah_library()
    leaves, depth, root = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    outs = (ctypes.byref(leaves), ctypes.byref(depth), ctypes.byref(root))
    with _lib_lock:
        if width == WIDTH:
            rows = lib.sah_count3(v0, v1, v2, t, leaf_size, *outs)
            table = np.zeros((max(rows, 1), RECORD), np.float32)
            rc = lib.sah_build3(v0, v1, v2, t, leaf_size, table, rows)
        else:
            rows = lib.sah_count_wide3(v0, v1, v2, t, leaf_size, width, *outs)
            table = np.zeros((max(rows, 1), RECORD), np.float32)
            rc = lib.sah_build_wide3(v0, v1, v2, t, leaf_size, width, table,
                                     rows)
    if rows < 1 or rc != 0:
        raise RuntimeError(f"native SAH build failed (rows={rows}, rc={rc})")
    has_flags = tri_alpha is not None and bool(np.asarray(tri_alpha).any())
    if has_flags:
        flag_alpha_tris(table, int(root.value), width, tri_alpha)
    return FlatBVH(table=torch.from_numpy(table), num_rows=int(rows),
                   max_depth=int(depth.value) + 2,
                   root_code=int(root.value), width=width,
                   has_alpha_flags=has_flags)


def build_bvh_for_scene(scene, width: int = WIDTH,
                        flag_alpha: bool = False) -> FlatBVH:
    """FlatBVH (on the CPU) over a Scene's triangles. flag_alpha=True marks
    the triangles of opacity-mapped materials with ALPHA_TID_BIT in the leaf
    ids (no-op on opaque scenes), which lets the W8 walk skip the alpha
    test's texture lookup for every other triangle."""
    pos = scene.positions.cpu().numpy()
    tri = scene.tri_idx.cpu().numpy()
    tri_alpha = None
    if flag_alpha and scene.any_opacity:
        has_op = scene.has_opacity.cpu().numpy()
        tri_alpha = has_op[scene.tri_material.cpu().numpy()]
    return build_bvh(pos[tri[:, 0]], pos[tri[:, 1]], pos[tri[:, 2]],
                     width=width, tri_alpha=tri_alpha)
