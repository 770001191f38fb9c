"""Wide-BVH tables built by the repository's native builders.

The counterpart of dxrpathtracer_tpu/accel/lbvh.py (FlatBVH, build_bvh,
build_bvh_for_scene, the morton build's host reference) plus accel/native.py.
The tables are the JAX package's, byte for byte: both packages run
`native/sah_builder.cpp` (the binned-SAH quality build, W8 or W32) and
`native/lbvh_builder.cpp` (the morton fast build, W8: equal-count
eighth-splits of the morton order), compiled with `-ffp-contract=off` so
their float comparisons round as their numpy mirrors do. The port compiles
them into its own build directory (buildlib.BUILD_DIR) and never into
`native/`, whose libraries are tracked. A failed build raises.
`build_table_numpy` is the morton build in numpy, the reference of the
device build (accel/device_build.py).

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
LBVH_SOURCE = REPO_ROOT / "native" / "lbvh_builder.cpp"
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
    leaf_size: int = LEAF_SIZE  # the most triangles a leaf holds

    def to(self, device) -> "FlatBVH":
        return dataclasses.replace(self, table=self.table.to(device))

    @property
    def stack_depth(self) -> int:
        """(node, mask) stack entries a walk needs: one per tree level."""
        return self.max_depth + 2


_lib = None
_lbvh_lib = None
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


def lbvh_library():
    """The native morton (LBVH) builder, compiled at first use."""
    global _lbvh_lib
    if _lbvh_lib is None:
        path, _ = build_shared_library(LBVH_SOURCE, "lbvh_builder",
                                       SAH_COMMAND)
        lib = ctypes.CDLL(str(path))
        lib.lbvh_count3.restype = ctypes.c_int64
        lib.lbvh_count3.argtypes = [ctypes.c_int64, ctypes.c_int64, _I64P,
                                    _I64P, _I64P]
        lib.lbvh_build3.restype = ctypes.c_int
        lib.lbvh_build3.argtypes = [_F32P, _F32P, _F32P, ctypes.c_int64,
                                    ctypes.c_int64, _F32P, ctypes.c_int64]
        _lbvh_lib = lib
    return _lbvh_lib


def morton_codes_30(centroids: np.ndarray) -> np.ndarray:
    """30-bit morton codes from (T, 3) float32 centroids, 10 bits per axis."""
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    ext = np.maximum(hi - lo, 1e-9)
    q = np.clip(((centroids - lo) / ext) * 1023.0, 0, 1023).astype(np.uint32)

    def expand_bits(v):
        v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
        v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
        v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
        v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
        return v

    return (expand_bits(q[:, 0]) * 4 + expand_bits(q[:, 1]) * 2
            + expand_bits(q[:, 2])).astype(np.uint32)


def lbvh_topology(num_tris: int, leaf_size: int = LEAF_SIZE):
    """The morton build's rows, a pure function of the triangle count:
    (row ranges (R, 2) over the sorted order, row is leaf (R,), child rows
    (R, WIDTH), -1 for none, and each level's (first, end) rows), in BFS
    order: each level's children laid out after it, WIDTH per internal row,
    the ranges split into equal-count eighths."""
    row_ranges, row_is_leaf, level_slices = [], [], []
    cur = [(0, num_tris)]
    while cur:
        start_row = len(row_ranges)
        nxt = []
        for (lo, hi) in cur:
            row_ranges.append((lo, hi))
            row_is_leaf.append(hi - lo <= leaf_size)
            if hi - lo > leaf_size:
                cnt = hi - lo
                bounds = [lo + (cnt * k) // WIDTH for k in range(WIDTH + 1)]
                nxt += [(bounds[k], bounds[k + 1]) for k in range(WIDTH)]
        level_slices.append((start_row, len(row_ranges)))
        cur = nxt
    row_is_leaf = np.asarray(row_is_leaf)
    child_row = np.full((len(row_ranges), WIDTH), -1, np.int64)
    for li, (s, e) in enumerate(level_slices[:-1]):
        base = level_slices[li + 1][0]
        internal_ids = np.arange(s, e)[~row_is_leaf[s:e]]
        for j, rid in enumerate(internal_ids):
            child_row[rid] = base + j * WIDTH + np.arange(WIDTH)
    return (np.asarray(row_ranges, np.int64), row_is_leaf, child_row,
            level_slices)


def build_table_numpy(v0, v1, v2, leaf_size: int = LEAF_SIZE):
    """The morton build in numpy (the JAX package's reference host build):
    (table (rows, RECORD) f32, num_rows, num_leaves, depth, root_code)."""
    v0, v1, v2 = (np.asarray(v, np.float32) for v in (v0, v1, v2))
    num_tris = v0.shape[0]
    centroids = (v0 + v1 + v2) / 3.0
    order = np.argsort(morton_codes_30(centroids),
                       kind="stable").astype(np.int64)
    sv0, sv1, sv2 = v0[order], v1[order], v2[order]
    tri_lo = np.minimum(np.minimum(sv0, sv1), sv2)
    tri_hi = np.maximum(np.maximum(sv0, sv1), sv2)
    row_ranges, row_is_leaf, child_row, level_slices = lbvh_topology(
        num_tris, leaf_size)
    n_rows, depth = len(row_ranges), len(level_slices)

    # AABBs bottom-up
    lo_arr = np.empty((n_rows, 3), np.float32)
    hi_arr = np.empty((n_rows, 3), np.float32)
    for s, e in reversed(level_slices):
        for rid in range(s, e):
            lo, hi = row_ranges[rid]
            if row_is_leaf[rid]:
                lo_arr[rid] = tri_lo[lo:hi].min(axis=0)
                hi_arr[rid] = tri_hi[lo:hi].max(axis=0)
            else:
                ch = child_row[rid]
                lo_arr[rid] = lo_arr[ch].min(axis=0)
                hi_arr[rid] = hi_arr[ch].max(axis=0)

    # codes: row index; leaves encoded as ~row
    code_of = np.where(row_is_leaf, ~np.arange(n_rows),
                       np.arange(n_rows)).astype(np.int32)
    table = np.zeros((n_rows, RECORD), np.float32)
    # leaf records: SoA blocks [v0 e1 e2](xyz each) and tri ids, LEAF_SIZE
    # slots each; empty slots keep tri id -1
    leaf_ids = np.where(row_is_leaf)[0]
    sorted_tri_id = order.astype(np.int32)
    e1, e2 = sv1 - sv0, sv2 - sv0
    table[leaf_ids, 9 * LEAF_SIZE:10 * LEAF_SIZE] = \
        np.int32(-1).view(np.float32)
    for k in range(min(leaf_size, LEAF_SIZE)):
        rid = leaf_ids[(row_ranges[leaf_ids, 1]
                        - row_ranges[leaf_ids, 0]) > k]
        src = row_ranges[rid, 0] + k
        for comp, arr in enumerate((sv0, e1, e2)):
            for ax in range(3):
                table[rid, (comp * 3 + ax) * LEAF_SIZE + k] = arr[src, ax]
        table[rid, 9 * LEAF_SIZE + k] = sorted_tri_id[src].view(np.float32)

    # internal records: every child slot is filled (count > leaf_size >= 8)
    int_ids = np.where(~row_is_leaf)[0]
    if int_ids.size:
        ch = child_row[int_ids]
        for ax in range(3):
            table[int_ids, ax * WIDTH:(ax + 1) * WIDTH] = lo_arr[ch, ax]
            table[int_ids, 24 + ax * WIDTH:24 + (ax + 1) * WIDTH] = \
                hi_arr[ch, ax]
        table[int_ids, 48:56] = code_of[ch].view(np.float32)
    return (table, n_rows, int(row_is_leaf.sum()), depth, int(code_of[0]))


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
                    tri_alpha: np.ndarray | None,
                    tri_ids: np.ndarray | None = None) -> np.ndarray:
    """The JAX package's `flag_alpha_tris`, in place: with `tri_ids`, first
    remaps the leaves' local build indices to tri_ids[index] (a table over
    a subset of a scene's triangles numbers them 0..n-1, shading needs the
    scene's ids); with `tri_alpha` (indexed by the remapped ids), ORs
    ALPHA_TID_BIT into the ids of alpha-tested triangles. Empty slots (-1)
    stay."""
    rows = leaf_rows(table, root_code, width)
    ids = table[rows, 9 * LEAF_SIZE:10 * LEAF_SIZE].view(np.int32).copy()
    valid = ids >= 0
    if tri_ids is not None:
        ids[valid] = np.asarray(tri_ids, np.int32)[ids[valid]]
    if tri_alpha is not None:
        flag = np.zeros_like(valid)
        flag[valid] = np.asarray(tri_alpha, bool)[ids[valid]]
        ids[flag] |= ALPHA_TID_BIT
    table[rows, 9 * LEAF_SIZE:10 * LEAF_SIZE] = ids.view(np.float32)
    return table


def build_bvh(v0, v1, v2, width: int = WIDTH,
              leaf_size: int = LEAF_SIZE, tri_alpha=None,
              mode: str = "sah", tri_ids=None) -> FlatBVH:
    """BVH over (T, 3) triangle vertices -> FlatBVH on the CPU. mode "sah"
    is the binned-SAH quality build (the reference's PREFER_FAST_TRACE
    driver build, W8 or W32); "morton" the fast build (PREFER_FAST_BUILD,
    W8 only), whose table the device build (accel/device_build.py) makes
    too. tri_alpha: (T,) bool, whose set triangles get ALPHA_TID_BIT in
    their leaf ids (the table then has_alpha_flags), or None. tri_ids: the
    scene's id of each of the T triangles, written into the leaves in place
    of its index (tri_alpha is then indexed by those ids), or None."""
    if width not in (8, 32):
        raise ValueError(f"width must be 8 or 32, got {width}")
    if mode not in ("sah", "morton") or (mode == "morton" and width != WIDTH):
        raise ValueError(f"mode {mode!r} at width {width}: the morton "
                         f"build is W{WIDTH} only")
    if not 0 < leaf_size <= LEAF_SIZE:
        raise ValueError(f"leaf_size must be in 1..{LEAF_SIZE}")
    v0, v1, v2 = (np.ascontiguousarray(v, np.float32) for v in (v0, v1, v2))
    t = v0.shape[0]
    if t == 0:
        raise ValueError("cannot build a BVH over zero triangles")
    lib = lbvh_library() if mode == "morton" else sah_library()
    leaves, depth, root = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    outs = (ctypes.byref(leaves), ctypes.byref(depth), ctypes.byref(root))
    with _lib_lock:
        if mode == "morton":
            rows = lib.lbvh_count3(t, leaf_size, *outs)
            table = np.zeros((max(rows, 1), RECORD), np.float32)
            rc = lib.lbvh_build3(v0, v1, v2, t, leaf_size, table, rows)
        elif width == WIDTH:
            rows = lib.sah_count3(v0, v1, v2, t, leaf_size, *outs)
            table = np.zeros((max(rows, 1), RECORD), np.float32)
            rc = lib.sah_build3(v0, v1, v2, t, leaf_size, table, rows)
        else:
            rows = lib.sah_count_wide3(v0, v1, v2, t, leaf_size, width, *outs)
            table = np.zeros((max(rows, 1), RECORD), np.float32)
            rc = lib.sah_build_wide3(v0, v1, v2, t, leaf_size, width, table,
                                     rows)
    if rows < 1 or rc != 0:
        raise RuntimeError(f"native {mode} build failed (rows={rows}, "
                           f"rc={rc})")
    has_flags = tri_alpha is not None and bool(np.asarray(tri_alpha).any())
    if has_flags or tri_ids is not None:
        flag_alpha_tris(table, int(root.value), width,
                        tri_alpha if has_flags else None, tri_ids=tri_ids)
    return FlatBVH(table=torch.from_numpy(table), num_rows=int(rows),
                   max_depth=int(depth.value) + 2,
                   root_code=int(root.value), width=width,
                   has_alpha_flags=has_flags, leaf_size=int(leaf_size))


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


ALPHA_LEAF_SIZE = 2  # the alpha-only table's leaves (packet.LEAF_EXTRACT)


def build_alpha_bvh_for_scene(scene, leaf_size: int = ALPHA_LEAF_SIZE
                              ) -> FlatBVH | None:
    """The split-alpha route's alpha-only table (on the CPU): a W8 SAH build
    over just the triangles of opacity-mapped materials, leaf_size to a
    leaf, their leaf ids the scene's and every one flagged (the JAX
    session's `bvh_alpha`); None when the scene has no such triangle."""
    if not scene.any_opacity:
        return None
    has_op = scene.has_opacity.cpu().numpy().astype(bool)
    amask = has_op[scene.tri_material.cpu().numpy()]
    if not amask.any():
        return None
    pos = scene.positions.cpu().numpy()
    aidx = np.where(amask)[0].astype(np.int32)
    atr = scene.tri_idx.cpu().numpy()[aidx]
    return build_bvh(pos[atr[:, 0]], pos[atr[:, 1]], pos[atr[:, 2]],
                     width=WIDTH, leaf_size=leaf_size, tri_alpha=amask,
                     tri_ids=aidx)
