"""On-device LBVH build: the morton fast build as torch ops on the tensors'
device, for geometry that moves.

The port of dxrpathtracer_tpu/accel/device_build.py. The reference rebuilds
its acceleration structures on the GPU (BuildRaytracingAccelerationStructure,
DXRPathTracer.cpp:2331-2488); geometry never goes back to the host. Here the
equal-count eighth-split topology of `bvh.build_table_numpy` (row ranges,
leaf slots, child links, levels) is a pure function of the triangle count,
computed once on the host (`lbvh_plan`); each build moves only data: morton
codes, a stable sort, gathers, and fixed-order min/max folds. The JAX
package left this to XLA's primitives rather than a Pallas kernel
(device_build.py:24-29 there), and the port leaves it to torch's.

The table is bit-identical to `build_table_numpy`'s on both devices:
  - the centroids divide by 3 as a tensor on the device (math3.div);
  - morton codes use int64 (torch's uint32 has few ops): every product of
    the bit expansion fits, and a mask under 2^32 drops what uint32 wraps;
  - the sort is stable, as numpy's kind="stable" argsort;
  - every min/max is a fold in numpy's order with numpy's tie rule (an
    equal pair gives the second operand: -0.0 and +0.0 keep numpy's sign),
    written as comparisons and `where`, never torch.minimum/amin, whose
    choice between signed zeros may differ by device;
  - records are assembled as int32 and viewed as float32 once: payload
    slots (tri ids, child codes) see no float arithmetic.
"""

import dataclasses

import numpy as np
import torch

from ..app.profiler import count
from ..core.math3 import div
from .bvh import LEAF_SIZE, RECORD, WIDTH, FlatBVH, lbvh_topology


@dataclasses.dataclass(frozen=True)
class LBVHPlan:
    """Static topology of the equal-count eighth-split LBVH: a function of
    (num_tris, leaf_size) only, so every frame of a moving scene shares
    one. Host numpy arrays; `tensors(device)` holds them on a device."""

    num_tris: int
    leaf_size: int
    num_rows: int
    num_leaves: int
    depth: int
    root_code: int
    leaf_ids: np.ndarray     # (num_leaves,) row ids of leaves, ascending
    int_ids: np.ndarray      # (num_int,) row ids of internal rows
    leaf_src: np.ndarray     # (num_leaves, LEAF_SIZE) sorted position per slot
    leaf_valid: np.ndarray   # (num_leaves, LEAF_SIZE) slot occupancy
    int_child: np.ndarray    # (num_int, WIDTH) child row ids
    int_codes: np.ndarray    # (num_int, WIDTH) int32 child codes
    level_int: tuple         # per level, deepest first: its internal rows'
                             # positions in int_ids
    _on_device: dict = dataclasses.field(default_factory=dict, compare=False,
                                         repr=False)

    def tensors(self, device) -> dict:
        """The plan's index arrays as tensors on `device` (made once)."""
        device = torch.device(device)
        if device not in self._on_device:
            t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            self._on_device[device] = dict(
                leaf_ids=t(self.leaf_ids), int_ids=t(self.int_ids),
                leaf_src=t(self.leaf_src), leaf_valid=t(self.leaf_valid),
                int_child=t(self.int_child), int_codes=t(self.int_codes),
                levels=[(t(self.int_ids[sel]), t(self.int_child[sel]))
                        for sel in self.level_int])
        return self._on_device[device]


def lbvh_plan(num_tris: int, leaf_size: int = LEAF_SIZE) -> LBVHPlan:
    """The static topology (build_table_numpy's BFS rows)."""
    if num_tris <= 0:
        raise ValueError("cannot build a BVH over zero triangles")
    if not WIDTH <= leaf_size <= LEAF_SIZE:
        raise ValueError(f"leaf_size must be in {WIDTH}..{LEAF_SIZE}")
    row_ranges, row_is_leaf, child_row, level_slices = lbvh_topology(
        num_tris, leaf_size)
    n_rows = len(row_ranges)
    leaf_ids = np.where(row_is_leaf)[0]
    int_ids = np.where(~row_is_leaf)[0]
    lo = row_ranges[leaf_ids, 0]
    hi = row_ranges[leaf_ids, 1]
    k = np.arange(LEAF_SIZE)
    leaf_src = np.minimum(lo[:, None] + k[None, :], num_tris - 1)
    leaf_valid = (lo[:, None] + k[None, :]) < hi[:, None]
    code_of = np.where(row_is_leaf, ~np.arange(n_rows),
                       np.arange(n_rows)).astype(np.int32)
    int_child = child_row[int_ids]
    int_codes = code_of[int_child] if int_ids.size else \
        np.zeros((0, WIDTH), np.int32)
    level_int = tuple(np.where((int_ids >= s) & (int_ids < e))[0]
                      for s, e in reversed(level_slices[:-1]))
    return LBVHPlan(num_tris=num_tris, leaf_size=leaf_size, num_rows=n_rows,
                    num_leaves=int(leaf_ids.size), depth=len(level_slices),
                    root_code=int(code_of[0]), leaf_ids=leaf_ids,
                    int_ids=int_ids, leaf_src=leaf_src, leaf_valid=leaf_valid,
                    int_child=int_child, int_codes=int_codes,
                    level_int=level_int)


def _min(a, b):
    """numpy's minimum without NaNs: a < b ? a : b (a tie gives b)."""
    return torch.where(a < b, a, b)


def _max(a, b):
    return torch.where(a > b, a, b)


def _expand_bits(v):
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes_30(centroids: torch.Tensor) -> torch.Tensor:
    """30-bit morton codes (int64) of (T, 3) float32 centroids, op for op
    bvh.morton_codes_30."""
    lo = centroids.amin(0)
    hi = centroids.amax(0)
    ext = torch.clamp_min(hi - lo, 1e-9)
    q = torch.clamp((centroids - lo) / ext * 1023.0, 0.0, 1023.0)
    q = q.to(torch.int64)
    return (_expand_bits(q[:, 0]) * 4 + _expand_bits(q[:, 1]) * 2
            + _expand_bits(q[:, 2]))


def _fold(x, op, valid=None):
    """op-fold of (N, K, 3) over K in order (slot k only where valid[:, k])."""
    acc = x[:, 0]
    for k in range(1, x.shape[1]):
        nxt = op(acc, x[:, k])
        acc = nxt if valid is None else torch.where(valid[:, k, None], nxt,
                                                    acc)
    return acc


def build_table_device(v0, v1, v2, plan: LBVHPlan) -> torch.Tensor:
    """(T, 3) float32 triangle vertices on a device -> the (num_rows,
    RECORD) float32 table there, bit-identical to build_table_numpy's."""
    if v0.shape != (plan.num_tris, 3):
        raise ValueError(f"{tuple(v0.shape)} vertices for a plan of "
                         f"{plan.num_tris} triangles")
    p = plan.tensors(v0.device)
    v0, v1, v2 = (v.to(torch.float32) for v in (v0, v1, v2))
    order = torch.argsort(morton_codes_30(div(v0 + v1 + v2, 3.0)),
                          stable=True)
    sv0, sv1, sv2 = v0[order], v1[order], v2[order]
    tri_lo = _min(_min(sv0, sv1), sv2)
    tri_hi = _max(_max(sv0, sv1), sv2)

    # boxes: leaves fold their slots, then internal rows their 8 children,
    # level by level from the deepest
    src, valid = p["leaf_src"], p["leaf_valid"]
    node_lo = torch.empty((plan.num_rows, 3), dtype=torch.float32,
                          device=v0.device)
    node_hi = torch.empty_like(node_lo)
    node_lo[p["leaf_ids"]] = _fold(tri_lo[src], _min, valid)
    node_hi[p["leaf_ids"]] = _fold(tri_hi[src], _max, valid)
    for ids, child in p["levels"]:
        node_lo[ids] = _fold(node_lo[child], _min)
        node_hi[ids] = _fold(node_hi[child], _max)

    # records, assembled as int32
    table = torch.zeros((plan.num_rows, RECORD), dtype=torch.int32,
                        device=v0.device)
    blocks = []
    for arr in (sv0, sv1 - sv0, sv2 - sv0):
        g = torch.where(valid[..., None], arr[src], 0.0)   # (Lv, L, 3)
        blocks.append(g.transpose(1, 2).reshape(plan.num_leaves,
                                                3 * LEAF_SIZE))
    leaf = torch.cat(blocks, 1).view(torch.int32)
    tid = torch.where(valid, order.to(torch.int32)[src], -1)
    table[p["leaf_ids"], :10 * LEAF_SIZE] = torch.cat([leaf, tid], 1)
    if plan.int_ids.size:
        child = p["int_child"]
        n = child.shape[0]
        box = lambda b: b[child].transpose(1, 2).reshape(n, 3 * WIDTH)
        table[p["int_ids"], :7 * WIDTH] = torch.cat(
            [box(node_lo).view(torch.int32), box(node_hi).view(torch.int32),
             p["int_codes"]], 1)
    return table.view(torch.float32)


def build_bvh_device(v0, v1, v2, plan: LBVHPlan | None = None) -> FlatBVH:
    """The W8 FlatBVH of the device build, its table on the vertices'
    device; the static fields come from the plan. Traced, each build counts
    one `lbvh_build` under the innermost open span."""
    count("lbvh_build")
    if plan is None:
        plan = lbvh_plan(int(v0.shape[0]))
    return FlatBVH(table=build_table_device(v0, v1, v2, plan),
                   num_rows=plan.num_rows, max_depth=plan.depth + 2,
                   root_code=plan.root_code, width=WIDTH)
