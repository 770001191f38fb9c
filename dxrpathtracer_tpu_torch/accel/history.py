"""Temporal hit reuse at depth 1: the revalidation kernel's wrapper, its
plain version and the two seeded walks.

The port of dxrpathtracer_tpu/accel/history.py. A progressive render traces
nearly the same depth-1 rays every sample: camera rays move by a subpixel
jitter, and sun rays start from those hits in one direction. Last sample's
per-lane triangle is retested exactly against this sample's ray:
  - closest hit (`seeded_closest`): a predicted hit at t_p bounds the walk,
    which then runs with t_max = t_p; where the walk finds nothing nearer,
    the prediction is the closest hit. The same hit as the unseeded walk,
    up to the triangle of an equal-t tie.
  - sun visibility (`seeded_any`): where last sample's occluder still
    blocks the segment, the lane is occluded without a walk (any hit is
    order-free, so this is exact); only the other lanes walk.

The history is two (N,) int32 tensors of triangle ids (-1: none) in the
frame's lane order, reset with the accumulation; a stale id is still
exact, only slower. It is used only where no ray is alpha-tested (an
occluder's retest would need the opacity test).

`revalidate` launches csrc/history.cu (one thread per lane) for CUDA tensors
and runs `revalidate_plain` for CPU tensors; it routes on the device alone.
"""

import ctypes
from pathlib import Path

import numpy as np
import torch

from ..app.profiler import spanned
from ..buildlib import build_shared_library, nvcc
from .traverse import NVCC_FLAGS, HitRecord, moller_trumbore

KERNEL_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "history.cu"

# Launches of the revalidation kernel since the process started (or since a
# caller last reset it). Only `_launch_kernel` adds to it.
KERNEL_LAUNCHES = 0

_kernel = None
BUILD_LOG = ""  # nvcc's -Xptxas -v report of the loaded library's build


def build_tri_table(positions, tri_idx) -> np.ndarray:
    """(T, 9) f32 rows (v0, e1, e2) of every triangle, the edges taken in
    f32 as the BVH's leaf records take them, so that a retest reproduces
    the walk's t, u and v bits. Host numpy, byte-equal to the JAX
    package's."""
    pos = np.asarray(positions, np.float32)
    tri = np.asarray(tri_idx)
    v0 = pos[tri[:, 0]]
    return np.concatenate([v0, pos[tri[:, 1]] - v0, pos[tri[:, 2]] - v0],
                          axis=1)


def kernel_library():
    """csrc/history.cu compiled for sm_90a, built at first use."""
    global _kernel, BUILD_LOG
    if _kernel is None:
        path, BUILD_LOG = build_shared_library(
            KERNEL_SOURCE, "history", [nvcc(), *NVCC_FLAGS])
        lib = ctypes.CDLL(str(path))
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.dxrpt_history_revalidate.restype = ctypes.c_int
        lib.dxrpt_history_revalidate.argtypes = [
            p, i64, p,                 # table, rows, predictions
            p, p, p, p, p, i64,        # rays
            p, p, p, p,                # outputs
            p]                         # stream
        lib.dxrpt_history_resident_warps.restype = ctypes.c_int
        lib.dxrpt_history_resident_warps.argtypes = []
        _kernel = lib
    return _kernel


def resident_warps() -> int:
    """Warps of the history kernel that one SM of the current CUDA device
    holds at once."""
    warps = kernel_library().dxrpt_history_resident_warps()
    if warps <= 0:
        raise RuntimeError(f"history kernel occupancy query failed: CUDA "
                           f"error {-warps}")
    return warps


def _lanes(tri_table, pred_tri, ray_o, ray_d, t_min, t_max, active):
    """The arguments as the kernel takes them: contiguous f32 (T, 9),
    i32 (n,), f32 (n, 3) x 2, f32 (n,) x 2 and bool (n,), on ray_o's
    device."""
    n, dev = ray_o.shape[0], ray_o.device
    f32 = torch.float32
    args = (tri_table.contiguous(), pred_tri.contiguous(),
            ray_o.to(f32).contiguous(), ray_d.to(f32).contiguous(),
            torch.as_tensor(t_min, dtype=f32, device=dev).expand(n).contiguous(),
            torch.as_tensor(t_max, dtype=f32, device=dev).expand(n).contiguous(),
            (torch.ones(n, dtype=torch.bool, device=dev) if active is None
             else active.contiguous()))
    rows = tri_table.shape[0]
    for name, x, shape, dtype in zip(
            ("tri_table", "pred_tri", "ray_o", "ray_d", "t_min", "t_max",
             "active"), args,
            ((rows, 9), (n,), (n, 3), (n, 3), (n,), (n,), (n,)),
            (f32, torch.int32, f32, f32, f32, f32, torch.bool)):
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != dev:
            raise ValueError(f"{name}: want {dtype} {shape} on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    return args


def _launch_kernel(tri_table, pred_tri, ray_o, ray_d, t_min, t_max, active):
    """One launch over all lanes on the current stream; does not
    synchronise."""
    global KERNEL_LAUNCHES
    n, dev = ray_o.shape[0], ray_o.device
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    t, u, v = (torch.empty(n, dtype=torch.float32, device=dev)
               for _ in range(3))
    if n == 0:
        return ok, t, u, v
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = kernel_library().dxrpt_history_revalidate(
            tri_table.data_ptr(), tri_table.shape[0], pred_tri.data_ptr(),
            ray_o.data_ptr(), ray_d.data_ptr(), t_min.data_ptr(),
            t_max.data_ptr(), active.data_ptr(), n, ok.data_ptr(),
            t.data_ptr(), u.data_ptr(), v.data_ptr(), stream)
        KERNEL_LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"history revalidation kernel launch failed: "
                           f"CUDA error {rc}")
    return ok, t, u, v


def revalidate_plain(tri_table, pred_tri, ray_o, ray_d, t_min, t_max,
                     active):
    """JAX `_intersect_pred`: Moller-Trumbore of each lane's predicted
    triangle (row max(pred, 0)) in the walk's expression order. Returns
    (ok, t, u, v); t, u and v are computed on every lane, ok only where the
    lane is active, its prediction a row of the table and the hit in
    [t_min, t_max)."""
    rows = tri_table.shape[0]
    row = tri_table.index_select(
        0, torch.clamp(pred_tri, 0, max(rows - 1, 0)).long())
    det_ok, u, v, t = moller_trumbore(
        [ray_o[:, c] for c in range(3)], [ray_d[:, c] for c in range(3)],
        [row[:, c] for c in range(3)], [row[:, c] for c in range(3, 6)],
        [row[:, c] for c in range(6, 9)])
    ok = (active & (pred_tri >= 0) & (pred_tri < rows) & det_ok
          & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t >= t_min) & (t < t_max))
    return ok, t, u, v


def revalidate(tri_table, pred_tri, ray_o, ray_d, t_min, t_max, active=None):
    """(ok, t, u, v) of each lane's predicted triangle (`pred_tri`, -1 for
    none) against its ray; `tri_table` is build_tri_table's on the rays'
    device."""
    args = _lanes(tri_table, pred_tri, ray_o, ray_d, t_min, t_max, active)
    dev = args[2].device
    if dev.type == "cuda":
        return _launch_kernel(*args)
    if dev.type == "cpu":
        return revalidate_plain(*args)
    raise ValueError(f"no history revalidation for device {dev}")


@spanned("traverse.history")
def seeded_closest(base_fn, tri_table, pred_tri, ray_o, ray_d, t_min, t_max,
                   active):
    """Closest hit with last sample's per-lane triangle as the t bound.
    base_fn(ray_o, ray_d, t_min, t_max, active) is a closest-hit walk
    (packets or per ray). Returns (HitRecord, the new per-lane triangle:
    the hit, -1 on a miss or an inactive lane)."""
    ok, t_p, u_p, v_p = revalidate(tri_table, pred_tri, ray_o, ray_d, t_min,
                                   t_max, active)
    rec = base_fn(ray_o, ray_d, t_min, torch.where(ok, t_p, t_max), active)
    # the walk misses below the bound where the prediction holds: the
    # predicted hit is the closest
    take = ok & (rec.tri_id < 0)
    merged = HitRecord(t=torch.where(take, t_p, rec.t),
                       tri_id=torch.where(take, pred_tri, rec.tri_id),
                       u=torch.where(take, u_p, rec.u),
                       v=torch.where(take, v_p, rec.v))
    return merged, torch.where(active, merged.tri_id, -1)


@spanned("traverse.history")
def seeded_any(base_rec_fn, tri_table, pred_tri, ray_o, ray_d, t_min, t_max,
               active):
    """Sun visibility with last sample's per-lane occluder retested first.
    base_rec_fn(ray_o, ray_d, t_min, t_max, active) -> (visibility,
    occluder id) is an any-hit walk that reports its occluder. Returns
    (visibility, the new per-lane occluder)."""
    resolved, _, _, _ = revalidate(tri_table, pred_tri, ray_o, ray_d, t_min,
                                   t_max, active)
    vis, occ = base_rec_fn(ray_o, ray_d, t_min, t_max, active & ~resolved)
    vis = torch.where(resolved, 0.0, vis)
    new_pred = torch.where(resolved, pred_tri,
                           torch.where(active, occ, -1))
    return vis, new_pred
