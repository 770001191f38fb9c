"""Row gather, out[i] = table[idx[i]]: the CUDA kernel's wrapper and its plain
version.

The port of tools/microbench_dma_gather.py::dma_gather, the JAX package's
Pallas row gather (one async DMA per row, 16 in flight). Here it is the
gather on the bake's path: the surface maps' per-texel gathers
(bake/surface_map.py) and the per-vertex 256 B shading row
(render/integrator.py::_fetch_shade_inputs).

`row_gather` launches csrc/gather.cu for CUDA tensors and runs
`row_gather_plain` for CPU tensors; it routes on the device alone and never
falls back. Callers clamp indices into [0, rows), as the JAX package's
callers do with jnp.maximum(tri, 0): the kernel does not check them.
"""

import ctypes
from pathlib import Path

import torch

from ..buildlib import build_shared_library, nvcc

KERNEL_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "gather.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]
# Tables of any 4-byte dtype: the kernel copies raw 32-bit words.
DTYPES = (torch.float32, torch.int32)

# Launches of the gather kernel since the process started (or since a caller
# last reset it). Only `_launch_kernel` adds to it.
KERNEL_LAUNCHES = 0

_kernel = None
BUILD_LOG = ""  # nvcc's -Xptxas -v report of the loaded library's build


def kernel_library():
    """csrc/gather.cu compiled for sm_90a, built at first use."""
    global _kernel, BUILD_LOG
    if _kernel is None:
        path, BUILD_LOG = build_shared_library(
            KERNEL_SOURCE, "gather", [nvcc(), *NVCC_FLAGS])
        lib = ctypes.CDLL(str(path))
        p = ctypes.c_void_p
        lib.dxrpt_row_gather.restype = ctypes.c_int
        lib.dxrpt_row_gather.argtypes = [p, p, p, ctypes.c_int64,
                                         ctypes.c_int32, p]
        _kernel = lib
    return _kernel


def _check(table, idx):
    if table.dim() != 2 or table.dtype not in DTYPES:
        raise ValueError(f"table: want a 2-D {DTYPES} tensor, got "
                         f"{table.dtype} {tuple(table.shape)}")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError(f"idx: want a 1-D int32 tensor, got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if table.device != idx.device:
        raise ValueError(f"table on {table.device}, idx on {idx.device}")


def _launch_kernel(table, idx):
    """One launch over all rows on the current stream; does not
    synchronise."""
    global KERNEL_LAUNCHES
    _check(table, idx)
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("row_gather: table and idx must be contiguous")
    n, width = idx.shape[0], table.shape[1]
    out = torch.empty((n, width), dtype=table.dtype, device=table.device)
    if n == 0 or width == 0:
        return out
    lib = kernel_library()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = lib.dxrpt_row_gather(table.data_ptr(), idx.data_ptr(),
                                  out.data_ptr(), n, width, stream)
        KERNEL_LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"gather kernel launch failed: CUDA error {rc}")
    return out


def row_gather_plain(table, idx):
    """The plain version: `table[idx.long()]`."""
    _check(table, idx)
    return table[idx.long()]


def row_gather(table, idx):
    """(rows, width) table, (n,) int32 idx in [0, rows) -> (n, width)."""
    if table.device.type == "cuda":
        return _launch_kernel(table, idx)
    if table.device.type == "cpu":
        return row_gather_plain(table, idx)
    raise ValueError(f"no row gather for device {table.device}")
