"""Bilinear wrap tap at mip 0 of the texel pool: the CUDA kernel's wrapper.

The material-map taps of the shading step, the surface map's albedo and the
split-alpha route's opacity (scene/textures.py::bilinear_from_meta) launch
csrc/taps.cu for CUDA tensors: one thread a lane computes the whole tap,
bit for bit its plain twin, textures.bilinear_from_meta_plain, which the
CPU route runs. `bilinear_from_meta` routes on the device alone and never
falls back. The JAX package has no TPU kernel for the tap (XLA fuses it);
the kernel replaces the twin's ~47 torch kernels a tap.

Lanes may come in any shape: base, w and h (...,) int32 and uv (..., 2)
float32 of the same leading shape, each read in place through its element
strides where it flattens to one dimension without a copy (the integrator's
strided views do). The wrapper reads no device value on the host.
"""

import ctypes
from pathlib import Path

import torch

from ..app.profiler import count
from ..buildlib import build_shared_library, nvcc

KERNEL_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "taps.cu"
# --fmad=false: every product and sum rounds on its own, as the twin's
# separate torch kernels round them
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC"]

# Launches of the tap kernel since the process started (or since a caller
# last reset it). Only `_launch_kernel` adds to it.
KERNEL_LAUNCHES = 0

_kernel = None
BUILD_LOG = ""  # nvcc's -Xptxas -v report of the loaded library's build


def kernel_library():
    """csrc/taps.cu compiled for sm_90a, built at first use."""
    global _kernel, BUILD_LOG
    if _kernel is None:
        path, BUILD_LOG = build_shared_library(
            KERNEL_SOURCE, "taps", [nvcc(), *NVCC_FLAGS])
        lib = ctypes.CDLL(str(path))
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.dxrpt_bilinear_tap.restype = ctypes.c_int
        lib.dxrpt_bilinear_tap.argtypes = [p, p, i64, i64, p, i64, p, i64, p,
                                           i64, p, i64, p]
        _kernel = lib
    return _kernel


def _check(texels, base, w, h, uv):
    if (texels.dim() != 2 or texels.shape[1] != 4
            or texels.dtype != torch.float32 or not texels.is_contiguous()):
        raise ValueError(f"texels: want a contiguous (total, 4) float32 "
                         f"tensor, got {texels.dtype} {tuple(texels.shape)}"
                         f"{'' if texels.is_contiguous() else ' strided'}")
    for name, t in (("base", base), ("w", w), ("h", h)):
        if t.dtype != torch.int32 or t.shape != base.shape:
            raise ValueError(f"{name}: want int32 of base's shape "
                             f"{tuple(base.shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if uv.dtype != torch.float32 or uv.shape != (*base.shape, 2):
        raise ValueError(f"uv: want float32 {(*base.shape, 2)}, got "
                         f"{uv.dtype} {tuple(uv.shape)}")
    for t in (base, w, h, uv):
        if t.device != texels.device:
            raise ValueError(f"texels on {texels.device}, lanes on "
                             f"{t.device}")


def _launch_kernel(texels, base, w, h, uv):
    """One launch over all lanes on the current stream; does not
    synchronise. -> (..., 4) float32."""
    global KERNEL_LAUNCHES
    _check(texels, base, w, h, uv)
    # views where the lanes flatten without a copy (1-D lanes always do)
    b, wl, hl = (t.reshape(-1) for t in (base, w, h))
    uvl = uv.reshape(-1, 2)
    n = b.shape[0]
    if texels.data_ptr() % 16:
        raise ValueError("texels: the kernel reads 16-byte aligned rows")
    out = torch.empty((n, 4), dtype=torch.float32, device=texels.device)
    if n:
        lib = kernel_library()
        with torch.cuda.device(texels.device):
            stream = torch.cuda.current_stream(texels.device).cuda_stream
            rc = lib.dxrpt_bilinear_tap(
                texels.data_ptr(), uvl.data_ptr(), uvl.stride(0),
                uvl.stride(1), b.data_ptr(), b.stride(0), wl.data_ptr(),
                wl.stride(0), hl.data_ptr(), hl.stride(0), out.data_ptr(), n,
                stream)
            KERNEL_LAUNCHES += 1
            count("tap_kernel")
        if rc != 0:
            raise RuntimeError(f"tap kernel launch failed: CUDA error {rc}")
    return out.reshape(*base.shape, 4)
