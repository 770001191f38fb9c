"""dxrpathtracer_tpu_torch — the PyTorch / CUDA port of dxrpathtracer_tpu.

The JAX package beside it is the reference; this package renders the same
progressive path-traced frame with PyTorch tensors, and sends every ray
through one hand-written CUDA traversal kernel (csrc/traverse.cu) when its
tensors lie on a GPU. On the CPU each kernel's plain PyTorch version runs
instead, so the tests can hold the port against the JAX package.

Layer map (mirrors dxrpathtracer_tpu/):
  core/    — constants, quaternions, CMJ sampler, sampling, BRDF (torch)
  scene/   — procedural meshes, texture atlas, scene build (numpy host layer)
  accel/   — native SAH BVH build (ctypes) and traversal (CUDA kernel + plain)
  sky/     — Hosek-Wilkie sky cache (numpy) and cubemap taps (torch)
  render/  — camera (numpy) and the per-ray wavefront integrator (torch)
  app/     — settings and RenderSession
  convert  — JAX-package host arrays -> port objects (parity tests)

This package imports no JAX. Public functions take an explicit device.
"""

import torch

__version__ = "0.1.0"

# Full float32 everywhere: the raygen unprojection and the Hosek-derived
# constants cancel badly in reduced precision (a TF32 product turns the
# far-plane w into 0).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
