"""Batched 3-vector helpers on torch tensors.

The port of the parts of dxrpathtracer_tpu/core/math3.py the path tracer uses.
Vectors are (..., 3) float32. Matrices follow the reference's DirectXMath
row-vector convention (SampleFramework12 SF12_Math.h).
"""

import torch


def _via_f64(fn, x):
    return fn(x.double()).to(x.dtype)


# sqrt, sin and cos are evaluated in float64 and rounded once to float32: the
# result is the correctly rounded float32 on every device, so the CPU and the
# GPU give the same bits. (Torch's vectorized CPU sqrt is an ulp off in about
# 1 % of lanes and its sin/cos differ from XLA's in about 5 %; XLA's sin/cos
# are glibc's, correctly rounded in about 99 % of lanes.)
def sqrt(x):
    return _via_f64(torch.sqrt, x)


def sin(x):
    return _via_f64(torch.sin, x)


def cos(x):
    return _via_f64(torch.cos, x)


def dot(a, b):
    """Sum of the three products, left to right (as XLA reduces them; a
    torch reduction may take another order on another device)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def dot3(a, b, keepdims=False):
    d = dot(a, b)
    return d[..., None] if keepdims else d


def cross(a, b):
    """a x b, component formula (as jnp.cross evaluates it)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def normalize(v, eps=0.0):
    l = sqrt(torch.clamp_min(dot3(v, v, keepdims=True), eps))
    return v / l


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def smoothstep(edge0, edge1, x):
    t = torch.clamp((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def reflect(i, n):
    """HLSL reflect: i - 2*dot(i,n)*n (i points toward the surface)."""
    return i - 2.0 * dot3(i, n, keepdims=True) * n
