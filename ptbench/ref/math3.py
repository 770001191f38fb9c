# Frozen copy of dxrpathtracer_tpu_torch/core/math3.py for the benchmark's
# reference; it imports nothing of the program.
"""Batched 3-vector helpers on torch tensors.

The port of dxrpathtracer_tpu/core/math3.py. Vectors are (..., 3) float32.
Matrices follow the reference's DirectXMath row-vector convention
(SampleFramework12 SF12_Math.h): points and directions are row vectors
transformed as ``v @ M``, written out as multiply-adds.
"""

import torch


def _via_f64(fn, x):
    return fn(x.double()).to(x.dtype)


# sqrt, arccos and exp are evaluated in float64 and rounded once to float32:
# the result is the correctly rounded float32 on every device (but for a
# float64 result within an ulp of a float32 rounding boundary), so the CPU and
# the GPU give the same bits. (Torch's vectorized CPU sqrt is an ulp off in
# about 1 % of lanes and its sin/cos differ from XLA's in about 5 %; XLA's
# sin/cos are glibc's, correctly rounded in about 99 % of lanes.)
def sqrt(x):
    return _via_f64(torch.sqrt, x)


# sin and cos use no library transcendental: fdlibm's argument reduction
# (x - k*pio2_1 - k*pio2_1t, k = round(x * 2/pi)) and its k_sin/k_cos
# polynomials on [-pi/4, pi/4] (s_sin.c, k_sin.c, k_cos.c), in float64
# adds and multiplies, each rounded as IEEE 754 says on every device and in
# every thread, then rounded once to float32. The float64 result is within
# about an ulp of sin(x), so the float32 is the correctly rounded one but
# where sin(x) lies within 2^-29 relative of a float32 rounding boundary.
# The reduction is exact for |x| <= 2^19 * pi/2 (k * pio2_1 has no rounding
# there); the callers' angles lie within [-2pi, 2pi].
_INV_PIO2 = 6.36619772367581382433e-01
_PIO2_1 = 1.57079632673412561417e+00      # the first 33 bits of pi/2
_PIO2_1T = 6.07710050650619224932e-11     # pi/2 - _PIO2_1
_S = (-1.66666666666666324348e-01, 8.33333333332248946124e-03,
      -1.98412698298579493134e-04, 2.75573137070700676789e-06,
      -2.50507602534068634195e-08, 1.58969099521155010221e-10)
_C = (4.16666666666666019037e-02, -1.38888888888741095749e-03,
      2.48015872894767294178e-05, -2.75573143513906633035e-07,
      2.08757232129817482790e-09, -1.13596475577881948265e-11)


def _reduce(x):
    """(r, k mod 4) with x = k*pi/2 + r, |r| <= ~pi/4, x float64."""
    k = torch.round(x * _INV_PIO2)
    r = (x - k * _PIO2_1) - k * _PIO2_1T
    return r, torch.remainder(k, 4.0)


def _k_sin(r):
    z = r * r
    p = _S[1] + z * (_S[2] + z * (_S[3] + z * (_S[4] + z * _S[5])))
    return r + (z * r) * (_S[0] + z * p)


def _k_cos(r):
    z = r * r
    p = z * (_C[0] + z * (_C[1] + z * (_C[2] + z * (_C[3] + z * (
        _C[4] + z * _C[5])))))
    hz = 0.5 * z
    w = 1.0 - hz
    return w + (((1.0 - w) - hz) + z * p)


def _sincos(x, phase: int):
    x64 = x.double()
    r, q = _reduce(x64)
    q = torch.remainder(q + phase, 4.0)
    s, c = _k_sin(r), _k_cos(r)
    # sin: q = 0 -> sin r, 1 -> cos r, 2 -> -sin r, 3 -> -cos r
    y = torch.where(q == 0, s, torch.where(q == 1, c,
                                           torch.where(q == 2, -s, -c)))
    if phase == 0:
        y = torch.where(x64 == 0.0, x64, y)  # sin(-0) = -0
    return y.to(x.dtype)


def sin(x):
    return _sincos(x, 0)


def cos(x):
    return _sincos(x, 1)


def arccos(x):
    return _via_f64(torch.acos, x)


def exp(x):
    return _via_f64(torch.exp, x)


# Division by a number: ATen's CUDA true-divide turns a divisor that is a
# Python number (or a CPU scalar tensor) into a multiply by its reciprocal,
# which rounds twice, while its CPU kernel divides; with the divisor on the
# tensor's own device both divide, and the card gives the CPU's bits. So a
# device path never writes `tensor / number` where the number may not be a
# power of two: it writes div(tensor, number).
def div(x, d):
    """x / d, d a Python number, divided on x's device."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def vec3(x, y, z, dtype=torch.float32):
    """(..., 3) from three broadcast components."""
    return torch.stack(torch.broadcast_tensors(
        torch.as_tensor(x, dtype=dtype), torch.as_tensor(y, dtype=dtype),
        torch.as_tensor(z, dtype=dtype)), dim=-1)


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


def length(v):
    return sqrt(torch.clamp_min(dot(v, v), 0.0))


def normalize(v, eps=0.0):
    l = sqrt(torch.clamp_min(dot3(v, v, keepdims=True), eps))
    return v / l


def safe_normalize(v):
    """Normalize; zero vectors map to zero (no NaN)."""
    l2 = dot3(v, v, keepdims=True)
    inv = torch.where(l2 > 0.0, 1.0 / sqrt(torch.clamp_min(l2, 1e-37)), 0.0)
    return v * inv


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def lerp(a, b, t):
    return a + (b - a) * t


def smoothstep(edge0, edge1, x):
    t = torch.clamp((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def reflect(i, n):
    """HLSL reflect: i - 2*dot(i,n)*n (i points toward the surface)."""
    return i - 2.0 * dot3(i, n, keepdims=True) * n


def transform_point(p, m):
    """Row-vector transform of (..., 3) points by a (4, 4) matrix, with the
    w divide."""
    out = (p[..., 0:1] * m[0] + p[..., 1:2] * m[1] + p[..., 2:3] * m[2]
           + m[3])
    return out[..., :3] / out[..., 3:4]


def transform_h(p_h, m):
    """Row-vector transform of (..., 4) homogeneous points; no divide."""
    return (p_h[..., 0:1] * m[0] + p_h[..., 1:2] * m[1]
            + p_h[..., 2:3] * m[2] + p_h[..., 3:4] * m[3])


def transform_dir(d, m):
    """Row-vector transform of (..., 3) directions (no translation)."""
    return (d[..., 0:1] * m[0, :3] + d[..., 1:2] * m[1, :3]
            + d[..., 2:3] * m[2, :3])


def luminance(rgb):
    """Rec.709 luma as the reference's resolve and denoise shaders take
    it."""
    return dot(rgb, torch.tensor([0.299, 0.587, 0.114], dtype=rgb.dtype,
                                 device=rgb.device))


def orthonormal_basis(n):
    """A tangent frame (t, bt) around the unit normal n (branchless,
    Frisvad-style)."""
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b,
                     -sign * n[..., 0]], dim=-1)
    bt = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]],
                     dim=-1)
    return t, bt
