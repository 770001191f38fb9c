# Frozen copy of dxrpathtracer_tpu_torch/core/sampling.py for the benchmark's
# reference; it imports nothing of the program.
"""Monte-Carlo direction sampling on torch tensors.

The port of dxrpathtracer_tpu/core/sampling.py (Sampling.hlsl:72-242):
concentric disk mapping, cosine hemisphere and GGX visible-normal (VNDF)
sampling, which the path tracer uses, and the sphere, hemisphere and cone
samplers with the matching pdfs, op for op the JAX versions. Branches are
masked selects so one call covers a whole ray wavefront.
"""

import torch

from .constants import Pi
from .math3 import cos, cross, div, dot, dot3, saturate, sin, sqrt


def square_to_concentric_disk(x, y):
    """Shirley-Chiu low-distortion square->disk map (Sampling.hlsl:72-114)."""
    a = 2.0 * x - 1.0
    b = 2.0 * y - 1.0

    def safe_div(p, q):
        return p / torch.where(q == 0.0, 1.0, q)

    r1 = a
    phi1 = (Pi / 4.0) * safe_div(b, a)
    r2 = b
    phi2 = (Pi / 4.0) * (2.0 - safe_div(a, b))
    r3 = -a
    phi3 = (Pi / 4.0) * (4.0 + safe_div(b, a))
    r4 = -b
    phi4 = torch.where(b != 0.0, (Pi / 4.0) * (6.0 - safe_div(a, b)), 0.0)

    region12 = a > -b
    r = torch.where(region12,
                    torch.where(a > b, r1, r2),
                    torch.where(a < b, r3, r4))
    phi = torch.where(region12,
                      torch.where(a > b, phi1, phi2),
                      torch.where(a < b, phi3, phi4))
    return torch.stack([r * cos(phi), r * sin(phi)], dim=-1)


def sample_cosine_hemisphere(u1, u2):
    """Cosine-weighted hemisphere around +z via concentric disk (Sampling.hlsl:181-196)."""
    uv = square_to_concentric_disk(u1, u2)
    u = uv[..., 0]
    v = uv[..., 1]
    r = u * u + v * v
    z = sqrt(torch.clamp_min(1.0 - r, 0.0))
    return torch.stack([u, v, z], dim=-1)


def _norm(v):
    return sqrt(dot3(v, v, keepdims=True))


def sample_ggx_visible_normal(wo, ax, ay, u1, u2):
    """GGX VNDF sampling [Heitz17] (Sampling.hlsl:131-154).

    wo: (..., 3) outgoing dir in tangent space (+z up); returns microfacet normal.
    """
    # Stretch the view vector so we sample as though roughness == 1
    v = torch.stack([wo[..., 0] * ax, wo[..., 1] * ay, wo[..., 2]], dim=-1)
    v = v / _norm(v)

    # Orthonormal basis around v
    vz = v[..., 2]
    # t1 = normalize(cross(v, z)) when v.z < 0.999 else (1,0,0)
    cross_vz = torch.stack([v[..., 1], -v[..., 0], torch.zeros_like(vz)], dim=-1)
    cl = _norm(cross_vz)
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=v.dtype, device=v.device)
    t1 = torch.where((vz < 0.999)[..., None],
                     cross_vz / torch.where(cl == 0.0, 1.0, cl),
                     x_axis)
    t2 = cross(t1, v)

    # Half-disk-weighted point
    a = 1.0 / (1.0 + vz)
    r = sqrt(u1)
    lower = u2 < a
    phi = torch.where(lower, (u2 / a) * Pi, Pi + (u2 - a) / (1.0 - a) * Pi)
    p1 = r * cos(phi)
    p2 = r * sin(phi) * torch.where(lower, 1.0, vz)

    n = (p1[..., None] * t1 + p2[..., None] * t2
         + sqrt(torch.clamp_min(1.0 - p1 * p1 - p2 * p2, 0.0))[..., None] * v)

    # Unstretch
    n = torch.stack([ax * n[..., 0], ay * n[..., 1],
                     torch.clamp_min(n[..., 2], 0.0)], dim=-1)
    return n / _norm(n)


def sample_direction_sphere(u1, u2):
    """Uniform sphere (Sampling.hlsl:157-166)."""
    z = u1 * 2.0 - 1.0
    r = sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * Pi * u2
    return torch.stack([r * cos(phi), r * sin(phi), z], dim=-1)


def sample_direction_hemisphere(u1, u2):
    """Uniform hemisphere around +z (Sampling.hlsl:169-178)."""
    z = u1
    r = sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * Pi * u2
    return torch.stack([r * cos(phi), r * sin(phi), z], dim=-1)


def sample_direction_cone(u1, u2, cos_theta_max):
    """Uniform cone around +z (Sampling.hlsl:199-205)."""
    cos_theta = (1.0 - u1) + u1 * cos_theta_max
    sin_theta = sqrt(1.0 - cos_theta * cos_theta)
    phi = u2 * 2.0 * Pi
    return torch.stack([cos(phi) * sin_theta, sin(phi) * sin_theta,
                        cos_theta], dim=-1)


def pdf_cosine_hemisphere(cos_theta):
    return div(cos_theta, Pi)


def pdf_cosine_hemisphere_dir(normal, sample_dir):
    return div(saturate(dot(normal, sample_dir)), Pi)


def pdf_hemisphere():
    return 1.0 / (Pi * 2.0)


def pdf_sphere():
    return 1.0 / (Pi * 4.0)


def pdf_cone(cos_theta_max):
    return 1.0 / (2.0 * Pi * (1.0 - cos_theta_max))


def pdf_ggx(n, h, v, roughness):
    """SampleDirectionGGX_PDF (Sampling.hlsl:233-242)."""
    n_dot_h = saturate(dot(n, h))
    h_dot_v = saturate(dot(h, v))
    m2 = roughness * roughness
    x = n_dot_h * n_dot_h * (m2 - 1.0) + 1.0
    d = m2 / (Pi * x * x)
    return d * n_dot_h / (4.0 * h_dot_v)
