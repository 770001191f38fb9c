"""GGX / Lambertian BRDF math on torch tensors.

The port of dxrpathtracer_tpu/core/brdf.py (BRDF.hlsl:16-261): Schlick Fresnel
with the 0.1%-albedo fade, Smith GGX masking/shadowing, the analytic GGX
environment-BRDF scale/bias used for multiscattering energy compensation, and
CalcLighting. Elementwise over batched float32 tensors, op for op the JAX
versions.
"""

import torch

from .constants import Pi
from .math3 import dot, dot3, normalize, saturate, sqrt


def _pow5(x):
    """x ** 5 with lax.integer_pow's multiplication order: x * (x^2)^2."""
    x2 = x * x
    return x * (x2 * x2)


def fresnel(spec_albedo, h, l):
    """Schlick Fresnel with low-albedo fade (BRDF.hlsl:16-24)."""
    l_dot_h = saturate(dot(l, h))[..., None]
    f = spec_albedo + (1.0 - spec_albedo) * _pow5(1.0 - l_dot_h)
    # Fade out spec entirely when lower than 0.1% albedo
    f = f * saturate(dot3(spec_albedo, torch.full_like(spec_albedo, 333.0),
                          keepdims=True))
    return f


def ggx_v1(m2, n_dot_x):
    """Helper for the GGX visibility term (BRDF.hlsl:89-92)."""
    return 1.0 / (n_dot_x + sqrt(m2 + (1.0 - m2) * n_dot_x * n_dot_x))


def ggx_visibility(m2, n_dot_l, n_dot_v):
    return ggx_v1(m2, n_dot_l) * ggx_v1(m2, n_dot_v)


def smith_ggx_masking(n, l, v, a2):
    """G1 for VNDF sampling (BRDF.hlsl:102-109)."""
    n_dot_v = saturate(dot(n, v))
    denom_c = sqrt(a2 + (1.0 - a2) * n_dot_v * n_dot_v) + n_dot_v
    return 2.0 * n_dot_v / denom_c


def smith_ggx_masking_shadowing(n, l, v, a2):
    """G2 for VNDF sampling (BRDF.hlsl:111-120)."""
    n_dot_l = saturate(dot(n, l))
    n_dot_v = saturate(dot(n, v))
    denom_a = n_dot_v * sqrt(a2 + (1.0 - a2) * n_dot_l * n_dot_l)
    denom_b = n_dot_l * sqrt(a2 + (1.0 - a2) * n_dot_v * n_dot_v)
    return 2.0 * n_dot_l * n_dot_v / (denom_a + denom_b)


def ggx_specular(m, n, h, v, l):
    """GGX NDF x separable visibility (BRDF.hlsl:128-145)."""
    n_dot_h = saturate(dot(n, h))
    n_dot_l = saturate(dot(n, l))
    n_dot_v = saturate(dot(n, v))
    m2 = m * m
    x = n_dot_h * n_dot_h * (m2 - 1.0) + 1.0
    d = m2 / (Pi * x * x)
    vis = ggx_visibility(m2, n_dot_l, n_dot_v)
    return d * vis


def ggx_environment_brdf_scale_bias(n_dot_v, sqrt_roughness):
    """Fitted split-sum env-BRDF polynomial (BRDF.hlsl:209-224)."""
    n_dot_v2 = n_dot_v * n_dot_v
    sr2 = sqrt_roughness * sqrt_roughness
    sr3 = sr2 * sqrt_roughness
    delta = (0.991086418474895
             + 0.412367709802119 * sqrt_roughness * n_dot_v2
             - 0.363848256078895 * sr2
             - 0.758634385642633 * n_dot_v * sr2)
    denom = 0.0272458171384516 + sr3 + n_dot_v2
    # full_like(...) / denom rounds once; `scalar / tensor` in torch is
    # reciprocal() * scalar, which rounds twice
    bias = saturate(0.0306613448029984 * sqrt_roughness
                    + torch.full_like(denom, 0.0238299731830387) / denom
                    - 0.0454747751719356)
    scale = saturate(delta - bias)
    return scale, bias


def calc_lighting(normal, light_dir, peak_irradiance, diffuse_albedo, specular_albedo,
                  roughness, position_ws, camera_pos_ws, ms_energy_compensation):
    """Per-analytic-light shading (BRDF.hlsl:241-261): Lambert diffuse + GGX
    specular (specular only when NdotL > 0), times NdotL * peakIrradiance."""
    lighting = diffuse_albedo * (1.0 / 3.14159)

    view = normalize(camera_pos_ws - position_ws, eps=1e-37)
    n_dot_l = saturate(dot(normal, light_dir))
    h = normalize(view + light_dir, eps=1e-37)
    f = fresnel(specular_albedo, h, light_dir)
    spec = ggx_specular(roughness, normal, h, view, light_dir)
    spec_term = spec[..., None] * f * ms_energy_compensation
    lighting = lighting + torch.where((n_dot_l > 0.0)[..., None], spec_term, 0.0)

    return lighting * n_dot_l[..., None] * peak_irradiance
