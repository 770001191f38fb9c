"""Post-processing: bloom, the filmic tone curve and the weighted resolve.

The port of dxrpathtracer_tpu/render/postfx.py (PostProcessing.hlsl:18-127,
PostProcessor.cpp:43-92), as torch ops; the JAX package leaves this chain to
XLA too:
  bloom  — 2x2 average downscale to half res (GatherRed/Green/Blue average),
           then 2 iterations of separable Gaussian blur with taps i in [-7, 7)
           and *unnormalized* weights (Blur(..., nrmlize=false))
  tonemap— color + bilinear-upscaled bloom * BloomMagnitude * exp2(BloomExposure),
           exposure exp2(Exposure)/FP16Scale, then HP Duiker filmic ALU curve
           (output is sRGB-encoded by the curve itself)
Images are (H, W, 3) f32, the JAX package's layout.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..core.constants import FP16Scale


def _gaussian_weights(sigma):
    """CalcGaussianWeight for taps -7..6 (PostProcessing.hlsl:19-23,33-52)."""
    i = np.arange(-7, 7, dtype=np.float32)
    g = 1.0 / np.sqrt(2.0 * 3.14159 * sigma * sigma)
    return (g * np.exp(-(i * i) / (2.0 * sigma * sigma))).astype(np.float32)


def _blur_1d(img, weights, axis: int):
    """Unnormalized 14-tap blur with clamp addressing along `axis`, the taps
    summed in order."""
    size = img.shape[axis]
    idx = torch.arange(size, device=img.device)
    out = torch.zeros_like(img)
    for k, off in enumerate(range(-7, 7)):
        shifted = img.index_select(axis, torch.clamp(idx + off, 0, size - 1))
        out = out + shifted * float(weights[k])
    return out


def bloom_pass(color, bloom_blur_sigma: float):
    """(H, W, 3) radiance -> (H/2, W/2, 3) blurred bloom source."""
    h, w = color.shape[:2]
    half = color[: h // 2 * 2, : w // 2 * 2].reshape(
        h // 2, 2, w // 2, 2, 3).mean(dim=(1, 3))
    weights = _gaussian_weights(float(bloom_blur_sigma))
    for _ in range(2):
        half = _blur_1d(half, weights, axis=1)  # horizontal
        half = _blur_1d(half, weights, axis=0)  # vertical
    return half


def tone_map_filmic_alu(color):
    """HP Duiker film-stock curve approximation (PostProcessing.hlsl:55-60).
    The curve bakes in sRGB encoding."""
    color = torch.clamp_min(color - 0.004, 0.0)
    return ((color * (6.2 * color + 0.5))
            / (color * (6.2 * color + 1.7) + 0.06))


def _upscale_bilinear_2x(img, out_h: int, out_w: int):
    """jax.image.resize(..., "bilinear") to (out_h, out_w): half-pixel
    centres, the edge samples clamped (jax renormalises the weights of the
    taps inside the image, which gives the edge texel, as the clamp does)."""
    x = img.permute(2, 0, 1)[None]
    out = F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                        align_corners=False)
    return out[0].permute(1, 2, 0)


def post_process(color, exposure: float, bloom_exposure: float,
                 bloom_magnitude: float, bloom_blur_sigma: float):
    """Full chain (PostProcessor::Render): returns display-ready sRGB in [0, 1]."""
    h, w = color.shape[:2]
    out = color
    if h >= 2 and w >= 2:
        bloom = bloom_pass(color, bloom_blur_sigma)
        bloom_up = _upscale_bilinear_2x(bloom, h, w)
        out = out + bloom_up * bloom_magnitude * (2.0 ** bloom_exposure)
    out = out * ((2.0 ** exposure) / FP16Scale)
    return tone_map_filmic_alu(out)


def resolve_weighted(samples, exposure: float):
    """Firefly-resistant MSAA-style resolve (Resolve.hlsl:33-65): inverse-
    luminance-weighted average over the sample axis (leading axis)."""
    exposure_w = (2.0 ** (exposure + 2.0)) / FP16Scale
    s = torch.clamp_min(samples, 0.0)
    lum = (s[..., 0] * 0.299 + s[..., 1] * 0.587 + s[..., 2] * 0.114) * exposure_w
    wgt = 1.0 / (1.0 + lum)
    summed = (s * wgt[..., None]).sum(dim=0)
    total = torch.clamp_min(wgt.sum(dim=0), 1e-5)
    return torch.clamp_min(summed / total[..., None], 0.0)
