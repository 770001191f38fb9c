"""Denoisers for the lightmap bake, as torch ops on (H, W, 3) images.

The port of dxrpathtracer_tpu/render/denoise.py, op for op:

median_filter_3x3 — parity with DenoiseMedian.hlsl:52-103 ("GPU Median
Denoise"): per texel, collect the 3x3 clamped neighbourhood, order by Rec.601
luminance with a *stable* sort (the HLSL uses insertion sort), output the
median (index 4).

atrous_denoise — an edge-avoiding A-trous wavelet smoother [Dammertz et al.
2010] with luminance-guided range weights.

guided_bilateral_denoise — the OIDN-bridge replacement (OidnDenoiser.cpp:
39-94): a joint-bilateral filter guided by the bake's own surface maps
(albedo + normal, bake/surface_map.py), after a selective despike.

These were XLA-lowered loops in the JAX package, not Pallas kernels; here
they are eager torch ops on the image's device.
"""

import torch

from ..core.math3 import dot

_LUMA = (0.299, 0.587, 0.114)


def luminance(rgb):
    """Rec.601 luminance of (..., 3), the products summed left to right."""
    return rgb[..., 0] * _LUMA[0] + rgb[..., 1] * _LUMA[1] + rgb[..., 2] * _LUMA[2]


def _clamped(size, offset, device):
    return torch.clamp(torch.arange(size, device=device) + offset, 0, size - 1)


def _shift(a, ys, xs):
    """a[ys][:, xs]: the image read at clamped offsets."""
    return a.index_select(0, ys).index_select(1, xs)


def median_filter_3x3(img):
    """(H, W, 3) -> (H, W, 3) luminance-median of the 3x3 neighbourhood."""
    h, w = img.shape[:2]
    dev = img.device
    stack = [_shift(img, _clamped(h, dy, dev), _clamped(w, dx, dev))
             for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    neigh = torch.stack(stack, dim=0)  # (9, H, W, 3)
    order = torch.sort(luminance(neigh), dim=0, stable=True).indices
    med_idx = order[4][None, ..., None].expand(1, h, w, img.shape[2])
    return torch.take_along_dim(neigh, med_idx, dim=0)[0]


def _log_luminance(img):
    return torch.log1p(luminance(torch.clamp_min(img, 0.0)))


# B3-spline 5-tap kernel; every value and pairwise product is exact in f32.
_K1D = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
_TAPS = [(i, j) for i in range(-2, 3) for j in range(-2, 3)]


def _tap_weight(dy, dx):
    return _K1D[dy + 2] * _K1D[dx + 2]


def atrous_denoise(img, iterations: int = 4, sigma_l: float = 4.0,
                   valid=None):
    """Edge-avoiding A-trous wavelet denoise of an HDR (H, W, 3) image.

    iterations: number of dyadic-dilation passes (radius grows 1,2,4,8...).
    sigma_l: luminance range sigma (relative, in log-luminance space).
    valid: optional (H, W) mask of texels that hold data (bake coverage);
           invalid texels have zero weight and get in-filled.
    """
    h, w = img.shape[:2]
    dev = img.device
    out = img
    vmask = (torch.ones((h, w), dtype=torch.float32, device=dev)
             if valid is None else valid.to(torch.float32))
    for it in range(iterations):
        step = 1 << it
        lum = _log_luminance(out)
        acc = torch.zeros_like(out)
        wacc = torch.zeros((h, w), dtype=torch.float32, device=dev)
        for dy, dx in _TAPS:
            ys = _clamped(h, dy * step, dev)
            xs = _clamped(w, dx * step, dev)
            range_w = torch.exp(-torch.square(_shift(lum, ys, xs) - lum)
                                * sigma_l)
            wgt = _tap_weight(dy, dx) * range_w * _shift(vmask, ys, xs)
            acc = acc + _shift(out, ys, xs) * wgt[..., None]
            wacc = wacc + wgt
        filled = acc / torch.clamp_min(wacc, 1e-8)[..., None]
        # Texels with no valid support keep their value (later passes reach
        # them)
        out = torch.where((wacc > 1e-8)[..., None], filled, out)
    return out


def despike(img):
    """Selective firefly removal: texels whose luminance exceeds 8x the
    local 3x3 median take that median; structure is untouched."""
    med = median_filter_3x3(img)
    spike = (luminance(torch.clamp_min(img, 0.0))
             > 8.0 * (luminance(torch.clamp_min(med, 0.0)) + 1e-4))
    return torch.where(spike[..., None], med, img)


def guided_bilateral_denoise(img, albedo, normal, valid=None,
                             iterations: int = 4, sigma_l: float = 0.5,
                             sigma_n: float = 32.0, sigma_a: float = 16.0):
    """Surface-map-guided joint-bilateral denoise of an HDR lightmap.

    img: (H, W, 3) noisy irradiance; albedo/normal: (H, W, 3) surface maps
    (bake/surface_map.py); valid: (H, W) coverage mask. A-trous dyadic
    dilation like atrous_denoise, but the range term is driven by the
    guides: normals keep geometric edges, albedo material borders, and
    luminance only weakly (small sigma_l), so noise is averaged.
    """
    h, w = img.shape[:2]
    dev = img.device
    # A bilateral keeps an isolated firefly as an edge: despike first.
    out = despike(img)
    vmask = (torch.ones((h, w), dtype=torch.float32, device=dev)
             if valid is None else valid.to(torch.float32))
    for it in range(iterations):
        step = 1 << it
        lum = _log_luminance(out)
        acc = torch.zeros_like(out)
        wacc = torch.zeros((h, w), dtype=torch.float32, device=dev)
        for dy, dx in _TAPS:
            ys = _clamped(h, dy * step, dev)
            xs = _clamped(w, dx * step, dev)
            w_l = torch.exp(-torch.square(_shift(lum, ys, xs) - lum) * sigma_l)
            n_dot = dot(_shift(normal, ys, xs), normal)
            w_n = torch.exp(-(1.0 - torch.clamp(n_dot, 0.0, 1.0)) * sigma_n)
            da = torch.square(_shift(albedo, ys, xs) - albedo)
            w_a = torch.exp(-(da[..., 0] + da[..., 1] + da[..., 2]) * sigma_a)
            wgt = _tap_weight(dy, dx) * w_l * w_n * w_a * _shift(vmask, ys, xs)
            acc = acc + _shift(out, ys, xs) * wgt[..., None]
            wacc = wacc + wgt
        filled = acc / torch.clamp_min(wacc, 1e-8)[..., None]
        out = torch.where((wacc > 1e-8)[..., None], filled, out)
    return out
