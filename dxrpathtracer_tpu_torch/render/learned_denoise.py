"""Learned lightmap denoiser — the neural OIDN-class option, as an nn.Module.

The port of dxrpathtracer_tpu/render/learned_denoise.py. A compact residual
CNN over the inputs OIDN's RTLightmap consumes (HDR irradiance + albedo +
normal); the shipped weights were trained by the JAX package's trainer, and
the port's own (dxrpathtracer_tpu_torch/tools/train_denoiser.py) trains
new ones on the card:
  - five dilated 3x3 convolutions (dilations 1,2,4,2,1) with ReLU, then a
    3x3 head that predicts a residual in log1p space on top of the guided
    joint-bilateral output (render/denoise.py);
  - isolated fireflies are despiked first with the guided filter's
    selective median;
  - maps larger than `tile` are processed in overlapping tiles.

The public function keeps the JAX package's (H, W, C) layout; the module
runs NCHW inside. TF32 stays off (dxrpathtracer_tpu_torch/__init__.py), so
the convolutions run in full float32.

The training API's two functions: `init_net` (the JAX `init_params`
scheme, drawn from a torch.Generator: JAX's threefry draws are not
reproduced) and `save_net` (the weight file the JAX `load_params` reads).
"""

import numpy as np
import torch
from torch import nn

from ..convert import denoiser_params_from_numpy, load_denoiser_weights
from .denoise import despike, guided_bilateral_denoise

# (out_channels, dilation) per hidden layer; every kernel is 3x3.
ARCH = ((32, 1), (48, 2), (48, 4), (32, 2), (16, 1))
# log1p(noisy) 3 + log1p(guided) 3 + albedo 3 + normal 3 + valid 1
IN_CHANNELS = 13
OUT_CHANNELS = 3   # residual in log1p space, added to log1p(guided)

# receptive field: net 22 px, plus the guided bilateral's a-trous reach
# 30 px and its 3x3 despike; 64 of overlap covers the combined 53 px.
TILE = 512
OVERLAP = 64


class DenoiserNet(nn.Module):
    """The residual CNN: ARCH's dilated 3x3 convs with ReLU, then the head.
    SAME padding: a 3x3 kernel at dilation d pads d on every side."""

    def __init__(self):
        super().__init__()
        layers = []
        cin = IN_CHANNELS
        for cout, dil in ARCH:
            layers.append(nn.Conv2d(cin, cout, 3, padding=dil, dilation=dil))
            cin = cout
        layers.append(nn.Conv2d(cin, OUT_CHANNELS, 3, padding=1))
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        """(N, IN_CHANNELS, H, W) features -> (N, 3, H, W) residual."""
        for conv in self.layers[:-1]:
            x = torch.relu(conv(x))
        return self.layers[-1](x)


def load_net(device, path=None) -> DenoiserNet:
    """The network with the weights of `path` (a save_net or JAX
    save_params file), by default the JAX package's trained ones, on
    `device`."""
    net = DenoiserNet()
    net.load_state_dict(denoiser_params_from_numpy(
        load_denoiser_weights(path)))
    return net.to(device).eval()


@torch.no_grad()
def init_net(generator: torch.Generator) -> DenoiserNet:
    """A freshly initialised network, as the JAX package's init_params:
    He-normal 3x3 convs (std sqrt(2 / (9 cin))) drawn from `generator` in
    HWIO order, zero biases, and a zero head, so that the net starts as the
    identity (learned_denoise then returns the guided filter's output)."""
    net = DenoiserNet()
    cin = IN_CHANNELS
    for conv, (cout, _dil) in zip(net.layers, ARCH):
        w = torch.randn((3, 3, cin, cout), generator=generator,
                        dtype=torch.float32) * float(np.sqrt(2.0 / (9 * cin)))
        conv.weight.copy_(w.permute(3, 2, 0, 1))
        conv.bias.zero_()
        cin = cout
    net.layers[-1].weight.zero_()
    net.layers[-1].bias.zero_()
    return net


def save_net(net: DenoiserNet, path):
    """Write the network's weights in the JAX package's layout (num_layers,
    w{i} HWIO, b{i}; np.savez_compressed), which its load_params and this
    module's load_net read: the inverse of
    convert.denoiser_params_from_numpy."""
    arrs = {"num_layers": np.int32(len(net.layers))}
    for i, conv in enumerate(net.layers):
        arrs[f"w{i}"] = np.ascontiguousarray(
            conv.weight.detach().cpu().numpy().transpose(2, 3, 1, 0))
        arrs[f"b{i}"] = conv.bias.detach().cpu().numpy()
    np.savez_compressed(path, **arrs)


def make_features(img, albedo, normal, valid):
    """(features (H, W, 13), log1p(guided) (H, W, 3)): log1p noisy HDR,
    log1p of the guided joint-bilateral output, albedo, normal, coverage."""
    h, w = img.shape[:2]
    log_in = torch.log1p(torch.clamp_min(img, 0.0))
    guided = guided_bilateral_denoise(img, albedo, normal, valid=valid)
    log_g = torch.log1p(torch.clamp_min(guided, 0.0))
    v = (torch.ones((h, w, 1), dtype=torch.float32, device=img.device)
         if valid is None else valid.to(torch.float32)[..., None])
    return torch.cat([log_in, log_g, albedo, normal, v], dim=-1), log_g


@torch.no_grad()
def denoise_with_net(net, img, albedo, normal, valid=None):
    """Single-shot (untiled) denoise; see `learned_denoise` for the API."""
    feat, log_g = make_features(img, albedo, normal, valid)
    res = net(feat.permute(2, 0, 1)[None])[0].permute(1, 2, 0)
    out = torch.expm1(torch.clamp_min(log_g + res, 0.0))
    if valid is not None:
        out = torch.where(valid[..., None], out, img)
    return out


@torch.no_grad()
def learned_denoise(img, albedo, normal, valid=None, net=None, tile=TILE,
                    overlap=OVERLAP):
    """Denoise an HDR lightmap with the trained CNN.

    img: (H, W, 3) noisy irradiance; albedo/normal: (H, W, 3) surface maps
    (bake/surface_map.py); valid: (H, W) coverage mask; net: a DenoiserNet
    on the image's device (freshly trained weights, the JAX package's
    `params`), by default the shipped weights. Maps larger than `tile` are
    processed in overlapping tiles (interior crops stitched back) so peak
    activation memory stays bounded.
    """
    if net is None:
        net = load_net(img.device)
    img = despike(img)
    h, w = img.shape[:2]
    if max(h, w) <= tile:
        return denoise_with_net(net, img, albedo, normal, valid)

    overlap = min(overlap, (tile - 1) // 2)  # keep the stride positive
    step = tile - 2 * overlap
    out = torch.zeros_like(img)
    for y0 in range(0, h, step):
        for x0 in range(0, w, step):
            ty0 = max(y0 - overlap, 0)
            tx0 = max(x0 - overlap, 0)
            ty1 = min(y0 + step + overlap, h)
            tx1 = min(x0 + step + overlap, w)
            sub = denoise_with_net(
                net, img[ty0:ty1, tx0:tx1], albedo[ty0:ty1, tx0:tx1],
                normal[ty0:ty1, tx0:tx1],
                None if valid is None else valid[ty0:ty1, tx0:tx1])
            iy0, ix0 = y0 - ty0, x0 - tx0
            iy1 = iy0 + min(step, h - y0)
            ix1 = ix0 + min(step, w - x0)
            out[y0:y0 + (iy1 - iy0), x0:x0 + (ix1 - ix0)] = \
                sub[iy0:iy1, ix0:ix1]
    if valid is not None:
        out = torch.where(valid[..., None], out, img)
    return out
