"""The reference of a frame cell: the progressive accumulation of chosen
pixels over the samples a run rendered.

The running mean is the program's (dxrpathtracer_tpu_torch/render/
integrator.py:917-920): accum = radiance + (accum - radiance) * f with
f = idx / (idx + 1) in float32, idx the sample index, from a zero image.
"""

import numpy as np
import torch

from .common import chunks, world
from .integrator import raygen, trace_paths

LANES = 1 << 19  # paths traced per call


def accumulate(desc, config, traffic, pixel_idx, first_sample: int,
               num_samples: int, device, storage=torch.float32):
    """(P, 3) f32: the accumulation at the pixels `pixel_idx` ((P,) int64,
    row major) after samples first_sample .. first_sample + num_samples - 1
    from a zero image."""
    scene, bvh, cube, s, frame = world(desc, config, traffic, device, storage)
    width, height = int(config["width"]), int(config["height"])
    pix = torch.as_tensor(pixel_idx, dtype=torch.int64, device=device)
    p = pix.shape[0]
    lanes_pix = pix.repeat(num_samples)
    lanes_smp = (torch.arange(num_samples, dtype=torch.int64, device=device)
                 .repeat_interleave(p) + int(first_sample))
    radiance = torch.empty((num_samples * p, 3), dtype=torch.float32,
                           device=device)
    for lo, hi in chunks(num_samples * p, LANES):
        o, d, t_max = raygen(s, frame, width, height, lanes_pix[lo:hi],
                             lanes_smp[lo:hi])
        radiance[lo:hi] = trace_paths(
            scene, bvh, cube, s, frame, o, d, t_max, lanes_pix[lo:hi],
            width * height, lanes_smp[lo:hi], first_set_idx=1)
    radiance = radiance.reshape(num_samples, p, 3)
    accum = torch.zeros((p, 3), dtype=torch.float32, device=device)
    for k in range(num_samples):
        idx = np.float32(first_sample + k)
        lerp_factor = float(idx / (idx + np.float32(1.0)))
        accum = radiance[k] + (accum - radiance[k]) * lerp_factor
        if storage != torch.float32:
            accum = accum.to(storage).to(torch.float32)
    return accum
