"""Post-processing: the filmic tone curve.

The part of dxrpathtracer_tpu/render/postfx.py that the bake's PNG needs. The
bloom chain and the full `post_process` wait for the `render` command's slice
(ROADMAP.md Queue 1 item 9).
"""

import torch


def tone_map_filmic_alu(color):
    """HP Duiker film-stock curve approximation (PostProcessing.hlsl:55-60).
    The curve bakes in sRGB encoding."""
    color = torch.clamp_min(color - 0.004, 0.0)
    return ((color * (6.2 * color + 0.5))
            / (color * (6.2 * color + 1.7) + 0.06))
