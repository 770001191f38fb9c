"""The comparison that decides `correct`.

Each compared value is one pixel's accumulated radiance (frame cells) or
one texel's lightmap value colorSum / validCount (bake cells). It is off
when any channel differs from the reference's by more than REL of the
reference's largest channel, or is not finite; a texel is also off when
its count of valid samples differs. The number compared is the share of
compared values that are off, in percent; each cell's limit on it is in
ptbench/limits/<cell>.json, set from the program's and the control's
readings (PERF.md).
"""

import torch

REL = 1e-3


def _off(got, ref):
    gap = (got - ref).abs().amax(dim=-1)
    scale = ref.abs().amax(dim=-1).clamp_min(1e-20)
    return ~torch.isfinite(got).all(dim=-1) | (gap > REL * scale)


def off_pct(got, ref, extra_off=None) -> float:
    """The share of rows of `got` that are off from `ref`'s, in percent;
    `extra_off` marks more rows off."""
    off = _off(got.double(), ref.double())
    if extra_off is not None:
        off = off | extra_off
    return 100.0 * off.double().mean().item()


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit (a number without a limit
    fails)."""
    return all(k in limits and v <= limits[k] for k, v in numbers.items())
