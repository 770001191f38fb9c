"""Correlated multi-jittered sampling [Kensler 2013], bit-exact with the reference.

The port of dxrpathtracer_tpu/core/cmj.py (Sampling.hlsl:282-331): the same
uint32 hash recurrences with wrapping arithmetic. Torch has no usable uint32
(on the CPU `>>` and `%` on uint32 raise), so every value is a uint32 held in
an int64 tensor and every step that can leave [0, 2^32) is masked back with
`& 0xFFFFFFFF`. Products are split into 16-bit halves so no int64 product
overflows. The outputs equal the JAX package's bit for bit.
"""

import torch

_M32 = 0xFFFFFFFF


def _u32(x, device=None):
    """uint32 value(s) as an int64 tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return torch.as_tensor(int(x) & _M32, dtype=torch.int64, device=device)


def _mul(a, c):
    """(a * c) mod 2^32 for uint32 a, c (int64 tensors or ints), exactly."""
    return ((a * (c & 0xFFFF)) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _masked_width(l: int) -> int:
    """w = next-pow2(l)-1 computed statically (l is a static stratum count)."""
    w = l - 1
    w |= w >> 1
    w |= w >> 2
    w |= w >> 4
    w |= w >> 8
    w |= w >> 16
    return w


def _permute_round(i, p, w: int):
    """One round of the CMJ permutation hash (Sampling.hlsl:290-304)."""
    i = i ^ p
    i = _mul(i, 0xE170893D)
    i = i ^ (p >> 16)
    i = i ^ ((i & w) >> 4)
    i = i ^ (p >> 8)
    i = _mul(i, 0x0929EB3F)
    i = i ^ (p >> 23)
    i = i ^ ((i & w) >> 1)
    i = _mul(i, 1 | (p >> 27))
    i = _mul(i, 0x6935FA69)
    i = i ^ ((i & w) >> 11)
    i = _mul(i, 0x74DCB303)
    i = i ^ ((i & w) >> 2)
    i = _mul(i, 0x9E501CC3)
    i = i ^ ((i & w) >> 2)
    i = _mul(i, 0xC860A3DF)
    i = i & w
    i = i ^ (i >> 5)
    return i


def cmj_permute(i, l: int, p):
    """CMJPermute(i, l, p): cycle-walking permutation of [0, l).

    `i` and `p` are uint32 values (int64 tensors or ints, broadcastable);
    `l` is a Python int. Returns an int64 tensor of uint32 values.
    """
    if not (isinstance(l, int) and l >= 1):
        raise ValueError(f"stratum count must be a positive int, got {l!r}")
    w = _masked_width(l)
    p = _u32(p)
    i = _u32(i, p.device)
    i, p = torch.broadcast_tensors(i, p)
    i = _permute_round(i, p, w)  # do { } executes at least once
    # while (i >= l): re-hash only the lanes still out of range
    redo = i >= l
    while bool(redo.any()):
        i = i.clone()
        i[redo] = _permute_round(i[redo], p[redo], w)
        redo = i >= l
    return ((i + p) & _M32) % l


def cmj_rand_float(i, p):
    """CMJRandFloat(i, p) -> float32 in [0, 1) (Sampling.hlsl:309-319)."""
    p = _u32(p)
    i = _u32(i, p.device)
    i = i ^ p
    i = i ^ (i >> 17)
    i = i ^ (i >> 10)
    i = _mul(i, 0xB36534E5)
    i = i ^ (i >> 12)
    i = i ^ (i >> 21)
    i = _mul(i, 0x93FC4795)
    i = i ^ 0xDF6E307F
    i = i ^ (i >> 17)
    i = _mul(i, 1 | (p >> 18))
    # int64 -> f32 rounds to nearest, as numpy's uint32 -> f32 does
    return i.to(torch.float32) * (1.0 / 4294967808.0)


def sample_cmj_2d(sample_idx, num_samples_x: int, num_samples_y: int, pattern):
    """SampleCMJ2D: 2D stratified sample for `sample_idx` in pattern `pattern`.

    sample_idx: int or int64 tensor; num_samples_x/y: Python ints; pattern:
    uint32 values as an int64 tensor (one per pixel). Returns (..., 2) f32.
    """
    n = num_samples_x * num_samples_y
    pattern = _u32(pattern)
    sample_idx = cmj_permute(sample_idx, n, _mul(pattern, 0x51633E2D))
    sx = cmj_permute(sample_idx % num_samples_x, num_samples_x,
                     _mul(pattern, 0x68BC21EB))
    sy = cmj_permute(sample_idx // num_samples_x, num_samples_y,
                     _mul(pattern, 0x02E5BE93))
    jx = cmj_rand_float(sample_idx, _mul(pattern, 0x967A889B))
    jy = cmj_rand_float(sample_idx, _mul(pattern, 0x368CC8B7))
    f32 = lambda v: v.to(torch.float32)
    u = (f32(sx) + (f32(sy) + jx) / num_samples_y) / num_samples_x
    v = (f32(sample_idx) + jy) / n
    return torch.stack([u, v], dim=-1)
