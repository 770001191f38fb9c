"""DDS texture loading with from-scratch, vectorized BC1-BC5 block decode.

A numpy copy of dxrpathtracer_tpu/scene/dds.py (the port imports nothing of
the JAX package), so a scene that binds a DDS texture decodes to the same
texels in both packages.

The reference loads material textures through DirectXTex
(Graphics/Textures.cpp:44-67 `LoadFromDDSFile` with mip-gen + sRGB forcing);
DirectXTex ships only as a prebuilt .lib, so everything here is implemented
from the public DDS container / S3TC-BC specs.

Scope: 2D single-surface DDS files — legacy fourCC (DXT1-5, ATI1/2, BC4/5
U and S, D3DFMT float codes) and DX10-header DXGI formats (uncompressed
UNORM/FLOAT and BC1-BC5 of either signedness, incl. _SRGB variants).
BC6H/BC7 are not decoded (their partition tables are not reproducible here
and no reference content uses them); they raise a clear error.

The path tracer samples mip 0 only (RayTrace.hlsl:174,185 `SampleLevel(...,
0.0f)`), so only the top surface is decoded. Returns float32 channels; UNORM
formats land in [0, 1], SNORM in [-1, 1], float formats pass through. sRGB
conversion is the caller's business (`is_srgb` is reported so scene loading
can match the reference's ForceSRGB behavior).
"""

import dataclasses
import struct

import numpy as np

_DDPF_ALPHAPIXELS = 0x1
_DDPF_FOURCC = 0x4
_DDPF_RGB = 0x40
_DDPF_LUMINANCE = 0x20000

# D3DFMT numeric fourCC codes for float formats (legacy headers)
_D3DFMT_FLOAT = {111: ("f2", 1), 112: ("f2", 2), 113: ("f2", 4),
                 114: ("f4", 1), 115: ("f4", 2), 116: ("f4", 4)}

# DXGI formats: id -> (numpy dtype, channels, kind, srgb)
# kind: "unorm" | "snorm" | "float"
_DXGI_UNCOMPRESSED = {
    2:  ("<f4", 4, "float", False),   # R32G32B32A32_FLOAT
    6:  ("<f4", 3, "float", False),   # R32G32B32_FLOAT
    10: ("<f2", 4, "float", False),   # R16G16B16A16_FLOAT
    11: ("<u2", 4, "unorm", False),   # R16G16B16A16_UNORM
    16: ("<f4", 2, "float", False),   # R32G32_FLOAT
    28: ("<u1", 4, "unorm", False),   # R8G8B8A8_UNORM
    29: ("<u1", 4, "unorm", True),    # R8G8B8A8_UNORM_SRGB
    34: ("<f2", 2, "float", False),   # R16G16_FLOAT
    35: ("<u2", 2, "unorm", False),   # R16G16_UNORM
    41: ("<f4", 1, "float", False),   # R32_FLOAT
    49: ("<u1", 2, "unorm", False),   # R8G8_UNORM
    54: ("<f2", 1, "float", False),   # R16_FLOAT
    56: ("<u2", 1, "unorm", False),   # R16_UNORM
    61: ("<u1", 1, "unorm", False),   # R8_UNORM
}
_DXGI_BGRA = {87: False, 91: True}    # B8G8R8A8_UNORM(_SRGB)
_DXGI_BC = {70: ("bc1", False), 71: ("bc1", False), 72: ("bc1", True),
            73: ("bc2", False), 74: ("bc2", False), 75: ("bc2", True),
            76: ("bc3", False), 77: ("bc3", False), 78: ("bc3", True),
            79: ("bc4", False), 80: ("bc4", False), 81: ("bc4s", False),
            82: ("bc5", False), 83: ("bc5", False), 84: ("bc5s", False)}
_DXGI_UNSUPPORTED_BC = {94: "BC6H", 95: "BC6H", 96: "BC6H",
                        97: "BC7", 98: "BC7", 99: "BC7"}


@dataclasses.dataclass
class DDSImage:
    data: np.ndarray  # (H, W, C) float32
    is_srgb: bool
    format_name: str


# ---------------------------------------------------------------------------
# BC block decoders — all vectorized over the full block array.

def _blocks_to_image(texels, h, w):
    """(nby*nbx, 4, 4, C) block texels -> (h, w, C) image (crop partial edge)."""
    nbx = (w + 3) // 4
    nby = (h + 3) // 4
    c = texels.shape[-1]
    img = (texels.reshape(nby, nbx, 4, 4, c)
           .transpose(0, 2, 1, 3, 4)
           .reshape(nby * 4, nbx * 4, c))
    return img[:h, :w]


def _rgb565(c):
    """(N,) uint16 -> (N, 3) float in [0,1] with the 5/6/5 bit replication
    DirectXTex uses (val * 255 / 31 rounding ≈ bit replication)."""
    r = ((c >> 11) & 0x1F).astype(np.float32) / 31.0
    g = ((c >> 5) & 0x3F).astype(np.float32) / 63.0
    b = (c & 0x1F).astype(np.float32) / 31.0
    return np.stack([r, g, b], axis=-1)


def _decode_bc1_color(blocks8, force_opaque):
    """blocks8: (N, 8) uint8 BC1 color block -> (N, 4, 4, 4) RGBA float32."""
    n = blocks8.shape[0]
    c0 = blocks8[:, 0].astype(np.uint16) | (blocks8[:, 1].astype(np.uint16) << 8)
    c1 = blocks8[:, 2].astype(np.uint16) | (blocks8[:, 3].astype(np.uint16) << 8)
    bits = (blocks8[:, 4].astype(np.uint32)
            | (blocks8[:, 5].astype(np.uint32) << 8)
            | (blocks8[:, 6].astype(np.uint32) << 16)
            | (blocks8[:, 7].astype(np.uint32) << 24))
    p0, p1 = _rgb565(c0), _rgb565(c1)
    four_mode = (c0 > c1) | force_opaque

    # palette (N, 4, 4): rows = palette entry, RGBA
    pal = np.zeros((n, 4, 4), np.float32)
    pal[:, 0, :3] = p0
    pal[:, 0, 3] = 1.0
    pal[:, 1, :3] = p1
    pal[:, 1, 3] = 1.0
    pal[:, 2, :3] = np.where(four_mode[:, None],
                             (2.0 * p0 + p1) / 3.0, (p0 + p1) * 0.5)
    pal[:, 2, 3] = 1.0
    pal[:, 3, :3] = np.where(four_mode[:, None], (p0 + 2.0 * p1) / 3.0, 0.0)
    pal[:, 3, 3] = np.where(four_mode, 1.0, 0.0)  # 3-color mode: transparent

    shifts = (np.arange(16, dtype=np.uint32) * 2)
    idx = ((bits[:, None] >> shifts) & 0x3).astype(np.int64)  # (N, 16)
    out = np.take_along_axis(pal, idx[..., None].repeat(4, -1), axis=1)
    return out.reshape(n, 4, 4, 4)


def _decode_bc4_channel(blocks8, signed):
    """blocks8: (N, 8) uint8 BC4 block -> (N, 4, 4) float32."""
    n = blocks8.shape[0]
    if signed:
        r0 = blocks8[:, 0].astype(np.int8).astype(np.float32)
        r1 = blocks8[:, 1].astype(np.int8).astype(np.float32)
        lo, hi = -1.0, 1.0
        scale = 127.0
        r0 = np.maximum(r0, -127.0) / scale
        r1 = np.maximum(r1, -127.0) / scale
    else:
        r0 = blocks8[:, 0].astype(np.float32) / 255.0
        r1 = blocks8[:, 1].astype(np.float32) / 255.0
        lo, hi = 0.0, 1.0
    bits = np.zeros(n, np.uint64)
    for i in range(6):
        bits |= blocks8[:, 2 + i].astype(np.uint64) << np.uint64(8 * i)

    eight_mode = blocks8[:, 0] > blocks8[:, 1] if not signed else (
        blocks8[:, 0].astype(np.int8) > blocks8[:, 1].astype(np.int8))
    pal = np.zeros((n, 8), np.float32)
    pal[:, 0] = r0
    pal[:, 1] = r1
    for i in range(2, 8):
        # 8-point: ((8-i)*r0 + (i-1)*r1) / 7 ; 6-point: ((6-i)*r0+(i-1)*r1)/5
        e = ((8 - i) * r0 + (i - 1) * r1) / 7.0
        s = (((6 - i) * r0 + (i - 1) * r1) / 5.0) if i <= 5 else (
            np.full(n, lo, np.float32) if i == 6 else np.full(n, hi, np.float32))
        pal[:, i] = np.where(eight_mode, e, s)

    shifts = (np.arange(16, dtype=np.uint64) * np.uint64(3))
    idx = ((bits[:, None] >> shifts) & np.uint64(0x7)).astype(np.int64)
    return np.take_along_axis(pal, idx, axis=1).reshape(n, 4, 4)


def _decode_bc2_alpha(blocks8):
    """(N, 8) uint8 explicit 4-bit alpha -> (N, 4, 4) float32."""
    n = blocks8.shape[0]
    bits = np.zeros(n, np.uint64)
    for i in range(8):
        bits |= blocks8[:, i].astype(np.uint64) << np.uint64(8 * i)
    shifts = (np.arange(16, dtype=np.uint64) * np.uint64(4))
    a = ((bits[:, None] >> shifts) & np.uint64(0xF)).astype(np.float32) / 15.0
    return a.reshape(n, 4, 4)


def _decode_bc(raw, h, w, kind):
    nbx, nby = (w + 3) // 4, (h + 3) // 4
    n = nbx * nby
    bpb = 8 if kind in ("bc1", "bc4", "bc4s") else 16
    blocks = np.frombuffer(raw[:n * bpb], np.uint8).reshape(n, bpb)
    if kind == "bc1":
        tex = _decode_bc1_color(blocks, force_opaque=False)
    elif kind == "bc2":
        tex = _decode_bc1_color(blocks[:, 8:], force_opaque=True)
        tex[..., 3] = _decode_bc2_alpha(blocks[:, :8])
    elif kind == "bc3":
        tex = _decode_bc1_color(blocks[:, 8:], force_opaque=True)
        tex[..., 3] = _decode_bc4_channel(blocks[:, :8], signed=False)
    elif kind in ("bc4", "bc4s"):
        tex = _decode_bc4_channel(blocks, signed=kind.endswith("s"))[..., None]
    elif kind in ("bc5", "bc5s"):
        signed = kind.endswith("s")
        r = _decode_bc4_channel(blocks[:, :8], signed)
        g = _decode_bc4_channel(blocks[:, 8:], signed)
        tex = np.stack([r, g], axis=-1)
    else:  # pragma: no cover
        raise ValueError(kind)
    return _blocks_to_image(tex, h, w)


# ---------------------------------------------------------------------------
# uncompressed decoders

def _decode_typed(raw, h, w, dtype, channels, kind):
    a = np.frombuffer(raw[:h * w * channels * np.dtype(dtype).itemsize],
                      dtype).reshape(h, w, channels).astype(np.float32)
    if kind == "unorm":
        a = a / float(np.iinfo(np.dtype(dtype).str.replace("<", "")).max)
    return a


def _decode_masked(raw, h, w, bit_count, masks, has_alpha, luminance):
    """Legacy DDPF_RGB / DDPF_LUMINANCE bitmask decode."""
    bpp = bit_count // 8
    store = {8: np.uint8, 16: np.uint16, 24: np.uint32, 32: np.uint32}[bit_count]
    if bit_count == 24:
        b = np.frombuffer(raw[:h * w * 3], np.uint8).reshape(h, w, 3)
        px = (b[..., 0].astype(np.uint32) | (b[..., 1].astype(np.uint32) << 8)
              | (b[..., 2].astype(np.uint32) << 16))
    else:
        px = np.frombuffer(raw[:h * w * bpp], store).reshape(h, w).astype(np.uint32)
    chans = []
    for m in masks:
        if m == 0:
            chans.append(None)
            continue
        shift = (m & -m).bit_length() - 1
        maxv = m >> shift
        chans.append(((px & m) >> shift).astype(np.float32) / float(maxv))
    r, g, b, a = chans
    if luminance:
        out = [r, r, r]
    else:
        out = [c if c is not None else np.zeros((h, w), np.float32)
               for c in (r, g, b)]
    if has_alpha and a is not None:
        out.append(a)
    return np.stack(out, axis=-1)


# ---------------------------------------------------------------------------

def load_dds(path) -> DDSImage:
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != b"DDS ":
        raise ValueError("not a DDS file")
    (hsize, _flags, height, width, _pitch, _depth, _mips) = struct.unpack_from(
        "<7I", buf, 4)
    if hsize != 124:
        raise ValueError("bad DDS header size")
    (pf_size, pf_flags, fourcc, bit_count, rm, gm, bm, am) = struct.unpack_from(
        "<2I4s5I", buf, 4 + 72)
    caps2 = struct.unpack_from("<I", buf, 4 + 108)[0]
    if caps2 & 0x200:
        raise ValueError("cubemap DDS unsupported (2D only)")
    data_off = 4 + 124
    srgb = False
    name = fourcc.decode("ascii", "replace") if pf_flags & _DDPF_FOURCC else "masked"

    if pf_flags & _DDPF_FOURCC and fourcc == b"DX10":
        dxgi, dim, _misc, array_size, _m2 = struct.unpack_from("<5I", buf, data_off)
        data_off += 20
        if dim not in (0, 3) or array_size > 1:
            raise ValueError("only 2D single-surface DX10 DDS supported")
        name = f"DXGI_{dxgi}"
        raw = buf[data_off:]
        if dxgi in _DXGI_UNSUPPORTED_BC:
            raise ValueError(f"{_DXGI_UNSUPPORTED_BC[dxgi]} decode unsupported")
        if dxgi in _DXGI_BC:
            kind, srgb = _DXGI_BC[dxgi]
            return DDSImage(_decode_bc(raw, height, width, kind), srgb, name)
        if dxgi in _DXGI_BGRA:
            img = _decode_typed(raw, height, width, "<u1", 4, "unorm")
            img = img[..., [2, 1, 0, 3]]
            return DDSImage(img, _DXGI_BGRA[dxgi], name)
        if dxgi in _DXGI_UNCOMPRESSED:
            dt, ch, kind, srgb = _DXGI_UNCOMPRESSED[dxgi]
            return DDSImage(_decode_typed(raw, height, width, dt, ch, kind),
                            srgb, name)
        raise ValueError(f"DXGI format {dxgi} unsupported")

    raw = buf[data_off:]
    if pf_flags & _DDPF_FOURCC:
        cc = fourcc
        icc = struct.unpack("<I", fourcc)[0]
        legacy_bc = {b"DXT1": "bc1", b"DXT2": "bc2", b"DXT3": "bc2",
                     b"DXT4": "bc3", b"DXT5": "bc3",
                     b"ATI1": "bc4", b"BC4U": "bc4", b"BC4S": "bc4s",
                     b"ATI2": "bc5", b"BC5U": "bc5", b"BC5S": "bc5s"}
        if cc in legacy_bc:
            return DDSImage(_decode_bc(raw, height, width, legacy_bc[cc]),
                            srgb, name)
        if icc in _D3DFMT_FLOAT:
            ft, ch = _D3DFMT_FLOAT[icc]
            return DDSImage(_decode_typed(raw, height, width, "<" + ft, ch,
                                          "float"), srgb, name)
        raise ValueError(f"fourCC {fourcc!r} unsupported")

    if pf_flags & (_DDPF_RGB | _DDPF_LUMINANCE | _DDPF_ALPHAPIXELS):
        img = _decode_masked(raw, height, width, bit_count, (rm, gm, bm, am),
                             has_alpha=bool(pf_flags & _DDPF_ALPHAPIXELS),
                             luminance=bool(pf_flags & _DDPF_LUMINANCE))
        return DDSImage(img, srgb, name)
    raise ValueError("unrecognized DDS pixel format")
