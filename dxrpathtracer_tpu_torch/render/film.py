"""Image output (host side): PNG / NPY export.

The port of dxrpathtracer_tpu/render/film.py. The PNG writer uses the
standard library alone (zlib, struct): 8-bit RGB, no interlace, filter 0 on
every row. EXR output waits for the EXR codec's slice
(ROADMAP.md Queue 1 item 9).
"""

import struct
import zlib

import numpy as np

def to_uint8(img):
    return np.clip(np.asarray(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, img):
    """(H, W, 3) values in [0, 1] -> an 8-bit RGB PNG."""
    px = to_uint8(img)
    if px.ndim != 3 or px.shape[2] != 3:
        raise ValueError(f"write_png: want (H, W, 3), got {px.shape}")
    h, w, _ = px.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), px.reshape(h, w * 3)],
                          axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 2: RGB
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


def write_npy(path, img):
    np.save(path, np.asarray(img, np.float32))


def write_image(path, img):
    """Dispatch on extension: .npy (raw f32), else PNG (LDR)."""
    path = str(path)
    if path.endswith(".npy"):
        write_npy(path, img)
    elif path.endswith(".exr"):
        raise NotImplementedError(
            "EXR output is not ported yet (ROADMAP.md Queue 1 item 9)")
    else:
        write_png(path, img)
