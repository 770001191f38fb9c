"""OpenEXR scanline image IO, from scratch (no external EXR dependency).

The reference vendors TinyEXR (Externals/TinyEXR) and exports HDR textures
through DirectXTex (Graphics/Textures.cpp:483-562); this module writes the
HDR accumulation buffers and lightmaps. A numpy and zlib copy of
dxrpathtracer_tpu/render/exr.py: the two packages write the same bytes.

Supports the subset every EXR tool emits/accepts:
  - single-part scanline files, version 2
  - compression NONE (one scanline per chunk) and ZIP / ZIPS
    (reconstruction = inflate -> un-delta -> un-interleave, matching
    OpenEXR ImfZip / TinyEXR.cpp:6867-6915)
  - channel types HALF and FLOAT, any channel names (RGB/RGBA/Y...)
  - increasing-Y line order

Writer emits FLOAT channels with ZIP compression by default.
"""

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_HALF, _FLOAT = 1, 2  # pixel types (UINT=0 unsupported)
_ZIP_LINES = {0: 1, 2: 1, 3: 16}  # compression id -> scanlines per chunk


# ---------------------------------------------------------------------------
# primitive encoders

def _attr(name: str, type_: str, payload: bytes) -> bytes:
    return (name.encode() + b"\0" + type_.encode() + b"\0"
            + struct.pack("<i", len(payload)) + payload)


def _chlist(names, pixel_type) -> bytes:
    out = b""
    for n in sorted(names):  # EXR stores channels sorted by name
        out += n.encode() + b"\0" + struct.pack("<iBBBBii", pixel_type,
                                                0, 0, 0, 0, 1, 1)
    return out + b"\0"


def _zip_compress(raw: bytes) -> bytes:
    # ImfZip::compress order: split-interleave halves FIRST, then the delta
    # predictor over the REORDERED buffer with byte 0 untouched
    # (d[i] = t[i] - t[i-1] + 128 + 256, stored mod 256). The reverse order
    # round-trips internally but is unreadable by OpenEXR/TinyEXR
    # (TinyEXR.cpp:6867-6915).
    a = np.frombuffer(raw, np.uint8)
    half = (len(a) + 1) // 2
    inter = np.empty_like(a)
    inter[:half] = a[0::2]
    inter[half:] = a[1::2]
    d = inter.astype(np.int16)
    d[1:] = d[1:] - inter[:-1].astype(np.int16) + (128 + 256)
    return zlib.compress(d.astype(np.uint8).tobytes())


def _zip_decompress(data: bytes, n: int) -> bytes:
    raw = zlib.decompress(data)
    if len(raw) != n:
        raise ValueError(f"EXR zip chunk: expected {n} bytes, got {len(raw)}")
    # ImfZip::uncompress order: undo the predictor (t[i] = t[i-1] + d[i] - 128
    # mod 256, byte 0 unchanged), THEN de-interleave the halves.
    d = np.frombuffer(raw, np.uint8).astype(np.int64)
    d[1:] -= 128
    t = (np.cumsum(d) & 0xFF).astype(np.uint8)
    half = (n + 1) // 2
    de = np.empty_like(t)
    de[0::2] = t[:half]
    de[1::2] = t[half:]
    return de.tobytes()


# ---------------------------------------------------------------------------
# writer

def write_exr(path, img, channel_names=None, compression="zip",
              pixel_type="float"):
    """Write (H, W) or (H, W, C) float data as a scanline EXR."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    if channel_names is None:
        channel_names = {1: ["Y"], 3: ["R", "G", "B"],
                         4: ["R", "G", "B", "A"]}[c]
    if len(channel_names) != c:
        raise ValueError("channel_names length != channel count")
    comp_id = {"none": 0, "zips": 2, "zip": 3}[compression]
    ptype = {"half": _HALF, "float": _FLOAT}[pixel_type]
    dtype = np.float16 if ptype == _HALF else np.float32

    header = b""
    header += _attr("channels", "chlist", _chlist(channel_names, ptype))
    header += _attr("compression", "compression", struct.pack("<B", comp_id))
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _attr("dataWindow", "box2i", box)
    header += _attr("displayWindow", "box2i", box)
    header += _attr("lineOrder", "lineOrder", struct.pack("<B", 0))
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"  # end of header

    # channel-major scanline payload, channels in sorted-name order
    order = np.argsort(channel_names)
    lines_per = _ZIP_LINES[comp_id]
    chunks = []
    for y0 in range(0, h, lines_per):
        ny = min(lines_per, h - y0)
        rows = []
        for y in range(y0, y0 + ny):
            for ci in order:
                rows.append(img[y, :, ci].astype(dtype).tobytes())
        raw = b"".join(rows)
        if comp_id == 0:
            data = raw
        else:
            data = _zip_compress(raw)
            if len(data) >= len(raw):  # spec: store raw if zip doesn't help
                data = raw
        chunks.append(struct.pack("<ii", y0, len(data)) + data)

    n_chunks = len(chunks)
    offset0 = 4 + 4 + len(header) + 8 * n_chunks
    offsets, pos = [], offset0
    for chk in chunks:
        offsets.append(pos)
        pos += len(chk)

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, 2))
        f.write(header)
        f.write(struct.pack(f"<{n_chunks}q", *offsets))
        for chk in chunks:
            f.write(chk)


# ---------------------------------------------------------------------------
# reader

def _read_nt_string(buf, pos):
    end = buf.index(b"\0", pos)
    return buf[pos:end].decode(), end + 1


def read_exr(path):
    """Read a scanline EXR; returns (img (H, W, C) float32, channel names)."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError("not an EXR file")
    if version & 0x200:
        raise ValueError("deep/multipart EXR unsupported")
    pos = 8

    channels, comp_id, dw = [], 0, None
    while True:
        name, pos = _read_nt_string(buf, pos)
        if not name:
            break
        _type, pos = _read_nt_string(buf, pos)
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        payload = buf[pos:pos + size]
        pos += size
        if name == "channels":
            p = 0
            while payload[p] != 0:
                cname, p = _read_nt_string(payload, p)
                ptype, = struct.unpack_from("<i", payload, p)
                xs, ys = struct.unpack_from("<ii", payload, p + 8)
                if ptype not in (_HALF, _FLOAT):
                    raise ValueError("UINT channels unsupported")
                if (xs, ys) != (1, 1):
                    raise ValueError("subsampled channels unsupported")
                channels.append((cname, ptype))
                p += 16
        elif name == "compression":
            comp_id = payload[0]
        elif name == "dataWindow":
            dw = struct.unpack("<iiii", payload)
        elif name == "lineOrder" and payload[0] != 0:
            raise ValueError("only increasing-Y line order supported")
    if comp_id not in _ZIP_LINES:
        raise ValueError(f"compression id {comp_id} unsupported (NONE/ZIP only)")

    x0, y0, x1, y1 = dw
    w, h = x1 - x0 + 1, y1 - y0 + 1
    lines_per = _ZIP_LINES[comp_id]
    n_chunks = -(-h // lines_per)
    offsets = struct.unpack_from(f"<{n_chunks}q", buf, pos)

    dtypes = {name: (np.float16 if t == _HALF else np.float32)
              for name, t in channels}
    names_sorted = [n for n, _ in channels]  # chlist is stored sorted
    img = {n: np.empty((h, w), np.float32) for n in names_sorted}
    bytes_per_line = sum(w * np.dtype(dtypes[n]).itemsize for n in names_sorted)

    for off in offsets:
        y, size = struct.unpack_from("<ii", buf, off)
        y -= y0
        ny = min(lines_per, h - y)
        data = buf[off + 8:off + 8 + size]
        raw = (data if comp_id == 0 or size == ny * bytes_per_line
               else _zip_decompress(data, ny * bytes_per_line))
        p = 0
        for yy in range(y, y + ny):
            for n in names_sorted:
                nb = w * np.dtype(dtypes[n]).itemsize
                img[n][yy] = np.frombuffer(raw[p:p + nb],
                                           dtypes[n]).astype(np.float32)
                p += nb

    # present as RGB(A) order when those channels exist, else sorted order
    pref = [n for n in ("R", "G", "B", "A") if n in img]
    out_names = pref + [n for n in names_sorted if n not in pref]
    return np.stack([img[n] for n in out_names], axis=-1), out_names
