"""Single-channel float EXR ("Z") writer and reader for depth frames.

The port's own copy of the JAX package's ``utils/exr.py``: scanline
OpenEXR 2.0 (magic 20000630, version 2) with one FLOAT channel "Z", as the
reference run.py writes through the OpenEXR bindings. Compression
``none``, ``zips`` (one scanline per block) or ``zip`` (16 per block).
ZIP is OpenEXR's pipeline written in Python over ``zlib``: the bytes split
into their even and odd halves, a byte-delta predictor (+128), then
deflate at zlib's default level; a block that does not shrink is stored
raw. That is what the JAX package's native codec (``native/exr_codec.cpp``)
does, so the two write the same bytes.

A file asked for as ZIP is ZIP or is not written: where the JAX package
quietly writes an uncompressed file when its codec is missing, the port
raises.
"""
from __future__ import annotations

import os
import struct

import numpy as np

_MAGIC = 20000630
_PIXEL_FLOAT = 2   # OpenEXR PixelType FLOAT (fp32)
COMPRESSION_IDS = {"none": 0, "zips": 2, "zip": 3}
_LINES_PER_BLOCK = {0: 1, 2: 1, 3: 16}


def _zlib():
    try:
        import zlib
    except ImportError as e:
        raise RuntimeError("EXR ZIP compression needs Python's zlib module, which this "
                           "interpreter lacks; write with compression='none'") from e
    return zlib


def _attr(name: bytes, type_: bytes, value: bytes) -> bytes:
    return name + b"\x00" + type_ + b"\x00" + struct.pack("<i", len(value)) + value


def _header(h: int, w: int, compression: int) -> bytes:
    chlist = (b"Z\x00" + struct.pack("<i", _PIXEL_FLOAT) + b"\x00\x00\x00\x00"
              + struct.pack("<ii", 1, 1) + b"\x00")
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    return struct.pack("<ii", _MAGIC, 2) + b"".join([
        _attr(b"channels", b"chlist", chlist),
        _attr(b"compression", b"compression", bytes([compression])),
        _attr(b"dataWindow", b"box2i", box),
        _attr(b"displayWindow", b"box2i", box),
        _attr(b"lineOrder", b"lineOrder", b"\x00"),      # INCREASING_Y
        _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0)),
        _attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0)),
        _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0)),
    ]) + b"\x00"


def _zip_block(raw: bytes, zlib) -> bytes:
    """OpenEXR ZIP: split even / odd bytes, delta-predict, deflate; the raw
    block when that does not shrink it."""
    a = np.frombuffer(raw, np.uint8)
    split = np.concatenate([a[0::2], a[1::2]]).astype(np.int16)
    pred = split.copy()
    pred[1:] = (split[1:] - split[:-1] + 128) & 0xFF
    out = zlib.compress(pred.astype(np.uint8).tobytes())
    return out if len(out) < len(raw) else raw


def _unzip_block(data: bytes, raw_n: int, zlib) -> bytes:
    if len(data) == raw_n:   # stored raw
        return data
    tmp = np.frombuffer(zlib.decompress(data), np.uint8)
    if tmp.size != raw_n:
        raise ValueError(f"EXR block inflates to {tmp.size} bytes, expected {raw_n}")
    d = tmp.astype(np.int64)
    d[1:] -= 128
    split = (np.cumsum(d) & 0xFF).astype(np.uint8)
    half = (raw_n + 1) // 2
    out = np.empty(raw_n, np.uint8)
    out[0::2] = split[:half]
    out[1::2] = split[half:]
    return out.tobytes()


def write_exr_z(path: str, depth: np.ndarray, compression: str = "none") -> None:
    """Write depth [H, W] as a float32 single-channel EXR. Raises on an
    unknown compression and leaves no file when ZIP cannot be written."""
    if compression not in COMPRESSION_IDS:
        raise ValueError(f"compression {compression!r}; expected one of {sorted(COMPRESSION_IDS)}")
    cid = COMPRESSION_IDS[compression]
    zlib = _zlib() if cid else None
    depth = np.ascontiguousarray(depth, dtype="<f4")
    if depth.ndim != 2:
        raise ValueError(f"depth must be [H, W], got {depth.shape}")
    h, w = depth.shape
    lines = _LINES_PER_BLOCK[cid]
    blocks = []
    for y in range(0, h, lines):
        raw = depth[y:y + lines].tobytes()
        payload = _zip_block(raw, zlib) if cid else raw
        blocks.append(struct.pack("<ii", y, len(payload)) + payload)
    pre = _header(h, w, cid)
    offsets, at = [], len(pre) + 8 * len(blocks)
    for b in blocks:
        offsets.append(at)
        at += len(b)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(pre)
        f.write(struct.pack(f"<{len(offsets)}Q", *offsets))
        f.writelines(blocks)
    os.replace(tmp, path)


def write_exr_batch(paths, depths: np.ndarray, compression: str = "zip") -> None:
    """One EXR per frame of depths [N, H, W]."""
    if len(paths) != len(depths):
        raise ValueError(f"{len(paths)} paths for {len(depths)} frames")
    for p, d in zip(paths, depths):
        write_exr_z(p, d, compression)


def read_exr_z(path: str) -> np.ndarray:
    """Read a single-FLOAT-channel scanline EXR (none / ZIPS / ZIP)."""
    with open(path, "rb") as f:
        raw = f.read()
    magic, _ = struct.unpack_from("<ii", raw, 0)
    if magic != _MAGIC:
        raise ValueError(f"not an EXR file: {path}")
    pos, data_window, compression = 8, None, None
    while raw[pos] != 0:
        name_end = raw.index(b"\x00", pos)
        name = raw[pos:name_end]
        pos = raw.index(b"\x00", name_end + 1) + 1
        (size,) = struct.unpack_from("<i", raw, pos)
        value = raw[pos + 4:pos + 4 + size]
        pos += 4 + size
        if name == b"dataWindow":
            data_window = struct.unpack("<iiii", value)
        elif name == b"compression":
            compression = value[0]
    pos += 1
    if compression not in _LINES_PER_BLOCK:
        raise ValueError(f"unsupported EXR compression {compression}: {path}")
    zlib = _zlib() if compression else None
    x0, y0, x1, y1 = data_window
    h, w = y1 - y0 + 1, x1 - x0 + 1
    lines = _LINES_PER_BLOCK[compression]
    n_blocks = -(-h // lines)
    pos += 8 * n_blocks   # the offset table
    out = np.empty((h, w), np.float32)
    for _ in range(n_blocks):
        y, size = struct.unpack_from("<ii", raw, pos)
        pos += 8
        nl = min(lines, h - (y - y0))
        payload = raw[pos:pos + size]
        pos += size
        if compression:
            payload = _unzip_block(payload, 4 * w * nl, zlib)
        out[y - y0:y - y0 + nl] = np.frombuffer(payload, "<f4", count=w * nl).reshape(nl, w)
    return out
