"""Gamma-corrected PNG I/O.

Matches the reference's exact transfer functions (src/util.rs:4-33):
save encodes linear → sRGB-ish with x^(1/2.2), clamps, scales by 255 and
truncates to u8 (Rust `as u8` truncates toward zero — so do numpy uint8
casts); load decodes with (x/255)^2.2. Images are [H*W, 3] linear float32.

PNG itself is read and written here with the standard library (zlib +
struct): 8-bit RGB and RGBA, non-interlaced, every filter type on read.
That is the whole format the datasets, previews and viewer frames use.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}          # PNG colour type -> samples per pixel


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(pixels: np.ndarray) -> bytes:
    """[H, W, 3|4] uint8 → PNG bytes (filter 0 on every row)."""
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    if pixels.ndim != 3 or pixels.shape[2] not in (3, 4):
        raise ValueError(f"expected [H, W, 3|4] pixels, got {pixels.shape}")
    h, w, c = pixels.shape
    colour = 2 if c == 3 else 6
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          pixels.reshape(h, w * c)], axis=1)
    return (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, pixels: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(pixels))


def _paeth_row(line: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    out = line.astype(np.int16)
    up = prior.astype(np.int16)
    for i in range(line.size):
        a = int(out[i - bpp]) if i >= bpp else 0
        b = int(up[i])
        c = int(up[i - bpp]) if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out.astype(np.uint8)


def _average_row(line: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    out = line.astype(np.int16)
    up = prior.astype(np.int16)
    for i in range(line.size):
        a = int(out[i - bpp]) if i >= bpp else 0
        out[i] = (out[i] + (a + int(up[i])) // 2) & 0xFF
    return out.astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → [H, W, 3|4] uint8 (8-bit RGB/RGBA, non-interlaced)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {colour}, "
            f"interlace {interlace}): only 8-bit RGB/RGBA, non-interlaced")
    bpp = _CHANNELS[colour]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:]
        if kind == 0:
            row = line
        elif kind == 1:       # Sub: running sum per channel, mod 256
            row = np.cumsum(line.reshape(w, bpp).astype(np.uint32),
                            axis=0).astype(np.uint8).reshape(-1)
        elif kind == 2:       # Up
            row = line + prior
        elif kind == 3:
            row = _average_row(line, prior, bpp)
        elif kind == 4:
            row = _paeth_row(line, prior, bpp)
        else:
            raise ValueError(f"bad PNG filter type {kind}")
        out[y] = row
        prior = row
    return out.reshape(h, w, bpp)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def save_array_as_image(arr, width: int, height: int, path: str) -> None:
    """Save a [H*W, 3] (or [H, W, 3]) linear float array as a gamma-2.2 PNG.

    Reference: src/util.rs:4-18.
    """
    a = np.asarray(arr, dtype=np.float32).reshape(height, width, 3)
    # Negative inputs produce NaN under fractional pow in the reference and
    # then cast to 0 (`as u8` on NaN is 0 in Rust); clipping first is
    # equivalent and NaN-free.
    a = np.clip(a, 0.0, 1.0)
    pixels = (a ** (1.0 / 2.2) * 255.0).astype(np.uint8)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    write_png(path, pixels)


def load_image_as_array(path: str) -> np.ndarray:
    """Load a PNG → [H*W, 3] linear float32 via gamma-2.2 decode (an alpha
    channel is dropped).

    Reference: src/util.rs:21-33.
    """
    pixels = read_png(path)[..., :3].astype(np.float32) / 255.0
    linear = pixels ** 2.2
    return linear.reshape(-1, 3)


def image_size(path: str) -> tuple[int, int]:
    """(width, height) of a PNG file, from its header."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != _SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    return struct.unpack(">II", head[16:24])
