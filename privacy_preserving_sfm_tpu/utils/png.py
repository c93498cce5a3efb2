"""PNG reading and writing with zlib and numpy alone.

The image front-end must not depend on an imaging library for the format
the pipeline itself writes and most datasets ship.  Supported: 8-bit
grayscale, grayscale+alpha, RGB and RGBA, non-interlaced, all five
per-row filter types (PNG specification, ISO/IEC 15948 §9).  Anything
else raises ``PNGError``; callers fall back to an imaging library.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Color type -> samples per pixel (8-bit depth only).
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


class PNGError(ValueError):
    """The file is not a PNG this decoder supports."""


def is_png(path: str) -> bool:
    with open(path, "rb") as fh:
        return fh.read(8) == SIGNATURE


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters; returns (height, stride) uint8."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != height * (stride + 1):
        raise PNGError("truncated image data")
    rows = rows.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype = int(rows[y, 0])
        line = rows[y, 1:]
        if ftype == 0:  # None
            cur = line.copy()
        elif ftype == 1:  # Sub: running sum per channel, modulo 256
            cur = np.cumsum(line.reshape(-1, bpp).astype(np.uint32),
                            axis=0).astype(np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prior
        elif ftype in (3, 4):  # Average, Paeth: sequential in x
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    pred = _paeth(a, b, up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise PNGError(f"unknown filter type {ftype}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a PNG to uint8 (H, W) for grayscale or (H, W, C) otherwise."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != SIGNATURE:
        raise PNGError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise PNGError(f"{path}: no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise PNGError(
            f"{path}: unsupported PNG (bit depth {depth}, color type "
            f"{color}, interlace {interlace})")
    ch = _CHANNELS[color]
    pix = _unfilter(zlib.decompress(b"".join(idat)), height, width * ch, ch)
    return pix.reshape(height, width) if ch == 1 else \
        pix.reshape(height, width, ch)


def to_gray(img: np.ndarray) -> np.ndarray:
    """uint8 luma with the ITU-R 601-2 weights, rounded as PIL's "L"
    conversion rounds them; alpha is ignored."""
    if img.ndim == 2:
        return img
    if img.shape[2] == 2:  # gray + alpha
        return img[..., 0]
    rgb = img[..., :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470
             + rgb[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write uint8 (H, W) grayscale or (H, W, 3|4) RGB(A) as a PNG.

    Every row uses the Up filter, which lets zlib compress smooth
    renderings well and decodes without a per-pixel loop.
    """
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        color, ch = 0, 1
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        color, ch = (2 if img.shape[2] == 3 else 6), img.shape[2]
    else:
        raise PNGError(f"cannot write an image of shape {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, w * ch)
    up = np.empty_like(rows)
    up[0] = rows[0]
    up[1:] = rows[1:] - rows[:-1]  # uint8 wraps modulo 256
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    with open(path, "wb") as fh:
        fh.write(SIGNATURE)
        fh.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                             0, 0, 0)))
        fh.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        fh.write(_chunk(b"IEND", b""))
