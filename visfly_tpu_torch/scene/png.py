"""PNG decoding and encoding with ``zlib`` and numpy, for mesh textures.

glTF exporters write their base-colour textures as PNG. The port decodes
them itself, so that a texture reads the same on every machine whether or
not PIL is installed: non-interlaced 8-bit greyscale, greyscale with alpha,
RGB, RGBA and palette images, with all five scanline filters. What it does
not take (other bit depths, interlacing) makes :func:`decode_png` return
None, and the caller decides. The result is what PIL's ``convert("RGB")``
gives: alpha dropped, greyscale repeated, a palette looked up.

:func:`encode_png` writes an 8-bit image with a chosen filter for each row;
tests and the on-card smoke build their textures with it.
"""
from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type → channels a pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def is_png(raw: bytes) -> bool:
    return raw[:8] == _SIGNATURE


def _chunks(raw: bytes):
    pos = 8
    while pos + 8 <= len(raw):
        n, kind = struct.unpack(">I4s", raw[pos:pos + 8])
        yield kind, raw[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("PNG ends before its IEND chunk")


def _unfilter(data: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the scanline filters. ``data`` (H, W, bpp) uint8 is the filtered
    image, ``ftype`` (H,) each row's filter. A pixel depends on its left,
    upper and upper-left neighbours, so the image is decoded one
    anti-diagonal (row + column = k) at a time, every pixel of a diagonal
    at once."""
    if int(ftype.max(initial=0)) > 4:
        raise ValueError(f"PNG scanline filter {int(ftype.max())} is not one of 0-4")
    h, w = data.shape[:2]
    out = np.zeros((h + 1, w + 1, bpp), np.int16)  # a zero row above, a zero column left
    raw = data.astype(np.int16)
    for k in range(h + w - 1):
        r = np.arange(max(0, k - w + 1), min(h, k + 1))
        c = k - r
        a, b, cc = out[r + 1, c], out[r, c + 1], out[r, c]
        x = raw[r, c]
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
        pred = np.stack([np.zeros_like(a), a, b, (a + b) // 2, paeth])
        out[r + 1, c + 1] = (x + pred[ftype[r], np.arange(len(r))]) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def decode_png(raw: bytes) -> Optional[np.ndarray]:
    """PNG bytes → (H, W, 3) uint8 RGB, or None for a variant this decoder
    does not take. A PNG it takes but cannot read raises ``ValueError``."""
    if not is_png(raw):
        raise ValueError("not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(raw):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, ctype, _compression, _filter, interlace = header
    if depth != 8 or interlace != 0 or ctype not in _CHANNELS:
        return None
    bpp = _CHANNELS[ctype]
    try:
        flat = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"PNG image data: {e}") from None
    if flat.size != h * (1 + w * bpp):
        raise ValueError(f"PNG image data holds {flat.size} bytes, not {h * (1 + w * bpp)}")
    rows = flat.reshape(h, 1 + w * bpp)
    px = _unfilter(rows[:, 1:].reshape(h, w, bpp), rows[:, 0].astype(np.int64), bpp)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        # an index past the palette reads black, as PIL's lookup does
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette[:256]
        return table[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def _filter_row(row: np.ndarray, prev: np.ndarray, ftype: int, bpp: int) -> np.ndarray:
    x = row.astype(np.int16)
    b = prev.astype(np.int16)
    a = np.concatenate([np.zeros(bpp, np.int16), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int16), b[:-bpp]])
    if ftype == 0:
        pred = np.zeros_like(x)
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = b
    elif ftype == 3:
        pred = (a + b) // 2
    else:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((x - pred) & 0xFF).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, filters: Sequence[int] = (0,), palette=None) -> bytes:
    """(H, W) or (H, W, C) uint8 → PNG bytes: C of 1, 2, 3 or 4 gives
    greyscale, greyscale with alpha, RGB or RGBA; ``palette`` (N, 3) uint8
    makes an (H, W) image of indices a palette image. Row i takes filter
    ``filters[i % len(filters)]``."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    ctype = 3 if palette is not None else {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    rows, prev = [], np.zeros(w * ch, np.uint8)
    for i in range(h):
        row = img[i].reshape(-1)
        ft = int(filters[i % len(filters)])
        rows.append(bytes([ft]) + _filter_row(row, prev, ft, ch).tobytes())
        prev = row
    out = _SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return out + _chunk(b"IDAT", zlib.compress(b"".join(rows))) + _chunk(b"IEND", b"")
