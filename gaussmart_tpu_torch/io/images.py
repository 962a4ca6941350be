"""8-bit PNG read/write and float32 TIFF write with zlib and numpy only.

The JAX package decodes and saves images through PIL; the port must run
where no image library is installed, so it carries this small codec.

PNG: non-interlaced, bit depth 8, colour types grey (0), RGB (2),
grey+alpha (4) and RGBA (6); all five row filters. Palette images are
refused. The Average and Paeth filters depend on the pixel to the left,
so they are undone with a per-pixel loop: correct but slow on large
images written by other encoders. This module's writer uses filter 0
only, which decodes in one vectorised pass.

TIFF: baseline little-endian, one uncompressed strip, one float32 sample
per pixel (what PIL writes for a mode "F" image).
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes):
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos = 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        yield ctype, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IEND":
            return


def png_size(path: str):
    """(width, height) from the IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != _PNG_SIG or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    return struct.unpack(">II", head[16:24])


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    rows = raw.reshape(height, stride + 1)
    ftypes = rows[:, 0]
    data = rows[:, 1:].astype(np.uint8)
    if not ftypes.any():
        return data
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        f = ftypes[y]
        line = data[y]
        if f == 0:
            cur = line.copy()
        elif f == 1:    # Sub: running sum per byte lane, mod 256
            pad = (-stride) % bpp
            lanes = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            cur = (np.cumsum(lanes, axis=0, dtype=np.uint64) % 256).astype(
                np.uint8).reshape(-1)[:stride]
        elif f == 2:    # Up
            cur = line + prev
        elif f in (3, 4):
            cur = bytearray(stride)
            ln, up = line.tolist(), prev.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                if f == 3:
                    pred = (a + up[i]) >> 1
                else:
                    pred = _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (ln[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {f}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Decode to uint8 [H,W] (grey), [H,W,2], [H,W,3] or [H,W,4], as
    ``np.asarray(PIL.Image.open(path))`` gives for these modes."""
    with open(path, "rb") as f:
        data = f.read()
    ihdr, idat = None, []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = ihdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only non-interlaced 8-bit PNGs are supported "
                         f"(bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace})")
    ch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw, height, width * ch, ch).reshape(height, width, ch)
    return img[..., 0] if ch == 1 else img


def _chunk(ctype: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(ctype + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", crc)


def write_png(path: str, img: np.ndarray, level: int = 6):
    """Write uint8 [H,W], [H,W,1], [H,W,3] or [H,W,4] as an 8-bit PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * ch)], axis=1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), level)))
        f.write(_chunk(b"IEND", b""))


def write_tiff_f32(path: str, img: np.ndarray):
    """Write a [H,W] float32 image as a one-strip uncompressed TIFF."""
    img = np.ascontiguousarray(np.asarray(img, np.float32))
    if img.ndim != 2:
        raise ValueError(f"write_tiff_f32 takes [H,W], got {img.shape}")
    h, w = img.shape
    pixels = img.astype("<f4").tobytes()
    # (tag, type, value): type 3 = SHORT, 4 = LONG
    entries = [(256, 4, w), (257, 4, h), (258, 3, 32), (259, 3, 1),
               (262, 3, 1), (273, 4, 0), (277, 3, 1), (278, 4, h),
               (279, 4, len(pixels)), (339, 3, 3)]
    ifd_offset = 8
    data_offset = ifd_offset + 2 + 12 * len(entries) + 4
    ifd = struct.pack("<H", len(entries))
    for tag, typ, val in entries:
        if tag == 273:
            val = data_offset
        if typ == 3:    # a SHORT sits left-justified in the 4-byte field
            ifd += struct.pack("<HHIHH", tag, typ, 1, val, 0)
        else:
            ifd += struct.pack("<HHII", tag, typ, 1, val)
    ifd += struct.pack("<I", 0)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"II*\x00" + struct.pack("<I", ifd_offset))
        f.write(ifd)
        f.write(pixels)
