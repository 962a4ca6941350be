"""Image files on the host without Pillow or OpenCV: PNG and JPEG read,
PNG, JPEG and float32 TIFF write.

The JAX package decodes and saves images through PIL and cv2; the port
must run where no image library is installed, so it carries this small
codec. Its native half, ``csrc/imagecodec.cpp`` (the JPEG decoder and
encoder and the PNG row unfilter), is built by g++ into
``build/gaussmart_tpu_torch/`` at first use and bound in io/jpeg.py.

``read_image`` and ``image_size`` dispatch on a file's content, as Pillow
and cv2 do, not on its extension: the PNG signature goes to ``read_png``,
``FF D8 FF`` to ``read_jpeg``; any other format raises ``ValueError``
naming it. ``exif_orientation=True`` turns the image upright as
``cv2.imread`` does (Pillow does not).

PNG: non-interlaced, bit depth 8, colour types grey (0), RGB (2),
grey+alpha (4) and RGBA (6); the five row filters are undone in one
native pass. Palette images are refused. The writer uses filter 0.

JPEG: see io/jpeg.py (equal to Pillow's decode to the bit, and to its
default save to the byte).

TIFF: baseline little-endian, one uncompressed strip, one float32 sample
per pixel (what PIL writes for a mode "F" image).

Resize: OpenCV's 8-bit INTER_LINEAR in its fixed-point arithmetic
(``resize_linear_u8``), for the readers that the JAX package gives cv2.
"""
from __future__ import annotations

import ctypes
import os
import struct
import zlib

import numpy as np

from gaussmart_tpu_torch.io import jpeg
from gaussmart_tpu_torch.io.jpeg import JPEG_SIGNATURE, jpeg_size, tiff_orientation

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


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    rows = raw.reshape(height, stride + 1)
    if not rows[:, 0].any():
        return np.ascontiguousarray(rows[:, 1:])
    out = np.empty((height, stride), np.uint8)
    err = ctypes.create_string_buffer(128)
    raw = np.ascontiguousarray(raw)
    if jpeg.native().gm_png_unfilter(raw.ctypes.data, height, stride, bpp, out.ctypes.data,
                                     err, len(err)):
        raise ValueError(err.value.decode())
    return out


def _decode_png(data: bytes, name: str):
    """(image, EXIF orientation from an eXIf chunk, 1 without one)."""
    ihdr, idat, exif = None, [], None
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"eXIf" and exif is None:
            exif = body
    if ihdr is None:
        raise ValueError(f"{name}: PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = ihdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{name}: only non-interlaced 8-bit PNGs are supported "
                         f"(bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace})")
    ch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw, height, width * ch, ch).reshape(height, width, ch)
    return img[..., 0] if ch == 1 else img, tiff_orientation(exif or b"")


def read_png(path: str) -> np.ndarray:
    """Decode to uint8 [H,W] (grey), [H,W,2], [H,W,3] or [H,W,4], as
    ``np.asarray(PIL.Image.open(path))`` gives for these modes."""
    with open(path, "rb") as f:
        data = f.read()
    return _decode_png(data, str(path))[0]


# leading bytes of the formats Pillow or cv2 open and the port does not
_OTHER_FORMATS = (
    (b"BM", "BMP"), (b"GIF87a", "GIF"), (b"GIF89a", "GIF"), (b"II*\x00", "TIFF"),
    (b"MM\x00*", "TIFF"), (b"\x00\x00\x01\x00", "ICO"), (b"8BPS", "PSD"),
    (b"\x00\x00\x00\x0cjP  ", "JPEG 2000"), (b"\xff\x4f\xff\x51", "JPEG 2000"),
)


def image_format(path) -> str:
    """'PNG' or 'JPEG' from the file's first bytes; any other format raises
    ValueError naming it ("the port has no BMP decoder")."""
    with open(path, "rb") as f:
        head = f.read(16)
    return _sniff(head, path)


def _sniff(head: bytes, path) -> str:
    if head.startswith(_PNG_SIG):
        return "PNG"
    if head.startswith(JPEG_SIGNATURE):
        return "JPEG"
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        name = "WebP"
    elif head[4:8] == b"ftyp":
        name = "HEIF/AVIF"
    elif len(head) >= 2 and head[0:1] == b"P" and head[1:2] in b"1234567":
        name = "PPM/PGM"
    else:
        name = next((n for sig, n in _OTHER_FORMATS if head.startswith(sig)), None)
    if name is None:
        raise ValueError(f"{path}: unknown image format; the port reads PNG and JPEG")
    raise ValueError(f"{path}: the port has no {name} decoder (it reads PNG and JPEG)")


def image_size(path):
    """(width, height) of a PNG or JPEG, as Pillow's ``.size``."""
    return png_size(path) if image_format(path) == "PNG" else jpeg_size(path)


def read_image(path, exif_orientation: bool = False) -> np.ndarray:
    """Decode a PNG or JPEG as ``np.asarray(PIL.Image.open(path))`` gives
    it; with ``exif_orientation`` the image is turned upright by its EXIF
    orientation as ``cv2.imread`` turns it."""
    with open(path, "rb") as f:
        data = f.read()
    if _sniff(data[:16], path) == "PNG":
        img, orientation = _decode_png(data, str(path))
    else:
        img = jpeg.decode_jpeg(data, str(path))
        orientation = jpeg.exif_orientation(data) if exif_orientation else 1
    if exif_orientation and orientation != 1:
        img = jpeg.apply_exif_orientation(img, orientation)
    return img


# file extensions by which Pillow's save picks the JPEG and PNG writers
_SAVE_FORMATS = {".jpg": "JPEG", ".jpeg": "JPEG", ".jpe": "JPEG", ".jfif": "JPEG",
                 ".png": "PNG"}


def save_format(path) -> str:
    """'JPEG' or 'PNG', chosen by the extension as Pillow's ``save``
    chooses; another extension raises (Pillow would write another format)."""
    ext = os.path.splitext(os.fspath(path))[1].lower()
    if ext not in _SAVE_FORMATS:
        raise ValueError(f"{path}: the port writes PNG and JPEG only, not {ext or 'no'} "
                         "files")
    return _SAVE_FORMATS[ext]


def write_image(path, img: np.ndarray, comment=None):
    """Save as Pillow's ``Image.fromarray(img).save(path)`` picks the format
    (by extension): a JPEG through write_jpeg, with `comment` as its COM
    segment, a PNG through write_png."""
    if save_format(path) == "JPEG":
        jpeg.write_jpeg(path, img, comment=comment)
    else:
        write_png(os.fspath(path), img)


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


# OpenCV's 8-bit INTER_LINEAR resize keeps its weights in 11 fraction bits
_RESIZE_COEF_SCALE = 2048


def _linear_taps(n_out: int, n_in: int):
    """OpenCV's INTER_LINEAR taps along one axis: source index and float32
    fraction of (i + 0.5) * scale - 0.5, with scale = 1 / (n_out / n_in) in
    float64 as OpenCV computes it, then the 11-bit weights, each rounded
    half to even on its own."""
    f = ((np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = f - i0.astype(np.float32)
    return i0, f


def _fixed_weights(f: np.ndarray):
    one = np.float32(_RESIZE_COEF_SCALE)
    return (np.rint((np.float32(1) - f) * one).astype(np.int64),
            np.rint(f * one).astype(np.int64))


def resize_linear_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height))`` (INTER_LINEAR) of a uint8 [H,W]
    or [H,W,C] image, equal to it to the bit: an integer horizontal pass
    (edge columns take their one pixel at full weight), then OpenCV's SIMD
    vertical pass, ((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16) + 2 >> 2,
    with the rows clamped to the image. Channels are independent."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_linear_u8 takes uint8, got {img.dtype}")
    h, w = img.shape[:2]
    x0, fx = _linear_taps(width, w)
    left, right = x0 < 0, x0 >= w - 1
    fx[left | right] = 0
    x0[left], x0[right] = 0, w - 1
    a0, a1 = _fixed_weights(fx)
    y0, fy = _linear_taps(height, h)
    b0, b1 = _fixed_weights(fy)
    extra = (1,) * (img.ndim - 2)
    src = img.astype(np.int64)
    rows = (src[:, x0] * a0.reshape((-1,) + extra)
            + src[:, np.minimum(x0 + 1, w - 1)] * a1.reshape((-1,) + extra))
    s0 = rows[np.clip(y0, 0, h - 1)] >> 4
    s1 = rows[np.clip(y0 + 1, 0, h - 1)] >> 4
    b0, b1 = b0.reshape((-1, 1) + extra), b1.reshape((-1, 1) + extra)
    out = (((s0 * b0) >> 16) + ((s1 * b1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)
