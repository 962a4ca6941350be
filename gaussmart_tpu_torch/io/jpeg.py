"""JPEG decode and encode on the host, without Pillow or OpenCV.

The JAX package opens photos with PIL and cv2, which both decode through
libjpeg-turbo; the port carries its own codec, ``csrc/imagecodec.cpp``,
which g++ builds into ``build/gaussmart_tpu_torch/`` at first use
(kernels.build_cxx; a failed build raises) and ctypes binds.

- ``read_jpeg`` equals Pillow's ``np.asarray(Image.open(f))`` to the bit
  (uint8 [H,W] for grey, [H,W,3] for colour): the integer IDCT, fancy
  upsampling and YCbCr->RGB that libjpeg-turbo uses by default.
  Baseline, extended-Huffman and progressive 8-bit files of 1 or 3
  components with any integral sampling factors and restart intervals;
  CMYK/YCCK, 12-bit, arithmetic-coded, lossless and hierarchical files
  raise ``ValueError`` naming what they are, as does a truncated file
  ("image file is truncated", Pillow's words). Any byte string gives an
  array or a ``ValueError``.
- ``jpeg_size`` reads markers only as far as the frame header.
- ``exif_orientation`` / ``apply_exif_orientation``: the EXIF orientation
  tag and the flips and transposes with which ``cv2.imread`` applies it
  (Pillow ignores it).
- ``write_jpeg`` writes the file Pillow's ``Image.save(path)`` writes for
  an L or RGB image with no options, byte for byte: baseline, the
  standard tables scaled by ``quality``, RGB as YCbCr 4:2:0, and only the
  JFIF 1.01 header (no EXIF, no ICC profile).
"""
from __future__ import annotations

import ctypes
import io
import os
import struct
import threading
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from gaussmart_tpu_torch import kernels

SRC = Path(__file__).resolve().parents[1] / "csrc" / "imagecodec.cpp"
JPEG_SIGNATURE = b"\xff\xd8\xff"
_ERRLEN = 512

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

Source = Union[str, os.PathLike, bytes, bytearray, memoryview]


def native() -> ctypes.CDLL:
    """The codec library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(kernels.build_cxx(SRC, "imagecodec")))
            vp, sz, cp = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p
            lib.gm_jpeg_info.argtypes = [cp, sz, ctypes.POINTER(ctypes.c_int), cp, sz]
            lib.gm_jpeg_decode.argtypes = [cp, sz, vp, sz, cp, sz]
            lib.gm_jpeg_encode.argtypes = [
                vp, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, cp, sz,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.POINTER(sz), cp, sz]
            lib.gm_free.argtypes = [vp]
            lib.gm_free.restype = None
            lib.gm_png_unfilter.argtypes = [vp, ctypes.c_int, sz, ctypes.c_int, vp, cp, sz]
            i64 = ctypes.c_int64
            lib.gm_resample_u8.argtypes = [vp, i64, i64, i64, i64, ctypes.c_int, vp, vp, vp]
            lib.gm_resample_u8.restype = None
            for fn in (lib.gm_jpeg_info, lib.gm_jpeg_decode, lib.gm_jpeg_encode,
                       lib.gm_png_unfilter):
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def _load(src: Source) -> Tuple[bytes, str]:
    if isinstance(src, (bytes, bytearray, memoryview)):
        return bytes(src), "<bytes>"
    with open(src, "rb") as f:
        return f.read(), os.fspath(src)


def read_jpeg(src: Source) -> np.ndarray:
    """Decode a JPEG file or byte string to uint8 [H,W] or [H,W,3]."""
    return decode_jpeg(*_load(src))


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """read_jpeg of a byte string; errors name the file as `name`."""
    lib = native()
    err = ctypes.create_string_buffer(_ERRLEN)
    info = (ctypes.c_int * 3)()
    if lib.gm_jpeg_info(data, len(data), info, err, _ERRLEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    w, h, c = info
    out = np.empty((h, w, c), np.uint8)
    if lib.gm_jpeg_decode(data, len(data), out.ctypes.data, out.size, err, _ERRLEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out[..., 0] if c == 1 else out


def _segments(f):
    """(marker, body) of each marker segment of a JPEG file object opened
    at byte 2, up to its first scan; the file is read no further than the
    segment yielded."""
    while True:
        b = f.read(1)
        while b and b != b"\xff":
            b = f.read(1)
        while b == b"\xff":
            b = f.read(1)
        if not b or b[0] in (0xD9, 0xDA):
            return
        if b[0] == 0 or b[0] == 0x01 or 0xD0 <= b[0] <= 0xD7:
            continue                    # stuffed byte, TEM, RSTn: no length
        raw = f.read(2)
        if len(raw) < 2 or struct.unpack(">H", raw)[0] < 2:
            return
        yield b[0], f.read(struct.unpack(">H", raw)[0] - 2)


def jpeg_size(path) -> Tuple[int, int]:
    """(width, height) from the frame header, as Pillow's ``.size``."""
    with open(path, "rb") as f:
        if f.read(3) != JPEG_SIGNATURE:
            raise ValueError(f"{path}: not a JPEG file")
        f.seek(2)
        for m, body in _segments(f):
            if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC) and len(body) >= 5:
                _, h, w = struct.unpack(">BHH", body[:5])
                return w, h
    raise ValueError(f"{path}: JPEG without a frame header")


def tiff_orientation(tiff: bytes) -> int:
    """The Orientation tag (0x0112) of IFD0 of a TIFF-structured EXIF
    block; 1 when it is absent or out of range."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    (ifd,) = struct.unpack(e + "I", tiff[4:8])
    if ifd + 2 > len(tiff):
        return 1
    (count,) = struct.unpack(e + "H", tiff[ifd:ifd + 2])
    for i in range(count):
        at = ifd + 2 + 12 * i
        if at + 12 > len(tiff):
            break
        tag, typ, n = struct.unpack(e + "HHI", tiff[at:at + 8])
        if tag == 0x0112 and typ == 3 and n >= 1:
            (value,) = struct.unpack(e + "H", tiff[at + 8:at + 10])
            return value if 1 <= value <= 8 else 1
    return 1


def exif_orientation(data: bytes) -> int:
    """EXIF orientation (1-8) of a JPEG byte string, from its first
    ``Exif`` APP1 segment before the first scan; 1 without one."""
    for m, body in _segments(io.BytesIO(data[2:])):
        if m == 0xE1 and body[:6] == b"Exif\x00\x00":
            return tiff_orientation(body[6:])
    return 1


def jpeg_comment(data: bytes) -> Optional[bytes]:
    """The last COM segment before the first scan, which Pillow keeps in
    ``Image.info["comment"]`` and writes again when it saves a copy."""
    comment = None
    for m, body in _segments(io.BytesIO(data[2:])):
        if m == 0xFE:
            comment = body
    return comment


def apply_exif_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """Turn an [H,W(,C)] image upright as cv2.imread does for each EXIF
    orientation: 2 mirror, 3 rotate 180, 4 flip, 5 transpose, 6 transpose
    then mirror, 7 transpose then rotate 180, 8 transpose then flip."""
    if orientation in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def encode_jpeg(img: np.ndarray, quality: int = 75, comment: Optional[bytes] = None) -> bytes:
    """The bytes Pillow's ``Image.fromarray(img).save(f, "JPEG",
    quality=quality, comment=comment)`` writes, for uint8 [H,W], [H,W,1]
    or [H,W,3]."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_jpeg takes uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"write_jpeg takes L or RGB, got shape {img.shape}")
    img = np.ascontiguousarray(img)
    lib = native()
    out = ctypes.POINTER(ctypes.c_uint8)()
    size = ctypes.c_size_t()
    err = ctypes.create_string_buffer(_ERRLEN)
    c = 1 if img.ndim == 2 else 3
    comment = bytes(comment or b"")
    if lib.gm_jpeg_encode(img.ctypes.data, img.shape[1], img.shape[0], c, int(quality),
                          comment, len(comment), ctypes.byref(out), ctypes.byref(size), err, _ERRLEN):
        raise ValueError(err.value.decode())
    try:
        return ctypes.string_at(out, size.value)
    finally:
        lib.gm_free(out)


def write_jpeg(path, img: np.ndarray, quality: int = 75, comment: Optional[bytes] = None):
    """Write `img` as Pillow's default JPEG save does (see encode_jpeg)."""
    data = encode_jpeg(img, quality, comment)
    os.makedirs(os.path.dirname(os.fspath(path)) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
