"""MPEG-4 Part 2 video in an MP4 file, without OpenCV or FFmpeg.

The JAX package writes its trajectory videos through ``cv2.VideoWriter``,
which (with no H.264 encoder in the build) writes MPEG-4 Part 2, fourcc
``mp4v``, in an MP4 container. The port writes that format itself:

- ``encode_mp4v``: the elementary stream of ``csrc/imagecodec.cpp``
  (``gm_mp4v_encode``, built by g++ at first use as the JPEG codec is):
  Simple Profile, every frame an I-VOP at one fixed ``vop_quant``, BT.601
  limited-range YCbCr 4:2:0. Integer arithmetic throughout, so the bytes
  are the same on every machine.
- ``mp4_bytes``: the ISO base media file around it: ``ftyp``, ``moov``
  (one ``mp4v`` track whose ``esds`` carries the VOL headers as
  DecoderSpecificInfo, one tick per frame at timescale ``fps``, every
  sample a sync sample, all samples in one chunk), then ``mdat``.
- ``video_bytes`` / ``write_video``: both, from uint8 RGB frames. An odd
  width or height loses its last column or row, as ``cv2.VideoWriter``
  drops them.
- ``read_mp4_info``: a box walker that reads a file of that one layout
  back (codec tag, the VOL's width and height, fps, sample sizes) and
  checks that every sample is an I-VOP; nothing else on a machine without
  a decoder can read it.
"""
from __future__ import annotations

import ctypes
import os
import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

from gaussmart_tpu_torch.io.jpeg import _ERRLEN, native

VOP_QUANT = 3           # the fixed quantizer of every frame (1..31)
VOP_START = b"\x00\x00\x01\xb6"
MP4V_OBJECT_TYPE = 0x20  # objectTypeIndication: MPEG-4 Visual
_U32 = 2 ** 32 - 1
_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def _encoder():
    """gm_mp4v_encode of the codec library (io/jpeg.native), its argtypes set."""
    fn = native().gm_mp4v_encode
    if fn.argtypes is None:
        sz, i = ctypes.c_size_t, ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, i, i, i, i, i,
                       ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.POINTER(sz),
                       ctypes.POINTER(sz), ctypes.c_char_p, sz]
        fn.restype = ctypes.c_int
    return fn


def encode_mp4v(frames: np.ndarray, fps: int = 30) -> Tuple[bytes, List[bytes]]:
    """uint8 [n, h, w, 3] RGB frames (even h and w) -> (the VOS + VO + VOL
    headers, one I-VOP per frame at VOP_QUANT)."""
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"need uint8 [n, h, w, 3] RGB frames, got {frames.dtype} "
                         f"{frames.shape}")
    frames = np.ascontiguousarray(frames)
    n, h, w = frames.shape[:3]
    out = ctypes.POINTER(ctypes.c_uint8)()
    size = ctypes.c_size_t()
    lens = (ctypes.c_size_t * (n + 1))()
    err = ctypes.create_string_buffer(_ERRLEN)
    if _encoder()(frames.ctypes.data, n, w, h, int(fps), VOP_QUANT, ctypes.byref(out),
                  ctypes.byref(size), lens, err, _ERRLEN):
        raise ValueError(err.value.decode())
    try:
        data = ctypes.string_at(out, size.value)
    finally:
        native().gm_free(out)
    ends = np.cumsum(np.asarray(lens, np.int64))
    return data[:ends[0]], [data[a:b] for a, b in zip(ends[:-1], ends[1:])]


def _box(kind: bytes, *payload: bytes) -> bytes:
    body = b"".join(payload)
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full_box(kind: bytes, version: int, flags: int, *payload: bytes) -> bytes:
    return _box(kind, struct.pack(">I", version << 24 | flags), *payload)


def _descriptor(tag: int, body: bytes) -> bytes:
    n = len(body)   # the 4-byte length form, as FFmpeg's muxer writes it
    return bytes([tag, 0x80 | n >> 21 & 0x7F, 0x80 | n >> 14 & 0x7F, 0x80 | n >> 7 & 0x7F,
                  n & 0x7F]) + body


def _moov(vol: bytes, sizes: Sequence[int], width: int, height: int, fps: int,
          offset: int) -> bytes:
    n = len(sizes)
    ms = (n * 1000 + fps // 2) // fps                 # the movie's timescale is 1000
    window = np.convolve(np.asarray(sizes, np.int64), np.ones(min(fps, n), np.int64), "valid")
    avg_bits = sum(sizes) * 8 * fps // n
    esds = _full_box(b"esds", 0, 0, _descriptor(3, struct.pack(">HB", 1, 0) + _descriptor(
        4, struct.pack(">BB", MP4V_OBJECT_TYPE, 4 << 2 | 1)
        + max(sizes).to_bytes(3, "big") + struct.pack(">II", int(window.max()) * 8, avg_bits)
        + _descriptor(5, vol)) + _descriptor(6, b"\x02")))
    entry = _box(b"mp4v", bytes(6), struct.pack(">H", 1), bytes(16),
                 struct.pack(">HHIIIH", width, height, 0x480000, 0x480000, 0, 1), bytes(32),
                 struct.pack(">Hh", 0x18, -1), esds)
    stbl = _box(b"stbl",
                _full_box(b"stsd", 0, 0, struct.pack(">I", 1), entry),
                _full_box(b"stts", 0, 0, struct.pack(">III", 1, n, 1)),
                _full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1)),
                _full_box(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *sizes)),
                _full_box(b"stco", 0, 0, struct.pack(">II", 1, offset)))
    minf = _box(b"minf", _full_box(b"vmhd", 0, 1, bytes(8)),
                _box(b"dinf", _full_box(b"dref", 0, 0, struct.pack(">I", 1),
                                        _full_box(b"url ", 0, 1))),
                stbl)
    mdia = _box(b"mdia",
                _full_box(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, fps, n, 0x55C4, 0)),
                _full_box(b"hdlr", 0, 0, struct.pack(">I", 0), b"vide", bytes(12),
                          b"VideoHandler\x00"),
                minf)
    tkhd = _full_box(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, ms), bytes(8),
                     struct.pack(">hhhH", 0, 0, 0, 0), _MATRIX,
                     struct.pack(">II", width << 16, height << 16))
    mvhd = _full_box(b"mvhd", 0, 0, struct.pack(">IIIIIH", 0, 0, 1000, ms, 0x10000, 0x100),
                     bytes(10), _MATRIX, bytes(24), struct.pack(">I", 2))
    return _box(b"moov", mvhd, _box(b"trak", tkhd, mdia))


def mp4_bytes(vol: bytes, vops: Sequence[bytes], width: int, height: int,
              fps: int) -> bytes:
    """The MP4 file of one mp4v track: `vops` (I-VOPs after the headers
    `vol`) at `fps`."""
    if not vops:
        raise ValueError("an MP4 file needs at least one frame")
    sizes = [len(v) for v in vops]
    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 0x200), b"isomiso2mp41")
    head = len(ftyp) + len(_moov(vol, sizes, width, height, fps, 0)) + 8
    if head + sum(sizes) > _U32:
        raise ValueError(f"{head + sum(sizes)} bytes of video: the 32-bit stco offsets "
                         "and mdat size hold at most 4 GiB")
    return b"".join([ftyp, _moov(vol, sizes, width, height, fps, head),
                     struct.pack(">I", 8 + sum(sizes)), b"mdat", *vops])


def video_bytes(frames: np.ndarray, fps: int = 30) -> bytes:
    """uint8 [n, h, w, 3] RGB frames as an intra-only mp4v MP4 file; an odd
    h or w loses its last row or column (cv2.VideoWriter's rule)."""
    h, w = frames.shape[1] & ~1, frames.shape[2] & ~1
    vol, vops = encode_mp4v(frames[:, :h, :w], fps)
    return mp4_bytes(vol, vops, w, h, fps)


def write_video(path: str, frames: np.ndarray, fps: int = 30) -> int:
    """video_bytes written to `path`; returns the file's size in bytes."""
    data = video_bytes(frames, fps)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


# --- reading back ------------------------------------------------------------
# The reader knows the one layout mp4_bytes writes and raises on any other.

def _boxes(data: bytes, start: int, end: int):
    """(kind, payload start, payload end) of each box in data[start:end]."""
    while start + 8 <= end:
        size, kind = struct.unpack_from(">I4s", data, start)
        if size < 8 or start + size > end:
            raise ValueError(f"box {kind!r} at {start} runs past its parent")
        yield kind, start + 8, start + size
        start += size


def _child(data: bytes, start: int, end: int, *path: bytes) -> Tuple[int, int]:
    for kind in path:
        found = [(s, e) for k, s, e in _boxes(data, start, end) if k == kind]
        if len(found) != 1:
            raise ValueError(f"{len(found)} {kind.decode()} boxes, not one")
        start, end = found[0]
    return start, end


def _table(data: bytes, box: Tuple[int, int], fields: int, skip: int = 0) -> Tuple[int, ...]:
    """The entries of a full box's table: version 0, then `skip` bytes, an
    entry count and `fields` big-endian u32 per entry."""
    if data[box[0]]:
        raise ValueError("a version-1 box")
    n = struct.unpack_from(">I", data, box[0] + 4 + skip)[0]
    return struct.unpack_from(f">{n * fields}I", data, box[0] + 8 + skip)


def _descriptor_body(data: bytes, start: int, tag: int) -> Tuple[int, int]:
    """(body start, body end) of the descriptor `tag` at data[start]."""
    if data[start] != tag:
        raise ValueError(f"descriptor {data[start]:#x} where {tag:#x} belongs")
    n, i = 0, start + 1
    for i in range(start + 1, start + 5):
        n = n << 7 | data[i] & 0x7F
        if not data[i] & 0x80:
            break
    return i + 1, i + 1 + n


class _Bits:
    def __init__(self, data: bytes):
        self.v, self.n, self.pos = int.from_bytes(data, "big"), 8 * len(data), 0

    def get(self, k: int) -> int:
        if self.pos + k > self.n:
            raise ValueError("VOL header ends early")
        self.pos += k
        return self.v >> self.n - self.pos & (1 << k) - 1


def parse_vol(vol: bytes) -> Dict[str, int]:
    """The profile and level, the VOL's width and height, and its
    vop_time_increment_resolution, from the VOS/VO/VOL headers that
    gm_mp4v_encode writes."""
    if not vol.startswith(b"\x00\x00\x01\xb0"):
        raise ValueError("no visual_object_sequence start code")
    i = vol.find(b"\x00\x00\x01\x20")
    if i < 0:
        raise ValueError("no video_object_layer start code")
    info = {"profile_level": vol[4]}
    b = _Bits(vol[i + 4:])
    b.get(1)                                  # random_accessible_vol
    info["object_type"] = b.get(8)
    # is_object_layer_identifier, aspect_ratio_info, vol_control_parameters,
    # chroma_format, low_delay, vbv_parameters, shape: as the encoder writes
    # them (no identifier, square pixels, 4:2:0, no B-VOPs, no VBV, rectangular)
    if (b.get(1), b.get(4), b.get(1), b.get(2), b.get(1), b.get(1), b.get(2)) != (
            0, 1, 1, 1, 1, 0, 0):
        raise ValueError("a video object layer the port does not write")
    b.get(1)
    info["time_resolution"] = b.get(16)
    b.get(1)
    if b.get(1):                              # fixed_vop_rate
        b.get(max(1, (info["time_resolution"] - 1).bit_length()))
    b.get(1)
    info["width"] = b.get(13)
    b.get(1)
    info["height"] = b.get(13)
    return info


def read_mp4_info(path: str) -> Dict:
    """What an mp4v MP4 file of mp4_bytes' layout holds: codec tag, the
    VOL's width and height (and the sample entry's), fps, sample count and
    sizes, profile and level. Raises ValueError on another layout, and
    unless every sample is an I-VOP (it begins with 00 00 01 B6 and its
    vop_coding_type is 0)."""
    with open(path, "rb") as f:
        data = f.read()
    mdia = _child(data, 0, len(data), b"moov", b"trak", b"mdia")
    mdhd = _child(data, *mdia, b"mdhd")
    if data[mdhd[0]]:
        raise ValueError(f"{path}: a version-1 mdhd")
    timescale = struct.unpack_from(">I", data, mdhd[0] + 12)[0]
    stbl = _child(data, *mdia, b"minf", b"stbl")
    stsd = _child(data, *stbl, b"stsd")
    entries = list(_boxes(data, stsd[0] + 8, stsd[1]))
    if len(entries) != 1:
        raise ValueError(f"{path}: {len(entries)} sample entries, not one")
    kind, es, ee = entries[0]
    entry_w, entry_h = struct.unpack_from(">HH", data, es + 24)
    esds = _child(data, es + 78, ee, b"esds")
    s, _ = _descriptor_body(data, esds[0] + 4, 3)     # ES_Descriptor
    if data[s + 2]:
        raise ValueError(f"{path}: ES_Descriptor flags the port does not write")
    s, _ = _descriptor_body(data, s + 3, 4)           # DecoderConfigDescriptor
    object_type = data[s]
    s, e = _descriptor_body(data, s + 13, 5)          # DecoderSpecificInfo: the VOL
    vol = data[s:e]
    stts = _table(data, _child(data, *stbl, b"stts"), 2)
    stsc = _table(data, _child(data, *stbl, b"stsc"), 3)
    stsz = _child(data, *stbl, b"stsz")
    if struct.unpack_from(">I", data, stsz[0] + 4)[0]:
        raise ValueError(f"{path}: one size for every sample, not a size each")
    sizes = list(_table(data, stsz, 1, skip=4))
    offsets = _table(data, _child(data, *stbl, b"stco"), 1)
    n = len(sizes)
    if len(stts) != 2 or stts[0] != n or len(offsets) != 1 or stsc != (1, n, 1):
        raise ValueError(f"{path}: not one chunk of {n} samples at one rate")
    pos = offsets[0]
    for i, size in enumerate(sizes):
        if size < 5 or pos + size > len(data) or data[pos:pos + 4] != VOP_START:
            raise ValueError(f"{path}: sample {i} does not begin with a VOP start code")
        if data[pos + 4] >> 6 != 0:
            raise ValueError(f"{path}: sample {i} is not an I-VOP")
        pos += size
    vol_info = parse_vol(vol)
    return {"codec": kind.decode("latin-1"), "object_type_indication": object_type,
            "width": vol_info["width"], "height": vol_info["height"],
            "entry_size": (entry_w, entry_h), "fps": timescale / stts[1], "n_samples": n,
            "sample_sizes": sizes, "profile_level": vol_info["profile_level"]}
