"""The port's trajectory videos (io/video.py: csrc/imagecodec.cpp's
intra-only MPEG-4 Part 2 encoder in an MP4 file) against the JAX
package's create_video (cv2.VideoWriter, which writes mp4v here), with
the installed cv2 (FFmpeg inside) as the decoder.

Tolerances, fixed before the measurements they judge:
- SMOOTH_FLOOR_DB: each decoded frame of a smooth clip against its uint8
  source, 37 dB: the JAX package's mp4v file decoded at 37.22 dB at worst
  on 30 smooth 776x584 frames.
- TEXTURED_FLOOR_DB: high-entropy frames (a smooth image plus per-pixel
  noise of standard deviation ~6.5, as textured photos hold), 30 dB.
- NOISE_FLOOR_DB: independent uniform noise in every channel, 12 dB: the
  4:2:0 chroma that both writers use keeps such frames near 13 dB.
  test_torch_slice.py holds render_cli's renders to the smooth floor, and
  its turbo depth and normal frames to one of their own.
- On every clip no port frame may fall below the JAX file's worst frame.
- Frame count, size and fps equal to the JAX file's.
"""
import ctypes
import hashlib
import json
import os

import numpy as np
import pytest

import chip_smoke
from gaussmart_tpu import trajectory as jtraj
from gaussmart_tpu_torch import trajectory as ttraj
from gaussmart_tpu_torch.io import video
from gaussmart_tpu_torch.io.jpeg import native

cv2 = pytest.importorskip("cv2")

SMOOTH_FLOOR_DB = 37.0
TEXTURED_FLOOR_DB = 30.0
NOISE_FLOOR_DB = 12.0
FLOORS = {"smooth": SMOOTH_FLOOR_DB, "textured": TEXTURED_FLOOR_DB, "noise": NOISE_FLOOR_DB,
          "fixture": TEXTURED_FLOOR_DB}
N_FRAMES = 16
with open(os.path.join(chip_smoke.VIDEO_DATA, "digests.json")) as f:
    DIGESTS = json.load(f)


def _smooth(rng, n, h, w):
    """float [n, h, w, 3] in [0, 1]: drifting low-frequency sinusoids."""
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    k, ph = rng.uniform(1, 4, (3, 2)), rng.uniform(0, 6, 3)
    return np.stack([np.stack([0.5 + 0.4 * np.sin(k[c, 0] * x + k[c, 1] * y + ph[c] + 0.15 * i)
                               for c in range(3)], -1) for i in range(n)])


def _clip(kind, n, h, w, seed=0):
    """float frames in [0, 1] of one kind, made from a seed."""
    rng = np.random.default_rng(seed)
    if kind == "smooth":
        return _smooth(rng, n, h, w)
    if kind == "textured":
        return np.clip(_smooth(rng, n, h, w) + rng.normal(0, 6.5 / 255, (n, h, w, 3)), 0, 1)
    if kind == "noise":
        return rng.random((n, h, w, 3))
    # the integer-only fixture, as floats that create_video quantizes back
    return (chip_smoke.video_fixture(n, h, w) + 0.5) / 255


def _u8(frames):
    return np.clip(np.asarray(frames) * 255, 0, 255).astype(np.uint8)


def _decode(path):
    """(RGB uint8 frames, (frame count, width, height, fps)) through cv2."""
    cap = cv2.VideoCapture(path)
    props = tuple(cap.get(p) for p in (cv2.CAP_PROP_FRAME_COUNT, cv2.CAP_PROP_FRAME_WIDTH,
                                       cv2.CAP_PROP_FRAME_HEIGHT, cv2.CAP_PROP_FPS))
    frames = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    cap.release()
    return frames, props


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def _against_jax(tmp_path, frames, floor, fps=30):
    """Both packages' create_video on the same float frames, decoded by
    cv2: the port's frames against their uint8 source. Returns the port's
    PSNRs, the JAX file's and the port file's path."""
    jpath, tpath = str(tmp_path / "jax.mp4"), str(tmp_path / "port.mp4")
    jtraj.create_video(list(frames), jpath, fps=fps)
    ttraj.create_video(list(frames), tpath, fps=fps)
    jdec, jprops = _decode(jpath)
    tdec, tprops = _decode(tpath)
    assert tprops == jprops and len(tdec) == len(jdec) == len(frames), (tprops, jprops)
    src = _u8(frames)[:, :int(tprops[2]), :int(tprops[1])]
    tp = [_psnr(a, b) for a, b in zip(tdec, src)]
    jp = [_psnr(a, b) for a, b in zip(jdec, src)]
    assert min(tp) >= floor, (min(tp), floor)
    assert min(tp) >= min(jp), (min(tp), min(jp))
    return tp, jp, tpath


CLIPS = [(kind, N_FRAMES, h, w) for (w, h) in ((64, 48), (100, 76))
         for kind in ("smooth", "textured", "noise")]
CLIPS += [("fixture", c["frames"], c["height"], c["width"]) for c in DIGESTS["cases"]]


@pytest.mark.parametrize("kind,n,h,w", CLIPS, ids=[f"{k}-{w}x{h}" for k, _, h, w in CLIPS])
def test_port_video_against_jax(tmp_path, kind, n, h, w):
    _against_jax(tmp_path, _clip(kind, n, h, w), FLOORS[kind])


@pytest.mark.parametrize("w,h", [(65, 49), (63, 48), (64, 47)])
def test_odd_sizes_lose_the_last_column_and_row_as_cv2(tmp_path, w, h):
    """cv2.VideoWriter writes an odd width or height one smaller, without
    the last column or row; so does the port."""
    _, _, path = _against_jax(tmp_path, _clip("smooth", 4, h, w), SMOOTH_FLOOR_DB)
    info = video.read_mp4_info(path)
    assert (info["width"], info["height"]) == (w & ~1, h & ~1)


@pytest.mark.parametrize("case", DIGESTS["cases"],
                         ids=[f"{c['width']}x{c['height']}" for c in DIGESTS["cases"]])
def test_fixture_encodes_to_the_committed_digest(tmp_path, case):
    """The integer-only fixture (chip_smoke.video_fixture) encodes to the
    sha256 committed in tests/torch_data/video/digests.json, through
    video_bytes and through create_video's file alike (chip_smoke.py holds
    the card machine's build to the same digests)."""
    u8 = chip_smoke.video_fixture(case["frames"], case["height"], case["width"])
    data = video.video_bytes(u8, DIGESTS["fps"])
    assert hashlib.sha256(data).hexdigest() == case["sha256"]
    path = str(tmp_path / "fixture.mp4")
    ttraj.create_video(list((u8 + 0.5) / 255), path, fps=DIGESTS["fps"])
    with open(path, "rb") as f:
        assert f.read() == data
    assert [c[1] == c[2] for c in chip_smoke.video_fixture_digests()] == [True] * len(
        DIGESTS["cases"])


@pytest.mark.parametrize("fps,n", [(30, 70), (24, 30), (1, 3)])
def test_structure_and_time_base(tmp_path, fps, n):
    """read_mp4_info on the port's file: sample count and sizes, the VOL's
    size, fps, every sample an I-VOP; cv2 agrees, past whole seconds
    (modulo_time_base) too."""
    u8 = chip_smoke.video_fixture(n, 48, 64)
    path = str(tmp_path / "v.mp4")
    size = video.write_video(path, u8, fps=fps)
    info = video.read_mp4_info(path)
    vol, vops = video.encode_mp4v(u8, fps)
    assert size == os.path.getsize(path)
    assert info["codec"] == "mp4v" and info["object_type_indication"] == 0x20
    assert (info["width"], info["height"], info["entry_size"]) == (64, 48, (64, 48))
    assert info["fps"] == fps and info["n_samples"] == n
    assert info["sample_sizes"] == [len(v) for v in vops]
    assert info["profile_level"] == 0x01           # 12 macroblocks: Simple Profile L1
    assert video.parse_vol(vol)["time_resolution"] == fps
    assert all(v.startswith(video.VOP_START) and v[4] >> 6 == 0 for v in vops)
    frames, props = _decode(path)
    assert props == (n, 64, 48, fps) and len(frames) == n
    assert min(_psnr(a, b) for a, b in zip(frames, u8)) >= TEXTURED_FLOOR_DB


def test_profile_level_covers_the_frame():
    """Simple Profile's level by macroblocks per VOP: 776x584 is 49x37 =
    1,813, above L5's 1,620, so L6 (0x06)."""
    for (w, h), want in (((176, 144), 1), ((352, 288), 2), ((640, 480), 4), ((720, 576), 5),
                         ((776, 584), 6), ((1280, 720), 6)):
        vol, _ = video.encode_mp4v(np.zeros((1, h, w, 3), np.uint8))
        got = video.parse_vol(vol)
        assert (got["profile_level"], got["width"], got["height"]) == (want, w, h)


def _encode_at(u8, quant):
    """gm_mp4v_encode's return code and message at a given vop_quant."""
    out, size = ctypes.POINTER(ctypes.c_uint8)(), ctypes.c_size_t()
    lens = (ctypes.c_size_t * (len(u8) + 1))()
    err = ctypes.create_string_buffer(512)
    rc = video._encoder()(u8.ctypes.data, len(u8), u8.shape[2], u8.shape[1], 30, quant,
                          ctypes.byref(out), ctypes.byref(size), lens, err, 512)
    if rc == 0:
        native().gm_free(out)
    return rc, err.value.decode()


def test_refusals(tmp_path, monkeypatch):
    u8 = chip_smoke.video_fixture(2, 16, 16)
    assert [_encode_at(u8, q) for q in (0, 32)] == [(1, "vop_quant is 1..31")] * 2
    assert _encode_at(u8, video.VOP_QUANT) == (0, "")
    with pytest.raises(ValueError, match="frame rates"):
        video.encode_mp4v(u8, fps=0)
    with pytest.raises(ValueError, match="even"):
        video.encode_mp4v(u8[:, :15])
    for bad in (u8[..., :2], u8.astype(np.float32)):
        with pytest.raises(ValueError, match="RGB frames"):
            video.encode_mp4v(bad)
    monkeypatch.setattr(video, "_U32", 1000)
    with pytest.raises(ValueError, match="4 GiB"):
        video.video_bytes(chip_smoke.video_fixture(4, 48, 64))
    monkeypatch.undo()
    # a sample that is not an I-VOP, and one without a VOP start code
    path = str(tmp_path / "v.mp4")
    video.write_video(path, u8)
    data = bytearray(open(path, "rb").read())
    first = data.index(video.VOP_START)
    for pos, value, match in ((first + 4, data[first + 4] | 0x40, "not an I-VOP"),
                              (first + 3, 0xB3, "VOP start code")):
        bad = bytearray(data)
        bad[pos] = value
        with open(path, "wb") as f:
            f.write(bad)
        with pytest.raises(ValueError, match=match):
            video.read_mp4_info(path)


def _set_byte(data, kind, offset, value):
    """A copy of `data` with the byte `offset` after the 4-byte `kind` set."""
    out = bytearray(data)
    pos = data.index(kind) + offset
    out[pos] = value(out[pos])
    return bytes(out)


@pytest.mark.parametrize("mutate,match", [
    (lambda d: _set_byte(d, b"mdhd", 4, lambda b: 1), "version-1 mdhd"),
    (lambda d: _set_byte(d, b"stsz", 11, lambda b: 7), "one size for every sample"),
    (lambda d: _set_byte(d, b"stco", 11, lambda b: 2), "not one chunk"),
    (lambda d: _set_byte(d, b"\x00\x00\x01\x20", 5, lambda b: b | 0x40), "does not write"),
    (None, "sample 0 does not begin with a VOP start code"),
], ids=["mdhd-v1", "stsz-fixed", "stco-two-chunks", "vol-identifier", "cv2-file"])
def test_reader_refuses_another_layout(tmp_path, mutate, match):
    """read_mp4_info knows only the layout mp4_bytes writes: a version-1
    mdhd, one size for every sample, a second chunk or a VOL field the
    encoder does not write raises; so does cv2's mp4v file (mutate None),
    whose first sample carries the VOL headers in band."""
    path = str(tmp_path / "v.mp4")
    u8 = chip_smoke.video_fixture(3, 16, 16)
    if mutate is None:
        jtraj.create_video(list((u8 + 0.5) / 255), path)
    else:
        with open(path, "wb") as f:
            f.write(mutate(video.video_bytes(u8)))
    with pytest.raises(ValueError, match=match):
        video.read_mp4_info(path)
