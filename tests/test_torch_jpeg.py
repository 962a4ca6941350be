"""The port's JPEG codec and image dispatch (io/jpeg.py, io/images.py,
csrc/imagecodec.cpp) against Pillow and OpenCV, on the CPU: the decoder
bit-equal to both over a grid of sampling factors, qualities, codings
and sizes; the committed fixtures against the digests Pillow gave; the
encoder byte-equal to Pillow's save; EXIF orientations as cv2 applies
them; the refusals; truncated and corrupted files; the native PNG
unfilter. PIL and cv2 are references here only."""
import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from gaussmart_tpu_torch.io import images, jpeg

cv2 = pytest.importorskip("cv2")

DATA = os.path.join(os.path.dirname(__file__), "torch_data", "jpeg")
with open(os.path.join(DATA, "digests.json")) as _f:
    DIGESTS = json.load(_f)

SIZES = ((1, 1), (9, 7), (97, 131), (1031, 17))     # (h, w)
LAYOUTS = ("444", "422", "420", "440", "411", "grey")
CODINGS = ("baseline", "optimize", "progressive", "restart")
QUALITIES = (10, 75, 95, 100)


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _photo(rng, h, w):
    y, x = np.mgrid[:h, :w].astype(np.float64)
    base = np.stack([128 + 100 * np.sin(x / 5.0 + y / 13.0),
                     128 + 90 * np.cos(y / 4.0 - x / 17.0), (x * 7 + y * 3) % 256], -1)
    return np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(np.uint8)


def _cv2_encode(img, layout, quality, coding):
    flags = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if layout != "grey":
        flags += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                  getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{layout}")]
    flags += {"baseline": [], "optimize": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
              "progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
              "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]}[coding]
    ok, buf = cv2.imencode(".jpg", img, flags)
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("coding", CODINGS)
@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_decoder_is_bit_equal_to_pillow_and_cv2(rng, layout, quality, coding):
    """Files that libjpeg-turbo writes through cv2 (each sampling factor,
    grey, 4 qualities, optimized tables, progressive, restart markers) at
    1x1, 7x9, 131x97 and 17x1031: read_jpeg equals Pillow's decode and
    cv2.imread's (orientation ignored, BGR reversed) to the bit."""
    for h, w in SIZES:
        img = _photo(rng, h, w)
        if layout == "grey":
            img = img[..., 0].copy()
        data = _cv2_encode(img, layout, quality, coding)
        got = jpeg.read_jpeg(data)
        ref = np.asarray(Image.open(io.BytesIO(data)))
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref, err_msg=f"{w}x{h}")
        buf = np.frombuffer(data, np.uint8)
        if layout == "grey":
            ocv = cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE | cv2.IMREAD_IGNORE_ORIENTATION)
        else:
            ocv = cv2.imdecode(buf, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)[..., ::-1]
        np.testing.assert_array_equal(got, ocv, err_msg=f"{w}x{h}")


@pytest.mark.parametrize("kw", [{"subsampling": 0}, {"subsampling": 1}, {"subsampling": 2},
                                {"progressive": True, "optimize": True},
                                {"progressive": True, "subsampling": 0}])
def test_decoder_reads_pillows_own_files(rng, kw):
    """Pillow's writer with its own options, at odd sizes where the
    chroma is 1 or 2 samples wide (box upsampling) and wider."""
    for h, w in ((3, 5), (2, 2), (5, 3), (16, 33), (57, 61)):
        img = _photo(rng, h, w)
        b = io.BytesIO()
        Image.fromarray(img).save(b, format="JPEG", quality=90, **kw)
        np.testing.assert_array_equal(jpeg.read_jpeg(b.getvalue()),
                                      np.asarray(Image.open(io.BytesIO(b.getvalue()))))


FIXTURES = sorted(n for n, d in DIGESTS["decoded"].items() if "sha256" in d)


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_decodes_to_pillows_digest(name):
    """Each committed fixture: read_image gives the array whose sha256
    Pillow gave when the fixtures were made (chip_smoke.py checks the same
    on the card's machine), Pillow here agrees, and image_size is
    Pillow's size."""
    path = os.path.join(DATA, name)
    want = DIGESTS["decoded"][name]
    got = images.read_image(path)
    assert list(got.shape) == want["shape"]
    assert _sha(got) == want["sha256"]
    assert _sha(np.asarray(Image.open(path))) == want["sha256"]
    assert list(images.image_size(path)) == want["size"] == list(Image.open(path).size)


def test_full_size_textured_photo_matches_pillows_digests():
    """chip_smoke.textured_photo at garden's 5187x3361, encoded at quality
    95 and decoded, gives Pillow's file and Pillow's pixels (the digests
    phase 10 holds on the card's machine): the codec at full size on a
    high-entropy photo."""
    import chip_smoke
    want = DIGESTS["textured"]
    w, h = want["size"]
    data = jpeg.encode_jpeg(chip_smoke.textured_photo(h, w), want["quality"])
    assert hashlib.sha256(data).hexdigest() == want["encoded"]
    assert _sha(jpeg.decode_jpeg(data)) == want["decoded"]


def test_image_size_reads_only_the_header(tmp_path):
    """jpeg_size stops at the frame header: a file cut right after it
    still gives Pillow's size; the CMYK fixture's size is given too."""
    data = open(os.path.join(DATA, "s420.jpg"), "rb").read()
    sof = data.index(b"\xff\xc0")
    (tmp_path / "cut.jpg").write_bytes(data[:sof + 9])
    assert images.image_size(str(tmp_path / "cut.jpg")) == (131, 97)
    assert list(images.image_size(os.path.join(DATA, "cmyk.jpg"))) == \
        DIGESTS["decoded"]["cmyk.jpg"]["size"]


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_write_jpeg_is_byte_equal_to_pillows_save(tmp_path, rng, mode, quality):
    """write_jpeg writes the file Image.save writes, for RGB (4:2:0) and
    L, at sizes with partial MCUs; default quality is Pillow's 75."""
    for h, w in SIZES + ((16, 16), (17, 33)):
        img = _photo(rng, h, w)
        if mode == "L":
            img = img[..., 1].copy()
        b = io.BytesIO()
        Image.fromarray(img, mode).save(b, format="JPEG", quality=quality)
        assert jpeg.encode_jpeg(img, quality) == b.getvalue(), f"{w}x{h}"
    path = tmp_path / "d" / "x.jpg"
    jpeg.write_jpeg(path, img)
    Image.fromarray(img, mode).save(tmp_path / "ref.jpg")
    assert path.read_bytes() == (tmp_path / "ref.jpg").read_bytes()


@pytest.mark.parametrize("source", sorted(DIGESTS["encoded"]))
def test_fixture_sources_encode_to_pillows_digest(source):
    img = images.read_image(os.path.join(DATA, source))
    for q, digest in DIGESTS["encoded"][source].items():
        assert hashlib.sha256(jpeg.encode_jpeg(img, int(q))).hexdigest() == digest, q


def test_write_jpeg_keeps_a_comment_as_pillow_does(tmp_path, rng):
    img = _photo(rng, 20, 30)
    for comment in (b"scene 7", b""):
        b = io.BytesIO()
        Image.fromarray(img).save(b, format="JPEG", comment=comment)
        assert jpeg.encode_jpeg(img, comment=comment) == b.getvalue()
        assert jpeg.jpeg_comment(b.getvalue()) == (comment or None)


@pytest.mark.parametrize("ext", ["jpg", "png"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_follows_cv2_and_is_ignored_as_pillow_ignores_it(
        tmp_path, rng, orientation, ext):
    img = _photo(rng, 40, 64)
    exif = Image.Exif()
    exif[0x0112] = orientation
    path = str(tmp_path / f"o.{ext}")
    Image.fromarray(img).save(path, exif=exif)
    np.testing.assert_array_equal(images.read_image(path, exif_orientation=True),
                                  cv2.imread(path)[..., ::-1])
    np.testing.assert_array_equal(images.read_image(path), np.asarray(Image.open(path)))
    assert images.image_size(path) == Image.open(path).size == (64, 40)


def test_orientation_fixture_matches_cv2s_digest():
    got = images.read_image(os.path.join(DATA, "orient6.jpg"), exif_orientation=True)
    want = DIGESTS["cv2_upright"]["orient6.jpg"]
    assert list(got.shape) == want["shape"] and _sha(got) == want["sha256"]


def _patched(data: bytes, at: int, value: int) -> bytes:
    b = bytearray(data)
    b[at] = value
    return bytes(b)


def test_refusals_name_what_the_file_is(tmp_path):
    base = open(os.path.join(DATA, "s420.jpg"), "rb").read()
    sof = base.index(b"\xff\xc0")
    cases = [
        (open(os.path.join(DATA, "cmyk.jpg"), "rb").read(), "CMYK/YCCK"),
        (_patched(base, sof + 1, 0xC9), "arithmetic-coded"),
        (_patched(base, sof + 1, 0xCA), "arithmetic-coded"),
        (_patched(base, sof + 1, 0xC3), "lossless"),
        (_patched(base, sof + 1, 0xCB), "lossless"),
        (_patched(base, sof + 1, 0xC5), "hierarchical"),
        (_patched(base, sof + 1, 0xCF), "hierarchical"),
        (_patched(base, sof + 4, 12), "12-bit"),
        (base[:len(base) // 2], "image file is truncated"),
        (base[:-2], "image file is truncated"),
        (b"\xff\xd8\xff\xd9", "contains no image"),
        (b"GIF89a", "not a JPEG"),
    ]
    for data, words in cases:
        with pytest.raises(ValueError, match=words):
            jpeg.read_jpeg(data)
    with pytest.raises(OSError, match="image file is truncated"):
        Image.open(io.BytesIO(base[:len(base) // 2])).load()    # Pillow's words
    for name, save in (("x.bmp", "BMP"), ("x.gif", "GIF"), ("x.tif", "TIFF"),
                       ("x.webp", "WEBP")):
        Image.new("RGB", (4, 4)).save(tmp_path / name, format=save)
        with pytest.raises(ValueError, match=f"no {save.replace('WEBP', 'WebP')} decoder"):
            images.read_image(str(tmp_path / name))
        with pytest.raises(ValueError, match="decoder"):
            images.image_size(str(tmp_path / name))
    (tmp_path / "x.txt").write_text("hello")
    with pytest.raises(ValueError, match="unknown image format"):
        images.read_image(str(tmp_path / "x.txt"))
    for name in ("x.bmp", "x.tif", "x"):
        with pytest.raises(ValueError, match="writes PNG and JPEG only"):
            images.write_image(str(tmp_path / "out" / name), np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="L or RGB"):
        jpeg.encode_jpeg(np.zeros((4, 4, 4), np.uint8))


@pytest.mark.parametrize("name", ["s420.jpg", "progressive.jpg", "restart.jpg", "grey.jpg",
                                  "s411.jpg"])
def test_truncated_and_corrupted_files_give_an_array_or_a_value_error(rng, name):
    """Every cut of a fixture, one flipped bit at every byte and random
    byte values: each decode returns a uint8 array of the header's shape
    or raises ValueError, in this process."""
    data = open(os.path.join(DATA, name), "rb").read()
    variants = [data[:cut] for cut in range(0, len(data), 3)]
    for i in range(len(data)):
        b = bytearray(data)
        b[i] ^= 1 << int(rng.integers(8))
        variants.append(bytes(b))
    for _ in range(200):
        b = bytearray(data)
        for at in rng.integers(0, len(data), 4):
            b[at] = int(rng.integers(256))
        variants.append(bytes(b))
    n_arrays = 0
    for v in variants:
        try:
            out = jpeg.read_jpeg(v)
        except ValueError:
            continue
        assert out.dtype == np.uint8 and out.ndim in (2, 3)
        n_arrays += 1
    assert 0 < n_arrays < len(variants)


def _png_rows(img: np.ndarray, ftype: int) -> bytes:
    """Filter an [H, W*C] uint8 image with one PNG filter type."""
    bpp = img.shape[2] if img.ndim == 3 else 1
    x = img.reshape(img.shape[0], -1).astype(np.int64)
    left = np.concatenate([np.zeros((x.shape[0], bpp), np.int64), x[:, :-bpp]], axis=1)
    up = np.concatenate([np.zeros((1, x.shape[1]), np.int64), x[:-1]], axis=0)
    upleft = np.concatenate([np.zeros((x.shape[0], bpp), np.int64), up[:, :-bpp]], axis=1)
    if ftype == 0:
        pred = 0
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = up
    elif ftype == 3:
        pred = (left + up) >> 1
    else:
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    rows = ((x - pred) % 256).astype(np.uint8)
    return np.concatenate([np.full((x.shape[0], 1), ftype, np.uint8), rows], 1).tobytes()


@pytest.mark.parametrize("ftype", range(5))
def test_png_unfilter_undoes_each_filter(tmp_path, rng, ftype):
    for shape, ctype in (((13, 17, 3), 2), ((9, 5), 0), ((7, 11, 4), 6), ((6, 3, 2), 4)):
        img = (rng.random(shape) * 256).astype(np.uint8)
        ihdr = struct.pack(">IIBBBBB", shape[1], shape[0], 8, ctype, 0, 0, 0)
        body = zlib.compress(_png_rows(img, ftype))
        png = b"\x89PNG\r\n\x1a\n"
        for tag, chunk in ((b"IHDR", ihdr), (b"IDAT", body), (b"IEND", b"")):
            png += struct.pack(">I", len(chunk)) + tag + chunk + struct.pack(
                ">I", zlib.crc32(tag + chunk) & 0xFFFFFFFF)
        (tmp_path / "f.png").write_bytes(png)
        np.testing.assert_array_equal(images.read_png(str(tmp_path / "f.png")), img)
        np.testing.assert_array_equal(images.read_png(str(tmp_path / "f.png")),
                                      np.asarray(Image.open(tmp_path / "f.png")))


def test_content_decides_the_decoder_not_the_extension(tmp_path, rng):
    img = _photo(rng, 12, 20)
    Image.fromarray(img).save(tmp_path / "a.png", format="JPEG")
    Image.fromarray(img).save(tmp_path / "b.jpg", format="PNG")
    np.testing.assert_array_equal(images.read_image(str(tmp_path / "a.png")),
                                  np.asarray(Image.open(tmp_path / "a.png")))
    np.testing.assert_array_equal(images.read_image(str(tmp_path / "b.jpg")), img)
    assert images.image_format(str(tmp_path / "a.png")) == "JPEG"
    assert images.image_size(str(tmp_path / "b.jpg")) == (20, 12)


def test_codec_builds_into_build_with_a_hashed_name():
    path = jpeg.kernels.build_cxx(jpeg.SRC, "imagecodec")
    assert path.parent == jpeg.kernels.BUILD_DIR and path.name.startswith("libimagecodec-")
    assert path == jpeg.kernels.cxx_library_path(jpeg.SRC, "imagecodec")


def test_codec_build_failure_raises(monkeypatch, tmp_path):
    """A source g++ rejects raises (no silent fallback), as the marching
    core's build does."""
    bad = tmp_path / "imagecodec.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(jpeg, "SRC", bad)
    monkeypatch.setattr(jpeg, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for imagecodec.cpp"):
        jpeg.read_jpeg(b"\xff\xd8\xff")
