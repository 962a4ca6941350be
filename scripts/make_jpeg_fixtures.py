"""Write the JPEG fixtures of tests/torch_data/jpeg/ with Pillow and OpenCV.

    python scripts/make_jpeg_fixtures.py [--out tests/torch_data/jpeg]

Needs Pillow and cv2 (the card's machine has neither; run it where they
are installed). Nothing in gaussmart_tpu_torch imports it. It writes:

- small JPEGs covering each sampling factor (4:4:4, 4:2:2, 4:2:0, 4:4:0,
  4:1:1), progressive, a restart interval, optimized Huffman tables, grey,
  odd sizes (1x1, 7x9, 17x1031), an EXIF orientation-6 photo, an Adobe
  RGB-coded file and a 4-component CMYK file (refused by the port);
- their source PNGs (src_rgb.png, src_grey.png and the odd sizes' sources);
- nerf_800.png, a Pillow-written RGBA PNG at NeRF-synthetic size for
  read_png's timing;
- digests.json: for each JPEG and PNG, Pillow's size and the sha256 and
  shape of ``np.asarray(Image.open(f))``; for each source and quality,
  the sha256 of the file ``Image.save`` writes; for the orientation
  photo, the sha256 of ``cv2.imread``'s upright array (as RGB); for
  ``chip_smoke.textured_photo`` at 5187x3361 (made again wherever it is
  needed, so no file is committed), the sha256 of Pillow's quality-95
  file and of Pillow's decode of it.

The data are made from a fixed seed; rerunning gives the same files
for the same Pillow and OpenCV.
"""
from __future__ import annotations

import argparse
import hashlib
import io
import json
import os

import sys

import cv2
import numpy as np
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (textured_photo; imports only numpy)

QUALITIES = (10, 75, 95, 100)


def array_sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def photo(rng, h: int, w: int) -> np.ndarray:
    """A smooth colour field with edges and mild noise, uint8 [h, w, 3]."""
    y, x = np.mgrid[:h, :w].astype(np.float64)
    base = np.stack([128 + 100 * np.sin(x / 9.0 + y / 23.0),
                     128 + 90 * np.cos(y / 7.0 - x / 31.0),
                     (x * 3 + y * 5) % 256], -1)
    base[(x - w / 2) ** 2 + (y - h / 2) ** 2 < (min(h, w) / 3) ** 2] *= 0.5
    return np.clip(base + rng.normal(0, 6, base.shape), 0, 255).astype(np.uint8)


def nerf_png() -> np.ndarray:
    """An 800x800 RGBA object on a transparent background, smooth enough
    to compress well."""
    y, x = np.mgrid[:800, :800].astype(np.float64)
    r = np.hypot(x - 400, y - 410)
    rgb = np.stack([200 - r / 3, 80 + (x / 8) % 60, 120 + 100 * np.sin(y / 40)], -1)
    alpha = np.clip((300 - r) * 8, 0, 255)
    img = np.concatenate([rgb, alpha[..., None]], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def cv2_jpeg(bgr: np.ndarray, **params) -> bytes:
    flags = []
    for key, value in params.items():
        flags += [getattr(cv2, f"IMWRITE_JPEG_{key.upper()}"), value]
    ok, buf = cv2.imencode(".jpg", bgr, flags)
    assert ok
    return buf.tobytes()


def pil_jpeg(img: np.ndarray, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img).save(b, format="JPEG", **kw)
    return b.getvalue()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=os.path.join("tests", "torch_data", "jpeg"))
    args = parser.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(2024)
    rgb = photo(rng, 97, 131)
    grey = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
    bgr = rgb[..., ::-1]
    sf = {k: getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{k}")
          for k in ("444", "422", "420", "440", "411")}
    files = {f"s{k}.jpg": cv2_jpeg(bgr, quality=90, sampling_factor=v) for k, v in sf.items()}
    files["progressive.jpg"] = pil_jpeg(rgb, quality=85, progressive=True)
    files["restart.jpg"] = cv2_jpeg(bgr, quality=85, rst_interval=3)
    files["optimize.jpg"] = pil_jpeg(rgb, quality=85, optimize=True)
    files["grey.jpg"] = pil_jpeg(grey, quality=85)
    files["grey_progressive.jpg"] = cv2_jpeg(grey, quality=60, progressive=1)
    files["adobe_rgb.jpg"] = pil_jpeg(rgb, keep_rgb=True)
    exif = Image.Exif()
    exif[0x0112] = 6
    files["orient6.jpg"] = pil_jpeg(photo(rng, 40, 64), exif=exif)
    sources = {"src_rgb.png": rgb, "src_grey.png": grey}
    for h, w in ((1, 1), (9, 7), (1031, 17)):
        img = photo(rng, h, w)
        sources[f"src_{w}x{h}.png"] = img
        files[f"odd_{w}x{h}.jpg"] = pil_jpeg(img, quality=75)
    cmyk = io.BytesIO()
    Image.fromarray(rgb).convert("CMYK").save(cmyk, format="JPEG")
    files["cmyk.jpg"] = cmyk.getvalue()

    digests = {"decoded": {}, "encoded": {}, "cv2_upright": {}}
    for name, data in sorted(files.items()):
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(data)
        with Image.open(io.BytesIO(data)) as im:
            entry = {"size": list(im.size)}
            if im.mode in ("L", "RGB"):
                a = np.asarray(im)
                entry.update(shape=list(a.shape), sha256=array_sha256(a))
        digests["decoded"][name] = entry
    up = cv2.imread(os.path.join(args.out, "orient6.jpg"))[..., ::-1]
    digests["cv2_upright"]["orient6.jpg"] = {"shape": list(up.shape),
                                             "sha256": array_sha256(up)}
    Image.fromarray(nerf_png()).save(os.path.join(args.out, "nerf_800.png"))
    for name, img in sorted(sources.items()):
        Image.fromarray(img).save(os.path.join(args.out, name))
    for name in sorted(sources) + ["nerf_800.png"]:
        with Image.open(os.path.join(args.out, name)) as im:
            a = np.asarray(im)
            digests["decoded"][name] = {"size": list(im.size), "shape": list(a.shape),
                                        "sha256": array_sha256(a)}
    for name, img in sorted(sources.items()):
        digests["encoded"][name] = {str(q): hashlib.sha256(pil_jpeg(img, quality=q)).hexdigest()
                                    for q in QUALITIES}
    h, w, q = chip_smoke.JPEG_HEIGHT, chip_smoke.JPEG_WIDTH, chip_smoke.JPEG_TEXTURED_QUALITY
    data = pil_jpeg(chip_smoke.textured_photo(h, w), quality=q)
    with Image.open(io.BytesIO(data)) as im:
        decoded = array_sha256(np.asarray(im))
    digests["textured"] = {"size": [w, h], "quality": q, "decoded": decoded,
                           "encoded": hashlib.sha256(data).hexdigest()}
    with open(os.path.join(args.out, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(args.out, n)) for n in os.listdir(args.out))
    print(f"wrote {len(os.listdir(args.out))} files, {total} bytes, into {args.out}")


if __name__ == "__main__":
    main()
