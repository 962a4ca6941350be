"""Write tests/torch_data/video/digests.json: the sha256 of the port's
mp4v file of each integer-only video fixture.

    python scripts/make_video_digests.py [--out tests/torch_data/video]

The fixtures are ``chip_smoke.video_fixture`` clips (a window sliding
across ``chip_smoke.textured_photo``, integer arithmetic only), made again
wherever they are needed, so no video is committed. The digests are of the
build of ``gaussmart_tpu_torch/csrc/imagecodec.cpp`` where it runs; run it
only after ``tests/test_torch_video.py::test_port_video_against_jax`` has
passed on the fixtures, so that each digest is of a file cv2 decoded
within the test's floors. ``chip_smoke.py`` and the tests hold every other
build to them.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CASES = ((24, 76, 100), (6, 584, 776))   # (frames, height, width)
FPS = 30


def main(argv=None):
    import chip_smoke
    from gaussmart_tpu_torch.io import video
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=chip_smoke.VIDEO_DATA)
    args = ap.parse_args(argv)
    cases = [{"frames": n, "height": h, "width": w,
              "sha256": hashlib.sha256(video.video_bytes(
                  chip_smoke.video_fixture(n, h, w), FPS)).hexdigest()}
             for n, h, w in CASES]
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "digests.json"), "w") as f:
        json.dump({"fps": FPS, "cases": cases}, f, indent=1)
        f.write("\n")
    for c in cases:
        print(c)


if __name__ == "__main__":
    main()
