"""DINO CLS-patch similarity heatmap CLI (counterpart of
gaussmart_tpu/semantics/visualize.py):
``python -m gaussmart_tpu_torch.semantics.visualize -i <image> -o
<out.png|out.jpg> [--alpha --random_encoder --device]``.

The card's machine has neither OpenCV nor Pillow: images are read and
written by io/images.py (PNG and JPEG in, PNG or JPEG out by the output's
extension as Pillow chooses; the JAX CLI reads any format Pillow reads),
the upsample of the heatmap is io/images.py's copy of
cv2.resize(INTER_LINEAR), equal to it to the bit, and the colour map is
OpenCV's turbo table, round(trajectory.TURBO * 255).
"""
from __future__ import annotations

from argparse import ArgumentParser

import numpy as np
import torch

from gaussmart_tpu_torch.io.images import read_image, resize_linear_u8, write_image
from gaussmart_tpu_torch.runtime import resolve_device, setup
from gaussmart_tpu_torch.semantics.dino import DinoEncoder
from gaussmart_tpu_torch.trajectory import TURBO

# cv2.applyColorMap(..., COLORMAP_TURBO) as RGB rows, one per uint8 level
TURBO_U8 = np.round(TURBO * 255).astype(np.uint8)


@torch.no_grad()
def cls_patch_heatmap(encoder: DinoEncoder, image: np.ndarray) -> np.ndarray:
    """CLS-token vs patch-token cosine similarity map in [0,1].

    encoder: DinoEncoder (on any device); image: [3,H,W] float in [0,1].
    Returns [g,g] heatmap (g = image_size/patch).
    """
    # one forward-pass definition: the same encoder.tokens the loss uses
    x = encoder.tokens(torch.as_tensor(image, dtype=torch.float32, device=encoder.device))
    g = encoder.image_size // encoder.patch
    cls_t = x[0] / torch.linalg.norm(x[0])
    # patch tokens start after the prefix (CLS [+ DINOv3 register tokens])
    pats = x[encoder.n_prefix:]
    patches = pats / torch.linalg.norm(pats, dim=-1, keepdim=True)
    sim = patches @ cls_t
    sim = (sim - sim.min()) / torch.clamp_min(sim.max() - sim.min(), 1e-9)
    return sim.reshape(g, g).cpu().numpy()


def overlay_heatmap(image: np.ndarray, heat: np.ndarray,
                    alpha: float = 0.5) -> np.ndarray:
    """Blend a turbo-coloured heatmap over an [H,W,3] image in [0,1]."""
    h, w = image.shape[:2]
    heat_img = resize_linear_u8((heat * 255).astype(np.uint8), w, h)
    heat_rgb = TURBO_U8[heat_img] / 255.0
    return (1 - alpha) * image + alpha * heat_rgb


def read_rgb(path: str) -> np.ndarray:
    """A PNG or JPEG as [H,W,3] float32 in [0,1], converted to RGB as
    Pillow's convert("RGB") does (grey repeated, alpha dropped)."""
    img = read_image(path)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    elif img.shape[2] == 2:
        img = np.repeat(img[..., :1], 3, axis=2)
    return img[..., :3].astype(np.float32) / 255.0


def main(argv=None):
    setup()
    parser = ArgumentParser(description="DINO heatmap visualization")
    parser.add_argument("-i", "--image", required=True)
    parser.add_argument("-o", "--output", required=True)
    parser.add_argument("--alpha", type=float, default=0.5)
    parser.add_argument("--random_encoder", action="store_true",
                        help="use a random-weight encoder (no checkpoint)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where to run the encoder (cuda unless asked otherwise)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    if args.random_encoder:
        enc = DinoEncoder.random(depth=2, dim=192, image_size=224, device=device)
    else:
        enc = DinoEncoder.create(device=device)

    rgb = read_rgb(args.image)
    heat = cls_patch_heatmap(enc, rgb.transpose(2, 0, 1))
    out = overlay_heatmap(rgb, heat, args.alpha)
    write_image(args.output, np.clip(out * 255, 0, 255).astype(np.uint8))
    print(f"saved {args.output}")


if __name__ == "__main__":
    main()
