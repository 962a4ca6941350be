"""Segmentation mask generation backends (the port's counterpart of
gaussmart_tpu/semantics/sam_backend.py).

The reference wraps SAM ViT-H / SAM2 automatic mask generation
(identification/sam.py: points_per_side 32, iou .86, stability .92, 1024px
cap) and stores masks as `segments_{i:03d}.npz{masks, boxes, areas}`. This
module keeps that artifact contract with three backends, picked by
availability:

  1. `sam` / `sam2` — the real models, when the packages + checkpoints
     exist locally (gated, as in the JAX package), on the pipeline's
     device.
  2. `precomputed` — load reference-format npz masks from a directory,
     so masks generated elsewhere interoperate.
  3. `classical` — colour quantisation + connected components, so the
     full pipeline runs end to end anywhere. It produces the same
     mask-dict schema SAM does.

No OpenCV: images are 8-bit PNGs read by io/images.py and resized by its
bit-exact copy of cv2.resize(INTER_LINEAR); the colour k-means is
semantics/kmeans.py's copy of cv2.kmeans (k-means++) on the device, drawn
from a CPU generator seeded per image; components are scipy's 8-connected
labels numbered as cv2.connectedComponents numbers them.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch
from scipy import ndimage

from gaussmart_tpu_torch.io.images import read_image, resize_linear_u8
from gaussmart_tpu_torch.semantics.kmeans import quantize_colors

MAX_IMAGE_SIZE = 1024


def _load_image_rgb(image_path: str, max_size: int = MAX_IMAGE_SIZE) -> np.ndarray:
    """uint8 [h, w, 3] RGB as cv2.imread + the 1024-px cap + BGR->RGB give
    it (turned upright by its EXIF orientation, grey repeated, alpha
    dropped)."""
    img = read_image(image_path, exif_orientation=True)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    elif img.shape[2] == 2:
        img = np.repeat(img[..., :1], 3, axis=2)
    img = np.ascontiguousarray(img[..., :3])
    h, w = img.shape[:2]
    if max(h, w) > max_size:
        s = max_size / max(h, w)
        img = resize_linear_u8(img, int(w * s), int(h * s))
    return img


def sam_available() -> bool:
    try:
        import segment_anything  # noqa: F401
        return True
    except ImportError:
        return False


def connected_components(binary: np.ndarray):
    """(count including the background, int32 labels) of the 8-connected
    components of a [h, w] mask, numbered as cv2.connectedComponents does:
    by each component's first 2x2 pixel block in raster order (one block
    never holds two components)."""
    lab, n = ndimage.label(binary, structure=np.ones((3, 3), int))
    if n == 0:
        return 1, lab.astype(np.int32)
    ys, xs = np.nonzero(lab)
    first = np.full(n + 1, np.iinfo(np.int64).max)
    np.minimum.at(first, lab[ys, xs], (ys // 2).astype(np.int64) * binary.shape[1] + xs // 2)
    remap = np.zeros(n + 1, np.int32)
    remap[1 + np.argsort(first[1:], kind="stable")] = np.arange(1, n + 1, dtype=np.int32)
    return n + 1, remap[lab]


class ClassicalSegmenter:
    """Colour-quantised connected-component segmentation.

    Not a SAM replacement in quality, but a deterministic, dependency-free
    stand-in producing the same mask schema, so the densification pipeline
    stays exercisable. The k-means runs on `device`, seeded by `seed` for
    each image.
    """

    def __init__(self, n_colors: int = 8, min_area_frac: float = 0.001,
                 max_masks: int = 64, device="cuda", seed: int = 0):
        self.n_colors = n_colors
        self.min_area_frac = min_area_frac
        self.max_masks = max_masks
        self.device = torch.device(device)
        self.seed = seed

    def labels(self, rgb: np.ndarray) -> np.ndarray:
        """[h, w] int32 colour-cluster labels of a uint8 RGB image."""
        pixels = torch.as_tensor(rgb.reshape(-1, 3), device=self.device)
        gen = torch.Generator().manual_seed(self.seed)
        labels, _ = quantize_colors(pixels, self.n_colors, gen)
        return labels.reshape(rgb.shape[:2]).to(torch.int32).cpu().numpy()

    def process_image(self, image_path: str) -> List[Dict]:
        return self.masks_from_labels(self.labels(_load_image_rgb(image_path)))

    def masks_from_labels(self, label_img: np.ndarray) -> List[Dict]:
        """The masks of each colour's components of at least min_area_frac
        of the image, largest first (a stable sort: colour, then component
        number), at most max_masks."""
        h, w = label_img.shape
        min_area = self.min_area_frac * h * w
        found = []                          # (area, component map, number)
        for c in range(self.n_colors):
            n, comp = connected_components(label_img == c)
            areas = np.bincount(comp.ravel(), minlength=n)
            boxes = ndimage.find_objects(comp)
            for k in range(1, n):
                if areas[k] >= min_area:
                    found.append((int(areas[k]), comp, k, boxes[k - 1]))
        found.sort(key=lambda f: -f[0])
        masks = []
        for area, comp, k, (ys, xs) in found[:self.max_masks]:
            masks.append({"segmentation": comp == k,
                          "bbox": [xs.start, ys.start, xs.stop - xs.start,
                                   ys.stop - ys.start],
                          "area": area,
                          "predicted_iou": 1.0,
                          "stability_score": 1.0})
        return masks


class SamSegmenter:
    """Real SAM/SAM2 wrapper (gated on local availability), on the
    pipeline's device: it never moves to the CPU on its own."""

    def __init__(self, checkpoint_path: str, sam2: bool = False, device="cuda"):
        from segment_anything import SamAutomaticMaskGenerator, sam_model_registry

        if sam2:
            from sam2.automatic_mask_generator import SAM2AutomaticMaskGenerator
            from sam2.sam2_image_predictor import SAM2ImagePredictor
            predictor = SAM2ImagePredictor.from_pretrained(
                "facebook/sam2-hiera-large", device=str(device))
            self.generator = SAM2AutomaticMaskGenerator(
                predictor.model, points_per_side=32, pred_iou_thresh=0.86,
                stability_score_thresh=0.92)
        else:
            sam = sam_model_registry["vit_h"](checkpoint=checkpoint_path)
            sam.to(device=device)
            self.generator = SamAutomaticMaskGenerator(
                sam, points_per_side=32, pred_iou_thresh=0.86,
                stability_score_thresh=0.92)

    def process_image(self, image_path: str) -> List[Dict]:
        return self.generator.generate(_load_image_rgb(image_path))


class PrecomputedMasks:
    """Load reference-format masks npz from a directory."""

    def __init__(self, mask_dir: str):
        self.mask_dir = mask_dir
        self._i = 0

    def process_image(self, image_path: str) -> List[Dict]:
        masks = load_masks_npz(os.path.join(
            self.mask_dir, f"segments_{self._i:03d}.npz"))
        self._i += 1
        return masks


def make_segmenter(backend: str = "auto", checkpoint_path: str = "",
                   sam2: bool = False, mask_dir: str = "", device="cuda",
                   seed: int = 0):
    if backend == "auto":
        if mask_dir and os.path.isdir(mask_dir):
            backend = "precomputed"
        elif sam_available() and os.path.exists(checkpoint_path):
            backend = "sam"
        else:
            backend = "classical"
            print("[sam] segment_anything / checkpoint unavailable; using "
                  "built-in classical segmenter")
    if backend == "sam":
        return SamSegmenter(checkpoint_path, sam2=sam2, device=device)
    if backend == "precomputed":
        return PrecomputedMasks(mask_dir)
    return ClassicalSegmenter(device=device, seed=seed)


def save_masks_npz(masks: List[Dict], output_path: str):
    """Artifact parity with identification/sam.py:118-133."""
    binary, boxes, areas = [], [], []
    for m in masks:
        binary.append(m["segmentation"])
        x, y, w, h = m["bbox"]
        boxes.append([x, y, x + w, y + h])
        areas.append(m["area"])
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    np.savez(output_path, masks=np.array(binary), boxes=np.array(boxes),
             areas=np.array(areas))


def load_masks_npz(path: str) -> List[Dict]:
    with np.load(path) as z:
        masks = z["masks"]
        boxes = z["boxes"]
        areas = z["areas"]
    out = []
    for i in range(len(masks)):
        x0, y0, x1, y1 = boxes[i]
        out.append({"segmentation": masks[i].astype(bool),
                    "bbox": [int(x0), int(y0), int(x1 - x0), int(y1 - y0)],
                    "area": int(areas[i])})
    return out
