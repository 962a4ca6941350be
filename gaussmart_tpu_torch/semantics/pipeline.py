"""Segmentation preprocessing pipeline CLI (the port's counterpart of
gaussmart_tpu/semantics/pipeline.py).

`python -m gaussmart_tpu_torch.semantics.pipeline -s <scan> -o <out> -t {dtu,nerf,tyt}
[--device cpu] [--seed N]`

Stage + artifact parity with reference identification/main.py:25-209:
  1. select representative views (clustering over camera poses);
  2. mask generation per selected view (SAM / precomputed / classical);
  3. optional convex-hull cleaning of the point cloud;
  4. project 3D points into mask views, first-view-wins segment labels,
     max-merged mask areas;
  5. save segments/{images,masks,point_cloud,embeddings,cameras} with
     segmented_point_cloud.ply + segment_indices.npy + mask_areas.npy —
     the exact artifact contract consumed by the dataset reader
     (dataset_readers.py:115-146).

The hull distances, the projection and the classical segmenter's colour
k-means run on --device (cuda unless asked otherwise; without CUDA it
raises); qhull, camera clustering and connected components on the host.
--seed seeds the colour k-means of every image.
"""
from __future__ import annotations

import argparse
import os
import shutil
from typing import Dict, List, Tuple

import numpy as np

from gaussmart_tpu_torch.io.ply import fetch_point_cloud, write_ply
from gaussmart_tpu_torch.runtime import resolve_device, setup
from gaussmart_tpu_torch.semantics.camera_formats import CameraAnalysis
from gaussmart_tpu_torch.semantics.clustering import (ViewSelector, list_image_files,
                                                      map_camera_to_image_index,
                                                      resolve_image_path)
from gaussmart_tpu_torch.semantics.hull import filter_point_cloud
from gaussmart_tpu_torch.semantics.projection import project_segments
from gaussmart_tpu_torch.semantics.sam_backend import make_segmenter, save_masks_npz


class Pipeline:
    def __init__(self, scan_path: str, output_path: str, dataset_type: str,
                 cluster_cameras: bool = True, sam2: bool = False,
                 mask_backend: str = "auto", mask_dir: str = "",
                 project_z_cull: bool = False, device="cuda", seed: int = 0):
        self.scan_path = scan_path
        self.output_path = output_path
        self.dataset_type = dataset_type.lower()
        self.cluster_cameras = cluster_cameras
        self.sam2 = sam2
        self.mask_backend = mask_backend
        self.mask_dir = mask_dir
        self.project_z_cull = project_z_cull
        self.device = device
        self.seed = seed
        self.dirs = self._setup_directories()

    def _setup_directories(self) -> Dict[str, str]:
        base = os.path.join(self.output_path, "segments")
        dirs = {name: os.path.join(base, name)
                for name in ("images", "masks", "point_cloud", "embeddings",
                             "cameras")}
        dirs["base"] = base
        if os.path.exists(base):
            shutil.rmtree(base)
        for d in dirs.values():
            os.makedirs(d, exist_ok=True)
        return dirs

    def _get_paths(self) -> Tuple[str, str]:
        if self.dataset_type == "dtu":
            return (os.path.join(self.scan_path, "points.ply"),
                    os.path.join(self.scan_path, "cameras.npz"))
        return (os.path.join(self.scan_path, "sparse/0/points3D.ply"),
                os.path.join(self.scan_path, "poses_bounds.npy"))

    def select_views(self):
        _, camera_path = self._get_paths()
        images_dir = os.path.join(self.scan_path, "images")
        analyzer = CameraAnalysis(camera_path, images_dir)
        if self.cluster_cameras:
            selector = ViewSelector(analyzer)
            selected = selector.select()["selected_indices"]
        else:
            selected = list(range(len(analyzer.views)))
        print(f"Selected camera indices: {selected}")

        # image paths use the (possibly //2-mapped) image indices; a camera
        # whose image is missing is DROPPED from the selection so that
        # image_paths, the masks computed from them, and cameras_dict stay
        # position-aligned (keeping the camera would shift every later
        # view's masks onto the wrong projection matrices)
        image_files = list_image_files(images_dir)
        image_paths: List[str] = []
        kept: List[int] = []
        for idx in selected:
            img_idx = map_camera_to_image_index(idx, self.dataset_type)
            p = resolve_image_path(images_dir, img_idx, image_files,
                                   self.dataset_type)
            if p is not None:
                kept.append(idx)
                image_paths.append(p)
            else:
                print(f"Warning: image for camera {idx} not found; "
                      f"dropping the view")
        selected = kept

        # camera_NNN keys are POSITIONS in the kept selection (the same
        # order as image_paths/masks); selected_indices records the
        # original camera indices
        cameras_dict = {f"camera_{i:03d}": analyzer.views[idx]
                        for i, idx in enumerate(selected)}
        np.savez(os.path.join(self.dirs["cameras"], "selected_cameras.npz"),
                 selected_indices=np.asarray(selected, np.int64),
                 **{k: v["world_mat"] for k, v in cameras_dict.items()})
        return selected, image_paths, cameras_dict

    def run_segmentation(self, image_paths: List[str]):
        from pathlib import Path

        ckpt = os.path.join(Path(__file__).resolve().parent, "weights",
                            "sam_vit_h_4b8939.pth")
        segmenter = make_segmenter(self.mask_backend, ckpt, sam2=self.sam2,
                                   mask_dir=self.mask_dir, device=self.device,
                                   seed=self.seed)
        all_masks = []
        for i, image_path in enumerate(image_paths):
            shutil.copy2(image_path, os.path.join(
                self.dirs["images"], os.path.basename(image_path)))
            masks = segmenter.process_image(image_path)
            save_masks_npz(masks, os.path.join(self.dirs["masks"],
                                               f"segments_{i:03d}.npz"))
            all_masks.append(masks)
        return all_masks

    def load_point_cloud(self, clean: bool = True):
        pc_path, _ = self._get_paths()
        if not os.path.exists(pc_path):
            print(f"Warning: Point cloud not found at {pc_path}")
            return None
        pts, cols, normals = fetch_point_cloud(pc_path)
        if clean:
            print("Applying hull removal filtering...")
            pts, cols, normals, _ = filter_point_cloud(pts, cols, normals,
                                                       device=self.device)
        self._save_pcd(os.path.join(self.dirs["point_cloud"], "raw_pc.ply"),
                       pts, cols, normals)
        return pts, cols, normals

    @staticmethod
    def _save_pcd(path, pts, cols, normals):
        write_ply(path, {
            "x": pts[:, 0].astype(np.float32),
            "y": pts[:, 1].astype(np.float32),
            "z": pts[:, 2].astype(np.float32),
            "nx": normals[:, 0].astype(np.float32),
            "ny": normals[:, 1].astype(np.float32),
            "nz": normals[:, 2].astype(np.float32),
            "red": np.clip(cols[:, 0] * 255, 0, 255).astype(np.uint8),
            "green": np.clip(cols[:, 1] * 255, 0, 255).astype(np.uint8),
            "blue": np.clip(cols[:, 2] * 255, 0, 255).astype(np.uint8),
        })

    def save_results(self, pts, cols, normals, segment_indices, mask_areas):
        self._save_pcd(os.path.join(self.dirs["point_cloud"],
                                    "segmented_point_cloud.ply"),
                       pts, cols, normals)
        np.save(os.path.join(self.dirs["point_cloud"], "segment_indices.npy"),
                segment_indices)
        np.save(os.path.join(self.dirs["point_cloud"], "mask_areas.npy"),
                np.asarray(mask_areas, dtype=object))

    def run(self, clean_pc: bool = True):
        print("1. Selecting optimal views...")
        selected, image_paths, cameras_dict = self.select_views()
        print("2. Running segmentation...")
        all_masks = self.run_segmentation(image_paths)
        print("3. Loading point cloud...")
        pcd = self.load_point_cloud(clean=clean_pc)
        if pcd is None:
            return None, None
        pts, cols, normals = pcd
        print("4. Projecting segments to 3D...")
        segment_indices, mask_areas = project_segments(
            pts, all_masks, cameras_dict, self.dataset_type,
            z_cull=self.project_z_cull, device=self.device)
        print("5. Saving results...")
        self.save_results(pts, cols, normals, segment_indices, mask_areas)
        return segment_indices, mask_areas


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="3D point-cloud segmentation pipeline")
    parser.add_argument("-s", "--scan_path", required=True)
    parser.add_argument("-o", "--output_path", required=True)
    parser.add_argument("-t", "--type", choices=["dtu", "nerf", "tyt"],
                        required=True)
    parser.add_argument("--skip_camera_clustering", action="store_true")
    parser.add_argument("--sam2", action="store_true")
    parser.add_argument("--clean", action="store_true")
    parser.add_argument("--mask_backend", default="auto",
                        choices=["auto", "sam", "precomputed", "classical"])
    parser.add_argument("--mask_dir", default="")
    parser.add_argument("--project_z_cull", action="store_true",
                        help="depth-test the segment projection (opt-in; "
                        "reference parity is occlusion-blind — "
                        "pc_projection.py:111-135)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the hull, projection and colour k-means "
                        "run (cuda unless asked otherwise)")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the classical segmenter's colour k-means")
    args = parser.parse_args(argv)
    setup()
    device = resolve_device(args.device)

    pipeline = Pipeline(args.scan_path, args.output_path, args.type,
                        cluster_cameras=not args.skip_camera_clustering,
                        sam2=args.sam2, mask_backend=args.mask_backend,
                        mask_dir=args.mask_dir,
                        project_z_cull=args.project_z_cull, device=device,
                        seed=args.seed)
    return pipeline.run(clean_pc=args.clean)


if __name__ == "__main__":
    main()
