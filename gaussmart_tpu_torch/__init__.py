"""gaussmart_tpu_torch — the PyTorch/CUDA port of gaussmart_tpu.

A second package beside the JAX one, with the same module names, public
names, dict keys and file formats, so a reader can find each counterpart.
It imports torch and numpy, never jax and nothing of gaussmart_tpu. Entry
points run on a CUDA device unless the caller asks for the CPU
(``device="cpu"`` / ``--device cpu``); they never fall back on their own.

It covers serving (``python -m gaussmart_tpu_torch.render_cli -m <model>
--skip_mesh``), training (``python -m gaussmart_tpu_torch.train -s <scene>
-m <out>``, with the DINO term) and both over D device slots
(``--n_devices D``; parallel/), mesh export, evaluation, the live
viewer, the segmentation preprocessing (``python -m
gaussmart_tpu_torch.semantics.pipeline``, ``train --run_segmentation``)
and the COLMAP convert CLI (``python -m gaussmart_tpu_torch.convert``).
Every TPU kernel of those paths is a hand-written CUDA kernel (csrc/): the
tile compositor forward and backward, their seeded variants for
Gaussian-sharded rendering, and the sorted segment sum; each has its plain
PyTorch version, which runs on CPU tensors. Photos are read and written
without Pillow or OpenCV: PNG and JPEG through io/images.py, whose host
library csrc/imagecodec.cpp (a JPEG decoder bit-equal to Pillow's, its
default JPEG encoder, the PNG row unfilter, Pillow's resampling pass) g++
builds into build/gaussmart_tpu_torch/ at first use.

Layer map:
  ops/        - SH eval, depth->normal
  io/         - PLY, PNG/JPEG/TIFF (images.py, jpeg.py), COLMAP, dataset
                readers, Gaussian snapshots
  models/     - Gaussian state (fixed capacity + active mask)
  render/     - preprocess, dense compositor, tiled compositor + kernels
  mesh/       - GaussianExtractor, TSDF fusion, marching tetrahedra
  eval/       - metrics CLI, LPIPS, Chamfer, F-score, cull
  semantics/  - DINO tower and heatmap CLI, segmentation pipeline (camera
                formats, view clustering, hull, masks, projection),
                segment-aware densification
  viewer/     - network_gui protocol, viewer CLI, a scripted client
  parallel/   - device slots: data-parallel, row- and Gaussian-sharded
  kernels.py  - nvcc build + ctypes loading of csrc/*.cu; g++ builds of
                the host libraries (build_cxx)
"""
