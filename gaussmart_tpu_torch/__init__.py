"""gaussmart_tpu_torch — the PyTorch/CUDA port of gaussmart_tpu.

A second package beside the JAX one, with the same module names, public
names, dict keys and file formats, so a reader can find each counterpart.
It imports torch and numpy, never jax and nothing of gaussmart_tpu. Entry
points run on a CUDA device unless the caller asks for the CPU
(``device="cpu"`` / ``--device cpu``); they never fall back on their own.

This slice covers serving: loading a trained model and rendering it
(``python -m gaussmart_tpu_torch.render_cli -m <model> --skip_mesh``). The
one TPU kernel on that path, the forward tile compositor, is a hand-written
CUDA kernel (csrc/raster_fwd.cu); its plain PyTorch version runs on CPU
tensors.

Layer map:
  ops/        - SH eval, depth->normal
  io/         - PLY, PNG/TIFF, COLMAP, dataset readers, Gaussian snapshots
  models/     - Gaussian state (fixed capacity + active mask)
  render/     - preprocess, dense compositor, tiled compositor + kernel
  mesh/       - GaussianExtractor (render every view, export images)
  kernels.py  - nvcc build + ctypes loading of csrc/*.cu
"""
