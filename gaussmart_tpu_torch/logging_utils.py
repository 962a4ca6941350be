"""Observability (counterpart of gaussmart_tpu/logging_utils.py):
TensorBoard scalars and images, and a profiler trace around a training
run (``--profile_dir``), here torch.profiler's Chrome trace."""
from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Optional


class TensorBoardLogger:
    """Thin optional wrapper over torch.utils.tensorboard."""

    def __init__(self, logdir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
            self.writer = SummaryWriter(logdir)
        except Exception as e:  # tensorboard not installed
            print(f"Tensorboard not available: not logging progress ({e})")
            self.writer = None

    def scalar(self, tag: str, value: float, step: int):
        if self.writer is not None:
            self.writer.add_scalar(tag, value, step)

    def image(self, tag: str, img, step: int):
        """img: [C,H,W] float in [0,1] (numpy)."""
        if self.writer is not None:
            import numpy as np
            self.writer.add_image(tag, np.clip(np.asarray(img), 0, 1), step)

    def close(self):
        if self.writer is not None:
            self.writer.close()


@contextmanager
def profile_trace(logdir: Optional[str]):
    """Record a torch.profiler trace (host, and the card where there is
    one) and write it to `logdir`/trace.json (chrome://tracing)."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
