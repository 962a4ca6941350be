"""Live-viewer CLI — ``python -m gaussmart_tpu_torch.viewer.serve -m <model>
[--ip --port --iteration --device]`` (counterpart of
gaussmart_tpu/viewer/serve.py).

Loads the trained model (the saved training config merged under the
command line, as the render CLI does) and serves a connected SIBR viewer
over the network_gui protocol: each request is one render of the model
(K1 on the card; binning never truncates, so there is no duplicate
budget to set). Runs on cuda unless ``--device cpu``.
"""
from __future__ import annotations

import itertools
import time
from argparse import ArgumentParser
from typing import Optional

import torch

from gaussmart_tpu_torch.config import (ModelParams, PipelineParams, add_group_args,
                                        extract_group, get_combined_args)
from gaussmart_tpu_torch.logging_utils import span
from gaussmart_tpu_torch.parallel.sharding import sharded_render_backend
from gaussmart_tpu_torch.render.api import render
from gaussmart_tpu_torch.runtime import resolve_device, setup
from gaussmart_tpu_torch.scene import Scene
from gaussmart_tpu_torch.viewer.protocol import NetworkGUI, serve_frame


def frame_renderer(state, pipe: PipelineParams, white_background: bool, device,
                   mesh=None):
    """``frame(cam, scaling_modifier)``: the render package of a viewer
    camera, for protocol.serve_frame. `state` is one GaussianState or,
    with `mesh`, the per-slot chunks of a Gaussian-sharded state, rendered
    through the sharded fold. Each call is the root span ``frame`` (id: the
    renderer's request count), holding ``frame.render``; the request's
    ``frame.net_image`` and ``frame.to_host`` follow it under its id."""
    backend = pipe.backend if mesh is None else sharded_render_backend(pipe.backend)
    bg = torch.tensor([1.0, 1.0, 1.0] if white_background else [0.0, 0.0, 0.0],
                      dtype=torch.float32, device=device)
    requests = itertools.count()

    @torch.inference_mode()
    def frame(cam, scaling_modifier):
        with span("frame", id=next(requests)), span("frame.render"):
            return render(cam.params(device), state, bg, scaling_modifier=scaling_modifier,
                          depth_ratio=pipe.depth_ratio, backend=backend, mesh=mesh)
    return frame


def view(dataset: ModelParams, pipe: PipelineParams, iteration: int,
         gui: NetworkGUI, max_frames: Optional[int] = None, device="cuda"):
    """Serve frames of the model at `iteration` (-1: the latest) until
    `max_frames` requests were answered (forever when None)."""
    device = resolve_device(device)
    scene = Scene(dataset, load_iteration=iteration, shuffle=False, device=device)
    state = scene.gaussians
    frame = frame_renderer(state, pipe, dataset.white_background, device)
    metrics = {"#": int(state.n_active)}
    served = 0
    while max_frames is None or served < max_frames:
        if gui.conn is None:
            gui.try_connect(dataset.render_items)
            if gui.conn is None:
                time.sleep(0.05)   # don't busy-spin while nobody connects
                continue
        serve_frame(gui, frame, dataset.render_items, dataset.source_path, metrics)
        served += 1


def main(argv=None):
    setup()
    parser = ArgumentParser(description="gaussmart_tpu_torch live viewer")
    # sentinel=True: unset flags parse as None so get_combined_args restores
    # them from the model's saved cfg_args.json (as the render CLI does)
    add_group_args(parser, ModelParams, sentinel=True)
    add_group_args(parser, PipelineParams, sentinel=True)
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where to render (cuda unless asked otherwise)")
    parser.add_argument("--max_frames", type=int, default=None,
                        help="stop after answering this many requests")
    args = get_combined_args(parser, argv)
    device = resolve_device(args.device)
    print("View: " + args.model_path)
    gui = NetworkGUI()
    gui.init(args.ip, args.port)
    try:
        view(extract_group(args, ModelParams), extract_group(args, PipelineParams),
             args.iteration, gui, max_frames=args.max_frames, device=device)
    finally:
        gui.shutdown()
    print("\nViewing complete.")


if __name__ == "__main__":
    main()
