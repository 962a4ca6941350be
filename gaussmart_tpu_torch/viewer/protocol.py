"""SIBR remote-viewer socket protocol (counterpart of
gaussmart_tpu/viewer/protocol.py; the wire format is the same, byte for
byte).

A non-blocking TCP listener; on connect the server sends the render-items
JSON; inbound messages are a 4-byte little-endian length + JSON holding
the custom camera (view matrix with its Y/Z columns flipped); outbound: raw
RGB bytes, then a 4-byte little-endian length + the source-path string,
then the length-prefixed metrics JSON.
"""
from __future__ import annotations

import json
import socket
import struct
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from gaussmart_tpu_torch.cameras import MiniCam
from gaussmart_tpu_torch.logging_utils import is_tracing, span
from gaussmart_tpu_torch.ops.image import gradient_map

# what a vanished or misbehaving client raises while its request is read:
# socket errors, malformed JSON, missing or mistyped fields
CLIENT_ERRORS = (OSError, ValueError, LookupError, TypeError)


class NetworkGUI:
    def __init__(self):
        self.host = "127.0.0.1"
        self.port = 6009
        self.conn: Optional[socket.socket] = None
        self.addr = None
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)

    def init(self, host: str, port: int):
        self.host, self.port = host, port
        self.listener.bind((host, port))
        self.listener.listen()
        # timeout 0: accept() returns at once, so the train loop never waits
        self.listener.settimeout(0)

    def send_json(self, data):
        payload = json.dumps(data).encode("utf-8")
        self.conn.sendall(struct.pack("I", len(payload)))
        self.conn.sendall(payload)

    def try_connect(self, render_items):
        """Accept a waiting viewer, if there is one, and send it the render
        items."""
        try:
            self.conn, self.addr = self.listener.accept()
        except BlockingIOError:
            return
        self.conn.settimeout(None)
        try:
            self.send_json(render_items)
        except OSError:
            self.close()

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            buf += chunk
        return buf

    def read(self) -> dict:
        n = int.from_bytes(self._read_exact(4), "little")
        return json.loads(self._read_exact(n).decode("utf-8"))

    def send(self, image_bytes: Optional[bytes], verify: str, metrics: dict):
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(bytes(verify, "ascii"))
        self.send_json(metrics)

    def receive(self) -> Tuple[Optional[MiniCam], bool, bool, float, int]:
        msg = self.read()
        width = msg["resolution_x"]
        height = msg["resolution_y"]
        if width == 0 or height == 0:
            return None, None, None, None, None
        do_training = bool(msg["train"])
        keep_alive = bool(msg["keep_alive"])
        scaling_modifier = msg["scaling_modifier"]
        wv = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
        wv[:, 1] = -wv[:, 1]
        wv[:, 2] = -wv[:, 2]
        fp = np.array(msg["view_projection_matrix"], np.float32).reshape(4, 4)
        fp[:, 1] = -fp[:, 1]
        cam = MiniCam(width, height, msg["fov_y"], msg["fov_x"],
                      msg["z_near"], msg["z_far"], wv, fp)
        return cam, do_training, keep_alive, scaling_modifier, msg["render_mode"]

    def close(self):
        if self.conn is not None:
            self.conn.close()
            self.conn = None

    def shutdown(self):
        """Close the connection and the listener."""
        self.close()
        self.listener.close()


def render_net_image(render_pkg, render_items, render_mode, camera):
    """Mode-selected viewer image [3,H,W]: RGB, Alpha, Normal, Depth, Edge
    or Curvature; a one-channel map is min-max normalised to grey."""
    output = render_items[render_mode].lower()
    with span("frame.net_image"):
        if output == "alpha":
            net_image = render_pkg["rend_alpha"]
        elif output == "normal":
            net_image = (render_pkg["rend_normal"] + 1) / 2
        elif output == "depth":
            net_image = render_pkg["surf_depth"]
        elif output == "edge":
            net_image = gradient_map(render_pkg["render"])
        elif output == "curvature":
            net_image = gradient_map((render_pkg["rend_normal"] + 1) / 2)
        else:
            net_image = render_pkg["render"]
        if net_image.shape[0] == 1:
            lo, hi = net_image.min(), net_image.max()
            norm = (net_image - lo) / torch.clamp_min(hi - lo, 1e-9)
            net_image = torch.cat([norm] * 3, dim=0)
    return net_image


def image_to_bytes(net_image: torch.Tensor) -> bytes:
    """[3,H,W] in [0,1] -> H*W*3 RGB bytes: clipped, scaled by 255 and
    truncated on the image's device, moved to the host once as uint8.
    While tracing, the wait for the device before the copy is its own span
    (frame.to_host.sync)."""
    arr = (torch.clamp(net_image.detach(), 0, 1.0) * 255).to(torch.uint8)
    with span("frame.to_host"):
        arr = arr.permute(1, 2, 0).contiguous()
        if is_tracing() and arr.is_cuda:
            with span("frame.to_host.sync"):
                torch.cuda.current_stream(arr.device).synchronize()
        return arr.cpu().numpy().tobytes()


def serve_frame(gui: NetworkGUI, render: Callable, render_items, verify: str,
                metrics: dict):
    """Answer one request of the connected viewer: read its camera, render
    it with `render(cam, scaling_modifier)` (a render package), send the
    frame of its render mode with `metrics`. Returns (do_training,
    keep_alive) of the request. A client error (a socket error, a malformed
    request) closes the connection and returns (None, None); an error of
    the render itself propagates."""
    try:
        cam, do_training, keep_alive, smod, mode = gui.receive()
        if cam is not None:
            render_items[mode]          # an unknown render mode is the client's error
    except CLIENT_ERRORS as e:
        return _drop(gui, e)
    net_image_bytes = None
    if cam is not None:
        pkg = render(cam, smod)
        net_image_bytes = image_to_bytes(render_net_image(pkg, render_items, mode, cam))
    try:
        gui.send(net_image_bytes, verify, metrics)
    except OSError as e:
        return _drop(gui, e)
    return do_training, keep_alive


def _drop(gui: NetworkGUI, error: Exception):
    print(f"[viewer] connection closed ({type(error).__name__}: {error})")
    gui.close()
    return None, None
