"""A scripted viewer client over the network_gui wire format (the SIBR
viewer's side of viewer/protocol.py), for driving a viewer server without
the SIBR application: it connects, reads the render items, sends camera
requests one by one and keeps each answer.

    client = ViewerClient(port, [camera_request(cam, mode) for mode in ...])
    client.start()                       # after the server's listener is up
    client.connected.wait(timeout)       # then serve; client.join(timeout)
"""
from __future__ import annotations

import json
import socket
import struct
import threading
import time
from typing import List, Optional, Tuple

import numpy as np


def camera_request(cam, render_mode: int, train: bool = False, keep_alive: bool = True,
                   scaling_modifier: float = 1.0) -> dict:
    """The request a SIBR viewer sends to see `cam` (a cameras.Camera or
    MiniCam) in `render_mode`: its view matrix with the Y and Z columns
    negated and its view-projection matrix with the Y column negated, which
    NetworkGUI.receive undoes."""
    wv = np.array(cam.world_view, np.float32)
    wv[:, 1] = -wv[:, 1]
    wv[:, 2] = -wv[:, 2]
    fp = np.array(cam.full_proj, np.float32)
    fp[:, 1] = -fp[:, 1]
    return dict(resolution_x=int(cam.width), resolution_y=int(cam.height), train=train,
                fov_y=float(cam.fovy), fov_x=float(cam.fovx), z_near=float(cam.znear),
                z_far=float(cam.zfar), keep_alive=keep_alive,
                scaling_modifier=scaling_modifier,
                view_matrix=wv.reshape(-1).tolist(),
                view_projection_matrix=fp.reshape(-1).tolist(), render_mode=render_mode)


class ViewerClient(threading.Thread):
    """Sends `requests` in order to the server at `port` and records, for
    each, (RGB bytes or None, verify string, metrics dict) in `frames` and
    the seconds from its send to the end of its answer in `seconds`;
    `raw` holds every byte received. `connected` is set once the
    connection is up (or the attempt failed: then `error` says why). The
    connection is closed after the last answer."""

    def __init__(self, port: int, requests: List[dict], host: str = "127.0.0.1",
                 timeout: float = 120.0):
        super().__init__(daemon=True)
        self.host, self.port, self.timeout = host, port, timeout
        self.requests = requests
        self.connected = threading.Event()
        self.items = None
        self.frames: List[Tuple[Optional[bytes], str, dict]] = []
        self.seconds: List[float] = []
        self.raw = bytearray()
        self.error: Optional[Exception] = None

    def _read(self, sock: socket.socket, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed the connection")
            buf += chunk
        self.raw += buf
        return buf

    def _json(self, sock: socket.socket):
        return json.loads(self._read(sock, struct.unpack("I", self._read(sock, 4))[0]))

    def run(self):
        try:
            with socket.create_connection((self.host, self.port),
                                          timeout=self.timeout) as sock:
                self.connected.set()
                self.items = self._json(sock)
                for req in self.requests:
                    t0 = time.perf_counter()
                    payload = json.dumps(req).encode("utf-8")
                    sock.sendall(len(payload).to_bytes(4, "little") + payload)
                    n = req["resolution_x"] * req["resolution_y"] * 3
                    image = self._read(sock, n) if n else None
                    verify = self._read(sock, int.from_bytes(self._read(sock, 4), "little"))
                    metrics = self._json(sock)
                    self.seconds.append(time.perf_counter() - t0)
                    self.frames.append((image, verify.decode("ascii"), metrics))
        except (OSError, ValueError) as e:
            self.error = e
        finally:
            self.connected.set()
