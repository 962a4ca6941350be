"""The viewer of the port (gaussmart_tpu_torch/viewer/) against the JAX
package's: the wire format byte for byte over loopback, render_net_image
for each render item and image_to_bytes on the same inputs; serve.view
and train._serve_gui (single-device and over 4 Gaussian-sharded slots)
answering a scripted client with frames equal to in-memory renders.

Every loopback test starts its client after the server listens and waits
for the connection with a threading.Event and a deadline."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gaussmart_tpu.viewer import protocol as jp
from gaussmart_tpu_torch import train as ttrain
from gaussmart_tpu_torch.cameras import MiniCam
from gaussmart_tpu_torch.config import ModelParams, PipelineParams
from gaussmart_tpu_torch.parallel.sharding import make_mesh, shard_state
from gaussmart_tpu_torch.optim import init_adam
from gaussmart_tpu_torch.render.api import render
from gaussmart_tpu_torch.scene import Scene
from gaussmart_tpu_torch.viewer import protocol as tp
from gaussmart_tpu_torch.viewer import serve
from gaussmart_tpu_torch.viewer.client import ViewerClient, camera_request

from test_torch_slice import ITER, _model_dir

torch.set_num_threads(1)
ITEMS = ["RGB", "Alpha", "Normal", "Depth", "Edge", "Curvature"]
DEADLINE = 30.0


def _connect(gui, requests, items):
    """A client for `requests`, connected to `gui` (listening) and accepted."""
    client = ViewerClient(gui.listener.getsockname()[1], requests)
    client.start()
    assert client.connected.wait(DEADLINE) and client.error is None, client.error
    gui.try_connect(items)
    assert gui.conn is not None
    return client


def _finish(client):
    client.join(DEADLINE)
    assert not client.is_alive() and client.error is None, client.error


def _listening(gui_cls):
    gui = gui_cls()
    gui.init("127.0.0.1", 0)
    return gui


def _request(**kw):
    req = dict(resolution_x=16, resolution_y=12, train=False, fov_y=0.8, fov_x=0.9,
               z_near=0.01, z_far=100.0, keep_alive=True, scaling_modifier=1.0,
               view_matrix=np.eye(4).reshape(-1).tolist(),
               view_projection_matrix=np.arange(16.0).tolist(), render_mode=0)
    req.update(kw)
    return req


def test_protocol_roundtrip_is_the_jax_wire_format(rng):
    """One request (and a zero-size one) answered by the port's NetworkGUI
    and by the JAX package's: the same camera (Y/Z flips undone), and the
    same bytes on the wire, render items, frame, verify string and
    metrics."""
    img = rng.uniform(-0.2, 1.2, (3, 12, 16)).astype(np.float32)
    streams = []
    for mod, to_image in ((tp, torch.tensor), (jp, np.asarray)):
        gui = _listening(mod.NetworkGUI)
        client = _connect(gui, [_request(), _request(resolution_x=0)], ["RGB", "Alpha"])
        cam, do_training, keep_alive, smod, mode = gui.receive()
        assert (cam.width, cam.height, do_training, keep_alive, smod, mode) == (
            16, 12, False, True, 1.0, 0)
        assert cam.world_view[1, 1] == -1.0 and cam.world_view[2, 2] == -1.0
        assert cam.full_proj[0, 1] == -1.0 and cam.full_proj[0, 2] == 2.0
        gui.send(mod.image_to_bytes(to_image(img)), "/tmp/scene", {"#": 42})
        assert gui.receive() == (None,) * 5
        gui.send(None, "/tmp/scene", {"#": 42})
        gui.close()
        gui.listener.close()
        _finish(client)
        assert client.items == ["RGB", "Alpha"]
        assert [f[1:] for f in client.frames] == [("/tmp/scene", {"#": 42})] * 2
        assert len(client.frames[0][0]) == 16 * 12 * 3 and client.frames[1][0] is None
        streams.append(bytes(client.raw))
    assert streams[0] == streams[1]


def _render_package(rng, h=12, w=16):
    return {"render": rng.uniform(0, 1.2, (3, h, w)).astype(np.float32),
            "rend_alpha": rng.random((1, h, w)).astype(np.float32),
            "rend_normal": rng.uniform(-1, 1, (3, h, w)).astype(np.float32),
            "surf_depth": rng.uniform(2, 5, (1, h, w)).astype(np.float32)}


@pytest.mark.parametrize("mode", range(len(ITEMS)))
def test_render_net_image_matches_jax(rng, mode):
    pkg = _render_package(rng)
    ref = np.asarray(jp.render_net_image({k: jnp.asarray(v) for k, v in pkg.items()},
                                         ITEMS, mode, None))
    got = tp.render_net_image({k: torch.tensor(v) for k, v in pkg.items()}, ITEMS, mode,
                              None)
    assert got.shape == ref.shape == (3, 12, 16)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-6)


def test_image_to_bytes_byte_equal_to_jax(rng):
    img = rng.uniform(-0.3, 1.3, (3, 12, 16)).astype(np.float32)
    img[0, 0, :4] = [0.0, 1.0, 0.5, 254.5 / 255]
    assert tp.image_to_bytes(torch.tensor(img)) == jp.image_to_bytes(img)


def _expected(state, cam, mode, bg, depth_ratio=0.0, **kw):
    with torch.no_grad():
        pkg = render(cam.params("cpu"), state, bg, depth_ratio=depth_ratio, **kw)
    return tp.image_to_bytes(tp.render_net_image(pkg, ITEMS, mode, cam))


def test_serve_view_answers_with_in_memory_renders(tmp_path):
    """serve.view(max_frames=7) on a trained-model directory: one request
    for each of the six render items at the first train camera, then a
    zero-size one; each frame equals image_to_bytes(render_net_image(...))
    of the same splats rendered in memory, the metrics count the splats."""
    model, cfg = _model_dir(str(tmp_path), n=60)
    dataset = ModelParams(model_path=model, source_path=cfg["source_path"],
                          white_background=True, sh_degree=1, eval=True)
    scene = Scene(dataset, load_iteration=ITER, shuffle=False, device="cpu")
    cam = scene.get_train_cameras()[0]
    requests = [camera_request(cam, m) for m in range(len(ITEMS))]
    requests.append(dict(requests[0], resolution_x=0))
    gui = _listening(tp.NetworkGUI)
    client = ViewerClient(gui.listener.getsockname()[1], requests)
    client.start()
    assert client.connected.wait(DEADLINE) and client.error is None
    serve.view(dataset, PipelineParams(), ITER, gui, max_frames=len(requests), device="cpu")
    gui.shutdown()
    _finish(client)
    assert client.items == ITEMS and len(client.frames) == len(requests)
    mini = MiniCam(cam.width, cam.height, cam.fovy, cam.fovx, cam.znear, cam.zfar,
                   cam.world_view, cam.full_proj)
    bg = torch.ones(3)
    for m, (image, verify, metrics) in enumerate(client.frames[:-1]):
        assert image == _expected(scene.gaussians, mini, m, bg), ITEMS[m]
        assert verify == cfg["source_path"] and metrics == {"#": 60}
    assert client.frames[-1][0] is None


@pytest.mark.parametrize("slots", [1, 4])
def test_serve_gui_in_the_training_path(tmp_path, slots):
    """train._serve_gui with a viewer that asks to train on: it answers one
    request (the Normal item) and returns. With 4 slots the state is the
    Gaussian-sharded chunks, rendered through the sharded fold (K3's plain
    version here): its frame within one level of the single-device
    render."""
    model, cfg = _model_dir(str(tmp_path), n=60)
    dataset = ModelParams(model_path=model, source_path=cfg["source_path"],
                          white_background=True, sh_degree=1, eval=True)
    scene = Scene(dataset, load_iteration=ITER, shuffle=False, device="cpu")
    state, cam = scene.gaussians, scene.get_train_cameras()[1]
    mesh = make_mesh(slots, "cpu") if slots > 1 else None
    shown = state
    if mesh is not None:
        p, _, x = shard_state(state.params, init_adam(state.params), state.aux, mesh)
        shown = [state.replace(params=a, aux=b) for a, b in zip(p, x)]
    gui = _listening(tp.NetworkGUI)
    client = _connect(gui, [camera_request(cam, 2, train=True)], ITEMS)
    ttrain._serve_gui(gui, shown, PipelineParams(), dataset, {"loss": 0.5}, iteration=10,
                      max_iters=100, mesh=mesh, device="cpu")
    gui.shutdown()
    _finish(client)
    (image, verify, metrics), = client.frames
    assert metrics == {"#": 60, "loss": 0.5} and verify == cfg["source_path"]
    mini = MiniCam(cam.width, cam.height, cam.fovy, cam.fovx, cam.znear, cam.zfar,
                   cam.world_view, cam.full_proj)
    ref = _expected(state, mini, 2, torch.ones(3))
    got = np.frombuffer(image, np.uint8).astype(int)
    diff = np.abs(got - np.frombuffer(ref, np.uint8))
    assert diff.max() <= (0 if mesh is None else 1)


def test_a_malformed_request_closes_only_the_connection():
    """A request that is not the protocol's JSON closes the connection
    (serve_frame returns (None, None)); the listener accepts the next
    viewer, whose request is answered. A failing render is not the
    client's fault: its error propagates."""
    gui = _listening(tp.NetworkGUI)
    port = gui.listener.getsockname()[1]
    bad = ViewerClient(port, [{"resolution_x": 4, "resolution_y": 2}])   # no camera
    bad.start()
    assert bad.connected.wait(DEADLINE)
    gui.try_connect(ITEMS)

    def fail_render(cam, smod):
        raise RuntimeError("render failed")
    assert tp.serve_frame(gui, fail_render, ITEMS, "v", {}) == (None, None)
    assert gui.conn is None
    bad.join(DEADLINE)
    assert isinstance(bad.error, ConnectionError)

    good = _connect(gui, [_request()], ITEMS)
    with pytest.raises(RuntimeError, match="render failed"):
        tp.serve_frame(gui, fail_render, ITEMS, "v", {})
    gui.shutdown()
    good.join(DEADLINE)
