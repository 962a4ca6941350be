"""The port's tracer (gaussmart_tpu_torch/logging_utils.py) on the CPU: with
tracing off a train step and a served frame record no span and no
device-valued counter, and give the same tensors and bytes, to the bit, as
with tracing on; with it on, the step's span tree (names, parents, one id
a step, the tower's backward and the rasterizer's under the step); the
`gm/` annotations in a CPU torch.profiler trace; the binning's pair
counters against its own counts; the launch counters and --profile_dir's
files."""
import json

import numpy as np
import pytest
import torch

from gaussmart_tpu_torch import logging_utils as lu
from gaussmart_tpu_torch import train as ttrain
from gaussmart_tpu_torch.cameras import Camera, MiniCam
from gaussmart_tpu_torch.config import OptimizationParams, PipelineParams
from gaussmart_tpu_torch.models import gaussians as tg
from gaussmart_tpu_torch.ops.sh import rgb2sh
from gaussmart_tpu_torch.optim import init_adam
from gaussmart_tpu_torch.render import raster_tiled as rt
from gaussmart_tpu_torch.render.raster_common import preprocess
from gaussmart_tpu_torch.semantics import dino as tdino
from gaussmart_tpu_torch.train_lib import make_train_step
from gaussmart_tpu_torch.viewer import protocol, serve

torch.set_num_threads(1)
ITERATION = 6          # past the DINO gate, inside the densify window
SIZE = 24
ITEMS = ["RGB", "Alpha", "Normal", "Depth", "Edge", "Curvature"]


@pytest.fixture(autouse=True)
def tracing_off():
    """Each test starts and ends with tracing off and nothing recorded."""
    lu.tracing(False)
    lu.collect()
    yield
    lu.tracing(False)
    lu.collect()


@pytest.fixture(scope="module")
def setup():
    """30 splats, a 24x24 camera and photo, and the tiled step with the
    DINO term on a small random tower (gate at 5)."""
    rng = np.random.default_rng(4)
    n = 30
    pts = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.8, 0.8, n),
                    rng.uniform(2.5, 4.0, n)], axis=1).astype(np.float32)
    state = tg.init_from_pcd(pts, rng.random((n, 3)).astype(np.float32), None,
                             max_sh_degree=1, spatial_lr_scale=1.0, capacity=48, seed=2,
                             device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(tdino.WEIGHT_ENV, "random")
        dino_fn = ttrain._build_dino_fn(0.05, 5, "fixed", "cpu")
    step = make_train_step(OptimizationParams(), sh_degree=1, white_background=False,
                           backend="auto", dino_fn=dino_fn)
    gt = torch.tensor(rng.random((3, SIZE, SIZE)).astype(np.float32))
    return state, step, _camera(), gt


def _camera():
    return Camera(uid=0, colmap_id=0, image_name="c", R=np.eye(3), T=np.zeros(3),
                  fovx=0.9, fovy=0.9, width=SIZE, height=SIZE)


def _step(setup):
    state, step, cam, gt = setup
    return step(state.params, init_adam(state.params), state.aux, cam.params("cpu"), gt,
                ITERATION)


def _frames(state, modes=(0, 2, 3)):
    """Bytes of served frames, one a render mode, through the renderer the
    viewer and the benchmark use."""
    frame = serve.frame_renderer(state, PipelineParams(), False, "cpu")
    p = _camera().params("cpu")
    cam = MiniCam(SIZE, SIZE, 0.9, 0.9, 0.01, 100.0, p.world_view.numpy(), p.full_proj.numpy())
    return [protocol.image_to_bytes(protocol.render_net_image(frame(cam, 1.0), ITEMS, m, cam))
            for m in modes]


def _leaves(out):
    """Every tensor of a step's outputs, in order."""
    params, adam, aux, metrics, it = out
    got = [getattr(params, n) for n in vars(params)]
    got += [getattr(adam.mu, n) for n in vars(adam.mu)] + [getattr(adam.nu, n) for n in vars(adam.nu)]
    got += [getattr(aux, n) for n in vars(aux)] + list(metrics)
    return got, it


def test_tracing_off_records_nothing_and_on_gives_the_same_bits(setup):
    off, it_off = _leaves(_step(setup))
    frames_off = _frames(setup[0])
    spans, counters = lu.collect()
    assert spans == []
    assert "render.live_pairs" not in counters         # no device-valued counter
    assert counters["render.rect_pairs"] > 0            # a host int is counted always
    lu.tracing(True)
    on, it_on = _leaves(_step(setup))
    frames_on = _frames(setup[0])
    lu.tracing(False)
    spans, counters = lu.collect()
    assert spans and "render.live_pairs" in counters
    assert it_off == it_on == ITERATION + 1 and len(off) == len(on)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    assert frames_off == frames_on
    # a span while tracing is off is the shared no-op
    assert lu.span("step", id=1) is lu.span("render.binning")


def test_a_train_step_gives_the_span_tree(setup):
    lu.tracing(True)
    _step(setup)
    lu.tracing(False)
    spans, _ = lu.collect()
    names = [s.name for s in spans]
    want = {"step", "render.preprocess", "render.binning", "render.binning.sync",
            "render.composite", "render.decode", "losses.photometric",
            "losses.regularization", "losses.dino", "losses.dino.render",
            "losses.dino.target", "backward", "backward.dino", "backward.raster",
            "update.stats", "update.adam"}
    # each tower block's two branches, named under the span that called the tower
    tower = {f"losses.dino.{call}.{branch}" for call in ("render", "target")
             for branch in ("attn", "mlp")}
    assert set(names) == want | tower
    assert names.count("step") == 1 and names[-1] == "step"
    assert all(s.id == ITERATION for s in spans)
    parent = {s.name: s.parent for s in spans}
    assert parent["step"] is None
    assert parent["render.binning.sync"] == "render.binning"
    assert parent["losses.dino.render"] == parent["losses.dino.target"] == "losses.dino"
    for name in tower:
        assert parent[name] == name.rsplit(".", 1)[0], name
    for name in ("render.preprocess", "render.binning", "render.composite", "render.decode",
                 "losses.photometric", "losses.regularization", "losses.dino", "backward",
                 "update.stats", "update.adam"):
        assert parent[name] == "step", name
    # the backward's spans run on autograd's thread on a card (parent: the
    # step, the open root) and on the calling thread here (parent: backward)
    by = {s.name: s for s in spans}
    for name in ("backward.dino", "backward.raster"):
        assert parent[name] in ("backward", "step"), name
        assert by["backward"].start_ns <= by[name].start_ns <= by[name].end_ns \
            <= by["backward"].end_ns
    # the tower's backward runs before the rasterizer's, each span inside its root
    assert by["backward.dino"].end_ns <= by["backward.raster"].start_ns
    for s in spans:
        assert by["step"].start_ns <= s.start_ns <= s.end_ns <= by["step"].end_ns


def test_served_frames_give_their_spans_one_id_a_request(setup):
    lu.tracing(True)
    _frames(setup[0], modes=(0, 3))
    lu.tracing(False)
    spans, _ = lu.collect()
    got = [(s.name, s.parent, s.id) for s in spans if s.name.startswith("frame")]
    assert got == [("frame.render", "frame", 0), ("frame", None, 0),
                   ("frame.net_image", None, 0), ("frame.to_host", None, 0),
                   ("frame.render", "frame", 1), ("frame", None, 1),
                   ("frame.net_image", None, 1), ("frame.to_host", None, 1)]


def test_spans_are_annotations_of_a_cpu_profiler_trace(setup, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    lu.tracing(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _frames(setup[0], modes=(0,))
    lu.tracing(False)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    events = json.load(open(tmp_path / "t.json"))["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"gm/frame", "gm/frame.render", "gm/render.preprocess", "gm/render.binning",
            "gm/render.binning.sync", "gm/render.composite", "gm/render.decode",
            "gm/frame.net_image", "gm/frame.to_host"} <= names


def test_the_pair_counters_are_the_binnings_counts():
    rng = np.random.default_rng(1)
    n, width, height = 80, 70, 45
    cam = Camera(uid=0, colmap_id=0, image_name="t", R=np.eye(3), T=np.zeros(3),
                 fovx=0.8, fovy=0.8 * height / width, width=width, height=height)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32))
    xyz = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(2, 4, n)], 1)
    prep = preprocess(t(xyz), t(0.05 * rng.uniform(0.5, 1.5, (n, 2))), t(rng.normal(size=(n, 4))),
                      t(rng.uniform(0.05, 0.99, n)), t(rgb2sh(rng.random((n, 1, 3)))),
                      torch.ones(n, dtype=torch.bool), cam.params("cpu"), sh_degree=0)
    tx, ty = rt.tile_grid(width, height)
    lu.tracing(True)
    b1 = rt.binning(prep, tx, ty)
    b2 = rt.binning(prep, tx, ty)
    lu.tracing(False)
    _, counters = lu.collect()
    rect = int(b1.entry_ids.shape[0])                    # the buffer: one slot a rect pair
    live = int(b1.slot_starts[-1])                       # the pairs past the row cull
    assert 0 < live < rect
    assert live == int((b1.entry_ids < n).sum()) == int(b1.tile_ranges[-1, 1])
    assert counters == {"render.rect_pairs": 2 * rect, "render.live_pairs": 2 * live}
    assert torch.equal(b1.entry_ids, b2.entry_ids)


def test_counters_add_host_ints_and_hold_device_tensors():
    lu.count("raster_fwd", 1)
    lu.count("raster_fwd", 2)
    lu.count("held", torch.tensor(5))                    # tracing off: dropped
    assert lu.counter("raster_fwd") == 3 and lu.counter("held") == 0
    lu.tracing(True)
    lu.count("held", torch.tensor(5, dtype=torch.int32))
    lu.count("held", torch.tensor(7, dtype=torch.int32))
    assert lu.counter("held") == 12
    assert lu.collect()[1] == {"held": 12, "raster_fwd": 3}
    assert lu.collect() == ([], {})


def test_profile_dir_traces_with_the_stage_spans(setup, tmp_path):
    with lu.profile_trace(str(tmp_path)):
        assert lu.is_tracing()
        _frames(setup[0], modes=(0,))
    assert not lu.is_tracing()
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    assert any(e.get("name") == "gm/frame.to_host" for e in events)
    counters = json.load(open(tmp_path / "counters.json"))
    assert counters["render.live_pairs"] <= counters["render.rect_pairs"]
