"""The yardstick's arithmetic on hand-worked cases: bounds, the DINO term's
operations, a step's operations and its MFU, blends of one surfel, the
trace's busy time, launches and labelled idle gaps, and the frozen
operation counts recounted from the reference's expressions."""
import math

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from portbench import common, counts, trace
from portbench.reference import raster
from portbench.reference import train as ref_train
from portbench.reference.raster import camera_matrices


def test_kernel_bounds_take_the_larger_of_operations_and_bytes():
    work = {"blends": 10**9, "visible": 10**5}
    ops_s = 89e9 / 67e12
    assert counts.k1_bound_s(work, 10**6) == pytest.approx(ops_s)
    # bytes bind when there are few blends: 4 * (18 * 1e5 + 10 * 1e6) bytes
    few = {"blends": 10, "visible": 10**5}
    assert counts.k1_bound_s(few, 10**6) == pytest.approx(4 * (18e5 + 10e6) / 3.35e12)
    assert counts.k2_bound_s(few, 10**6) == pytest.approx(4 * (36e5 + 8e6) / 3.35e12)
    assert counts.k2_bound_s(work, 10**6) == pytest.approx(249e9 / 67e12)


def test_dino_term_flops_at_the_published_widths():
    # ViT-B/16 at 224 on a 776x584 render: 111.437 GFLOP, as chip_smoke.fixed_term_flops counts it
    dino = dict(image_size=224, patch=16, depth=12, dim=768, mlp=3072, registers=4)
    assert counts.dino_term_flops(dino, 584, 776) == pytest.approx(111.437e9, rel=1e-5)


def test_step_flops_and_mfu_add_their_three_parts():
    dino = dict(image_size=224, patch=16, depth=12, dim=768, mlp=3072, registers=4)
    work = {"blends": 2 * 10**6, "visible": 5 * 10**4}
    want = (89 + 249) * 2e6 + counts.dino_term_flops(dino, 584, 776) \
        + 10**5 * (494 + 1388 + 17 * 58)
    assert counts.step_flops(work, dino, 584, 776, 10**5, 58) == pytest.approx(want)
    rec = dict(work=[work, work], dino=dino, height=584, width=776, active=10**5,
               params_per_splat=58, steps=100, window_s=10.0)
    mfu = common.module("metrics", "step_mfu.train").read(rec)
    assert mfu == pytest.approx(100 * want / 0.1 / 67e12)


def test_blends_of_one_surfel_fill_its_alpha_ellipse():
    """A square-on surfel of scale s at depth z under focal f: alpha =
    0.5 exp(-rho/2) >= 1/255 inside rho <= 2 ln(127.5), a disc of radius
    sqrt(2 ln 127.5) s f / z pixels."""
    W = H = 96
    fov = 2 * math.atan(0.5)                      # f = W
    cam = camera_matrices(torch.eye(3).numpy(), [0.0, 0.0, 0.0], fov, fov, W, H, "cpu")
    z, s = 4.0, 4.0 / 96 * 5                      # s f / z = 5 px
    params = {"xyz": torch.tensor([[0.0, 0.0, z]]), "scaling": torch.full((1, 2), math.log(s)),
              "rotation": torch.tensor([[1.0, 0.0, 0.0, 0.0]]),
              "opacity": torch.zeros((1, 1)), "features_dc": torch.zeros((1, 1, 3)),
              "features_rest": torch.zeros((1, 15, 3))}
    work = counts.frame_work(params, torch.ones(1, dtype=torch.bool), cam)
    radius = math.sqrt(2 * math.log(127.5)) * 5
    assert work["visible"] == 1
    assert work["blends"] == pytest.approx(math.pi * radius ** 2, rel=0.05)


def test_trace_summary_unions_device_time_and_labels_gaps():
    device = [("raster_bwd_kernel", 10, 30), ("elementwise", 20, 40), ("Memcpy DtoH", 60, 70),
              ("raster_fwd_kernel", 90, 100)]
    host = [("aten::nonzero", 38, 65), ("cudaStreamSynchronize", 45, 58),
            ("aten::add", 75, 80)]
    out = trace.summarise(0, 100, device, host)
    assert out["busy_s"] == pytest.approx(50e-6)
    assert out["window_s"] == pytest.approx(100e-6)
    assert out["kernels"] == 3
    assert dict(out["gaps"]) == pytest.approx({"host (no traced op)": 10e-6,
                                               "cudaStreamSynchronize": 20e-6,
                                               "aten::add": 20e-6})
    assert trace.kernel_seconds(out, "raster_bwd") == pytest.approx(20e-6)


# what the operation counter counts: one per element of an arithmetic, test
# or select, one per element read of a reduction, 2 per multiply-add of a
# matrix product; data movement and allocation are free
ELEMENTWISE = {"abs", "add", "sub", "mul", "div", "neg", "rsub", "exp", "log", "sqrt",
               "reciprocal", "pow", "sigmoid", "sigmoid_backward", "clamp", "clamp_min",
               "clamp_max", "maximum", "minimum", "ceil", "floor", "relu", "where", "masked_fill",
               "eq", "ne", "gt", "ge", "lt", "le", "bitwise_and", "bitwise_or", "bitwise_not",
               "logical_and", "logical_or", "logical_not"}
REDUCTIONS = {"sum", "prod", "any", "argmax", "max", "cumsum", "cumprod", "mean"}
MATMULS = {"mm", "bmm"}
FREE = {"_to_copy", "cat", "clone", "detach", "expand", "gather", "ones_like", "scalar_tensor",
        "scatter", "select", "select_backward", "slice", "slice_backward", "squeeze",
        "unsqueeze", "zeros", "zeros_like", "full_like", "lift_fresh", "ones", "stack", "t",
        "unbind", "view", "_unsafe_view", "flip", "full", "empty", "arange", "alias", "index",
        "permute", "transpose", "split", "copy", "randn", "rand"}


class OpCount(TorchDispatchMode):
    """The operations of the aten calls made under it (an unknown call
    raises, so that a new kind of call is classified before it counts)."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if name in ELEMENTWISE:
            self.ops += out.numel()
        elif name in REDUCTIONS:
            self.ops += args[0].numel()
        elif name in MATMULS:
            self.ops += 2 * args[0].numel() * args[1].shape[-1]
        elif name not in FREE:
            raise KeyError(f"unclassified aten call {name}")
        return out


def test_the_counter_counts_a_hand_worked_expression():
    a, b = torch.rand(4, 5), torch.rand(5, 3)
    with OpCount() as c:
        x = torch.where(a > 0.5, a * 2.0 + 1.0, 0.0).sum(dim=1)      # 4 x 20 + 20
        y = torch.cat([a, a]) @ b                                       # free + 2 x 8 x 5 x 3
    assert c.ops == 100 + 240 and x.shape == (4,) and y.shape == (8, 3)


def _walk_ops(K, B=2):
    """(forward, backward) operations of one call of the reference's walk
    over B tiles of K entries each."""
    gen = torch.Generator().manual_seed(0)
    g = {"T": torch.randn(B, K, 9, generator=gen),
         "center": torch.rand(B, K, 2, generator=gen) * 16,
         "opacity": torch.rand(B, K, generator=gen), "color": torch.rand(B, K, 3, generator=gen),
         "normal": torch.randn(B, K, 3, generator=gen)}
    g = {k: v.requires_grad_() for k, v in g.items()}
    valid = torch.ones(B, K, dtype=torch.bool)
    px, py = raster._pixels(torch.arange(B), 4, "cpu")
    carry = raster._init_carry(B, "cpu")
    with OpCount() as fwd:
        out = raster._walk(carry, g, valid, px, py)
        planes = torch.cat([out["color"], out["depth"][:, None], out["alpha"][:, None],
                            out["normal"]], 1)
    with OpCount() as bwd:
        torch.autograd.grad(planes, [g[k] for k in raster.FIELDS], torch.ones_like(planes))
    return fwd.ops, bwd.ops


def test_ops_per_blend_are_the_reference_walks():
    """The operations an entry adds to a tile's walk, per pixel: what the
    walk costs at 32 entries less what it costs at 16 (the pixels' own
    work cancels). The backward's 59 per (tile, entry) are left out."""
    (f16, b16), (f32, b32) = _walk_ops(16), _walk_ops(32)
    pairs = 2 * 16 * raster.PIX
    assert f32 - f16 == counts.FWD_OPS_PER_BLEND * pairs
    assert b32 - b16 == (counts.BWD_OPS_PER_BLEND - counts.FWD_OPS_PER_BLEND) * pairs \
        + 59 * 2 * 16


def _per_splat_ops(N):
    """(preprocess forward, its backward, Adam) operations on N splats."""
    gen = torch.Generator().manual_seed(1)
    shapes = dict(xyz=(N, 3), features_dc=(N, 1, 3), features_rest=(N, 15, 3), scaling=(N, 2),
                  rotation=(N, 4), opacity=(N, 1))
    p = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    p["xyz"] = p["xyz"] + torch.tensor([0.0, 0.0, 4.0])
    p = {k: v.requires_grad_() for k, v in p.items()}
    active = torch.ones(N, dtype=torch.bool)
    cam = camera_matrices(torch.eye(3).numpy(), [0.0, 0.0, 0.0], 1.0, 0.8, 64, 48, "cpu")
    with OpCount() as fwd:
        act = raster.activated(p, active)
        prep = raster.preprocess(act["xyz"], act["scales"], act["quats"], act["opacity"],
                                 act["shs"], active, cam)
        outs = [prep[k] for k in ("T", "center", "depth", "normal", "color", "opacity")]
    with OpCount() as bwd:
        torch.autograd.grad(outs, [p[g] for g in ref_train.GROUPS],
                            [torch.ones_like(x) for x in outs])
    raw = {k: v.detach() for k, v in p.items()}
    state = ref_train.init_adam(raw)
    with torch.no_grad(), OpCount() as adam:
        ref_train.adam_step(raw, {k: torch.ones_like(v) for k, v in raw.items()}, state, active,
                            ref_train.learning_rates(15001, 1.0))
    return fwd.ops, bwd.ops, adam.ops


def test_ops_per_splat_are_the_reference_preprocess_and_adam():
    (f10, b10, a10), (f20, b20, a20) = _per_splat_ops(10), _per_splat_ops(20)
    assert f20 - f10 == 10 * counts.PREP_FWD_OPS_PER_SPLAT
    assert b20 - b10 == 10 * counts.PREP_BWD_OPS_PER_SPLAT
    assert a20 - a10 == 10 * 58 * counts.ADAM_OPS_PER_PARAM
