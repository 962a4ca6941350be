"""The DINOv3 ViT-7B/16 configuration and its tower kind
(towers/dinov3-vit-gated.py): the DINO term's operations at the garden's
1296x840 against a count by hand, the parameters at the published widths
from the shapes alone, and the three DINO tower metrics on a made-up
record of the program's spans."""
import math

import pytest

from portbench import common

CONFIG = common.load_json(common.HERE / "configs" / "m360-garden-vit7b.json")
DINO = CONFIG["dino"]
KIND = common.tower(DINO)


def test_the_configuration_names_the_gated_kind_at_the_published_widths():
    assert KIND is common.module("towers", "dinov3-vit-gated")
    assert {k: DINO[k] for k in ("depth", "dim", "heads", "mlp", "patch", "registers",
                                 "image_size", "rope_theta", "ln_eps")} == dict(
        depth=40, dim=4096, heads=32, mlp=8192, patch=16, registers=4, image_size=224,
        rope_theta=100.0, ln_eps=1e-5)
    assert CONFIG["reduced"] == {}


def test_term_flops_at_the_gardens_size_is_the_hand_count():
    """One forward on 201 tokens: per block q/k/v 2*201*4096*12288, the
    output projection 2*201*4096*4096, the gate, up and down products
    3*2*201*4096*8192, attention's two products 2*2*201*201*4096; the patch
    embedding 2*196*768*4096 and the resize 2*3*840*1296*224 + 2*3*224*840*224.
    The term is two forwards and a backward to the render, which costs a
    forward again with attention's products twice."""
    blocks = 40 * (2 * 201 * 4096 * 12288 + 2 * 201 * 4096 * 4096 + 3 * 2 * 201 * 4096 * 8192)
    attention = 40 * 2 * 2 * 201 * 201 * 4096
    rest = 2 * 196 * 768 * 4096 + 2 * 3 * 840 * 1296 * 224 + 2 * 3 * 224 * 840 * 224
    forward = blocks + attention + rest
    want = 3 * forward + attention
    assert KIND.term_flops(DINO, 840, 1296) == want
    assert want / 1e12 == pytest.approx(8.21, abs=0.005)


def test_the_parameters_at_the_published_widths_are_six_point_seven_billion():
    shapes = KIND.weight_shapes(DINO)
    n = sum(math.prod(s) for s in shapes.values())
    assert n / 1e9 == pytest.approx(6.72, abs=0.005)
    assert 4 * n / 2**30 == pytest.approx(25.02, abs=0.01)
    assert shapes["blocks.39.gate_w"] == (4096, 8192) and "blocks.0.attn.qkv_b" not in shapes


def _rec(device_ms):
    return {"spans": {"device_ms": device_ms}, "dino": DINO, "height": 840, "width": 1296}


SPANS = {"step": 1.0, "losses.dino": 0.5, "losses.dino.render": 2.0,
         "losses.dino.render.attn": 30.0, "losses.dino.render.mlp": 50.0,
         "losses.dino.target": 1.0, "losses.dino.target.attn": 29.0,
         "losses.dino.target.mlp": 49.0, "backward.dino": 90.0, "render.preprocess": 15.0}


def test_the_tower_metrics_read_the_spans_by_name():
    read = {n: common.module("metrics", n).read for n in
            ("dino_attn_ms.train", "dino_mlp_ms.train", "tower_mfu.train")}
    rec = _rec(SPANS)
    assert read["dino_attn_ms.train"](rec) == 59.0
    assert read["dino_mlp_ms.train"](rec) == 99.0
    ms = 2.0 + 30.0 + 50.0 + 1.0 + 29.0 + 49.0 + 90.0
    assert read["tower_mfu.train"](rec) == pytest.approx(
        100.0 * KIND.term_flops(DINO, 840, 1296) / (ms * 1e-3) / 67e12)
    # a program without the in-tower spans (the parent's): nothing to read
    # for the branches, the share still read from the tower's three spans
    old = {k: v for k, v in SPANS.items() if not k.endswith((".attn", ".mlp"))}
    assert read["dino_attn_ms.train"](_rec(old)) is None
    assert read["dino_mlp_ms.train"](_rec(old)) is None
    assert read["tower_mfu.train"](_rec(old)) > 0
    for r in read.values():
        assert r({}) is None and r({"spans": None}) is None
