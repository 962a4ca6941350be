"""Tower kinds (portbench/towers/): the configurations' tower, `dinov3-vit`,
draws the weights the harness drew before kinds existed and counts the
same operations, its npz and encoder agree with the system's encoder, and
the kind a configuration names is the one that the scene, the npz writer,
the reference's steps and the operation counts call."""
import math
import types

import numpy as np
import pytest
import torch

from portbench import check, common, counts, scene as scenes
from portbench.tests.helpers import tiny_cell

TINY = dict(depth=2, dim=192, heads=3, mlp=768, patch=16, registers=4, image_size=64,
            rope_theta=100.0, ln_eps=1e-5)


def _old_dino_weights(dino, seed, device):
    """scene.dino_weights and reference/dino.weight_shapes as they were
    before tower kinds: a 4 x dim MLP, stream 5, two draws."""
    dim = dino["dim"]
    shapes = {"patch_w": (3 * dino["patch"] ** 2, dim), "patch_b": (dim,), "cls_token": (dim,),
              "register_tokens": (dino["registers"], dim), "norm_g": (dim,), "norm_b": (dim,)}
    for i in range(dino["depth"]):
        p = f"blocks.{i}"
        shapes.update({
            f"{p}.norm1_g": (dim,), f"{p}.norm1_b": (dim,),
            f"{p}.norm2_g": (dim,), f"{p}.norm2_b": (dim,),
            f"{p}.attn.qkv_w": (dim, 3 * dim), f"{p}.attn.qkv_b": (3 * dim,),
            f"{p}.attn.proj_w": (dim, dim), f"{p}.attn.proj_b": (dim,),
            f"{p}.ls1": (dim,), f"{p}.ls2": (dim,),
            f"{p}.fc1_w": (dim, 4 * dim), f"{p}.fc1_b": (4 * dim,),
            f"{p}.fc2_w": (4 * dim, dim), f"{p}.fc2_b": (dim,)})
    normal_keys = [k for k in shapes if k.endswith("_w") or k in ("cls_token", "register_tokens")]
    ls_keys = [k for k in shapes if k.endswith(".ls1") or k.endswith(".ls2")]
    gen = scenes.generator(seed, 5, device)
    sizes = [math.prod(shapes[k]) for k in normal_keys]
    flat = torch.randn(sum(sizes), generator=gen, device=device) * 0.02
    ls = 0.5 + torch.rand((len(ls_keys), dim), generator=gen, device=device)
    w = {k: t.reshape(shapes[k]) for k, t in zip(normal_keys, torch.split(flat, sizes))}
    w.update({k: ls[i] for i, k in enumerate(ls_keys)})
    for k, s in shapes.items():
        if k not in w:
            w[k] = torch.full(s, 1.0 if k.endswith("_g") else 0.0, dtype=torch.float32,
                              device=device)
    return w


def _old_term_flops(dino, height, width):
    """counts.dino_term_flops as it was before tower kinds (MLP 4 x dim)."""
    S, p, L, D = dino["image_size"], dino["patch"], dino["depth"], dino["dim"]
    N = 1 + dino["registers"] + (S // p) ** 2
    resize = 2 * 3 * height * width * S + 2 * 3 * S * height * S
    dense = 2 * (S // p) ** 2 * 3 * p * p * D + L * (2 * N * D * 3 * D + 2 * N * D * D
                                                      + 2 * 2 * N * D * 4 * D)
    attention = L * 2 * 2 * N * N * D
    return 2 * (resize + dense + attention) + resize + dense + 2 * attention


def _configs():
    return [common.load_json(common.ROOT / c["file"]) for c in common.spec()["configs"]]


def test_every_configuration_names_the_default_tower():
    for cfg in _configs():
        assert "kind" not in cfg["dino"]
        assert common.tower(cfg["dino"]) is common.module("towers", "dinov3-vit")


@pytest.mark.parametrize("seed", [7, 2**31 + 11])
def test_the_dinov3_vit_draw_is_bit_equal_to_the_old_draw(seed):
    old, new = _old_dino_weights(TINY, seed, "cpu"), scenes.dino_weights(TINY, seed, "cpu")
    assert list(new) == list(old)
    for k in old:
        assert new[k].shape == old[k].shape and torch.equal(new[k], old[k]), k


@pytest.mark.parametrize("config,height,width,gflop", [("dtu-scan24", 600, 800, 111.6),
                                                       ("m360-garden", 840, 1296, 114.2)])
def test_term_flops_at_the_cells_widths_are_the_old_count(config, height, width, gflop):
    dino = common.load_json(common.HERE / "configs" / f"{config}.json")["dino"]
    ops = counts.dino_term_flops(dino, height, width)
    assert ops == _old_term_flops(dino, height, width)
    assert ops / 1e9 == pytest.approx(gflop, abs=0.05)


def test_the_kind_through_its_npz_matches_the_system_encoder(tmp_path):
    """The configurations' tower, drawn and written as a training run does,
    read by the system's encoder as its loader reads an npz, against the
    kind's reference encoder on the same image."""
    from gaussmart_tpu_torch.semantics.dino import DinoEncoder
    w = scenes.dino_weights(TINY, 5, "cpu")
    path = tmp_path / "tower.npz"
    scenes.write_dino_npz(w, TINY, str(path))
    with np.load(path) as z:
        params = {k: z[k] for k in z.files}
    assert sorted(params) == sorted(list(w) + list(common.tower(TINY).npz_meta(TINY)))
    enc = DinoEncoder(params, patch=int(params["meta_patch"]), n_heads=int(params["meta_n_heads"]),
                      image_size=int(params["meta_image_size"]))
    tower = common.tower(TINY).Tower(w, TINY)
    image = torch.rand((3, 48, 72), generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(tower.embed(image), enc(image), rtol=1e-4, atol=1e-5)


def test_the_kind_a_configuration_names_is_the_one_called(monkeypatch, tmp_path):
    real = common.module("towers", "dinov3-vit")
    calls = []

    def logged(name):
        def f(*a, **k):
            calls.append(name)
            return getattr(real, name)(*a, **k)
        return f
    fake = types.SimpleNamespace(**{n: logged(n) for n in ("draw", "npz_meta", "Tower",
                                                          "term_flops")})
    module = common.module
    monkeypatch.setattr(common, "module", lambda kind, name: fake if (kind, name) == (
        "towers", "fake") else module(kind, name))
    _, _, cfg, traffic = tiny_cell("dtu-scan24.train-dino")
    dino = dict(cfg["dino"], kind="fake")

    w = scenes.dino_weights(dino, 3, "cpu")
    assert calls == ["draw"]
    scenes.write_dino_npz(w, dino, str(tmp_path / "t.npz"))
    assert calls[-1] == "npz_meta"
    counts.dino_term_flops(dino, 48, 64)
    assert calls[-1] == "term_flops"

    sc = scenes.build(cfg, 3, "cpu")
    cam = scenes.camera(sc.cams[0], sc.width, sc.height, "cpu")
    gt = scenes.targets(1, sc.width, sc.height, 3, "cpu")
    out = check.reference_steps(sc.params, sc.active, [cam], gt, [15001], sc.spatial_lr_scale,
                                tower_weights=w, dino=dino,
                                lambda_dino=traffic["lambda_dino"])
    assert "Tower" in calls and out["losses"][0]["dino"] > 0
