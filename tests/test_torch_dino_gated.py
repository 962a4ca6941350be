"""The port's DINO tower with DINOv3's gated SiLU block (ViT-7B/16's
layout, at a tiny width) on the CPU: drawn by the benchmark's tower kind,
written as the benchmark writes its npz and read by DinoEncoder.create()
against the kind's plain-PyTorch tower and DINO term; the converter on a
random-init transformers DINOv3ViTModel with use_gated_mlp; the one-copy
load against the load it replaced; and the spans inside the tower."""
import tracemalloc

import numpy as np
import pytest
import torch

from gaussmart_tpu_torch import logging_utils as lu
from gaussmart_tpu_torch.losses import dino_term
from gaussmart_tpu_torch.semantics import dino as td
from portbench import common, scene
from portbench.reference import dino as ref_dino

torch.set_num_threads(1)
TINY = dict(kind="dinov3-vit-gated", depth=2, dim=192, heads=3, mlp=512, patch=16, registers=4,
            image_size=64, rope_theta=100.0, ln_eps=1e-5)
KIND = common.tower(TINY)
# the towers: float32 products summed in another order (addmm against a
# product and an add, packed against split q/k/v), as in test_torch_dino.py
TOL = dict(atol=1e-5, rtol=1e-4)
# the term's gradient on the image, against its own norm: the same sums
# carried through the backward of two towers and the two resize products
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def tracing_off():
    lu.tracing(False)
    lu.collect()
    yield
    lu.tracing(False)
    lu.collect()


def _written(tmp_path, seed):
    """The kind's weights for `seed` and the system's encoder of their npz,
    loaded as training loads it."""
    w = KIND.draw(TINY, seed, "cpu")
    path = tmp_path / f"gated_{seed}.npz"
    scene.write_dino_npz(w, TINY, str(path))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(td.WEIGHT_ENV, str(path))
        enc = td.DinoEncoder.create()
    return w, enc


@pytest.mark.parametrize("seed", [3, 2**31 + 17])
def test_the_gated_tower_through_its_npz_matches_the_plain_tower(tmp_path, seed):
    w, enc = _written(tmp_path, seed)
    assert enc.is_v3 and enc.n_layers == 2 and enc.n_prefix == 5
    assert "blocks.0.gate_w" in enc.params and "blocks.0.attn.qkv_b" not in enc.params
    assert not any(k.endswith(("fc1_w", "fc2_w")) for k in enc.params)
    ref = KIND.Tower(w, TINY)
    gen = torch.Generator().manual_seed(seed % 1000)
    image, gt = torch.rand((3, 48, 72), generator=gen), torch.rand((3, 48, 72), generator=gen)
    with torch.no_grad():
        torch.testing.assert_close(enc(image), ref.embed(image), **TOL)

    x, xr = image.clone().requires_grad_(True), image.clone().requires_grad_(True)
    term = dino_term(x, gt, enc, 0.05, mode="fixed")
    want = ref_dino.dino_term(ref, xr, gt, 0.05)
    term.backward()
    want.backward()
    torch.testing.assert_close(term, want, **TOL)
    assert xr.grad.norm() > 0
    assert (x.grad - xr.grad).norm() <= GRAD_TOL * xr.grad.norm()


def test_the_converter_writes_the_kinds_layout_for_a_gated_dinov3(tmp_path, rng):
    from transformers import DINOv3ViTConfig, DINOv3ViTModel
    torch.manual_seed(0)
    cfg = DINOv3ViTConfig(image_size=64, patch_size=16, hidden_size=192, num_attention_heads=3,
                          intermediate_size=512, num_hidden_layers=2, num_register_tokens=4,
                          rope_theta=100.0, layerscale_value=1.0, use_gated_mlp=True,
                          hidden_act="silu", query_bias=False, key_bias=False, value_bias=False)
    model = DINOv3ViTModel(cfg).eval()
    with torch.no_grad():          # LayerScale and biases that matter
        for layer in model.layer:
            layer.layer_scale1.lambda1.uniform_(0.5, 1.5)
            layer.layer_scale2.lambda1.uniform_(0.5, 1.5)
            for proj in (layer.mlp.gate_proj, layer.mlp.up_proj, layer.mlp.down_proj,
                         layer.attention.o_proj):
                proj.bias.normal_(0.0, 0.02)
    model.save_pretrained(tmp_path / "hf")
    npz = td.convert_hf_dino(str(tmp_path / "hf"), str(tmp_path / "gated.npz"))
    with np.load(npz) as z:
        shapes = {k: z[k].shape for k in z.files}
    want = dict(KIND.weight_shapes(TINY), **{k: () for k in KIND.npz_meta(TINY)})
    assert shapes == want

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(td.WEIGHT_ENV, npz)
        enc = td.DinoEncoder.create()
    img = rng.random((3, 64, 64)).astype(np.float32)
    x = (img - td.IMAGENET_MEAN[:, None, None]) / td.IMAGENET_STD[:, None, None]
    with torch.no_grad():
        out = model(pixel_values=torch.from_numpy(x[None])).last_hidden_state[0]
        tokens = enc.tokens(torch.tensor(img))
    torch.testing.assert_close(tokens, out, atol=2e-4, rtol=1e-3)


def test_the_converter_refuses_a_gated_block_of_another_activation():
    cfg = type("Cfg", (), dict(hidden_size=8, use_gated_mlp=True, hidden_act="gelu"))()
    with pytest.raises(NotImplementedError, match="hidden_act"):
        td._convert_dinov3({}, cfg)


def _vitb_npz(tmp_path, depth=4, dim=256):
    params = td.random_params(depth=depth, dim=dim, seed=9)
    params.update(meta_patch=np.int32(16), meta_n_heads=np.int32(4),
                  meta_image_size=np.int32(64))
    path = tmp_path / "vitb.npz"
    np.savez(path, **params)
    return str(path), params


def test_create_loads_the_exact_gelu_tower_bit_equal_to_the_whole_file_load(tmp_path,
                                                                             monkeypatch):
    """The buffers equal, to the bit and in dtype, shape and strides, those
    of the load that read the whole npz into a dict and copied it."""
    path, _ = _vitb_npz(tmp_path)
    monkeypatch.setenv(td.WEIGHT_ENV, path)
    with np.load(path) as z:
        whole = {k: z[k] for k in z.files}
    old = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in whole.items()
           if not k.startswith("meta_")}
    enc = td.DinoEncoder.create(device="cpu")
    assert (enc.patch, enc.n_heads, enc.image_size, enc.n_layers) == (16, 4, 64, 4)
    assert sorted(enc.params) == sorted(old)
    for k, v in enc.params.items():
        assert v.dtype == old[k].dtype and v.stride() == old[k].stride(), k
        assert torch.equal(v, old[k]), k
    # another device gets a copy of the buffers, not of the file
    meta = td.DinoEncoder.create(device="meta")
    assert meta.device.type == "meta" and sorted(meta.params) == sorted(old)
    copy = enc.to_device("cpu")
    assert (copy.rope_theta, copy.ln_eps, copy.n_heads) == (enc.rope_theta, enc.ln_eps, 4)
    for k, v in enc.params.items():
        assert torch.equal(copy.params[k], v) and copy.params[k].data_ptr() != v.data_ptr(), k


def test_create_holds_one_member_of_the_npz_at_a_time(tmp_path, monkeypatch):
    """numpy's host allocations (traced by tracemalloc) while create()
    loads: at most about the largest array, where the whole-file load
    holds every array at once."""
    path, params = _vitb_npz(tmp_path)
    monkeypatch.setenv(td.WEIGHT_ENV, path)
    largest = max(v.nbytes for v in params.values())
    total = sum(v.nbytes for v in params.values())
    assert total > 8 * largest

    def peak(load):
        tracemalloc.start()
        try:
            load()
            return tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()

    def whole():
        with np.load(path) as z:
            return td.DinoEncoder({k: z[k] for k in z.files}, n_heads=4, image_size=64)

    assert peak(whole) >= total
    assert peak(lambda: td.DinoEncoder.create(device="cpu")) < 1.5 * largest + (1 << 20)


@pytest.mark.parametrize("save", [np.savez, np.savez_compressed])
def test_the_npz_reader_reads_what_numpy_reads(tmp_path, save):
    """create()'s reader: stored members (read straight into its reused
    buffer) and compressed ones (through numpy) equal np.load's arrays in
    dtype, shape, order and bits; a name not in the file raises KeyError."""
    rng = np.random.default_rng(4)
    arrays = {"c": rng.random((5, 7)).astype(np.float32),
              "f": np.asfortranarray(rng.random((6, 3))).astype(np.float32),
              "t": rng.random((4, 9)).astype(np.float32).T, "d": rng.random(11),
              "i": np.int32(16), "e": np.zeros((0, 4), np.float32)}
    save(tmp_path / "a.npz", **arrays)
    with np.load(tmp_path / "a.npz") as z:
        members = td._NpzMembers(z)
        assert list(members) == list(z.files) and len(members) == 6 and "c" in members
        for k in members:
            got, want = np.array(members[k]), z[k]
            assert got.dtype == want.dtype and got.shape == want.shape, k
            assert got.flags.f_contiguous == want.flags.f_contiguous, k
            assert np.array_equal(got, want) and got.tobytes("A") == want.tobytes("A"), k
        with pytest.raises(KeyError):
            members["missing"]


def test_the_tower_spans_nest_under_the_call_that_runs_the_tower(tmp_path):
    """With tracing on, each block's `attn` and `mlp` spans are named and
    parented under losses.dino.render and losses.dino.target (so the
    benchmark's sums by name prefix keep the whole tower forward under
    each), on the same numbers as with tracing off; off, no span."""
    _, enc = _written(tmp_path, 5)
    gen = torch.Generator().manual_seed(2)
    image, gt = torch.rand((3, 40, 56), generator=gen), torch.rand((3, 40, 56), generator=gen)

    def term():
        x = image.clone().requires_grad_(True)
        with lu.span("losses.dino"):
            t = dino_term(x, gt, enc, 0.05, mode="fixed")
        t.backward()
        return t.detach(), x.grad

    off = term()
    assert lu.collect()[0] == []
    lu.tracing(True)
    on = term()
    lu.tracing(False)
    spans, _ = lu.collect()
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])
    names = [s.name for s in spans]
    for call in ("render", "target"):
        for branch in ("attn", "mlp"):
            assert names.count(f"losses.dino.{call}.{branch}") == TINY["depth"]
    assert not {n for n in names if n.endswith((".attn", ".mlp"))
                and not n.startswith(("losses.dino.render.", "losses.dino.target."))}
    for s in spans:
        if s.name.endswith((".attn", ".mlp")):
            assert s.parent == s.name.rsplit(".", 1)[0], s
    assert "backward.dino" in names
