"""The DINO tower of the port (gaussmart_tpu_torch/semantics/dino.py) and
its heatmap CLI (semantics/visualize.py) against the JAX package on the
same numpy inputs: the resize weights against jax.image.resize, random()
bit-equal, tokens and the pooled CLS of the DINOv3 and plain-ViT towers,
the converters against random-init transformers models built from configs
in code, the DINO term's gradient against jax.grad, create(), the
heatmap, the overlay against OpenCV (a reference only) and the CLI."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gaussmart_tpu.losses import dino_term as j_dino_term
from gaussmart_tpu.semantics import dino as jd
from gaussmart_tpu.semantics import visualize as jv
from gaussmart_tpu_torch.io.images import read_png, write_png
from gaussmart_tpu_torch.losses import dino_term as t_dino_term
from gaussmart_tpu_torch.semantics import dino as td
from gaussmart_tpu_torch.semantics import visualize as tv

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-4)          # the towers: float32 sum order


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("h,w,size", [(584, 776, 224), (40, 48, 64), (64, 64, 64),
                                      (32, 32, 64)])
def test_resize_matches_jax_image_resize(rng, h, w, size):
    """Two products with per-axis weight matrices = jax.image.resize(...,
    "bilinear") (antialiased when it downsamples), down, mixed, the
    identity and up."""
    img = rng.random((3, h, w)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(img), (3, size, size), method="bilinear"))
    enc = td.DinoEncoder.random(depth=1, dim=48, n_heads=3, image_size=size)
    np.testing.assert_allclose(_np(enc.resize(torch.tensor(img))), ref, atol=1e-5, rtol=0)


def test_random_params_bit_equal_to_jax():
    for kw in (dict(), dict(depth=3, dim=96, n_heads=3, image_size=32, seed=7,
                            n_registers=2)):
        je, te = jd.DinoEncoder.random(**kw), td.DinoEncoder.random(**kw)
        assert set(te.params) == set(je.params)
        for k, v in je.params.items():
            np.testing.assert_array_equal(_np(te.params[k]), np.asarray(v), err_msg=k)
        for attr in ("is_v3", "n_prefix", "n_layers", "patch", "n_heads", "image_size",
                     "rope_theta", "ln_eps"):
            assert getattr(te, attr) == getattr(je, attr), attr
        assert all(not b.requires_grad for b in te.buffers())


def _vit_params(rng, depth=2, dim=96, image_size=64, patch=16):
    """Plain-ViT weights: a learned position embedding, no registers, no
    LayerScale, no meta entries (LN eps 1e-12); LN gains and biases drawn
    so that they matter."""
    p = td.random_params(depth=depth, dim=dim, patch=patch, seed=3)
    for k in ["register_tokens", "meta_rope_theta", "meta_ln_eps"] + [
            f"blocks.{i}.ls{j}" for i in range(depth) for j in (1, 2)]:
        del p[k]
    p["pos_embed"] = rng.normal(0, 0.02, (1 + (image_size // patch) ** 2, dim)).astype(
        np.float32)
    for k in list(p):
        if k.endswith(("norm1_g", "norm2_g", "norm_g")):
            p[k] = rng.uniform(0.5, 1.5, p[k].shape).astype(np.float32)
        elif k.endswith(("_b",)) and "norm" in k:
            p[k] = rng.normal(0, 0.1, p[k].shape).astype(np.float32)
    return p


@pytest.mark.parametrize("arch", ["dinov3", "vit"])
def test_tokens_and_pooled_match_jax(rng, arch):
    """Every token and the pooled CLS against the JAX tower on the same
    weights: the DINOv3 random tower (RoPE, 4 registers, LayerScale) and a
    plain ViT (position embedding, LN eps 1e-12), on a 50x70 image."""
    if arch == "dinov3":
        params = td.random_params(depth=2, dim=96)
        params.update({f"blocks.{i}.ls{j}": rng.uniform(0.5, 1.5, 96).astype(np.float32)
                       for i in range(2) for j in (1, 2)})
    else:
        params = _vit_params(rng)
    je = jd.DinoEncoder(params, n_heads=3, image_size=64)
    te = td.DinoEncoder(params, n_heads=3, image_size=64)
    assert (te.is_v3, te.n_prefix, te.ln_eps) == (je.is_v3, je.n_prefix, je.ln_eps)
    img = rng.random((3, 50, 70)).astype(np.float32)
    ref = np.asarray(je.tokens(jnp.asarray(img)))
    assert ref.shape == (je.n_prefix + 16, 96)
    np.testing.assert_allclose(_np(te.tokens(torch.tensor(img))), ref, **TOL)
    np.testing.assert_allclose(_np(te(torch.tensor(img))), np.asarray(je(jnp.asarray(img))),
                               **TOL)


def _hf_model(arch):
    from transformers import DINOv3ViTConfig, DINOv3ViTModel, ViTConfig, ViTModel
    torch.manual_seed(0)
    if arch == "dinov3":
        cfg = DINOv3ViTConfig(image_size=64, patch_size=16, hidden_size=96,
                              num_attention_heads=3, intermediate_size=192,
                              num_hidden_layers=2, num_register_tokens=4,
                              rope_theta=100.0, layerscale_value=1.0)
        model = DINOv3ViTModel(cfg).eval()
        with torch.no_grad():          # LayerScale that matters
            for layer in model.layer:
                layer.layer_scale1.lambda1.uniform_(0.5, 1.5)
                layer.layer_scale2.lambda1.uniform_(0.5, 1.5)
        return model
    cfg = ViTConfig(image_size=64, patch_size=16, hidden_size=96, num_attention_heads=3,
                    intermediate_size=192, num_hidden_layers=2)
    return ViTModel(cfg, add_pooling_layer=False).eval()


@pytest.mark.parametrize("arch", ["dinov3", "vit"])
def test_converters_match_transformers(tmp_path, rng, arch):
    """convert_hf_dino on a random-init DINOv3ViTModel / ViTModel saved to a
    directory: the npz equals the JAX converter's, and the port's tower on
    it gives the model's tokens (last_hidden_state) and pooled CLS."""
    model = _hf_model(arch)
    model.save_pretrained(tmp_path / "hf")
    npz = td.convert_hf_dino(str(tmp_path / "hf"), str(tmp_path / "dino.npz"))
    with np.load(npz) as z:
        params = {k: z[k] for k in z.files}
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    ref = (jd._convert_dinov3(sd, model.config) if arch == "dinov3"
           else jd._convert_vit(sd))
    assert set(params) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(params[k], v, err_msg=k)
    enc = td.DinoEncoder(params, n_heads=3, image_size=64)
    assert enc.is_v3 == (arch == "dinov3") and enc.n_prefix == (5 if enc.is_v3 else 1)
    img = rng.random((3, 64, 64)).astype(np.float32)
    x = (img - td.IMAGENET_MEAN[:, None, None]) / td.IMAGENET_STD[:, None, None]
    with torch.no_grad():
        out = model(pixel_values=torch.from_numpy(x[None]))
        tokens = enc.tokens(torch.tensor(img))
    np.testing.assert_allclose(_np(tokens), out.last_hidden_state[0].numpy(),
                               atol=2e-4, rtol=1e-3)
    pooled = out.pooler_output[0] if arch == "dinov3" else out.last_hidden_state[0, 0]
    np.testing.assert_allclose(_np(tokens[0]), pooled.numpy(), atol=2e-4, rtol=1e-3)


def test_dino_term_gradient_matches_jax(rng):
    """losses.dino_term: the fixed mode's value and its gradient with
    respect to the image against jax.value_and_grad; the parity mode's
    gradient is zero in both packages."""
    je = jd.DinoEncoder.random(depth=1, dim=96, n_heads=3, image_size=32)
    te = td.DinoEncoder.random(depth=1, dim=96, n_heads=3, image_size=32)
    img = rng.random((3, 40, 36)).astype(np.float32)
    gt = rng.random((3, 40, 36)).astype(np.float32)
    val, grad = jax.value_and_grad(
        lambda i: j_dino_term(i, jnp.asarray(gt), je, 0.05, mode="fixed"))(jnp.asarray(img))
    x = torch.tensor(img, requires_grad=True)
    term = t_dino_term(x, torch.tensor(gt), te, 0.05, mode="fixed")
    term.backward()
    grad = np.asarray(grad)
    assert np.abs(grad).max() > 0
    np.testing.assert_allclose(term.item(), float(val), rtol=1e-4)
    np.testing.assert_allclose(_np(x.grad), grad, rtol=1e-4, atol=1e-4 * np.abs(grad).max())

    x = torch.tensor(img, requires_grad=True)
    term = t_dino_term(x, torch.tensor(gt), te, 0.05, mode="parity")
    assert not term.requires_grad and x.grad is None
    val_p, grad_p = jax.value_and_grad(
        lambda i: j_dino_term(i, jnp.asarray(gt), je, 0.05, mode="parity"))(jnp.asarray(img))
    assert np.abs(np.asarray(grad_p)).sum() == 0
    np.testing.assert_allclose(term.item(), float(val_p), rtol=1e-4)


def test_create_reads_random_an_npz_or_raises(tmp_path, monkeypatch):
    """create(): GAUSSMART_DINO_WEIGHTS=random gives random(); an npz in the
    JAX package's layout (meta_* entries) loads with its patch, heads and
    size; with no file anywhere it raises FileNotFoundError."""
    monkeypatch.setattr(td, "DEFAULT_PATHS", [str(tmp_path / "none.npz")])
    monkeypatch.setenv(td.WEIGHT_ENV, "random")
    enc, ref = td.DinoEncoder.create(), td.DinoEncoder.random()
    for k, v in ref.params.items():
        assert torch.equal(enc.params[k], v), k

    params = td.random_params(depth=1, dim=48, patch=8, seed=5, n_registers=2)
    params.update(meta_patch=np.int32(8), meta_n_heads=np.int32(4),
                  meta_image_size=np.int32(32))
    np.savez(tmp_path / "w.npz", **params)
    monkeypatch.setenv(td.WEIGHT_ENV, str(tmp_path / "w.npz"))
    enc = td.DinoEncoder.create()
    assert (enc.patch, enc.n_heads, enc.image_size, enc.n_prefix, enc.n_layers) == (
        8, 4, 32, 3, 1)
    je = jd.DinoEncoder(params, patch=8, n_heads=4, image_size=32)
    img = np.random.default_rng(1).random((3, 20, 24)).astype(np.float32)
    np.testing.assert_allclose(_np(enc(torch.tensor(img))), np.asarray(je(jnp.asarray(img))),
                               **TOL)

    monkeypatch.setenv(td.WEIGHT_ENV, str(tmp_path / "missing.npz"))
    with pytest.raises(FileNotFoundError, match="No DINO weights"):
        td.DinoEncoder.create()


def test_cls_patch_heatmap_matches_jax(rng):
    je = jd.DinoEncoder.random(depth=1, dim=96, n_heads=3, image_size=64)
    te = td.DinoEncoder.random(depth=1, dim=96, n_heads=3, image_size=64)
    img = rng.random((3, 50, 70)).astype(np.float32)
    heat = tv.cls_patch_heatmap(te, img)
    assert heat.shape == (4, 4) and heat.min() >= 0 and heat.max() <= 1
    np.testing.assert_allclose(heat, jv.cls_patch_heatmap(je, img), atol=1e-5, rtol=0)


def test_overlay_matches_opencv(rng):
    """The turbo table equals cv2.applyColorMap(COLORMAP_TURBO) entry for
    entry; the uint8 bilinear resize equals cv2.resize(INTER_LINEAR) to the
    bit, up and down; so the overlay equals the JAX overlay (cv2)."""
    cv2 = pytest.importorskip("cv2")
    lut = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
                            cv2.COLORMAP_TURBO)[:, 0, ::-1]
    np.testing.assert_array_equal(tv.TURBO_U8, lut)
    for h, w, H, W in ((14, 14, 48, 64), (4, 4, 584, 776), (14, 14, 10, 9)):
        a = (rng.random((h, w)) * 255).astype(np.uint8)
        ref = cv2.resize(a, (W, H), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(tv.resize_linear_u8(a, W, H), ref)
    img = rng.random((48, 64, 3)).astype(np.float32)
    heat = rng.random((4, 4)).astype(np.float32)
    np.testing.assert_array_equal(tv.overlay_heatmap(img, heat, 0.4),
                                  jv.overlay_heatmap(img, heat, 0.4))


def test_visualize_cli_writes_a_png(tmp_path, rng):
    """The CLI on an RGBA PNG (--random_encoder --device cpu) writes an RGB
    PNG of the input's size: the overlay of the random encoder's heatmap,
    as the JAX CLI computes it to within one colour-table step."""
    img = (rng.random((48, 64, 4)) * 255).astype(np.uint8)
    write_png(str(tmp_path / "in.png"), img)
    tv.main(["-i", str(tmp_path / "in.png"), "-o", str(tmp_path / "out" / "o.png"),
             "--random_encoder", "--device", "cpu"])
    out = read_png(str(tmp_path / "out" / "o.png"))
    assert out.shape == (48, 64, 3) and out.dtype == np.uint8
    rgb = img[..., :3].astype(np.float32) / 255
    enc = jd.DinoEncoder.random(depth=2, dim=192, image_size=224)
    ref = jv.overlay_heatmap(rgb, jv.cls_patch_heatmap(enc, rgb.transpose(2, 0, 1)))
    step = np.abs(np.diff(tv.TURBO_U8.astype(float), axis=0)).max()
    assert np.abs(out - np.clip(ref * 255, 0, 255)).max() <= 0.5 * step + 1


def test_visualize_reads_only_8bit_pngs(tmp_path):
    """Intended: the CLI reads 8-bit PNGs through io/images.py (the JAX CLI
    reads any format Pillow reads); a 16-bit PNG is refused by name."""
    from PIL import Image
    Image.fromarray(np.full((8, 8), 40000, np.uint16)).save(tmp_path / "deep.png")
    with pytest.raises(ValueError, match="only non-interlaced 8-bit PNGs"):
        tv.main(["-i", str(tmp_path / "deep.png"), "-o", str(tmp_path / "o.png"),
                 "--random_encoder", "--device", "cpu"])
    assert not (tmp_path / "o.png").exists()
