"""gaussmart_tpu_torch foundations vs the JAX package on the same inputs:
transforms, cameras, SH evaluation, depth->normal, runtime setup.

Pure float32 math, so the tolerance is fp32 noise: atol 1e-5, rtol 1e-5."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gaussmart_tpu import cameras as jcam
from gaussmart_tpu import transforms as jtr
from gaussmart_tpu.ops import depth_normal as jdn
from gaussmart_tpu.ops import sh as jsh
from gaussmart_tpu_torch import cameras as tcam
from gaussmart_tpu_torch import runtime
from gaussmart_tpu_torch import transforms as ttr
from gaussmart_tpu_torch.ops import depth_normal as tdn
from gaussmart_tpu_torch.ops import sh as tsh

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _cams(rng):
    """A few cameras of random pose; the second one is a Blender-style
    pose with translation, the third has a non-square frame."""
    out = []
    for i, (w, h) in enumerate([(64, 48), (32, 32), (80, 30)]):
        q = rng.normal(size=4)
        from gaussmart_tpu.io.colmap import qvec2rotmat
        R = qvec2rotmat(q / np.linalg.norm(q))
        T = rng.normal(size=3)
        kw = dict(uid=i, colmap_id=i, image_name=f"c{i}", R=R, T=T,
                  fovx=0.6 + 0.2 * i, fovy=0.5 + 0.1 * i, width=w, height=h)
        out.append((jcam.Camera(**kw), tcam.Camera(**kw)))
    return out


def test_transforms_match_jax(rng):
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q[0] = 0.0                                   # degenerate quaternion
    np.testing.assert_allclose(ttr.quat_to_rotmat(_t(q)).numpy(),
                               np.asarray(jtr.quat_to_rotmat(jnp.asarray(q))), **TOL)
    x = rng.normal(size=(64, 3)).astype(np.float32)
    x[:3] = 0.0                                  # zero vectors stay zero
    np.testing.assert_allclose(ttr.safe_normalize(_t(x)).numpy(),
                               np.asarray(jtr.safe_normalize(jnp.asarray(x))), **TOL)
    p = rng.uniform(0.01, 0.99, 64).astype(np.float32)
    np.testing.assert_allclose(ttr.inverse_sigmoid(_t(p)).numpy(),
                               np.asarray(jtr.inverse_sigmoid(jnp.asarray(p))), **TOL)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(rng, deg):
    k = (deg + 1) ** 2
    sh = rng.normal(size=(50, 3, k)).astype(np.float32)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    np.testing.assert_allclose(
        tsh.eval_sh(deg, _t(sh), _t(d)).numpy(),
        np.asarray(jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d))), **TOL)
    rgb = rng.random((7, 3)).astype(np.float32)
    np.testing.assert_allclose(tsh.sh2rgb(tsh.rgb2sh(_t(rgb))).numpy(), rgb, **TOL)
    np.testing.assert_allclose(tsh.rgb2sh(rgb), np.asarray(jsh.rgb2sh(rgb)), **TOL)
    assert tsh.SH_C0 == jsh.SH_C0


def test_cameras_match_jax(rng):
    for jc, tc in _cams(rng):
        for name in ("world_view", "proj", "full_proj", "camera_center"):
            np.testing.assert_allclose(getattr(tc, name), getattr(jc, name), **TOL)
        jp, tp = jc.params(), tc.params("cpu")
        np.testing.assert_allclose(tp.world_view.numpy(), np.asarray(jp.world_view), **TOL)
        np.testing.assert_allclose(tp.full_proj.numpy(), np.asarray(jp.full_proj), **TOL)
        np.testing.assert_allclose(tp.camera_center.numpy(),
                                   np.asarray(jp.camera_center), **TOL)
        assert tp.tanfovx == pytest.approx(float(jp.tanfovx), rel=1e-6)
        assert (tp.width, tp.height) == (jp.width, jp.height)
        assert tp.world_view.dtype == torch.float32
        np.testing.assert_allclose(tc.c2w(), jc.c2w(), **TOL)
        mj = jcam.MiniCam(jc.width, jc.height, jc.fovy, jc.fovx, 0.01, 100.0,
                          jc.world_view, jc.full_proj)
        mt = tcam.MiniCam(tc.width, tc.height, tc.fovy, tc.fovx, 0.01, 100.0,
                          tc.world_view, tc.full_proj)
        np.testing.assert_allclose(mt.params("cpu").camera_center.numpy(),
                                   np.asarray(mj.params().camera_center), **TOL)
    assert tcam.fov2focal(0.7, 640) == jcam.fov2focal(0.7, 640)
    assert tcam.focal2fov(500.0, 640) == jcam.focal2fov(500.0, 640)


def test_depth_to_normal_matches_jax(rng):
    for jc, tc in _cams(rng):
        depth = rng.uniform(1.0, 3.0, (1, jc.height, jc.width)).astype(np.float32)
        pts_j = np.asarray(jdn.depths_to_points(jc.params(), jnp.asarray(depth)))
        pts_t = tdn.depths_to_points(tc.params("cpu"), _t(depth)).numpy()
        np.testing.assert_allclose(pts_t, pts_j, atol=1e-5 * np.abs(pts_j).max(),
                                   rtol=1e-5)
        n_j = np.asarray(jdn.depth_to_normal(jc.params(), jnp.asarray(depth)))
        n_t = tdn.depth_to_normal(tc.params("cpu"), _t(depth)).numpy()
        np.testing.assert_allclose(n_t, n_j, atol=1e-4, rtol=1e-4)


def test_runtime_pins_f32_and_never_falls_back(monkeypatch):
    runtime.setup()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert runtime.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.resolve_device("cuda")
