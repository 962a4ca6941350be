"""The reference against the system's CPU path at small sizes: the
rasterizer's maps and gradients, the DINO tower and its term, and Adam."""
import math

import numpy as np
import pytest
import torch

from portbench import scene as scenes
from portbench.reference import dino as ref_dino, raster, train as ref_train
from portbench.tests.helpers import tiny_cell

MAPS = ("render", "rend_alpha", "rend_normal", "surf_depth", "surf_normal")


def _inputs(workload, seed=11):
    _, _, cfg, _ = tiny_cell(workload)
    sc = scenes.build(cfg, seed, "cpu")
    return cfg, sc


def _port_camera(cam, c):
    from gaussmart_tpu_torch.cameras import CameraParams
    return CameraParams(world_view=cam.world_view, full_proj=cam.full_proj,
                        camera_center=cam.center, tanfovx=math.tan(c["fovx"] / 2),
                        tanfovy=math.tan(c["fovy"] / 2), width=cam.width, height=cam.height)


@pytest.mark.parametrize("workload,view", [("dtu-scan24.train-dino", 0),
                                           ("dtu-scan24.train-dino", 3),
                                           ("m360-garden.train-dino", 5)])
def test_rasterizer_maps_and_gradients_match_the_system(workload, view):
    from gaussmart_tpu_torch.render.api import render_arrays
    cfg, sc = _inputs(workload)
    cam = scenes.camera(sc.cams[view], sc.width, sc.height, "cpu")
    gen = torch.Generator().manual_seed(3)
    weights = {k: torch.rand((3 if k in ("render", "rend_normal", "surf_normal") else 1,
                              sc.height, sc.width), generator=gen) for k in MAPS}
    outs, grads = [], []
    for side in ("system", "reference"):
        leaves = {g: sc.params[g].clone().requires_grad_() for g in ref_train.GROUPS}
        act = dict(xyz=leaves["xyz"], scales=torch.exp(leaves["scaling"]),
                   quats=leaves["rotation"], opacity=torch.sigmoid(leaves["opacity"][:, 0]),
                   shs=torch.cat([leaves["features_dc"], leaves["features_rest"]], 1),
                   active=sc.active)
        if side == "system":
            pkg = render_arrays(_port_camera(cam, sc.cams[view]), xyz=act["xyz"],
                                scaling=act["scales"], rotation=act["quats"],
                                opacity=act["opacity"], features=act["shs"], active=sc.active,
                                sh_degree=3, bg_color=torch.zeros(3), active_degree=3,
                                need_dist_grad=False)
        else:
            pkg = raster.render(act, cam)
        sum(torch.sum(pkg[k] * weights[k]) for k in MAPS).backward()
        outs.append({k: pkg[k].detach() for k in MAPS})
        grads.append({g: leaves[g].grad for g in ref_train.GROUPS})
    assert float(outs[1]["rend_alpha"].max()) > 0.5     # the view sees splats
    for k in MAPS:
        torch.testing.assert_close(outs[1][k], outs[0][k], rtol=1e-4, atol=1e-4)
    for g in ref_train.GROUPS:
        scale = float(grads[1][g].abs().max())
        torch.testing.assert_close(grads[1][g], grads[0][g], rtol=1e-3, atol=1e-4 * scale)


def test_tower_and_term_match_the_system_encoder():
    from gaussmart_tpu_torch.losses import dino_term
    from gaussmart_tpu_torch.semantics.dino import DinoEncoder
    dino = dict(depth=2, dim=192, heads=3, mlp=768, patch=16, registers=4, image_size=64,
                rope_theta=100.0, ln_eps=1e-5)
    w = scenes.dino_weights(dino, 5, "cpu")
    params = {k: v.numpy() for k, v in w.items()}
    params.update(meta_rope_theta=np.float32(100.0), meta_ln_eps=np.float32(1e-5))
    enc = DinoEncoder(params, patch=16, n_heads=3, image_size=64)
    tower = ref_dino.Tower(w, heads=3, patch=16, size=64)
    gen = torch.Generator().manual_seed(1)
    image = torch.rand((3, 48, 72), generator=gen)
    target = torch.rand((3, 48, 72), generator=gen)
    torch.testing.assert_close(tower.embed(image), enc(image), rtol=1e-4, atol=1e-5)
    grads = []
    for f in (lambda x: dino_term(x, target, enc, 0.05, "fixed"),
              lambda x: ref_dino.dino_term(tower, x, target, 0.05)):
        x = image.clone().requires_grad_()
        f(x).backward()
        grads.append(x.grad)
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-3,
                               atol=1e-4 * float(grads[0].abs().max()))


def test_adam_matches_the_system_optimizer():
    from gaussmart_tpu_torch.models.gaussians import GaussianParams
    from gaussmart_tpu_torch.optim import adam_step, group_lrs, init_adam
    from gaussmart_tpu_torch.config import OptimizationParams
    _, sc = _inputs("dtu-scan24.train-dino")
    gen = torch.Generator().manual_seed(2)
    grads = {g: torch.randn(v.shape, generator=gen) * 1e-3 for g, v in sc.params.items()}
    p_sys, st_sys = GaussianParams(**sc.params), init_adam(GaussianParams(**sc.params))
    p_ref, st_ref = dict(sc.params), ref_train.init_adam(sc.params)
    for it in (15001, 15002):
        p_sys, st_sys = adam_step(p_sys, GaussianParams(**grads), st_sys,
                                  group_lrs(OptimizationParams(), it, 2.0), sc.active)
        p_ref, st_ref = ref_train.adam_step(p_ref, grads, st_ref, sc.active,
                                            ref_train.learning_rates(it, 2.0))
    for g in ref_train.GROUPS:
        torch.testing.assert_close(p_ref[g], getattr(p_sys, g), rtol=1e-5, atol=1e-6)
