"""The mesh-export slice of the port against the JAX package: the TSDF grid
(state, chunking, the int8 pull, extract_mesh), fuse_samples and the
contraction, marching tetrahedra (numpy body and the native core built
into build/), post-processing and PLY bytes, the extractor's bounded and
unbounded meshes on the same maps, and render_cli's mesh export end to
end on a small sphere model; the --render_path repairs (turbo map, the
videos written without OpenCV)."""
import hashlib
import json
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from gaussmart_tpu import render_cli as j_render_cli
from gaussmart_tpu.cameras import Camera as JCamera
from gaussmart_tpu.io.gaussian_ply import save_gaussian_ply as j_save_ply
from gaussmart_tpu.io.ply import store_point_cloud
from gaussmart_tpu.mesh import marching as jm
from gaussmart_tpu.mesh import meshing as jmesh
from gaussmart_tpu.mesh import native as jnative
from gaussmart_tpu.mesh import tsdf as jt
from gaussmart_tpu.mesh.extract import GaussianExtractor as JExtractor
from gaussmart_tpu.models import gaussians as jg
from gaussmart_tpu_torch import render_cli
from gaussmart_tpu_torch import trajectory as ttraj
from gaussmart_tpu_torch.cameras import Camera as TCamera
from gaussmart_tpu_torch.mesh import marching as tm
from gaussmart_tpu_torch.mesh import meshing as tmesh
from gaussmart_tpu_torch.mesh import native as tnative
from gaussmart_tpu_torch.mesh import tsdf as tt
from gaussmart_tpu_torch.mesh.extract import GaussianExtractor as TExtractor
from gaussmart_tpu_torch.models import gaussians as tg

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 64, 48
LO, HI = (-1.2, -1.0, 1.0), (1.2, 1.0, 3.2)     # a 49 x 41 x 45 grid at 0.05


def _views(rng, n):
    """n random cameras near the origin looking down +z, with random depth
    (10% holes) and colour maps."""
    cams, depths, rgbs = [], [], []
    for i in range(n):
        a = rng.uniform(-0.4, 0.4)
        c, s = np.cos(a), np.sin(a)
        cams.append(dict(uid=i, colmap_id=i, image_name=f"c{i}",
                         R=np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]),
                         T=rng.uniform(-0.2, 0.2, 3), fovx=0.9, fovy=0.7,
                         width=W, height=H))
        d = (2.0 + 0.5 * rng.random((H, W))).astype(np.float32)
        d[rng.random((H, W)) < 0.1] = 0
        depths.append(d)
        rgbs.append(rng.random((3, H, W)).astype(np.float32))
    return cams, depths, rgbs


def _fused(rng, n_views=3, voxel=0.05, trunc=0.15):
    cams, depths, rgbs = _views(rng, n_views)
    jv = jt.TSDFVolume(LO, HI, voxel, trunc)
    tv = tt.TSDFVolume(LO, HI, voxel, trunc, device="cpu")
    for c, d, r in zip(cams, depths, rgbs):
        jv.integrate(jnp.asarray(d), jnp.asarray(r), JCamera(**c).params(), 4.0)
        tv.integrate(torch.from_numpy(d), torch.from_numpy(r), TCamera(**c).params("cpu"), 4.0)
    return jv, tv


def _jax_grid(jv):
    return tuple(np.concatenate([np.asarray(a) for a in getattr(jv, k)])
                 for k in ("tsdf", "weight", "color"))


def test_tsdf_volume_matches_jax(rng):
    jv, tv = _fused(rng)
    assert tv.dims == jv.dims and tv.voxel_size == jv.voxel_size
    j_tsdf, j_weight, j_color = _jax_grid(jv)
    assert j_weight.max() == 3 and (j_weight == 0).mean() > 0.1   # every case occurs
    np.testing.assert_array_equal(tv.weight.numpy(), j_weight)
    np.testing.assert_allclose(tv.tsdf.numpy(), j_tsdf, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tv.color.numpy(), j_color, rtol=0, atol=1e-6)
    # the int8 grid that extract_mesh pulls
    j_q = np.concatenate([np.asarray(jt._quantize_chunk(t, w))
                          for t, w in zip(jv.tsdf, jv.weight)]).reshape(jv.dims)
    q = tv.quantized()
    assert q.dtype == np.int8 and q.shape == j_q.shape
    assert (q == j_q).mean() >= 0.9999
    assert np.abs(q.astype(np.int16) - j_q).max() <= 1


def test_extract_mesh_from_the_jax_grid_matches_jax(rng):
    """The JAX grid's arrays carried into the port's volume give the same
    welded mesh and colours."""
    jv, tv = _fused(rng)
    for k, a in zip(("tsdf", "weight", "color"), _jax_grid(jv)):
        getattr(tv, k).copy_(torch.from_numpy(a))
    ref = jv.extract_mesh()
    mesh = tv.extract_mesh()
    assert len(ref.vertices) > 1000
    np.testing.assert_array_equal(mesh.vertices, ref.vertices)
    np.testing.assert_array_equal(mesh.faces, ref.faces)
    np.testing.assert_allclose(mesh.vertex_colors, ref.vertex_colors, rtol=0, atol=1e-6)


def test_tsdf_chunked_matches_unchunked(rng, monkeypatch):
    cams, depths, rgbs = _views(rng, 2)

    def fuse():
        tv = tt.TSDFVolume(LO, HI, 0.05, 0.15, device="cpu")
        for c, d, r in zip(cams, depths, rgbs):
            tv.integrate(torch.from_numpy(d), torch.from_numpy(r),
                         TCamera(**c).params("cpu"), 4.0)
        return tv

    ref = fuse()
    monkeypatch.setattr(tt, "CHUNK", 4096)       # the grid is 90,405 voxels
    chunked = fuse()
    assert len(chunked._chunks) == 23 and len(ref._chunks) == 1
    for k in ("tsdf", "weight", "color"):
        assert torch.equal(getattr(chunked, k), getattr(ref, k)), k
    assert np.array_equal(chunked.quantized(), ref.quantized())


def test_tsdf_voxel_cap_scales_voxel_and_band_as_jax(monkeypatch):
    monkeypatch.setenv("GAUSSMART_TSDF_MAX_VOXELS", "20000")
    jv = jt.TSDFVolume(LO, HI, 0.05, 0.15)
    tv = tt.TSDFVolume(LO, HI, 0.05, 0.15, device="cpu")
    assert tv.dims == jv.dims and tv.voxel_size > 0.05      # capped
    assert (tv.voxel_size, tv.sdf_trunc) == (jv.voxel_size, jv.sdf_trunc)


@pytest.mark.parametrize("adaptive", [True, False])
def test_fuse_samples_matches_jax(rng, adaptive):
    cams, depths, rgbs = _views(rng, 4)
    projs = np.stack([JCamera(**c).full_proj for c in cams])
    center, radius = np.array([0.0, 0.0, 2.2], np.float32), 0.8
    if adaptive:     # contracted space, inside and outside the unit ball
        samples = rng.uniform(-1.2, 1.2, (6000, 3)).astype(np.float32)
    else:
        samples = (rng.uniform(-1, 1, (6000, 3)) * [0.8, 0.6, 0.8] + [0, 0, 2.2]
                   ).astype(np.float32)
    j_tsdf, j_rgb = jt.fuse_samples(samples, jnp.asarray(np.stack(depths)),
                                    jnp.asarray(np.stack(rgbs)), jnp.asarray(projs),
                                    0.02, center, radius, adaptive=adaptive)
    t_tsdf, t_rgb = tt.fuse_samples(samples, torch.from_numpy(np.stack(depths)),
                                    torch.from_numpy(np.stack(rgbs)),
                                    torch.from_numpy(projs), 0.02, center, radius,
                                    adaptive=adaptive)
    assert (np.asarray(j_tsdf) != 1).mean() > 0.05      # samples were fused
    np.testing.assert_allclose(t_tsdf, j_tsdf, rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_rgb, j_rgb, rtol=0, atol=1e-5)


def test_contract_and_uncontract_match_jax(rng):
    x = rng.normal(scale=2.0, size=(2000, 3)).astype(np.float32)
    y = np.asarray(jt.contract(jnp.asarray(x)))
    np.testing.assert_allclose(tt.contract(torch.from_numpy(x)).numpy(), y, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tt.uncontract(torch.from_numpy(y)).numpy(),
                               np.asarray(jt.uncontract(jnp.asarray(y))), rtol=0, atol=1e-6)


def _sphere(n=24, r=0.6, holes=0.0, rng=None):
    xs = np.linspace(-1, 1, n)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1)
    vol = np.linalg.norm(g, axis=-1) - r
    if holes:
        vol[rng.random(vol.shape) < holes] = np.nan
    return vol, xs[1] - xs[0]


@pytest.mark.parametrize("holes", [0.0, 0.15])
def test_marching_tetrahedra_numpy_matches_jax(rng, holes):
    vol, sp = _sphere(holes=holes, rng=rng)
    ref = jm.marching_tetrahedra(vol, 0.0, (sp,) * 3, (-1, -1, -1), use_native=False)
    got = tm.marching_tetrahedra(vol, 0.0, (sp,) * 3, (-1, -1, -1), use_native=False)
    assert len(ref[0]) > 100
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


def test_native_core_builds_into_build_and_matches_jax_and_numpy(rng):
    """The port compiles native/marching_tet.cpp into build/gaussmart_tpu_torch/
    (never beside the source) and its triangles equal the JAX package's
    library's and, up to order, the numpy body's."""
    so = os.path.join(REPO, "native", "libmarching_tet.so")

    def stamp():
        with open(so, "rb") as f:
            return os.stat(so).st_mtime_ns, hashlib.sha256(f.read()).hexdigest()
    before = stamp()
    path = tnative.build()
    assert path.parent == tnative.kernels.BUILD_DIR and path.exists()
    assert tnative.kernels.BUILD_DIR.parts[-2:] == ("build", "gaussmart_tpu_torch")
    assert stamp() == before                      # nothing written under native/
    if not jnative.available():
        pytest.skip("the JAX package's loader found no C++ toolchain")
    for holes in (0.0, 0.15):
        vol, sp = _sphere(n=32, holes=holes, rng=rng)
        vol = vol.astype(np.float32)
        ref = jnative.marching_tetrahedra_native(vol, 0.0, (sp,) * 3, (-1, -1, -1))
        got = tm.marching_tetrahedra(vol, 0.0, (sp,) * 3, (-1, -1, -1))
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        plain = tm.marching_tetrahedra(vol.astype(np.float64), 0.0, (sp,) * 3,
                                       (-1, -1, -1), use_native=False)
        assert len(plain[0]) == len(got[0])
        np.testing.assert_allclose(np.sort(got[0].reshape(-1, 9), axis=0),
                                   np.sort(plain[0].reshape(-1, 9), axis=0), atol=1e-6)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SRC", bad)
    monkeypatch.setattr(tnative.kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.build()


def test_blockwise_marching_matches_jax():
    def sdf(p):
        return np.linalg.norm(p, axis=-1) - 0.55

    kw = dict(resolution=48, block=16, bounding_box_min=(-1, -1, -1),
              bounding_box_max=(1, 1, 1), inv_contraction=lambda v: v * 1.5)
    ref = jm.marching_cubes_with_contraction(sdf, **kw)
    got = tm.marching_cubes_with_contraction(sdf, **kw)
    assert len(ref.faces) > 1000
    np.testing.assert_array_equal(got.vertices, ref.vertices)
    np.testing.assert_array_equal(got.faces, ref.faces)


def test_post_process_and_ply_bytes_match_jax(tmp_path, rng):
    vol, sp = _sphere(n=32)
    v, f = jm.marching_tetrahedra(vol, 0.0, (sp,) * 3, (-1, -1, -1), use_native=False)
    welded = jmesh.TriMesh(v, f).merge_vertices()
    nv = len(welded.vertices)
    verts = np.concatenate([welded.vertices, [[5, 5, 5], [5.1, 5, 5], [5, 5.1, 5]]])
    faces = np.concatenate([welded.faces, [[nv, nv + 1, nv + 2]]])
    cols = rng.random((len(verts), 3))
    ref = jmesh.post_process_mesh(jmesh.TriMesh(verts, faces, cols), cluster_to_keep=1)
    got = tmesh.post_process_mesh(tmesh.TriMesh(verts, faces, cols), cluster_to_keep=1)
    assert len(got.vertices) == nv
    for k in ("vertices", "faces", "vertex_colors"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k))
    for with_colors in (True, False):
        m = dict(vertex_colors=None) if not with_colors else {}
        jmesh.save_mesh_ply(str(tmp_path / "j.ply"), jmesh.TriMesh(ref.vertices, ref.faces,
                                                                   **m) if m else ref)
        tmesh.save_mesh_ply(str(tmp_path / "t.ply"), tmesh.TriMesh(got.vertices, got.faces,
                                                                   **m) if m else got)
        assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()
        back = tmesh.load_mesh_ply(str(tmp_path / "j.ply"))
        ref_back = jmesh.load_mesh_ply(str(tmp_path / "j.ply"))
        np.testing.assert_array_equal(back.vertices, ref_back.vertices)
        np.testing.assert_array_equal(back.faces, ref_back.faces)


# --- the extractor and render_cli on a sphere ---------------------------------

def sphere_surfels(rng, n, radius=1.0, grey=0.6, sh_degree=3):
    """n surfels on a sphere at the origin, each tangent to it (its normal
    radial), scales about the mean spacing, opacity 0.99, a constant grey
    at SH degree `sh_degree`: numpy parameter arrays."""
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    # the rotation taking +z to the normal: (1 + n_z, -n_y, n_x, 0) in (w,x,y,z)
    q = np.stack([1 + nrm[:, 2], -nrm[:, 1], nrm[:, 0], np.zeros(n)], axis=1)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    spacing = radius * np.sqrt(4 * np.pi / n)
    k = (sh_degree + 1) ** 2
    return {"xyz": (radius * nrm).astype(np.float32),
            "features_dc": np.full((n, 1, 3), (grey - 0.5) / 0.28209479177387814, np.float32),
            "features_rest": np.zeros((n, k - 1, 3), np.float32),
            "scaling": np.full((n, 2), np.log(spacing), np.float32),
            "rotation": q.astype(np.float32),
            "opacity": np.full((n, 1), np.log(0.99 / 0.01), np.float32)}


def _ring_c2w(n, dist=4.0):
    """OpenGL camera-to-world matrices on a ring of radius `dist` in the
    xz plane, each looking at the origin."""
    out = []
    for i in range(n):
        a = 2 * np.pi * i / n
        back = np.array([np.cos(a), 0.0, np.sin(a)])
        up = np.array([0.0, 1.0, 0.0])
        c2w = np.eye(4)
        c2w[:3, 0] = np.cross(up, back)
        c2w[:3, 1] = up
        c2w[:3, 2] = back
        c2w[:3, 3] = dist * back
        out.append(c2w)
    return out


def sphere_model_dir(root, rng, n=2000, n_views=10, iteration=7):
    """A Blender scene (views 0 and 3 of a ring of n_views for test, the
    others for training, at 64x48, grey GT images) and a trained snapshot
    of `n` sphere surfels, written with the JAX package, with its
    cfg_args.json. The two test views are not opposite: the bounding
    sphere of two opposite views is singular."""
    src = os.path.join(root, "scene")
    os.makedirs(os.path.join(src, "train"))
    frames = []
    for i, c2w in enumerate(_ring_c2w(n_views)):
        img = np.full((H, W, 4), 150, np.uint8)
        img[..., 3] = 255
        Image.fromarray(img, "RGBA").save(os.path.join(src, "train", f"r_{i}.png"))
        frames.append({"file_path": f"train/r_{i}", "transform_matrix": c2w.tolist()})
    test = [frames[0], frames[3]]
    for split, fr in (("train", [f for f in frames if f not in test]), ("test", test)):
        with open(os.path.join(src, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.9, "frames": fr}, f)
    store_point_cloud(os.path.join(src, "points3d.ply"), rng.uniform(-1, 1, (32, 3)),
                      np.full((32, 3), 128.0))
    p = sphere_surfels(rng, n, sh_degree=1)
    params = jg.GaussianParams(**{k: jnp.asarray(v) for k, v in p.items()})
    aux = jg.GaussianAux(active=jnp.ones(n, bool), segments=jnp.zeros(n, jnp.int32),
                         max_radii2d=jnp.zeros(n), grad_accum=jnp.zeros(n),
                         denom=jnp.zeros(n))
    state = jg.GaussianState(params=params, aux=aux, max_sh_degree=1,
                             active_sh_degree=1, spatial_lr_scale=1.0)
    model = os.path.join(root, "model")
    j_save_ply(os.path.join(model, "point_cloud", f"iteration_{iteration}",
                            "point_cloud.ply"), state)
    with open(os.path.join(model, "cfg_args.json"), "w") as f:
        json.dump(dict(source_path=src, model_path=model, white_background=False,
                       sh_degree=1, resolution=1, eval=True, images="images",
                       backend="auto", depth_ratio=0.0), f)
    return model, p


def _extractors(rng, n=1500, n_views=6):
    """A JAX and a port extractor holding the same maps, cameras, centre,
    radius and splats (maps: the port's renders of the sphere)."""
    p = sphere_surfels(rng, n, sh_degree=0)
    tstate = tg.state_from_numpy(p, np.ones(n, bool), np.zeros(n, np.int32), 0, 0, 1.0,
                                 device="cpu")
    jstate = jg.GaussianState(
        params=jg.GaussianParams(**{k: jnp.asarray(v) for k, v in p.items()}),
        aux=jg.GaussianAux(active=jnp.ones(n, bool), segments=jnp.zeros(n, jnp.int32),
                           max_radii2d=jnp.zeros(n), grad_accum=jnp.zeros(n),
                           denom=jnp.zeros(n)),
        max_sh_degree=0, active_sh_degree=0, spatial_lr_scale=1.0)
    cams = []
    for i, c2w in enumerate(_ring_c2w(n_views)):
        c2w = c2w.copy()
        c2w[:3, 1:3] *= -1                     # OpenGL -> COLMAP axes
        w2c = np.linalg.inv(c2w)
        cams.append(dict(uid=i, colmap_id=i, image_name=f"v{i}", R=w2c[:3, :3].T,
                         T=w2c[:3, 3], fovx=0.9, fovy=0.7, width=W, height=H))
    tex = TExtractor(tstate, bg_color=[0, 0, 0])
    tex.reconstruction([TCamera(**c) for c in cams])
    jex = JExtractor(jstate, bg_color=[0, 0, 0], backend="dense")
    jex.viewpoint_stack = [JCamera(**c) for c in cams]
    jex.rgbmaps = [jnp.asarray(m.numpy()) for m in tex.rgbmaps]
    jex.depthmaps = [jnp.asarray(m.numpy()) for m in tex.depthmaps]
    jex.center, jex.radius = tex.center, tex.radius
    return jex, tex


def test_extract_mesh_bounded_matches_jax_on_the_same_maps(rng):
    jex, tex = _extractors(rng)
    kw = dict(voxel_size=0.07, sdf_trunc=0.21, depth_trunc=8.0)      # a 47^3 grid
    ref = jex.extract_mesh_bounded(**kw)
    mesh = tex.extract_mesh_bounded(**kw)
    assert len(ref.vertices) > 1000
    assert mesh.vertices.shape == ref.vertices.shape
    np.testing.assert_allclose(mesh.vertices, ref.vertices, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(mesh.faces, ref.faces)
    np.testing.assert_allclose(mesh.vertex_colors, ref.vertex_colors, rtol=0, atol=1e-5)
    # the surface is the sphere, within a voxel
    assert np.abs(np.linalg.norm(mesh.vertices, axis=1) - 1).mean() < 0.07


def test_extract_mesh_unbounded_matches_jax_on_the_same_maps(rng):
    """At resolution 64, the least extract_mesh_unbounded takes (its
    marching blocks are 64^3)."""
    jex, tex = _extractors(rng)
    ref = jex.extract_mesh_unbounded(resolution=64)
    mesh = tex.extract_mesh_unbounded(resolution=64)
    assert len(ref.vertices) > 1000
    assert mesh.vertices.shape == ref.vertices.shape
    np.testing.assert_allclose(mesh.vertices, ref.vertices, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(mesh.faces, ref.faces)
    np.testing.assert_allclose(mesh.vertex_colors, ref.vertex_colors, rtol=0, atol=1e-5)


def _png(path):
    with Image.open(path) as im:
        return np.asarray(im).astype(np.int32)


def _mean_nn(a, b):
    from scipy.spatial import cKDTree
    return 0.5 * (cKDTree(b).query(a)[0].mean() + cKDTree(a).query(b)[0].mean())


def test_render_cli_mesh_export_matches_jax(tmp_path, rng):
    """render_cli without --skip_mesh on a 2000-surfel sphere: the port's
    fuse.ply within one voxel of the JAX CLI's (two-sided mean nearest-
    neighbour distance), fuse_post.ply written, the renders equal modulo
    binning; over 2 device slots the same mesh; then --unbounded writes
    fuse_unbounded.ply and its _post."""
    model, _ = sphere_model_dir(str(tmp_path / "port"), np.random.default_rng(1))
    jmodel, _ = sphere_model_dir(str(tmp_path / "jax"), np.random.default_rng(1))
    voxel = 0.08
    mesh_args = ["--voxel_size", str(voxel), "--sdf_trunc", "0.16"]
    render_cli.main(["-m", model, "--device", "cpu"] + mesh_args)
    j_render_cli.main(["-m", jmodel, "--backend", "dense"] + mesh_args)
    ours, theirs = (os.path.join(m, "train", "ours_7") for m in (model, jmodel))
    mesh = tmesh.load_mesh_ply(os.path.join(ours, "fuse.ply"))
    ref = jmesh.load_mesh_ply(os.path.join(theirs, "fuse.ply"))
    assert len(ref.vertices) > 500 and len(mesh.vertices) > 500
    assert _mean_nn(mesh.vertices, ref.vertices) <= voxel
    post = tmesh.load_mesh_ply(os.path.join(ours, "fuse_post.ply"))
    assert 0 < len(post.vertices) <= len(mesh.vertices)
    assert np.abs(np.linalg.norm(post.vertices, axis=1) - 1).mean() <= voxel
    for split, n in (("train", 8), ("test", 2)):
        for i in range(n):
            a = _png(os.path.join(model, split, "ours_7", "renders", f"{i:05d}.png"))
            b = _png(os.path.join(jmodel, split, "ours_7", "renders", f"{i:05d}.png"))
            assert np.abs(a - b).max() <= np.ceil(6e-3 * 255), (split, i)
    # over 2 device slots (Gaussian-sharded renders), the fusion on slot 0's
    render_cli.main(["-m", model, "--device", "cpu", "--skip_train", "--skip_test",
                     "--n_devices", "2", "--shard_mode", "gaussian"] + mesh_args)
    sharded = tmesh.load_mesh_ply(os.path.join(ours, "fuse.ply"))
    assert _mean_nn(sharded.vertices, mesh.vertices) <= 0.1 * voxel
    render_cli.main(["-m", model, "--device", "cpu", "--skip_train", "--skip_test",
                     "--unbounded", "--mesh_res", "64"])
    for name in ("fuse_unbounded.ply", "fuse_unbounded_post.ply"):
        m = tmesh.load_mesh_ply(os.path.join(ours, name))
        assert len(m.vertices) > 500 and np.isfinite(m.vertices).all(), name


def test_turbo_table_matches_matplotlib(rng):
    import matplotlib
    x = np.concatenate([np.linspace(0, 1, 4097), rng.random(1000)])
    for a in (x, x.astype(np.float32)):
        np.testing.assert_array_equal(ttraj.turbo(a), matplotlib.colormaps["turbo"](a)[..., :3])


def test_render_path_without_cv2_writes_the_three_videos(tmp_path, rng, monkeypatch):
    """With cv2 unimportable, --render_path writes the three videos, 240
    I-VOPs each; each one equals to the byte the video re-encoded from the
    files export_image wrote (chip_smoke.py's check on the card)."""
    import chip_smoke
    from gaussmart_tpu_torch.io import video
    model, _ = sphere_model_dir(str(tmp_path), rng, n=200)
    monkeypatch.setitem(sys.modules, "cv2", None)      # import cv2 fails
    render_cli.main(["-m", model, "--device", "cpu", "--skip_mesh", "--skip_train",
                     "--skip_test", "--render_path"])
    traj = os.path.join(model, "traj", "ours_7")
    sources = chip_smoke.traj_frames(traj)
    for name in chip_smoke.VIDEO_NAMES:
        info = video.read_mp4_info(os.path.join(traj, name))
        assert (info["n_samples"], info["fps"], info["width"], info["height"]) == (
            240, 30, W, H), name
        with open(os.path.join(traj, name), "rb") as f:
            assert f.read() == video.video_bytes(sources[name]), name
