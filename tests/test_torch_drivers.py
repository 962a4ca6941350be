"""The benchmark drivers on the port against the repo's JAX drivers: each
twin's command list (default flags and each --skip_*) equals the JAX
driver's after the package rename, read in process from scripts/*.py with
scripts.driver_common's run_jobs and sh patched to record; the port's
three flags; the summary against the pandas one on the same results.json
files; and one whole DTU-mesh chain at 30 iterations on the CPU (train,
bounded mesh, mask cull and Chamfer), with a failing job failing the
driver."""
import json
import os
import runpy
import sys

import numpy as np
import pytest
import scipy.io
import torch

from gaussmart_tpu_torch.io.ply import store_point_cloud
from gaussmart_tpu_torch.io.images import write_png
from gaussmart_tpu_torch.scripts import (driver_common, dtu_eval, dtu_eval_mesh, m360_eval,
                                         nerf_eval, summary, tnt_eval)
from test_torch_semantics import _dtu_scan, _ring_c2w

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import scripts.driver_common as jax_driver_common  # noqa: E402

DRIVERS = {
    "dtu_eval": (dtu_eval, ["--dtu", "/data/dtu"]),
    "dtu_eval_mesh": (dtu_eval_mesh, ["--dtu", "/data/dtu", "--DTU_Official", "/data/gt"]),
    "m360_eval": (m360_eval, ["--m360", "/data/m360"]),
    "nerf_eval": (nerf_eval, ["--nerf", "/data/nerf"]),
    "tnt_eval": (tnt_eval, ["--TNT_data", "/data/tnt", "--TNT_GT", "/data/tnt_gt"]),
}
SKIPS = [[], ["--skip_training"], ["--skip_rendering"], ["--skip_metrics"]]


def _jax_stages(monkeypatch, name, argv):
    """The JAX driver's jobs in call order: one stage per run_jobs call,
    one per sh call."""
    stages = []
    monkeypatch.setattr(jax_driver_common, "run_jobs",
                        lambda cmds, max_workers=None: stages.append(list(cmds)))
    monkeypatch.setattr(jax_driver_common, "sh", lambda cmd: stages.append([cmd]) or 0)
    path = os.path.join(REPO, "scripts", f"{name}.py")
    monkeypatch.setattr(sys, "argv", [path, *argv])
    runpy.run_path(path, run_name="__main__")
    return stages


def _renamed(stages):
    """-m gaussmart_tpu.X -> -m gaussmart_tpu_torch.X; the cull's output
    directory, which each driver puts beside itself."""
    here = os.path.join(REPO, "scripts", "tmp")
    there = os.path.join(os.path.dirname(os.path.abspath(dtu_eval_mesh.__file__)), "tmp")
    return [[c.replace("-m gaussmart_tpu.", "-m gaussmart_tpu_torch.").replace(here, there)
             for c in stage] for stage in stages]


@pytest.mark.parametrize("skip", SKIPS, ids=["default", "skip_training", "skip_rendering",
                                             "skip_metrics"])
@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_commands_equal_the_jax_drivers(monkeypatch, name, skip):
    module, roots = DRIVERS[name]
    argv = [*roots, "--output_path", "/out", *skip]
    ref = _renamed(_jax_stages(monkeypatch, name, argv))
    got = module.commands(module.build_parser().parse_args(argv))
    assert got == ref
    assert sum(map(len, got)) > 0 and all("gaussmart_tpu_torch." in c for s in got for c in s)


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_the_port_flags(name):
    module, roots = DRIVERS[name]
    default = module.commands(module.build_parser().parse_args([*roots]))
    scenes = module.build_parser().parse_args([*roots]).scenes
    pick = [scenes[-1], scenes[0]]
    stages = module.commands(module.build_parser().parse_args(
        [*roots, "--iterations", "30", "--device", "cpu", "--scenes", ",".join(pick)]))
    cmds = [c for s in stages for c in s]
    def clis(stages_):
        return {c.split()[2] for s in stages_ for c in s}
    assert clis(stages) == clis(default)
    assert "30000" not in " ".join(cmds)
    for c in cmds:
        words = c.split()
        named = [s for s in scenes if f"/{s} " in c + " " or f"/{s}/" in c]
        assert set(named) <= set(pick) and named, c
        if "gaussmart_tpu_torch.train" in c:
            assert c.endswith(" --iterations 30 --device cpu")
        elif "render_cli" in c:
            assert c.endswith(" --device cpu")
            assert "--iteration" not in words or words[words.index("--iteration") + 1] == "30"
        elif "metrics_cli" in c:
            assert c.endswith(" --device cpu")
            assert c.index(f"/{pick[0]}") < c.index(f"/{pick[1]}")
        else:       # eval.cull, eval.tnt_fscore: on the host, no --device
            assert "--device" not in words and "ours_30/" in c
    with pytest.raises(SystemExit):
        module.build_parser().parse_args([*roots, "--scenes", "nowhere"])


def _write_results(root, scenes):
    for scene, res in scenes.items():
        os.makedirs(root / scene)
        with open(root / scene / "results.json", "w") as f:
            json.dump(res, f)


@pytest.mark.parametrize("case", ["no_lpips", "mixed"])
def test_summary_equals_the_pandas_summary(tmp_path, monkeypatch, capsys, case):
    import pandas as pd
    lp = (lambda v: None) if case == "no_lpips" else (lambda v: v)
    _write_results(tmp_path, {
        "scan24": {"ours_30000": {"SSIM": 0.91, "PSNR": 31.25, "LPIPS": lp(0.12)},
                   "ours_7000": {"SSIM": 0.85, "PSNR": 28.5, "LPIPS": None}},
        "scan37": {"ours_30000": {"SSIM": 0.875, "PSNR": 29.0, "LPIPS": lp(0.2)}},
        "lego": {"ours_30000": {"SSIM": 0.97, "PSNR": 35.125, "LPIPS": None,
                                "note": "white"}}})
    frames = []

    class Recorded(pd.DataFrame):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            frames.append(self)
    monkeypatch.setattr(pd, "DataFrame", Recorded)
    path = os.path.join(REPO, "scripts", "summary.py")
    monkeypatch.setattr(sys, "argv", [path, "--root", str(tmp_path)])
    runpy.run_path(path, run_name="__main__")
    monkeypatch.undo()
    df = pd.DataFrame(frames[0])
    ref_means = df.select_dtypes("number").mean().to_dict()

    rows, means = summary.main(["--root", str(tmp_path)])
    out = capsys.readouterr().out
    assert list(df.columns) == summary.collect(str(tmp_path))[1]
    ref_rows = [{k: (None if isinstance(v, float) and np.isnan(v) else v) for k, v in r.items()}
                for r in df.to_dict("records")]
    got_rows = [{c: r.get(c) for c in df.columns} for r in rows]
    assert got_rows == ref_rows
    assert means.keys() == ref_means.keys()
    for k, v in ref_means.items():
        assert means[k] == pytest.approx(v, rel=1e-12, abs=0), k
    assert ("LPIPS" in means) == (case == "mixed")
    assert "averages:" in out and "scan24" in out


def _dtu_official(root, scan, pts):
    """The official DTU ground truth layout eval.cull reads: ObsMask (all
    observed over the cloud's box), the ground plane (everything above)
    and the STL points."""
    os.makedirs(root / "ObsMask")
    lo, hi = pts.min(0) - 1.0, pts.max(0) + 1.0
    res = 0.1
    dims = np.ceil((hi - lo) / res).astype(int) + 1
    scipy.io.savemat(root / "ObsMask" / f"ObsMask{scan}_10.mat",
                     {"ObsMask": np.ones(dims, np.uint8), "BB": np.stack([lo, hi]),
                      "Res": np.array([[res]])})
    scipy.io.savemat(root / "ObsMask" / f"Plane{scan}.mat",
                     {"P": np.array([[0.0], [0.0], [0.0], [1.0]])})
    store_point_cloud(str(root / "Points" / "stl" / f"stl{scan:03d}_total.ply"), pts,
                      np.full((len(pts), 3), 128.0))


def test_dtu_mesh_chain_on_the_cpu(tmp_path, monkeypatch, rng):
    """dtu_eval_mesh --scenes scan24 --iterations 30 --device cpu end to end:
    the scan of the semantics tests (COLMAP model for the Scene), its
    cameras.npz in the IDR layout the cull reads (world_mat = K [R|t] at
    DTU's 1600x1200, with scale_mat) and masks, as in test_torch_eval's
    cull test; the bounded TSDF held to 2M voxels on the CPU."""
    dtu, gt = tmp_path / "dtu", tmp_path / "gt"
    scan = dtu / "scan24"
    os.makedirs(dtu)
    _dtu_scan(scan, rng)
    scale = np.diag([1.0, 1.0, 1.0, 1.0])
    K = np.array([[1500.0, 0, 800, 0], [0, 1500, 600, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    mats = {}
    os.makedirs(scan / "mask")
    for i in range(8):
        w2c = np.linalg.inv(_ring_c2w(0.35 * i, 3.0))
        mats[f"world_mat_{i}"] = K @ w2c @ np.linalg.inv(scale)
        mats[f"scale_mat_{i}"] = scale
        mask = np.zeros((48, 64), np.uint8)
        mask[4:44, 6:58] = 255
        write_png(str(scan / "mask" / f"{i:03d}.png"), mask)
    np.savez(scan / "cameras.npz", **mats)
    from gaussmart_tpu_torch.io.ply import fetch_point_cloud
    pts, _, _ = fetch_point_cloud(str(scan / "points.ply"))
    _dtu_official(gt, 24, pts.astype(np.float64))

    culled = tmp_path / "culled"
    monkeypatch.setattr(dtu_eval_mesh, "cull_dir", lambda scan_id: str(culled / scan_id))
    monkeypatch.setenv("GAUSSMART_TSDF_MAX_VOXELS", "2000000")
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "eval"
    argv = ["--dtu", str(dtu), "--DTU_Official", str(gt), "--output_path", str(out),
            "--scenes", "scan24", "--iterations", "30", "--device", "cpu"]
    assert dtu_eval_mesh.main(argv) == 0
    assert os.path.exists(out / "scan24" / "point_cloud" / "iteration_30" / "point_cloud.ply")
    assert os.path.exists(out / "scan24" / "train" / "ours_30" / "fuse_post.ply")
    assert os.path.exists(culled / "24" / "culled_mesh.ply")
    with open(culled / "24" / "results.json") as f:
        res = json.load(f)
    assert all(np.isfinite(res[k]) for k in ("mean_d2s", "mean_s2d", "overall")), res
    print(f"dtu_eval_mesh chain on the CPU: {res}")

    # a job that fails fails the driver (the chain goes on, as in the JAX drivers)
    argv_bad = [*argv[:2], "--DTU_Official", str(tmp_path / "missing"), *argv[4:],
                "--skip_training", "--skip_rendering"]
    assert dtu_eval_mesh.main(argv_bad) == 1
    assert driver_common.run_jobs(["exit 3", "true"]) == ["exit 3"]
