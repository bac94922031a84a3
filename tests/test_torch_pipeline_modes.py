"""The port's modes 1-7 through ``pipeline/modes.py`` against the JAX
package's, on one tiny workspace with one set of view-space files: the
novel sets, the size test and the coverage sets (modes 1-3), a NeRF per
coverage count, one at a time and in batches over a two-device CPU mesh
(mode 4), the labels, their statistics and the PRVNet dataset (modes 5-6),
and the budget comparison (mode 7).

Both packages render the same coverage sets and train each field from
seed 0, but from their own random streams (``torch.Generator`` against
``jax.random``), so the metrics they write agree within a training's
spread, not to rounding: at this size measured up to 1.09 dB PSNR and
0.014 SSIM apart over the six fields of both batch sizes."""

import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from nerf_prv_tpu.core.config import CameraConfig as JCameraConfig
from nerf_prv_tpu.core.config import Config as JConfig
from nerf_prv_tpu.nerf import model as jm
from nerf_prv_tpu.pipeline import compare as jcompare
from nerf_prv_tpu.pipeline import modes as jmodes
from nerf_prv_tpu.scene import save_ply_binary
from nerf_prv_tpu.viewspace import hemisphere as jhemi
from nerf_prv_tpu.nerf import api as japi
from nerf_prv_tpu_torch.core.config import CameraConfig, Config
from nerf_prv_tpu_torch.labeling import labels as tlab
from nerf_prv_tpu_torch.nerf import model as tm
from nerf_prv_tpu_torch.nerf.rays import load_dataset
from nerf_prv_tpu_torch.parallel import mesh as tmesh
from nerf_prv_tpu_torch.pipeline import compare as tcompare
from nerf_prv_tpu_torch.pipeline import modes as tmodes

from synthetic import make_object
from test_torch_labeling import CURVE_ATOL, X, _curves, _robust_labels

torch.set_num_threads(1)

CAM = dict(width=96, height=54, fx=68.7, fy=68.5, ppx=48.5, ppy=27.9, model=0)
# counts 3 and 5, then the 100-view set: with batch size 2 the last group
# holds one job and is padded to the mesh's two devices
COMMON = dict(name_of_pcd="toy0", num_of_views=60, coverage_view_num_max=5, coverage_view_num_add=2,
              evaluate=False)
COUNTS = (3, 5, 100)
NERF = dict(voxel_grid_size=12, n_steps=80, train_rays=256, train_warmup_steps=25)
# mode 7 at two budgets that mode 4 also trains, so that its metrics must
# equal mode 4's to the last digit within each package
LABELS = {"toy0": 3}
STATS = {"mode": 3, "median": 5, "mean": 5}
PREDICTIONS = {"toy0": 5}
# one field trained by each package from its own random stream (see the
# module docstring): measured 1.09 dB / 0.014 apart at most
PSNR_DB = 2.0
SSIM_TOL = 0.03
# each field must learn: its PSNR above an all-black frame's
LEARN_DB = 3.0
# path lengths: float64 local paths over the same view-space files
# (tests/test_torch_pipeline.py)
MOVE_RTOL = 1e-5


def _metrics(path):
    return {k: float(v) for k, v in (line.split() for line in open(path).read().splitlines())}


def _black_psnr(test_json):
    ds = load_dataset(test_json)
    gt = ds.pixels[..., :3] * ds.pixels[..., 3:4]
    return float(np.mean([-10.0 * np.log10(np.mean(f ** 2)) for f in gt]))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """One object, the view-space files written once by the reference's
    generator, and the JAX package's mode 4 and mode 7 in its workspace."""
    root = tmp_path_factory.mktemp("modes")
    pts, cols = make_object(8000, seed=3)
    save_ply_binary(str(root / "models" / "ShapeNet" / "toy0.ply"), pts * 20, cols)
    common = dict(COMMON, model_path=str(root / "models"), viewspace_path=str(root / "viewspace"))
    for n in (*COUNTS, 60):
        jhemi.save_view_space(common["viewspace_path"], jhemi.generate_hemisphere(n, seed=n, restarts=2, steps=100))
    jcfg = JConfig(workspace=str(root / "jax"), camera=JCameraConfig(**CAM), **common)
    jmodes.mode_instant_ngp(jcfg, ["toy0"], nerf_cfg=jm.NerfConfig(**NERF))
    rows = jcompare.compare_objects(jcfg, ["toy0"], LABELS, nerf_cfg=jm.NerfConfig(**NERF), stat_budgets=STATS,
                                    predictions=PREDICTIONS)
    return dict(root=root, common=common, jcfg=jcfg, rows=rows)


def _port_cfg(reference, name):
    return Config(workspace=str(reference["root"] / name), camera=CameraConfig(**CAM), **reference["common"])


def _port_mode4(reference, batch_size):
    tcfg = _port_cfg(reference, f"port_b{batch_size}")
    kw = dict(batch_size=2, mesh=tmesh.make_mesh(("dp",), devices=["cpu", "cpu"])) if batch_size == 2 else {}
    tmodes.mode_instant_ngp(tcfg, ["toy0"], nerf_cfg=tm.NerfConfig(**NERF), device="cpu", **kw)
    return tcfg


@pytest.fixture(scope="module")
def port_b1(reference):
    """The port's mode 4 one field at a time, in its own workspace."""
    return _port_mode4(reference, 1)


@pytest.mark.parametrize("batch_size", [1, 2])
def test_mode4_metric_files_match_jax(request, reference, batch_size):
    """The same files in the object's folder, the coverage sets' PNGs and
    poses identical, and each count's metrics within a training's spread
    of JAX's, above a black frame; at batch size 2 over a two-device CPU
    mesh, the last group padded."""
    tcfg = request.getfixturevalue("port_b1") if batch_size == 1 else _port_mode4(reference, 2)
    jdir = reference["jcfg"].gt_path
    mode4 = lambda d: sorted(f for f in os.listdir(d) if not f.startswith("compare_"))  # noqa: E731
    assert mode4(tcfg.gt_path) == mode4(jdir)
    base = _black_psnr(os.path.join(tcfg.gt_path, "100.json"))
    for n in COUNTS:
        assert open(os.path.join(tcfg.gt_path, f"{n}.json")).read() == open(os.path.join(jdir, f"{n}.json")).read()
        for i in range(n):
            png = os.path.join(str(n), f"rgbaClip_{i}.png")
            np.testing.assert_array_equal(np.asarray(Image.open(os.path.join(tcfg.gt_path, png))),
                                          np.asarray(Image.open(os.path.join(jdir, png))))
        got, want = _metrics(os.path.join(tcfg.gt_path, f"{n}.txt")), _metrics(os.path.join(jdir, f"{n}.txt"))
        assert list(got) == list(want) == ["PSNR", "SSIM"]
        assert got["PSNR"] >= base + LEARN_DB, (n, got, base)
        assert abs(got["PSNR"] - want["PSNR"]) <= PSNR_DB, (n, got, want)
        assert abs(got["SSIM"] - want["SSIM"]) <= SSIM_TOL, (n, got, want)


def test_compare_objects_table_matches_jax(reference, port_b1):
    """Mode 7 with fixed predictions: the same budgets and path lengths as
    JAX's, metrics within a training's spread, each budget's metrics equal
    to its own package's mode-4 field of that count (same seed, same
    frames), and the table's budget and path columns equal to JAX's."""
    tcfg = port_b1  # mode 4's workspace: its coverage sets and metric files are there
    rows = tcompare.compare_objects(tcfg, ["toy0"], LABELS, nerf_cfg=tm.NerfConfig(**NERF), stat_budgets=STATS,
                                    predictions=PREDICTIONS, device="cpu")
    want = reference["rows"]
    assert set(rows) == set(want) == {"toy0"}
    got, ref = rows["toy0"], want["toy0"]
    assert set(got) == set(ref) == {"gt", "mode", "median", "mean", "prv"}
    for key in ref:
        assert got[key]["budget"] == ref[key]["budget"]
        assert got[key]["path_len"] == pytest.approx(ref[key]["path_len"], rel=MOVE_RTOL)
        assert abs(got[key]["PSNR"] - ref[key]["PSNR"]) <= PSNR_DB, (key, got[key], ref[key])
        assert abs(got[key]["SSIM"] - ref[key]["SSIM"]) <= SSIM_TOL, (key, got[key], ref[key])
    for cfg, entry in ((tcfg, got), (reference["jcfg"], ref)):
        for rec in entry.values():
            mode4 = _metrics(os.path.join(cfg.gt_path, f"{rec['budget']}.txt"))
            assert mode4 == pytest.approx({"PSNR": rec["PSNR"], "SSIM": rec["SSIM"]}, rel=1e-6)
    tab = [line.split("\t") for line in open(os.path.join(tcfg.workspace, "pvb_statistic_compare.txt"))]
    jtab = [line.split("\t") for line in open(os.path.join(reference["jcfg"].workspace,
                                                           "pvb_statistic_compare.txt"))]
    assert [r[0] for r in tab] == [r[0] for r in jtab] and tab[0] == jtab[0]
    for t, j in zip(tab[1:], jtab[1:]):
        assert t[1:3] == j[1:3] and t[9] == j[9]  # budget mean, std, n
        np.testing.assert_allclose(np.float64(t[7:9]), np.float64(j[7:9]), rtol=MOVE_RTOL, atol=1e-4)
        assert abs(float(t[3]) - float(j[3])) <= PSNR_DB and abs(float(t[5]) - float(j[5])) <= SSIM_TOL


def _tree(root):
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(root) for f in fs}


def test_modes_1_to_3_match_jax(reference):
    """Mode 1 on the JAX package's novel view files renders the same novel
    sets, PNG for PNG; mode 2 accepts the object at the same size; mode 3
    writes the same coverage sets."""
    jcfg = JConfig(workspace=str(reference["root"] / "jax13"), camera=JCameraConfig(**CAM), **reference["common"])
    tcfg = _port_cfg(reference, "port13")
    assert jmodes.mode_get_size_test(jcfg, ["toy0"]) == ["toy0"]
    assert tmodes.mode_get_size_test(tcfg, ["toy0"], device="cpu") == ["toy0"]
    size = "size.txt"
    assert open(os.path.join(tcfg.gt_path, size)).read() == open(os.path.join(jcfg.gt_path, size)).read()
    jmodes.mode_view_novel(jcfg, ["toy0"])
    os.makedirs(tcfg.workspace, exist_ok=True)
    for f in ("novel_train_views.txt", "novel_test_views.txt"):
        shutil.copy(os.path.join(jcfg.workspace, f), tcfg.workspace)
    tmodes.mode_view_novel(tcfg, ["toy0"], device="cpu")
    jmodes.mode_get_coverage(jcfg, ["toy0"])
    tmodes.mode_get_coverage(tcfg, ["toy0"], device="cpu")
    got, want = _tree(tcfg.gt_path), _tree(jcfg.gt_path)
    assert sorted(got) == sorted(want)
    subs = {name.split(os.sep)[0] for name in got if os.sep in name}
    assert subs == {"novel_train", "novel_test", *map(str, COUNTS)}
    for name in want:
        if name.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(os.path.join(tcfg.gt_path, name))),
                                          np.asarray(Image.open(os.path.join(jcfg.gt_path, name))))
        else:
            assert got[name] == want[name], name


def test_modes_5_6_labels_and_dataset_match_jax(tmp_path):
    """Mode 5 fits each object's metric files (noiseless lognormal curves on
    Fit_ShapeNet's 24 counts) as JAX's does: converged flags equal, curves
    within the labeling tests' 2e-4 dB, every label whose decision clears
    that tolerance equal.  On the same label files, mode 5's statistics and
    mode 6's dataset are byte-identical to JAX's."""
    names = [f"obj{i}" for i in range(6)]
    ys, tops = _curves(11, 0.0, b=len(names))
    jcfg, tcfg = JConfig(workspace=str(tmp_path / "jax")), Config(workspace=str(tmp_path / "port"))
    for cfg in (jcfg, tcfg):
        for name, y, top in zip(names, ys, tops):
            gt = cfg.replace(name_of_pcd=name).gt_path
            for v, psnr in zip(X.astype(int), y):
                japi.save_metrics(os.path.join(gt, f"{v}.txt"), {"PSNR": float(psnr), "SSIM": 0.9})
            japi.save_metrics(os.path.join(gt, "100.txt"), {"PSNR": float(top), "SSIM": 0.9})
    jmodes.mode_fit_labels(jcfg, names)
    tmodes.mode_fit_labels(tcfg, names, device="cpu")
    for name, top in zip(names, tops):
        jpath = os.path.join(jcfg.replace(name_of_pcd=name).gt_path, "label.txt")
        tpath = os.path.join(tcfg.replace(name_of_pcd=name).gt_path, "label.txt")
        want, got = tlab.parse_label_file(jpath), tlab.parse_label_file(tpath)
        assert got.converged == want.converged
        np.testing.assert_allclose(got.curve, want.curve, rtol=0, atol=CURVE_ATOL[0.0])
        gap, grad = _robust_labels(want.curve.astype(np.float64), top)
        np.testing.assert_array_equal(got.gap_labels[gap], want.gap_labels[gap])
        np.testing.assert_array_equal(got.gradient_labels[grad], want.gradient_labels[grad])
        shutil.copy(jpath, tpath)  # from here on both read the same labels
    assert tmodes.mode_read_label(tcfg, names) == jmodes.mode_read_label(jcfg, names)
    assert tmodes.mode_get_dataset(tcfg, names) == jmodes.mode_get_dataset(jcfg, names)
    got, want = _tree(tcfg.workspace), _tree(jcfg.workspace)
    assert {k for k in got if not k.startswith("Coverage_images")} == {k for k in want if not k.startswith(
        "Coverage_images")}
    for k in want:
        assert got[k] == want[k], k
