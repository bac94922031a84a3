"""The port's production label protocol on the two textured meshes
(``nerf_prv_tpu_torch/experiments/real_object.py``, ``check_real_object.py``)
and over ten family objects (``production10.py``) against the JAX package's
``experiments/exp_real_object.py`` and ``exp_production10.py``: the mesh
writers' bytes, L0's PLY bytes at the runs' own 300,000 points, the fit of
the committed PSNRs against the committed calibrations and JAX's fit, the
pinned-count guard, and tiny runs of each entry point on the CPU."""

import dataclasses
import importlib
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from nerf_prv_tpu.labeling import labels as jlabels
from nerf_prv_tpu.scene import mesh_sampling as jms
from nerf_prv_tpu_torch.core.config import CameraConfig
from nerf_prv_tpu_torch.experiments import check_real_object as cro
from nerf_prv_tpu_torch.experiments import production10 as p10
from nerf_prv_tpu_torch.experiments import real_object as ro
from nerf_prv_tpu_torch.labeling.stats import N_GRADIENTS
from nerf_prv_tpu_torch.nerf.api import load_metrics
from nerf_prv_tpu_torch.nerf.model import NerfConfig
from nerf_prv_tpu_torch.pipeline import cli as tcli
from nerf_prv_tpu_torch.scene import ply as tply
from nerf_prv_tpu_torch.viewspace.hemisphere import save_view_space

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "experiments"))
jreal = importlib.import_module("exp_real_object")  # numpy at import; JAX inside main() only

# phase 11d's card-against-CPU limit on a fitted curve; the fit here reads the
# committed PSNRs rounded to 3 decimals, so the limit against the committed
# curve adds what that rounding moves the curve by (``_rounding_spread``):
# measured 1.2e-3 dB on the torus's 24 counts and about 1.6e-2 dB on the
# knot's 8, whose lone 3-view point leaves the curve's head loosely held
CURVE_DB = 4e-3
# the port's fit against JAX's on the same files (tests/test_torch_labeling.py's
# CURVE_ATOL and DIFF_ATOL): curves of noisy samples within 4e-3 dB, their view-to-view
# differences (the gradient label's input) within 1e-3
JAX_CURVE_DB = 4e-3
JAX_DIFF_DB = 1e-3
TINY_CAM = CameraConfig(width=40, height=24, fx=28.6, fy=28.5, ppx=20.2, ppy=11.6, model=2, k1=0.12, k2=-0.21)
TINY_NERF = NerfConfig(voxel_grid_size=12, n_steps=20, train_rays=256, train_warmup_steps=10)


def _stand_in_540(viewspace):
    """A 540-view file the label protocol does not read (``load_object``
    builds the object's view space from it), so that no Riesz descent of 540
    points runs here."""
    z = np.linspace(0.0, 1.0, 540, endpoint=False)
    a = np.arange(540) * 2.399963229728653
    r = np.sqrt(1.0 - z * z)
    save_view_space(viewspace, np.stack([r * np.cos(a), r * np.sin(a), z], 1))


def _rounding_spread(counts, psnrs, max_psnr) -> float:
    """The most the port's fitted curve moves when each PSNR moves within
    its rounding (±5e-4 dB): 32 seeded draws of the signs."""
    from nerf_prv_tpu_torch.labeling.labels import fit_objects

    rng = np.random.default_rng(0)
    draws = np.asarray(psnrs)[None] + 5e-4 * rng.choice([-1.0, 1.0], size=(32, len(psnrs)))
    base = fit_objects(counts, np.asarray(psnrs)[None], np.array([max_psnr]), device="cpu")[0].curve
    fits = fit_objects(counts, draws, np.full(32, max_psnr), device="cpu")
    return max(float(np.abs(np.asarray(f.curve) - np.asarray(base)).max()) for f in fits)


def _write_metrics(gt, psnrs: dict):
    os.makedirs(gt, exist_ok=True)
    for v, p in psnrs.items():
        with open(os.path.join(gt, f"{v}.txt"), "w") as f:
            f.write(f"PSNR\t{p}\nSSIM\t0.9")


@pytest.mark.parametrize("kind", ro.KINDS)
def test_mesh_writers_write_the_jax_bytes(tmp_path, kind):
    """The OBJ, MTL and PNG texture of each mesh equal the JAX script's
    byte for byte."""
    jgen = {"torus": jreal.write_textured_torus, "knot": jreal.write_textured_knot}[kind]
    got = ro.WRITERS[kind](str(tmp_path / "port"))
    want = jgen(str(tmp_path / "jax"))
    assert os.path.basename(got) == os.path.basename(want) == "model.obj"
    for name in ("model.obj", "model.mtl", "tex.png"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name


@pytest.mark.parametrize("kind", ro.KINDS)
def test_sampled_ply_equals_jax(tmp_path, kind):
    """L0 at the runs' own size (300,000 points thinned on a 512³ grid,
    textures required) writes the JAX package's PLY bytes."""
    got = ro.sample_object(kind, str(tmp_path / "port"))
    obj = {"torus": jreal.write_textured_torus, "knot": jreal.write_textured_knot}[kind](str(tmp_path / "jax"))
    want = str(tmp_path / "jax.ply")
    assert jms.sample_and_voxelize(obj, want, n_points=300_000, grid_resolution=512, require_texture=True)
    assert os.path.basename(got) == f"{kind}0.ply"
    assert open(got, "rb").read() == open(want, "rb").read()
    pts, cols = tply.load_ply(got)
    assert 100_000 < len(pts) < 300_000 and len(np.unique(cols, axis=0)) > 100  # thinned, texture-coloured


@pytest.mark.parametrize("kind", ro.KINDS)
def test_fit_of_the_committed_psnrs_reproduces_the_committed_calibration(tmp_path, kind):
    """From the committed run's PSNRs, the port's fit gives the committed
    label and flags (torus 20 converged, knot 24 not) and curve within
    ``CURVE_DB`` plus what the PSNRs' rounding moves it by, and JAX's fit on
    the same files within ``JAX_CURVE_DB`` (differences ``JAX_DIFF_DB``)."""
    ref = ro.committed(kind)
    _write_metrics(str(tmp_path), {**dict(zip(ref["view_counts"], ref["measured_psnr"])), 100: ref["max_psnr_100"]})
    got = ro.fit_artifact(str(tmp_path), ref["view_counts"], "cpu")
    assert sorted(got) == sorted(ref)
    for key in ("converged", "view_counts", "measured_psnr", "max_psnr_100", "gradient_label_0.02",
                "label_in_clip_window", "curve_monotone", "curve_diminishing_returns"):
        assert got[key] == ref[key], key
    assert (got["gradient_label_0.02"], got["converged"]) == {"torus": (20, True), "knot": (24, False)}[kind]
    spread = _rounding_spread(ref["view_counts"], ref["measured_psnr"], ref["max_psnr_100"])
    assert spread < {"torus": 2e-3, "knot": 3e-2}[kind]
    np.testing.assert_allclose(got["fitted_curve_3_100"], ref["fitted_curve_3_100"], rtol=0,
                               atol=CURVE_DB + spread + 5e-4)  # + the curve's own rounding
    assert open(tmp_path / "label.txt").read().startswith("Converged")
    want = jlabels.fit_object_from_metrics(str(tmp_path), view_counts=ref["view_counts"])
    port = ro.fit_object_from_metrics(str(tmp_path), view_counts=ref["view_counts"], device="cpu")
    np.testing.assert_allclose(np.asarray(port.curve), np.asarray(want.curve), rtol=0, atol=JAX_CURVE_DB)
    np.testing.assert_allclose(np.diff(port.curve), np.diff(want.curve), rtol=0, atol=JAX_DIFF_DB)
    assert int(want.gradient_labels[1]) == ref["gradient_label_0.02"] and bool(want.converged) == ref["converged"]
    assert ro.shape_flags(np.asarray(want.curve)) == (ref["curve_monotone"], ref["curve_diminishing_returns"])


def test_pinned_count_off_the_sweep_is_refused_before_any_training(tmp_path):
    """A pinned count neither on the step/max grid nor on disk raises before
    anything is written; one already scored on disk passes the guard."""
    root = str(tmp_path / "torus")
    with pytest.raises(ValueError, match=r"\[4\]"):
        ro.run_real_object("torus", root, counts=[3, 4, 5], step=2, cmax=9, device="cpu")
    assert not os.path.exists(root)
    cfg = ro.real_object_config("torus", root, 2, 9)
    ro.check_pinned(cfg, [3, 5, 9])
    _write_metrics(cfg.gt_path, {4: 20.0})
    ro.check_pinned(cfg, [3, 4, 5])
    with pytest.raises(ValueError):
        ro.check_pinned(cfg, [3, 4, 5], seed=1)  # a seed's own workspace has no 4.txt


def test_run_real_object_tiny_writes_every_artifact_key(tmp_path, monkeypatch):
    """The whole chain on the CPU at a cut size (a 40x24 model-2 camera,
    20,000 points, 20-step grid-12 fields): the artifact has the committed
    run's keys, the anchor and each count are scored, a second NeRF seed
    trains in a workspace of its own, and a rerun resumes from the files."""
    real_cfg = ro.real_object_config
    monkeypatch.setattr(ro, "real_object_config", lambda *a, **k: real_cfg(*a, **k).replace(camera=TINY_CAM))
    monkeypatch.setattr(ro, "N_POINTS", 20_000)
    monkeypatch.setattr(ro, "GRID_RESOLUTION", 128)
    root = str(tmp_path / "knot")
    _stand_in_540(os.path.join(root, "ws", "viewspace"))
    art, walls = ro.run_real_object("knot", root, step=6, cmax=9, device="cpu", nerf_cfg=TINY_NERF)
    assert sorted(art) == sorted(ro.committed("knot"))
    assert art["view_counts"] == [3, 9] and len(art["fitted_curve_3_100"]) == 98
    assert all(np.isfinite(art["measured_psnr"])) and np.isfinite(art["max_psnr_100"])
    assert set(walls) == {"sample and mode 0", "mode 3", "mode 4 anchor", "mode 4 sweep"}
    vs = os.path.join(root, "ws", "viewspace")
    assert open(os.path.join(vs, "9.txt")).read() == open(os.path.join(ro.PRODUCTION_DIR, "9.txt")).read()
    assert open(os.path.join(vs, "5.txt")).read() == open(os.path.join(ro.VIEWSPACE_DIR, "probe", "5.txt")).read()
    gt = ro.real_object_config("knot", root, 6, 9).gt_path
    assert round(load_metrics(os.path.join(gt, "9.txt"))["PSNR"], 3) == art["measured_psnr"][1]
    mtime = os.path.getmtime(os.path.join(gt, "9.txt"))
    again, _ = ro.run_real_object("knot", root, counts=[3, 9], step=6, cmax=9, device="cpu", nerf_cfg=TINY_NERF)
    assert again == art and os.path.getmtime(os.path.join(gt, "9.txt")) == mtime
    seeded, _ = ro.run_real_object("knot", root, step=6, cmax=9, seed=1, device="cpu", nerf_cfg=TINY_NERF)
    assert os.path.exists(os.path.join(root, "ws_seed1")) and seeded["view_counts"] == [3, 9]


def test_check_real_object_limits_and_summary():
    """The check's limits (each count's seed range widened by the largest
    one; the label range widened by a view), its comparison by count and
    its summary on made-up runs."""
    ref = dict(view_counts=[3, 9], measured_psnr=[17.0, 23.0], max_psnr_100=24.0)
    ref = {**ref, "gradient_label_0.02": 24, "converged": False, "fitted_curve_3_100": [17.0] * 97 + [24.3],
           "curve_monotone": True, "curve_diminishing_returns": True}
    runs = {s: {**ref, "measured_psnr": [17.0 + d, 23.2 + d], "max_psnr_100": 24.1 + d, "gradient_label_0.02": 24 + s,
                "converged": True} for s, d in ((0, 0.0), (1, 0.1), (2, 0.3))}
    lim = cro.seed_limits(runs, (0, 1, 2))
    assert lim["widen_db"] == pytest.approx(0.3) and lim["label"] == [23, 27]
    assert lim["psnr"]["3"] == pytest.approx([16.7, 17.6]) and lim["psnr"]["100"] == pytest.approx([23.8, 24.7])
    comp = cro.compare_run(runs[2], ref)
    assert comp["psnr_diff_db"] == {"3": 0.3, "9": 0.5, "100": 0.4}
    assert comp["committed_margins"]["tail_minus_max_db"] == pytest.approx(0.3)
    assert comp["committed_margins"]["sample_minus_max_db"] == pytest.approx(-1.0)
    summ = cro.summarize(runs, ref, lim, (0, 1, 2))
    assert summ["n_counts"] == 3 and summ["n_within"] == 3 and summ["label_within"]
    assert summ["sign_test"]["n_pos"] == 3 and summ["offset_db"] == pytest.approx((0.1333 + 0.3333 + 0.2333) / 3,
                                                                                 abs=1e-3)


def test_check_real_object_main_tiny(tmp_path, monkeypatch):
    """The check's ``main`` on the CPU at a cut size, its jobs in this
    process: fields, fits, limits, comparison and summary written; a second
    call restores the first's fields from the result file and trains none."""
    real_cfg = ro.real_object_config
    monkeypatch.setattr(cro, "real_object_config", lambda *a, **k: real_cfg(*a, **k).replace(camera=TINY_CAM))
    monkeypatch.setattr(ro, "real_object_config", cro.real_object_config)
    monkeypatch.setattr(ro, "N_POINTS", 20_000)
    monkeypatch.setattr(ro, "GRID_RESOLUTION", 128)
    monkeypatch.setattr(cro, "SWEEPS", {"torus": (12, 15), "knot": (6, 9)})
    monkeypatch.setattr(cro, "nerf_config", lambda: TINY_NERF)
    monkeypatch.setattr(cro, "SEEDS", (0, 1))
    monkeypatch.setattr(cro, "run_jobs", lambda fn, jobs, workers: (fn(j) for j in jobs))
    monkeypatch.setattr(cro, "LOG_DIR", str(tmp_path / "log_dir"))
    root, out, log = str(tmp_path / "ws"), str(tmp_path / "check.json"), str(tmp_path / "check.log")
    _stand_in_540(os.path.join(root, "knot", "ws", "viewspace"))
    argv = ["--device", "cpu", "--workers", "2", "--objects", "knot", "--root", root, "--out", out, "--log", log]
    assert cro.main(argv) == 0
    assert os.path.exists(tmp_path / "log_dir" / "check.json")
    res = json.load(open(out))
    assert set(res["fields"]) == {"knot@0", "knot@1"} and set(res["fields"]["knot@0"]) == {"3", "9", "100"}
    assert res["limits"]["knot"]["label"][1] - res["limits"]["knot"]["label"][0] >= 2
    assert set(res["summary"]["knot"]) >= {"n_within", "label_within", "offset_db", "sign_test"}
    assert set(res["comparison"]["knot"]) == {"0", "1"}
    text = open(log).read()
    assert text.index("LIMITS written before the comparison") < text.index("knot seed 0: label")
    import shutil

    shutil.rmtree(root)
    _stand_in_540(os.path.join(root, "knot", "ws", "viewspace"))
    assert cro.main(argv) == 0
    again = json.load(open(out))
    assert len(again["calls"]) == 2 and again["calls"][1]["n_fields"] == 0
    assert again["runs"]["knot@1"]["measured_psnr"] == res["runs"]["knot@1"]["measured_psnr"]


def test_production10_tiny_writes_the_jax_keys(tmp_path, monkeypatch):
    """``production10`` on the CPU at a cut size (a 40x24 camera, counts 3,
    5, 7 + 100, 10-step fields): one object alone, then one under worker
    sharing (its jobs in this process) in a second call that keeps the
    first's object; the result has the JAX script's keys, mode 5's table
    over both objects, and the seconds a unit of the object run alone."""
    real_cfg = p10.production_config
    monkeypatch.setattr(p10, "production_config", lambda root: real_cfg(root).replace(
        camera=TINY_CAM, coverage_view_num_max=7, n_steps=10))
    monkeypatch.setattr(p10, "nerf_config", lambda cfg: dataclasses.replace(TINY_NERF, n_steps=cfg.n_steps))
    monkeypatch.setattr(p10, "run_jobs", lambda fn, jobs, workers: (fn(j) for j in jobs))
    monkeypatch.setattr(p10, "LOG_DIR", str(tmp_path / "log_dir"))
    root, out = str(tmp_path / "ws"), str(tmp_path / "production10.json")
    _stand_in_540(os.path.join(root, "ws", "viewspace"))
    common = ["--device", "cpu", "--root", root, "--out", out, "--log", str(tmp_path / "log")]
    assert p10.main(["--names", "uni5", "--workers", "1"] + common) == 0
    import shutil

    shutil.rmtree(root)  # a later call starts from an empty workspace
    _stand_in_540(os.path.join(root, "ws", "viewspace"))
    assert p10.main(["--names", "ell5", "--workers", "3"] + common) == 0
    res = json.load(open(out))
    src = open(os.path.join(REPO, "experiments", "exp_production10.py")).read()
    jax_keys = re.findall(r'^\s+"(\w+)": ', src[src.index("json.dump(_jsonable({"):], re.M)[:7]
    assert jax_keys == ["camera", "n_steps", "view_counts", "objects", "seconds", "median_s_per_protocol_unit",
                        "label_stats_mode5"]
    assert set(jax_keys) <= set(res) and res["view_counts"] == 4 and res["n_steps"] == 10
    assert set(res["objects"]) == {"uni5", "ell5"}
    assert res["seconds"]["uni5"]["workers"] == 1 and res["seconds"]["ell5"]["workers"] == 3
    assert set(res["s_per_protocol_unit_alone"]) == {"uni5"}
    assert set(res["seconds"]["ell5"]) >= {"total_s", "coverage_s", "ngp_sweep_s", "s_per_protocol_unit"}
    assert set(res["fields"]["uni5"]) == {"3", "5", "7", "100"}
    gradient = res["label_stats_mode5"]["gradient"]
    assert len(gradient) == N_GRADIENTS and {"value", "mean", "std", "fail_num", "min", "max", "distribution"} <= set(gradient[1])


def test_cli_sizes_pick_mode21_coverage_sets(monkeypatch):
    """``--sizes`` gives mode 21 its coverage sets (default: the reference's
    full space, 5..60 and 100)."""
    seen = []
    monkeypatch.setattr(tcli.modes, "mode_view_planning", lambda *a, **k: seen.append(k["coverage_sizes"]))
    assert tcli.main(["--mode", "21", "--method", "4", "--objects", "a", "--device", "cpu",
                      "--sizes", "540", "5", "100"]) == 0
    assert tcli.main(["--mode", "21", "--method", "4", "--objects", "a", "--device", "cpu"]) == 0
    assert seen == [[540, 5, 100], None]


def test_cpu_field_puts_the_torus_offset_before_the_port():
    """The committed record of ``tests/jax_reference_runs.py real-object``
    (the torus at 25 views, 2,500 steps, NeRF seeds 0 and 1, each package on
    the CPU from the same coverage sets): today's JAX package lies above the
    committed PSNR at each seed, and the port's seed mean on the CPU lies
    within the card's three-seed range at 25 views (``real_object_check.json``)
    of JAX's."""
    with open(os.path.join(os.path.dirname(ro.__file__), "results", "real_object_cpu.json")) as f:
        rec = json.load(f)
    with open(os.path.join(os.path.dirname(ro.__file__), "results", "real_object_check.json")) as f:
        check = json.load(f)
    ref = ro.committed("torus")
    assert rec["views"] == 25 and rec["committed"] == ref["measured_psnr"][ref["view_counts"].index(25)]
    assert all(r["PSNR"] > rec["committed"] for r in rec["jax_cpu"].values())
    mean = {k: np.mean([r["PSNR"] for r in rec[k].values()]) for k in ("jax_cpu", "port_cpu")}
    assert abs(mean["port_cpu"] - mean["jax_cpu"]) <= check["limits"]["torus"]["ranges_db"]["25"]
    assert rec["port_card"] == {s: check["fields"][f"torus@{s}"]["25"] for s in ("0", "1", "2")}
