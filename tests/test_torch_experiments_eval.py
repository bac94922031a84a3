"""The port's held-out evaluation (``nerf_prv_tpu_torch/experiments``:
``mode7_compare``, ``mode21_table``, ``predictor_gate``) against the JAX
package's experiments and committed artifacts: the shipped view-space
files, the roster, the summaries of the committed rows, the predictor
gate's decisions, the path lengths and movements at the protocol's camera,
a tiny mode 7 and mode 21 run through both packages, and the committed
records of the two packages' CPU runs (fields, cut-size trainers) that place
the card checks' misses."""

import copy
import importlib
import inspect
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from nerf_prv_tpu.core.config import CameraConfig as JCameraConfig
from nerf_prv_tpu.core.config import Config as JConfig
from nerf_prv_tpu.pipeline import compare as jcompare
from nerf_prv_tpu.pipeline import modes as jmodes
from nerf_prv_tpu.viewspace import hemisphere as jhemi
from nerf_prv_tpu_torch.core.config import CameraConfig
from nerf_prv_tpu_torch.experiments import check_mode7, families
from nerf_prv_tpu_torch.experiments import label_protocol as lp
from nerf_prv_tpu_torch.experiments import mode7_compare as m7
from nerf_prv_tpu_torch.experiments import mode21_table as m21
from nerf_prv_tpu_torch.experiments import predictor_gate as gate_mod
from nerf_prv_tpu_torch.experiments.predictor_gate import predictor_gate
from nerf_prv_tpu_torch.nerf.model import NerfConfig
from nerf_prv_tpu_torch.pipeline import compare as tcompare
from nerf_prv_tpu_torch.pipeline import modes as tmodes
from nerf_prv_tpu_torch.pipeline.compare import path_length_for_budget, stat_budgets_from_labels
from nerf_prv_tpu_torch.scene.object_setup import load_object

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "experiments"))
jfam = importlib.import_module("families")
jgate = importlib.import_module("predictor_gate")
jmode7 = importlib.import_module("exp_mode7_r4")
jmode21 = importlib.import_module("exp_mode21_r4")
ART = os.path.join(REPO, "experiments", "artifacts")
RESULTS = os.path.join(REPO, "nerf_prv_tpu_torch", "experiments", "results")

# the on-demand sizes the evaluation reads: every mode-7 budget and a spread
# of mode 21's 5..60 (each case runs the reference's 8 x 800-step descent)
ON_DEMAND_CASES = (6, 13, 25, 28, 29, 30, 32, 34, 40, 60)
# the budgets whose path lengths mode7_r4.json holds
PATH_BUDGETS = (23, 25, 27, 28, 29, 30, 32, 34)
# the committed path lengths were taken on the reference's own view-space
# files, which today's generator on the CPU does not reproduce bit for bit
# (ROADMAP section 3): measured 4.6e-6 relative at most, 4 decimals equal
COMMITTED_PATH_RTOL = 5e-6
PATH_RTOL = 1e-9  # exact on the same files; the committed values miss it
# a tiny field for the two packages' runs, and one training's spread between
# them (tests/test_torch_pipeline_modes.py)
TINY_NERF = dict(voxel_grid_size=12, n_steps=40, train_rays=256, train_warmup_steps=10)
TINY_CAM = dict(width=48, height=27, fx=34.3, fy=34.2, ppx=24.2, ppy=14.0, model=0)
PSNR_DB = 2.0
SSIM_TOL = 0.03
MOVE_RTOL = 1e-12  # float64 local paths over the same files on both sides


def _read(name):
    with open(os.path.join(ART, name)) as f:
        return json.load(f)


@pytest.mark.parametrize("n", ON_DEMAND_CASES)
def test_shipped_view_spaces_are_the_jax_generators(n):
    """The on-demand view spaces shipped for the evaluation
    (``viewspace/seed0``) are the JAX package's ``generate_hemisphere(n)``
    (seed 0, as its ``_ensure_viewspace`` writes them) byte for byte."""
    pts = jhemi.generate_hemisphere(n)
    want = "".join(f"{p[0]:.8g} {p[1]:.8g} {p[2]:.8g}\n" for p in pts)
    assert open(os.path.join(lp.ON_DEMAND_DIR, f"{n}.txt")).read() == want


def test_shipped_view_spaces_cover_every_size_the_evaluation_reads(tmp_path):
    """``seed0`` holds 5..60 less mode 0's sizes, and the installed
    workspace holds every size of 5..60, mode 0's from their own files."""
    mode0 = set(lp.fit_counts(lp.pipeline_config("r"))) | {5, 64, 100}
    on_demand = sorted(int(f[:-4]) for f in os.listdir(lp.ON_DEMAND_DIR))
    assert on_demand == sorted(set(range(5, 61)) - mode0)
    cfg = lp.pipeline_config(str(tmp_path))
    m7.install_eval_viewspace(cfg)
    for n in range(5, 61):
        got = open(os.path.join(cfg.viewspace_path, f"{n}.txt")).read()
        src = lp.VIEWSPACE_DIR if n in mode0 else lp.ON_DEMAND_DIR
        assert got == open(os.path.join(src, f"{n}.txt")).read()


def test_pick_objects_equals_jax_and_committed():
    want = jmode21.pick_objects(5)
    assert m21.pick_objects(5) == want == _read("mode21_r4.json")["objects"]
    assert m21.pick_objects(12) == jmode21.pick_objects(12)


def test_mode21_config_equals_jax():
    cfg = m21.mode21_config("r")
    want = jmode7.pipeline_config().replace(num_of_views=64, num_of_max_iteration=60, evaluate=True)
    assert (cfg.num_of_views, cfg.num_of_max_iteration, cfg.evaluate, cfg.n_steps) == (
        want.num_of_views, want.num_of_max_iteration, want.evaluate, want.n_steps) == (64, 60, True, 1200)
    assert vars(cfg.camera) == vars(want.camera)


def test_mode7_labels_and_summary_equal_jax_and_committed(tmp_path):
    """The labels and stat budgets read as the reference reads them, and
    ``summarize`` of the committed rows: what JAX's ``_flush`` writes and
    what ``mode7_r4.json`` holds."""
    ref = _read("mode7_r4.json")
    labels, val_labels, test = m7.corpus_labels()
    stats = stat_budgets_from_labels(val_labels)
    assert stats == jcompare.stat_budgets_from_labels(val_labels) == ref["stat_budgets"]
    assert sorted(test) == sorted(ref["rows"]) and len(val_labels) == ref["val_n"]
    assert all(ref["rows"][n]["gt"]["budget"] == labels[n] for n in test)
    assert m7.committed_predictions() == {n: e["prv"]["budget"] for n, e in ref["rows"].items()}
    got = m7.summarize(ref["rows"], stats, len(val_labels), len(test))
    path = str(tmp_path / "mode7.json")
    jmode7._flush(path, copy.deepcopy(ref["rows"]), stats, val_labels, len(test))
    with open(path) as f:
        want = json.load(f)
    assert json.loads(json.dumps(got)) == want
    assert {k: want[k] for k in ("summary", "deltas", "n_done", "n_roster", "val_n")} == {
        k: ref[k] for k in ("summary", "deltas", "n_done", "n_roster", "val_n")}


def test_mode21_summary_equals_jax_and_committed():
    ref = _read("mode21_r4.json")
    got = m21.summarize({"rows": copy.deepcopy(ref["rows"])})
    want = {"rows": copy.deepcopy(ref["rows"])}
    jmode21._summarize(want)
    assert got["summary"] == want["summary"] == ref["summary"]


@pytest.mark.parametrize("artifact,passes", [
    ("prvnet_tiny180.json", True), ("prvnet_r3.json", True), ("prvnet_tiny720_partial.json", False)])
def test_predictor_gate_decides_as_jax(monkeypatch, artifact, passes):
    """The same decision as the JAX gate on committed artifacts: the two
    trained predictors pass, the partial tiny@720 run (no correlation key)
    is refused; a missing file is refused too."""
    monkeypatch.delenv("PRV4_SKIP_PREDICTOR_GATE", raising=False)
    path = os.path.join(ART, artifact)
    if passes:
        assert predictor_gate(path) == jgate.predictor_gate(artifact) == _read(artifact)
    else:
        with pytest.raises(SystemExit):
            jgate.predictor_gate(artifact)
        with pytest.raises(SystemExit, match="degenerate"):
            predictor_gate(path)
    with pytest.raises(SystemExit, match="missing"):
        predictor_gate(path + ".absent")
    assert predictor_gate(path + ".absent", skip=True) == {}


def test_cpu_fields_put_the_psnr_offset_before_the_port():
    """The record behind ROADMAP section 3's PSNR offset (``fields_cpu.json``,
    ``tests/jax_reference_runs.py field`` / ``merge-fields``: one 1,200-step
    protocol field a package and NeRF seed on the CPU, from the same coverage
    sets).  At every (object, budget) pair today's JAX package scores above
    the committed ``mode7_r4.json`` value, and the port's seed mean lies
    within ``mode7_check.json``'s L_psnr of JAX's: the offset that
    ``check_mode7`` found lies between today's JAX package and the committed
    run, not in the port."""
    with open(os.path.join(RESULTS, "fields_cpu.json")) as f:
        fields = json.load(f)
    with open(os.path.join(RESULTS, "mode7_check.json")) as f:
        limit = json.load(f)["limit"]["L_psnr"]
    rows = _read("mode7_r4.json")["rows"]

    def mean(runs):
        return float(np.mean([r["PSNR"] for r in runs.values()]))

    assert len(fields["pairs"]) >= 6
    for key, e in fields["pairs"].items():
        name, budget = key.split("@")
        committed = next(r for r in rows[name].values() if r["budget"] == int(budget))["PSNR"]
        assert e["committed"]["PSNR"] == committed and set(e["jax_cpu"]) == set(e["port_cpu"]) == {"0", "1"}
        assert mean(e["jax_cpu"]) > committed, key
        assert abs(mean(e["port_cpu"]) - mean(e["jax_cpu"])) <= limit, key


def test_cpu_trainers_both_reach_and_miss_the_gate():
    """The record behind ROADMAP section 3's predictor collapse
    (``trainers_cpu.json``, ``tests/jax_reference_runs.py trainers`` /
    ``merge-trainers``: the tiny@180 recipe's two stages cut in size, by
    each package's trainer on the CPU, on the same corpus dataset).  Every
    run trained every regression epoch, its gate decision is the gate's
    (both packages' floors), and each trainer has seeds past the gate and
    seeds refused: the JAX trainer collapses to a constant predictor on
    some seeds too."""
    with open(os.path.join(RESULTS, "trainers_cpu.json")) as f:
        record = json.load(f)
    floors = inspect.signature(jgate.predictor_gate).parameters
    assert (floors["min_corr"].default, floors["min_span"].default) == (gate_mod.MIN_CORR, gate_mod.MIN_SPAN)
    for package in ("jax", "port"):
        entry = record["packages"][package]
        passed = set()
        for seed, run in entry["runs"].items():
            assert len(run["val_l1_by_epoch"]) == 150 and run["best_val_l1"] == min(run["val_l1_by_epoch"])
            lo, hi = run["val_pred_min_max"]
            if run["val_pred_gt_corr"] >= gate_mod.MIN_CORR and hi - lo >= gate_mod.MIN_SPAN:
                passed.add(seed)
        assert entry["n_seeds"] == len(entry["runs"]) >= 4
        assert set(entry["seeds_past_the_gate"]) == passed
        assert 0 < len(passed) < len(entry["runs"]), (package, passed)


def test_limit_and_sign_test_arithmetic():
    lim = check_mode7.seed_limit({"clu10": {0: dict(PSNR=30.0, SSIM=0.97), 1: dict(PSNR=30.2, SSIM=0.975),
                                            2: dict(PSNR=29.9, SSIM=0.972)},
                                  "uni11": {0: dict(PSNR=27.9, SSIM=0.97), 1: dict(PSNR=28.0, SSIM=0.97),
                                            2: dict(PSNR=27.95, SSIM=0.969)}})
    assert lim["L_psnr"] == pytest.approx(0.6) and lim["L_ssim"] == pytest.approx(0.01)
    assert check_mode7.sign_test([1, 2, 3, -1, 0]) == dict(n_pos=3, n_neg=1, n_ties=1, p_two_sided=0.625)
    assert check_mode7.sign_test([1.0] * 10)["p_two_sided"] == pytest.approx(2 / 1024)
    rows = _read("mode7_r4.json")["rows"]
    pairs = check_mode7.pairs(rows)
    assert pairs["spi10@23"]["PSNR"] == rows["spi10"]["gt"]["PSNR"] == rows["spi10"]["prv"]["PSNR"]
    assert len(pairs) == len({(n, r["budget"]) for n, e in rows.items() for r in e.values()})
    same = check_mode7.compare_deltas(_read("mode7_r4.json")["deltas"], _read("mode7_r4.json")["deltas"])
    assert all(v["dPSNR_within"] and v["dpath_equal"] for v in same.values())


def test_pinned_predictor_answers_the_coverage_dirs_object(tmp_path):
    cfg = m21.mode21_config(str(tmp_path)).replace(name_of_pcd="spi10")
    pred = m21.PinnedPredictor({"spi10": 23, "clu10": 25})
    assert pred.predict_from_coverage(os.path.join(cfg.gt_path, "5"), [0, 1, 3]) == 23
    assert pred.predict_from_coverage(os.path.join(cfg.gt_path, "5") + os.sep, (0, 1, 3)) == 23
    assert pred.calls == [("spi10", [0, 1, 3])] * 2


@pytest.fixture(scope="module")
def spi10(tmp_path_factory):
    """spi10 loaded at the protocol's camera in a workspace holding the
    evaluation's view spaces; mode 21 methods 4, 0 and 1 at its committed
    budget (23) without the final field, by both packages on the same
    files."""
    root = tmp_path_factory.mktemp("spi10")
    tcfg = m21.mode21_config(str(root / "port")).replace(evaluate=False)
    m7.install_eval_viewspace(tcfg)
    models = str(root / "port" / "models" / "ShapeNet")
    families.make_family_object("spi10", models)
    jcfg = JConfig(**{**vars(tcfg), "camera": JCameraConfig(**vars(tcfg.camera)),
                      "workspace": str(root / "jax" / "ws"), "viewspace_path": str(root / "jax" / "vs")})
    shutil.copytree(tcfg.viewspace_path, jcfg.viewspace_path)
    kw = dict(init_view_cases=((0, 1, 3),), coverage_sizes=())
    paths = {}
    for m in (4, 0, 1):
        pred = m21.PinnedPredictor({"spi10": 23}) if m == 4 else None
        paths[m] = (tmodes.mode_view_planning(tcfg, ["spi10"], method_ids=(m,), predictor=pred, device="cpu", **kw)[0],
                    jmodes.mode_view_planning(jcfg, ["spi10"], method_ids=(m,), predictor=pred, **kw)[0])
    scene = load_object(tcfg.replace(name_of_pcd="spi10"), "spi10", device="cpu")
    return dict(cfg=tcfg, jcfg=jcfg, scene=scene, paths=paths)


def test_path_lengths_on_a_test_object_against_the_committed(spi10):
    """``path_length_for_budget`` on spi10 at the protocol camera: the JAX
    function's value on the same files bit for bit, and the committed
    ``mode7_r4.json`` value to 4 decimals and 5e-6 relative.  The committed
    values were taken on the reference's own view-space files: the fault
    this pins (ROADMAP section 3) is that not all of them equal the
    shipped files' to 1e-9."""
    ref = {r["budget"]: r["path_len"] for e in _read("mode7_r4.json")["rows"].values() for r in e.values()}
    cfg = spi10["cfg"].replace(name_of_pcd="spi10")
    errs = {}
    for b in PATH_BUDGETS:
        got = path_length_for_budget(cfg, spi10["scene"].view_space, b, device="cpu")
        assert got == jcompare.path_length_for_budget(cfg, spi10["scene"].view_space, b), b
        assert round(got, 4) == round(ref[b], 4), b
        errs[b] = abs(got - ref[b]) / ref[b]
    assert max(errs.values()) <= COMMITTED_PATH_RTOL, errs
    assert max(errs.values()) > PATH_RTOL, errs  # the known miss, until the reference's files are shipped


@pytest.mark.parametrize("method", [4, 0, 1])
def test_mode21_movement_on_a_test_object(spi10, method):
    """Mode 21 at spi10's committed budget on both packages: the chosen
    views, every move and the total equal; the budget file method 4
    writes, 23 views.  Against ``mode21_r4.json`` the total equals to its 4
    decimals for method 4 only: methods 0 and 1 cross the 64-view space,
    which today's generator does not reproduce bit for bit (ROADMAP
    section 3), and are off by 2e-4..8e-4."""
    tp, jp = spi10["paths"][method]
    moves = sorted(f for f in os.listdir(os.path.join(jp, "movement")) if f[:-4].lstrip("-").isdigit())
    assert sorted(f for f in os.listdir(os.path.join(tp, "movement")) if f[:-4].lstrip("-").isdigit()) == moves
    assert len(moves) == 23  # -1.txt and 22 moves
    for f in moves:
        got = open(os.path.join(tp, "movement", f)).read().split()
        want = open(os.path.join(jp, "movement", f)).read().split()
        assert got[0] == want[0], f
        np.testing.assert_allclose(np.float64(got[1:]), np.float64(want[1:]), rtol=MOVE_RTOL, atol=1e-12)
    if method == 4:
        assert open(os.path.join(tp, "view_budget.txt")).read() == open(os.path.join(jp, "view_budget.txt")).read()
        assert int(open(os.path.join(tp, "view_budget.txt")).read()) == 23
    ref = _read("mode21_r4.json")["rows"][f"spi10/m{method}"]["movement"]
    total = m21.total_movement(tp)
    assert (round(total, 4) == ref) == (method == 4), (total, ref)
    assert abs(total - ref) < 1e-3


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A tiny mode 7 (two pinned budgets) and mode 21 (methods 4, 0 and 1
    with ``PinnedPredictor``) on both packages: one family object, a 48x27
    camera, 40-step fields, the shipped view spaces."""
    root = tmp_path_factory.mktemp("tiny")
    over = dict(camera=CameraConfig(**TINY_CAM), n_steps=TINY_NERF["n_steps"])
    tcfg = m21.mode21_config(str(root / "port")).replace(**over)
    m7.install_eval_viewspace(tcfg)
    families.make_family_object("spi10", str(root / "port" / "models" / "ShapeNet"))
    jcfg = JConfig(**{**vars(tcfg), "camera": JCameraConfig(**TINY_CAM), "workspace": str(root / "jax" / "ws"),
                      "viewspace_path": str(root / "jax" / "vs")})
    shutil.copytree(tcfg.viewspace_path, jcfg.viewspace_path)
    from nerf_prv_tpu.nerf import model as jm

    labels, stats, preds, walls = {"spi10": 23}, {"mode": 28}, {"spi10": 23}, {}
    trows = m7.run_mode7(tcfg, ["spi10"], labels, stats, predictions=preds, device="cpu",
                         nerf_cfg=NerfConfig(**TINY_NERF), walls=walls)
    jrows = jcompare.compare_objects(jcfg, ["spi10"], labels, nerf_cfg=jm.NerfConfig(**TINY_NERF), stat_budgets=stats,
                                     predictions=preds)
    pred = m21.PinnedPredictor({"spi10": 23})
    t21 = m21.run_rows(tcfg, ["spi10"], (4, 0, 1), pred, device="cpu", nerf_cfg=NerfConfig(**TINY_NERF),
                       coverage_sizes=[64, 5, 23, 100])
    jpaths = {m: jmodes.mode_view_planning(jcfg, ["spi10"], method_ids=(m,), nerf_cfg=jm.NerfConfig(**TINY_NERF),
                                           predictor=pred if m == 4 else None, coverage_sizes=[64, 5, 23, 100])[0]
              for m in (4, 0, 1)}
    return dict(tcfg=tcfg, trows=trows, jrows=jrows, t21=t21, jpaths=jpaths, pred=pred, walls=walls)


def test_tiny_mode7_matches_jax(tiny):
    """Budgets and path lengths equal, metrics within a training's spread."""
    got, want = tiny["trows"]["spi10"], tiny["jrows"]["spi10"]
    assert set(got) == set(want) == {"gt", "mode", "prv"}
    for key in want:
        assert got[key]["budget"] == want[key]["budget"]
        assert got[key]["path_len"] == want[key]["path_len"]
        assert abs(got[key]["PSNR"] - want[key]["PSNR"]) <= PSNR_DB, (key, got[key], want[key])
        assert abs(got[key]["SSIM"] - want[key]["SSIM"]) <= SSIM_TOL, (key, got[key], want[key])
    assert got["gt"] == got["prv"]  # one field for the shared budget
    # each distinct budget's field timed where it was trained, and the
    # wrapped evaluate_budget put back
    assert sorted(tiny["walls"]) == [("spi10", 23), ("spi10", 28)] and min(tiny["walls"].values()) > 0
    assert tcompare.evaluate_budget.__name__ == "evaluate_budget"


def test_tiny_mode7_at_another_seed_trains_in_its_own_workspace(tiny):
    """NeRF seed 1 runs ``evaluate_budget``'s steps in ``<workspace>_seed1``:
    the same budgets and path lengths as seed 0, its own metric files, and
    ``score_budget`` reads the cached field there."""
    cfg = tiny["tcfg"]
    got = m7.run_mode7(cfg, ["spi10"], {"spi10": 23}, {"mode": 28}, predictions={"spi10": 23}, seed=1,
                       device="cpu", nerf_cfg=NerfConfig(**TINY_NERF))["spi10"]
    seed0 = tiny["trows"]["spi10"]
    assert {k: (r["budget"], r["path_len"]) for k, r in got.items()} == {
        k: (r["budget"], r["path_len"]) for k, r in seed0.items()}
    assert got["mode"]["PSNR"] != seed0["mode"]["PSNR"]
    gt = cfg.replace(workspace=cfg.workspace + "_seed1", name_of_pcd="spi10").gt_path
    assert sorted(f for f in os.listdir(gt) if f.startswith("compare_")) == ["compare_23.txt", "compare_28.txt"]
    again = m7.score_budget(cfg, "spi10", 28, seed=1, device="cpu", nerf_cfg=NerfConfig(**TINY_NERF))
    assert (again["PSNR"], again["SSIM"], again["path_len"]) == (
        got["mode"]["PSNR"], got["mode"]["SSIM"], got["mode"]["path_len"])


@pytest.mark.parametrize("method", [4, 0, 1])
def test_tiny_mode21_rows_match_jax(tiny, method):
    """The row read off each package's experiment directory: budget, views
    trained and movement equal, PSNR and SSIM within a training's spread;
    the predictor asked once, for spi10's views [0, 1, 3]."""
    got = tiny["t21"][f"spi10/m{method}"]
    want = m21.read_row(tiny["jpaths"][method], method)
    assert {k: got.get(k) for k in ("method", "budget", "n_views_trained", "movement")} == {
        k: want.get(k) for k in ("method", "budget", "n_views_trained", "movement")}
    assert got["n_views_trained"] == 23
    assert abs(got["PSNR"] - want["PSNR"]) <= PSNR_DB and abs(got["SSIM"] - want["SSIM"]) <= SSIM_TOL
    assert tiny["pred"].calls.count(("spi10", [0, 1, 3])) == 2  # once a package
    if method == 4:
        tp = f"{tiny['tcfg'].replace(name_of_pcd='spi10', method_of_IG=4).save_path}_v3_t0"
        assert open(os.path.join(tp, "view_budget.txt")).read() == open(
            os.path.join(tiny["jpaths"][4], "view_budget.txt")).read()


def test_entry_points_ask_for_the_cpu_without_a_card(tmp_path):
    """Without a card the evaluation raises at once unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = lp.pipeline_config(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m7.run_mode7(cfg, ["spi10"], {"spi10": 23}, {"mode": 28})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m21.run_rows(m21.mode21_config(str(tmp_path)), ["spi10"], (4,), m21.PinnedPredictor({"spi10": 23}))
