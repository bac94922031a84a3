"""The port's end-to-end mode 21 (``nerf_prv_tpu_torch/experiments``:
``toy``, ``e2e_mode21``, ``check_e2e_mode21``, ``launches``) against the JAX
package's ``experiments/exp_e2e_mode21.py``: the toy object and its PLY
bytes, the script's configuration and predictor rule, the budget from the
same fresh-init PRVNet weights, a cut-camera run of methods 4 and 0 through
both packages, method 2's score, the check's bookkeeping, and
``chip_smoke.py`` phase 18's launch counts against a CPU run's counted
calls."""

import importlib
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from nerf_prv_tpu.core.config import CameraConfig as JCameraConfig
from nerf_prv_tpu.core.config import Config as JConfig
from nerf_prv_tpu.pipeline import modes as jmodes
from nerf_prv_tpu.pipeline import nbv as jnbv
from nerf_prv_tpu.prvnet import infer as jinfer
from nerf_prv_tpu.prvnet.model import IMG_PATTERN as JIMG_PATTERN
from nerf_prv_tpu.prvnet.train import TrainConfig as JTrainConfig
from nerf_prv_tpu.prvnet.train import init_model as jinit_model
from nerf_prv_tpu.scene import save_ply_binary as jsave_ply_binary
from nerf_prv_tpu_torch.convert import prvnet_state_dict_from_flax
from nerf_prv_tpu_torch.core.config import CameraConfig
from nerf_prv_tpu_torch.experiments import check_e2e_mode21 as ce
from nerf_prv_tpu_torch.experiments import e2e_mode21, toy
from nerf_prv_tpu_torch.experiments.mode7_compare import install_eval_viewspace
from nerf_prv_tpu_torch.experiments.mode21_table import total_movement
from nerf_prv_tpu_torch.nerf import model as tm
from nerf_prv_tpu_torch.pipeline import nbv as tnbv
from nerf_prv_tpu_torch.pipeline.coverage import get_coverage
from nerf_prv_tpu_torch.prvnet.infer import BudgetPredictor
from nerf_prv_tpu_torch.prvnet.train import save_checkpoint
from nerf_prv_tpu_torch.scene.object_setup import load_object

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
sys.path.insert(0, REPO)
synthetic = importlib.import_module("synthetic")

# a tenth of the default camera, wide enough for the predictor's crop of 64
CUT_CAM = dict(width=128, height=72, fx=91.56, fy=91.33, ppx=64.7, ppy=37.25, model=0)
# the same fresh-init weights in both packages: float32 forwards that sum in
# other orders (measured within 1e-5 on the budget's scale)
BUDGET_ATOL = 1e-4
MOVE_RTOL = 1e-6  # float64 local paths over the same files
TINY_NERF = dict(voxel_grid_size=12, n_steps=20, train_rays=256, train_warmup_steps=10)


@pytest.fixture(scope="module")
def jax_atto():
    """The JAX script's fresh-init predictor weights (exp_e2e_mode21.py:57-58)."""
    _, params = jinit_model(JTrainConfig(arch="convnextv2_atto", image_size=64), n_views=3, image_size=64)
    return params


def _predictors(params):
    jpred = jinfer.BudgetPredictor(params=params, arch="convnextv2_atto", pattern=JIMG_PATTERN[2], crop=64)
    tpred = BudgetPredictor(params=prvnet_state_dict_from_flax(params), arch="convnextv2_atto",
                            pattern=JIMG_PATTERN[2], crop=64, device="cpu")
    return jpred, tpred


def _jax_value(jpred, views):
    return float(jpred._apply(jpred.params, views[None])[0])


def test_toy_object_and_ply_bytes_equal_jax(tmp_path):
    """``toy.make_object`` is ``tests/synthetic.make_object``, and ``write_toy``
    writes the bytes of the JAX scripts' ``save_ply_binary(pts * 20, cols)``."""
    for n, seed in ((30000, 3), (500, 0)):
        pts, cols = toy.make_object(n, seed=seed)
        jpts, jcols = synthetic.make_object(n, seed=seed)
        np.testing.assert_array_equal(pts, jpts)
        np.testing.assert_array_equal(cols, jcols)
        assert (pts.dtype, cols.dtype) == (jpts.dtype, jcols.dtype)
    path = toy.write_toy(str(tmp_path / "port"))
    assert path == os.path.join(str(tmp_path / "port"), "models", "ShapeNet", "toy0.ply")
    jpts, jcols = synthetic.make_object(30000, seed=3)
    jpath = str(tmp_path / "jax" / "toy0.ply")
    jsave_ply_binary(jpath, jpts * 20, jcols)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    mtime = os.path.getmtime(path)
    toy.write_toy(str(tmp_path / "port"))  # an existing file is kept
    assert os.path.getmtime(path) == mtime


def test_e2e_config_equals_the_jax_script():
    cfg = e2e_mode21.e2e_config("r")
    want = JConfig(workspace=os.path.join("r", "ws"), model_path=os.path.join("r", "models"),
                   viewspace_path=os.path.join("r", "ws", "viewspace"), name_of_pcd="toy0", num_of_views=60,
                   num_of_max_iteration=3, n_steps=2500, ensemble_num=2, evaluate=False)
    assert {k: v for k, v in vars(cfg).items() if k != "camera"} == {
        k: v for k, v in vars(want).items() if k != "camera"}
    assert vars(cfg.camera) == vars(want.camera)
    assert e2e_mode21.e2e_config("r", evaluate=True).evaluate
    assert e2e_mode21.VIEW_SIZES == [5, 60] + list(range(13, 59))
    assert (e2e_mode21.METHODS, e2e_mode21.INIT_CASE) == ((4, 0, 2), (0, 1, 3))


def test_predictor_follows_the_scripts_rule(tmp_path, jax_atto):
    """No checkpoint (or a missing one): a fresh atto at crop 64 drawn from
    ``TrainConfig.seed``, the same weights each time; a checkpoint that
    exists: its weights at crop 180."""
    a, kind = e2e_mode21.make_predictor(None, "cpu")
    b, kind_b = e2e_mode21.make_predictor(str(tmp_path / "missing.msgpack"), "cpu")
    assert (kind, kind_b) == ("fresh-init", "fresh-init") and (a.crop, a.pattern) == (64, [0, 1, 3])
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k])
    path = str(tmp_path / "best_checkpoint.msgpack")
    save_checkpoint(path, prvnet_state_dict_from_flax(jax_atto))
    c, kind_c = e2e_mode21.make_predictor(path, "cpu")
    assert kind_c == "checkpoint" and (c.crop, c.pattern) == (180, [0, 1, 3])
    want = prvnet_state_dict_from_flax(jax_atto)
    for k, v in c.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))


def test_e2e_budget_from_the_jax_weights_equals_jax(tmp_path, jax_atto):
    """JAX's fresh-init atto carried into the port gives the same continuous
    budget (within 1e-4) and the same integer budget on the same coverage
    images: toy0's 5-view set at the script's 1280x720 camera, views 0, 1, 3."""
    cfg = e2e_mode21.e2e_config(str(tmp_path))
    toy.write_toy(str(tmp_path))
    install_eval_viewspace(cfg)
    scene = load_object(cfg, "toy0", device="cpu")
    get_coverage(scene, cfg, 5, device="cpu")
    jpred, tpred = _predictors(jax_atto)
    cov = os.path.join(cfg.gt_path, "5")
    views = tpred.coverage_views(cov, e2e_mode21.INIT_CASE)
    want = _jax_value(jpred, views)
    got = tpred.predict_value_from_arrays(views)
    assert abs(got - want) <= BUDGET_ATOL, (got, want)
    assert tpred.predict_from_coverage(cov, e2e_mode21.INIT_CASE) == jpred.predict_from_coverage(
        cov, e2e_mode21.INIT_CASE) == int(np.round(want))
    assert 13 <= int(np.round(want)) <= 58


@pytest.fixture(scope="module")
def cut_runs(tmp_path_factory, jax_atto):
    """Methods 4 and 0 of the script on both packages at the cut camera
    (``evaluate=False``, as the script runs: no field is trained), on the
    same view-space files, each package with its own predictor built from
    the same JAX weights."""
    root = tmp_path_factory.mktemp("e2e")
    tcfg = e2e_mode21.e2e_config(str(root / "port")).replace(camera=CameraConfig(**CUT_CAM))
    install_eval_viewspace(tcfg)
    jcfg = JConfig(**{**vars(tcfg), "camera": JCameraConfig(**CUT_CAM), "workspace": str(root / "jax" / "ws"),
                      "model_path": str(root / "jax" / "models"), "viewspace_path": str(root / "jax" / "vs")})
    shutil.copytree(tcfg.viewspace_path, jcfg.viewspace_path)
    jpts, jcols = synthetic.make_object(30000, seed=3)
    jsave_ply_binary(os.path.join(jcfg.model_path, "ShapeNet", "toy0.ply"), jpts * 20, jcols)
    jpred, tpred = _predictors(jax_atto)
    out = e2e_mode21.run_e2e(str(root / "port"), methods=(4, 0), device="cpu", cfg=tcfg, predictor=tpred)
    jmodes.mode_view_cover(jcfg, sizes=e2e_mode21.VIEW_SIZES)
    jpaths = jmodes.mode_view_planning(jcfg, ["toy0"], method_ids=(4, 0), init_view_cases=((0, 1, 3),),
                                       predictor=jpred, coverage_sizes=())
    return dict(out=out, jpaths=dict(zip((4, 0), jpaths)), tcfg=tcfg)


def _moves(path):
    mv = os.path.join(path, "movement")
    ids = sorted(int(f[:-4]) for f in os.listdir(mv) if f[:-4].isdigit())
    return [open(os.path.join(mv, f"{i}.txt")).read().split() for i in ids]


@pytest.mark.parametrize("method", [4, 0])
def test_cut_camera_e2e_matches_jax(cut_runs, method):
    """The same budget, method 0's chosen views and method 4's path equal
    to JAX's, each movement and the total within 1e-6 relative; the rows
    the port returns read off its own directory."""
    row = cut_runs["out"]["methods"][method]
    jpath = cut_runs["jpaths"][method]
    got, want = _moves(row["path"]), _moves(jpath)
    assert [int(r[0]) for r in got] == [int(r[0]) for r in want]
    assert len(got) == int(open(os.path.join(cut_runs["jpaths"][4], "view_budget.txt")).read()) - 1
    for g, w in zip(got, want):
        assert float(g[1]) == pytest.approx(float(w[1]), rel=MOVE_RTOL, abs=1e-12)
        assert float(g[2]) == pytest.approx(float(w[2]), rel=MOVE_RTOL)
    assert total_movement(row["path"]) == pytest.approx(total_movement(jpath), rel=MOVE_RTOL)
    if method == 4:
        assert row["budget"] == int(open(os.path.join(jpath, "view_budget.txt")).read())
        assert open(os.path.join(row["path"], "movement", "init_path.txt")).read() == open(
            os.path.join(jpath, "movement", "init_path.txt")).read()
    assert row["run_time"] is not None and os.path.exists(os.path.join(row["path"], "run_time.txt"))


def test_cut_camera_e2e_renders_only_the_scripts_sets(cut_runs):
    """``coverage_sizes=()``: the candidate space and the 5 init views only."""
    gt = cut_runs["tcfg"].gt_path
    assert sorted(f for f in os.listdir(gt) if f.endswith(".json")) == ["5.json", "60.json"]


@pytest.mark.parametrize("seed", [0, 1])
def test_method2_argmax_equal_through_both_scorers(seed):
    """An identical (V, E, H, W, 4) image stack through JAX's and the port's
    EnsembleRGB score: the same argmax, the scores within float32 rounding."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (23, 2, 45, 80, 4), dtype=np.uint8)
    imgs[5, 1] = imgs[5, 0]  # a candidate the two members agree on: every variance 0
    want = np.asarray(jnbv.score_candidates_rgb(imgs))
    got = tnbv.score_candidates_rgb(torch.as_tensor(imgs)).numpy()
    assert int(np.argmax(got)) == int(np.argmax(want))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[5] == want[5] == 0.0


def test_planned_work_and_read_path(tmp_path):
    """The fields, screenshot sets and evals the check derives from a budget,
    and the row it reads off an experiment directory."""
    cfg = e2e_mode21.e2e_config("r", evaluate=True)
    assert ce.planned_work(2, 36, cfg.replace(method_of_IG=2)) == dict(iterations=35, fields=71, screenshots=70,
                                                                         evals=1)
    assert ce.planned_work(4, 36, cfg.replace(method_of_IG=4)) == dict(iterations=35, fields=1, screenshots=0,
                                                                         evals=1)
    assert ce.planned_work(0, 4, cfg.replace(method_of_IG=0, evaluate=False))["fields"] == 0
    path = str(tmp_path / "exp")
    for sub in ("movement", "infer_time", "metrics"):
        os.makedirs(os.path.join(path, sub))
    open(os.path.join(path, "movement", "-1.txt"), "w").write("7\t0.5\t0.0\n")
    for i, (v, d) in enumerate(((3, 0.25), (9, 0.5))):
        open(os.path.join(path, "movement", f"{i}.txt"), "w").write(f"{v}\t{d}\t{0.25 + 0.5 * i}\n")
        open(os.path.join(path, "infer_time", f"{i}.txt"), "w").write(f"{0.1 * (i + 1)}\n")
    open(os.path.join(path, "run_time.txt"), "w").write("2.5\n")
    open(os.path.join(path, "metrics", "2.txt"), "w").write("PSNR\t30.5\nSSIM\t0.9")
    row = ce.read_path(path)
    assert row == dict(first_view=7, chosen=[3, 9], movement=[0.25, 0.5], movement_total=0.75,
                       infer_time=[0.1, 0.2], run_time=2.5, PSNR=30.5, SSIM=0.9, n_views_trained=3)


def test_ensemble_choices_recompute_the_argmax(tmp_path):
    """Screenshots written so that one candidate has the largest RGB
    variance each iteration: the plain score picks it, and a card choice
    that differs shows as a disagreement."""
    from PIL import Image

    rng = np.random.default_rng(2)
    path, n_views, first = str(tmp_path), 6, 0
    chosen = [4, 2]
    taken = [first]
    for it, pick in enumerate(chosen):
        for e in range(2):
            d = os.path.join(path, "render", str(it), f"ensemble_{e}")
            os.makedirs(d)
            for i in range(n_views):
                if i in taken:
                    continue
                base = rng.integers(100, 110, (9, 16, 4), dtype=np.uint8)
                if i == pick:
                    base[..., :3] = 0 if e == 0 else 200
                Image.fromarray(base, "RGBA").save(os.path.join(d, f"rgbaClip_{i}.png"))
        taken.append(pick)
    got = ce.ensemble_choices(path, first, chosen, n_views, 2)
    assert [(c["card"], c["plain"]) for c in got] == [(4, 4), (2, 2)] and all(c["top2_gap"] > 0 for c in got)
    wrong = ce.ensemble_choices(path, first, [4, 3], n_views, 2)
    assert [(c["card"], c["plain"]) for c in wrong] == [(4, 4), (3, 2)]
    assert ce.DEVIATIONS and all(isinstance(d, str) for d in ce.DEVIATIONS)


def _counting(fn, target, nonempty):
    def f(*a, **kw):
        out = fn(*a, **kw)
        if nonempty(*a):
            target.launches += 1
        return out
    return f


@pytest.fixture
def counting_stand_ins(monkeypatch):
    """Each wrapper's CPU call counted where its kernel would launch (the row
    kernels launch nothing for an empty input): the card's counters here."""
    from nerf_prv_tpu_torch.nerf import render as nrender
    from nerf_prv_tpu_torch.nerf import voxelfield
    from nerf_prv_tpu_torch.ops.row_gather import row_gather
    from nerf_prv_tpu_torch.ops.row_scatter_add import row_scatter_add
    from nerf_prv_tpu_torch.ops.splat import splat
    from nerf_prv_tpu_torch.scene import render as srender

    gather = lambda t, i: i.numel() > 0  # noqa: E731
    monkeypatch.setattr(voxelfield, "row_gather", _counting(voxelfield.row_gather, row_gather, gather))
    monkeypatch.setattr(nrender, "row_gather", _counting(nrender.row_gather, row_gather, gather))
    monkeypatch.setattr(voxelfield, "row_scatter_add", _counting(voxelfield.row_scatter_add, row_scatter_add,
                                                                 lambda i, u, n: i.numel() > 0))
    monkeypatch.setattr(srender, "splat", _counting(srender.splat, splat, lambda *a: True))
    for w in (row_gather, row_scatter_add, splat):
        monkeypatch.setattr(w, "launches", 0)


@pytest.mark.parametrize("width,height", [(512, 16), (64, 36)])
def test_render_gathers_match_counted_renders(tmp_path, counting_stand_ins, width, height):
    """``launches.eval_gathers`` and ``screenshot_gathers`` against the
    gathers an ``eval_nerf`` and a ``screenshot_nerf`` launch, counted: the
    tile path (512 wide, the level-1 probe replayed) and the per-ray one."""
    from nerf_prv_tpu_torch.experiments import launches
    from nerf_prv_tpu_torch.nerf.api import eval_nerf, screenshot_nerf, train_nerf
    from nerf_prv_tpu_torch.nerf.model import NerfConfig
    from nerf_prv_tpu_torch.ops.row_gather import row_gather

    cam = CameraConfig(width=width, height=height, fx=0.715 * width, fy=0.715 * width, ppx=width / 2,
                       ppy=height / 2, model=0)
    cfg = e2e_mode21.e2e_config(str(tmp_path)).replace(camera=cam)
    toy.write_toy(str(tmp_path))
    install_eval_viewspace(cfg)
    scene = load_object(cfg, "toy0", device="cpu")
    train_json, test_json = (get_coverage(scene, cfg, n, device="cpu") for n in (5, 20))
    ncfg = NerfConfig(**TINY_NERF)
    params, _ = train_nerf(train_json, ncfg, device="cpu")
    for fn, derive in ((lambda: eval_nerf(params, test_json, ncfg), launches.eval_gathers),
                       (lambda: screenshot_nerf(params, test_json, str(tmp_path / "shots"), ncfg),
                        launches.screenshot_gathers)):
        before = row_gather.launches
        fn()
        want, data = derive(params, test_json, ncfg, "cpu")
        assert row_gather.launches - before == want > 0 and len(data) == (3 if derive is launches.eval_gathers else 2)


def test_phase18_launch_formula_matches_a_counted_cpu_run(tmp_path, monkeypatch, counting_stand_ins):
    """``chip_smoke.py`` phase 18 on the CPU at a cut size (a 64x36 camera,
    20-step grid-12 fields): its derived launches (fields, evals, screenshot
    sets, K8's sets) equal the counted calls, its K8 frames and method 2's
    choices hold, and a derivation that forgets the screenshots is caught."""
    import chip_smoke as cs

    cam = CameraConfig(width=64, height=36, fx=45.8, fy=45.7, ppx=32.4, ppy=18.6, model=0)
    real = e2e_mode21.e2e_config
    monkeypatch.setattr(e2e_mode21, "e2e_config", lambda root, evaluate=False: real(root, evaluate).replace(camera=cam))
    monkeypatch.setattr(cs, "sync", lambda: None)
    monkeypatch.setattr(cs, "E2E_NERF", cs.NerfConfig(**TINY_NERF))
    monkeypatch.setattr(cs, "E2E_PSNR_MARGIN_DB", -100.0)
    k = [dict(name=n) for n in ("row_gather", "row_scatter_add", "splat")]
    cs.phase_e2e(torch.device("cpu"), str(tmp_path / "a"), *k, "CPU")
    fields, steps = 1 + 1 + 3 * 2 + 1, TINY_NERF["n_steps"]
    assert k[1]["launches_e2e"] == fields * steps
    assert k[2]["launches_e2e"] == 1 + 4  # one size-test try, the 60-, 5-, 4- and 100-view sets
    assert k[0]["launches_e2e"] > fields * cs.expected_train_launches(cs.E2E_NERF)[0]
    # a derivation that forgets the screenshots' gathers fails the phase
    real_shots = ce.launch_mod.screenshot_gathers
    monkeypatch.setattr(ce.launch_mod, "screenshot_gathers", lambda *a: (0, real_shots(*a)[1]))
    with pytest.raises(SystemExit, match="18: the e2e run's launches"):
        cs.phase_e2e(torch.device("cpu"), str(tmp_path / "b"), *k, "CPU")


def test_check_main_split_over_two_calls(tmp_path, monkeypatch, counting_stand_ins):
    """``check_e2e_mode21.main`` on the CPU at a cut size: methods 4 and 0 in
    one call, method 2 in a second call from an empty workspace that
    restores the budget from the result file; launches held to the code in
    each, method 2's choices equal to the plain score's."""
    cam = CameraConfig(width=64, height=36, fx=45.8, fy=45.7, ppx=32.4, ppy=18.6, model=0)
    real = e2e_mode21.e2e_config
    monkeypatch.setattr(ce, "e2e_config", lambda root, evaluate=False: real(root, evaluate).replace(
        camera=cam, n_steps=TINY_NERF["n_steps"]))
    monkeypatch.setattr(ce, "field_config", lambda cfg: tm.NerfConfig(**TINY_NERF))

    class Pinned:
        crop = 64

        def coverage_views(self, d, ids):
            return None

        def predict_value_from_arrays(self, views):
            return 4.2

        def predict_from_coverage(self, d, ids):
            return 4

    monkeypatch.setattr(ce, "make_predictor", lambda ckpt, dev: (Pinned(), "pinned"))
    root, out = str(tmp_path / "ws"), str(tmp_path / "e2e.json")
    argv = ["--device", "cpu", "--root", root, "--out", out, "--log", str(tmp_path / "e2e.log")]
    assert ce.main(argv + ["--methods", "4", "0"]) == 0
    shutil.rmtree(root)
    assert ce.main(argv + ["--methods", "2"]) == 0
    res = json.load(open(out))
    assert res["all_held"] and res["budget"] == 4 and sorted(res["methods"]) == ["0", "2", "4"]
    assert [c["methods"] for c in res["calls"]] == [[4, 0], [2]]
    for m, r in res["methods"].items():
        assert r["launched"] == r["expected"] and len(r["chosen"]) == 3
        assert np.isfinite(r["PSNR"]) and len(r["infer_time"]) == 3
    assert res["methods"]["4"]["budget"] == 4 and res["methods"]["2"]["plain_equal"]
    assert res["methods"]["2"]["launched"]["row_scatter_add"] == 7 * TINY_NERF["n_steps"]
    assert all(c["prepare"]["splat"]["launched"] == c["prepare"]["splat"]["expected"] == 5 for c in res["calls"])


def test_entry_points_ask_for_the_cpu_without_a_card(tmp_path):
    """Without a card the script raises at once unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        e2e_mode21.run_e2e(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ce.main(["--root", str(tmp_path), "--out", str(tmp_path / "x.json"), "--log", str(tmp_path / "x.log")])
