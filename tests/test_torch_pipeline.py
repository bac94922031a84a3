"""The port's pipeline against the JAX package: the ensemble scores, the
budget comparison's statistics and table, mode 21 (the NBV experiment) with
methods 4, 0 and 1 on one tiny workspace and the same PRVNet weights, a
tiny mode-21 run of the port alone that trains and scores its NeRF, the
command line's modes 0 and 20 and the ready-file servers (the spans and
the device trace: ``test_torch_timing.py``)."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nerf_prv_tpu.core.config import CameraConfig as JCameraConfig
from nerf_prv_tpu.core.config import Config as JConfig
from nerf_prv_tpu.pipeline import cli as jcli
from nerf_prv_tpu.pipeline import compare as jcompare
from nerf_prv_tpu.pipeline import modes as jmodes
from nerf_prv_tpu.pipeline import nbv as jnbv
from nerf_prv_tpu.prvnet import infer as jinfer
from nerf_prv_tpu.prvnet import model as jmodel
from nerf_prv_tpu.scene import save_ply_binary
from nerf_prv_tpu.viewspace import hemisphere as jhemi
from nerf_prv_tpu_torch.convert import prvnet_state_dict_from_flax
from nerf_prv_tpu_torch.core.config import CameraConfig, Config
from nerf_prv_tpu_torch.nerf.model import NerfConfig
from nerf_prv_tpu_torch.pipeline import cli as tcli
from nerf_prv_tpu_torch.pipeline import compare as tcompare
from nerf_prv_tpu_torch.pipeline import modes as tmodes
from nerf_prv_tpu_torch.pipeline import nbv as tnbv
from nerf_prv_tpu_torch.prvnet import infer as tinfer
from nerf_prv_tpu_torch.servers import infer_server, train_server
from nerf_prv_tpu_torch.viewspace.hemisphere import ViewSpace

from synthetic import make_object
from test_torch_prvnet import _random_tree

torch.set_num_threads(1)

CAM = dict(width=96, height=54, fx=68.7, fy=68.5, ppx=48.5, ppy=27.9, model=0)
# the ensemble scores: float32 sums over 2,000 pixels of per-pixel terms,
# reduced in other orders by XLA and ATen: measured up to 4.8e-7 relative
SCORE_RTOL = 1e-5
# movement distances: float64 local paths on both sides, summed in the
# same order; the initial path's length is the TSP's cost over float32
# edge matrices, 1e-5 relative apart (tests/test_torch_planning.py)
MOVE_RTOL = 1e-5
# the frames' camera-to-world matrices: the same numpy pose code on the
# same view-space files
C2W_ATOL = 1e-9
# PRVNet's last bias, the same in both trees, puts the budget near the
# label range's low end, so that method 4 plans and replays few views
FC4_BIAS = -6.0
BUDGET_ATOL = 1e-3  # tests/test_torch_prvnet.py


# ----------------------------------------------------------- ensemble scores


@pytest.mark.parametrize("which", ["rgb", "rgb_density"])
def test_ensemble_scores_match_jax(which):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (6, 5, 40, 50, 4), dtype=np.uint8)
    imgs[1, :, :, :, :3] = imgs[1, :1, :, :, :3]  # one candidate the members agree on
    imgs[2, :, :10, :, 3] = 255
    jfn = getattr(jnbv, f"score_candidates_{which}")
    tfn = getattr(tnbv, f"score_candidates_{which}")
    want = np.asarray(jfn(jnp.asarray(imgs)))
    got = tfn(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, want, rtol=SCORE_RTOL)
    assert int(np.argmax(got)) == int(np.argmax(want))
    one = getattr(tnbv, f"ensemble_uncertainty_{which}")(imgs[3], device="cpu")
    assert one == pytest.approx(getattr(jnbv, f"ensemble_uncertainty_{which}")(imgs[3]), rel=SCORE_RTOL)


# ------------------------------------------------------------- comparison


def test_stat_budgets_and_match_distribution_match_jax():
    rng = np.random.default_rng(1)
    for n in (1, 2, 7, 40):
        labels = {f"o{i}": int(v) for i, v in enumerate(rng.integers(13, 59, n))}
        assert tcompare.stat_budgets_from_labels(labels) == jcompare.stat_budgets_from_labels(labels)
    assert tcompare.stat_budgets_from_labels({}) == jcompare.stat_budgets_from_labels({})
    val = {f"v{i}": int(v) for i, v in enumerate(rng.integers(13, 59, 60))}
    cand = {f"c{i}": int(v) for i, v in enumerate(rng.integers(5, 70, 400))}
    for seed, n_test in ((0, 50), (3, 250)):
        assert tcompare.match_distribution(val, cand, n_test, seed) == jcompare.match_distribution(
            val, cand, n_test, seed)


def test_write_comparison_table_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    rows = {
        f"o{i}": {m: {"budget": int(rng.integers(13, 59)), "PSNR": float(rng.uniform(20, 40)),
                      "SSIM": float(rng.uniform(0.5, 1)), "path_len": float(rng.uniform(1, 5))}
                  for m in (("gt", "mode", "prv") if i else ("gt", "mean"))}
        for i in range(4)
    }
    jcompare.write_comparison_table(str(tmp_path / "j.txt"), rows)
    tcompare.write_comparison_table(str(tmp_path / "t.txt"), rows)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()


def test_path_length_for_budget_matches_jax(tmp_path):
    vs_dir = str(tmp_path / "vs")
    for n in (7, 9):
        jhemi.save_view_space(vs_dir, jhemi.generate_hemisphere(n, seed=n, restarts=2, steps=100))
    # a precomputed order for 7 views; 9 views are planned on the spot
    jhemi.save_path_order(vs_dir, np.array([0, 3, 1, 6, 2, 5, 4]))
    pts, _ = make_object(2000, seed=4)
    jcfg, tcfg = JConfig(viewspace_path=vs_dir), Config(viewspace_path=vs_dir)
    jvs = jhemi.ViewSpace(jhemi.load_view_space(vs_dir, 9), pts, 0.3)
    tvs = ViewSpace(jhemi.load_view_space(vs_dir, 9), pts, 0.3)
    for budget in (7, 9):
        want = jcompare.path_length_for_budget(jcfg, jvs, budget)
        got = tcompare.path_length_for_budget(tcfg, tvs, budget, device="cpu")
        assert got == pytest.approx(want, rel=MOVE_RTOL)


# ------------------------------------------------------------ mode 21


def _atto_tree():
    """Seeded random PVBNet-atto weights as a Flax tree, with FC4_BIAS."""
    tree = _random_tree(jmodel.make_pvbnet("convnextv2_atto"), np.zeros((1, 3, 64, 64, 3), np.float32), 5)
    tree["fc4"]["bias"] = np.full_like(tree["fc4"]["bias"], FC4_BIAS)
    return tree


def _configs(root, name):
    common = dict(
        model_path=str(root / "models"), viewspace_path=str(root / "viewspace"), name_of_pcd="toy0",
        num_of_views=60, num_of_max_iteration=3, coverage_view_num_max=7, coverage_view_num_add=2,
        n_steps=100, evaluate=False, show=True,
    )
    return (JConfig(workspace=str(root / f"{name}_jax"), camera=JCameraConfig(**CAM), **common),
            Config(workspace=str(root / f"{name}_port"), camera=CameraConfig(**CAM), **common))


@pytest.fixture(scope="module")
def planning(tmp_path_factory):
    """Mode 21, methods 4, 0 and 1, run by both packages on one object,
    one set of view-space files (the reference's generator, written first)
    and one set of PRVNet weights; each in its own workspace."""
    root = tmp_path_factory.mktemp("m21")
    pts, cols = make_object(8000, seed=3)
    save_ply_binary(str(root / "models" / "ShapeNet" / "toy0.ply"), pts * 20, cols)
    tree = _atto_tree()
    jpred = jinfer.BudgetPredictor(params=tree, arch="convnextv2_atto", crop=64)
    tpred = tinfer.BudgetPredictor(params=prvnet_state_dict_from_flax(tree), arch="convnextv2_atto",
                                   crop=64, device="cpu")
    jcfg, tcfg = _configs(root, "ws")
    for n in (5, 60, 100):
        jhemi.save_view_space(tcfg.viewspace_path, jhemi.generate_hemisphere(n, seed=n, restarts=2, steps=100))
    # method 4 reads the budget-sized view space: write every size it could predict
    for n in range(13, 16):
        jhemi.save_view_space(tcfg.viewspace_path, jhemi.generate_hemisphere(n, seed=n, restarts=2, steps=100))
    kw = dict(method_ids=(4, 0, 1), init_view_cases=((0, 1, 3),), coverage_sizes=())
    jpaths = jmodes.mode_view_planning(jcfg, ["toy0"], predictor=jpred, **kw)
    tpaths = tmodes.mode_view_planning(tcfg, ["toy0"], predictor=tpred, device="cpu", **kw)
    cov = os.path.join(tcfg.gt_path, "5")
    value = tpred.predict_value_from_arrays(tpred.coverage_views(cov, [0, 1, 3]))
    return dict(root=root, jpaths=jpaths, tpaths=tpaths, tpred=tpred, value=value, cfg=tcfg)


def _moves(path):
    out = {}
    for f in os.listdir(os.path.join(path, "movement")):
        parts = open(os.path.join(path, "movement", f)).read().split()
        out[f] = parts
    return out


def _frames(path):
    with open(path) as f:
        d = json.load(f)
    return d


@pytest.mark.parametrize("method", [4, 0, 1])
def test_mode21_artifacts_match_jax(planning, method):
    i = (4, 0, 1).index(method)
    jp, tp = planning["jpaths"][i], planning["tpaths"][i]
    assert tp.endswith(f"_m{method}_v3_t0") and jp.endswith(f"_m{method}_v3_t0")
    # the budget: the same integer, decided away from a half-integer
    value = planning["value"]
    assert abs(value - np.floor(value) - 0.5) > BUDGET_ATOL
    budget = int(np.round(value))
    if method == 4:
        for f in ("view_budget.txt",):
            assert open(os.path.join(tp, f)).read() == open(os.path.join(jp, f)).read()
        assert int(open(os.path.join(tp, "view_budget.txt")).read()) == budget
        for f in ("view_space.ply", "trajectory.ply", "view_space.png"):
            assert os.path.exists(os.path.join(tp, "debug_viz", f)), f
    for f in ("run_time.txt", os.path.join("movement", "init_path.txt")):
        assert os.path.exists(os.path.join(tp, f))
    assert open(os.path.join(tp, "movement", "init_path.txt")).read() == open(
        os.path.join(jp, "movement", "init_path.txt")).read()
    jm, tm = _moves(jp), _moves(tp)
    assert set(tm) == set(jm)
    assert len([f for f in tm if f[0].isdigit()]) == budget - 1
    for f in jm:
        if f == "init_path.txt":
            continue
        assert tm[f][0] == jm[f][0], f  # the view id
        np.testing.assert_allclose(np.float64(tm[f][1:]), np.float64(jm[f][1:]), rtol=MOVE_RTOL, atol=1e-12)
    for sub in ("json", "render_json"):
        names = sorted(os.listdir(os.path.join(jp, sub)))
        assert sorted(os.listdir(os.path.join(tp, sub))) == names and len(names) == budget
        for name in names:
            jd, td = _frames(os.path.join(jp, sub, name)), _frames(os.path.join(tp, sub, name))
            assert {k: v for k, v in td.items() if k != "frames"} == pytest.approx(
                {k: v for k, v in jd.items() if k != "frames"})
            assert [fr["file_path"] for fr in td["frames"]] == [fr["file_path"] for fr in jd["frames"]]
            np.testing.assert_allclose(
                np.array([fr["transform_matrix"] for fr in td["frames"]]),
                np.array([fr["transform_matrix"] for fr in jd["frames"]]), atol=C2W_ATOL)
    # methods 0 and 1 draw from the seeded numpy generator, as the reference
    if method == 0:
        rng = np.random.default_rng(planning["cfg"].seed)
        chosen, seq = {int(jm["-1.txt"][0])}, []
        for _ in range(budget - 1):
            nxt = int(rng.integers(60))
            while nxt in chosen:
                nxt = int(rng.integers(60))
            chosen.add(nxt)
            seq.append(nxt)
        assert [int(tm[f"{k}.txt"][0]) for k in range(budget - 1)] == seq


def test_mode21_resume_guard_and_evaluated_run(planning):
    """Rerunning is a no-op (``run_time.txt``); a tiny evaluated run of the
    port alone trains its NeRF on the budget's coverage set, scores it on
    the 100-view set and writes ``metrics/<last iteration>.txt``."""
    root, tpred = planning["root"], planning["tpred"]
    _, tcfg = _configs(root, "ws")
    again = tmodes.mode_view_planning(tcfg, ["toy0"], method_ids=(4,), predictor=tpred, coverage_sizes=(),
                                      device="cpu")
    assert again == planning["tpaths"][:1]
    budget = int(np.round(planning["value"]))
    _, ecfg = _configs(root, "eval")
    nerf_cfg = NerfConfig(voxel_grid_size=12, n_steps=80, train_rays=256, train_warmup_steps=25)
    paths = tmodes.mode_view_planning(
        ecfg.replace(show=False, evaluate=True), ["toy0"], method_ids=(4,), predictor=tpred,
        nerf_cfg=nerf_cfg, coverage_sizes=[budget, 100], device="cpu")
    metrics = os.path.join(paths[0], "metrics", f"{budget - 1}.txt")
    vals = dict(line.split() for line in open(metrics).read().splitlines())
    assert np.isfinite(float(vals["PSNR"])) and 0 < float(vals["SSIM"]) <= 1
    assert os.path.exists(os.path.join(paths[0], "train_time", f"{budget - 1}.txt"))


# ----------------------------------------------------------- command line


def test_cli_mode0_writes_view_spaces_like_jax(tmp_path, capsys):
    """The two generators draw other start points, so the files are held
    by their form: the same sizes, the pole first, unit rows."""
    args = ["--mode", "0", "--sizes", "3", "4", "5"]
    assert jcli.main(args + ["--workspace", str(tmp_path / "j")]) == 0
    assert tcli.main(args + ["--workspace", str(tmp_path / "t"), "--device", "cpu"]) == 0
    assert capsys.readouterr().out.count("System over.") == 2
    jdir, tdir = (str(tmp_path / w / "view_space" / "Hemisphere") for w in ("j", "t"))
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == ["3.txt", "4.txt", "5.txt"]
    for n in (3, 4, 5):
        t, j = np.loadtxt(os.path.join(tdir, f"{n}.txt")), np.loadtxt(os.path.join(jdir, f"{n}.txt"))
        assert t.shape == j.shape == (n, 3)
        np.testing.assert_array_equal(t[0], [0, 0, 1])
        np.testing.assert_allclose(np.linalg.norm(t, axis=1), 1, atol=1e-6)


def test_cli_mode20_paths_equal_jax(tmp_path):
    """The same view-space files give the same TSP path files."""
    jdir, tdir = (str(tmp_path / w / "view_space" / "Hemisphere") for w in ("j", "t"))
    for n in (3, 6, 9, 12):
        jhemi.save_view_space(jdir, jhemi.generate_hemisphere(n, seed=n, restarts=2, steps=100))
    shutil.copytree(jdir, tdir)
    args = ["--mode", "20", "--sizes", "3", "6", "9", "12"]
    assert jcli.main(args + ["--workspace", str(tmp_path / "j")]) == 0
    assert tcli.main(args + ["--workspace", str(tmp_path / "t"), "--device", "cpu"]) == 0
    for n in (3, 6, 9, 12):
        assert open(os.path.join(tdir, f"{n}_path.txt")).read() == open(os.path.join(jdir, f"{n}_path.txt")).read()


# ---------------------------------------------------------------- servers


def test_train_server_roundtrip(tmp_path):
    root = str(tmp_path)
    interact = os.path.join(root, "interact")
    os.makedirs(interact)
    marker = os.path.join(root, "ran.txt")
    with open(os.path.join(interact, "run_with_c++.py"), "w") as f:
        f.write(f"open(r'{marker}', 'w').write('done')\n")
    open(os.path.join(interact, "ready_c++.txt"), "w").close()
    train_server.serve(root, poll_s=0.05, once=True)
    assert open(marker).read() == "done"
    assert os.path.exists(os.path.join(interact, "ready_py.txt"))
    assert not os.path.exists(os.path.join(interact, "ready_c++.txt"))


def test_infer_server_roundtrip_matches_jax(tmp_path):
    """The reference's wire format: pattern-[0, 1, 3] PNGs in data/images/,
    ready_c++.txt in; view_budget.txt and ready_py.txt out, with the JAX
    predictor's budget on the same images and weights."""
    root = str(tmp_path)
    images = os.path.join(root, "data", "images")
    os.makedirs(images)
    rng = np.random.default_rng(6)
    for idx in (0, 1, 3):
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8), "RGB").save(
            os.path.join(images, f"{idx}.png"))
    tree = _atto_tree()
    tree["fc4"]["bias"] = np.full_like(tree["fc4"]["bias"], 0.4)
    ckpt = os.path.join(root, "best_checkpoint.pth")
    torch.save({"model_state_dict": prvnet_state_dict_from_flax(tree)}, ckpt)
    open(os.path.join(root, "data", "ready_c++.txt"), "w").close()
    infer_server.serve(root, ckpt, poll_s=0.05, once=True, device="cpu", arch="convnextv2_atto", crop=64)
    got = int(open(os.path.join(root, "data", "view_budget.txt")).read())
    jp = jinfer.BudgetPredictor(params=tree, arch="convnextv2_atto", crop=64)
    assert got == jp.predict_from_dir(images) and 13 <= got <= 58
    assert os.path.exists(os.path.join(root, "data", "ready_py.txt"))
    assert not os.path.exists(os.path.join(root, "data", "ready_c++.txt"))
