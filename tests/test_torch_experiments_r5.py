"""The port's last capability scripts beside the e2e (``nerf_prv_tpu_torch/
experiments``: the atto@180 arm of ``prvnet_recipe`` and its check,
``label_spread2`` and ``check_pilot2``, ``warmstart``) against the JAX
package's scripts and committed records: the atto configs field by field,
the checks' arithmetic, and tiny CPU runs of the pilot and the warm-start
study that write every key of the JAX artifacts."""

import dataclasses
import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from nerf_prv_tpu.prvnet.train import TrainConfig as JTrainConfig
from nerf_prv_tpu_torch.core.config import CameraConfig
from nerf_prv_tpu_torch.experiments import check_pilot2, check_prvnet, label_spread2, prvnet_recipe, warmstart
from nerf_prv_tpu_torch.experiments import label_protocol as lp

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "experiments"))
ART = os.path.join(REPO, "experiments", "artifacts")
RESULTS = os.path.join(REPO, "nerf_prv_tpu_torch", "experiments", "results")

TINY_CAM = dict(width=40, height=24, fx=28.6, fy=28.5, ppx=20.2, ppy=11.6, model=0)
# the fields of prvnet_r5_scaling.json that fix the atto arm's two stages
ATTO_FIELDS = ("batch_size", "accum_steps", "blr", "use_schedule", "pretrain_blr", "pretrain_schedule",
               "pretrain_epochs", "epochs", "image_size", "arch")


def _read(name):
    with open(os.path.join(ART, name)) as f:
        return json.load(f)


def _stand_in_540(viewspace):
    """A stand-in 540-view file (the size test reads the object's view space)."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(540, 3))
    v[:, 2] = np.abs(v[:, 2])
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    os.makedirs(viewspace, exist_ok=True)
    with open(os.path.join(viewspace, "540.txt"), "w") as f:
        f.writelines(f"{p[0]:.8g} {p[1]:.8g} {p[2]:.8g}\n" for p in v)


def test_atto_configs_equal_the_committed_run():
    """The atto arm's two ``TrainConfig``s hold ``prvnet_r5_scaling.json``'s
    fields and equal the JAX ``TrainConfig``s that ``exp_prvnet_r4.py``'s
    ``run_two_stage`` builds for ``--phase atto`` under the queue's
    ``PRV4_PRETRAIN_BLR=1.5e-4 PRV4_PRETRAIN_SCHEDULE=0 --epochs 200``; the
    tiny@180 defaults stay as they were."""
    rec = _read("prvnet_r5_scaling.json")
    pre, reg = prvnet_recipe.atto_pretrain_config(), prvnet_recipe.atto_regression_config()
    got = dict(batch_size=reg.batch_size, accum_steps=reg.accum_steps, blr=reg.blr, use_schedule=reg.use_schedule,
               pretrain_blr=pre.blr, pretrain_schedule=pre.use_schedule, pretrain_epochs=pre.epochs,
               epochs=reg.epochs, image_size=reg.image_size, arch=reg.arch)
    assert got == {k: rec[k] for k in ATTO_FIELDS}
    assert (pre.arch, pre.image_size, pre.batch_size, pre.accum_steps, pre.warmup_epochs) == (
        rec["arch"], rec["image_size"], 32, 1, 2)
    jpre = JTrainConfig(arch="convnextv2_atto", batch_size=32, accum_steps=1, epochs=2, image_size=180,
                        blr=1.5e-4, use_schedule=False, warmup_epochs=max(2 // 20, 2))
    jreg = JTrainConfig(arch="convnextv2_atto", batch_size=8, accum_steps=1, epochs=200, image_size=180,
                        blr=1.5e-4, use_schedule=False)
    for mine, want in ((pre, jpre), (reg, jreg)):
        want = dataclasses.asdict(want)
        assert {k: v for k, v in dataclasses.asdict(mine).items() if k in want} == want
    assert (prvnet_recipe.ARCH, prvnet_recipe.CROP, prvnet_recipe.BATCH, prvnet_recipe.EPOCHS) == (
        "convnextv2_tiny", 180, 64, 800)
    assert prvnet_recipe.RECIPES["tiny180"][:2] == (prvnet_recipe.pretrain_config, prvnet_recipe.regression_config)


@pytest.mark.parametrize("recipe", ["tiny180", "atto180"])
def test_run_two_stage_trains_the_recipes_configs(tmp_path, monkeypatch, recipe):
    """``run_two_stage(recipe=)`` hands each stage its recipe's config (the
    epochs the recipe's unless given) and records them in its artifact."""
    seen = {}

    def pretrain(ds_root, train_split, val_split, cfg, **kw):
        seen["pre"] = cfg
        return None, {"l1_mean": 4.0}

    def train_regression(ds_root, train_split, val_split, cfg, pattern, checkpoint_dir, **kw):
        seen["reg"] = cfg
        os.makedirs(checkpoint_dir, exist_ok=True)
        with open(os.path.join(checkpoint_dir, "log.jsonl"), "w") as f:
            f.write(json.dumps({"l1_mean": 3.0}) + "\n")
        return None, {"accuracy": 0.2, "l1_mean": 3.0, "l1_std": 2.0}

    monkeypatch.setattr(prvnet_recipe, "pretrain", pretrain)
    monkeypatch.setattr(prvnet_recipe, "train_regression", train_regression)
    monkeypatch.setattr(prvnet_recipe, "val_metrics", lambda *a: {"val_pred_gt_corr": 0.5})
    for split in ("train_split.txt", "val_split.txt"):
        (tmp_path / split).write_text("a\nb\n")
    art = prvnet_recipe.run_two_stage(str(tmp_path), str(tmp_path / "out"), seed=2, device="cpu", recipe=recipe)
    make_pre, make_reg, pre_epochs, epochs = prvnet_recipe.RECIPES[recipe]
    assert seen["pre"] == make_pre(2, pre_epochs) and seen["reg"] == make_reg(2, epochs)
    assert (art["recipe"], art["arch"], art["seed"], art["batch_size"], art["pretrain_batch_size"], art["epochs"],
            art["pretrain_epochs"]) == (recipe, seen["reg"].arch, 2, seen["reg"].batch_size,
                                        seen["pre"].batch_size, epochs, pre_epochs)
    assert art["val_l1_by_epoch"] == [3.0] and art["val_pred_gt_corr"] == 0.5


def test_check_prvnet_atto_record_and_tables():
    """The atto check reads the committed record and its 200-epoch log, and
    lays each seed's val predictions and span beside the committed ones."""
    ref = check_prvnet.committed(recipe="atto180")
    assert (ref["best_val_l1_mean"], ref["val_pred_gt_corr"], ref["epochs"]) == (2.973, 0.6812, 200)
    assert len(ref["val_l1_by_epoch"]) == 200 and min(ref["val_l1_by_epoch"]) == pytest.approx(2.973, abs=5e-4)
    assert len(ref["val_per_object"]) == check_prvnet.N_VAL
    names = sorted(ref["val_per_object"])
    seeds = {"0": dict(val_per_object={n: {"pred": 30.0 + i} for i, n in enumerate(names)},
                      val_pred_min_max=[30.0, 30.0 + len(names) - 1]),
             "1": dict(val_per_object={n: {"pred": 28.0} for n in names}, val_pred_min_max=[28.0, 28.0])}
    table = check_prvnet.prediction_table(seeds, ref)
    assert table["span"] == {"seed 0": len(names) - 1, "seed 1": 0.0, "committed": pytest.approx(18.0)}
    row = table["per_object"][names[3]]
    assert row == dict(gt=ref["val_per_object"][names[3]]["gt"], committed=ref["val_per_object"][names[3]]["pred"],
                       **{"seed 0": 33.0, "seed 1": 28.0})
    assert check_prvnet.committed()["epochs"] == 800  # the default recipe's record is unchanged


def test_pilot2_limit_and_summary():
    """L = 8 and the port's earlier seed-0 labels come from the label check's
    result; the summary lays each seed's label beside the committed one."""
    lim = check_pilot2.label_limit()
    assert lim["L"] == 8 and lim["port_seed0_labels"] == {"nos0": 38, "nos7": 63, "fan0": 37}
    ref = check_pilot2.committed_pilot2()
    assert {n: (o["label"], o["converged"]) for n, o in ref["objects"].items()} == {
        "nos0": (36, True), "nos7": (57, True), "fan0": (34, True), "fan7": (25, True)}
    runs = {f"{n}@{s}": dict(label=ref["objects"][n]["label"] + d, converged=s != 2)
            for n in label_spread2.PILOT2 for s, d in zip((0, 1, 2), (0, 9, -3))}
    rows = check_pilot2.summarize(runs, ref, lim)
    assert rows["nos7"]["labels"] == {0: 57, 1: 66, 2: 54} and rows["nos7"]["seed_range"] == 12
    assert rows["fan7"]["within_L"] == {0: True, 1: False, 2: True}
    assert rows["fan0"]["converged"] == {0: True, 1: True, 2: False}
    assert rows["nos0"]["mean"] == pytest.approx(38.0)


def test_pilot2_artifact_keys_equal_the_committed():
    """``pilot2_artifact`` writes exp_label_spread2.py's keys, and the
    committed artifact's own labels give back its distinct labels."""
    ref = _read("label_spread_pilot2.json")
    out = {n: (o["label"], o["converged"]) for n, o in ref["objects"].items()}
    art = label_spread2.pilot2_artifact(out, ref["seconds_per_object"], ref["total_seconds"])
    assert art == ref
    assert label_spread2.PILOT2 == tuple(importlib.import_module("exp_label_spread2").PILOT2)


def test_label_spread2_tiny_writes_every_key_of_the_jax_artifact(tmp_path, monkeypatch):
    """``run_pilot2`` through the port's label protocol on the CPU at a tiny
    size (one object, counts 3 and 7, 8-step fields, 40x24 frames): the
    committed artifact's keys, a label that the label file gives back."""
    real = lp.pipeline_config
    monkeypatch.setattr(label_spread2, "pipeline_config", lambda root: real(root).replace(
        camera=CameraConfig(**TINY_CAM), coverage_view_num_max=7, n_steps=8))
    monkeypatch.setattr(label_spread2, "PILOT2", ("nos0",))
    cfg = label_spread2.pipeline_config(str(tmp_path))
    _stand_in_540(cfg.viewspace_path)
    art = label_spread2.run_pilot2(str(tmp_path), device="cpu")
    assert set(art) == set(_read("label_spread_pilot2.json"))
    assert set(art["objects"]) == set(art["seconds_per_object"]) == {"nos0"}
    rec = lp.object_record(cfg, "nos0")
    assert art["objects"]["nos0"] == {"label": rec["label"], "converged": rec["converged"]}
    assert art["distinct_labels"] == ([rec["label"]] if rec["label"] > 0 else [])
    with open(os.path.join(cfg.viewspace_path, "7.txt")) as f:  # the reference's file, installed
        assert f.read() == open(os.path.join(lp.VIEWSPACE_DIR, "7.txt")).read()


def _jax_warm_summary(base, arm, counts):
    """exp_warmstart.py:84-91 on ({wall, psnrs, fit}) tuples."""
    wall, psnrs, fit = arm
    dpsnr = max(abs(psnrs[v] - base[1][v]) for v in counts)
    dcurve = float(np.abs(fit.curve - base[2].curve).max())
    dlab = int(abs(fit.gradient_labels[1] - base[2].gradient_labels[1]))
    return base[0] / wall, dpsnr, dcurve, dlab


def test_warmstart_summary_formulas_equal_the_jax_script():
    """``compare_arms`` is exp_warmstart.py's speedup, max |dPSNR|, max
    |dcurve| and |d grad@0.02| on the same fixed inputs."""
    rng = np.random.default_rng(4)
    counts = warmstart.COUNTS + [100]

    class Fit:
        def __init__(self, curve, grad):
            self.curve, self.gradient_labels = np.asarray(curve), np.asarray(grad)

    arms = {}
    for arm, wall in (("scratch", 812.5), ("warm800", 351.25)):
        psnr = {v: float(20 + 0.1 * v + rng.normal()) for v in counts}
        fit = Fit(rng.normal(size=98) + 25, rng.integers(3, 50, size=4))
        arms[arm] = (dict(wall_s=wall, psnr={str(v): p for v, p in psnr.items()}, curve=fit.curve.tolist(),
                          gradient_labels=fit.gradient_labels.tolist()), (wall, psnr, fit))
    got = warmstart.compare_arms(arms["scratch"][0], arms["warm800"][0])
    want = _jax_warm_summary(arms["scratch"][1], arms["warm800"][1], counts)
    assert (got["speedup"], got["max_abs_dpsnr"], got["max_abs_dcurve"], got["abs_d_grad_002"]) == want
    assert warmstart.summarize({"scratch": arms["scratch"][0], "warm800": arms["warm800"][0]}) == {"warm800": got}
    assert warmstart.ARMS == {"scratch": 0, "warm800": 800, "warm400": 400}
    assert warmstart.COUNTS == list(range(3, 51, 2))


def test_warmstart_config_equals_the_jax_script():
    from nerf_prv_tpu.core.config import Config as JConfig

    cfg = warmstart.warmstart_config("r")
    want = JConfig(workspace=os.path.join("r", "ws"), model_path=os.path.join("r", "models"),
                   viewspace_path=os.path.join("r", "ws", "viewspace"), name_of_pcd="toy0", n_steps=2500)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)


def test_warmstart_tiny_arms_write_every_key(tmp_path, monkeypatch):
    """Two arms on the CPU at a tiny size (counts 3, 5, 7 and 100 at 40x24,
    8-step fields, the warm arm 4 steps a count): each arm trains in its own
    workspace from the copied coverage sets, writes a metric file a count and
    the fit's labels; the warm arm starts from scratch at 3 views only."""
    real = warmstart.warmstart_config
    monkeypatch.setattr(warmstart, "warmstart_config", lambda root: real(root).replace(
        camera=CameraConfig(**TINY_CAM), coverage_view_num_max=7, n_steps=8))
    monkeypatch.setitem(warmstart.ARMS, "warm800", 4)
    cfg = warmstart.warmstart_config(str(tmp_path))
    _stand_in_540(cfg.viewspace_path)
    assert warmstart.prepare(str(tmp_path), "cpu") == cfg
    arms = {a: warmstart.run_arm(cfg, a, "cpu") for a in ("scratch", "warm800")}
    for arm, rec in arms.items():
        assert set(rec) == {"arm", "warm_start_steps", "wall_s", "psnr", "converged", "gap_labels",
                            "gradient_labels", "curve"}
        assert sorted(rec["psnr"], key=int) == ["3", "5", "7", "100"] and len(rec["curve"]) == 98
        assert all(np.isfinite(list(rec["psnr"].values())))
        gt = warmstart.arm_config(cfg, arm).gt_path
        assert sorted(f for f in os.listdir(gt) if f.endswith(".txt")) == ["100.txt", "3.txt", "5.txt", "7.txt",
                                                                           "size.txt"]
    assert (arms["scratch"]["warm_start_steps"], arms["warm800"]["warm_start_steps"]) == (0, 4)
    assert arms["scratch"]["psnr"]["3"] == arms["warm800"]["psnr"]["3"]  # the first count from scratch in both
    assert arms["scratch"]["psnr"]["5"] != arms["warm800"]["psnr"]["5"]
    s = warmstart.summarize(arms)
    assert set(s) == {"warm800"} and set(s["warm800"]) == {"speedup", "max_abs_dpsnr", "max_abs_dcurve",
                                                          "abs_d_grad_002"}


def test_entry_points_ask_for_the_cpu_without_a_card(tmp_path):
    """Without a card the scripts raise at once unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        label_spread2.run_pilot2(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        warmstart.main(["--root", str(tmp_path), "--out", str(tmp_path / "w.json"), "--log", str(tmp_path / "w.log")])
