"""The port's hd arm (``nerf_prv_tpu_torch/experiments``: the 1280x720 PVB
sets of ``corpus_dataset``, the tiny@720 recipe of ``prvnet_recipe``,
``HDPredictor`` in ``mode7_compare``, ``tiny720`` and ``check_hd``) against
the JAX package's ``exp_dataset300.py``, ``exp_prvnet_r4.py --phase tiny``,
``exp_mode7_r4.py`` and ``exp_tiny720.py``: the hd PNGs byte for byte, the
hd dataset's links, drops and splits, the recipe's configs field by field,
16 x 4 accumulation against the reference's 8 x 8 (in small), the
predictor's budget and its fallback, and the step measurement's halving."""

import dataclasses
import importlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from nerf_prv_tpu.core.config import CameraConfig as JCameraConfig
from nerf_prv_tpu.core.config import Config as JConfig
from nerf_prv_tpu.pipeline import modes as jmodes
from nerf_prv_tpu.prvnet import infer as jinfer
from nerf_prv_tpu.prvnet import train as jtrain
from nerf_prv_tpu.scene.object_setup import load_object as jload_object
from nerf_prv_tpu.viewspace import hemisphere as jhemi
from nerf_prv_tpu_torch.core.config import CameraConfig
from nerf_prv_tpu_torch.experiments import check_hd, corpus_dataset, prvnet_recipe, tiny720
from nerf_prv_tpu_torch.experiments import label_protocol as lp
from nerf_prv_tpu_torch.experiments.mode7_compare import HDPredictor, live_predictor
from nerf_prv_tpu_torch.prvnet import infer as tinfer
from nerf_prv_tpu_torch.prvnet import train as ttrain
from nerf_prv_tpu_torch.scene.object_setup import load_object
from nerf_prv_tpu_torch.convert import prvnet_state_dict_to_flax
from test_torch_prvnet_train import (
    ARCH, CPU, PARAM_FAR_LR, PARAM_FAR_SHARE, PARAM_MEDIAN_LR, SIZE, _batch, _jax_value_and_grad, _leaves,
    _port_model, _pvbnet_tree,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "experiments"))
jfam = importlib.import_module("families")
jspread = importlib.import_module("exp_label_spread")
jd300 = importlib.import_module("exp_dataset300")
jr4 = importlib.import_module("exp_prvnet_r4")
jm7 = importlib.import_module("exp_mode7_r4")
jt720 = importlib.import_module("exp_tiny720")
ART = os.path.join(REPO, "experiments", "artifacts")
HD_OBJECT = "blo0"  # the smallest family (80,000 points), a committed train object
# the continuous budget, port against JAX from the same weights (chip_smoke.py's
# card-against-CPU limit; test_torch_prvnet_train.py holds the two within 1e-3)
HD_BUDGET_ATOL = 1e-4


def _fill_540(viewspace):
    """A 540-view file (``load_object`` reads the object's view space) written
    on both sides, so neither package spends minutes on a 540-point descent."""
    z = np.linspace(0.0, 1.0, 540, endpoint=False)
    a = np.arange(540) * 2.399963229728653
    r = np.sqrt(1.0 - z * z)
    jhemi.save_view_space(viewspace, np.stack([r * np.cos(a), r * np.sin(a), z], 1))


def test_hd_sets_equal_the_jax_writer_byte_for_byte(tmp_path):
    """One family object's hd sets at 1280x720 (16 and 5 views): the port's
    ``render_hd_sets`` writes ``exp_dataset300._render_pvb_sets``'s
    transforms and PNGs byte for byte, from the reference's view spaces
    (its generator's files, as every object after the first read them);
    ``pvb_cfg`` is ``_pvb_cfg``'s camera and ``hd_done`` is ``_pvb_done``."""
    base = jspread.pipeline_config()
    jcfg = JConfig(**{**dataclasses.asdict(base), "camera": JCameraConfig(**dataclasses.asdict(base.camera)),
                      "workspace": str(tmp_path / "jax" / "ws"), "model_path": str(tmp_path / "models"),
                      "viewspace_path": str(tmp_path / "jax" / "vs"), "name_of_pcd": HD_OBJECT})
    tcfg = lp.pipeline_config(str(tmp_path / "port")).replace(model_path=str(tmp_path / "models"),
                                                              name_of_pcd=HD_OBJECT)
    assert dataclasses.asdict(corpus_dataset.pvb_cfg(tcfg).camera) == dataclasses.asdict(jd300._pvb_cfg(jcfg).camera)
    assert corpus_dataset.pvb_cfg(tcfg).camera == CameraConfig() and corpus_dataset.HD_VIEWS == jd300.HD_VIEWS == 16
    for vs in (jcfg.viewspace_path, tcfg.viewspace_path):
        _fill_540(vs)
    jmodes.mode_view_cover(jcfg, sizes=[5])
    jhemi.save_view_space(jcfg.viewspace_path, jhemi.generate_hemisphere(jd300.HD_VIEWS))
    lp.install_reference_viewspace(tcfg, [5, corpus_dataset.HD_VIEWS], probe=False)
    for n in (5, 16):
        assert open(os.path.join(tcfg.viewspace_path, f"{n}.txt")).read() == open(
            os.path.join(jcfg.viewspace_path, f"{n}.txt")).read()
    jfam.make_family_object(HD_OBJECT, os.path.join(jcfg.model_path, "ShapeNet"))
    jscene = jload_object(jcfg, HD_OBJECT)
    for gt in (jcfg.gt_path, tcfg.gt_path):  # the 320x180 64-view set is not compared: a stand-in marks it done
        os.makedirs(gt, exist_ok=True)
        open(os.path.join(gt, "64.json"), "w").write("{}")
    jd300._render_pvb_sets(jscene, jcfg)
    scene = load_object(tcfg, HD_OBJECT, device="cpu")
    assert not corpus_dataset.hd_done(tcfg) and not corpus_dataset.hd_done(tcfg, hd_train=False)
    corpus_dataset.render_hd_sets(scene, tcfg, hd_train=True, device="cpu")
    jhd, thd = os.path.join(jcfg.gt_path, "hd"), corpus_dataset.hd_path(tcfg)
    files = [f"{n}.json" for n in (16, 5)] + [f"{n}/rgbaClip_{i}.png" for n in (16, 5) for i in range(n)]
    differ = [f for f in files if open(os.path.join(thd, f), "rb").read() != open(os.path.join(jhd, f), "rb").read()]
    assert not differ, differ
    assert Image.open(os.path.join(thd, "5", "rgbaClip_0.png")).size == (1280, 720)
    for train in (True, False):
        assert corpus_dataset.hd_done(tcfg, train) == jd300._pvb_done(jcfg, train) is True
    for cfg in (jcfg, tcfg):
        os.remove(os.path.join(cfg.gt_path, "hd", "16.json"))
    assert corpus_dataset.hd_done(tcfg, False) == jd300._pvb_done(jcfg, False) is True
    assert corpus_dataset.hd_done(tcfg, True) == jd300._pvb_done(jcfg, True) is False


def _png(path, value):
    Image.fromarray(np.full((4, 6, 4), value, np.uint8), "RGBA").save(path)


def test_assemble_hd_dataset_links_filters_and_drops(tmp_path, capsys):
    """``pvb_dataset_hd`` from stub coverage folders: every object's 16 hd
    PNGs hard-linked with its label, a link to another render replaced, a
    stale index >= 16 removed; an object missing one PNG is dropped with a
    printed line; the split files are ``pvb_dataset``'s filtered to the
    complete objects."""
    cfg = lp.pipeline_config(str(tmp_path))
    roster = corpus_dataset.corpus_roster()
    train = [n for n in roster["labels"] if n not in roster["val"]][:3]
    val = [n for n in roster["val"]][:2]
    names = train + val
    for name in names:
        gt = cfg.replace(name_of_pcd=name).gt_path
        os.makedirs(os.path.join(gt, "64"))
        _png(os.path.join(gt, "64", "rgbaClip_0.png"), 1)
        os.makedirs(os.path.join(gt, "hd", "16"))
        for j in range(16):
            _png(os.path.join(gt, "hd", "16", f"rgbaClip_{j}.png"), j)
    missing, relinked = train[1], val[0]
    os.remove(os.path.join(cfg.replace(name_of_pcd=missing).gt_path, "hd", "16", "rgbaClip_7.png"))
    hd_root = tmp_path / "ws" / "pvb_dataset_hd"
    os.makedirs(hd_root / relinked)
    _png(hd_root / relinked / "rgbaClip_3.png", 200)  # an earlier render at the same index
    _png(hd_root / relinked / "rgbaClip_40.png", 9)  # a larger earlier view space's
    ds = corpus_dataset.assemble_dataset(cfg, names=names)
    hd = corpus_dataset.assemble_hd_dataset(cfg, ds)
    assert f"dropped {missing}: 15/16 images" in capsys.readouterr().out
    assert hd["dropped"] == {missing: 15} and hd["linked"] == sorted(set(names) - {missing})
    assert hd["train"] == [n for n in ds["train"] if n != missing] and hd["val"] == ds["val"] == sorted(val)
    for split in ("train_split.txt", "val_split.txt", "names_all.txt"):
        want = [n for n in open(os.path.join(ds["root"], split)).read().split() if n != missing]
        assert open(hd_root / split).read().split() == want
    for name in names:
        src = os.path.join(cfg.replace(name_of_pcd=name).gt_path, "hd", "16")
        pngs = sorted(f for f in os.listdir(hd_root / name) if f.endswith(".png"))
        assert open(hd_root / name / "view_budget.txt").read() == str(roster["labels"][name])
        assert len(pngs) == (15 if name == missing else 16)
        for f in pngs:
            assert os.path.samefile(os.path.join(src, f), hd_root / name / f)
    assert hd["labels"] == {n: roster["labels"][n] for n in hd["linked"]}


def _jax_tiny_configs(tmp_path, monkeypatch) -> dict:
    """The JAX ``TrainConfig``s and view space that ``exp_prvnet_r4.py
    --phase tiny`` hands its two stages, captured by stubbing the trainers."""
    from nerf_prv_tpu import prvnet as jprvnet
    from nerf_prv_tpu.parallel import mesh as jmesh

    seen = {}

    def pretrain(ds_root, train_split, val_split, cfg, viewspace_size, **kw):
        seen["pre"], seen["viewspace_size"] = cfg, viewspace_size
        return None, {"l1_mean": 4.0}

    def train_regression(ds_root, train_split, val_split, cfg, pattern, **kw):
        seen["reg"], seen["pattern"] = cfg, list(pattern)
        return None, {"accuracy": 0.2, "l1_mean": 3.0, "l1_std": 2.0}

    for var in ("PRV4_TINY_TAG", "PRV4_TINY_PRETRAIN_EPOCHS", "PRV4_PRETRAIN_BLR", "PRV4_PRETRAIN_SCHEDULE",
                "PRV4_REG_BLR", "PRV4_REG_SCHEDULE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(jtrain, "pretrain", pretrain)
    monkeypatch.setattr(jprvnet, "train_regression", train_regression)
    monkeypatch.setattr(jmesh, "make_mesh", lambda *a, **k: None)
    monkeypatch.setattr(jr4, "_val_metrics", lambda *a: {})
    monkeypatch.setattr(jr4, "ROOT", str(tmp_path))
    monkeypatch.setattr(jr4, "ART", str(tmp_path / "art"))
    os.makedirs(tmp_path / "art")
    ds = tmp_path / "ws" / "pvb_dataset_hd"
    os.makedirs(ds)
    for split in ("train_split.txt", "val_split.txt"):
        (ds / split).write_text("a\nb\n")
    monkeypatch.setattr(sys, "argv", ["exp_prvnet_r4.py", "--phase", "tiny"])
    jr4.main()
    return seen


def test_tiny720_configs_equal_the_jax_phase_tiny(tmp_path, monkeypatch):
    """The tiny@720 recipe's two ``TrainConfig``s equal, field by field, the
    ones ``exp_prvnet_r4.py --phase tiny`` builds, but for the
    accumulation: the port makes batch 64 of 4 x 16 images (pretrain) and
    16 x 4 objects (regression) where the reference takes 8 x 8; both
    pretrain on the hd set's 16 views and regress on five; the epochs and
    the committed record agree."""
    seen = _jax_tiny_configs(tmp_path, monkeypatch)
    make_pre, make_reg, n_pre, n_reg = prvnet_recipe.RECIPES["tiny720"]
    pre, reg = make_pre(0, n_pre), make_reg(0, n_reg)
    for mine, want in ((pre, seen["pre"]), (reg, seen["reg"])):
        want = dataclasses.asdict(want)
        got = {k: v for k, v in dataclasses.asdict(mine).items() if k in want}
        assert set(want) <= set(dataclasses.asdict(mine))
        assert {k: v for k, v in got.items() if k != "accum_steps"} == {
            k: v for k, v in want.items() if k != "accum_steps"}
        assert want["accum_steps"] == 8 and want["batch_size"] == mine.batch_size == 64
    assert (pre.accum_steps, pre.micro_batch, reg.accum_steps, reg.micro_batch) == (4, 16, 16, 4)
    assert seen["viewspace_size"] == prvnet_recipe.VIEWSPACE["tiny720"] == corpus_dataset.HD_VIEWS
    assert seen["pattern"] == prvnet_recipe.PATTERN
    rec = json.load(open(os.path.join(ART, "prvnet_tiny720.json")))
    assert (rec["image_size"], rec["viewspace_size"], rec["batch_size"], rec["pretrain_epochs"], rec["epochs"]) == (
        reg.image_size, prvnet_recipe.VIEWSPACE["tiny720"], reg.batch_size, n_pre, n_reg)


@pytest.mark.parametrize("recipe", ["tiny180", "atto180", "tiny720"])
def test_run_two_stage_takes_size_view_space_and_accumulation_from_the_recipe(tmp_path, monkeypatch, recipe):
    """``run_two_stage``'s artifact records the recipe's crop, view space and
    accumulation, and the pretrain reads that view space: the tiny@180 and
    atto@180 artifacts keep their keys and values (180, 64, 1)."""
    seen = {}

    def pretrain(ds_root, train_split, val_split, cfg, viewspace_size, **kw):
        seen["viewspace_size"] = viewspace_size
        return None, {"l1_mean": 4.0}

    def train_regression(ds_root, train_split, val_split, cfg, pattern, checkpoint_dir, **kw):
        os.makedirs(checkpoint_dir, exist_ok=True)
        with open(os.path.join(checkpoint_dir, "log.jsonl"), "w") as f:
            f.write(json.dumps({"l1_mean": 3.0}) + "\n")
        return None, {"accuracy": 0.2, "l1_mean": 3.0, "l1_std": 2.0}

    monkeypatch.setattr(prvnet_recipe, "pretrain", pretrain)
    monkeypatch.setattr(prvnet_recipe, "train_regression", train_regression)
    monkeypatch.setattr(prvnet_recipe, "val_metrics", lambda *a: {})
    for split in ("train_split.txt", "val_split.txt"):
        (tmp_path / split).write_text("a\nb\n")
    art = prvnet_recipe.run_two_stage(str(tmp_path), str(tmp_path / "out"), device="cpu", recipe=recipe)
    want = {"tiny180": (180, 64, 1), "atto180": (180, 64, 1), "tiny720": (720, 16, 16)}[recipe]
    assert (art["image_size"], art["viewspace_size"], art["accum_steps"]) == want
    assert seen["viewspace_size"] == want[1]
    assert list(art) == [
        "recipe", "arch", "seed", "image_size", "viewspace_size", "batch_size", "accum_steps", "pretrain_batch_size",
        "blr", "use_schedule", "pretrain_blr", "pretrain_schedule", "pretrain_warmup_epochs", "n_train", "n_val",
        "pretrain_epochs", "pretrain_best_l1", "pretrain_seconds", "epochs", "best_val_accuracy",
        "best_val_l1_mean", "best_val_l1_std", "train_seconds", "val_l1_by_epoch"]
    cut = prvnet_recipe.run_two_stage(str(tmp_path), str(tmp_path / "cut"), device="cpu", recipe=recipe,
                                      regression_batch=2)
    assert (cut["batch_size"], cut["accum_steps"]) == (2, 2 if recipe == "tiny720" else 1)


def test_accumulation_4x2_matches_jax_2x4_on_the_same_objects():
    """One regression application at accumulation 4 x 2 from the same
    converted weights lands where JAX's 2 x 4 (its loss gradients through
    ``MultiSteps`` over its AdamW) lands on the same 8 objects, in
    test_torch_prvnet_train.py's units for accumulated applications: the
    16 x 4 against 8 x 8 of the tiny@720 recipe, in small.  An epoch's
    resident order takes the same 64 objects under either split."""
    jm, tree = _pvbnet_tree(61)
    base = dict(arch=ARCH, batch_size=8, epochs=1, image_size=SIZE, blr=0.05)
    cfg_j = jtrain.TrainConfig(**base, accum_steps=2)
    vg = _jax_value_and_grad(jm, cfg_j)
    opt = optax.MultiSteps(jtrain.make_optimizer(cfg_j, tree, steps_per_epoch=1), every_k_schedule=2)
    update = jax.jit(opt.update)
    views, labels = _batch(62, 8)
    params, state = jax.tree.map(jnp.asarray, tree), opt.init(tree)
    for i in (0, 4):
        _, g = vg(params, jnp.asarray(views[i:i + 4]), jnp.asarray(labels[i:i + 4]))
        updates, state = update(g, state, params)
        params = optax.apply_updates(params, updates)
    model = _port_model(tree)
    step = ttrain.make_train_step(model, ttrain.TrainConfig(**base, accum_steps=4), steps_per_epoch=1, mesh=CPU)
    for i in range(0, 8, 2):
        step(views[i:i + 2], labels[i:i + 2])
    assert step.count == 1
    got = _leaves(prvnet_state_dict_to_flax(model.state_dict()))
    want, start = _leaves(params), _leaves(tree)
    lr = cfg_j.lr
    moved = np.median(np.concatenate([np.abs(want[k] - start[k]).ravel() for k in want])) / lr
    gaps = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want]) / lr
    far = float((gaps > PARAM_FAR_LR).mean())
    assert moved > 0.5, moved
    assert np.median(gaps) <= PARAM_MEDIAN_LR and far <= PARAM_FAR_SHARE and gaps.max() <= 2, (
        float(np.median(gaps)), far, float(gaps.max()))
    reg = prvnet_recipe.tiny720_regression_config()
    ours = ttrain._resident_epoch_indices(90, reg, np.random.default_rng(0))
    ref = jtrain._resident_epoch_indices(90, jtrain.TrainConfig(batch_size=64, accum_steps=8),
                                         np.random.default_rng(0))
    assert ours.shape == (1, 16, 4) and ref.shape == (1, 8, 8)
    np.testing.assert_array_equal(ours.ravel(), ref.ravel())


class _RecordedPort(tinfer.BudgetPredictor):
    def predict_from_arrays(self, views):
        self.values.append(self.predict_value_from_arrays(views))
        return super().predict_from_arrays(views)


class _RecordedJax(jinfer.BudgetPredictor):
    def predict_from_arrays(self, views):
        self.values.append(float(self._apply(self.params, jnp.asarray(views)[None])[0]))
        return super().predict_from_arrays(views)


def test_hd_predictor_gives_jax_budget_and_falls_back_to_qcam(tmp_path):
    """``HDPredictor`` around the port's predictor and ``exp_mode7_r4``'s
    around JAX's, from the same checkpoint: both read the hd set when it
    exists and the qcam one when ``hd/`` is missing, and their continuous
    budgets agree within HD_BUDGET_ATOL; ``live_predictor`` wraps only at
    crop 720 or more."""
    _, tree = _pvbnet_tree(63, k=3)
    tree["fc4"]["bias"] = np.full_like(tree["fc4"]["bias"], 0.4)
    ckpt = str(tmp_path / "best_checkpoint.msgpack")
    jtrain.save_checkpoint(ckpt, tree, {"epoch": 1})
    rng = np.random.default_rng(64)
    obj = tmp_path / "ws" / "obj"
    for sub, shape in (("5", (36, 48, 4)), (os.path.join("hd", "5"), (40, 72, 4))):
        os.makedirs(obj / sub)
        for i in range(5):
            Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), "RGBA").save(obj / sub / f"rgbaClip_{i}.png")
    port = _RecordedPort(ckpt, arch=ARCH, crop=SIZE, device="cpu")
    ref = _RecordedJax(ckpt, arch=ARCH, crop=SIZE)
    for p in (port, ref):
        p.values = []

    def ask():
        return (HDPredictor(port).predict_from_coverage(str(obj / "5"), [0, 1, 3]),
                jm7.HDPredictor(ref).predict_from_coverage(str(obj / "5"), [0, 1, 3]))

    budgets = [ask()]
    os.rename(obj / "hd", obj / "hd_gone")
    budgets.append(ask())
    assert all(a == b for a, b in budgets) and abs(port.values[0] - port.values[1]) > 1e-3
    for got, want in zip(port.values, ref.values):
        assert abs(got - want) <= HD_BUDGET_ATOL, (got, want)
    for direct in ("hd_gone", "."):
        tp = tinfer.BudgetPredictor(ckpt, arch=ARCH, crop=SIZE, device="cpu")
        v = tp.predict_value_from_arrays(tp.coverage_views(str(obj / direct / "5"), [0, 1, 3]))
        assert v == port.values[0 if direct == "hd_gone" else 1]
    assert isinstance(live_predictor(ckpt, ARCH, 720, device="cpu"), HDPredictor)
    assert isinstance(live_predictor(ckpt, ARCH, 180, device="cpu"), tinfer.BudgetPredictor)


def test_tiny720_halves_on_out_of_memory_and_raises_otherwise(monkeypatch):
    """``tiny720.run`` halves the batch from 64 on ``torch.OutOfMemoryError``
    only, records each attempt and projects the epochs at the batch that
    fits; any other error stops it at once.  ``measure`` itself runs a real
    step at a cut size, and the constants are ``exp_tiny720.py``'s."""
    assert (tiny720.N_VIEWS, tiny720.CROP, tiny720.ARCH) == (jt720.N_VIEWS, jt720.CROP, "convnextv2_tiny")
    tried = []

    def fits_at_8(bs, device):
        tried.append(bs)
        if bs > 8:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 9.00 GiB")
        return {"batch_size": bs, "objects_per_second": 10.0}

    monkeypatch.setattr(tiny720, "measure", fits_at_8)
    out = tiny720.run(torch.device("cpu"))
    assert tried == [64, 32, 16, 8] and out["batch_held"] == 8
    assert [a["batch_size"] for a in out["attempts"]] == [64, 32, 16, 8]
    assert all("out of memory" in a["error"] for a in out["attempts"][:3])
    assert out["epoch_seconds_3000_objects"] == 300.0 and out["epoch_seconds_120_objects"] == 12.0
    tried.clear()

    def broken(bs, device):
        tried.append(bs)
        raise RuntimeError("cuDNN error: CUDNN_STATUS_INTERNAL_ERROR")

    monkeypatch.setattr(tiny720, "measure", broken)
    with pytest.raises(RuntimeError, match="CUDNN"):
        tiny720.run(torch.device("cpu"))
    assert tried == [64]
    monkeypatch.undo()
    monkeypatch.setattr(tiny720, "ARCH", "convnextv2_atto")
    monkeypatch.setattr(tiny720, "CROP", 32)
    got = tiny720.measure(2, torch.device("cpu"))
    assert got["batch_size"] == 2 and len(got["step_seconds_all"]) == tiny720.TIMED_STEPS
    assert got["images_per_second"] == pytest.approx(10 / got["step_seconds"]) and got["n_params_m"] > 3


def test_check_hd_records_the_gate_and_projects_the_wall(tmp_path, monkeypatch):
    """``check_hd``: stage (d) records a refused predictor's verdict and is
    not run again once recorded; ``recipe_record`` sets a cut run beside the
    committed tiny@720 record at its own epochs and projects the full
    protocol's wall from the seconds an epoch."""
    monkeypatch.setattr(check_hd, "LOG_DIR", str(tmp_path / "copies"))
    root, out = tmp_path / "ws", tmp_path / "hd.json"
    run_dir = root / "tiny720_seed0_p100_e800"
    os.makedirs(run_dir)
    (run_dir / "result.json").write_text(json.dumps({"val_pred_gt_corr": 0.05, "val_pred_min_max": [30.0, 31.0]}))
    argv = ["--root", str(root), "--device", "cpu", "--stages", "d", "--out", str(out), "--log", str(tmp_path / "l")]
    assert check_hd.main(argv) == 0
    d = json.load(open(out))["d"]
    assert d["passed"] is False and "corr 0.050" in d["reason"]
    (run_dir / "result.json").write_text(json.dumps({"val_pred_gt_corr": 0.9, "val_pred_min_max": [20.0, 40.0]}))
    assert check_hd.main(argv) == 0 and json.load(open(out))["d"] == d

    os.makedirs(run_dir / "pretrain")
    (run_dir / "pretrain" / "pretrain_log.jsonl").write_text("".join(
        json.dumps({"l1_mean": v}) + "\n" for v in (4.5, 4.1, 4.2)))
    art = dict(seed=0, pretrain_epochs=3, epochs=10, pretrain_seconds=110.0, train_seconds=120.0,
               val_pred_min_max=[25.0, 37.5], val_per_object={}, best_val_l1_mean=3.9)
    rec = check_hd.recipe_record(art, str(run_dir), probe=dict(pretrain_seconds=60.0, train_seconds=30.0))
    ref = json.load(open(os.path.join(ART, "prvnet_tiny720.json")))
    log = [json.loads(line)["l1_mean"] for line in open(os.path.join(ART, "prvnet_tiny720_ckpt", "log.jsonl"))]
    assert rec["cut"] and rec["full_epochs"] == [100, 800] and rec["val_pred_span"] == 12.5
    assert rec["pretrain_l1_by_epoch"] == [4.5, 4.1, 4.2]
    assert rec["committed"]["best_val_l1_mean"] == ref["best_val_l1_mean"] == 2.854
    assert rec["committed"]["val_l1_at_epochs"] == log[9] and rec["committed"]["best_val_l1_within_epochs"] == min(
        log[:10])
    pre, reg = rec["projection"]["pretrain"], rec["projection"]["regression"]
    assert (pre["seconds_an_epoch"], pre["fixed_seconds"]) == (25.0, 35.0)
    assert (reg["seconds_an_epoch"], reg["fixed_seconds"]) == (10.0, 20.0)
    assert rec["projection"]["projected_full_hours"] == pytest.approx((35 + 2500 + 20 + 8000) / 3600)
    assert rec["micro_batches"]["regression"] == "16 x 4 objects"
