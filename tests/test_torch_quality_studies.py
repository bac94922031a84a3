"""The quality studies' tables and runner (``nerf_prv_tpu_torch/experiments/
quality_studies.py``, ``check_quality.py``) against the JAX package's
scripts: each table against its script's arms (parsed with ``ast``), the
options training reads, shared fields bit-equal, render-only arms scored
alike by both packages, the artifact keys and the summary formulas."""

import ast
import dataclasses
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_prv_tpu.nerf import api as japi
from nerf_prv_tpu.nerf import model as jm
from nerf_prv_tpu_torch.experiments import check_quality as cq
from nerf_prv_tpu_torch.experiments import quality_studies as qst
from nerf_prv_tpu_torch.nerf import api as tapi
from nerf_prv_tpu_torch.nerf import model as tm
from nerf_prv_tpu_torch.nerf import train as ttrain
from nerf_prv_tpu_torch.nerf.rays import load_dataset
from synthetic import write_scene
from test_torch_api import METRIC_TOL

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(REPO, "experiments", "artifacts")


# --- each table against its script ---------------------------------------------------------------------


def _script(name):
    path = os.path.join(REPO, qst.STUDIES[name].script.split(":")[0])
    with open(path) as f:
        return ast.parse(f.read())


def _literal(node, env):
    """A constant, a tuple of them, a name bound in ``env`` or an integer
    shift (``1 << 17``)."""
    return eval(compile(ast.Expression(node), "<script>", "eval"), {"__builtins__": {}}, dict(env))


def _config_kw(node, env):
    """The keywords of ``NerfConfig(...)``, of ``dataclasses.replace(base,
    ...)`` or of a name bound to one of them."""
    if isinstance(node, ast.Name):
        return dict(env[node.id])
    assert isinstance(node, ast.Call), ast.dump(node)
    fn = ast.unparse(node.func)
    base = {} if fn == "NerfConfig" else _config_kw(node.args[0], env)
    assert fn in ("NerfConfig", "dataclasses.replace"), fn
    return dict(base, **{k.arg: _literal(k.value, env) for k in node.keywords})


def _assigned(tree, name):
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
            and any(isinstance(t, ast.Name) and t.id == name for t in n.targets)]


def _dict_arms(tree, name, env):
    (node,) = _assigned(tree, name)
    return {_literal(k, env): _config_kw(v, env) for k, v in zip(node.keys, node.values)}


def _loop(tree, target, pick=lambda loops: loops[-1]):
    loops = [n for n in ast.walk(tree) if isinstance(n, ast.For) and ast.unparse(n.target) == target]
    return _literal(pick(loops).iter, {})


def script_arms(name):
    """{label: NerfConfig keywords} of the script's quality table, with the
    script's own labels."""
    tree = _script(name)
    env = {}
    if name == "hashgrid_r3":  # for field in ("voxel", "hash"): NerfConfig(field_impl=field)
        return {f: dict(field_impl=f) for f in _loop(tree, "field")}
    if name == "adam_lowp":  # bf16 at the unroll the speed phase chose
        with open(os.path.join(ARTIFACTS, "adam_lowp.json")) as f:
            env["bf16_unroll"] = json.load(f)["bf16_best_unroll"]
        return _dict_arms(tree, "ARMS", env)
    if name == "quality":  # each train arm re-rendered at render_n_samples ns
        train, render = _dict_arms(tree, "train_variants", env), _literal(_assigned(tree, "render_variants")[0], {})
        return {f"{t} {r}": dict(kw, render_n_samples=ns) for t, kw in train.items() for r, ns in render.items()}
    if name == "pe":  # for pe: base = NerfConfig(voxel_pe_freqs=pe); for ns, chunk: render_n_samples=ns
        return {f"pe{pe} r{ns} c{chunk >> 10}k": dict(voxel_pe_freqs=pe, render_n_samples=ns)
                for pe in _loop(tree, "pe") for ns, chunk in _loop(tree, "(ns, chunk)")}
    if name == "baked_probe":  # the quality loop (the last over refresh) into NerfConfig(train_probe_refresh=...)
        (fn,) = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == "quality"]
        (cfg,) = _assigned(fn, "cfg")
        assert ast.unparse(cfg) == "NerfConfig(train_probe_refresh=refresh)"
        return {f"refresh {r}": dict(train_probe_refresh=r) for r in _loop(tree, "refresh")}
    if _assigned(tree, "base"):  # exp_render20.py: base = NerfConfig(), arms dataclasses.replace(base, ...)
        env["base"] = _config_kw(_assigned(tree, "base")[0], {})
    return _dict_arms(tree, "variants", env)


def _fields_of(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = dataclasses.asdict(v) if dataclasses.is_dataclass(v) else (
            np.dtype(v).name if f.name == "compute_dtype" and not isinstance(v, torch.dtype) else
            str(v).split(".")[-1] if f.name == "compute_dtype" else v)
    return out


@pytest.mark.parametrize("name", list(qst.STUDIES))
def test_table_equals_its_script(name):
    """The port's table has the script's labels in its order, and each arm's
    ``NerfConfig`` equals the JAX package's from the script's keywords,
    field by field."""
    want = script_arms(name)
    got = qst.STUDIES[name].arms
    assert list(got) == list(want)
    for label, kw in want.items():
        assert _fields_of(tm.NerfConfig(**got[label])) == _fields_of(jm.NerfConfig(**kw)), label


def test_the_quality_scenes_and_seeds_of_the_studies():
    assert {n: st.scenes for n, st in qst.STUDIES.items() if st.scenes != ("splat",)} == {
        "hashgrid_r3": ("splat", "thin"), "thin_geometry": ("thin",), "adam_lowp": ("splat", "thin"),
        "train16": ("splat", "thin"), "render20": ("splat", "thin"), "warmup2": ("splat", "thin"),
        "warmup3": ("splat", "thin"), "train24": ("splat", "thin_s1")}
    for name in ("hashgrid_r3", "train16", "render20", "warmup2", "warmup3"):
        assert qst.STUDIES[name].seeds == tuple(_loop(_script(name), "seed", pick=lambda loops: loops[0])), name
    assert cq.SEEDS["adam_lowp"] == cq.SEEDS["quality"] == cq.SIX and cq.SEEDS["warmup"] == (0,)


# --- shared fields ------------------------------------------------------------------------------------

CUT = dict(voxel_grid_size=12, n_steps=8, train_rays=256, train_warmup_steps=3)
RENDER_ONLY = dict(render_probe_fine=24, render_n_samples=32, render_probe_coarse=6, render_coarse=20,
                   train_scan_unroll=8, train_rng="fused", train_hit_oversample=2)


@pytest.fixture(scope="module")
def tiny_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("quality_tiny")
    train_json, test_json, _, _ = write_scene(str(root), n_train=5, n_test=3, n_points=5000)
    return train_json, test_json


def test_render_options_share_a_field():
    assert qst.field_key("splat", 0, {}) == qst.field_key("splat", 0, RENDER_ONLY) == "splat/s0/default"
    assert qst.eval_key(RENDER_ONLY) != qst.eval_key({}) == "default"
    for kw in (dict(n_samples=20), dict(train_warmup_rays=2048), dict(adam_moment_dtype="bfloat16"),
               dict(voxel_pe_freqs=2), dict(field_impl="hash")):
        assert qst.field_key("splat", 0, kw) != qst.field_key("splat", 0, {}), kw
    fields = qst.plan(cq.SEEDS)
    assert len(fields) == 127 and sum(f["kw"].get("field_impl") == "hash" for f in fields.values()) == 4
    assert sum(len(f["evals"]) for f in fields.values()) == 182


@pytest.mark.parametrize("name,per_field", [("hashgrid_r3", 2), ("thin_geometry", 1), ("quality", 5),
                                            ("trainrays", 5), ("gridsize", 3), ("adam_lowp", 2), ("train16", 2),
                                            ("render20", 1), ("warmup2", 4), ("warmup3", 3), ("train24", 3),
                                            ("warmup", 3), ("pe", 2), ("baked_probe", 3)])
def test_each_study_trains_its_distinct_fields_once(name, per_field):
    st = qst.STUDIES[name]
    planned = qst.plan({name: st.seeds})
    assert len(planned) == per_field * len(st.scenes) * len(st.seeds)
    n_evals = len({qst.eval_key(kw) for kw in st.arms.values()})
    assert sum(len(f["evals"]) for f in planned.values()) == n_evals * len(st.scenes) * len(st.seeds)


def test_training_reads_only_the_train_options(tiny_scene):
    """Every NerfConfig field that training reads (recorded on a config
    whose attribute reads are logged, outside dataclass machinery) is in
    ``TRAIN_OPTIONS``: the voxel field with and without a warmup, with the
    baked probe, importance resampling, bf16 moments and the box bound, and
    the hash field."""
    from nerf_prv_tpu_torch.nerf.hashgrid import HashGridConfig

    names = {f.name for f in dataclasses.fields(tm.NerfConfig)}
    seen = set()

    @dataclasses.dataclass(frozen=True)
    class Recorded(tm.NerfConfig):
        def __getattribute__(self, k):
            if k in names:
                frame = sys._getframe(1)
                if "nerf_prv_tpu_torch" in frame.f_code.co_filename and frame.f_code.co_name != "__post_init__":
                    seen.add(k)
            return object.__getattribute__(self, k)

    ds = load_dataset(tiny_scene[0], with_images=True)
    for kw in (dict(), dict(train_warmup_steps=0), dict(train_probe_refresh=2), dict(n_importance=8),
               dict(adam_moment_dtype="bfloat16", train_warmup_rays=128), dict(bound="box"),
               dict(field_impl="hash", grid=HashGridConfig(levels=4, log2_table=12))):
        ttrain.train(ds, Recorded(**dict(CUT, **kw)), seed=0, device="cpu")
    assert seen <= set(qst.TRAIN_OPTIONS), seen - set(qst.TRAIN_OPTIONS)
    assert {"n_samples", "train_coarse", "train_rays", "voxel_grid_size", "adam_moment_dtype", "grid"} <= seen
    assert not {k for k in seen if k.startswith("render_")}


def test_training_is_bit_equal_under_render_only_options(tiny_scene):
    ds = load_dataset(tiny_scene[0], with_images=True)
    a, la = ttrain.train(ds, tm.NerfConfig(**CUT), seed=3, device="cpu")
    b, lb = ttrain.train(ds, tm.NerfConfig(**CUT, **RENDER_ONLY), seed=3, device="cpu")
    np.testing.assert_array_equal(la, lb)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# render-only arms of the tables (each on the field of the NerfConfig() it shares)
RENDER_ARMS = {"default": {}, "rp24": dict(render_probe_fine=24), "rp16 rs16": dict(render_probe_fine=16),
               "rp12": dict(render_probe_fine=12), "rs32": dict(render_n_samples=32),
               "rs24": dict(render_n_samples=24)}


@pytest.fixture(scope="module")
def jax_field(tiny_scene):
    """A tiny f32 voxel field trained by the JAX package, carried over."""
    kw = dict(voxel_grid_size=12, n_steps=60, train_rays=512, train_warmup_steps=20)
    jparams, _ = japi.train_nerf(tiny_scene[0], jm.NerfConfig(compute_dtype=jnp.float32, **kw), seed=0)
    from nerf_prv_tpu_torch.convert import params_from_numpy

    return kw, jparams, params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, device="cpu")


@pytest.mark.parametrize("arm", list(RENDER_ARMS))
def test_render_only_arms_score_alike_in_both_packages(tiny_scene, jax_field, arm):
    kw, jparams, tparams = jax_field
    ekw = dict(kw, **RENDER_ARMS[arm])
    theirs = japi.eval_nerf(jparams, tiny_scene[1], jm.NerfConfig(compute_dtype=jnp.float32, **ekw))
    ours = tapi.eval_nerf(tparams, tiny_scene[1], tm.NerfConfig(compute_dtype=torch.float32, **ekw))
    tol = METRIC_TOL["f32"]
    assert abs(ours["PSNR"] - theirs["PSNR"]) <= tol["psnr"], (ours, theirs)
    assert abs(ours["SSIM"] - theirs["SSIM"]) <= tol["ssim"], (ours, theirs)
    assert ours["PSNR"] > 15.0


# --- results: the scripts' artifact keys, the summary formulas, the check ------------------------------


def _fake_fields(seeds_by_study, seed=0):
    rng = np.random.default_rng(seed)
    return {k: dict(train_seconds=1.0, evals={e: dict(PSNR=35.5 + rng.normal() * 0.1, SSIM=0.99, min_PSNR=34.0,
                                                     eval_seconds=0.1) for e in f["evals"]})
            for k, f in qst.plan(seeds_by_study).items()}


def test_result_keys_equal_the_committed_artifacts():
    with open(os.path.join(ARTIFACTS, "hashgrid_r3.json")) as f:
        hg = json.load(f)
    with open(os.path.join(ARTIFACTS, "adam_lowp.json")) as f:
        al = json.load(f)
    fields = _fake_fields({"hashgrid_r3": (0, 1), "adam_lowp": cq.SIX})
    got = qst.study_result("hashgrid_r3", (0, 1), fields)["artifact"]
    voxel = {k: v for k, v in hg.items() if k.startswith("voxel/")}
    assert {k for k in got if k.startswith("voxel/")} == set(voxel)
    assert set(got) == set(voxel) | {k.replace("voxel/", "hash/") for k in voxel}
    assert all(set(got[k]) == set(voxel["voxel/splat/s0"]) for k in got)
    got = qst.study_result("adam_lowp", cq.SIX, fields)["artifact"]
    assert set(got["psnr"]) == set(al["psnr"]) and set(got["stats"]) == set(al["stats"])
    assert all(set(got["stats"][k]) == set(al["stats"][k]) for k in got["stats"] if isinstance(got["stats"][k], dict))


def test_adam_stats_reproduce_the_committed_stats_and_gate():
    with open(os.path.join(ARTIFACTS, "adam_lowp.json")) as f:
        al = json.load(f)
    assert qst.adam_stats(al["psnr"], cq.SIX) == al["stats"]
    assert al["stats"]["flip_default_to_bf16"] is False


def test_rows_name_arms_of_their_tables_and_collapsed_arms_are_collapsed():
    for row in cq.ROWS:
        arms = qst.STUDIES[row["study"]].arms
        if row["not_comparable"]:
            assert row["arm"] is None and row["decision"] is None
            continue
        assert row["arm"] in arms and row["reference"] in arms and row["decision"] in (
            "negative", "neutral", "not_negative"), row
        assert qst.eval_key(arms[row["arm"]]) != qst.eval_key(arms[row["reference"]]), row
    eq = lambda study, *labels: len({qst.eval_key(qst.STUDIES[study].arms[a]) for a in labels}) == 1  # noqa: E731
    assert eq("warmup", "w500s96 (prod)", "w500s48", "w125s48") and eq("warmup", "w250s96", "w250s48")
    assert eq("thin_geometry", "blk2 rp32 (prod)", "blk2 rp20")
    assert eq("train16", "s24 p8 (prod)", "s16 p8", "s16 p12")
    assert eq("render20", "rp24 rs24 (prod)", "rp24 rs16", "rp20 rs16")
    assert cq.one_seed_sd() == pytest.approx(0.1284, abs=1e-4)


def test_row_verdict_rules():
    studies = {"gridsize": dict(scenes=["splat"], arms={
        "G32": dict(runs={f"splat/s{s}": dict(PSNR=34.95 + 0.01 * s) for s in range(6)}),
        "G40 (prod)": dict(runs={f"splat/s{s}": dict(PSNR=35.4) for s in range(6)})})}
    row = next(r for r in cq.ROWS if r["arm"] == "G32")
    v = cq.row_verdict(row, studies, 0.13)
    assert v["verdict"] == "holds" and v["n"] == 6 and v["mean_db"] == pytest.approx(-0.425)
    assert v["band_db"] == pytest.approx(0.10)  # 3 SE is below the floor
    studies["gridsize"]["arms"]["G32"]["runs"] = {f"splat/s{s}": dict(PSNR=35.2) for s in range(6)}
    assert cq.row_verdict(row, studies, 0.13)["verdict"] == "same decision"  # -0.2: the sign agrees
    studies["gridsize"]["arms"]["G32"]["runs"] = {f"splat/s{s}": dict(PSNR=35.5) for s in range(6)}
    assert cq.row_verdict(row, studies, 0.13)["verdict"] == "miss"
    assert cq.row_verdict(cq.ROWS[0], studies, 0.13)["verdict"] == "not comparable"


def test_check_quality_main_with_a_stand_in_trainer(tmp_path, monkeypatch):
    """The check's whole flow on the CPU with a stand-in for the training:
    the limits first, a cut call, the call that resumes, every arm of every
    table under its label, the verdicts."""
    rng = np.random.default_rng(0)
    calls = []

    def stand_in(train, test, kw, evals, seed, device):
        calls.append(kw)
        return dict(train_seconds=1.0, evals={k: dict(PSNR=35.6 + rng.normal() * 0.1, SSIM=0.99, min_PSNR=34.0,
                                                      eval_seconds=0.1) for k in evals})

    monkeypatch.setattr(qst, "train_and_evaluate", stand_in)
    monkeypatch.setattr(cq, "LOG_DIR", str(tmp_path / "log"))
    out = str(tmp_path / "q.json")
    args = ["--root", str(tmp_path / "ws"), "--device", "cpu", "--workers", "1", "--out", out,
            "--log", str(tmp_path / "q.log")]
    assert cq.main(args + ["--max-fields", "5"]) == 0
    first = json.load(open(out))
    assert len(first["fields"]) == 5 and first["verdicts"] == {} and first["limits"]["rows"] == cq.ROWS
    assert list(first["fields"])[0] == "splat/s0/default"  # the anchor trains first
    assert all(c == dict(bytes=[], missing=[], pixels=[], n_files=34) for c in first["scenes"].values())
    assert cq.main(args) == 0
    res = json.load(open(out))
    assert len(calls) == 127 and len(res["calls"]) == 2 and len(res["fields"]) == 127
    for name, st in qst.STUDIES.items():
        arms = res["studies"][name]["arms"]
        assert list(arms) == list(st.arms)
        assert all(len(a["runs"]) == len(st.scenes) * len(cq.SEEDS[name]) for a in arms.values()), name
    v = res["verdicts"]
    assert set(v["anchor"]) == {"splat", "thin"} and v["scenes_equal"] is True
    assert len(v["rows"]) == len(cq.ROWS) and sum(v["row_counts"].values()) == len(cq.ROWS)
    assert v["row_counts"]["not comparable"] == sum(bool(r["not_comparable"]) for r in cq.ROWS)
    assert set(v["hash"]) == {"splat/s0", "splat/s1", "thin/s0", "thin/s1"} and all(h["ok"] for h in v["hash"].values())


def test_run_study_tiny_on_the_cpu(tmp_path, monkeypatch):
    """``run_study`` end to end at a cut size: the thin scene written, one
    field trained and scored under the table's two distinct evaluations."""
    @dataclasses.dataclass(frozen=True)
    class Cut(tm.NerfConfig):
        voxel_grid_size: int = CUT["voxel_grid_size"]
        n_steps: int = CUT["n_steps"]
        train_rays: int = CUT["train_rays"]
        train_warmup_steps: int = CUT["train_warmup_steps"]

    monkeypatch.setattr(qst, "NerfConfig", Cut)
    out = qst.run_study("thin_geometry", str(tmp_path), device="cpu")
    assert json.load(open(tmp_path / "results" / "thin_geometry.json")) == json.loads(json.dumps(out))
    arms = out["arms"]
    assert arms["blk2 rp20"]["runs"]["thin/s0"] == arms["blk2 rp32 (prod)"]["runs"]["thin/s0"]
    assert arms["blk2 rp24"]["same_field_as"] == ["blk2 rp32 (prod)", "blk2 rp20"]
    r24, r20 = arms["blk2 rp24"]["runs"]["thin/s0"], arms["blk2 rp20"]["runs"]["thin/s0"]
    assert r24["train_seconds"] == r20["train_seconds"] and r24["PSNR"] != r20["PSNR"]
    assert all(np.isfinite(r["PSNR"]) and r["PSNR"] > 12 for r in (r24, r20))


def test_entry_points_ask_for_the_cpu_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cq.main(["--root", str(tmp_path), "--out", str(tmp_path / "q.json"), "--log", str(tmp_path / "q.log")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        qst.run_study("render20", str(tmp_path))


# --- the committed card run (results/quality_check.json) ---------------------------------------------------

CHECK = os.path.join(REPO, "nerf_prv_tpu_torch", "experiments", "results", "quality_check.json")


@pytest.fixture(scope="module")
def committed_check():
    with open(CHECK) as f:
        return json.load(f)


def test_committed_check_holds_every_arm_at_its_seeds_on_the_card(committed_check):
    res = committed_check
    assert "H100" in res["card"] and "W" in res["card"] and all(c["card"] == res["card"] for c in res["calls"])
    assert res["limits"] == json.loads(json.dumps(cq.limits(cq.one_seed_sd())))
    assert len(res["fields"]) == 127 and res["protocol"]["seeds"] == {k: list(v) for k, v in cq.SEEDS.items()}
    for name, st in qst.STUDIES.items():
        arms = res["studies"][name]["arms"]
        assert list(arms) == list(st.arms), name
        want = {f"{sc}/s{s}" for sc in st.scenes for s in cq.SEEDS[name]}
        assert all(set(a["runs"]) == want for a in arms.values()), name
        assert all(np.isfinite(r["PSNR"]) for a in arms.values() for r in a["runs"].values())
    v = res["verdicts"]
    assert v["scenes_equal"] and all(not (c["bytes"] or c["pixels"]) for c in res["scenes"].values())
    assert all(a["within"] for a in v["anchor"].values())  # (i): splat +0.066, thin +0.414 dB over the record
    assert all(h["ok"] for h in v["hash"].values()) and len(v["hash"]) == 4  # (iv)


# The committed check's misses (ROADMAP §3): the README row, the claim, the measured paired delta's sign.
MISSES = {
    ("experiments/README.md:18", "G36 -0.3 dB"): +1,  # +0.174 +- 0.071 dB: G36 above G40
    ("experiments/README.md:18", "12 fine probes -0.11 dB"): +1,  # +0.128 +- 0.018 dB on the same fields
    ("experiments/README.md:34", "16 / 12 beats 20 / 8"): +1,  # +0.076 +- 0.054 dB: 20 samples above 16
    ("experiments/README.md:43", "125 x 24 warmup loses on splat"): +1,
    ("experiments/README.md:43", "no warmup loses on splat"): +1,
    ("experiments/README.md:46", "2,048 warmup rays lose on splat"): +1,
}


def test_committed_check_misses_are_the_recorded_ones(committed_check):
    """Each row that did not hold keeps its verdict and its sign; no other
    row missed; the adam_lowp gate turned over (bf16 passes on the card)."""
    rows = committed_check["verdicts"]["rows"]
    got = {(r["row"], r["claim"]): r for r in rows if r["verdict"] == "miss"}
    assert set(got) == set(MISSES)
    for key, sign in MISSES.items():
        assert np.sign(got[key]["mean_db"]) == sign and not got[key]["holds"] and not got[key]["same_decision"]
    assert committed_check["verdicts"]["row_counts"] == {"holds": 12, "same decision": 6, "miss": 6,
                                                         "not comparable": 9}
    adam = committed_check["verdicts"]["adam_lowp"]
    assert adam["stats"]["flip_default_to_bf16"] is True and adam["holds"] is False
    assert adam["stats"] == qst.adam_stats(committed_check["studies"]["adam_lowp"]["artifact"]["psnr"], cq.SIX)
