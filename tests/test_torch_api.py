"""The port's serving slice as a whole against the JAX package: snapshots,
eval metrics, screenshots and ``run``; plus the port's import hygiene."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nerf_prv_tpu.nerf import api as japi
from nerf_prv_tpu.nerf import hashgrid as jhg
from nerf_prv_tpu.nerf import model as jm
from nerf_prv_tpu_torch.nerf import api as tapi
from nerf_prv_tpu_torch.nerf import hashgrid as thg
from nerf_prv_tpu_torch.nerf import model as tm
from synthetic import write_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = dict(levels=4, features=2, log2_table=12, n_min=4, n_max=64)
# eval metrics: measured within 1e-5 dB / 2e-7 SSIM at f32 and within
# 1.1e-4 dB / 2.2e-6 SSIM at bf16, where a bf16 GEMM may round one MLP
# activation an ulp apart; the bounds leave 10-100 times that
METRIC_TOL = {"f32": dict(psnr=1e-3, ssim=1e-5), "bf16": dict(psnr=1e-2, ssim=1e-4)}


def _cfgs(compute):
    jcfg = jm.NerfConfig(
        grid=jhg.HashGridConfig(**GRID), hidden=16, field_impl="hash", encode_impl="xla",
        compute_dtype=jnp.float32 if compute == "f32" else jnp.bfloat16,
    )
    tcfg = tm.NerfConfig(
        grid=thg.HashGridConfig(**GRID), hidden=16, field_impl="hash", encode_impl="fused",
        compute_dtype=torch.float32 if compute == "f32" else torch.bfloat16,
    )
    return jcfg, tcfg


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A small scene and a hash-field snapshot written by the JAX package."""
    root = tmp_path_factory.mktemp("served")
    train_json, test_json, _, _ = write_scene(str(root), n_train=2, n_test=3, n_points=4000)
    jcfg, _ = _cfgs("f32")
    p = {k: np.array(v) for k, v in jm.init_params(jax.random.PRNGKey(0), jcfg).items()}
    p["table"] *= 1e4
    p["sigma_w1"][:, 0] *= 20.0
    snap = str(root / "snap.ingp")
    japi.save_snapshot(snap, {k: jnp.asarray(v) for k, v in p.items()})
    return train_json, test_json, snap, p


def test_snapshots_interchange(served, tmp_path):
    _, _, snap, p = served
    jcfg, tcfg = _cfgs("f32")
    tp = tapi.load_snapshot(snap, tcfg, device="cpu")
    assert sorted(tp) == sorted(p)
    for k in p:
        np.testing.assert_array_equal(tp[k].numpy(), p[k])
    back = str(tmp_path / "back.ingp")
    tapi.save_snapshot(back, tp)
    jp = japi.load_snapshot(back, jcfg)
    for k in p:
        np.testing.assert_array_equal(np.asarray(jp[k]), p[k])
        assert jp[k].dtype == p[k].dtype


def test_validate_snapshot_rejects_voxel_cfg(served):
    _, _, snap, _ = served
    with pytest.raises(ValueError, match="voxel"):
        tapi.load_snapshot(snap, tm.NerfConfig(), device="cpu")


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_eval_nerf_matches(served, compute):
    _, test_json, snap, _ = served
    jcfg, tcfg = _cfgs(compute)
    want = japi.eval_nerf(japi.load_snapshot(snap), test_json, jcfg)
    got = tapi.eval_nerf(tapi.load_snapshot(snap, device="cpu"), test_json, tcfg)
    assert sorted(got) == sorted(want)
    tol = METRIC_TOL[compute]
    for k in ("PSNR", "PSNR_avgmse", "min_PSNR", "max_PSNR"):
        assert abs(got[k] - want[k]) <= tol["psnr"], (k, got[k], want[k])
    assert abs(got["SSIM"] - want["SSIM"]) <= tol["ssim"]


def test_screenshots_and_run_match(served, tmp_path):
    _, test_json, snap, _ = served
    jcfg, tcfg = _cfgs("f32")
    japi.screenshot_nerf(japi.load_snapshot(snap), test_json, str(tmp_path / "j"), jcfg)
    metrics = tapi.run(
        "unused.json", test_transforms=test_json, save_metrics_path=str(tmp_path / "m.txt"),
        screenshot_transforms=test_json, screenshot_dir=str(tmp_path / "t"), cfg=tcfg,
        load_snapshot_path=snap, device="cpu",
    )
    names = sorted(os.listdir(tmp_path / "j"))
    assert names and names == sorted(os.listdir(tmp_path / "t"))
    for name in names:
        a = np.asarray(Image.open(tmp_path / "j" / name), np.int16)
        b = np.asarray(Image.open(tmp_path / "t" / name), np.int16)
        assert a.shape == b.shape and a.shape[-1] == 4
        # u8 rounding of values that agree to ~4e-5 can straddle a .5
        assert np.abs(a - b).max() <= 1
    saved = tapi.load_metrics(str(tmp_path / "m.txt"))
    assert saved == pytest.approx({"PSNR": metrics["PSNR"], "SSIM": metrics["SSIM"]})
    assert np.isfinite(metrics["PSNR"]) and 0 < metrics["SSIM"] <= 1


def test_run_without_snapshot_raises(served):
    train_json, test_json, _, _ = served
    with pytest.raises(NotImplementedError, match="training"):
        tapi.run(train_json, test_transforms=test_json, device="cpu")


def test_port_imports_no_jax():
    """Every port module and chip_smoke import without jax or nerf_prv_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import nerf_prv_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'nerf_prv_tpu.'))"
        " or m == 'nerf_prv_tpu')\n"
        "assert len(names) >= 10, names\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
