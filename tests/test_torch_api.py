"""The port's serving slice as a whole against the JAX package: snapshots,
eval metrics, screenshots and ``run``; plus the port's import hygiene."""

import dataclasses
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

# one thread for PyTorch: the tests' tensors are tiny, and several test workers on
# a few cores otherwise spend their time contending for them (minutes, not seconds)
torch.set_num_threads(1)

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


@pytest.mark.parametrize("encode_impl", ["fused", "auto"])
def test_run_without_snapshot_trains_the_hash_field(served, tmp_path, monkeypatch, encode_impl):
    """Without a snapshot ``run`` trains the hash field too: the losses fall,
    the snapshot is a hash snapshot that the JAX package scores the same
    (on the scene and config of ``test_eval_nerf_matches``, so its programs
    are compiled already), and the score beats a black frame."""
    train_json, test_json, _, _ = served
    jcfg, tcfg = _cfgs("f32")
    tcfg = dataclasses.replace(tcfg, encode_impl=encode_impl, n_steps=60, train_rays=256,
                               train_warmup_steps=20, train_warmup_samples=24)
    losses = []
    real_train = tapi.train
    monkeypatch.setattr(tapi, "train", lambda *a, **kw: losses.append(real_train(*a, **kw)) or losses[0])
    snap = str(tmp_path / "hash.ingp")
    metrics = tapi.run(train_json, test_transforms=test_json, cfg=tcfg, seed=0,
                       save_snapshot_path=snap, device="cpu")
    ls = losses[0][1]
    assert ls.shape == (60,) and np.isfinite(ls).all() and ls[-10:].mean() < 0.5 * ls[:5].mean()
    assert metrics["PSNR"] >= _black_psnr(test_json) + 3.0, metrics
    params = tapi.load_snapshot(snap, tcfg, device="cpu")
    assert params["table"].shape == (4 << 12, 2) and float(params["table"].abs().max()) > 1e-3
    theirs = japi.eval_nerf(japi.load_snapshot(snap, jcfg), test_json, jcfg)
    assert abs(metrics["PSNR"] - theirs["PSNR"]) <= METRIC_TOL["f32"]["psnr"], (metrics, theirs)


# --- the voxel field: train, snapshot, score, both ways ----------------------

VOXEL = dict(voxel_grid_size=12, n_steps=80, train_rays=256, train_warmup_steps=25, train_warmup_samples=24)
CAM = dict(width=64, height=36, fx=70.0, fy=70.0, ppx=32.0, ppy=18.0, model=0)
# the two packages score one snapshot through bf16 MLPs that may round an
# activation an ulp apart and through probes whose thresholds may then
# flip a ray: measured within 0.02 dB; the bound leaves several times that
XSCORE_DB = 0.15


def _black_psnr(test_json):
    ds = tapi.load_dataset(test_json)
    gt = ds.pixels[..., :3] * ds.pixels[..., 3:4]
    return float(np.mean([-10.0 * np.log10(np.mean(f ** 2)) for f in gt]))


@pytest.fixture(scope="module")
def voxel_scene(tmp_path_factory):
    from nerf_prv_tpu.core.config import CameraConfig as JCam

    root = tmp_path_factory.mktemp("voxel")
    train_json, test_json, _, _ = write_scene(
        str(root), n_train=6, n_test=2, camera=JCam(**CAM), n_points=4000
    )
    return root, train_json, test_json


def test_run_trains_the_default_field_end_to_end(voxel_scene):
    """``run`` without a snapshot at a tiny voxel config on the CPU: trains,
    saves, scores above a black frame, and writes screenshots."""
    root, train_json, test_json = voxel_scene
    snap = str(root / "port.ingp")
    metrics = tapi.run(
        train_json, n_steps=VOXEL["n_steps"], test_transforms=test_json,
        save_metrics_path=str(root / "m.txt"), screenshot_transforms=test_json,
        screenshot_dir=str(root / "shots"), cfg=tm.NerfConfig(**{**VOXEL, "n_steps": 5}),
        seed=0, save_snapshot_path=snap, device="cpu",
    )
    assert metrics["PSNR"] >= _black_psnr(test_json) + 6.0, metrics
    assert 0 < metrics["SSIM"] <= 1 and len(os.listdir(root / "shots")) == 2
    params = tapi.load_snapshot(snap, tm.NerfConfig(**VOXEL), device="cpu")
    assert params["grid"].shape == (12 ** 3, 64) and not params["grid"].requires_grad
    again = tapi.eval_nerf(params, test_json, tm.NerfConfig(**VOXEL))
    assert again == pytest.approx(metrics)


def test_port_trained_snapshot_scores_the_same_in_jax(voxel_scene):
    root, train_json, test_json = voxel_scene
    tcfg, jcfg = tm.NerfConfig(**VOXEL), jm.NerfConfig(**VOXEL)
    params, ds = tapi.train_nerf(train_json, tcfg, seed=1, device="cpu")
    assert ds.n_frames == 6
    snap = str(root / "port2.ingp")
    tapi.save_snapshot(snap, params)
    ours = tapi.eval_nerf(params, test_json, tcfg)
    theirs = japi.eval_nerf(japi.load_snapshot(snap, jcfg), test_json, jcfg)
    assert ours["PSNR"] >= _black_psnr(test_json) + 6.0
    assert abs(ours["PSNR"] - theirs["PSNR"]) <= XSCORE_DB, (ours, theirs)
    assert abs(ours["SSIM"] - theirs["SSIM"]) <= 5e-3


def test_jax_trained_snapshot_scores_the_same_in_the_port(voxel_scene):
    root, train_json, test_json = voxel_scene
    tcfg, jcfg = tm.NerfConfig(**VOXEL), jm.NerfConfig(**VOXEL)
    jparams, _ = japi.train_nerf(train_json, jcfg, seed=0)
    snap = str(root / "jax.ingp")
    japi.save_snapshot(snap, jparams)
    theirs = japi.eval_nerf(jparams, test_json, jcfg)
    params = tapi.load_snapshot(snap, tcfg, device="cpu")
    np.testing.assert_array_equal(params["grid"].numpy(), np.asarray(jparams["grid"]))
    ours = tapi.eval_nerf(params, test_json, tcfg)
    assert theirs["PSNR"] >= _black_psnr(test_json) + 6.0
    assert abs(ours["PSNR"] - theirs["PSNR"]) <= XSCORE_DB, (ours, theirs)
    assert abs(ours["SSIM"] - theirs["SSIM"]) <= 5e-3
    # and the port trains on from it: a warm start skips the warmup phase
    more, _ = tapi.train_nerf(train_json, dataclasses.replace(tcfg, n_steps=10), seed=2, init_from=params, device="cpu")
    assert tapi.eval_nerf(more, test_json, tcfg)["PSNR"] >= ours["PSNR"] - 1.0


def test_validate_snapshot_checks_the_grid_shape(voxel_scene):
    params = tm.init_params(torch.Generator().manual_seed(0), tm.NerfConfig(**VOXEL), device="cpu")
    tapi.validate_snapshot(params, tm.NerfConfig(**VOXEL))
    with pytest.raises(ValueError, match="grid shape"):
        tapi.validate_snapshot(params, tm.NerfConfig())
    with pytest.raises(ValueError, match="table"):
        tapi.validate_snapshot(params, tm.NerfConfig(field_impl="hash"))


# --- geometry export, video frames and the PLY writer ------------------------

from nerf_prv_tpu.nerf import extract as jex  # noqa: E402
from nerf_prv_tpu.scene import ply as jply  # noqa: E402
from nerf_prv_tpu_torch.nerf import extract as tex  # noqa: E402
from nerf_prv_tpu_torch.scene import ply as tply  # noqa: E402
from voxel_common import both, cfgs as vcfgs, np_params  # noqa: E402


def _fields(which):
    """(JAX cfg, port cfg, JAX params, port params) of a small f32 field
    with densities on both sides of the export threshold."""
    if which == "voxel":
        jcfg, tcfg = vcfgs()
        jp, tp = both(np_params(jcfg))
    else:
        jcfg, tcfg = _cfgs("f32")
        p = {k: np.array(v) for k, v in jm.init_params(jax.random.PRNGKey(0), jcfg).items()}
        p["table"] *= 1e4
        p["sigma_w1"][:, 0] *= 20.0
        jp, tp = both(p)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("which", ["voxel", "hash"])
def test_extract_density_grid_matches(which):
    """Same field, same 12^3 lattice, small chunks: densities are exp(raw)
    of f32 MLPs, so compare relative (1e-4; the fields' own parity tests
    hold raw to 1e-5)."""
    jcfg, tcfg, jp, tp = _fields(which)
    want = jex.extract_density_grid(jp, jcfg, resolution=12, chunk=500)
    got = tex.extract_density_grid(tp, tcfg, resolution=12, chunk=500)
    assert isinstance(got, np.ndarray) and got.shape == (12, 12, 12)
    assert np.isfinite(got).all() and (got >= 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("which,threshold", [("voxel", 1.0), ("hash", 1.0), ("voxel", 0.0), ("voxel", 1e9)])
def test_save_geometry_matches(tmp_path, which, threshold):
    """The exported surface shell: the same points, colours within one u8
    step (threshold 0: everything occupied, the shell is the lattice's
    faces; 1e9: nothing, an empty but valid PLY)."""
    jcfg, tcfg, jp, tp = _fields(which)
    grid = tex.extract_density_grid(tp, tcfg, resolution=12)
    if threshold == 1.0:
        # the middle of the widest gap between sorted densities near the
        # median: no cell sits on the threshold
        v = np.sort(grid.reshape(-1))[800:930]
        k = int(np.argmax(np.diff(np.log(v))))
        threshold = float(np.sqrt(v[k] * v[k + 1]))
        assert np.abs(grid / threshold - 1.0).min() > 1e-3
    a, b = str(tmp_path / "j.ply"), str(tmp_path / "sub" / "t.ply")
    n_j = jex.save_geometry(jp, jcfg, a, resolution=12, density_threshold=threshold)
    n_t = tex.save_geometry(tp, tcfg, b, resolution=12, density_threshold=threshold)
    assert n_t == n_j and (n_t > 0) == (threshold < 1e9)
    pts_j, col_j = jply.load_ply(a)
    pts_t, col_t = tply.load_ply(b)
    assert len(pts_t) == n_t
    np.testing.assert_array_equal(pts_t, pts_j)
    if n_t:
        assert (pts_t >= 0).all() and (pts_t <= 1).all()
        assert np.abs(col_t.astype(np.int16) - col_j.astype(np.int16)).max() <= 1


@pytest.mark.parametrize("colors", [True, False])
@pytest.mark.parametrize("writer", ["save_ply_binary", "save_ply_ascii"])
def test_ply_round_trip_and_interchange(tmp_path, writer, colors):
    """Each writer's file is byte-identical to the reference's and reads
    back through either package's loader."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, size=(17, 3))
    cols = rng.integers(0, 256, size=(17, 3)).astype(np.uint8) if colors else None
    a, b = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    getattr(jply, writer)(a, pts, cols)
    getattr(tply, writer)(b, pts, cols)
    assert open(a, "rb").read() == open(b, "rb").read()
    for path in (a, b):
        got_p, got_c = tply.load_ply(path)
        want_p, want_c = jply._load_ply_py(path)
        np.testing.assert_array_equal(got_p, want_p)
        np.testing.assert_allclose(got_p, pts, rtol=0, atol=1e-6)
        assert (got_c is None) == (not colors)
        if colors:
            np.testing.assert_array_equal(got_c, cols)
            np.testing.assert_array_equal(got_c, want_c)


def test_render_video_and_run_mesh_and_video_arguments(voxel_scene, tmp_path):
    """``run`` with a snapshot and the reference's mesh and video arguments:
    frames are written whether or not ffmpeg exists and equal the
    screenshots' RGB; the mesh has the points ``save_geometry`` counts."""
    import inspect

    _, train_json, test_json = voxel_scene
    tcfg = tm.NerfConfig(**VOXEL)
    params = tm.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    params["grid"] += 0.5
    snap = str(tmp_path / "v.ingp")
    tapi.save_snapshot(snap, params)
    mesh, video = str(tmp_path / "mesh.ply"), str(tmp_path / "out" / "clip.mp4")
    tapi.run(
        "unused.json", cfg=tcfg, load_snapshot_path=snap, device="cpu",
        screenshot_transforms=test_json, screenshot_dir=str(tmp_path / "shots"),
        save_mesh_path=mesh, marching_cubes_res=10, video_camera_path=test_json,
        video_output=video, video_fps=12,
    )
    pts, cols = tply.load_ply(mesh)
    assert len(pts) == tex.save_geometry(params, tcfg, str(tmp_path / "again.ply"), resolution=10)
    assert cols is not None and len(cols) == len(pts)
    frames = sorted(os.listdir(tmp_path / "out" / "clip_frames"))
    assert frames == ["frame_0000.png", "frame_0001.png"]
    shots = sorted(os.listdir(tmp_path / "shots"))
    for f, s_ in zip(frames, shots):
        a = np.asarray(Image.open(tmp_path / "out" / "clip_frames" / f))
        b = np.asarray(Image.open(tmp_path / "shots" / s_))
        assert a.shape == (36, 64, 3) and np.array_equal(a, b[..., :3])
    assert tex.render_video(params, test_json, str(tmp_path / "v2.mp4"), tcfg) == 2
    # the same names and defaults as the reference's run
    want = inspect.signature(japi.run).parameters
    got = inspect.signature(tapi.run).parameters
    assert [k for k in got if k != "device"] == list(want)
    for k in ("save_mesh_path", "marching_cubes_res", "video_camera_path", "video_output", "video_fps"):
        assert got[k].default == want[k].default


def test_port_imports_no_jax():
    """Every port module and chip_smoke import without jax, flax, optax,
    msgpack, torchvision or nerf_prv_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import nerf_prv_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'nerf_prv_tpu.'))"
        " or m in ('nerf_prv_tpu', 'optax', 'flax', 'msgpack', 'torchvision')"
        " or m.startswith(('optax.', 'flax.', 'msgpack.', 'torchvision.')))\n"
        "assert len(names) >= 50, names\n"
        "assert {p.__name__ + s for s in ('.nerf.voxelfield', '.nerf.train', '.ops.row_gather', '.ops.row_scatter_add',"
        " '.ops.sorted_grad', '.ops.fused', '.nerf.extract', '.scene.ply', '.core.camera', '.core.config',"
        " '.viewspace.hemisphere', '.viewspace.novel', '.ops.splat', '.ops.voxel_cast', '.scene.render',"
        " '.scene.voxel', '.scene.mesh_sampling', '.scene.object_setup', '.runtime.native',"
        " '.pipeline.coverage', '.labeling.lognormal', '.labeling.labels', '.labeling.stats',"
        " '.labeling.dataset', '.planning.local_path', '.planning.tsp', '.parallel.mesh', '.parallel.dryrun',"
        " '.nerf.batch_train', '.prvnet.convnextv2', '.prvnet.resnet', '.prvnet.model', '.prvnet.data',"
        " '.prvnet.infer', '.pipeline.nbv', '.pipeline.compare', '.pipeline.modes', '.pipeline.cli',"
        " '.utils.timing', '.utils.visualize', '.servers.infer_server', '.servers.train_server',"
        " '.servers.run', '.prvnet.train', '.prvnet.cli', '.prvnet._msgpack', '.experiments.families',"
        " '.experiments.label_protocol', '.experiments.corpus_dataset', '.experiments.prvnet_recipe',"
        " '.experiments.check_labels', '.experiments.check_prvnet', '.experiments.runs',"
        " '.experiments.time_pretrain_step', '.experiments.predictor_gate', '.experiments.mode7_compare',"
        " '.experiments.mode21_table', '.experiments.check_mode7', '.experiments.check_mode21',"
        " '.experiments.predict_budgets', '.experiments.real_object', '.experiments.check_real_object',"
        " '.experiments.production10', '.experiments.toy', '.experiments.e2e_mode21', '.experiments.launches',"
        " '.experiments.check_e2e_mode21', '.experiments.label_spread2', '.experiments.check_pilot2',"
        " '.experiments.warmstart', '.experiments.quality_scenes', '.experiments.quality_studies',"
        " '.experiments.check_quality', '.experiments.tiny720', '.experiments.check_hd')} <= set(names)\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
