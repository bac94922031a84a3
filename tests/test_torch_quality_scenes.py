"""The quality studies' scenes (``nerf_prv_tpu_torch/experiments/quality_scenes.py``)
against the JAX writers: the shipped views, the thin object, every PNG and
JSON of the splat, thin (seeds 0 and 1) and bench scenes, the one-launch
view-set path against the per-frame render, and the committed digests."""

import os
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch

from nerf_prv_tpu.core.config import CameraConfig as JCam
from nerf_prv_tpu.scene import render as jr
from nerf_prv_tpu.viewspace import generate_hemisphere
from nerf_prv_tpu_torch.experiments import quality_scenes as qs
from nerf_prv_tpu_torch.experiments.toy import make_object
from nerf_prv_tpu_torch.ops.splat import fma32
from nerf_prv_tpu_torch.scene import render as tr

from jax_reference_runs import REPO, jax_write_quality_scene

sys.path.insert(0, os.path.join(REPO, "experiments"))
from exp_thin_geometry import make_thin_object as jax_make_thin_object  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Every quality scene by the JAX writer and by the port's (on the
    CPU, K8's plain version), each once."""
    root = tmp_path_factory.mktemp("quality_scenes")
    out = {}
    for name in qs.SCENES:
        jd, td = str(root / "jax" / name), str(root / "port" / name)
        jax_write_quality_scene(name, jd)
        qs.write_named(name, td, device="cpu")
        out[name] = (jd, td)
    return out


@pytest.mark.parametrize("n,seed", qs.HEMISPHERES)
def test_shipped_views_equal_jax_generate_hemisphere(n, seed):
    got = qs.hemisphere(n, seed)
    want = generate_hemisphere(n, seed=seed, restarts=2, steps=200)
    assert got.dtype == want.dtype == np.float64 and got.shape == (n, 3)
    assert got.tobytes() == want.tobytes()


def test_unshipped_view_count_is_refused():
    with pytest.raises(FileNotFoundError, match="no shipped view set"):
        qs.hemisphere(12, 1)


@pytest.mark.parametrize("seed", [0, 1])
def test_make_thin_object_equals_jax(seed):
    pts, cols = qs.make_thin_object(seed=seed)
    jpts, jcols = jax_make_thin_object(seed=seed)
    assert pts.dtype == jpts.dtype and cols.dtype == jcols.dtype == np.uint8
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(cols, jcols)


@pytest.mark.parametrize("name", list(qs.SCENES))
def test_scene_equals_the_jax_writers_byte_for_byte(written, name):
    """Every PNG and both JSONs, byte for byte (the frames through K8's
    plain version with the per-frame rounding)."""
    jd, td = written[name]
    want, got = qs.scene_digests(jd), qs.scene_digests(td)
    n = qs.SCENES[name][1].get("n_train", 24) + qs.SCENES[name][1].get("n_test", 8)
    assert len(want["pixels"]) == n and len(want["files"]) == n + 2
    assert qs.compare_digests(got, want) == dict(n_files=n + 2, missing=[], bytes=[], pixels=[])
    for js in ("train.json", "test.json"):
        assert open(os.path.join(td, js), "rb").read() == open(os.path.join(jd, js), "rb").read()


@pytest.mark.parametrize("name", list(qs.SCENES))
def test_port_scene_equals_the_committed_digests(written, name):
    """``results/quality_scenes_cpu.json``: what the card-written scenes are
    held to."""
    assert qs.compare_digests(qs.scene_digests(written[name][1]), qs.committed_digests()[name])["bytes"] == []


def test_make_scenes_finds_written_scenes(written, tmp_path):
    for name in ("splat", "thin"):
        os.symlink(written[name][1], tmp_path / name)
    got = qs.make_scenes(qs.QUALITY_CAMERA, str(tmp_path), device="cpu")
    assert got == {n: (str(tmp_path / n / "train.json"), str(tmp_path / n / "test.json")) for n in ("splat", "thin")}


@pytest.mark.parametrize("name,frames", [("splat", [0, 11, 23]), ("bench", [13, 14])])
def test_view_set_launch_equals_the_per_frame_render(name, frames):
    """One launch for a view set (u8, the per-frame rounding) gives the
    bytes of ``render_pointcloud`` + ``rgba_from_render`` frame by frame, on
    both packages; the batched rounding equals the JAX package's batched
    render (on the bench scene's frames 13-14 the two roundings differ)."""
    kw = qs.SCENES[name][1]
    pts, cols = make_object(kw["n_points"], seed=0)
    c2ws = qs.poses(qs.hemisphere(kw["n_train"], 1)[frames], pts.mean(axis=0), 0.3)
    cam, ps = kw["camera"], kw["point_size"]
    jcam = JCam(**{k: getattr(cam, k) for k in ("width", "height", "fx", "fy", "ppx", "ppy", "model", "k1", "k2",
                                                   "k3", "p1", "p2")})
    sets = tr.render_pointcloud_views(pts, cols, c2ws, cam, point_size=ps, device="cpu", rounding="frame").numpy()
    for i, c2w in enumerate(c2ws):
        rgb, alpha = tr.render_pointcloud(pts, cols, c2w, cam, point_size=ps, device="cpu")
        np.testing.assert_array_equal(sets[i], tr.rgba_from_render(rgb, alpha))
        np.testing.assert_array_equal(sets[i], jr.rgba_from_render(*jr.render_pointcloud(pts, cols, c2w, jcam,
                                                                                         point_size=ps)))
    batched = tr.render_pointcloud_views(pts, cols, c2ws, cam, point_size=ps, device="cpu").numpy()
    np.testing.assert_array_equal(batched, jr.render_pointcloud_views(pts, cols, c2ws, jcam, point_size=ps))
    assert (name == "bench") == (not np.array_equal(batched, sets))


def _fma_exact(a, b, c):
    """a * b + c rounded once to float32, from the exact rational value."""
    ex = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = np.float32(float(ex))
    near = [np.nextafter(r, np.float32(-np.inf)), r, np.nextafter(r, np.float32(np.inf))]
    return min(near, key=lambda v: (abs(Fraction(float(v)) - ex), int(np.float32(v).view(np.uint32)) & 1))


def test_fma32_rounds_once():
    """Random operands and the double-rounding case: the float64 sum lands
    on a midpoint of two f32 values that the exact sum does not."""
    rng = np.random.default_rng(0)
    a, b, c = (rng.normal(size=3000).astype(np.float32) * s for s in (1.0, 1e-3, 1.0))
    got = fma32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    assert all(got[i] == _fma_exact(a[i], b[i], c[i]) for i in range(len(a)))
    a1, b1, c1 = (np.array([v], np.float32) for v in (1 + 2**-23, 2**-24 * (1 - 2**-23), 1 + 2**-23))
    got = fma32(torch.from_numpy(a1), torch.from_numpy(b1), torch.from_numpy(c1)).numpy()[0]
    assert got == _fma_exact(a1[0], b1[0], c1[0]) == np.float32(1 + 2**-23)
    assert (a1.astype(np.float64) * b1 + c1).astype(np.float32)[0] != got  # what rounding twice gives
