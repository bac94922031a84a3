"""The port's camera model against the JAX package's, on the CPU: the same
numpy points and pixels through ``project_points``, ``deproject_pixels`` and
``pixels_to_ray_ends`` at every distortion model."""

import numpy as np
import pytest
import torch

from nerf_prv_tpu.core import camera as jcam
from nerf_prv_tpu.core.config import CameraConfig as JCam
from nerf_prv_tpu_torch.core import camera as tcam
from nerf_prv_tpu_torch.core.config import CameraConfig as TCam

torch.set_num_threads(1)

# coefficients per model: Brown-Conrady (the default camera's), F-theta's
# field parameter, Kannala-Brandt's four (k4 is the fourth coefficient)
COEFFS = {
    0: {},
    1: {},
    2: {},
    3: dict(k1=0.9),
    4: {},
    5: dict(k1=0.05, k2=-0.02, k3=0.004, p1=-0.001),
}
# both sides compute in f32 in the same order of operations; XLA contracts
# some multiply-adds into FMAs and has its own tan / atan, torch neither:
# measured at most 9.2e-5 px (project, model 3), 3.0e-7 (deproject) and
# 6.0e-8 (ray ends) here
PIX_TOL = 5e-4
PT_TOL = 2e-6


def _cams(model):
    kw = dict(width=160, height=90, fx=150.0, fy=149.0, ppx=80.3, ppy=45.1, model=model, **COEFFS[model])
    return JCam(**kw), TCam(**kw)


def _points(seed=0, n=500):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-0.3, 0.3, size=(n, 2)), rng.uniform(0.3, 1.0, size=(n, 1))], 1).astype(
        np.float32)


@pytest.mark.parametrize("model", [0, 1, 2, 3, 4, 5])
def test_project_points_matches_jax(model):
    jc, tc = _cams(model)
    pts = _points(model)
    want = np.asarray(jcam.project_points(pts, jc))
    got = tcam.project_points(torch.from_numpy(pts), tc)
    assert got.dtype == torch.float32 and got.shape == (500, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PIX_TOL)


@pytest.mark.parametrize("model", [0, 1, 2, 3, 4, 5])
def test_deproject_pixels_matches_jax(model):
    jc, tc = _cams(model)
    rng = np.random.default_rng(10 + model)
    px = np.stack([rng.uniform(0, 160, 400), rng.uniform(0, 90, 400)], -1).astype(np.float32)
    depth = rng.uniform(0.2, 1.0, 400).astype(np.float32)
    want = np.asarray(jcam.deproject_pixels(px, depth, jc))
    got = tcam.deproject_pixels(torch.from_numpy(px), torch.from_numpy(depth), tc)
    assert got.shape == (400, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PT_TOL)


@pytest.mark.parametrize("model", [0, 1, 2, 3, 4, 5])
def test_pixels_to_ray_ends_matches_jax(model):
    jc, tc = _cams(model)
    rng = np.random.default_rng(20 + model)
    px = np.stack([rng.uniform(0, 160, 300), rng.uniform(0, 90, 300)], -1).astype(np.float32)
    c2w = np.eye(4)
    c2w[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    c2w[:3, 3] = rng.normal(size=3)
    want = np.asarray(jcam.pixels_to_ray_ends(px, c2w, jc, max_range=0.7))
    got = tcam.pixels_to_ray_ends(px, c2w, tc, max_range=0.7, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PT_TOL)


def test_brown_conrady_model_4_passes_through():
    """Model 4 applies no distortion in either direction, as in the reference."""
    _, tc4 = _cams(4)
    _, tc0 = _cams(0)
    pts = torch.from_numpy(_points(3))
    assert torch.equal(tcam.project_points(pts, tc4), tcam.project_points(pts, tc0))


def test_kb4_undistort_inverts_distort():
    """The 4-step Newton loop inverts the forward KB4 model (as the
    reference's ``tests/test_core.py`` checks for its own)."""
    _, tc = _cams(5)
    pts = torch.from_numpy(_points(4))
    px = tcam.project_points(pts, tc)
    back = tcam.deproject_pixels(px, pts[:, 2], tc)
    np.testing.assert_allclose(back.numpy(), pts.numpy(), atol=1e-5)
