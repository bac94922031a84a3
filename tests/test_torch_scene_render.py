"""The port's point-splat renders (K8's plain version on the CPU) against
the JAX package's ``scene/render.py``: u8 RGBA and f32 renders at every
pixel, the tie rule, and the helpers around them."""

import numpy as np
import pytest
import torch

from nerf_prv_tpu.core.config import CameraConfig as JCam
from nerf_prv_tpu.core.pose import camera_to_world
from nerf_prv_tpu.scene import render as jr
from nerf_prv_tpu_torch.core.config import CameraConfig as TCam
from nerf_prv_tpu_torch.ops import splat as splat_mod
from nerf_prv_tpu_torch.scene import render as tr

from synthetic import make_object

torch.set_num_threads(1)

CAMERAS = {
    "96x96": dict(width=96, height=96, fx=110.0, fy=110.0, ppx=48.0, ppy=48.0),
    "128x72": dict(width=128, height=72, fx=91.5, fy=91.3, ppx=64.7, ppy=37.2),
    "160x90": dict(width=160, height=90, fx=150.0, fy=149.0, ppx=80.3, ppy=45.1),
}


def _cams(name, model):
    kw = dict(CAMERAS[name], model=model)
    if model == 2:
        kw.update(k1=0.12, k2=-0.21, k3=0.0054, p1=-0.0021)
    return JCam(**kw), TCam(**kw)


def _views(center, n=5, radius=0.3, seed=0):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    d[:, 2] = np.abs(d[:, 2]) + 0.2
    pos = d / np.linalg.norm(d, axis=1, keepdims=True) * radius + center
    return camera_to_world(pos, center)


# Both sides round the same f32 operations in the same order, and XLA's
# scatters on the CPU apply their updates serially (the last writer wins),
# as the port's "amax" on the point index does: every pixel agrees (measured:
# 0 pixels differ in every case below), so the renders are held equal.
@pytest.mark.parametrize("point_size", [1, 3, 5])
@pytest.mark.parametrize("model", [0, 2])
@pytest.mark.parametrize("camera", list(CAMERAS))
def test_render_views_u8_equal_to_reference(camera, model, point_size):
    pts, cols = make_object(8000, seed=1)
    c2w = _views(pts.mean(0), seed=point_size)
    jc, tc = _cams(camera, model)
    want = jr.render_pointcloud_views(pts, cols, c2w, jc, point_size=point_size)
    got = tr.render_pointcloud_views(pts, cols, c2w, tc, point_size=point_size, device="cpu")
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.01 < float((want[..., 3] > 0).mean()) < 0.9


@pytest.mark.parametrize("point_size", [1, 3, 5])
@pytest.mark.parametrize("model", [0, 2])
def test_render_single_frame_f32_equal_to_reference(model, point_size):
    pts, cols = make_object(6000, seed=2)
    c2w = _views(pts.mean(0), n=1, seed=10 + point_size)[0]
    jc, tc = _cams("128x72", model)
    rgb_j, a_j = jr.render_pointcloud(pts, cols, c2w, jc, point_size=point_size)
    rgb_t, a_t = tr.render_pointcloud(pts, cols, c2w, tc, point_size=point_size, device="cpu")
    np.testing.assert_array_equal(rgb_t.numpy(), np.asarray(rgb_j))
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(tr.rgba_from_render(rgb_t, a_t), jr.rgba_from_render(rgb_j, a_j))
    assert tr.object_pixel_rate(a_t) == jr.object_pixel_rate(a_j) > 0
    assert tr.colorfulness(rgb_t) == pytest.approx(jr.colorfulness(np.asarray(rgb_j)), rel=1e-12)


def test_tie_goes_to_the_highest_point_index():
    """Two points at one position (equal depth, overlapping squares): the
    later point's colour wins every shared pixel in both, in either order."""
    jc, tc = _cams("96x96", 0)
    c2w = camera_to_world(np.array([[0.0, 0.0, 0.3]]), np.zeros(3))[0]
    p = np.array([[0.01, -0.005, 0.0], [0.01, -0.005, 0.0], [0.011, -0.004, 0.0]])
    for cols in (np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255]]), np.array([[0, 0, 255], [0, 255, 0], [255, 0, 0]])):
        want = jr.render_pointcloud_views(p, cols.astype(np.uint8), c2w[None], jc, point_size=5)
        got = tr.render_pointcloud_views(p, cols.astype(np.uint8), c2w[None], tc, point_size=5, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
        lit = want[0][want[0, ..., 3] > 0][:, :3]
        assert not (lit == cols[0]).all(axis=1).any()  # the first point never shows


def test_ties_within_1e7_of_the_nearest_depth_win_too():
    """A splat within 1e-7 of its pixel's nearest depth counts as a winner:
    the higher index wins among such near-ties, as in the reference."""
    jc, tc = _cams("96x96", 0)
    eye = np.eye(4)
    p = np.array([[0.0, 0.0, 0.3], [0.0, 0.0, 0.3 + 5e-8], [0.0, 0.0, 0.3 + 1e-5]])
    cols = np.array([[10, 20, 30], [40, 50, 60], [70, 80, 90]], np.uint8)
    want = jr.render_pointcloud_views(p, cols, eye[None], jc, point_size=3)
    got = tr.render_pointcloud_views(p, cols, eye[None], tc, point_size=3, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, 48, 48].tolist() == [40, 50, 60, 255]


def test_colors01_quirk_and_missing_colours():
    """u8 colours that are all <= 1 are not scaled (the reference tests the
    dtype after casting to float32); no colours render black."""
    for cols in (np.array([[0, 1, 1], [1, 0, 0]], np.uint8), np.array([[0, 128, 255], [3, 2, 1]], np.uint8),
                 np.array([[0.2, 0.4, 1.0], [1.5, 0.0, 0.1]], np.float32)):
        np.testing.assert_array_equal(tr._colors01(cols, 2, "cpu").numpy(), np.asarray(jr._colors01(cols, 2)))
    pts, _ = make_object(3000, seed=3)
    jc, tc = _cams("96x96", 0)
    c2w = _views(pts.mean(0), n=2)
    want = jr.render_pointcloud_views(pts, None, c2w, jc, point_size=3)
    got = tr.render_pointcloud_views(pts, None, c2w, tc, point_size=3, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_splat_plain_drops_points_behind_and_beyond_the_frame():
    """Points behind the camera or with a centre more than ``point_size``
    outside the frame leave no pixel; one just outside still paints the
    frame's edge with its square."""
    _, tc = _cams("96x96", 0)
    w2c = torch.eye(3, 4)[None].contiguous()
    # u = x / z * 110 + 48: centre at -2 (inside the margin), at -6
    # (beyond it), and one behind the camera
    pts = torch.tensor([[-50 / 110 * 0.5, 0.0, 0.5], [-54 / 110 * 0.5, 0.0, 0.5], [0.0, 0.0, -0.5]])
    cols = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    out = splat_mod.splat(pts, cols, w2c, tc, 5)
    lit = out[0, ..., 3] > 0
    assert int(lit.sum()) == 5 and bool(lit[46:51, 0].all())
    assert out[0, 48, 0].tolist() == [255, 0, 0, 255]


def test_rgba_from_render_rounds_half_to_even():
    rgb = torch.tensor([[[0.5 / 255, 1.5 / 255, 2.5 / 255]]], dtype=torch.float32)
    alpha = torch.tensor([[0.5 / 255]])
    np.testing.assert_array_equal(tr.rgba_from_render(rgb, alpha), jr.rgba_from_render(rgb.numpy(), alpha.numpy()))
