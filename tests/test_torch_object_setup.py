"""The port's object setup against the JAX package's, on the CPU: a toy
ShapeNet PLY through ``load_object`` with the size augmentation, from
view-space files written beforehand (the two sides' generators draw other
start points)."""

import os

import numpy as np
import pytest
import torch

from nerf_prv_tpu.core.config import CameraConfig as JCam
from nerf_prv_tpu.core.config import Config as JConfig
from nerf_prv_tpu.scene import object_setup as jo
from nerf_prv_tpu.viewspace.hemisphere import generate_hemisphere, save_view_space
from nerf_prv_tpu_torch.core.config import CameraConfig as TCam
from nerf_prv_tpu_torch.core.config import Config as TConfig
from nerf_prv_tpu_torch.scene import object_setup as to
from nerf_prv_tpu_torch.scene.ply import save_ply_binary

torch.set_num_threads(1)

CAM = dict(width=128, height=72, fx=91.5, fy=91.3, ppx=64.7, ppy=37.2, model=2, k1=0.12, k2=-0.21)


def _setup(tmp_path, name, extent, n_views=6, object_pixel_rate=0.035, seed=0):
    """A toy cloud in ``models/ShapeNet/<name>.ply``, the 5-view probe and
    ``n_views`` view spaces written by the reference, and a config per side
    (own workspace, shared models and view spaces)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-extent, extent, size=(4000, 3)) * [1.0, 0.6, 0.8]
    cols = rng.integers(0, 255, size=(4000, 3), dtype=np.uint8)
    save_ply_binary(str(tmp_path / "models" / "ShapeNet" / f"{name}.ply"), pts, cols)
    vs = str(tmp_path / "viewspace")
    for n in sorted({5, n_views}):
        save_view_space(vs, generate_hemisphere(n, seed=n, restarts=2, steps=100))
    common = dict(model_path=str(tmp_path / "models"), viewspace_path=vs, name_of_pcd=name,
                  num_of_views=n_views, object_pixel_rate=object_pixel_rate, seed=seed)
    return (JConfig(workspace=str(tmp_path / "jax"), camera=JCam(**CAM), **common),
            TConfig(workspace=str(tmp_path / "port"), camera=TCam(**CAM), **common))


@pytest.mark.parametrize("extent,seed", [(1.0, 0), (0.3, 5)])
def test_load_object_matches_reference(tmp_path, extent, seed):
    jcfg, tcfg = _setup(tmp_path, "toy0", extent, seed=seed)
    want = jo.load_object(jcfg, "toy0")
    got = to.load_object(tcfg, "toy0", device="cpu")
    assert got.ok and want.ok
    assert got.size == want.size  # the same numpy draws, accepted on the same rates
    for f in ("predicted_size", "octomap_resolution", "min_z_table", "name"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.colors, want.colors)
    read = lambda cfg: open(os.path.join(cfg.gt_path, "size.txt")).read()  # noqa: E731
    assert read(tcfg) == read(jcfg)
    np.testing.assert_array_equal(got.gt_scene.occupancy.numpy(), np.asarray(want.gt_scene.occupancy))
    np.testing.assert_array_equal(got.gt_scene.color_grid.numpy(), np.asarray(want.gt_scene.color_grid))
    np.testing.assert_array_equal(got.gt_sample.occupancy, want.gt_sample.occupancy)
    np.testing.assert_array_equal(got.view_space.views, want.view_space.views)
    np.testing.assert_array_equal(got.object_center, want.object_center)
    # idempotent on size.txt
    again = to.load_object(tcfg, "toy0", build_scene=False, device="cpu")
    assert again.size == got.size and again.gt_scene is None


def test_size_test_rate_equal_and_rejection_written(tmp_path):
    """A cloud far too small for the pixel rate: every try fails on both
    sides, and both write -1 and return a rejected scene."""
    jcfg, tcfg = _setup(tmp_path, "tiny", 1.0, object_pixel_rate=0.9)
    pts = np.random.default_rng(3).normal(size=(500, 3)) * 0.03
    cols = np.random.default_rng(4).integers(0, 255, size=(500, 3), dtype=np.uint8)
    assert to._size_test_rate(pts, cols, tcfg, tcfg.viewspace_path, device="cpu") == \
        jo._size_test_rate(pts, cols, jcfg, jcfg.viewspace_path)
    want = jo.load_object(jcfg, "tiny")
    got = to.load_object(tcfg, "tiny", device="cpu")
    assert not got.ok and not want.ok and got.size == want.size == -1.0
    assert open(os.path.join(tcfg.gt_path, "size.txt")).read() == "-1"
    assert not to.load_object(tcfg, "tiny", device="cpu").ok  # read back from size.txt


@pytest.mark.parametrize("state", range(6))
def test_poses_equal(state):
    np.testing.assert_array_equal(to.toward_pose(state), jo.toward_pose(state))
    np.testing.assert_array_equal(to.rotate_z_pose(state), jo.rotate_z_pose(state))


def test_orientation_and_non_shapenet_scale(tmp_path):
    """An HB (non-ShapeNet) object with an ``MP_SCALE`` entry, turned by the
    toward and rotate states: the same points, sizes and grids."""
    assert to.MP_SCALE == jo.MP_SCALE and to.NAMES_ROTATE == jo.NAMES_ROTATE
    rng = np.random.default_rng(9)
    pts = rng.normal(size=(3000, 3)) * 0.05
    cols = rng.integers(0, 255, size=(3000, 3), dtype=np.uint8)
    save_ply_binary(str(tmp_path / "models" / "PLY" / "LM3.ply"), pts, cols)
    vs = str(tmp_path / "viewspace")
    save_view_space(vs, generate_hemisphere(6, seed=1, restarts=2, steps=100))
    common = dict(model_path=str(tmp_path / "models"), viewspace_path=vs, name_of_pcd="LM3", num_of_views=6,
                  is_shape_net=False)
    want = jo.load_object(JConfig(workspace=str(tmp_path / "j"), camera=JCam(**CAM), **common), "LM3",
                          toward_state=3, rotate_state=2)
    got = to.load_object(TConfig(workspace=str(tmp_path / "t"), camera=TCam(**CAM), **common), "LM3",
                         toward_state=3, rotate_state=2, device="cpu")
    np.testing.assert_array_equal(got.points, want.points)
    assert (got.size, got.predicted_size, got.octomap_resolution) == (
        want.size, want.predicted_size, want.octomap_resolution)
    np.testing.assert_array_equal(got.gt_scene.occupancy.numpy(), np.asarray(want.gt_scene.occupancy))
