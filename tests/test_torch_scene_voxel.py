"""The port's ground-truth voxel scene against the JAX package's: the
downsampling, the 32^3 sample grid and the dense grids equal, and the
occupancy ray cast (K9's plain version on the CPU) against
``_cast_rays_grid``, misses included."""

import numpy as np
import pytest
import torch

from nerf_prv_tpu.core.config import CameraConfig as JCam
from nerf_prv_tpu.core.pose import camera_to_world
from nerf_prv_tpu.scene import voxel as jv
from nerf_prv_tpu_torch.core.config import CameraConfig as TCam
from nerf_prv_tpu_torch.ops.voxel_cast import voxel_cast, voxel_cast_plain
from nerf_prv_tpu_torch.scene import voxel as tv

from synthetic import make_object

torch.set_num_threads(1)

# voxel centres: XLA contracts (idx + 0.5) * res + origin into an FMA, the
# port rounds the product first: measured at most 3.7e-9 apart (one f32 ulp
# at 0.05 m); hit flags and colours are equal
POS_TOL = 1e-8


def _scene(res=0.004, seed=0):
    pts, cols = make_object(20000, seed=seed)
    return pts, cols, jv.VoxelScene(pts, cols, res), tv.VoxelScene(pts, cols, res, device="cpu")


def test_voxel_downsample_and_gt_sample_equal():
    pts, cols = make_object(5000, seed=4)
    for res in (0.002, 0.0047):
        for a, b in zip(tv.voxel_downsample(pts, cols, res), jv.voxel_downsample(pts, cols, res)):
            np.testing.assert_array_equal(a, b)
    c, _, _ = tv.voxel_downsample(pts, None, 0.003)
    assert tv.voxel_downsample(pts, None, 0.003)[1] is None and len(c) > 100
    got, want = tv.make_gt_sample(pts, pts.mean(0), 0.05), jv.make_gt_sample(pts, pts.mean(0), 0.05)
    np.testing.assert_array_equal(got.occupancy, want.occupancy)
    np.testing.assert_array_equal(got.origin, want.origin)
    assert (got.resolution, got.init_voxels, got.occupied_voxels) == (
        want.resolution, want.init_voxels, want.occupied_voxels)


def test_voxel_scene_grids_equal():
    _, _, js, ts = _scene()
    np.testing.assert_array_equal(ts.occupancy.numpy(), np.asarray(js.occupancy))
    np.testing.assert_array_equal(ts.color_grid.numpy(), np.asarray(js.color_grid))
    np.testing.assert_array_equal(ts.origin, js.origin)
    np.testing.assert_array_equal(ts.dims, js.dims)
    assert ts.full_voxels == js.full_voxels and ts.occupancy.dtype == torch.bool


def _compare(got, want):
    hit, pos, col = (t.numpy() for t in got)
    np.testing.assert_array_equal(hit, np.asarray(want[0]))
    np.testing.assert_allclose(pos, np.asarray(want[1]), rtol=0, atol=POS_TOL)
    np.testing.assert_array_equal(col, np.asarray(want[2]))


@pytest.mark.parametrize("max_range,steps_per_voxel", [(0.5, 2.0), (0.35, 1.0)])
def test_cast_rays_matches_reference_with_misses(max_range, steps_per_voxel):
    pts, _, js, ts = _scene(seed=1)
    rng = np.random.default_rng(2)
    n = 700
    o = rng.normal(size=(n, 3))
    o = (o / np.linalg.norm(o, axis=1, keepdims=True) * 0.2 + pts.mean(0)).astype(np.float32)
    d = (pts.mean(0) - o + rng.normal(size=(n, 3)) * 0.03).astype(np.float32)
    d[::4] *= -1.0  # a quarter aimed away: misses report step 0's clipped voxel
    want = js.cast_rays(o, d, max_range=max_range, steps_per_voxel=steps_per_voxel)
    got = ts.cast_rays(o, d, max_range=max_range, steps_per_voxel=steps_per_voxel)
    _compare(got, want)
    hits = np.asarray(want[0])
    assert 0.3 < hits.mean() < 0.8 and not hits[::4].any()


@pytest.mark.parametrize("model", [0, 2])
def test_precept_matches_reference(model):
    pts, _, js, ts = _scene(seed=2)
    center = pts.mean(0)
    kw = dict(width=64, height=48, fx=70.0, fy=70.0, ppx=32.0, ppy=24.0, model=model)
    if model == 2:
        kw.update(k1=0.12, k2=-0.21)
    for v in ([0.3, 0.2, 0.9], [-0.5, 0.1, 0.6]):
        v = np.asarray(v) / np.linalg.norm(v) * 0.3 + center
        c2w = camera_to_world(v[None], center)[0]
        want = jv.precept(js, c2w, JCam(**kw), max_range=0.5)
        got = tv.precept(ts, c2w, TCam(**kw), max_range=0.5)
        assert got[0].shape == (48, 64) and got[1].shape == got[2].shape == (48, 64, 3)
        _compare(got, want)
        assert 0.05 < want[0].mean() < 0.6


def test_voxel_cast_wrapper_uses_the_plain_version_on_the_cpu():
    _, _, _, ts = _scene(seed=3)
    rng = np.random.default_rng(0)
    o = torch.from_numpy(rng.normal(size=(50, 3)).astype(np.float32) * 0.2)
    d = -o
    args = (ts.occupancy, ts.color_grid, ts.origin, ts.resolution, o, d, 0.4, 100)
    before = voxel_cast.launches
    for a, b in zip(voxel_cast(*args), voxel_cast_plain(*args, chunk=7)):
        assert torch.equal(a, b)
    assert voxel_cast.launches == before  # no kernel on the CPU
    with pytest.raises(ValueError):
        voxel_cast(ts.occupancy.float(), *args[1:])


def test_colorize_depth_equal():
    d = np.random.default_rng(0).uniform(0, 2, size=(20, 30))
    np.testing.assert_array_equal(tv.colorize_depth(d), jv.colorize_depth(d))
    np.testing.assert_array_equal(tv.colorize_depth(np.zeros((3, 3))), jv.colorize_depth(np.zeros((3, 3))))
