"""The port's view spaces against the JAX package's, on the CPU: file IO
byte for byte, ``ViewSpace`` placement, the Riesz-energy descent from the
reference's own start points, packing quality of ``generate_hemisphere``,
and the novel-view scores on the same draws."""

import os

import jax
import numpy as np
import pytest
import torch

from nerf_prv_tpu.viewspace import hemisphere as jh
from nerf_prv_tpu.viewspace import novel as jn
from nerf_prv_tpu_torch.viewspace import hemisphere as th
from nerf_prv_tpu_torch.viewspace import novel as tn

torch.set_num_threads(1)

# f32 descent on both sides, other summation orders (closed-form gradient
# here, autodiff there): measured 8.9e-8 after 20 steps and 3.0e-7 after
# 800 on the points, 1e-6 relative on the energy
DESCENT_TOL = 2e-6
# pairwise distances summed over 100 x 100 views in f32, other orders:
# measured 2.0e-6 relative
SCORE_RTOL = 1e-5


def test_view_space_and_path_files_are_byte_equal(tmp_path):
    pts = np.random.default_rng(0).normal(size=(17, 3))
    order = np.random.default_rng(1).permutation(17)
    a, b = tmp_path / "jax", tmp_path / "port"
    for mod, d in ((jh, a), (th, b)):
        mod.save_view_space(str(d), pts)
        mod.save_path_order(str(d), order)
    for name in ("17.txt", "17_path.txt"):
        assert (a / name).read_bytes() == (b / name).read_bytes()
    np.testing.assert_array_equal(th.load_view_space(str(a), 17), jh.load_view_space(str(a), 17))
    np.testing.assert_array_equal(th.load_path_order(str(a), 17), jh.load_path_order(str(a), 17))
    (a / "16.txt").write_bytes((a / "17.txt").read_bytes())
    with pytest.raises(ValueError):  # 17 rows in a file that names 16
        th.load_view_space(str(a), 16)


def test_view_space_placement_and_top_view(tmp_path):
    views = jh.generate_hemisphere(9, seed=4, restarts=2, steps=100)
    obj = np.random.default_rng(2).normal(size=(300, 3)) * 0.05 + [0.01, -0.02, 0.03]
    want, got = jh.ViewSpace(views, obj, 0.3), th.ViewSpace(views, obj, 0.3)
    np.testing.assert_array_equal(got.views, want.views)
    np.testing.assert_array_equal(got.object_center, want.object_center)
    assert got.predicted_size == want.predicted_size and len(got) == len(want) == 9
    assert got.top_view_id() == want.top_view_id()
    lower = np.concatenate([views, [[0.0, 0.6, -0.8]]])
    assert len(th.ViewSpace(lower, obj, 0.3)) == 9  # z < 0 views are dropped
    with pytest.raises(ValueError):
        th.ViewSpace(views[1:], obj, 0.3).top_view_id()


@pytest.mark.parametrize("n,steps", [(12, 20), (12, 800), (30, 120)])
def test_descent_from_the_reference_start_points(n, steps):
    """The port's batched descent, fed the reference's ``jax.random.normal``
    start points (three restarts), lands where the reference's does."""
    keys = jax.random.split(jax.random.PRNGKey(n + steps), 3)
    raw = np.stack([np.asarray(jax.random.normal(k, (n, 3))) for k in keys])
    pts, energy = th._optimize_one(torch.from_numpy(raw), steps)
    for r, k in enumerate(keys):
        jp, je = jh._optimize_one(k, n, steps)
        np.testing.assert_allclose(pts[r].numpy(), np.asarray(jp), rtol=0, atol=DESCENT_TOL)
        assert float(energy[r]) == pytest.approx(float(je), rel=DESCENT_TOL)
        assert pts[r, 0].tolist() == [0.0, 0.0, 1.0] and bool((pts[r, :, 2] >= 0).all())


@pytest.mark.parametrize("n", [1, 5, 16])
def test_generate_hemisphere_packs_as_well_as_the_reference(n):
    """Other draws than the reference's, so held by packing quality: the
    pole pinned, unit vectors on the upper hemisphere, and min angle and
    energy within 10% of the reference's for the same restarts and steps."""
    got = th.generate_hemisphere(n, seed=0, restarts=4, steps=300, device="cpu")
    want = jh.generate_hemisphere(n, seed=0, restarts=4, steps=300)
    assert got.shape == (n, 3) and got.dtype == np.float64
    np.testing.assert_allclose(got[0], [0.0, 0.0, 1.0])
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    assert (got[:, 2] >= 0).all()
    if n > 1:
        assert th.min_pairwise_angle(got) >= 0.9 * jh.min_pairwise_angle(want)
        e = lambda p: float(th._riesz_energy(torch.from_numpy(p[None].astype(np.float32)))[0])  # noqa: E731
        assert e(got) <= 1.1 * e(want)
        assert th.sum_pairwise_distance(got) == pytest.approx(jh.sum_pairwise_distance(got))
        assert th.min_pairwise_angle(want) == jh.min_pairwise_angle(want)


def test_generate_all_skips_existing_files(tmp_path):
    d = str(tmp_path)
    th.save_view_space(d, np.eye(3))
    before = (tmp_path / "3.txt").read_bytes()
    th.generate_all(d, sizes=[3, 4], device="cpu")
    assert (tmp_path / "3.txt").read_bytes() == before
    assert th.load_view_space(d, 4).shape == (4, 3)


def test_novel_scores_on_the_same_draws():
    """The port's scoring of the reference's own normal draws: the same
    hemisphere points and the same top-weighted dispersion scores."""
    key = jax.random.PRNGKey(7)
    want_pts, want_score = jn._sample_and_score(key, 20, 50)
    raw = np.array(jax.random.normal(key, (50, 20, 3)))
    pts, score = tn._score(torch.from_numpy(raw))
    np.testing.assert_allclose(pts.numpy(), np.asarray(want_pts), rtol=0, atol=1e-7)
    np.testing.assert_allclose(score.numpy(), np.asarray(want_score), rtol=SCORE_RTOL)
    assert int(torch.argmax(score)) == int(np.argmax(np.asarray(want_score)))


def test_novel_views_sampling_and_files(tmp_path):
    vs = str(tmp_path / "vs")
    jh.save_view_space(vs, jh.generate_hemisphere(5, seed=0, restarts=2, steps=50))
    views = tn.sample_novel_views(30, seed=1, restarts=64, device="cpu")
    assert views.shape == (30, 3) and (views[:, 2] >= 0).all()
    np.testing.assert_allclose(np.linalg.norm(views, axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(tn.coverage_directions(vs), jn.coverage_directions(vs))
    ws = str(tmp_path / "ws")
    train, test = tn.get_or_create_novel_views(ws, vs, num_views=10, seed=0, device="cpu")
    assert train.shape == test.shape == (10, 3) and not np.allclose(train, test)
    # idempotent, and the reference reads the same files back
    again = tn.get_or_create_novel_views(ws, vs, num_views=10, seed=5, device="cpu")
    ref = jn.get_or_create_novel_views(ws, vs, num_views=10, seed=5)
    for a, b, c in zip((train, test), again, ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)
    assert sorted(os.listdir(ws)) == ["novel_test_views.txt", "novel_train_views.txt"]
