"""The port's path planning against the JAX package: local paths and
trajectories, the batched edge matrix, the TSP orders and the written
``N_path.txt`` files."""

import importlib
import shutil

import numpy as np
import pytest
import torch

from nerf_prv_tpu.viewspace import hemisphere as jhemi
from nerf_prv_tpu_torch import planning as tpkg

# one thread for PyTorch: the tests' tensors are tiny, and several test workers on
# a few cores otherwise spend their time contending for them (minutes, not seconds)
torch.set_num_threads(1)

# the packages export the function `local_path` under the module's name
jlp = importlib.import_module("nerf_prv_tpu.planning.local_path")
tlp = importlib.import_module("nerf_prv_tpu_torch.planning.local_path")
jtsp = importlib.import_module("nerf_prv_tpu.planning.tsp")
ttsp = importlib.import_module("nerf_prv_tpu_torch.planning.tsp")

# the port's float32 edge matrix against the reference's jitted float32 one.
# Measured up to 2.2e-6 relative on hemisphere view spaces and 4.5e-6 on
# random points, on detours whose chord passes near the centre, where
# arccos is ill-conditioned: there each side's float32 result is itself up
# to 3.8e-6 (port) and 1.5e-6 (reference) from the float64 scalar length
# (XLA's acos and sums round otherwise than torch's).  So 1e-5
PAIR_RTOL = 1e-5
# against the float64 scalar local_path, the same float32 rounding
SCALAR_RTOL = 1e-5


def _views(n, seed):
    return jhemi.generate_hemisphere(n, seed=seed, restarts=2, steps=100) * 0.3


def _random_points(n, seed):
    """Points around a unit-radius sphere at the origin, some inside it."""
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3))
    return p / np.linalg.norm(p, axis=1, keepdims=True) * rng.uniform(0.8, 2.5, size=(n, 1))


def test_local_path_and_trajectory_equal():
    rng = np.random.default_rng(0)
    o = np.array([0.0, 0.0, 0.05])
    kinds = set()
    for _ in range(300):
        m, n = _random_points(2, int(rng.integers(1 << 30)))
        want, got = jlp.local_path(m, n, o, 1.0), tlp.local_path(m, n, o, 1.0)
        assert got == want
        kinds.add(got[0])
        jt, tt = jlp.trajectory(m, n, o, 0.9, 0.05, 0.1), tlp.trajectory(m, n, o, 0.9, 0.05, 0.1)
        assert tt[0] == jt[0] and len(tt[1]) == len(jt[1])
        for a, b in zip(tt[1], jt[1]):
            np.testing.assert_array_equal(a, b)
    assert kinds == {tlp.LINE_PATH, tlp.WRONG_PATH, tlp.CIRCLE_PATH}


@pytest.mark.parametrize("case", ["hemisphere", "random"])
def test_pairwise_lengths_match_jax_and_scalar_classes(case):
    kinds = set()
    for n, seed in ((3, 1), (17, 2), (40, 3)):
        if case == "hemisphere":
            views, center, r = _views(n, seed), np.zeros(3) + 1e-10, 0.15
        else:
            views, center, r = _random_points(n, seed), np.array([0.0, 0.0, 0.05]), 1.0
        want = np.asarray(jlp.pairwise_lengths(views, center, r))
        got = tlp.pairwise_lengths(views, center, r, device="cpu")
        assert got.dtype == torch.float32 and got.shape == (n, n)
        got = got.numpy()
        off = ~np.eye(n, dtype=bool)
        np.testing.assert_allclose(got[off], want[off], rtol=PAIR_RTOL)
        modes = np.array([[tlp.local_path(views[i], views[j], center, r)[0] if i != j else tlp.LINE_PATH
                           for j in range(n)] for i in range(n)])
        lengths = np.array([[tlp.local_path(views[i], views[j], center, r)[1] if i != j else 0.0
                             for j in range(n)] for i in range(n)])
        wrong = modes == tlp.WRONG_PATH
        assert (got[wrong] == tlp._BIG).all() and (want[wrong] == tlp._BIG).all()
        assert (got[~wrong] < tlp._BIG).all()
        np.testing.assert_allclose(got[~wrong & off], lengths[~wrong & off], rtol=SCALAR_RTOL)
        kinds |= set(modes[off].tolist())
    assert kinds == ({tlp.LINE_PATH, tlp.CIRCLE_PATH} if case == "hemisphere" else
                     {tlp.LINE_PATH, tlp.CIRCLE_PATH, tlp.WRONG_PATH})


@pytest.mark.parametrize("n", [5, 12, 16, 17, 25, 40])
def test_solve_open_tsp_identical_orders(n):
    rng = np.random.default_rng(n)
    pts = rng.uniform(size=(n, 2))
    dist = np.linalg.norm(pts[:, None] - pts[None], axis=-1).astype(np.float32)
    for start, end, seed in ((0, None, 0), (n // 2, None, 3), (1, n - 1, 1)):
        want = jtsp.solve_open_tsp(dist, start, end, seed=seed)
        got = ttsp.solve_open_tsp(dist, start, end, seed=seed)
        assert got == want
        assert got[0] == start and sorted(got) == list(range(n)) and (end is None or got[-1] == end)


def test_global_path_planner_matches_jax():
    views = _views(24, 5)
    subset = [0, 2, 3, 5, 7, 8, 11, 13, 17, 19, 20, 23]
    args = (views, subset, np.array([0.001, 0.0, 0.0]), 0.14, subset[3])
    want, got = jtsp.GlobalPathPlanner(*args), ttsp.GlobalPathPlanner(*args, device="cpu")
    assert got.dist.dtype == want.dist.dtype == np.float32
    np.testing.assert_allclose(got.dist, want.dist, rtol=PAIR_RTOL)
    assert got.solve() == pytest.approx(want.solve(), rel=PAIR_RTOL)
    assert got.get_path_id_set() == want.get_path_id_set()


def test_precompute_paths_writes_identical_files(tmp_path):
    """N_path.txt for 3..20 views on the same view spaces.  The two float32
    edge matrices differ in the last bits, so where two orders cost the same
    to float32 precision the solver may pick either: a file that differs
    must then cost the same within 1e-6 relative under one matrix (measured:
    all 18 files byte-identical)."""
    sizes = range(3, 21)
    a, b = tmp_path / "jax", tmp_path / "port"
    for n in sizes:
        jhemi.save_view_space(str(a), jhemi.generate_hemisphere(n, seed=n, restarts=2, steps=100))
    shutil.copytree(a, b)
    jtsp.precompute_paths(str(a), sizes)
    tpkg.precompute_paths(str(b), sizes, device="cpu")
    identical = 0
    for n in sizes:
        views = jhemi.load_view_space(str(a), n)
        order, ref = jhemi.load_path_order(str(b), n), jhemi.load_path_order(str(a), n)
        assert sorted(order) == list(range(n)) and order[0] == ref[0]
        dist = tlp.pairwise_lengths(views, np.zeros(3) + 1e-10, 0.5 * np.linalg.norm(views[0]), device="cpu").numpy()
        cost_t = float(dist[order[:-1], order[1:]].sum())
        cost_j = float(dist[ref[:-1], ref[1:]].sum())
        assert cost_t == pytest.approx(cost_j, rel=1e-6), n
        identical += (b / f"{n}_path.txt").read_bytes() == (a / f"{n}_path.txt").read_bytes()
    assert identical >= len(sizes) - 2, identical


def test_package_exports_the_reference_names():
    jpkg = importlib.import_module("nerf_prv_tpu.planning")
    assert sorted(tpkg.__all__) == sorted(jpkg.__all__)
    assert (tlp.ERROR_PATH, tlp.WRONG_PATH, tlp.LINE_PATH, tlp.CIRCLE_PATH, tlp._BIG) == (
        jlp.ERROR_PATH, jlp.WRONG_PATH, jlp.LINE_PATH, jlp.CIRCLE_PATH, jlp._BIG)
