"""The port's labeling stage against the JAX package: the batched lognormal
fit, the labels, ``label.txt``, the label statistics and the PRVNet
dataset split, on inputs made with numpy from a seed."""

import importlib
import os

import numpy as np
import pytest
import torch
from scipy.stats import norm

from nerf_prv_tpu.labeling import dataset as jds
from nerf_prv_tpu.labeling import labels as jlab
from nerf_prv_tpu.labeling import stats as jst
from nerf_prv_tpu.nerf import api as japi
from nerf_prv_tpu_torch import labeling as tpkg
from nerf_prv_tpu_torch.labeling import dataset as tds
from nerf_prv_tpu_torch.labeling import labels as tlab
from nerf_prv_tpu_torch.labeling import stats as tst

# one thread for PyTorch: the tests' tensors are tiny, and several test workers on
# a few cores otherwise spend their time contending for them (minutes, not seconds)
torch.set_num_threads(1)

jln = importlib.import_module("nerf_prv_tpu.labeling.lognormal")
tln = importlib.import_module("nerf_prv_tpu_torch.labeling.lognormal")

X = np.arange(3, 51, 2, dtype=np.float64)  # Fit_ShapeNet's 24 view counts
B = 96
# port fit against JAX fit, both float32 LM of 100 steps.  Measured on 400
# curves: noiseless, parameters within 1.6e-5 relative and curves within
# 4.4e-5 dB; with noise of 0.05 / 0.3 dB, 3.4e-4 / 4.7e-4 relative and
# 8.6e-4 / 2.0e-3 dB (the noisy fits end in a flat valley, where the two
# erf implementations' last ulp steer the accept/reject decisions apart).
# Costs within 6.2e-5 relative; converged flags equal everywhere
PARAM_RTOL = {0.0: 1e-4, 0.05: 2e-3, 0.3: 2e-3}
CURVE_ATOL = {0.0: 2e-4, 0.05: 4e-3, 0.3: 8e-3}
COST_RTOL = 3e-4
# the curves' view-to-view differences (the gradient labels' input) differ by
# less: measured 8.3e-5 to 4.2e-4 dB over five seeds at both noise levels
DIFF_ATOL = 1e-3


def _curves(seed, noise, b=B, x=X):
    rng = np.random.default_rng(seed)
    y0 = rng.uniform(8, 15, b)
    a = rng.uniform(10, 25, b)
    mu = np.log(rng.uniform(6, 30, b))
    sg = rng.uniform(0.4, 1.3, b)
    clean = y0[:, None] + a[:, None] * norm.cdf((np.log(x)[None] - mu[:, None]) / sg[:, None])
    ys = clean + rng.normal(0, noise, clean.shape)
    top = y0 + a * norm.cdf((np.log(100.0) - mu) / sg)
    return ys, top + rng.uniform(-0.2, 0.8, b)


@pytest.mark.parametrize("noise", [0.0, 0.05, 0.3])
def test_fit_batch_matches_jax(noise):
    ys, _ = _curves(1, noise)
    want = jln.fit_batch(X, ys)
    got = tln.fit_batch(X, ys, device="cpu")
    assert isinstance(got.params, torch.Tensor) and got.params.shape == (B, 4)
    pj, pt = np.asarray(want.params), got.params.numpy()
    assert np.isfinite(pt).all() and (pt[:, 3] > 0).all()
    np.testing.assert_allclose(pt, pj, rtol=PARAM_RTOL[noise], atol=1e-6)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=COST_RTOL, atol=1e-6)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    assert got.converged.numpy().mean() > 0.9
    cj = jln.eval_curve(pj, jlab.X_EVAL)
    ct = tln.eval_curve(got.params, tlab.X_EVAL)
    assert ct.shape == (B, 98)
    np.testing.assert_allclose(ct, cj, rtol=0, atol=CURVE_ATOL[noise])


def test_single_fit_and_cdf_match_jax():
    ys, _ = _curves(2, 0.05, b=1)
    want = jln.fit_lognormal(X, ys[0])
    got = tln.fit_lognormal(X, ys[0], device="cpu")
    assert got.params.shape == (4,) and bool(got.converged) == bool(want.converged)
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params), rtol=PARAM_RTOL[0.05])
    p = np.asarray(want.params)[None].astype(np.float32)
    x = np.float32(jlab.X_EVAL)
    np.testing.assert_allclose(
        tln.lognormal_cdf(torch.from_numpy(x), torch.from_numpy(p)).numpy(),
        np.asarray(jln.lognormal_cdf(x, p)), rtol=1e-6)


def test_labels_from_curve_equal_on_the_same_curve():
    ys, tops = _curves(3, 0.05, b=32)
    curves = jln.eval_curve(np.asarray(jln.fit_batch(X, ys).params), jlab.X_EVAL)
    for c, m in zip(curves, tops):
        want, got = jlab.labels_from_curve(c, m), tlab.labels_from_curve(c, m)
        for k in ("gap", "gradient"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def _robust(margins, tol):
    """Per threshold row of ``margins`` (> 0: the view meets it), whether
    the first view that meets it stays the first under any change of the
    margins by at most ``tol``: every earlier view misses by more, and the
    first one (if any) meets it by more."""
    hit = margins > 0
    first = np.where(hit.any(axis=1), hit.argmax(axis=1), margins.shape[1])
    ok = []
    for row, j in zip(margins, first):
        ok.append(bool((row[:j] < -tol).all() and (j == len(row) or row[j] > tol)))
    return np.array(ok)


def _robust_labels(curve, max_psnr):
    """(gap, gradient) masks of the labels that a curve within CURVE_ATOL dB
    of ``curve``, its differences within DIFF_ATOL, must share with it
    (labels_from_curve's decisions)."""
    gap = _robust(curve[None, :] - np.outer(1.0 - 0.01 * np.arange(tlab.N_GAPS), [max_psnr]),
                  CURVE_ATOL[0.05])
    ts = 0.01 * (np.arange(tlab.N_GRADIENTS) + 1)
    grad = _robust(ts[:, None] - np.diff(curve)[None, :], DIFF_ATOL)
    return gap, grad


def test_fit_objects_labels_equal_away_from_thresholds():
    """Whole-fit labels equal JAX's wherever the decision does not lie
    within the curve tolerance of its threshold; the convergence rule (with
    and without the samples-below-max check) equal everywhere."""
    ys, tops = _curves(4, 0.05)
    tops[:8] = ys[:8].max(axis=1) - 0.5  # a sample above the 100-view PSNR
    for check in (True, False):
        want = jlab.fit_objects(X, ys, tops, check_samples_below_max=check)
        got = tlab.fit_objects(X, ys, tops, check_samples_below_max=check, device="cpu")
        assert [r.converged for r in got] == [r.converged for r in want]
        assert (not check) or not any(r.converged for r in got[:8])
        compared = 0
        for g, w, m in zip(got, want, tops):
            np.testing.assert_allclose(g.curve, w.curve, rtol=0, atol=CURVE_ATOL[0.05])
            np.testing.assert_allclose(np.diff(g.curve), np.diff(w.curve), rtol=0, atol=DIFF_ATOL)
            gap, grad = _robust_labels(w.curve.astype(np.float64), m)
            np.testing.assert_array_equal(g.gap_labels[gap], w.gap_labels[gap])
            np.testing.assert_array_equal(g.gradient_labels[grad], w.gradient_labels[grad])
            compared += gap.sum() + grad.sum()
        assert compared >= 0.6 * B * (tlab.N_GAPS + tlab.N_GRADIENTS), compared  # 72% on this seed


def _label_results(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        curve = np.sort(rng.uniform(10, 35, 98)).astype(np.float32)
        gaps = rng.integers(-1, 100, tlab.N_GAPS)
        grads = rng.integers(-1, 70, tlab.N_GRADIENTS)
        out.append(tlab.LabelResult(bool(rng.uniform() < 0.9), curve, gaps, grads))
    return out


def test_label_file_byte_identical_and_parsed_alike(tmp_path):
    for i, r in enumerate(_label_results(5, 6)):
        a, b = str(tmp_path / f"j{i}" / "label.txt"), str(tmp_path / f"t{i}" / "label.txt")
        jlab.write_label_file(a, jlab.LabelResult(r.converged, r.curve, r.gap_labels, r.gradient_labels))
        tlab.write_label_file(b, r)
        assert open(a, "rb").read() == open(b, "rb").read()
        pj, pt = jlab.parse_label_file(a), tlab.parse_label_file(b)
        assert pt.converged == pj.converged
        for f in ("curve", "gap_labels", "gradient_labels"):
            np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f))
    bad = tmp_path / "bad.txt"
    bad.write_text(open(a).read().replace("gap 3%", "gop 3%"))
    with pytest.raises(ValueError, match="label wrong"):
        tlab.parse_label_file(str(bad))


def test_fit_object_from_metrics_matches_jax(tmp_path):
    ys, tops = _curves(6, 0.05, b=1)
    for v, y in zip(X.astype(int), ys[0]):
        japi.save_metrics(str(tmp_path / f"{v}.txt"), {"PSNR": float(y), "SSIM": 0.9})
    japi.save_metrics(str(tmp_path / "100.txt"), {"PSNR": float(tops[0]), "SSIM": 0.9})
    for hb in (False, True):
        want = jlab.fit_object_from_metrics(str(tmp_path), label_path=str(tmp_path / f"j{hb}.txt"), hb=hb)
        got = tlab.fit_object_from_metrics(str(tmp_path), label_path=str(tmp_path / f"t{hb}.txt"), hb=hb,
                                           device="cpu")
        assert got.converged == want.converged
        np.testing.assert_allclose(got.curve, want.curve, rtol=0, atol=CURVE_ATOL[0.05])
        gap, grad = _robust_labels(want.curve.astype(np.float64), tops[0])
        assert gap.sum() + grad.sum() >= 15  # 22 of 31 on this curve
        np.testing.assert_array_equal(got.gap_labels[gap], want.gap_labels[gap])
        np.testing.assert_array_equal(got.gradient_labels[grad], want.gradient_labels[grad])
        assert tlab.parse_label_file(str(tmp_path / f"t{hb}.txt")).converged == got.converged
    assert tlab.hb_view_counts() == jlab.hb_view_counts() and tlab.HB_SKIP == jlab.HB_SKIP


def test_label_stats_identical(tmp_path):
    results = _label_results(7, 40)
    results[3] = tlab.LabelResult(False, results[3].curve, results[3].gap_labels, results[3].gradient_labels)
    jst.write_label_stats(str(tmp_path / "j"), results)
    tst.write_label_stats(str(tmp_path / "t"), results)
    for name in ("label_mean_std.txt", "label_distribution.txt"):
        assert (tmp_path / "j" / name).read_bytes() == (tmp_path / "t" / name).read_bytes()
    names = [f"obj{i}" for i in range(5)]
    for i, name in enumerate(names):
        tlab.write_label_file(str(tmp_path / "labels" / f"ShapeNet_{i // 3}_label" / name / "label.txt"), results[i])
    a = jst.read_all_labels(str(tmp_path / "labels"), names, batch_size=3)
    b = tst.read_all_labels(str(tmp_path / "labels"), names, batch_size=3)
    assert [r.converged for r in a] == [r.converged for r in b]
    for ra, rb in zip(a, b):
        np.testing.assert_array_equal(ra.gradient_labels, rb.gradient_labels)


def _dataset_inputs(seed=8, n=240):
    rng = np.random.default_rng(seed)
    cats = tds.CATEGORY_PREFIXES[:6]
    names = [f"{cats[i % len(cats)]}{i:04d}" for i in range(n)]
    results = []
    for _ in names:
        grads = np.full(tlab.N_GRADIENTS, -1, np.int64)
        grads[tds.LABEL_INDEX] = rng.choice([-1, 8, 70] + list(range(13, 30)))
        results.append(tlab.LabelResult(bool(rng.uniform() < 0.9), np.zeros(98), np.full(11, -1), grads))
    return names, results


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


@pytest.mark.parametrize("split", ["reference", "holdout"])
def test_split_and_dataset_identical(tmp_path, split):
    names, results = _dataset_inputs()
    sel = tds.select_labels(names, results)
    assert sel == jds.select_labels(names, results) and 50 < len(sel) < len(names)
    for seed in (0, 1, 2):
        assert tds.stratified_split(sel, seed=seed, split=split) == jds.stratified_split(sel, seed=seed, split=split)
    cov = tmp_path / "cov"
    for name in names[:5]:
        os.makedirs(cov / name / "4")
        for j in range(4):
            (cov / name / "4" / f"rgbaClip_{j}.png").write_bytes(bytes([j]) * 8)
    want = jds.build_dataset(str(tmp_path / "j"), names, results, coverage_root=str(cov), n_views=4, seed=3,
                             split=split)
    got = tds.build_dataset(str(tmp_path / "t"), names, results, coverage_root=str(cov), n_views=4, seed=3,
                            split=split)
    assert got == want
    tree = _tree(tmp_path / "t")
    assert tree == _tree(tmp_path / "j") and len(tree) > len(sel)
    path = str(tmp_path / "t" / "sorted_object_names.txt")
    assert tds.read_sorted_object_names(path) == jds.read_sorted_object_names(path) == sel
    with pytest.raises(ValueError, match="split"):
        tds.stratified_split(sel, split="other")


def test_package_exports_the_reference_names():
    jpkg = importlib.import_module("nerf_prv_tpu.labeling")
    assert sorted(tpkg.__all__) == sorted(jpkg.__all__)
    assert tpkg.X_EVAL.tolist() == jpkg.X_EVAL.tolist()
