"""The port's PRVNet against the JAX package: weights carried from Flax trees
into the port's state dicts and back through the JAX package's own
converters, ConvNeXt-V2 / ResNet-50 / PVBNet logits against Flax ``apply``,
the image loaders bit for bit, and the budget predictor on written PNGs."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nerf_prv_tpu.prvnet import convnextv2 as jconv
from nerf_prv_tpu.prvnet import data as jdata
from nerf_prv_tpu.prvnet import infer as jinfer
from nerf_prv_tpu.prvnet import model as jmodel
from nerf_prv_tpu.prvnet import resnet as jresnet
from nerf_prv_tpu_torch.convert import prvnet_state_dict_from_flax, prvnet_state_dict_to_flax
from nerf_prv_tpu_torch.prvnet import convnextv2 as tconv
from nerf_prv_tpu_torch.prvnet import data as tdata
from nerf_prv_tpu_torch.prvnet import infer as tinfer
from nerf_prv_tpu_torch.prvnet import model as tmodel
from nerf_prv_tpu_torch.prvnet import resnet as tresnet

torch.set_num_threads(1)

# float32 forward passes against Flax's on the CPU: measured 2.1e-6 and
# 4.0e-7 relative on PVBNet's logits (atto, 64x64, K = 2 and 3), 8.2e-7
# on the atto encoder's features and 8.1e-7 on ResNet-50's; XLA and ATen
# sum the convolutions in other orders.  So 2e-5 relative to the output's
# largest magnitude
LOGIT_RTOL = 2e-5
# the continuous budget 13 + 45 * sigmoid(logit): 45/4 times the logit's
# error at most, on a logit of a few units
BUDGET_ATOL = 1e-3


def _random_tree(module, x, seed):
    """Seeded random Flax params for ``module`` at input ``x``, as numpy: the
    tree's shapes come from ``jax.eval_shape`` (an eager Flax ``init`` takes
    many seconds on the CPU).  Every leaf is non-trivial (GRN's gamma and
    beta and the head are not at their zero init); kernels are scaled by
    their fan-in, BatchNorm variances kept positive."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]

    def leaf(path, sd):
        name = jax.tree_util.keystr(path[-1:])
        noise = rng.standard_normal(sd.shape).astype(np.float32)
        if name == "['kernel']":
            return noise / np.sqrt(np.prod(sd.shape[:-1]))
        if name == "['scale']":
            return 1 + 0.1 * noise
        if name == "['var']":
            return 1 + 0.2 * np.abs(noise)
        return 0.05 * noise

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _apply(module, params, x):
    return np.asarray(jax.jit(module.apply)({"params": params}, jnp.asarray(x)))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_same_tree(got, want):
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w), set(g) ^ set(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


def _pvbnet_params(seed, k=3, size=64, bias=None):
    m = jmodel.make_pvbnet("convnextv2_atto")
    p = _random_tree(m, np.zeros((1, k, size, size, 3), np.float32), seed)
    if bias is not None:
        p["fc4"]["bias"] = np.full_like(p["fc4"]["bias"], bias)
    return m, p


def _resnet50_params(seed, size=32):
    r = jresnet.resnet50()
    return r, _random_tree(r, np.zeros((1, size, size, 3), np.float32), seed)


@pytest.mark.parametrize("which", ["pvbnet_atto", "pvbpretrain_atto", "resnet50_encoder"])
def test_flax_tree_round_trips_through_the_reference_converter(which):
    """The JAX package's own converter inverts prvnet_state_dict_from_flax
    leaf for leaf, and so does the port's inverse; the port's modules take
    the state dict with strict key and shape checks."""
    if which == "pvbnet_atto":
        _, tree = _pvbnet_params(0)
        back, module = jinfer.convert_torch_checkpoint, tmodel.make_pvbnet("convnextv2_atto")
    elif which == "pvbpretrain_atto":
        tree = _random_tree(jmodel.make_pvbpretrain("convnextv2_atto"), np.zeros((1, 64, 64, 3), np.float32), 1)
        back, module = jinfer.convert_torch_checkpoint, tmodel.make_pvbpretrain("convnextv2_atto")
    else:
        _, tree = _resnet50_params(2)
        back, module = jinfer.convert_encoder_state_dict, tresnet.resnet50()
    sd = prvnet_state_dict_from_flax(tree)
    _assert_same_tree(back(sd), tree)
    _assert_same_tree(prvnet_state_dict_to_flax(sd), tree)
    assert set(sd) == set(module.state_dict())
    module.load_state_dict(sd)
    # the reference checkpoint's ``module.`` prefixes are stripped
    _assert_same_tree(prvnet_state_dict_to_flax({"module." + k: v for k, v in sd.items()}), tree)


def test_grn_and_block_match_flax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 11, 16)).astype(np.float32)
    gp = {"gamma": rng.standard_normal((1, 1, 1, 16)).astype(np.float32),
          "beta": rng.standard_normal((1, 1, 1, 16)).astype(np.float32)}
    want = np.asarray(jconv.GRN(16).apply({"params": gp}, jnp.asarray(x)))
    grn = tconv.GRN(16)
    grn.load_state_dict({k: torch.from_numpy(v) for k, v in gp.items()})
    with torch.no_grad():
        got = grn(torch.from_numpy(x)).numpy()
    assert _rel(got, want) < LOGIT_RTOL

    bp = _random_tree(jconv.Block(16), x, 3)
    want = _apply(jconv.Block(16), bp, x)
    block = tconv.Block(16)
    block.load_state_dict({k.split(".", 3)[3]: v for k, v in
                           prvnet_state_dict_from_flax({"stage0_block0": bp}).items()})
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert _rel(got, want) < LOGIT_RTOL


def test_atto_encoder_matches_flax_at_64():
    x = np.random.default_rng(4).random((2, 64, 64, 3), dtype=np.float32)
    enc = jconv.convnextv2_atto()
    p = _random_tree(enc, x, 4)
    want = _apply(enc, p, x)
    t = tconv.convnextv2_atto()
    t.load_state_dict(prvnet_state_dict_from_flax(p))
    with torch.no_grad():
        got = t(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, 1000)
    assert _rel(got, want) < LOGIT_RTOL


@pytest.mark.parametrize("k", [2, 3])
def test_pvbnet_logits_match_flax(k):
    m, p = _pvbnet_params(5 + k, k=k)
    x = np.random.default_rng(k).random((2, k, 64, 64, 3), dtype=np.float32)
    want = _apply(m, p, x)
    t = tmodel.make_pvbnet("convnextv2_atto")
    t.load_state_dict(prvnet_state_dict_from_flax(p))
    with torch.no_grad():
        got = t(torch.from_numpy(x)).numpy()
    assert got.shape == (2,)
    assert _rel(got, want) < LOGIT_RTOL
    np.testing.assert_allclose(
        tmodel.logits_to_budget(torch.from_numpy(got)).numpy(),
        np.asarray(jmodel.logits_to_budget(want)), atol=BUDGET_ATOL)


def test_resnet50_encoder_matches_flax_at_32():
    r, p = _resnet50_params(6)
    x = np.random.default_rng(6).random((2, 32, 32, 3), dtype=np.float32)
    want = _apply(r, p, x)
    t = tresnet.resnet50()
    t.load_state_dict(prvnet_state_dict_from_flax(p))
    with torch.no_grad():
        got = t(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert np.isfinite(want).all() and got.shape == want.shape
    assert _rel(got, want) < LOGIT_RTOL
    assert set(tconv.MODELS) == set(jconv.MODELS)


def _write_pngs(root, names, size, mode, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    paths = []
    for name in names:
        c = 4 if mode == "RGBA" else 3
        Image.fromarray(rng.integers(0, 256, size + (c,), dtype=np.uint8), mode).save(
            os.path.join(root, name))
        paths.append(os.path.join(root, name))
    return paths


def test_center_crop_and_load_rgb_bit_equal(tmp_path):
    rgba = _write_pngs(str(tmp_path), ["a.png"], (54, 96), "RGBA", 7)[0]
    rgb = _write_pngs(str(tmp_path), ["b.png"], (40, 30), "RGB", 8)[0]
    for path in (rgba, rgb):
        for crop in (None, 32, 64, 720):
            np.testing.assert_array_equal(tdata.load_rgb(path, crop), jdata.load_rgb(path, crop))
    img = np.random.default_rng(9).integers(0, 256, (13, 21, 3), dtype=np.uint8)
    for size in (5, 13, 20, 30):
        np.testing.assert_array_equal(tdata.center_crop(img, size), jdata.center_crop(img, size))


def test_budget_predictor_from_coverage_matches_jax(tmp_path):
    """The same written RGBA coverage PNGs and weights through both
    predictors: the continuous budget within BUDGET_ATOL, the integer equal
    wherever the value clears that from a half-integer."""
    cov = str(tmp_path / "5")
    _write_pngs(cov, [f"rgbaClip_{i}.png" for i in range(5)], (72, 80), "RGBA", 10)
    for bias in (0.3, -1.1, 2.0):
        _, p = _pvbnet_params(11, bias=bias)
        jp = jinfer.BudgetPredictor(params=p, arch="convnextv2_atto", crop=64)
        tp = tinfer.BudgetPredictor(params=prvnet_state_dict_from_flax(p), arch="convnextv2_atto",
                                    crop=64, device="cpu")
        views = np.stack([jdata.load_rgb(os.path.join(cov, f"rgbaClip_{i}.png"), 64) for i in (0, 1, 3)])
        want = float(jp._apply(jp.params, jnp.asarray(views)[None])[0])
        got = tp.predict_value_from_arrays(tp.coverage_views(cov, [0, 1, 3]))
        assert abs(got - want) < BUDGET_ATOL, (got, want)
        budget = tp.predict_from_coverage(cov, [0, 1, 3])
        assert budget == int(np.round(got)) and 13 <= budget <= 58
        if abs(want - np.floor(want) - 0.5) > BUDGET_ATOL:
            assert budget == jp.predict_from_coverage(cov, [0, 1, 3])
    # one view is duplicated, as the reference's server does
    one = views[:1]
    assert abs(tp.predict_value_from_arrays(one)
               - float(jp._apply(jp.params, jnp.asarray(np.concatenate([one, one]))[None])[0])) < BUDGET_ATOL


def test_budget_predictor_reads_a_pth_checkpoint(tmp_path):
    """A reference-layout ``best_checkpoint.pth`` (``model_state_dict`` with
    ``module.`` prefixes) loads as it is, and a missing file raises."""
    _, p = _pvbnet_params(12, bias=0.7)
    sd = prvnet_state_dict_from_flax(p)
    path = str(tmp_path / "best_checkpoint.pth")
    torch.save({"epoch": 3, "model_state_dict": {"module." + k: v for k, v in sd.items()}}, path)
    imgs = str(tmp_path / "images")
    _write_pngs(imgs, [f"{i}.png" for i in (0, 1, 3)], (64, 64), "RGB", 13)
    tp = tinfer.BudgetPredictor(path, arch="convnextv2_atto", crop=64, device="cpu")
    jp = jinfer.BudgetPredictor(params=p, arch="convnextv2_atto", crop=64)
    views = np.stack([jdata.load_rgb(os.path.join(imgs, f"{i}.png"), 64) for i in (0, 1, 3)])
    want = float(jp._apply(jp.params, jnp.asarray(views)[None])[0])
    assert abs(tp.predict_value_from_arrays(views) - want) < BUDGET_ATOL
    assert tp.predict_from_dir(imgs) == jp.predict_from_dir(imgs)
    with pytest.raises(FileNotFoundError):
        tinfer.BudgetPredictor(str(tmp_path / "missing.pth"), device="cpu")


def test_budget_predictor_runs_on_the_card_by_default():
    _, p = _pvbnet_params(14)
    if torch.cuda.is_available():
        pred = tinfer.BudgetPredictor(params=prvnet_state_dict_from_flax(p), arch="convnextv2_atto")
        assert pred.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            tinfer.BudgetPredictor(params=prvnet_state_dict_from_flax(p), arch="convnextv2_atto")


def test_pretrained_encoder_loaders_match_jax():
    """``load_pretrained_encoder`` takes the same checkpoints as the JAX
    package's (plain ImageNet keys; ``module.encoder.``-prefixed PVB keys),
    loads what the JAX one converts, and fails on the same mismatches."""
    m, p = _pvbnet_params(15)
    enc_sd = {k[len("encoder."):]: v for k, v in prvnet_state_dict_from_flax(p).items() if k.startswith("encoder.")}
    jparams = jax.tree.map(np.zeros_like, p)
    for ckpt, imagenet in (({"model": enc_sd}, True),
                           ({"module.encoder." + k: v for k, v in enc_sd.items()}, False)):
        want = jinfer.load_pretrained_encoder(jparams, ckpt, imagenet=imagenet)["encoder"]
        t = tinfer.load_pretrained_encoder(tmodel.make_pvbnet("convnextv2_atto"), ckpt, imagenet=imagenet)
        _assert_same_tree(prvnet_state_dict_to_flax(t.encoder.state_dict()), want)
    bad = dict(enc_sd)
    bad.pop("head.bias")
    # a block atto does not have; a wrong shape
    for broken in (bad, {**enc_sd, "stages.3.9.dwconv.bias": torch.zeros(320)},
                   {**enc_sd, "head.bias": torch.zeros(3)}):
        with pytest.raises(ValueError) as jerr:
            jinfer.load_pretrained_encoder(jparams, {"model": broken}, imagenet=True)
        with pytest.raises(ValueError) as terr:
            tinfer.load_pretrained_encoder(tmodel.make_pvbnet("convnextv2_atto"), {"model": broken}, imagenet=True)
        assert str(terr.value).split()[:2] == str(jerr.value).split()[:2]
    # stricter than the JAX package's converter, which drops a key it cannot
    # map: every key of the checkpoint must load
    with pytest.raises(ValueError, match="unexpected"):
        tinfer.load_pretrained_encoder(tmodel.make_pvbnet("convnextv2_atto"),
                                       {"model": {**enc_sd, "extra.weight": torch.zeros(1)}}, imagenet=True)
    # a PVBPretrain's encoder carried into a PVBNet
    pre = tmodel.make_pvbpretrain("convnextv2_atto")
    net = tinfer.load_flax_encoder(tmodel.make_pvbnet("convnextv2_atto"), pre)
    for k, v in pre.encoder.state_dict().items():
        assert torch.equal(net.encoder.state_dict()[k], v)
