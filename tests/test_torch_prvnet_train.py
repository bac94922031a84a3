"""The port's PRVNet trainer against the JAX package's, on the CPU.

ConvNeXt-V2 atto at 32 px with K = 2 views: Flax's msgpack both ways
(bytes equal), checkpoints across the two packages, the decayed leaves,
the schedule at every count, the micro-batch orders, one micro-batch's loss
and every gradient (``|0|`` included), the accumulated gradient against
``MultiStepsState.acc_grads``, parameters after three applications against
``make_train_step``, ``check_accuracy``, the resident trainer against the
streaming one, ``train_regression`` / ``pretrain`` / the CLI end to end on
a written dataset, and ``BudgetPredictor`` on a JAX-written checkpoint.
Each broken variant (a sum for the mean, decay on biases, ``torch.abs``'s
gradient at 0) is run through its check, which must fail."""

import json
import os

import flax.serialization as fser
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from nerf_prv_tpu.parallel.mesh import make_mesh as jmake_mesh
from nerf_prv_tpu.prvnet import cli as jcli
from nerf_prv_tpu.prvnet import data as jdata
from nerf_prv_tpu.prvnet import infer as jinfer
from nerf_prv_tpu.prvnet import model as jmodel
from nerf_prv_tpu.prvnet import resnet as jresnet
from nerf_prv_tpu.prvnet import train as jtrain
from nerf_prv_tpu_torch.convert import prvnet_state_dict_from_flax, prvnet_state_dict_to_flax
from nerf_prv_tpu_torch.parallel.mesh import make_mesh, pad_to_multiple
from nerf_prv_tpu_torch.prvnet import _msgpack
from nerf_prv_tpu_torch.prvnet import cli as tcli
from nerf_prv_tpu_torch.prvnet import data as tdata
from nerf_prv_tpu_torch.prvnet import infer as tinfer
from nerf_prv_tpu_torch.prvnet import model as tmodel
from nerf_prv_tpu_torch.prvnet import train as ttrain

torch.set_num_threads(1)

ARCH = "convnextv2_atto"
SIZE = 32
K = 2
CPU = make_mesh(devices=["cpu"])
# float32 loss and gradients against JAX's on the CPU (atto, 32 px, K = 2,
# 4 samples): measured 1.0e-6 / 8.0e-7 relative on the L1 / MSE loss and
# 3.2e-6 / 4.2e-6 of each leaf's largest gradient (XLA and ATen sum the
# convolutions in other orders); 10x that
LOSS_RTOL = 1e-5
GRAD_RTOL = 5e-5
# parameters after three applications, in units of the peak lr: Adam
# divides each gradient by its own root mean square, so an element whose
# gradient is float noise may move either way (up to 2 lr an application
# apart) while the rest agree closely.  Measured without accumulation:
# median 2.9e-5, 99.9% within 2.2e-3, 5.8e-5 of the 6.36 M elements beyond
# 0.01, worst 1.88; accum 2 with the schedule: median 9.5e-6, 1.6e-7
# beyond 0.01, worst 0.011
PARAM_MEDIAN_LR = 1e-3
PARAM_FAR_LR = 0.01
PARAM_FAR_SHARE = 1e-3
# the continuous budget (test_torch_prvnet.py's BUDGET_ATOL)
BUDGET_ATOL = 1e-3


def _random_tree(module, x, seed):
    """Seeded random Flax params for ``module`` at input ``x``, as numpy
    (shapes from ``jax.eval_shape``); GRN and the heads off their zero init."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]

    def leaf(path, sd):
        name = jax.tree_util.keystr(path[-1:])
        noise = rng.standard_normal(sd.shape).astype(np.float32)
        if name == "['kernel']":
            return noise / np.sqrt(np.prod(sd.shape[:-1]))
        if name in ("['scale']", "['var']"):
            return 1 + 0.1 * np.abs(noise)
        return 0.05 * noise

    return jax.tree_util.tree_map_with_path(lambda p, sd: leaf(p, sd).astype(np.float32), shapes)


def _pvbnet_tree(seed, k=K):
    m = jmodel.make_pvbnet(ARCH)
    return m, _random_tree(m, np.zeros((1, k, SIZE, SIZE, 3), np.float32), seed)


def _pretrain_tree(seed):
    m = jmodel.make_pvbpretrain(ARCH)
    return m, _random_tree(m, np.zeros((1, SIZE, SIZE, 3), np.float32), seed)


def _port_model(tree, pretrain=False):
    model = (tmodel.make_pvbpretrain if pretrain else tmodel.make_pvbnet)(ARCH)
    model.load_state_dict(prvnet_state_dict_from_flax(tree))
    return model


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_same_tree(got, want):
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w), set(g) ^ set(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _flax_grads(model, grads):
    """The port's gradients (in ``model.parameters()`` order) as a Flax tree."""
    return prvnet_state_dict_to_flax({n: g for (n, _), g in zip(model.named_parameters(), grads)})


def _assert_close_per_leaf(got, want, rtol, what):
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w)
    for k in w:
        scale = max(float(np.abs(w[k]).max()), 1e-30)
        err = float(np.abs(g[k] - w[k]).max()) / scale
        assert err <= rtol, f"{what} {k}: {err:.3e} of its largest > {rtol}"


def _batch(seed, n, k=K):
    r = np.random.default_rng(seed)
    views = r.uniform(0, 1, (n, k, SIZE, SIZE, 3)).astype(np.float32)
    return views, r.uniform(13, 58, (n,)).astype(np.float32)


def _write_dataset(root, names, budgets, n_imgs=5, size=40):
    """Per-object RGB PNGs (brightness follows the budget) and
    ``view_budget.txt``, as the JAX package's tests write them."""
    rng = np.random.default_rng(0)
    for name, b in zip(names, budgets):
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        for j in range(n_imgs):
            img = np.full((size, size, 3), int(b * 4), np.uint8) + rng.integers(0, 20, (size, size, 3), dtype=np.uint8)
            Image.fromarray(img, "RGB").save(os.path.join(d, f"rgbaClip_{j}.png"))
        with open(os.path.join(d, "view_budget.txt"), "w") as f:
            f.write(str(b))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pvb"))
    names = [f"obj{i}" for i in range(10)]
    _write_dataset(root, names, [15, 20, 25, 30, 35, 40, 45, 50, 22, 33])
    with open(os.path.join(root, "train_split.txt"), "w") as f:
        f.write("\n".join(names[:8]) + "\n")
    with open(os.path.join(root, "val_split.txt"), "w") as f:
        f.write("\n".join(names[8:]) + "\n")
    with open(os.path.join(root, "four.txt"), "w") as f:
        f.write("\n".join(names[:4]) + "\n")
    return root


def _cfg(**kw):
    base = dict(arch=ARCH, batch_size=4, epochs=2, image_size=SIZE)
    base.update(kw)
    return base


# --- msgpack -----------------------------------------------------------------

def _mixed_tree():
    rng = np.random.default_rng(3)
    return {
        "params": {
            "encoder": {"kernel": rng.standard_normal((3, 4, 2, 5)).astype(np.float32),
                        "grn": {"gamma": rng.standard_normal((1, 1, 1, 7)).astype(np.float32)}},
            "f64": rng.standard_normal(9), "i32": np.arange(-5, 5, dtype=np.int32), "i64": np.arange(40),
            "u8": rng.integers(0, 256, 300).astype(np.uint8), "flags": np.array([True, False]),
            "zero_d": np.array(2.5, np.float32), "empty": np.zeros((0, 3), np.float32),
            "npscalar": np.float32(1.25), "npint": np.int64(-7),
        },
        "meta": {"val": {"accuracy": 0.25, "l1_mean": 3.5, "l1_std": 1e-9}, "epoch": 3, "neg": -40,
                 "big": 2**40, "negbig": -2**33, "flag": True, "nothing": None, "name": "x" * 40,
                 "list": [1, 2.0, "a", [True]], "blob": b"\x01" * 300, "wide": {str(i): i for i in range(20)}},
    }


def _assert_same_restored(got, want, path="."):
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_same_restored(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same_restored(a, b, f"{path}/{i}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, (path, got, want)


def test_msgpack_port_writer_reads_back_in_flax():
    """The port's bytes are msgpack_serialize's bytes, and msgpack_restore
    reads them back: every dtype the trees use, numpy scalars, the meta
    dict's Python values, 16-bit map and array headers."""
    tree = _mixed_tree()
    blob = _msgpack.serialize(tree)
    assert blob == fser.msgpack_serialize(tree)
    _assert_same_restored(fser.msgpack_restore(blob), fser.msgpack_restore(fser.msgpack_serialize(tree)))


def test_msgpack_flax_bytes_read_by_the_port():
    blob = fser.msgpack_serialize(_mixed_tree())
    _assert_same_restored(_msgpack.restore(blob), fser.msgpack_restore(blob))


@pytest.mark.parametrize("writer", ["port", "flax"])
def test_msgpack_chunked_leaf(writer, monkeypatch):
    """A leaf over MAX_CHUNK_SIZE (set small in both) is written as Flax's
    chunk dict and read back whole by the other side."""
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(_msgpack, "MAX_CHUNK_SIZE", 64)
    tree = {"params": {"big": np.arange(100, dtype=np.float32).reshape(4, 25), "small": np.ones(3, np.float32)},
            "meta": {}}
    blob = _msgpack.serialize(tree) if writer == "port" else fser.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob and blob == fser.msgpack_serialize(tree)
    read = fser.msgpack_restore(blob) if writer == "port" else _msgpack.restore(blob)
    _assert_same_restored(read, {"meta": {}, "params": {"big": tree["params"]["big"], "small": tree["params"]["small"]}})


@pytest.mark.parametrize("case", ["complex", "float32", "ext7", "bfloat16", "tuple", "trailing"])
def test_msgpack_rejects_what_it_does_not_cover(case):
    """Anything outside the covered subset raises and names the type."""
    if case == "tuple":
        with pytest.raises(TypeError, match="tuple"):
            _msgpack.serialize({"a": (1, 2)})
        return
    blob, name = {
        "complex": (fser.msgpack_serialize({"c": 1 + 2j}), "native_complex"),
        "float32": (msgpack.packb({"f": 1.5}, use_single_float=True), "float32"),
        "ext7": (msgpack.packb(msgpack.ExtType(7, b"abc")), "ext type 7"),
        "bfloat16": (fser.msgpack_serialize({"b": np.ones(3, jnp.bfloat16)}), "bfloat16"),
        "trailing": (msgpack.packb(1) + b"\x01", "after the first value"),
    }[case]
    with pytest.raises(ValueError, match=name):
        _msgpack.restore(blob)


# --- checkpoints across the packages -------------------------------------------

@pytest.mark.parametrize("kind", ["pvbnet", "pvbpretrain"])
def test_checkpoints_cross_both_packages(kind, tmp_path):
    """The JAX package's save_checkpoint read by the port's load_checkpoint
    leaf for leaf; the port's save_checkpoint of the same weights writes the
    same bytes, and the JAX package's load_checkpoint reads it back."""
    _, tree = (_pvbnet_tree if kind == "pvbnet" else _pretrain_tree)(21)
    meta = {"val": {"accuracy": 0.5, "l1_mean": 4.25, "l1_std": 1.5}, "epoch": 7}
    jpath, tpath = str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack")
    jtrain.save_checkpoint(jpath, tree, meta)
    params, got_meta = ttrain.load_checkpoint(jpath)
    _assert_same_tree(params, tree)
    assert got_meta == meta
    ttrain.save_checkpoint(tpath, _port_model(tree, pretrain=kind == "pvbpretrain"), meta)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    back, back_meta = jtrain.load_checkpoint(tpath)
    _assert_same_tree(back, tree)
    assert back_meta == meta


# --- the optimizer ---------------------------------------------------------------

def _decayed_leaves(model, mask):
    """The Flax paths of the port's decayed tensors, through the convert table."""
    sd = model.state_dict()
    return set(_leaves(prvnet_state_dict_to_flax({n: sd[n] for n, d in mask.items() if d})))


def _check_decay_set(model, jtree):
    opt, _ = ttrain.make_optimizer(ttrain.TrainConfig(arch=ARCH), model)
    decay_group, plain_group = opt.param_groups
    assert decay_group["weight_decay"] == 0.05 and plain_group["weight_decay"] == 0.0
    ids = {id(p) for p in decay_group["params"]}
    mask = {n: id(p) in ids for n, p in model.named_parameters()}
    want = {k for k, v in _leaves(jtrain._wd_mask(jtree)).items() if v}
    assert _decayed_leaves(model, mask) == want


@pytest.mark.parametrize("broken", [False, True])
@pytest.mark.parametrize("kind", ["pvbnet", "pvbpretrain", "resnet50"])
def test_decayed_leaves_are_the_jax_mask(kind, broken, monkeypatch):
    """AdamW's decayed group is exactly the leaves JAX's _wd_mask decays
    (kernels and GRN's gamma and beta; no bias, norm or FrozenBN leaf); a
    mask that decays biases too fails the check."""
    if kind == "resnet50":
        jm = jmodel.PVBNet(encoder=jresnet.resnet50())
        tree = _random_tree(jm, np.zeros((1, K, SIZE, SIZE, 3), np.float32), 22)
        model = tmodel.make_pvbnet("resnet50")
    else:
        _, tree = (_pvbnet_tree if kind == "pvbnet" else _pretrain_tree)(22)
        model = _port_model(tree, pretrain=kind == "pvbpretrain")
    if broken:
        monkeypatch.setattr(ttrain, "_wd_mask", lambda m: {n: True for n, _ in m.named_parameters()})
        with pytest.raises(AssertionError):
            _check_decay_set(model, tree)
    else:
        _check_decay_set(model, tree)


@pytest.mark.parametrize("epochs,warmup_epochs,steps,min_lr", [(10, 2, 3, 0.0), (5, 40, 4, 1e-6), (1, 1, 1, 0.0)])
def test_schedule_is_optax_at_every_count(epochs, warmup_epochs, steps, min_lr):
    """make_optimizer's schedule against optax.warmup_cosine_decay_schedule
    with the JAX make_optimizer's arguments, at every count and past the
    end (float64 here, float32 there: 1e-6 relative)."""
    cfg = ttrain.TrainConfig(arch=ARCH, batch_size=8, epochs=epochs, warmup_epochs=warmup_epochs,
                             min_lr=min_lr, use_schedule=True)
    _, schedule = ttrain.make_optimizer(cfg, tmodel.make_pvbnet(ARCH), steps)
    total = max(epochs * steps, 2)
    want = optax.warmup_cosine_decay_schedule(0.0, cfg.lr, max(min(warmup_epochs * steps, total - 1), 1), total, min_lr)
    for count in range(total + 3):
        np.testing.assert_allclose(schedule(count), float(want(count)), rtol=1e-6, atol=1e-7 * cfg.lr)
    assert schedule(0) == 0.0
    assert ttrain.make_optimizer(ttrain.TrainConfig(arch=ARCH), tmodel.make_pvbnet(ARCH), steps)[1] is None


# --- data order ------------------------------------------------------------------

@pytest.mark.parametrize("accum", [1, 2, 3])
def test_micro_batches_and_resident_indices_match_jax(dataset, accum):
    """The same rng gives the same micro-batches in both packages, and the
    resident index array the same samples in the same order."""
    kw = _cfg(batch_size=2 * accum if accum > 1 else 3, accum_steps=accum)
    cfg_j, cfg_t = jtrain.TrainConfig(**kw), ttrain.TrainConfig(**kw)
    split = os.path.join(dataset, "train_split.txt")
    jds = jdata.PVBDataset(dataset, split, [0, 1], crop=SIZE)
    tds = tdata.PVBDataset(dataset, split, [0, 1], crop=SIZE)
    for seed in (0, 1):
        want = list(jtrain._train_micro_batches(jds, cfg_j, np.random.default_rng(seed)))
        got = list(ttrain._train_micro_batches(tds, cfg_t, np.random.default_rng(seed)))
        assert len(got) == len(want) > 0
        for (gv, gl), (wv, wl) in zip(got, want):
            np.testing.assert_array_equal(gv, wv)
            np.testing.assert_array_equal(gl, wl)
        idx = ttrain._resident_epoch_indices(len(tds), cfg_t, np.random.default_rng(seed))
        np.testing.assert_array_equal(idx, jtrain._resident_epoch_indices(len(jds), cfg_j, np.random.default_rng(seed)))
        labels = np.asarray([tds[i][1] for i in range(len(tds))], np.float32)
        flat = idx.reshape(-1, cfg_t.micro_batch)
        full = [b for b in got if len(b[1]) == cfg_t.micro_batch]
        assert len(flat) == len(full)
        for row, (_, gl) in zip(flat, full):
            np.testing.assert_array_equal(labels[row], gl)


# --- loss, gradients, accumulation, applications ----------------------------------

def _jax_value_and_grad(jm, cfg):
    return jax.jit(jax.value_and_grad(lambda p, v, y: jtrain.loss_fn(jm, p, v, y, cfg)))


def _port_loss_and_grads(model, views, labels, cfg):
    loss = ttrain.loss_fn(model, torch.from_numpy(views), torch.from_numpy(labels), cfg)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(loss.detach()), grads


@pytest.mark.parametrize("loss_type", ["L1", "MSE"])
def test_loss_and_every_gradient_match_jax(loss_type):
    jm, tree = _pvbnet_tree(31)
    views, labels = _batch(32, 4)
    cfg_j = jtrain.TrainConfig(**_cfg(loss_type=loss_type))
    want_loss, want_grads = _jax_value_and_grad(jm, cfg_j)(tree, jnp.asarray(views), jnp.asarray(labels))
    model = _port_model(tree)
    loss, grads = _port_loss_and_grads(model, views, labels, ttrain.TrainConfig(**_cfg(loss_type=loss_type)))
    assert abs(loss - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    _assert_close_per_leaf(_flax_grads(model, grads), want_grads, GRAD_RTOL, "gradient")


@pytest.mark.parametrize("broken", [False, True])
def test_l1_gradient_at_zero_is_jax_s(broken, monkeypatch):
    """A sample whose float32 label equals the prediction exactly: JAX's
    |x| has gradient 1 at 0, so both packages' gradients are the
    prediction's own; ``torch.abs`` (gradient 0 there) fails the check."""
    jm, tree = _pvbnet_tree(33)
    views, _ = _batch(34, 1)
    model = _port_model(tree)
    with torch.no_grad():
        label_t = tmodel.logits_to_budget(model(torch.from_numpy(views))).numpy()
    label_j = np.asarray(jax.jit(lambda p, v: jmodel.logits_to_budget(jm.apply({"params": p}, v)))(tree, views))
    cfg_j, cfg_t = jtrain.TrainConfig(**_cfg()), ttrain.TrainConfig(**_cfg())
    want_loss, want_grads = _jax_value_and_grad(jm, cfg_j)(tree, jnp.asarray(views), jnp.asarray(label_j))
    assert float(want_loss) == 0.0
    if broken:
        monkeypatch.setattr(ttrain, "_abs", torch.abs)
    loss, grads = _port_loss_and_grads(model, views, label_t, cfg_t)
    assert loss == 0.0
    pred = tmodel.logits_to_budget(model(torch.from_numpy(views))).mean()
    own = torch.autograd.grad(pred, list(model.parameters()))

    def check():
        _assert_close_per_leaf(_flax_grads(model, grads), want_grads, GRAD_RTOL, "gradient at |0|")
        _assert_close_per_leaf(_flax_grads(model, grads), _flax_grads(model, own), GRAD_RTOL, "gradient at |0|")

    if broken:
        with pytest.raises(AssertionError):
            check()
    else:
        check()


@pytest.mark.parametrize("broken", [False, True])
def test_accumulated_gradient_is_multisteps_mean(broken, monkeypatch):
    """After two micro-steps of an every-3 accumulation, the port's running
    gradient equals optax MultiStepsState.acc_grads on the same batches (a
    sum in its place fails)."""
    jm, tree = _pvbnet_tree(35)
    batches = [_batch(36 + i, 2) for i in range(2)]
    cfg_j = jtrain.TrainConfig(**_cfg(batch_size=6, accum_steps=3))
    opt = optax.MultiSteps(jtrain.make_optimizer(cfg_j, tree), every_k_schedule=3)
    state = opt.init(tree)
    vg = _jax_value_and_grad(jm, cfg_j)
    update = jax.jit(opt.update)
    for v, y in batches:
        _, g = vg(tree, jnp.asarray(v), jnp.asarray(y))
        _, state = update(g, state, tree)
    if broken:
        monkeypatch.setattr(ttrain, "_accumulate", lambda acc, grads, n: torch._foreach_add(acc, list(grads)))
    model = _port_model(tree)
    step = ttrain.make_train_step(model, ttrain.TrainConfig(**_cfg(batch_size=6, accum_steps=3)), mesh=CPU)
    for v, y in batches:
        step(v, y)
    assert step.mini == 2 and step.count == 0

    def check():
        _assert_close_per_leaf(_flax_grads(model, step.acc), state.acc_grads, GRAD_RTOL, "accumulated gradient")

    if broken:
        with pytest.raises(AssertionError):
            check()
    else:
        check()


@pytest.mark.parametrize("accum,schedule", [(1, False), (2, True)])
def test_parameters_after_three_applications_match_jax(accum, schedule):
    """Three applications (3 x accum micro-steps) from the same converted
    weights on the same batches through JAX's make_train_step and the
    port's (with the schedule, the first at lr 0): the gaps' median within
    PARAM_MEDIAN_LR lr, at most PARAM_FAR_SHARE of the elements beyond
    PARAM_FAR_LR lr, none beyond Adam's 2 lr an application; the lr high
    enough that the parameters move far beyond float noise."""
    jm, tree = _pvbnet_tree(41)
    kw = _cfg(batch_size=2 * accum, accum_steps=accum, blr=0.05, use_schedule=schedule, epochs=3, warmup_epochs=1)
    cfg_j = jtrain.TrainConfig(**kw)
    opt = jtrain.make_optimizer(cfg_j, tree, steps_per_epoch=1)
    if accum > 1:
        opt = optax.MultiSteps(opt, every_k_schedule=accum)
    step_j = jtrain.make_train_step(jm, cfg_j, opt, jmake_mesh(devices=jax.devices()[:1]))
    params, state = jax.tree.map(jnp.asarray, tree), opt.init(tree)
    batches = [_batch(50 + i, 2) for i in range(3 * accum)]
    for v, y in batches:
        params, state, _ = step_j(params, state, jnp.asarray(v), jnp.asarray(y))
    model = _port_model(tree)
    step = ttrain.make_train_step(model, ttrain.TrainConfig(**kw), steps_per_epoch=1, mesh=CPU)
    for v, y in batches:
        step(v, y)
    assert step.count == 3
    got = _leaves(prvnet_state_dict_to_flax(model.state_dict()))
    want, start = _leaves(params), _leaves(tree)
    lr = cfg_j.lr
    moved = np.median(np.concatenate([np.abs(want[k] - start[k]).ravel() for k in want])) / lr
    gaps = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want]) / lr
    far = float((gaps > PARAM_FAR_LR).mean())
    assert moved > 0.5, moved
    assert np.median(gaps) <= PARAM_MEDIAN_LR and far <= PARAM_FAR_SHARE and gaps.max() <= 6, (
        float(np.median(gaps)), far, float(gaps.max()))


def test_check_accuracy_matches_jax(dataset):
    jm, tree = _pvbnet_tree(43)
    cfg_j, cfg_t = jtrain.TrainConfig(**_cfg(batch_size=3)), ttrain.TrainConfig(**_cfg(batch_size=3))
    split = os.path.join(dataset, "train_split.txt")
    mesh_j = jmake_mesh(devices=jax.devices()[:1])
    want = jtrain.check_accuracy(jtrain.make_eval_step(jm, cfg_j, mesh_j), tree,
                                 jdata.PVBDataset(dataset, split, [0, 1], crop=SIZE), cfg_j, mesh_j)
    got = ttrain.check_accuracy(ttrain.make_eval_step(_port_model(tree), cfg_t, CPU),
                                tdata.PVBDataset(dataset, split, [0, 1], crop=SIZE), cfg_t)
    assert got["accuracy"] == want["accuracy"]
    for k in ("l1_mean", "l1_std"):
        assert abs(got[k] - want[k]) <= BUDGET_ATOL, (k, got[k], want[k])


# --- the trainers end to end ---------------------------------------------------------

def _log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_resident_and_streaming_trainers_agree(dataset, tmp_path):
    """Two epochs of accumulated training from the same weights and rng:
    the resident path (uint8 on the device, gathered and divided there) and
    the streaming path compute the same float32 operations on the same
    samples, so the parameters and the logs are equal."""
    runs = {}
    for resident in (True, False):
        cfg = ttrain.TrainConfig(**_cfg(batch_size=4, accum_steps=2, device_data=resident))
        model, best = ttrain.train_regression(dataset, os.path.join(dataset, "train_split.txt"),
                                              os.path.join(dataset, "val_split.txt"), cfg=cfg, pattern=[0, 1],
                                              checkpoint_dir=str(tmp_path / str(resident)), mesh=CPU)
        runs[resident] = (model.state_dict(), _log(str(tmp_path / str(resident) / "log.jsonl")))
    (res, res_log), (stream, stream_log) = runs[True], runs[False]
    for k in res:
        torch.testing.assert_close(res[k], stream[k], rtol=0, atol=0)
    for a, b in zip(res_log, stream_log):
        assert a.keys() == b.keys() and abs(a["train_loss"] - b["train_loss"]) <= 1e-6 * b["train_loss"]
        assert {k: a[k] for k in a if k != "train_loss"} == {k: b[k] for k in b if k != "train_loss"}


def test_pretrain_then_train_regression_end_to_end(dataset, tmp_path):
    """pretrain writes pretrain_log.jsonl and best_pretrain_checkpoint.msgpack;
    its encoder seeds train_regression through premodel_file (zero epochs
    leave it as loaded); two epochs write log.jsonl with the JAX field names
    and best_checkpoint.msgpack, which the JAX package loads; a second call
    resumes from it."""
    mesh = CPU
    cfg = dict(_cfg(batch_size=8, accum_steps=2, epochs=2))
    pre_dir = str(tmp_path / "pre")
    pre_model, pre_best = ttrain.pretrain(dataset, os.path.join(dataset, "four.txt"), None,
                                          cfg=ttrain.TrainConfig(**cfg), checkpoint_dir=pre_dir, mesh=mesh,
                                          viewspace_size=5)
    pre_path = os.path.join(pre_dir, "best_pretrain_checkpoint.msgpack")
    lines = _log(os.path.join(pre_dir, "pretrain_log.jsonl"))
    assert [l["epoch"] for l in lines] == [0, 1]
    assert all(set(l) == {"epoch", "train_loss", "accuracy", "l1_mean", "l1_std"} for l in lines)
    assert all(np.isfinite(l["train_loss"]) for l in lines)
    assert np.isfinite(pre_best["l1_mean"]) and os.path.exists(pre_path)
    pre_tree, pre_meta = jtrain.load_checkpoint(pre_path)
    assert pre_meta["val"] == pre_best

    split, val = os.path.join(dataset, "train_split.txt"), os.path.join(dataset, "val_split.txt")
    ckpt = str(tmp_path / "reg")
    seeded, best0 = ttrain.train_regression(dataset, split, val, cfg=ttrain.TrainConfig(**dict(cfg, epochs=0)),
                                            pattern=[0, 1], checkpoint_dir=ckpt, mesh=mesh, premodel_file=pre_path)
    assert best0["l1_mean"] == float("inf") and not os.path.exists(os.path.join(ckpt, "best_checkpoint.msgpack"))
    want_enc = prvnet_state_dict_from_flax(pre_tree["encoder"])
    for k, v in seeded.encoder.state_dict().items():
        torch.testing.assert_close(v, want_enc[k], rtol=0, atol=0)

    model, best = ttrain.train_regression(dataset, split, val, cfg=ttrain.TrainConfig(**cfg), pattern=[0, 1],
                                          checkpoint_dir=ckpt, mesh=mesh, premodel_file=pre_path)
    lines = _log(os.path.join(ckpt, "log.jsonl"))
    assert [l["epoch"] for l in lines] == [0, 1]
    assert all(set(l) == {"epoch", "train_loss", "accuracy", "l1_mean", "l1_std"} for l in lines)
    best_path = os.path.join(ckpt, "best_checkpoint.msgpack")
    tree, meta = jtrain.load_checkpoint(best_path)
    assert meta["val"] == best and meta["epoch"] in (0, 1)
    resumed, best_again = ttrain.train_regression(dataset, split, val, cfg=ttrain.TrainConfig(**dict(cfg, epochs=0)),
                                                  pattern=[0, 1], checkpoint_dir=ckpt, mesh=mesh)
    assert best_again == best
    want = prvnet_state_dict_from_flax(tree)
    for k, v in resumed.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)


def test_jax_checkpoints_resume_and_seed_the_port(dataset, tmp_path):
    """A best_checkpoint.msgpack written by the JAX package is resumed by the
    port's train_regression (its val metrics taken as the best so far), and
    a JAX pretrain checkpoint seeds the port's encoder through premodel_file."""
    _, tree = _pvbnet_tree(45)
    _, pre_tree = _pretrain_tree(46)
    meta = {"val": {"accuracy": 0.0, "l1_mean": 1.0, "l1_std": 0.5}, "epoch": 4}
    jtrain.save_checkpoint(str(tmp_path / "resume" / "best_checkpoint.msgpack"), tree, meta)
    pre_path = str(tmp_path / "best_pretrain_checkpoint.msgpack")
    jtrain.save_checkpoint(pre_path, pre_tree)
    split, val = os.path.join(dataset, "train_split.txt"), os.path.join(dataset, "val_split.txt")
    cfg = ttrain.TrainConfig(**_cfg(epochs=0))
    model, best = ttrain.train_regression(dataset, split, val, cfg=cfg, pattern=[0, 1],
                                          checkpoint_dir=str(tmp_path / "resume"), mesh=CPU, premodel_file=pre_path)
    assert best == meta["val"]
    want = prvnet_state_dict_from_flax(tree)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    seeded, _ = ttrain.train_regression(dataset, split, val, cfg=cfg, pattern=[0, 1],
                                        checkpoint_dir=str(tmp_path / "fresh"), mesh=CPU, premodel_file=pre_path)
    want_enc = prvnet_state_dict_from_flax(pre_tree["encoder"])
    for k, v in seeded.encoder.state_dict().items():
        torch.testing.assert_close(v, want_enc[k], rtol=0, atol=0)


def test_prvnet_cli_trains_on_the_cpu(dataset, tmp_path):
    """The trainer CLI (the JAX CLI's arguments plus --device) drives both
    the regression and the pretrain path."""
    base = ["--data_path", dataset, "--model", ARCH, "--batch_size", "2", "--epochs", "1",
            "--input_size", str(SIZE), "--device", "cpu"]
    assert tcli.main(base + ["--pattern_idx", "1", "--output_dir", str(tmp_path / "out")]) == 0
    assert os.path.exists(tmp_path / "out" / "best_checkpoint.msgpack")
    assert tcli.main(base + ["--pre_train", "--viewspace_size", "2", "--train_split",
                             os.path.join(dataset, "four.txt"), "--output_dir", str(tmp_path / "out2")]) == 0
    assert os.path.exists(tmp_path / "out2" / "best_pretrain_checkpoint.msgpack")
    assert len(_log(str(tmp_path / "out2" / "pretrain_log.jsonl"))) == 1
    want = vars(jcli.parse_args(["--data_path", "x"]))
    got = vars(tcli.parse_args(["--data_path", "x"]))
    assert got == dict(want, device=None)  # every card, as the JAX CLI trains over every device


TWO = make_mesh(devices=["cpu", "cpu"])
# two devices against one: the same float32 operations, the loss summed as
# two halves' means and the gradients as two halves' sums.  Measured at the
# default lr: epoch losses and val metrics equal to the logged digits,
# parameters a median 0 lr apart, 2.3e-7 of them beyond 0.01 lr, worst
# 0.013 lr; the val l1 of batches split 2 + 2 against batches of 3, 7.3e-8
# relative
TWO_RTOL = 1e-6


def _assert_params_within_lr(got: dict, want: dict, lr: float):
    """The lr-unit rule of test_parameters_after_three_applications_match_jax."""
    gaps = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want]) / lr
    far = float((gaps > PARAM_FAR_LR).mean())
    assert np.median(gaps) <= PARAM_MEDIAN_LR and far <= PARAM_FAR_SHARE and gaps.max() <= 6, (
        float(np.median(gaps)), far, float(gaps.max()))


@pytest.mark.parametrize("entry", ["train_regression", "pretrain"])
def test_trainer_on_two_devices_matches_one(dataset, entry, tmp_path):
    """Two epochs on a mesh of the CPU listed twice (the micro-batch split
    2 + 2, the replica's gradients summed into the master's, the replica
    refreshed after each application) against a mesh of one: each epoch's
    loss and val metrics within TWO_RTOL, the parameters within the lr-unit
    rule of the JAX comparison."""
    cfg = ttrain.TrainConfig(**_cfg(batch_size=8, accum_steps=2))
    split, val = os.path.join(dataset, "train_split.txt"), os.path.join(dataset, "val_split.txt")
    runs = {}
    for name, mesh in (("one", CPU), ("two", TWO)):
        out = str(tmp_path / name)
        if entry == "pretrain":
            model, _ = ttrain.pretrain(dataset, os.path.join(dataset, "four.txt"), val, cfg=cfg, checkpoint_dir=out,
                                       mesh=mesh, viewspace_size=5)
            log = _log(os.path.join(out, "pretrain_log.jsonl"))
        else:
            model, _ = ttrain.train_regression(dataset, split, val, cfg=cfg, pattern=[0, 1], checkpoint_dir=out,
                                               mesh=mesh)
            log = _log(os.path.join(out, "log.jsonl"))
        runs[name] = ({k: v.detach().numpy() for k, v in model.state_dict().items()}, log)
    (one, log1), (two, log2) = runs["one"], runs["two"]
    assert len(log1) == len(log2) == 2
    for a, b in zip(log2, log1):
        assert a["accuracy"] == b["accuracy"]
        for k in ("train_loss", "l1_mean", "l1_std"):
            assert abs(a[k] - b[k]) <= TWO_RTOL * abs(b[k]), (k, a[k], b[k])
    assert log1[0]["train_loss"] != log1[1]["train_loss"]
    _assert_params_within_lr(two, one, cfg.lr)


def _capture_grads():
    """An optax transformation whose state is the last gradient it saw (and
    whose updates are zero), to read make_train_step's gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g),
    )


def test_two_device_micro_step_matches_jax():
    """One micro-step's loss and gradients on two devices (the port: the
    CPU listed twice; JAX: make_train_step on jax.devices()[:2], the batch
    sharded over dp and the gradients all-reduced) within LOSS_RTOL and
    GRAD_RTOL of each leaf's largest."""
    jm, tree = _pvbnet_tree(61)
    views, labels = _batch(62, 4)
    cfg_j = jtrain.TrainConfig(**_cfg())
    step_j = jtrain.make_train_step(jm, cfg_j, _capture_grads(), jmake_mesh(devices=jax.devices()[:2]))
    params = jax.tree.map(jnp.asarray, tree)
    _, want_grads, want_loss = step_j(params, _capture_grads().init(params), jnp.asarray(views), jnp.asarray(labels))
    model = _port_model(tree)
    step = ttrain.make_train_step(model, ttrain.TrainConfig(**_cfg()), mesh=TWO)
    loss, grads = step.loss_and_grads(step.replicas.shard(views, labels))
    assert [tuple(v.shape) for v, _ in step.replicas.shard(views, labels)] == [(2, K, SIZE, SIZE, 3)] * 2
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    _assert_close_per_leaf(_flax_grads(model, grads), want_grads, GRAD_RTOL, "two-device gradient")


def test_eval_pads_to_the_mesh_and_cuts_back(dataset):
    """Batches of 3 over two devices: padded to 4 (the last sample, or index
    0 on the resident path, repeated) and cut back; the predictions and the
    metrics equal a mesh of one's, on both paths.  An unpadded odd batch
    raises, as the JAX jit does."""
    _, tree = _pvbnet_tree(63)
    cfg = ttrain.TrainConfig(**_cfg(batch_size=3))
    ds = tdata.PVBDataset(dataset, os.path.join(dataset, "train_split.txt"), [0, 1], crop=SIZE)
    one, two = ttrain.make_eval_step(_port_model(tree), cfg, CPU), ttrain.make_eval_step(_port_model(tree), cfg, TWO)
    want = ttrain.check_accuracy(one, ds, cfg)
    got = ttrain.check_accuracy(two, ds, cfg)
    assert got["accuracy"] == want["accuracy"]
    for k in ("l1_mean", "l1_std"):
        assert abs(got[k] - want[k]) <= TWO_RTOL * max(abs(want[k]), 1e-6), (k, got[k], want[k])
    imgs, labels = tdata.resident_arrays(ds)
    res = {d: torch.from_numpy(imgs) for d in two.replicas.models}
    got = ttrain._resident_metrics(two, res, labels, 3)
    want = ttrain._resident_metrics(one, {torch.device("cpu"): torch.from_numpy(imgs)}, labels, 3)
    assert got["accuracy"] == want["accuracy"]
    for k in ("l1_mean", "l1_std"):
        assert abs(got[k] - want[k]) <= TWO_RTOL * max(abs(want[k]), 1e-6), (k, got[k], want[k])
    views = np.stack([ds[i][0] for i in range(3)])
    padded, n = pad_to_multiple(views, 2)
    np.testing.assert_allclose(two(padded)[:n].numpy(), one(views).numpy(), rtol=TWO_RTOL, atol=0)
    with pytest.raises(ValueError, match="divide"):
        two(views)


def test_micro_batch_that_does_not_divide_the_mesh_raises(dataset):
    """A micro-batch of 3 on two devices: the step raises (the JAX jit does),
    and the trainer does not take the resident path."""
    _, tree = _pvbnet_tree(64)
    cfg = ttrain.TrainConfig(**_cfg(batch_size=3))
    step = ttrain.make_train_step(_port_model(tree), cfg, mesh=TWO)
    views, labels = _batch(65, 3)
    with pytest.raises(ValueError, match="divide"):
        step(views, labels)
    ds = tdata.PVBDataset(dataset, os.path.join(dataset, "train_split.txt"), [0, 1], crop=SIZE)
    assert not ttrain._use_resident(cfg, ds, 2, TWO) and ttrain._use_resident(cfg, ds, 2, CPU)


def test_resident_and_streaming_agree_on_two_devices(dataset, tmp_path):
    """Both data paths on two devices, two accumulated epochs: the resident
    one (the uint8 stacks copied to each device, each index row split over
    them) and the streaming one give the same parameters and logs."""
    runs = {}
    for resident in (True, False):
        cfg = ttrain.TrainConfig(**_cfg(batch_size=8, accum_steps=2, device_data=resident))
        ds = tdata.PVBDataset(dataset, os.path.join(dataset, "train_split.txt"), [0, 1], crop=SIZE)
        assert ttrain._use_resident(cfg, ds, 2, TWO) == resident
        model, _ = ttrain.train_regression(dataset, os.path.join(dataset, "train_split.txt"),
                                           os.path.join(dataset, "val_split.txt"), cfg=cfg, pattern=[0, 1],
                                           checkpoint_dir=str(tmp_path / str(resident)), mesh=TWO)
        runs[resident] = (model.state_dict(), _log(str(tmp_path / str(resident) / "log.jsonl")))
    (res, res_log), (stream, stream_log) = runs[True], runs[False]
    for k in res:
        torch.testing.assert_close(res[k], stream[k], rtol=0, atol=0)
    for a, b in zip(res_log, stream_log):
        assert a.keys() == b.keys() and abs(a["train_loss"] - b["train_loss"]) <= 1e-6 * b["train_loss"]
        assert {k: a[k] for k in a if k != "train_loss"} == {k: b[k] for k in b if k != "train_loss"}


def test_trainer_runs_on_the_card_by_default(dataset, tmp_path):
    """Without a mesh the trainer takes every CUDA card; without one it
    raises rather than train on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("the card test (tests/test_torch_cuda_kernels.py) covers a machine with a card")
    split = os.path.join(dataset, "train_split.txt")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ttrain.train_regression(dataset, split, split, cfg=ttrain.TrainConfig(**_cfg()), pattern=[0, 1],
                                checkpoint_dir=str(tmp_path))


def test_budget_predictor_reads_a_jax_msgpack_checkpoint(tmp_path):
    """A checkpoint written by the JAX package's save_checkpoint gives the
    same continuous budget through the port's predictor as through the JAX
    predictor (within BUDGET_ATOL); the JAX predictor reads the port's."""
    _, tree = _pvbnet_tree(47, k=3)
    tree["fc4"]["bias"] = np.full_like(tree["fc4"]["bias"], 0.4)
    path = str(tmp_path / "best_checkpoint.msgpack")
    jtrain.save_checkpoint(path, tree, {"epoch": 1})
    views = np.random.default_rng(48).uniform(0, 1, (3, SIZE, SIZE, 3)).astype(np.float32)
    jp = jinfer.BudgetPredictor(path, arch=ARCH, crop=SIZE)
    want = float(jp._apply(jp.params, jnp.asarray(views)[None])[0])
    tp = tinfer.BudgetPredictor(path, arch=ARCH, crop=SIZE, device="cpu")
    assert abs(tp.predict_value_from_arrays(views) - want) < BUDGET_ATOL
    port_path = str(tmp_path / "port.msgpack")
    ttrain.save_checkpoint(port_path, tp.model)
    jp2 = jinfer.BudgetPredictor(port_path, arch=ARCH, crop=SIZE)
    assert float(jp2._apply(jp2.params, jnp.asarray(views)[None])[0]) == want
