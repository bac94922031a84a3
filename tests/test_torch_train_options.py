"""The port's hash training step, bf16-moment Adam, baked train probe and
every other training option against the JAX package (the trainer's basics
are in test_torch_train.py, whose helpers and scene these tests share)."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_prv_tpu.nerf import render as jrd
from nerf_prv_tpu_torch.nerf import rays as tr
from nerf_prv_tpu_torch.nerf import train as ttr
from test_torch_train import GRAD_TOL, _batch, _jax_loss, _torch_batch, scene  # noqa: F401 (scene: a fixture)
from voxel_common import both, cfgs, np_params

# one thread for PyTorch: the tests' tensors are tiny, and several test workers on
# a few cores otherwise spend their time contending for them (minutes, not seconds)
torch.set_num_threads(1)

jtr = importlib.import_module("nerf_prv_tpu.nerf.train")

HASH_GRID = dict(levels=4, features=2, log2_table=12, n_min=4, n_max=64)


def _hash_cfgs(**kw):
    from nerf_prv_tpu.nerf import hashgrid as jhg
    from nerf_prv_tpu.nerf import model as jm
    from nerf_prv_tpu_torch.nerf import hashgrid as thg
    from nerf_prv_tpu_torch.nerf import model as tm

    jcfg = jm.NerfConfig(grid=jhg.HashGridConfig(**HASH_GRID), hidden=16, field_impl="hash",
                         encode_impl="sorted", compute_dtype=jnp.float32, **kw)
    tcfg = tm.NerfConfig(grid=thg.HashGridConfig(**HASH_GRID), hidden=16, field_impl="hash",
                         encode_impl="fused", compute_dtype=torch.float32, **kw)
    return jcfg, tcfg


def _hash_np_params(jcfg, seed=0):
    from nerf_prv_tpu.nerf import model as jm

    p = {k: np.array(v) for k, v in jm.init_params(jax.random.PRNGKey(seed), jcfg).items()}
    p["table"] *= 1e4  # O(1) features
    p["sigma_w1"][:, 0] *= 20.0  # densities from ~0 to saturating
    return p


@pytest.mark.parametrize("train_coarse", [12, 0], ids=["tightened", "flat"])
def test_hash_training_step_loss_and_gradients_match(train_coarse):
    """One hash-field training step on identical rays and jitter: the port
    through ``encode_fused`` (on the CPU the plain versions of the forward
    and table-gradient kernels) against ``jax.value_and_grad`` through the
    reference's ``encode_sorted``.  Loss within 1e-5 relative (measured
    9e-8); every gradient, ``table`` included, within 2e-5 of its largest
    entry (measured 2e-7 to 1.4e-6: f32 composites, matmuls and the
    table's sums in other orders)."""
    jcfg, tcfg = _hash_cfgs(train_coarse=train_coarse)
    p = _hash_np_params(jcfg)
    jp, tp = both(p)
    batch = _batch()
    loss_j, grads_j = jax.value_and_grad(_jax_loss)(jp, batch, jcfg)
    for v in tp.values():
        v.requires_grad_(True)
    tb, jitter = _torch_batch(batch)
    loss_t = ttr.batch_loss(tp, tb, jitter, tcfg)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    for k in p:
        gj, gt = np.asarray(grads_j[k]), tp[k].grad.numpy()
        assert np.isfinite(gt).all()
        scale = np.abs(gj).max()
        assert scale > 0 and np.abs(gt - gj).max() <= 2e-5 * scale, (k, np.abs(gt - gj).max(), scale)
    assert (tp["table"].grad != 0).any(dim=1).sum() > 100  # many rows took updates


def test_bf16_moment_adam_matches_scale_by_adam_lowp():
    """Six steps of the bf16-moment Adam on numpy gradients against the
    reference's ``make_optimizer(adam_moment_dtype="bfloat16")`` chain, with
    coupled weight decay on the MLP weight only.  Both round the moments to
    bf16 after each step; an f32 difference of an ulp before that rounding
    can move a stored moment by one bf16 ulp (0.4%), hence 1% of the step
    size on the parameters and one bf16 ulp on the moments."""
    jcfg, tcfg = cfgs(weight_decay=1e-2, adam_moment_dtype="bfloat16")
    rng = np.random.default_rng(5)
    p0 = {"grid": rng.normal(size=(50, 8)).astype(np.float32),
          "sigma_w0": rng.normal(size=(8, 4)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * 10.0 ** rng.uniform(-4, 0)).astype(np.float32)
              for k, v in p0.items()} for _ in range(6)]
    for g in grads:
        g["grid"][:5] = 0.0  # rows no sample touched

    opt_j = jtr.make_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt_j.init(jp)
    for g in grads:
        updates, state = opt_j.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
    adam_state = state[1]
    assert adam_state.mu["grid"].dtype == jnp.bfloat16

    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in p0.items()}
    opt_t = ttr.make_optimizer(tp, tcfg)
    assert isinstance(opt_t, ttr.AdamLowp)
    for g in grads:
        for k in tp:
            tp[k].grad = torch.from_numpy(g[k].copy())
        opt_t.step()
    for k in p0:
        a, b = tp[k].detach().numpy(), np.asarray(jp[k])
        reach = len(grads) * tcfg.lr
        assert np.abs(b - p0[k]).max() > 0.5 * reach  # the steps are visible
        assert np.abs(a - b).max() <= 0.01 * reach, (k, np.abs(a - b).max())
        st = opt_t.state[tp[k]]
        assert st["mu"].dtype == st["nu"].dtype == torch.bfloat16 and st["step"] == len(grads)
        for name, ref in (("mu", adam_state.mu[k]), ("nu", adam_state.nu[k])):
            got = st[name].to(torch.float32).numpy()
            want = np.asarray(ref.astype(jnp.float32))
            np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-30)
    np.testing.assert_array_equal(tp["grid"].detach().numpy()[:5], p0["grid"][:5])  # 0 / (0 + eps)
    # the float32 optimizer stays torch.optim.Adam
    assert isinstance(ttr.make_optimizer(tp, cfgs()[1]), torch.optim.Adam)


def test_baked_probe_step_matches_jax():
    """One tight step whose probe reads a baked corner-density table: the
    same bf16 table on both sides (made by JAX), the same rays and jitter;
    loss and gradients as in the MLP-probed step."""
    from nerf_prv_tpu.nerf import voxelfield as jvf

    jcfg, tcfg = cfgs(train_probe_refresh=10)
    p = np_params(jcfg)
    jp, tp = both(p)
    praw_j = jvf.lattice_corner_raw(jp, jcfg).astype(jnp.bfloat16)
    praw_t = torch.from_numpy(np.array(praw_j.astype(jnp.float32))).to(torch.bfloat16)
    batch = _batch()

    def jax_loss(q):
        o, d, target, bg, jitter = (jnp.asarray(a) for a in batch)
        rgb, acc = jrd.render_rays(q, o, d, jcfg, jitter=jitter, probe_raw=praw_j)
        return jtr._huber_mean(rgb + bg * (1.0 - acc[:, None]) - target, jcfg)

    loss_j, grads_j = jax.value_and_grad(jax_loss)(jp)
    for v in tp.values():
        v.requires_grad_(True)
    tb, jitter = _torch_batch(batch)
    loss_t = ttr.batch_loss(tp, tb, jitter, tcfg, probe_raw=praw_t)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    for k in p:
        gj, gt = np.asarray(grads_j[k]), tp[k].grad.numpy()
        scale = np.abs(gj).max()
        assert scale > 0 and np.abs(gt - gj).max() <= GRAD_TOL * scale, k
    # the table the trainer bakes is the one JAX bakes, to a bf16 ulp
    baked = ttr.bake_train_probe(tp, tcfg)
    assert baked.dtype == torch.bfloat16 and baked.shape == praw_t.shape
    a = baked.view(torch.int16).numpy().astype(np.int32)
    b = praw_t.view(torch.int16).numpy().astype(np.int32)
    assert np.abs(a - b).max() <= 1 and (a != b).mean() <= 1e-3
    assert ttr.uses_baked_probe(tcfg)
    assert not ttr.uses_baked_probe(dataclasses.replace(tcfg, bound="cube"))
    assert not ttr.uses_baked_probe(dataclasses.replace(tcfg, train_coarse=0))
    assert not ttr.uses_baked_probe(_hash_cfgs(train_probe_refresh=10)[1])


def test_baked_probe_is_rebaked_every_refresh_steps(scene, monkeypatch):
    _, cfg = cfgs("bf16", n_steps=33, train_rays=64, train_warmup_steps=10,
                  train_warmup_samples=24, train_probe_refresh=10)
    bakes = []
    real = ttr.bake_train_probe
    monkeypatch.setattr(ttr, "bake_train_probe", lambda p, c: bakes.append(1) or real(p, c))
    _, losses = ttr.train(tr.load_dataset(scene[0]), cfg, device="cpu")
    # no bake in the 10 warmup steps (no probe there); steps 0, 10, 20 of the 23 tight ones
    assert len(bakes) == 3 and np.isfinite(losses).all()


@pytest.mark.parametrize(
    "kw",
    [
        dict(adam_moment_dtype="bfloat16"),
        dict(field_impl="hash", encode_impl="fused", hidden=16),
        dict(field_impl="hash", encode_impl="sorted", hidden=16),
        dict(field_impl="hash", encode_impl="auto", hidden=16, adam_moment_dtype="bfloat16"),
        dict(n_importance=8),
        dict(train_probe_refresh=10),
        dict(train_probe_refresh=7, n_importance=4, adam_moment_dtype="bfloat16"),
    ],
    ids=["bf16_moments", "hash_fused", "hash_sorted", "hash_auto_bf16_moments", "importance",
         "baked_probe", "all_three"],
)
def test_ported_training_options_train(scene, kw):
    """Each option that used to raise now trains: 60 steps on the CPU bring
    the loss below half of where it started, and the same seed gives the
    same losses."""
    from nerf_prv_tpu_torch.nerf import hashgrid as thg

    if kw.get("field_impl") == "hash":
        kw = dict(kw, grid=thg.HashGridConfig(**HASH_GRID))
    _, cfg = cfgs("bf16", n_steps=60, train_rays=256, train_warmup_steps=20,
                  train_warmup_samples=24, **kw)
    ds = tr.load_dataset(scene[0])
    params, losses = ttr.train(ds, cfg, seed=0, device="cpu")
    assert losses.shape == (60,) and np.isfinite(losses).all()
    assert losses[-10:].mean() < 0.5 * losses[:5].mean()
    assert ("table" in params) == (cfg.field_impl == "hash")
    _, again = ttr.train(ds, dataclasses.replace(cfg, n_steps=25), seed=0, device="cpu")
    np.testing.assert_array_equal(again, losses[:25])
