"""The port's trainer against the JAX package: hit pool, batch decoding,
the training march, the loss, three optimizer steps, and the phase plan."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_prv_tpu.core.config import CameraConfig as JCam
from nerf_prv_tpu.nerf import rays as jr
from nerf_prv_tpu.nerf import render as jrd
from nerf_prv_tpu_torch.core.config import CameraConfig as TCam
from nerf_prv_tpu_torch.nerf import rays as tr
from nerf_prv_tpu_torch.nerf import render as trd
from nerf_prv_tpu_torch.nerf import train as ttr
from synthetic import write_scene
from voxel_common import both, cfgs, np_params, rays

# one thread for PyTorch: the tests' tensors are tiny, and several test workers on
# a few cores otherwise spend their time contending for them (minutes, not seconds)
torch.set_num_threads(1)

# the JAX package's nerf/__init__ exports the function `train` under the module's name
jtr = importlib.import_module("nerf_prv_tpu.nerf.train")

CAM = dict(width=64, height=36, fx=70.0, fy=70.0, ppx=32.0, ppy=18.0, model=0)
# f32 training march: the same composite and matmul reorderings as the
# eval renders, whose parity tests measured 3.5e-5
RENDER_TOL = 1e-4
# gradients, relative to each parameter's largest entry
GRAD_TOL = 5e-4


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_scene")
    train_json, test_json, _, _ = write_scene(
        str(root), n_train=5, n_test=2, camera=JCam(**CAM), n_points=4000
    )
    return train_json, test_json


def _cams(ds):
    return (
        jnp.asarray(ds.rotations), jnp.asarray(ds.origins),
        torch.from_numpy(ds.rotations), torch.from_numpy(ds.origins),
    )


def test_rays_from_pixels_match(scene):
    ds = tr.load_dataset(scene[0], with_images=False)
    jrot, jorg, trot, torg = _cams(ds)
    rng = np.random.default_rng(0)
    f = rng.integers(0, ds.n_frames, size=300)
    u = rng.integers(0, 64, size=300).astype(np.float32)
    v = rng.integers(0, 36, size=300).astype(np.float32)
    want = jr.rays_from_pixels(jrot, jorg, JCam(**CAM), jnp.asarray(f), jnp.asarray(u), jnp.asarray(v))
    got = tr.rays_from_pixels(trot, torg, TCam(**CAM), torch.from_numpy(f), torch.from_numpy(u), torch.from_numpy(v))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)


def test_build_hit_pool_equals_jax(scene):
    ds = tr.load_dataset(scene[0], with_images=False)
    jrot, jorg, trot, torg = _cams(ds)
    pool_j, n_j = jtr.build_hit_pool(jrot, jorg, JCam(**CAM))
    pool_t, n_t = ttr.build_hit_pool(trot, torg, TCam(**CAM))
    assert isinstance(n_t, int) and n_t == int(n_j) and 0 < n_t < pool_t.numel()
    assert pool_t.dtype == torch.int32
    np.testing.assert_array_equal(pool_t.numpy(), np.asarray(pool_j))


def test_pool_ray_batch_and_huber_match(scene):
    ds = tr.load_dataset(scene[0])
    jrot, jorg, trot, torg = _cams(ds)
    u8 = np.clip(ds.pixels * 255.0 + 0.5, 0, 255).astype(np.uint8)
    idx = np.random.default_rng(1).integers(0, u8.shape[0] * 36 * 64, size=500).astype(np.int32)
    want = jtr._pool_ray_batch(jnp.asarray(idx), jnp.asarray(u8), jrot, jorg, JCam(**CAM))
    got = ttr._pool_ray_batch(torch.from_numpy(idx), torch.from_numpy(u8), trot, torg, TCam(**CAM))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)
    err = np.random.default_rng(2).normal(size=(400, 3)).astype(np.float32) * 0.2
    jcfg, tcfg = cfgs()
    np.testing.assert_allclose(
        float(ttr._huber_mean(torch.from_numpy(err), tcfg)),
        float(jtr._huber_mean(jnp.asarray(err), jcfg)), rtol=1e-6,
    )


def test_sample_batch_pooled_draws_from_the_pool(scene):
    ds = tr.load_dataset(scene[0])
    _, _, trot, torg = _cams(ds)
    u8 = torch.from_numpy(np.clip(ds.pixels * 255.0 + 0.5, 0, 255).astype(np.uint8))
    pool, n_hit = ttr.build_hit_pool(trot, torg, TCam(**CAM))
    draw = lambda seed: ttr._sample_batch_pooled(  # noqa: E731
        torch.Generator().manual_seed(seed), u8, trot, torg, TCam(**CAM), 300, pool, n_hit)
    o, d, target, bg = draw(0)
    assert o.shape == d.shape == target.shape == bg.shape == (300, 3)
    assert bool(tr.ray_sphere(o, d)[2].all())  # every drawn ray hits the sphere
    assert 0.0 <= float(bg.min()) and float(bg.max()) < 1.0 and float(target.max()) <= 1.0
    again = draw(0)
    assert all(torch.equal(a, b) for a, b in zip((o, d, target, bg), again))
    assert not torch.equal(draw(1)[3], bg)


def _batch(n=256, ns=16, seed=3):
    o, d = rays(n, seed=seed)
    rng = np.random.default_rng(seed + 10)
    jitter = rng.uniform(size=(n, ns)).astype(np.float32)
    bg = rng.uniform(size=(n, 3)).astype(np.float32)
    target = rng.uniform(size=(n, 3)).astype(np.float32)
    return o, d, target, bg, jitter


@pytest.mark.parametrize("train_coarse", [12, 0], ids=["tightened", "flat"])
def test_training_render_rays_matches(train_coarse):
    jcfg, tcfg = cfgs(train_coarse=train_coarse)
    jp, tp = both(np_params(jcfg))
    o, d, _, _, jitter = _batch()
    rgb_j, a_j = jrd.render_rays(jp, jnp.asarray(o), jnp.asarray(d), jcfg, jitter=jnp.asarray(jitter))
    rgb_t, a_t = trd.render_rays(tp, torch.from_numpy(o), torch.from_numpy(d), tcfg, jitter=torch.from_numpy(jitter))
    assert float(a_t.max()) > 0.5 and float(a_t[:16].max()) == 0.0  # misses stay empty
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=0, atol=RENDER_TOL)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=0, atol=RENDER_TOL)


def test_training_probe_falls_back_to_the_full_chord():
    """Rays whose probes find nothing keep their whole sphere chord in
    training (eval drops them instead): on an empty field the tightened
    march samples exactly where the flat march does."""
    jcfg, tcfg = cfgs()
    p = np_params(jcfg)
    p["sigma_w1"][:, 0] = -20.0  # raw = -20 * sum(relu(.)): sigma ~ 0 everywhere
    jp, tp = both(p)
    o, d, _, _, jitter = _batch(64)
    args = (torch.from_numpy(o), torch.from_numpy(d))
    tight = trd.render_rays(tp, *args, tcfg, jitter=torch.from_numpy(jitter))
    flat = trd.render_rays(tp, *args, dataclasses.replace(tcfg, train_coarse=0), jitter=torch.from_numpy(jitter))
    assert torch.equal(tight[0], flat[0]) and torch.equal(tight[1], flat[1])
    rgb_j, a_j = jrd.render_rays(jp, jnp.asarray(o), jnp.asarray(d), jcfg, jitter=jnp.asarray(jitter))
    np.testing.assert_allclose(tight[1].numpy(), np.asarray(a_j), rtol=0, atol=RENDER_TOL)
    np.testing.assert_allclose(tight[0].numpy(), np.asarray(rgb_j), rtol=0, atol=RENDER_TOL)


def _jax_loss(p, batch, jcfg):
    o, d, target, bg, jitter = (jnp.asarray(a) for a in batch)
    rgb, acc = jrd.render_rays(p, o, d, jcfg, jitter=jitter)
    return jtr._huber_mean(rgb + bg * (1.0 - acc[:, None]) - target, jcfg)


def _torch_batch(batch):
    o, d, target, bg, jitter = (torch.from_numpy(a) for a in batch)
    return (o, d, target, bg), jitter


@pytest.mark.parametrize("gather", ["bf16", "f32"])
def test_batch_loss_and_gradients_match(gather):
    jcfg, tcfg = cfgs(voxel_gather_dtype=gather)
    p = np_params(jcfg)
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
        assert scale > 0 and np.abs(gt - gj).max() <= GRAD_TOL * scale, (k, np.abs(gt - gj).max(), scale)


def test_gradient_through_saturated_rays_is_finite_and_matches():
    """A wall of huge density saturates every ray after a sample or two:
    transmittance underflows and ``1 - alpha + 1e-10`` sits at 1e-10.  The
    composite's backward divides by that; it must give JAX's gradient, not
    NaN."""
    jcfg, tcfg = cfgs(train_coarse=0)
    p = np_params(jcfg, density_gain=40.0)
    jp, tp = both(p)
    batch = _batch(128)
    grads_j = jax.grad(_jax_loss)(jp, batch, jcfg)
    for v in tp.values():
        v.requires_grad_(True)
    tb, jitter = _torch_batch(batch)
    with torch.no_grad():
        o, d = tb[0], tb[1]
        sig = trd.render_rays(tp, o, d, tcfg, jitter=jitter)[1]
    assert float(sig.max()) > 0.999  # saturated
    ttr.batch_loss(tp, tb, jitter, tcfg).backward()
    for k in p:
        gj, gt = np.asarray(grads_j[k]), tp[k].grad.numpy()
        assert np.isfinite(gt).all() and np.isfinite(gj).all(), k
        scale = np.abs(gj).max()
        assert np.abs(gt - gj).max() <= 5 * GRAD_TOL * max(scale, 1e-30), (k, np.abs(gt - gj).max(), scale)


def test_three_optimizer_steps_match_optax():
    """Three Adam steps (eps 1e-15, L2 on the MLP weights only) from one
    batch per step, against jax.value_and_grad + the JAX make_optimizer."""
    jcfg, tcfg = cfgs(weight_decay=1e-3)  # large enough to show in three steps
    p = np_params(jcfg)
    jp, tp = both(p)
    batches = [_batch(seed=20 + i) for i in range(3)]

    opt_j = jtr.make_optimizer(jcfg)
    state = opt_j.init(jp)
    losses_j = []
    for b in batches:
        loss, grads = jax.value_and_grad(_jax_loss)(jp, b, jcfg)
        updates, state = opt_j.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        losses_j.append(float(loss))

    for v in tp.values():
        v.requires_grad_(True)
    opt_t = ttr.make_optimizer(tp, tcfg)
    losses_t = []
    for b in batches:
        tb, jitter = _torch_batch(b)
        losses_t.append(float(ttr.train_step(tp, opt_t, tb, jitter, tcfg)))
    # the later losses see the earlier updates
    np.testing.assert_allclose(losses_t, losses_j, rtol=2e-4)
    for k in p:
        a, b = tp[k].detach().numpy(), np.asarray(jp[k])
        moved = np.abs(b - p[k]) > 0
        assert moved.any(), k
        # rows of the grid that no sample touched get 0 / (0 + eps) = 0
        np.testing.assert_array_equal(a[~moved], p[k][~moved])
        # Adam's first steps are sign-like (lr * g / |g|): an element whose
        # gradient is rounding noise may step the other way, so compare
        # the bulk and bound the rest by the three steps' reach
        diff = np.abs(a - b)
        assert np.quantile(diff[moved], 0.99) <= 1e-4, (k, np.quantile(diff[moved], 0.99))
        assert diff.max() <= 2 * 3 * tcfg.lr + 1e-6, (k, diff.max())
        assert diff.mean() <= 2e-5, (k, diff.mean())


def test_weight_decay_skips_the_grid():
    _, tcfg = cfgs(weight_decay=0.5)
    _, tp = both(np_params(tcfg))
    opt = ttr.make_optimizer(tp, tcfg)
    decayed = {id(q) for g in opt.param_groups if g["weight_decay"] > 0 for q in g["params"]}
    assert id(tp["grid"]) not in decayed
    assert all(id(v) in decayed for k, v in tp.items() if k != "grid")
    g = opt.param_groups[0]
    assert (g["lr"], g["betas"], g["eps"]) == (tcfg.lr, (0.9, 0.99), 1e-15)


def test_phase_plan_matches_reference():
    _, cfg = cfgs(n_steps=300, train_warmup_steps=125, train_warmup_samples=48)
    (warm, n_warm), (tight, n_tight) = ttr._phases(cfg, warm_start=False)
    assert (n_warm, n_tight) == (125, 175) and tight is cfg
    assert (warm.train_coarse, warm.n_samples, warm.train_rays) == (0, 48, cfg.train_rays)
    assert ttr._phases(cfg, warm_start=True) == [(cfg, 300)]
    short = dataclasses.replace(cfg, n_steps=50)
    assert [n for _, n in ttr._phases(short, warm_start=False)] == [50, 0]
    flat = dataclasses.replace(cfg, train_coarse=0)
    assert ttr._phases(flat, warm_start=False) == [(flat, 300)]
    rays_cfg = dataclasses.replace(cfg, train_warmup_rays=1024)
    assert ttr._phases(rays_cfg, warm_start=False)[0][0].train_rays == 1024


@pytest.mark.parametrize("bound", ["sphere", "cube"])
def test_train_learns_and_warm_start_skips_warmup(scene, bound):
    _, cfg = cfgs("bf16", n_steps=60, train_rays=256, train_warmup_steps=20,
                  train_warmup_samples=24, bound=bound)
    ds = tr.load_dataset(scene[0])
    params, losses = ttr.train(ds, cfg, seed=0, device="cpu")
    assert losses.shape == (60,) and np.isfinite(losses).all()
    assert losses[-10:].mean() < 0.5 * losses[:5].mean()
    assert all(not v.requires_grad and v.device.type == "cpu" for v in params.values())
    again, losses2 = ttr.train(ds, cfg, seed=0, device="cpu")
    np.testing.assert_array_equal(losses, losses2)  # one generator, one seed
    before = {k: v.clone() for k, v in params.items()}
    warm, losses3 = ttr.train(ds, dataclasses.replace(cfg, n_steps=5), seed=1, init_from=params, device="cpu")
    assert losses3.shape == (5,) and losses3.mean() < losses[:5].mean()
    assert all(torch.equal(before[k], params[k]) for k in params)  # trained on a copy
    assert not torch.equal(warm["grid"], params["grid"])
