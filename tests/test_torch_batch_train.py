"""The port's batched multi-object trainer against the JAX package and
against the port's own single-object step: stacking, one batched step's
losses and gradients, three Adam steps, a short training of two scenes,
the mesh helpers and batched parameters carried across."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_prv_tpu.nerf import api as japi
from nerf_prv_tpu.nerf import batch_train as jbt
from nerf_prv_tpu.nerf import hashgrid as jhg
from nerf_prv_tpu.nerf import model as jm
from nerf_prv_tpu.nerf import render as jrd
from nerf_prv_tpu.nerf import rays as jr
from nerf_prv_tpu.parallel import mesh as jmesh
from nerf_prv_tpu_torch.convert import params_from_numpy, params_to_numpy
from nerf_prv_tpu_torch.nerf import api as tapi
from nerf_prv_tpu_torch.nerf import batch_train as tbt
from nerf_prv_tpu_torch.nerf import hashgrid as thg
from nerf_prv_tpu_torch.nerf import model as tm
from nerf_prv_tpu_torch.nerf import rays as tr
from nerf_prv_tpu_torch.nerf import train as ttr
from nerf_prv_tpu_torch.ops.row_gather import row_gather
from nerf_prv_tpu_torch.ops.row_scatter_add import row_scatter_add
from nerf_prv_tpu_torch.parallel import mesh as tmesh
from synthetic import write_scene
from voxel_common import np_params, rays

# one thread for PyTorch: the tests' tensors are tiny, and several test workers on
# a few cores otherwise spend their time contending for them (minutes, not seconds)
torch.set_num_threads(1)

jtr = __import__("importlib").import_module("nerf_prv_tpu.nerf.train")

# tests/test_batch_train.py's TINY size
TINY = dict(voxel_grid_size=20, voxel_features=4, hidden=48, n_samples=32, train_rays=512, n_steps=200)
GRID = dict(levels=4, features=2, log2_table=12, n_min=8, n_max=64)
K = 3
N_RAYS = 128
# the batched step against JAX's per-object value_and_grad, f32 compute.
# Measured: losses within 1.8e-7 relative; gradients within 2e-6 of each
# parameter's largest entry but for object 0 of the voxel field, whose
# color_w1 (largest entry 1.5e-4, a sum of cancelling terms) is 1.25e-3 off
# and color_w0 4.3e-4: there JAX's own f32 gradient is that far from a
# float64 JAX gradient, and the port's 7e-7 and 1.1e-6
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-3  # of each parameter's largest entry


def _cfgs(field="voxel", compute="f32", **kw):
    kw = dict(TINY, field_impl=field, **kw)
    jcfg = jm.NerfConfig(grid=jhg.HashGridConfig(**GRID), encode_impl="xla",
                         compute_dtype=jnp.float32 if compute == "f32" else jnp.bfloat16, **kw)
    tcfg = tm.NerfConfig(grid=thg.HashGridConfig(**GRID),
                         compute_dtype=torch.float32 if compute == "f32" else torch.bfloat16, **kw)
    return jcfg, tcfg


def _np_batched_params(cfg, field):
    """K parameter sets from numpy, stacked: voxel grids from voxel_common,
    hash tables scaled so the encoding matters."""
    sets = []
    for i in range(K):
        if field == "voxel":
            sets.append(np_params(cfg, seed=i))
        else:
            rng = np.random.default_rng(100 + i)
            p = {k: np.array(v) for k, v in jm.init_params(jax.random.PRNGKey(i), cfg).items()}
            p["table"] = rng.uniform(-1, 1, size=p["table"].shape).astype(np.float32)
            p["sigma_w1"][:, 0] *= 4.0
            sets.append(p)
    return {k: np.stack([s[k] for s in sets]) for k in sets[0]}


def _np_batch(ns, seed=0):
    """K object-major ray batches: (o, d, target, bg, jitter), each (K, N, .)."""
    out = []
    for i in range(K):
        o, d = rays(N_RAYS, seed=seed + i)
        rng = np.random.default_rng(seed + 50 + i)
        out.append((o, d, rng.uniform(size=(N_RAYS, 3)).astype(np.float32),
                    rng.uniform(size=(N_RAYS, 3)).astype(np.float32),
                    rng.uniform(size=(N_RAYS, ns)).astype(np.float32)))
    return tuple(np.stack([b[j] for b in out]) for j in range(5))


def _jax_loss(p, b, jcfg):
    o, d, target, bg, jitter = b
    rgb, acc = jrd.render_rays(p, o, d, jcfg, jitter=jitter)
    return jtr._huber_mean(rgb + bg * (1.0 - acc[:, None]) - target, jcfg)


def _jax_batched(jp, batch, jcfg):
    fn = jax.vmap(jax.value_and_grad(lambda p, b: _jax_loss(p, b, jcfg)))
    return fn(jp, tuple(jnp.asarray(a) for a in batch))


def _torch_batch(batch):
    flat = [torch.from_numpy(a.reshape(K * N_RAYS, -1)) for a in batch]
    return tuple(flat[:4]), flat[4]


def _port_params(p):
    tp = params_from_numpy(p, device="cpu")
    for v in tp.values():
        v.requires_grad_(True)
    return tp


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("batch_scenes")
    a = write_scene(str(root / "a"), n_train=5, n_test=2, seed=1, n_points=4000)
    b = write_scene(str(root / "b"), n_train=8, n_test=2, seed=7, n_points=4000)
    return a[:2], b[:2]


def test_stack_datasets_equal_to_jax(scenes):
    (a, _), (b, _) = scenes
    want = jbt.stack_datasets([jr.load_dataset(a), jr.load_dataset(b)])
    got = tbt.stack_datasets([tr.load_dataset(a), tr.load_dataset(b)])
    assert got[0].shape[:2] == (2, 8) and list(got[3]) == [5, 8]
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("field", ["voxel", "hash"])
def test_batched_step_matches_jax_per_object(field):
    """One batched step's per-object losses and gradients against JAX's
    per-object ``value_and_grad``, vmapped, on identical rays and jitter."""
    jcfg, tcfg = _cfgs(field)
    p = _np_batched_params(jcfg, field)
    batch = _np_batch(tcfg.n_samples)
    loss_j, grads_j = _jax_batched({k: jnp.asarray(v) for k, v in p.items()}, batch, jcfg)
    tp = _port_params(p)
    tb, jitter = _torch_batch(batch)
    losses = tbt.batch_loss(tp, tb, jitter, tcfg)
    losses.sum().backward()
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(loss_j), rtol=LOSS_RTOL)
    for k in p:
        for i in range(K):
            gj, gt = np.asarray(grads_j[k][i]), tp[k].grad[i].numpy()
            scale = np.abs(gj).max()
            assert scale > 0 and np.abs(gt - gj).max() <= GRAD_TOL * scale, (k, i, np.abs(gt - gj).max(), scale)


class _Counting:
    """Counts the calls of a row kernel's wrapper (the plain version runs)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a):
        self.calls += 1
        return self.fn(*a)


@pytest.mark.parametrize("compute", ["bf16", "f32"])
def test_batched_step_equals_single_object_steps(monkeypatch, compute):
    """The batched step against K single-object steps of the port on the same
    rays and jitter: the grid's rows of each object meet only that object's
    updates, so on the CPU the two agree to the last bit but for the batched
    products' own summation order (measured: losses equal; gradients equal
    at f32 and within 8.2e-9 of their max at bf16; held to 1e-6 and 1e-5,
    the card's limits in chip_smoke.py phase 11).  The batched tight step gathers
    twice and scatter-adds once for all K objects."""
    from nerf_prv_tpu_torch.nerf import render as trd
    from nerf_prv_tpu_torch.nerf import voxelfield

    _, tcfg = _cfgs("voxel", compute)
    p = _np_batched_params(tcfg, "voxel")
    batch = _np_batch(tcfg.n_samples, seed=5)
    gather, scatter = _Counting(row_gather), _Counting(row_scatter_add)
    monkeypatch.setattr(voxelfield, "row_gather", gather)
    monkeypatch.setattr(trd, "row_gather", gather)
    monkeypatch.setattr(voxelfield, "row_scatter_add", scatter)
    tp = _port_params(p)
    tb, jitter = _torch_batch(batch)
    losses = tbt.batch_loss(tp, tb, jitter, tcfg)
    losses.sum().backward()
    assert (gather.calls, scatter.calls) == (2, 1)
    for i in range(K):
        single = _port_params({k: v[i] for k, v in p.items()})
        sb = tuple(torch.from_numpy(a[i]) for a in batch)
        loss = ttr.batch_loss(single, sb[:4], sb[4], tcfg)
        loss.backward()
        np.testing.assert_allclose(float(losses[i].detach()), float(loss.detach()), rtol=1e-6)
        for k in p:
            g1, g0 = tp[k].grad[i], single[k].grad
            assert float((g1 - g0).abs().max()) <= 1e-5 * float(g0.abs().max()), (k, i)


def test_dropping_the_object_offset_is_caught(monkeypatch):
    """A gather that reads every object's rows from object 0's grid changes
    objects 1.. by far more than the step tolerance."""
    from nerf_prv_tpu_torch.nerf import voxelfield

    _, tcfg = _cfgs("voxel")
    p = _np_batched_params(tcfg, "voxel")
    batch = _np_batch(tcfg.n_samples, seed=5)
    tb, jitter = _torch_batch(batch)
    good = tbt.batch_loss(_port_params(p), tb, jitter, tcfg).detach()
    rows = tcfg.voxel_grid_size ** 3
    real = voxelfield.row_gather
    monkeypatch.setattr(voxelfield, "row_gather", lambda table, idx: real(table, idx % rows))
    bad = tbt.batch_loss(_port_params(p), tb, jitter, tcfg).detach()
    assert float(bad[0]) == float(good[0])
    assert float(((bad[1:] - good[1:]).abs() / good[1:]).min()) > 1e-3


def test_three_adam_steps_match_vmapped_optax():
    """Three steps of one Adam over the stacked tensors against the
    reference's vmapped optax state (L2 on the MLP weights only)."""
    jcfg, tcfg = _cfgs("voxel", weight_decay=1e-3)
    p = _np_batched_params(jcfg, "voxel")
    batches = [_np_batch(tcfg.n_samples, seed=20 + 3 * i) for i in range(3)]

    opt_j = jtr.make_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    state = jax.vmap(opt_j.init)(jp)

    def one(pk, sk, bk):
        loss, grads = jax.value_and_grad(lambda q: _jax_loss(q, bk, jcfg))(pk)
        updates, sk = opt_j.update(grads, sk, pk)
        return optax.apply_updates(pk, updates), sk, loss

    losses_j = []
    for b in batches:
        jp, state, loss = jax.vmap(one)(jp, state, tuple(jnp.asarray(a) for a in b))
        losses_j.append(np.asarray(loss))

    tp = _port_params(p)
    opt_t = ttr.make_optimizer(tp, tcfg)
    losses_t = []
    for b in batches:
        tb, jitter = _torch_batch(b)
        losses_t.append(tbt.train_step(tp, opt_t, tb, jitter, tcfg).numpy())
    np.testing.assert_allclose(np.stack(losses_t), np.stack(losses_j), rtol=2e-4)
    for k in p:
        a, b = tp[k].detach().numpy(), np.asarray(jp[k])
        moved = np.abs(b - p[k]) > 0
        assert moved.any(), k
        np.testing.assert_array_equal(a[~moved], p[k][~moved])
        # as tests/test_torch_train.py: Adam's first steps are sign-like, so
        # compare the bulk and bound the rest by the three steps' reach
        diff = np.abs(a - b)
        assert np.quantile(diff[moved], 0.99) <= 1e-4, (k, np.quantile(diff[moved], 0.99))
        assert diff.max() <= 2 * 3 * tcfg.lr + 1e-6, (k, diff.max())
        assert diff.mean() <= 2e-5, (k, diff.mean())


def test_sample_objects_draws_each_object_from_its_own_frames(scenes):
    (a, _), (b, _) = scenes
    _, tcfg = _cfgs("voxel")
    ds = [tr.load_dataset(a), tr.load_dataset(b)]
    for bound in ("sphere", "cube"):
        obj = tbt.upload_objects(ds, dataclasses.replace(tcfg, bound=bound), device="cpu")
        o, d, target, bg = tbt.sample_objects(torch.Generator().manual_seed(0), obj, 400)
        assert o.shape == d.shape == target.shape == bg.shape == (800, 3)
        for i, dsi in enumerate(ds):
            own = torch.from_numpy(dsi.origins.astype(np.float32))
            block = o[i * 400 : (i + 1) * 400]
            hit = (block[:, None, :] == own[None]).all(-1)
            assert bool(hit.any(1).all()), (bound, i)  # every ray from a real frame of its own
            if bound == "sphere":
                assert bool(tr.ray_sphere(block, d[i * 400 : (i + 1) * 400])[2].all())
            # the draws reach across the object's frames
            assert int(hit.any(0).sum()) == dsi.n_frames


def test_train_batch_two_scenes_both_learn(scenes):
    (a, ta), (b, tb_) = scenes
    _, tcfg = _cfgs("voxel", "bf16", n_steps=60, train_rays=256, train_warmup_steps=20, train_warmup_samples=24)
    ds = [tr.load_dataset(a), tr.load_dataset(b)]
    params, losses = tbt.train_batch(ds, tcfg, seed=0, device="cpu")
    assert losses.shape == (60, 2) and np.isfinite(losses).all()
    start, end = losses[:5].mean(axis=0), losses[-10:].mean(axis=0)
    assert (end < 0.7 * start).all(), (start, end)
    assert params["grid"].shape == (2, 20 ** 3, 32)
    assert all(not v.requires_grad for v in params.values())
    again, losses2 = tbt.train_batch(ds, tcfg, seed=0, device="cpu")
    np.testing.assert_array_equal(losses, losses2)  # one generator, one seed
    for i, test_json in enumerate((ta, tb_)):
        m = tapi.eval_nerf(tbt.slice_params(params, i), test_json, tcfg)
        assert np.isfinite(m["PSNR"]) and m["PSNR"] > 10.0


def test_train_batch_on_a_mesh_pads_and_drops(scenes):
    """Three objects over a two-device mesh: padded to four, two per device,
    the padded copy dropped; each chunk trains as train_batch does alone."""
    (a, _), (b, _) = scenes
    _, tcfg = _cfgs("voxel", n_steps=4, train_rays=64, train_warmup_steps=2, train_warmup_samples=8)
    ds = [tr.load_dataset(a), tr.load_dataset(b), tr.load_dataset(a)]
    mesh = tmesh.make_mesh(("dp",), devices=["cpu", "cpu"])
    params, losses = tbt.train_batch(ds, tcfg, seed=3, mesh=mesh, device="cpu")
    assert losses.shape == (4, 3) and params["grid"].shape[0] == 3
    first, l0 = tbt.train_batch(ds[:2], tcfg, seed=3, device="cpu")
    second, l1 = tbt.train_batch([ds[2], ds[2]], tcfg, seed=4, device="cpu")
    np.testing.assert_array_equal(losses, np.concatenate([l0, l1[:, :1]], axis=1))
    assert torch.equal(params["grid"][:2], first["grid"]) and torch.equal(params["grid"][2], second["grid"][0])


def test_pad_to_multiple_and_make_mesh_match_jax():
    x = np.arange(21, dtype=np.float32).reshape(21, 1)
    for mult in (1, 4, 8, 21):
        (pj, nj), (pt, nt) = jmesh.pad_to_multiple(x, mult), tmesh.pad_to_multiple(x, mult)
        assert nt == nj
        np.testing.assert_array_equal(pt, pj)
    y = np.arange(12).reshape(3, 4)
    np.testing.assert_array_equal(tmesh.pad_to_multiple(y, 3, axis=1)[0], jmesh.pad_to_multiple(y, 3, axis=1)[0])

    cpu = jax.devices("cpu")[:1]
    jm_ = jmesh.make_mesh(("dp", "tp"), devices=cpu)
    tm_ = tmesh.make_mesh(("dp", "tp"), devices=["cpu"])
    assert tm_.axis_names == tuple(jm_.axis_names) and tm_.devices.shape == jm_.devices.shape
    assert tm_.shape == dict(jm_.shape) and tm_.size == jm_.size
    with pytest.raises(ValueError, match="mesh"):
        jmesh.make_mesh(("dp",), (2,), devices=cpu)
    with pytest.raises(ValueError, match="mesh"):
        tmesh.make_mesh(("dp",), (2,), devices=["cpu"])

    mesh = tmesh.make_mesh(("dp",), devices=["cpu", "cpu"])
    padded, _ = tmesh.pad_to_multiple(x, mesh.size)
    parts = tmesh.shard_batch({"x": padded, "y": [padded[:, 0]]}, mesh)
    assert len(parts) == 2
    np.testing.assert_array_equal(torch.cat([q["x"] for q in parts]).numpy(), padded)
    assert parts[1]["y"][0].shape == (11,)
    with pytest.raises(ValueError, match="divide"):
        tmesh.shard_batch(x, mesh)


@pytest.mark.parametrize("field", ["voxel", "hash"])
def test_batched_params_carry_across(field, scenes):
    """A batched parameter tree crosses in both directions, and object i's
    slice scores the same under either package's eval_nerf."""
    (_, test_json), _ = scenes
    jcfg, tcfg = _cfgs(field)
    jp = jax.vmap(lambda kk: jm.init_params(kk, jcfg))(jax.random.split(jax.random.PRNGKey(0), 2))
    p = {k: np.array(v) for k, v in jp.items()}
    if field == "voxel":
        p["grid"] *= 1e4
    else:
        p["table"] *= 1e4
    p["sigma_w1"][:, :, 0] *= 20.0
    tp = params_from_numpy(p, device="cpu")
    back = params_to_numpy(tp)
    assert sorted(back) == sorted(p)
    for k in p:
        assert back[k].dtype == p[k].dtype
        np.testing.assert_array_equal(back[k], p[k])
    jtree = {k: jnp.asarray(v) for k, v in back.items()}
    for i in range(2):
        want = japi.eval_nerf(jbt.slice_params(jtree, i), test_json, jcfg)
        got = tapi.eval_nerf(tbt.slice_params(tp, i), test_json, tcfg)
        assert abs(got["PSNR"] - want["PSNR"]) <= 1e-3, (i, got, want)
        assert abs(got["SSIM"] - want["SSIM"]) <= 1e-5, (i, got, want)


def test_make_mesh_without_a_card_asks_for_the_cpu(monkeypatch):
    """No silent CPU fallback: without a card and without ``devices``,
    ``make_mesh`` raises and names ``devices=["cpu"]``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"devices=\['cpu'\]"):
        tmesh.make_mesh()
    assert tmesh.make_mesh(("dp",), devices=["cpu"]).size == 1
