"""The port's row-sharded voxel field (``tp_voxel_field``) against the JAX
package's on the CPU, and the port's multi-chip dry run.

JAX runs on two of the conftest's 8 virtual CPU devices; the port on a mesh
that lists ``"cpu"`` several times, which runs the same shard split, masked
gathers and cross-device sums as a mesh of distinct cards.  Inputs are made
by numpy from a seed, weights carried over as numpy arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from nerf_prv_tpu.nerf import NerfConfig as JConfig
from nerf_prv_tpu.nerf import init_params as jinit
from nerf_prv_tpu.parallel import make_mesh as jmake_mesh
from nerf_prv_tpu.parallel.mesh import tp_voxel_field as jtp_voxel_field
from nerf_prv_tpu_torch.convert import params_from_numpy
from nerf_prv_tpu_torch.nerf.model import NerfConfig
from nerf_prv_tpu_torch.nerf.voxelfield import voxel_field
from nerf_prv_tpu_torch.ops.row_gather import row_gather
from nerf_prv_tpu_torch.ops.row_scatter_add import row_scatter_add
from nerf_prv_tpu_torch.parallel import make_mesh, shard_rows, tp_gather_rows, tp_voxel_field
from nerf_prv_tpu_torch.parallel.dryrun import dryrun_multichip

torch.set_num_threads(1)

# tests/test_parallel.py's configuration, with the MLPs in float32 on both
# sides so that only the frameworks' summation orders differ
SIZE = dict(voxel_grid_size=20, voxel_features=4, hidden=32)
JCFG = JConfig(compute_dtype=jnp.float32, **SIZE)
CFG = NerfConfig(compute_dtype=torch.float32, voxel_gather_dtype="f32", **SIZE)
# port against JAX, both gathering in f32: measured 1.2e-7 (sigma) and
# 7.9e-8 (rgb) of the largest output, gradients 6.5e-8 to 2.1e-7 of each
# leaf's largest entry; against the port's replicated field, gradients 0
# at tp x 1 and up to 3.3e-7 with the samples split over dp
FWD_RTOL = 1e-5
GRAD_RTOL = 1e-5


def _setup(n=256, seed=1):
    """tests/test_parallel.py's setup: JAX's init, the grid raised by 0.05,
    points in [0.01, 0.99]^3 and unit directions from a seeded numpy."""
    params = jinit(jax.random.PRNGKey(0), JCFG)
    params = {k: np.asarray(v + 0.05 if k == "grid" else v) for k, v in params.items()}
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.01, 0.99, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return params, x, d / np.linalg.norm(d, axis=1, keepdims=True)


def _loss(sigma, rgb):
    """tests/test_parallel.py:63-69's loss, in either framework."""
    return (sigma.sum() * 1e-3 + (rgb * rgb).sum())


def _port_tp(params, x, d, tp, dp, cfg=CFG):
    """(sigma, rgb, gradients as full arrays) of the port's tp field on a
    (tp, dp) mesh of the CPU listed tp * dp times."""
    mesh = make_mesh(("tp", "dp"), (tp, dp), ["cpu"] * (tp * dp))
    p = params_from_numpy(params, device="cpu")
    p = {k: v.requires_grad_(True) for k, v in p.items()}
    sharded = dict(p, grid=shard_rows(p["grid"].detach().requires_grad_(True), mesh))
    sigma, rgb = tp_voxel_field(mesh, sharded, torch.from_numpy(x), torch.from_numpy(d), cfg,
                                batch_axis="dp" if dp > 1 else None)
    _loss(sigma, rgb).backward()
    grads = {k: v.grad.numpy() for k, v in p.items() if k != "grid"}
    grads["grid"] = torch.cat([s.grad for s in sharded["grid"]]).numpy()
    return sigma.detach(), rgb.detach(), grads


def _port_replicated(params, x, d):
    p = {k: v.requires_grad_(True) for k, v in params_from_numpy(params, device="cpu").items()}
    sigma, rgb = voxel_field(p, torch.from_numpy(x), torch.from_numpy(d), CFG)
    _loss(sigma, rgb).backward()
    return sigma.detach(), rgb.detach(), {k: v.grad.numpy() for k, v in p.items()}


def _assert_grads_close(got, want, rtol):
    assert set(got) == set(want)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(got[k] - want[k]).max()) / scale
        assert err <= rtol, f"gradient {k}: {err:.3e} of its largest > {rtol}"


def test_tp_field_and_gradients_match_jax():
    """The port's tp field on a (2, 1) mesh against JAX's tp_voxel_field on
    jax.devices()[:2]: forward within FWD_RTOL of the largest output, every
    gradient (JAX's jax.grad of the same loss) within GRAD_RTOL of its
    leaf's largest entry."""
    params, x, d = _setup(128)
    mesh = jmake_mesh(("tp", "dp"), (2, 1), jax.devices()[:2])
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    sharded = dict(jp, grid=jax.device_put(jp["grid"], NamedSharding(mesh, P("tp"))))
    xj, dj = jnp.asarray(x), jnp.asarray(d)
    sig_j, rgb_j = jtp_voxel_field(mesh, sharded, xj, dj, JCFG)
    g_j = jax.grad(lambda p: _loss(*jtp_voxel_field(mesh, p, xj, dj, JCFG)))(sharded)
    sig_t, rgb_t, g_t = _port_tp(params, x, d, 2, 1)
    for got, want in ((sig_t, sig_j), (rgb_t, rgb_j)):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert float(np.abs(got.numpy() - want).max()) <= FWD_RTOL * float(np.abs(want).max())
    _assert_grads_close(g_t, {k: np.asarray(v) for k, v in g_j.items()}, GRAD_RTOL)


@pytest.mark.parametrize("tp,dp", [(2, 1), (4, 1), (2, 2), (1, 4)])
def test_tp_field_equals_the_replicated_field(tp, dp):
    """Against the port's replicated f32 field: the masked sum adds exact
    zeros, and the products run on the same rows, so the forward is
    bit-equal at tp x 1 and, the MLPs running on the CPU's same kernels
    chunk by chunk, at tp x dp here too; the gradients sum the same
    updates in another grouping (within GRAD_RTOL)."""
    params, x, d = _setup()
    sig, rgb, grads = _port_tp(params, x, d, tp, dp)
    sig_r, rgb_r, grads_r = _port_replicated(params, x, d)
    assert torch.equal(sig, sig_r) and torch.equal(rgb, rgb_r)
    _assert_grads_close(grads, grads_r, GRAD_RTOL)


def test_every_sample_in_one_shard():
    """Every sample's cell in the first half of the grid: shard 1's gather
    is masked everywhere, its backward scatters only zeros (one launch, as
    every shard's), and the field still equals the replicated one."""
    params, x, d = _setup()
    x[:, 0] = np.clip(x[:, 0] * 0.4, 0.0, 0.45)  # cell x <= 8 of 20: rows below 4000 of 8000
    sig, rgb, grads = _port_tp(params, x, d, 2, 1)
    sig_r, rgb_r, grads_r = _port_replicated(params, x, d)
    assert torch.equal(sig, sig_r) and torch.equal(rgb, rgb_r)
    rows = grads["grid"].shape[0] // 2
    assert not grads["grid"][rows:].any() and grads["grid"][:rows].any()
    _assert_grads_close(grads, grads_r, GRAD_RTOL)


def test_tp_gather_rows_counts_and_ranges(monkeypatch):
    """One gather and one scatter-add per shard, whatever the number of
    index tensors; every index reaching a shard's gather lies inside it
    (``row_gather`` does not clamp); one index tensor gives one result."""
    seen = []
    real = row_gather

    def watch(table, idx):
        seen.append((table.shape[0], int(idx.min()), int(idx.max()), idx.numel()))
        return real(table, idx)

    from nerf_prv_tpu_torch.nerf import voxelfield

    monkeypatch.setattr(voxelfield, "row_gather", watch)
    scatters = []
    real_s = row_scatter_add
    monkeypatch.setattr(voxelfield, "row_scatter_add",
                        lambda i, u, n: scatters.append(n) or real_s(i, u, n))
    grid = torch.randn(60, 8, generator=torch.Generator().manual_seed(0))
    mesh = make_mesh(("tp",), (3,), ["cpu"] * 3)
    shards = [s.requires_grad_(True) for s in shard_rows(grid, mesh)]
    idx = [torch.tensor([0, 59, 20, 19, 40], dtype=torch.int32), torch.tensor([39, 21], dtype=torch.int32)]
    out = tp_gather_rows(shards, idx)
    assert isinstance(out, list) and len(out) == 2
    assert torch.equal(out[0], grid[idx[0].long()]) and torch.equal(out[1], grid[idx[1].long()])
    assert [(n, lo >= 0 and hi < 20, k) for n, lo, hi, k in seen] == [(20, True, 7)] * 3
    sum(o.sum() for o in out).backward()
    assert scatters == [20, 20, 20]
    counts = torch.bincount(torch.cat(idx).long(), minlength=60).float()[:, None].expand(60, 8)
    assert torch.equal(torch.cat([s.grad for s in shards]), counts)
    (single,) = tp_gather_rows(shards, idx[:1])
    assert torch.equal(single, out[0])


def test_shard_rows_places_one_shard_per_tp_device():
    grid = torch.arange(40.0).reshape(10, 4)
    mesh = make_mesh(("tp", "dp"), (2, 2), ["cpu"] * 4)
    shards = shard_rows(grid, mesh)
    assert [tuple(s.shape) for s in shards] == [(5, 4), (5, 4)]
    assert torch.equal(torch.cat(shards), grid) and shards[0].data_ptr() != grid.data_ptr()
    assert not shards[0].requires_grad and shard_rows(grid.requires_grad_(True), mesh)[1].requires_grad
    with pytest.raises(ValueError, match="divide"):
        shard_rows(torch.zeros(9, 4), mesh)


def test_dryrun_multichip_on_four_cpu_devices():
    """The ep x dp ensemble step, the batched dp step and the tp x dp step of
    the reference's _dryrun_impl, with its asserts, on the CPU listed 4 times."""
    out = dryrun_multichip(4, devices=["cpu"] * 4)
    assert out["ensemble_losses"].shape == (4,) and np.isfinite(out["ensemble_losses"]).all()
    assert out["batch_losses"].shape == (2, 4) and np.isfinite(out["batch_losses"]).all()
    assert np.isfinite(out["tp_loss"])
    assert out["grid_shards"] == [(4000, 32), (4000, 32)]
