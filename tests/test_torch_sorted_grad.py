"""The port's hash-table gradient (the plain version of the backward kernel)
against the JAX package's sort-based custom VJP.

The CUDA kernel is held against this plain version and a float64 sum on the
card by tests/test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_prv_tpu.nerf import hashgrid as jhg
from nerf_prv_tpu.ops import sorted_grad as jsg
from nerf_prv_tpu_torch.nerf import hashgrid as thg
from nerf_prv_tpu_torch.nerf import model as tm
from nerf_prv_tpu_torch.ops import encode_fused, encode_sorted, hash_encode_backward
from nerf_prv_tpu_torch.ops import sorted_grad as tsg

# one thread for PyTorch: the tests' tensors are tiny, and several test workers on
# a few cores otherwise spend their time contending for them (minutes, not seconds)
torch.set_num_threads(1)

SMALL = dict(levels=4, features=2, log2_table=12, n_min=4, n_max=64)
DEFAULT = dict(levels=16, features=2, log2_table=19, n_min=16, n_max=2048)
WIDE = dict(levels=3, features=4, log2_table=9, n_min=2, n_max=40)

# Table gradients, as a share of the largest entry.  tests/test_ops.py holds
# the JAX functions to each other at rtol 2e-3 / atol 2e-4; here both sides
# sum the same f32 updates, in orders of their own (run totals taken as
# differences of one long f32 cumsum), and measure 0.9e-6 to 2.1e-6 apart
# over the three configs.  2e-5 leaves room for another XLA or PyTorch
# build's summation order.
GRAD_TOL = 2e-5


def _inputs(cfg_kw, n, seed=0):
    rng = np.random.default_rng(seed)
    rows = cfg_kw["levels"] << cfg_kw["log2_table"]
    table = rng.uniform(-1, 1, size=(rows, cfg_kw["features"])).astype(np.float32)
    x = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    x[:3] = [[0.0, 0.0, 0.0], [1 - 1e-6] * 3, [1.0, 1.0, 1.0]]  # boundary samples
    x[3:40] = x[3]  # duplicate-heavy: one cell takes 37 points on every level
    ct = rng.normal(size=(n, cfg_kw["levels"] * cfg_kw["features"])).astype(np.float32)
    return table, x, ct


@pytest.mark.parametrize("m,rows,f", [(500, 40, 2), (37, 1000, 4), (1, 3, 1), (0, 5, 2)])
def test_segmented_scatter_add_matches_jax_and_a_dense_sum(m, rows, f):
    """Rows that receive many updates, one, and none (most of them in the
    second case).  Tolerance: f32 sums of at most 500 terms of magnitude
    <= 1 taken through a cumsum; measured 2e-6."""
    rng = np.random.default_rng(m)
    idx = rng.integers(0, rows, size=m).astype(np.int32)
    upd = rng.uniform(-1, 1, size=(m, f)).astype(np.float32)
    dense = np.zeros((rows, f), np.float64)
    np.add.at(dense, idx, upd.astype(np.float64))
    got = tsg.segmented_scatter_add(torch.from_numpy(idx), torch.from_numpy(upd), rows)
    assert got.shape == (rows, f) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), dense, rtol=0, atol=1e-5)
    untouched = np.ones(rows, bool)
    untouched[idx] = False
    assert (got.numpy()[untouched] == 0).all()
    if m:
        want = np.asarray(jsg.segmented_scatter_add(jnp.asarray(idx), jnp.asarray(upd), rows))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("cfg_kw", [SMALL, DEFAULT], ids=["small", "default"])
def test_levelwise_indices_and_weights_match_jax(cfg_kw):
    _, x, _ = _inputs(cfg_kw, 200)
    idx_j, w_j = jsg._levelwise_indices_weights(jnp.asarray(x), jhg.HashGridConfig(**cfg_kw))
    idx_t, w_t = tsg._levelwise_indices_weights(torch.from_numpy(x), thg.HashGridConfig(**cfg_kw))
    assert idx_t.shape == w_t.shape == (cfg_kw["levels"], 200, 8)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(w_t.sum(-1).numpy(), 1.0, rtol=0, atol=1e-5)


def _jax_table_grad(cfg_kw, table, x, ct):
    jcfg = jhg.HashGridConfig(**cfg_kw)
    loss = lambda t: jnp.sum(jsg.encode_sorted(t, jnp.asarray(x), jcfg) * jnp.asarray(ct))  # noqa: E731
    return np.asarray(jax.grad(loss)(jnp.asarray(table)))


@pytest.mark.parametrize("impl", ["fused", "sorted", "xla", "auto"])
@pytest.mark.parametrize("cfg_kw", [SMALL, DEFAULT, WIDE], ids=["small", "default", "wide"])
def test_table_gradient_matches_jax_encode_sorted(cfg_kw, impl):
    """The same table, points and cotangent through ``jax.grad`` of the
    reference's ``encode_sorted`` and through each of the port's encode
    paths (on the CPU "fused" takes the plain version of both kernels); at
    the default config level 14 is hashed although (res+1)^3 overflows
    int32."""
    table, x, ct = _inputs(cfg_kw, 300)
    want = _jax_table_grad(cfg_kw, table, x, ct)
    cfg = tm.NerfConfig(grid=thg.HashGridConfig(**cfg_kw), field_impl="hash", encode_impl=impl)
    t = torch.from_numpy(table).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm._encode(t, xt, cfg)
    (out * torch.from_numpy(ct)).sum().backward()
    scale = np.abs(want).max()
    assert scale > 1.0
    assert np.abs(t.grad.numpy() - want).max() <= GRAD_TOL * scale
    if impl in ("fused", "sorted"):
        assert xt.grad is None  # positions are not differentiable, as in the reference


def test_hash_encode_backward_plain_version_matches_jax_bwd():
    table, x, ct = _inputs(SMALL, 257, seed=3)
    d_table, d_x = jsg._bwd(jhg.HashGridConfig(**SMALL), jnp.asarray(x), jnp.asarray(ct))
    got = hash_encode_backward(torch.from_numpy(x), torch.from_numpy(ct), thg.HashGridConfig(**SMALL))
    assert got.shape == table.shape and float(jnp.abs(d_x).max()) == 0.0
    scale = float(np.abs(np.asarray(d_table)).max())
    assert np.abs(got.numpy() - np.asarray(d_table)).max() <= GRAD_TOL * scale
    assert torch.equal(got, tsg.table_grad_sorted(torch.from_numpy(x), torch.from_numpy(ct), thg.HashGridConfig(**SMALL)))


CFG = thg.HashGridConfig(levels=2, features=2, log2_table=8, n_min=4, n_max=16)


@pytest.mark.parametrize(
    "x,g",
    [
        (torch.zeros(4, 3, dtype=torch.float64), torch.zeros(4, 4)),  # dtype
        (torch.zeros(4, 3), torch.zeros(4, 4, dtype=torch.bfloat16)),  # dtype
        (torch.zeros(4, 2), torch.zeros(4, 4)),  # x shape
        (torch.zeros(4, 3), torch.zeros(4, 6)),  # g width
        (torch.zeros(4, 3), torch.zeros(5, 4)),  # g rows
        (torch.zeros(4, 3), torch.zeros(4, 4).t().contiguous().t()),  # non-contiguous
    ],
)
def test_backward_wrapper_rejects_what_the_kernel_does_not_take(x, g):
    before = hash_encode_backward.launches
    with pytest.raises(ValueError):
        hash_encode_backward(x, g, CFG)
    assert hash_encode_backward.launches == before


def test_backward_wrapper_empty_input_and_launch_count_on_the_cpu():
    before = hash_encode_backward.launches
    out = hash_encode_backward(torch.zeros(0, 3), torch.zeros(0, 4), CFG)
    assert out.shape == (512, 2) and float(out.abs().max()) == 0.0
    t = torch.zeros(512, 2, requires_grad=True)
    encode_fused(t, torch.rand(8, 3), CFG).sum().backward()
    encode_sorted(t, torch.rand(8, 3), CFG).sum().backward()
    assert t.grad.shape == (512, 2) and float(t.grad.sum()) == pytest.approx(2 * 8 * 4, rel=1e-5)
    assert hash_encode_backward.launches == before  # the CPU launches no kernel
