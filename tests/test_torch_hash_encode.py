"""The port's hash encode (K1's module) against the JAX package.

The plain version runs here on the CPU; the CUDA kernel is held against it
on the card by tests/test_torch_cuda_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_prv_tpu.nerf import hashgrid as jhg
from nerf_prv_tpu.ops import hash_encode_pallas
from nerf_prv_tpu_torch.nerf import hashgrid as thg
from nerf_prv_tpu_torch.ops import encode_fused, hash_encode

TOL = 1e-5  # f32 trilinear blend of table values in [-1, 1]

# the small configs of tests/test_ops.py (dense + hashed levels), with
# N not a multiple of the Pallas block
SMALL = [
    (dict(levels=4, features=2, log2_table=12, n_min=4, n_max=64), 256, 64),
    (dict(levels=3, features=2, log2_table=10, n_min=16, n_max=64), 200, 64),
    (dict(levels=2, features=2, log2_table=10, n_min=16, n_max=32), 33, 32),
    (dict(levels=3, features=4, log2_table=9, n_min=2, n_max=40), 77, 32),
]


def _inputs(cfg_kw, n, seed=0):
    rng = np.random.default_rng(seed)
    levels, f = cfg_kw["levels"], cfg_kw["features"]
    table = rng.uniform(-1, 1, size=(levels << cfg_kw["log2_table"], f)).astype(np.float32)
    x = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    x[:3] = [[0.0, 0.0, 0.0], [1 - 1e-6] * 3, [1.0, 1.0, 1.0]]  # boundary samples
    return table, x


@pytest.mark.parametrize("cfg_kw,n,block", SMALL)
def test_plain_encode_matches_jax_and_pallas_interpret(cfg_kw, n, block):
    table, x = _inputs(cfg_kw, n)
    jcfg = jhg.HashGridConfig(**cfg_kw)
    want = np.asarray(jhg.encode(jnp.asarray(table), jnp.asarray(x), jcfg))
    pallas = np.asarray(
        hash_encode_pallas(jnp.asarray(table), jnp.asarray(x), jcfg, block=block, interpret=True)
    )
    got = thg.encode(torch.from_numpy(table), torch.from_numpy(x), thg.HashGridConfig(**cfg_kw))
    assert got.shape == (n, jcfg.out_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=TOL)


def test_plain_encode_matches_jax_at_default_config():
    """Full default config, level 14 included: there (res+1)^3 overflows
    int32, so the reference is hashgrid.encode, not the Pallas kernel."""
    cfg_kw = dict(levels=16, features=2, log2_table=19, n_min=16, n_max=2048)
    table, x = _inputs(cfg_kw, 300, seed=1)
    jcfg = jhg.HashGridConfig()
    assert (int(jcfg.resolutions()[14]) + 1) ** 3 > 2**31 - 1
    want = np.asarray(jhg.encode(jnp.asarray(table), jnp.asarray(x), jcfg))
    got = thg.encode(torch.from_numpy(table), torch.from_numpy(x), thg.HashGridConfig())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    wrapped = hash_encode(torch.from_numpy(table), torch.from_numpy(x), thg.HashGridConfig())
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())


def test_hashgrid_config_and_dense_choice_match_jax():
    for kw in [{}] + [c for c, _, _ in SMALL]:
        j, t = jhg.HashGridConfig(**kw), thg.HashGridConfig(**kw)
        np.testing.assert_array_equal(j.resolutions(), t.resolutions())
        assert (j.table_size, j.out_dim) == (t.table_size, t.out_dim)
        for r in t.resolutions():
            assert thg.is_dense(r, t.table_size) == ((int(r) + 1) ** 3 <= j.table_size)


def test_corner_indices_match_jax_uint32_hash():
    rng = np.random.default_rng(3)
    cells = rng.integers(0, 2049, size=(500, 3)).astype(np.int32)
    for res, t in ((2047, 1 << 19), (1482, 1 << 19), (7, 1 << 12)):
        want = np.asarray(jhg._corner_indices(jnp.asarray(cells), res, t))
        got = thg._corner_indices(torch.from_numpy(cells).long(), res, t)
        np.testing.assert_array_equal(got.numpy(), want)


def test_init_table_shape_and_range():
    cfg = thg.HashGridConfig(levels=2, log2_table=8)
    g = torch.Generator().manual_seed(0)
    table = thg.init_table(g, cfg, scale=0.5, device="cpu")
    assert table.shape == (2 * 256, 2) and table.dtype == torch.float32
    assert float(table.abs().max()) <= 0.5


CFG = thg.HashGridConfig(levels=2, features=2, log2_table=8, n_min=4, n_max=16)


@pytest.mark.parametrize(
    "table,x",
    [
        (torch.zeros(512, 2), torch.zeros(4, 3, dtype=torch.float64)),  # dtype
        (torch.zeros(512, 2, dtype=torch.bfloat16), torch.zeros(4, 3)),  # dtype
        (torch.zeros(512, 2), torch.zeros(4, 2)),  # x shape
        (torch.zeros(512, 3), torch.zeros(4, 3)),  # table shape
        (torch.zeros(2, 512).t(), torch.zeros(4, 3)),  # non-contiguous
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(table, x):
    with pytest.raises(ValueError):
        hash_encode(table, x, CFG)


def test_wrapper_rejects_unsupported_feature_count():
    cfg = thg.HashGridConfig(levels=2, features=3, log2_table=8, n_min=4, n_max=16)
    with pytest.raises(ValueError, match="features"):
        hash_encode(torch.zeros(512, 3), torch.zeros(4, 3), cfg)


def test_wrapper_empty_input():
    out = hash_encode(torch.zeros(512, 2), torch.zeros(0, 3), CFG)
    assert out.shape == (0, CFG.out_dim)


def test_encode_fused_is_forward_only():
    table = torch.zeros(512, 2, requires_grad=True)
    x = torch.rand(8, 3)
    with pytest.raises(NotImplementedError):
        encode_fused(table, x, CFG)
    with torch.no_grad():
        assert encode_fused(table, x, CFG).shape == (8, 4)
