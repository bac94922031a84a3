"""The port's hash encode (K1's module) against the JAX package.

The plain version runs here on the CPU; the CUDA kernel is held against it
on the card by tests/test_torch_cuda_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from nerf_prv_tpu.nerf import hashgrid as jhg
from nerf_prv_tpu.ops import hash_encode_pallas
from nerf_prv_tpu_torch.nerf import hashgrid as thg
from nerf_prv_tpu_torch.ops import encode_fused, hash_encode
from nerf_prv_tpu_torch.ops.hash_encode import _level_arrays, level_plan

# one thread for PyTorch: the tests' tensors are tiny, and several test workers on
# a few cores otherwise spend their time contending for them (minutes, not seconds)
torch.set_num_threads(1)

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


def test_encode_fused_has_a_table_gradient_and_none_for_positions():
    """Forward equal to the plain encode; the table's gradient equal to
    autograd's through the plain encode (8 points, one f32 sum order apart:
    1e-6); positions get none."""
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.uniform(-1, 1, size=(512, 2)).astype(np.float32))
    x = torch.rand(8, 3, generator=torch.Generator().manual_seed(0))
    grads = []
    for fn in (encode_fused, thg.encode):
        t = table.clone().requires_grad_(True)
        xg = x.clone().requires_grad_(True)
        out = fn(t, xg, CFG)
        assert out.shape == (8, 4) and out.requires_grad
        (out * out).sum().backward()
        grads.append((t.grad, xg.grad))
    np.testing.assert_allclose(grads[0][0].numpy(), grads[1][0].numpy(), rtol=0, atol=1e-6)
    assert grads[0][1] is None and grads[1][1] is not None
    with torch.no_grad():
        assert torch.equal(encode_fused(table, x, CFG), thg.encode(table, x, CFG))


# ---- the arithmetic the kernel's lane pairs lean on: the even lane of a pair
# reads the four corners at cx, the odd lane the four at cx + 1


@settings(max_examples=60, deadline=None, database=None)
@given(
    log2_table=st.integers(min_value=1, max_value=31),
    seed=st.integers(min_value=0, max_value=2**31 - 1),
)
def test_hashed_x_neighbour_of_an_even_cell_is_the_index_xor_1(log2_table, seed):
    """The hash multiplies x by 1, so for even cx the rows of (cx, cy, cz) and
    (cx + 1, cy, cz) differ in bit 0 only, for every power-of-two table: the
    two lanes of a pair then read one aligned pair of rows.  Exact
    (integers); also equal to the JAX package's uint32 hash where its int32
    result can hold the index."""
    table_size = 1 << log2_table
    res = 1 << 21  # (res + 1)^3 > 2^31: hashed for every table size
    assert not thg.is_dense(res, table_size)
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, res, size=(64, 3))
    cells[:, 0] &= ~1  # even cx
    cells[0] = [0, 0, 0]
    cells[1] = [res - 2, res, res]
    here = thg._corner_indices(torch.from_numpy(cells), res, table_size)
    beside = thg._corner_indices(torch.from_numpy(cells + [1, 0, 0]), res, table_size)
    np.testing.assert_array_equal(beside.numpy(), here.numpy() ^ 1)
    assert int(here.min()) >= 0 and int(here.max()) < table_size
    if log2_table <= 30:
        want = np.asarray(jhg._corner_indices(jnp.asarray(cells.astype(np.int32)), res, table_size))
        np.testing.assert_array_equal(here.numpy(), want)


@settings(max_examples=30, deadline=None, database=None)
@given(res=st.integers(min_value=1, max_value=79), seed=st.integers(min_value=0, max_value=2**31 - 1))
def test_dense_x_neighbour_is_the_next_row(res, seed):
    """On a dense level the x-neighbour is row idx + 1, which shares an
    aligned pair with idx exactly when idx is even.  Exact (integers)."""
    table_size = 1 << 19
    assert thg.is_dense(res, table_size)
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, res, size=(64, 3))  # cx + 1 <= res stays a grid point
    here = thg._corner_indices(torch.from_numpy(cells), res, table_size)
    beside = thg._corner_indices(torch.from_numpy(cells + [1, 0, 0]), res, table_size)
    np.testing.assert_array_equal(beside.numpy(), here.numpy() + 1)
    np.testing.assert_array_equal(((here ^ beside) == 1).numpy(), (here % 2 == 0).numpy())
    assert int(beside.max()) < (res + 1) ** 3


def encode_as_kernel(table, x, cfg, stats=None):
    """``hashgrid.encode`` computed the way the CUDA kernel computes it: the
    per-level plan from the wrapper's ``level_plan``; a lane pair's group of
    8 / F levels filling one 8-float sector of the output row; the even lane
    blending the four corners at cx in (j, k) order, the odd lane the four at
    cx + 1, and the two halves added.  ``stats`` collects, per level and
    (j, k), the share of lane pairs whose two rows are one aligned pair and
    the share whose rows lie in one 128-byte line."""
    res_list, dense = level_plan(cfg)
    f, t = cfg.features, cfg.table_size
    per_pair = 8 // f
    rows_per_line = 128 // (4 * f)
    sectors = []
    for first in range(0, cfg.levels, per_pair):
        sector = []
        for level in range(first, min(first + per_pair, cfg.levels)):
            res = res_list[level]
            assert bool(dense[level]) == thg.is_dense(res, t)
            level_table = table[level * t : (level + 1) * t]
            pos = x * float(res)
            cell = torch.clamp(torch.floor(pos), 0, res - 1)
            frac = pos - cell
            cell = cell.to(torch.int64)
            halves, rows = [], []
            for di in (0, 1):  # the lane
                wx = frac[:, 0] if di else 1.0 - frac[:, 0]
                acc = torch.zeros((x.shape[0], f), dtype=table.dtype)
                for jk in range(4):
                    dj, dk = jk >> 1, jk & 1
                    idx = thg._corner_indices(cell + torch.tensor([di, dj, dk]), res, t)
                    wy = frac[:, 1] if dj else 1.0 - frac[:, 1]
                    wz = frac[:, 2] if dk else 1.0 - frac[:, 2]
                    acc = acc + level_table[idx] * (wx * wy * wz)[:, None]
                    rows.append(idx)
                halves.append(acc)
            sector.append(halves[0] + halves[1])
            if stats is not None:
                for jk in range(4):
                    i0, i1 = rows[jk], rows[4 + jk]
                    stats.append((float(((i0 ^ i1) == 1).float().mean()),
                                  float((i0 // rows_per_line == i1 // rows_per_line).float().mean())))
        sectors.append(torch.cat(sector, dim=-1))
    return torch.cat(sectors, dim=-1)


def _boundary_points():
    edge = [0.0, 1.0 - 1e-6, 1.0]
    return np.array([[a, b, c] for a in edge for b in edge for c in edge], dtype=np.float32)


@pytest.mark.parametrize(
    "cfg_kw",
    [
        dict(levels=16, features=2, log2_table=19, n_min=16, n_max=2048),  # the default
        dict(levels=16, features=2, log2_table=14, n_min=16, n_max=2048),  # more levels hashed
        dict(levels=5, features=1, log2_table=12, n_min=4, n_max=64),  # an incomplete last group
        dict(levels=3, features=4, log2_table=9, n_min=2, n_max=40),  # two levels to a sector
    ],
    ids=["default", "log2_table14", "f1_ragged", "f4"],
)
def test_lane_pairs_in_level_groups_match_plain_encode_and_jax(cfg_kw):
    table, x = _inputs(cfg_kw, 400, seed=5)
    x[:27] = _boundary_points()  # 0, 1 - 1e-6 and 1 on every axis
    cfg = thg.HashGridConfig(**cfg_kw)
    stats = []
    got = encode_as_kernel(torch.from_numpy(table), torch.from_numpy(x), cfg, stats)
    want = thg.encode(torch.from_numpy(table), torch.from_numpy(x), cfg)
    # the same eight products, added as two sums of four: a few f32 roundings
    # of values below 1 apart (measured 1.2e-7)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    ref = np.asarray(jhg.encode(jnp.asarray(table), jnp.asarray(x), jhg.HashGridConfig(**cfg_kw)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL)
    pair_share, line_share = np.mean(stats, axis=0)
    # about every other cell has an even cx (or an even dense index) ...
    assert 0.35 <= pair_share <= 0.65
    # ... and an odd cx leaves the line only when its carry passes the
    # line's rows: two lanes' rows share a 128-byte line far more often than not
    assert line_share >= 0.85


def test_level_plan_is_the_python_integer_dense_test():
    cfg = thg.HashGridConfig()
    res, dense = level_plan(cfg)
    assert res == [int(r) for r in jhg.HashGridConfig().resolutions()]
    assert dense == [int((r + 1) ** 3 <= cfg.table_size) for r in res]
    assert dense == [1] * 5 + [0] * 11  # levels 14 and 15 overflow 32 bits and stay hashed
    res_arr, dense_arr = _level_arrays(cfg)
    assert (list(res_arr), list(dense_arr)) == (res, dense)
    assert _level_arrays(thg.HashGridConfig()) is _level_arrays(cfg)  # made once per config
