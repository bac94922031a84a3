"""The port's row gather and row scatter-add (plain versions and CPU
wrappers) against numpy, the TPU experiments' own references and the JAX
voxel field's gather with its VJP."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_prv_tpu.nerf import voxelfield as jvf
from nerf_prv_tpu_torch.nerf import voxelfield as tvf
from nerf_prv_tpu_torch.ops.row_gather import row_gather, row_gather_plain
from nerf_prv_tpu_torch.ops.row_scatter_add import row_scatter_add, row_scatter_add_plain

# one thread for PyTorch: the tests' tensors are tiny, and several test workers on
# a few cores otherwise spend their time contending for them (minutes, not seconds)
torch.set_num_threads(1)

R, W = 1000, 64
# a row receives at most a few dozen f32 updates of magnitude <= 1 here;
# numpy's add.at and index_add_ sum them in other orders
SUM_TOL = 1e-5


def _table(dtype, seed=0, rows=R, width=W):
    t = np.random.default_rng(seed).uniform(-1, 1, size=(rows, width)).astype(np.float32)
    return torch.from_numpy(t).to(dtype)


def _idx(n, seed=1, rows=R, dtype=np.int32, clustered=False):
    rng = np.random.default_rng(seed)
    if clustered:  # ray-ordered: runs of equal rows
        return np.repeat(rng.integers(0, rows, size=n // 6 + 1), 6)[:n].astype(dtype)
    return rng.integers(0, rows, size=n).astype(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64], ids=["i32", "i64"])
@pytest.mark.parametrize("width", [64, 8])
def test_row_gather_equals_numpy_take(dtype, idx_dtype, width):
    table = _table(dtype, width=width)
    idx = _idx(4099, dtype=idx_dtype)
    want = table.float().numpy()[idx]
    for fn in (row_gather_plain, row_gather):
        got = fn(table, torch.from_numpy(idx))
        assert got.dtype == dtype and got.shape == (4099, width)
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("clustered", [False, True], ids=["uniform", "ray_ordered"])
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64], ids=["i32", "i64"])
def test_row_scatter_add_matches_numpy_add_at(clustered, idx_dtype):
    n = 8192
    idx = _idx(n, dtype=idx_dtype, clustered=clustered)
    upd = np.random.default_rng(2).uniform(-1, 1, size=(n, W)).astype(np.float32)
    want = np.zeros((R, W), np.float32)
    np.add.at(want, idx, upd)  # the experiments' own reference
    for fn in (row_scatter_add_plain, row_scatter_add):
        got = fn(torch.from_numpy(idx), torch.from_numpy(upd), R)
        assert got.dtype == torch.float32 and got.shape == (R, W)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SUM_TOL)


def test_cpu_wrappers_launch_no_kernel_and_take_empty_input():
    g0, s0 = row_gather.launches, row_scatter_add.launches
    table = _table(torch.float32)
    empty = torch.zeros((0,), dtype=torch.int32)
    assert row_gather(table, empty).shape == (0, W)
    out = row_scatter_add(empty, torch.zeros((0, W)), R)
    assert out.shape == (R, W) and float(out.abs().max()) == 0.0
    row_gather(table, torch.from_numpy(_idx(10)))
    assert (row_gather.launches, row_scatter_add.launches) == (g0, s0)


@pytest.mark.parametrize(
    "table,idx,match",
    [
        (torch.zeros((4, 8), dtype=torch.float64), torch.zeros(2, dtype=torch.int32), "float32 or bfloat16"),
        (torch.zeros((4, 8)), torch.zeros(2, dtype=torch.int16), "int32 or int64"),
        (torch.zeros((4, 6)), torch.zeros(2, dtype=torch.int32), "multiple of 4"),
        (torch.zeros((4, 8, 2)), torch.zeros(2, dtype=torch.int32), r"\(R, W\)"),
        (torch.zeros((8, 4)).T, torch.zeros(2, dtype=torch.int32), "contiguous"),
    ],
    ids=["dtype", "index_dtype", "width", "rank", "strided"],
)
def test_row_gather_rejects(table, idx, match):
    with pytest.raises(ValueError, match=match):
        row_gather(table, idx)


@pytest.mark.parametrize(
    "idx,upd,n_rows,match",
    [
        (torch.zeros(2, dtype=torch.int32), torch.zeros((2, 8), dtype=torch.bfloat16), 4, "float32"),
        (torch.zeros(2, dtype=torch.int16), torch.zeros((2, 8)), 4, "int32 or int64"),
        (torch.zeros(3, dtype=torch.int32), torch.zeros((2, 8)), 4, r"\(N, W\)"),
        (torch.zeros(2, dtype=torch.int32), torch.zeros((2, 6)), 4, "multiple of 4"),
        (torch.zeros(2, dtype=torch.int32), torch.zeros((2, 8)), 0, "n_rows"),
        (torch.zeros(2, dtype=torch.int32), torch.zeros((8, 2)).T, 4, "contiguous"),
    ],
    ids=["dtype", "index_dtype", "length", "width", "rows", "strided"],
)
def test_row_scatter_add_rejects(idx, upd, n_rows, match):
    with pytest.raises(ValueError, match=match):
        row_scatter_add(idx, upd, n_rows)


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_gather_function_matches_jax_gather_and_vjp(bf16):
    """``_GatherRows`` against ``_gather_rows_bf16`` (or plain indexing) and
    its VJP: bit-equal rows; the scatter-add of the same cotangents within
    the summation tolerance."""
    grid = _table(torch.float32, seed=3).numpy()
    idx = _idx(4096, seed=4, clustered=True)
    cot = np.random.default_rng(5).uniform(-1, 1, size=(4096, W)).astype(np.float32)
    if bf16:
        rows_j, vjp = jax.vjp(lambda g: jvf._gather_rows_bf16(g, jnp.asarray(idx)), jnp.asarray(grid))
        (dgrid_j,) = vjp(jnp.asarray(cot).astype(jnp.bfloat16))
    else:
        rows_j, vjp = jax.vjp(lambda g: g[jnp.asarray(idx)], jnp.asarray(grid))
        (dgrid_j,) = vjp(jnp.asarray(cot))
    tg = torch.from_numpy(grid).requires_grad_(True)
    rows_t = tvf._GatherRows.apply(tg, torch.from_numpy(idx), bf16)
    assert rows_t.dtype == (torch.bfloat16 if bf16 else torch.float32)
    np.testing.assert_array_equal(rows_t.detach().float().numpy(), np.asarray(rows_j, np.float32))
    # the cotangent reaches the backward in the rows' dtype, as in JAX
    rows_t.backward(torch.from_numpy(cot).to(rows_t.dtype))
    assert tg.grad.dtype == torch.float32
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(dgrid_j), rtol=0, atol=SUM_TOL)
