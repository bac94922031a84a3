"""The port's CUDA kernels against their plain versions, on the card.

Imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Without a CUDA card every test skips: a CUDA kernel has no CPU mode.
"""

import numpy as np
import pytest
import torch

from nerf_prv_tpu_torch.nerf.hashgrid import HashGridConfig, encode
from nerf_prv_tpu_torch.ops.fused import encode_fused
from nerf_prv_tpu_torch.ops.hash_encode import hash_encode, hash_encode_backward
from nerf_prv_tpu_torch.ops.row_gather import row_gather, row_gather_plain
from nerf_prv_tpu_torch.ops.row_scatter_add import row_scatter_add, row_scatter_add_plain
from nerf_prv_tpu_torch.ops.sorted_grad import _levelwise_indices_weights, table_grad_sorted

TOL = 1e-5  # f32 trilinear blend of table values in [-1, 1]; FMA vs mul+add


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(cfg, n, seed, dev):
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, size=(cfg.levels * cfg.table_size, cfg.features))
    x = rng.uniform(0, 1, size=(n, 3))
    x[:3] = [[0.0, 0.0, 0.0], [1 - 1e-6] * 3, [1.0, 1.0, 1.0]]
    as_t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    return as_t(table), as_t(x)


def _points(n, order, seed, dev):
    """(n, 3) points in the unit cube: uniform, or ray by ray (32 samples
    along a short chord each, as a march hands them over); the cube's
    boundaries come first either way."""
    rng = np.random.default_rng(seed)
    if order == "uniform":
        x = rng.uniform(0, 1, size=(n, 3))
    else:
        rays = -(-n // 32)
        o = rng.uniform(0.2, 0.8, size=(rays, 1, 3))
        d = rng.normal(size=(rays, 1, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        t = (np.arange(32) + 0.5)[None, :, None] * (rng.uniform(0.002, 0.02, size=(rays, 1, 1)))
        x = np.clip(o + d * t, 0.0, 1.0 - 1e-6).reshape(-1, 3)[:n]
    edge = np.array([[0.0, 0.0, 0.0], [1 - 1e-6] * 3, [1.0, 1.0, 1.0], [0.0, 1.0, 1 - 1e-6], [1.0, 0.5, 0.0]])
    x[: min(n, 5)] = edge[: min(n, 5)]
    return torch.from_numpy(x.astype(np.float32)).to(dev)


@pytest.mark.parametrize("order", ["uniform", "ray_ordered"])
@pytest.mark.parametrize("n", [1, 255, 524_288 + 37])
@pytest.mark.parametrize("log2_table", [14, 19])
@pytest.mark.parametrize("levels", [1, 5, 16])
@pytest.mark.parametrize("features", [1, 2, 4, 8])
def test_hash_encode_kernel_matches_plain(cuda_device, features, levels, log2_table, n, order):
    """Every feature width, whole and incomplete level groups, output rows
    that are and are not whole 16-byte vectors, dense-only and mostly hashed
    grids, one block and thousands, against ``hashgrid.encode`` level by
    level (tolerance: a f32 blend of 8 values in [-1, 1], FMA vs mul+add)."""
    cfg = HashGridConfig(levels=levels, features=features, log2_table=log2_table)
    g = torch.Generator(device=cuda_device).manual_seed(features * 100 + levels)
    table = torch.rand((levels * cfg.table_size, features), generator=g, device=cuda_device) * 2.0 - 1.0
    x = _points(n, order, seed=levels, dev=cuda_device)
    before = hash_encode.launches
    got = hash_encode(table, x, cfg)
    torch.cuda.synchronize()
    assert hash_encode.launches == before + 1
    want = encode(table, x, cfg)
    assert got.shape == want.shape == (n, cfg.out_dim)
    assert bool(torch.isfinite(got).all())
    err = (got - want).abs().reshape(n, levels, features).amax(dim=(0, 2))
    assert float(err.max()) <= TOL, err.tolist()


def test_hash_encode_kernel_small_grid(cuda_device):
    """A grid whose levels are all dense or barely hashed (n_min 4)."""
    cfg = HashGridConfig(levels=4, log2_table=12, n_min=4, n_max=64)
    table, x = _inputs(cfg, 33, seed=2, dev=cuda_device)
    got = hash_encode(table, x, cfg)
    torch.cuda.synchronize()
    assert float((got - encode(table, x, cfg)).abs().max()) <= TOL


def test_hash_encode_kernel_rejects_unaligned_and_strided_inputs(cuda_device):
    cfg = HashGridConfig(levels=2, log2_table=8, n_min=4, n_max=16)
    table, x = _inputs(cfg, 64, seed=0, dev=cuda_device)
    shifted = torch.zeros(table.numel() + 2, device=cuda_device)[2:].view(table.shape)  # 8 bytes off
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 8
    before = hash_encode.launches
    with pytest.raises(ValueError, match="aligned"):
        hash_encode(shifted, x, cfg)
    strided = x.t().contiguous().t()  # (N, 3) with the points along the fast axis
    assert strided.shape == x.shape and not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        hash_encode(table, strided, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        hash_encode(table.repeat(1, 2)[:, ::2], x, cfg)
    assert hash_encode.launches == before


def test_hash_encode_kernel_empty_input_launches_nothing(cuda_device):
    cfg = HashGridConfig(levels=2, log2_table=8, n_min=4, n_max=16)
    table, _ = _inputs(cfg, 3, seed=0, dev=cuda_device)
    before = hash_encode.launches
    out = hash_encode(table, torch.zeros((0, 3), device=cuda_device), cfg)
    assert out.shape == (0, cfg.out_dim) and hash_encode.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("width", [64, 8, 4])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64], ids=["i32", "i64"])
def test_row_gather_kernel_equals_plain(cuda_device, dtype, width, idx_dtype):
    rng = np.random.default_rng(width)
    table = torch.from_numpy(rng.uniform(-1, 1, size=(1000, width)).astype(np.float32)).to(cuda_device, dtype)
    idx = torch.from_numpy(rng.integers(0, 1000, size=4099)).to(cuda_device, idx_dtype)
    before = row_gather.launches
    got = row_gather(table, idx)
    torch.cuda.synchronize()
    assert row_gather.launches == before + 1
    assert got.dtype == dtype and torch.equal(got, row_gather_plain(table, idx))


@pytest.mark.parametrize("clustered", [False, True], ids=["uniform", "ray_ordered"])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64], ids=["i32", "i64"])
def test_row_scatter_add_kernel_matches_float64_sum(cuda_device, clustered, idx_dtype):
    rng = np.random.default_rng(3)
    n, rows, width = 20011, 500, 64
    idx_np = np.repeat(rng.integers(0, rows, size=n // 6 + 1), 6)[:n] if clustered else rng.integers(0, rows, size=n)
    idx = torch.from_numpy(idx_np).to(cuda_device, idx_dtype)
    upd = torch.from_numpy(rng.uniform(-1, 1, size=(n, width)).astype(np.float32)).to(cuda_device)
    before = row_scatter_add.launches
    got = row_scatter_add(idx, upd, rows)
    torch.cuda.synchronize()
    assert row_scatter_add.launches == before + 1
    want = torch.zeros((rows, width), dtype=torch.float64, device=cuda_device)
    want.index_add_(0, idx.long(), upd.double())
    # a row sums ~40 (up to ~100) f32 terms of magnitude <= 1, in an order
    # the atomics choose: k * 2^-24 * sum|terms| stays below 1e-4
    assert float((got.double() - want).abs().max()) <= 1e-4
    assert float((got - row_scatter_add_plain(idx, upd, rows)).abs().max()) <= 2e-4


def test_row_kernels_empty_input_launches_nothing(cuda_device):
    table = torch.zeros((10, 8), device=cuda_device)
    empty = torch.zeros((0,), dtype=torch.int32, device=cuda_device)
    g0, s0 = row_gather.launches, row_scatter_add.launches
    assert row_gather(table, empty).shape == (0, 8)
    out = row_scatter_add(empty, torch.zeros((0, 8), device=cuda_device), 10)
    torch.cuda.synchronize()
    assert out.shape == (10, 8) and float(out.abs().max()) == 0.0
    assert (row_gather.launches, row_scatter_add.launches) == (g0, s0)


def test_voxel_gradient_through_kernels_matches_plain(cuda_device):
    """Loss and every gradient of a small voxel field, through the kernels
    on the card against the plain versions on the CPU (f32 compute)."""
    from nerf_prv_tpu_torch.nerf import model as tm

    cfg = tm.NerfConfig(voxel_grid_size=12, compute_dtype=torch.float32)
    p = tm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    p["grid"] *= 1e4
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(0, 1, size=(3000, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(3000, 3)).astype(np.float32)), dim=-1)
    grads = []
    for dev in (cuda_device, "cpu"):
        q = {k: v.to(dev).requires_grad_(True) for k, v in p.items()}
        sigma, rgb = tm.field(q, x.to(dev), d.to(dev), cfg)
        (torch.tanh(sigma)[:, None] * rgb).mean().backward()
        grads.append({k: v.grad.cpu() for k, v in q.items()})
    for k in p:
        scale = float(grads[1][k].abs().max())
        assert scale > 0 and float((grads[0][k] - grads[1][k]).abs().max()) <= 2e-3 * scale, k  # card vs CPU: other exp, sin and matmul rounding; measured 3.1e-4


# --- the hash encode's table gradient ---------------------------------------


def _table_grad_f64(x, g, cfg):
    """(float64 sum, per-element f32 summation bound k * 2^-24 * sum|w g|)
    of the table gradient: a row that receives k updates is k rounded adds,
    each off by at most 2^-24 of a partial sum that never exceeds the row's
    sum of |updates|, in whatever order the atomics ran; one more rounding
    (the product w * g) is covered by the same term."""
    n, f = x.shape[0], cfg.features
    rows = cfg.levels * cfg.table_size
    idx, w = _levelwise_indices_weights(x, cfg)
    upd = (w[..., None].double() * g.reshape(n, cfg.levels, f).permute(1, 0, 2)[:, :, None, :].double()).reshape(-1, f)
    idx = idx.reshape(-1)
    want = torch.zeros((rows, f), dtype=torch.float64, device=x.device).index_add_(0, idx, upd)
    mag = torch.zeros_like(want).index_add_(0, idx, upd.abs())
    count = torch.bincount(idx, minlength=rows).double()[:, None]
    return want, (count + 1) * 2.0 ** -24 * mag


@pytest.mark.parametrize("points", ["uniform", "ray_ordered", "one_cell"])
@pytest.mark.parametrize("n", [1, 255, 20_011])
@pytest.mark.parametrize("log2_table", [12, 19])
@pytest.mark.parametrize("levels", [1, 5, 16])
@pytest.mark.parametrize("features", [1, 2, 4, 8])
def test_hash_encode_backward_kernel_matches_float64_sum(cuda_device, features, levels, log2_table, n, points):
    """Every feature width, whole and incomplete level groups, rows of g that
    are and are not whole 16-byte vectors, dense and hashed levels, N not a
    multiple of the block, and duplicate-heavy points (all in one cell of
    the finest level: every update of a level lands on 8 rows), against a
    float64 sum within the f32 summation bound computed from the data, and
    against the plain sort-based version within that version's own cumsum
    error."""
    cfg = HashGridConfig(levels=levels, features=features, log2_table=log2_table)
    if points == "one_cell":
        rng = np.random.default_rng(n)
        x = torch.from_numpy((0.3 + rng.uniform(0, 1e-4, size=(n, 3))).astype(np.float32)).to(cuda_device)
    else:
        x = _points(n, points, seed=levels, dev=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(features * 100 + levels)
    g = torch.randn((n, cfg.out_dim), generator=gen, device=cuda_device)
    before = hash_encode_backward.launches
    got = hash_encode_backward(x, g, cfg)
    torch.cuda.synchronize()
    assert hash_encode_backward.launches == before + 1
    assert got.shape == (levels * cfg.table_size, features) and got.dtype == torch.float32
    want, tol = _table_grad_f64(x, g, cfg)
    err = (got.double() - want).abs()
    assert bool((err <= tol).all()), float((err - tol).max())
    assert float(got.abs().max()) > 0
    # the plain version takes each run's total as a difference of two
    # entries of one f32 cumsum over all M updates, so it is the looser of
    # the two: off by up to 1.3e-4 of the largest entry at M = 2.6 M on an
    # NVIDIA H100 80GB HBM3; the check holds it to 1e-3
    plain = table_grad_sorted(x, g, cfg)
    assert float((got - plain).abs().max()) <= 1e-3 * float(want.abs().max())


def _design_points(case, dev):
    """Points that reach one branch of the table-gradient kernel each: a
    warp's 32 points in one cell of every level (one run is the whole
    warp); rays of 24 samples after a first one of 8 (every later run
    crosses a warp's edge); rays of 20 samples ending in a last warp of 7
    live lanes; or points whose cell has only even or only odd cx."""
    rng = np.random.default_rng(11)
    if case == "one_run":
        x = 0.3 + rng.uniform(0, 1e-4, size=(32, 3))
    elif case in ("runs_cross_warps", "ragged_last_warp"):
        lengths = [8] + [24] * 40 if case == "runs_cross_warps" else [20] * 8 + [7]
        rays = []
        for k in lengths:  # a chord of 0.01: one cell on the coarse levels
            o = rng.uniform(0.2, 0.8, size=3)
            d = rng.normal(size=3)
            rays.append(o + np.linspace(0.0, 0.01, k)[:, None] * (d / np.linalg.norm(d)))
        x = np.concatenate(rays)
    else:
        res = 15 if case.endswith("dense") else 2048
        x = rng.uniform(0, 1, size=(1000, 3))
        cx = 2 * rng.integers(0, res // 2, size=1000) + (1 if case.startswith("odd") else 0)
        x[:, 0] = (cx + rng.uniform(0.05, 0.95, size=1000)) / res
    return torch.from_numpy(x.astype(np.float32)).to(dev)


@pytest.mark.parametrize(
    "case",
    ["one_run", "runs_cross_warps", "ragged_last_warp", "even_cx_dense", "odd_cx_dense", "even_cx_hashed",
     "odd_cx_hashed"],
)
@pytest.mark.parametrize("features", [1, 2, 4, 8])
def test_hash_encode_backward_kernel_runs_and_x_pairs(cuda_device, features, case):
    """The kernel's runs of equal cells (summed inside a warp before the
    atomics) and its aligned x-pairs (one vector add for F <= 2): a run that
    is a whole warp, runs cut at a warp's edge, a ragged last warp, and a
    dense (res + 1 even, so a row's parity is cx's) and a hashed level whose
    x-corner rows all form aligned pairs (even cx) or none (odd cx).  Held
    against the float64 sum within the f32 summation bound, which holds for
    any order of the adds, pre-sums included."""
    if case.endswith("dense"):
        cfg = HashGridConfig(levels=1, features=features, n_min=15)
    elif case.endswith("hashed"):
        cfg = HashGridConfig(levels=1, features=features, log2_table=12, n_min=2048)
    else:
        cfg = HashGridConfig(features=features)
    x = _design_points(case, cuda_device)
    n = x.shape[0]
    g = torch.randn((n, cfg.out_dim), generator=torch.Generator(device=cuda_device).manual_seed(features),
                    device=cuda_device)
    before = hash_encode_backward.launches
    got = hash_encode_backward(x, g, cfg)
    torch.cuda.synchronize()
    assert hash_encode_backward.launches == before + 1
    want, tol = _table_grad_f64(x, g, cfg)
    err = (got.double() - want).abs()
    assert bool(torch.isfinite(got).all()) and bool((err <= tol).all()), float((err - tol).max())
    assert float(got.abs().max()) > 0


def test_hash_encode_backward_kernel_empty_input_zeroes_and_launches_nothing(cuda_device):
    cfg = HashGridConfig(levels=2, log2_table=8, n_min=4, n_max=16)
    before = hash_encode_backward.launches
    out = hash_encode_backward(torch.zeros((0, 3), device=cuda_device), torch.zeros((0, 4), device=cuda_device), cfg)
    torch.cuda.synchronize()
    assert out.shape == (512, 2) and float(out.abs().max()) == 0.0
    assert hash_encode_backward.launches == before


def test_hash_encode_backward_kernel_rejects_what_it_does_not_take(cuda_device):
    cfg = HashGridConfig(levels=2, log2_table=8, n_min=4, n_max=16)
    x = torch.rand((64, 3), device=cuda_device)
    g = torch.rand((64, 4), device=cuda_device)
    before = hash_encode_backward.launches
    with pytest.raises(ValueError, match="contiguous"):
        hash_encode_backward(x, g.t().contiguous().t(), cfg)
    with pytest.raises(ValueError, match="g must be"):
        hash_encode_backward(x, g[:, :2].contiguous(), cfg)
    with pytest.raises(ValueError, match="float32"):
        hash_encode_backward(x, g.double(), cfg)
    shifted = torch.zeros(g.numel() + 2, device=cuda_device)[2:].view(g.shape)  # 8 bytes off
    with pytest.raises(ValueError, match="aligned"):
        hash_encode_backward(x, shifted, cfg)
    with pytest.raises(ValueError, match="x on"):
        hash_encode_backward(x.cpu(), g, cfg)
    assert hash_encode_backward.launches == before


@pytest.mark.parametrize(
    "cfg",
    [HashGridConfig(levels=4, log2_table=12, n_min=4, n_max=64), HashGridConfig(), HashGridConfig(features=4, levels=6)],
    ids=["small", "default", "f4"],
)
def test_encode_fused_backward_agrees_with_autograd_through_plain_encode(cuda_device, cfg):
    """The table gradient of ``encode_fused`` (K1 forward, atomic table
    gradient backward) against autograd through ``hashgrid.encode`` for the
    same table, points and cotangent; x gets no gradient.  Tolerance: both
    sum f32 updates in orders of their own (a few hundred per row at most),
    measured 1e-6 of the largest entry; 2e-5 leaves room."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    table = (torch.rand((cfg.levels * cfg.table_size, cfg.features), generator=gen, device=cuda_device) * 2 - 1)
    x = _points(3001, "ray_ordered", seed=3, dev=cuda_device).requires_grad_(True)
    ct = torch.randn((3001, cfg.out_dim), generator=gen, device=cuda_device)
    grads = []
    for fn in (encode_fused, encode):
        t = table.clone().requires_grad_(True)
        k1, k1b = hash_encode.launches, hash_encode_backward.launches
        (fn(t, x, cfg) * ct).sum().backward()
        torch.cuda.synchronize()
        launched = (hash_encode.launches - k1, hash_encode_backward.launches - k1b)
        assert launched == ((1, 1) if fn is encode_fused else (0, 0))
        grads.append(t.grad)
        if fn is encode_fused:
            assert x.grad is None
    scale = float(grads[1].abs().max())
    assert scale > 0 and float((grads[0] - grads[1]).abs().max()) <= 2e-5 * scale
