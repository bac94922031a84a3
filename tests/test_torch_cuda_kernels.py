"""The port's CUDA kernels against their plain versions, on the card.

Imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Without a CUDA card every test skips: a CUDA kernel has no CPU mode.
"""

import math

import numpy as np
import pytest
import torch

from nerf_prv_tpu_torch.nerf.hashgrid import HashGridConfig, encode
from nerf_prv_tpu_torch.ops.fused import encode_fused
from nerf_prv_tpu_torch.ops.hash_encode import hash_encode, hash_encode_backward
from nerf_prv_tpu_torch.ops.row_gather import row_gather, row_gather_plain
from nerf_prv_tpu_torch.ops.row_scatter_add import row_scatter_add, row_scatter_add_plain
from nerf_prv_tpu_torch.ops.sorted_grad import _levelwise_indices_weights, table_grad_sorted
from test_torch_kernel_mirrors import BIN_CAMERA, GRIDS, _border_cloud, _rays
from test_torch_kernel_mirrors import _poses as _mirror_poses

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



@pytest.mark.parametrize("k", [1, 4])
def test_row_kernels_on_stacked_grids(cuda_device, k):
    """K grids read as one (K*R, W) bf16 table, each object's indices offset
    by k*R (the batched trainer's gather and scatter-add)."""
    rng = np.random.default_rng(k)
    rows, width, n = 8000, 64, 6007
    table = torch.from_numpy(rng.uniform(-1, 1, size=(k * rows, width)).astype(np.float32)).to(cuda_device)
    table = table.to(torch.bfloat16)
    local = rng.integers(0, rows, size=(k, n))
    idx = torch.from_numpy((local + rows * np.arange(k)[:, None]).reshape(-1)).to(cuda_device, torch.int32)
    got = row_gather(table, idx)
    for i in range(k):
        part = table[i * rows : (i + 1) * rows]
        want = row_gather_plain(part, torch.from_numpy(local[i]).to(cuda_device))
        assert torch.equal(got[i * n : (i + 1) * n], want)
    upd = torch.from_numpy(rng.uniform(-1, 1, size=(k * n, width)).astype(np.float32)).to(cuda_device)
    summed = row_scatter_add(idx, upd, k * rows)
    want = torch.zeros((k * rows, width), dtype=torch.float64, device=cuda_device).index_add_(0, idx.long(), upd.double())
    assert float((summed.double() - want).abs().max()) <= 1e-4  # a row sums a few f32 terms of magnitude <= 1


def test_batched_voxel_step_equals_single_steps(cuda_device):
    """One batched step of three small voxel fields through the kernels (two
    gathers and one scatter-add for all three) against each field's own
    single-object step on the same rays and jitter, f32 compute."""
    from nerf_prv_tpu_torch.nerf import batch_train as tbt
    from nerf_prv_tpu_torch.nerf import model as tm
    from nerf_prv_tpu_torch.nerf import train as ttr

    k, n = 3, 1024
    cfg = tm.NerfConfig(voxel_grid_size=16, compute_dtype=torch.float32)
    params = tbt.init_batched_params(torch.Generator().manual_seed(0), cfg, k, device="cpu")
    params["grid"] *= 1e4
    params = {name: v.to(cuda_device) for name, v in params.items()}
    rng = np.random.default_rng(2)
    o = np.repeat([[0.5, 0.5, 2.0]], k * n, axis=0) + rng.normal(size=(k * n, 3)) * 0.1
    d = rng.uniform(0.2, 0.8, size=(k * n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda_device)  # noqa: E731
    batch = (as_t(o), as_t(d), as_t(rng.uniform(size=(k * n, 3))), as_t(rng.uniform(size=(k * n, 3))))
    jitter = as_t(rng.uniform(size=(k * n, cfg.n_samples)))
    q = {name: v.clone().requires_grad_(True) for name, v in params.items()}
    g0, s0 = row_gather.launches, row_scatter_add.launches
    losses = tbt.batch_loss(q, batch, jitter, cfg)
    losses.sum().backward()
    torch.cuda.synchronize()
    assert (row_gather.launches - g0, row_scatter_add.launches - s0) == (2, 1)
    for i in range(k):
        one = {name: v[i].clone().requires_grad_(True) for name, v in params.items()}
        rays = slice(i * n, (i + 1) * n)
        loss = ttr.batch_loss(one, tuple(t[rays] for t in batch), jitter[rays], cfg)
        loss.backward()
        assert abs(float(losses[i].detach()) - float(loss.detach())) <= 1e-6 * abs(float(loss.detach()))
        for name in params:
            g1, g = q[name].grad[i], one[name].grad
            # the grid's rows meet only their own object's updates; the
            # atomics' order and the batched products may round otherwise
            assert float((g1 - g).abs().max()) <= 1e-5 * float(g.abs().max()), (name, i)


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


# --- the point splat (K8) and the occupancy ray cast (K9) --------------------


def _splat_scene(n, seed, dev, dup_every=0):
    """(points, colours01) of a random blob 0.3 in front of the camera at
    the identity pose, spread past the frame's edges; with ``dup_every``,
    every such point is repeated at the end with another colour, so that
    their splats tie exactly in depth."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-0.25, 0.25, size=(n, 2)), rng.uniform(0.2, 0.4, size=(n, 1))], axis=1)
    cols = rng.uniform(0, 1, size=(n, 3))
    if dup_every:
        pts = np.concatenate([pts, pts[::dup_every]])
        cols = np.concatenate([cols, rng.uniform(0, 1, size=(len(pts) - n, 3))])
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)  # noqa: E731
    return as_t(pts), as_t(cols)


def _poses(frames, seed, dev):
    """(frames, 3, 4) world-to-camera matrices: small rotations and shifts
    about the identity, the first exactly the identity."""
    rng = np.random.default_rng(seed)
    out = np.tile(np.eye(3, 4), (frames, 1, 1))
    for f in range(1, frames):
        a = rng.normal(size=3) * 0.2  # Rodrigues: a rotation by |a| about a
        k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]]) / np.linalg.norm(a)
        t = np.linalg.norm(a)
        out[f, :, :3] = np.eye(3) + np.sin(t) * k + (1 - np.cos(t)) * k @ k
        out[f, :, 3] = rng.normal(size=3) * 0.02
    return torch.from_numpy(out.astype(np.float32)).to(dev)


def _camera(size, model):
    from nerf_prv_tpu_torch.core.config import CameraConfig

    if size == "full":
        return CameraConfig(model=model)
    return CameraConfig(width=160, height=90, fx=150.0, fy=149.0, ppx=80.3, ppy=45.1, model=model)


@pytest.mark.parametrize("u8", [True, False], ids=["u8", "f32"])
@pytest.mark.parametrize("point_size", [1, 3, 4, 5])
@pytest.mark.parametrize("model", [0, 2])
@pytest.mark.parametrize("size,n,frames", [("small", 3000, 3), ("full", 200_003, 2)])
def test_splat_kernel_equals_plain(cuda_device, size, n, frames, model, point_size, u8):
    """Bit-equal to ``splat_plain`` (the kernel and the plain version round
    every f32 operation the same way), exact depth ties included, with
    points beyond every edge of the frame."""
    from nerf_prv_tpu_torch.ops.splat import splat, splat_plain

    pts, cols = _splat_scene(n, seed=point_size, dev=cuda_device, dup_every=7)
    w2c = _poses(frames, seed=model, dev=cuda_device)
    cam = _camera(size, model)
    before = splat.launches
    got = splat(pts, cols, w2c, cam, point_size, rgba_u8=u8)
    torch.cuda.synchronize()
    assert splat.launches == before + 1
    want = splat_plain(pts, cols, w2c, cam, point_size, rgba_u8=u8)
    if u8:
        assert got.shape == (frames, cam.height, cam.width, 4) and got.dtype == torch.uint8
        assert torch.equal(got, want)
        covered = float((got[..., 3] > 0).float().mean())
    else:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        covered = float(got[1].mean())
    assert 0.02 < covered < 0.98  # the frame is neither empty nor full


def test_splat_kernel_empty_cloud_is_white_and_transparent(cuda_device):
    from nerf_prv_tpu_torch.ops.splat import splat

    empty = torch.zeros((0, 3), device=cuda_device)
    out = splat(empty, empty, _poses(2, 0, cuda_device), _camera("small", 0), 5)
    torch.cuda.synchronize()
    assert bool((out[..., :3] == 255).all()) and bool((out[..., 3] == 0).all())


def _tie_and_round_scene(dev):
    """Points whose projections land exactly on pixel centres + 0.5 (fx a
    power of two, ppx on a half) and exact duplicates with other colours."""
    from nerf_prv_tpu_torch.core.config import CameraConfig

    cam = CameraConfig(width=96, height=64, fx=64.0, fy=64.0, ppx=40.5, ppy=30.5, model=0)
    j = np.arange(-30, 30)
    pts = np.stack([j / 64.0, (j % 17 - 8) / 64.0, np.full(j.shape, 1.0)], axis=1)
    pts = np.concatenate([pts, pts])
    cols = np.random.default_rng(0).uniform(0, 1, size=(len(pts), 3))
    as_t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    return as_t(pts), as_t(cols), torch.eye(3, 4, device=dev)[None].contiguous(), cam


def _border_scene(dev):
    """Points on and around every tile border of a 200x120 frame and beyond
    its edges, and random points at random depths (``_border_cloud``), in
    random colours, at the identity pose."""
    pts = _border_cloud(5, 16, seed=3).to(dev)
    cols = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, size=(len(pts), 3)).astype(np.float32)).to(dev)
    return pts, cols, torch.eye(3, 4, device=dev)[None].contiguous(), BIN_CAMERA


SPLAT_BROKEN = {
    "ties to the lowest index": [
        ("if (q.z <= add(zmin, 1e-7f) && winner[p] < i) atomicMax(winner + p, i);",
         "if (q.z <= add(zmin, 1e-7f)) atomicMax(winner + p, 2147483646 - i);"),
        ("    const int w = winner[p];\n",
         "    const int w = winner[p] < 0 ? -1 : 2147483646 - winner[p];\n"),
    ],
    "roundf in place of round half to even": [
        ("rintf(add(mul(x, c.fx), c.ppx))", "roundf(add(mul(x, c.fx), c.ppx))"),
        ("rintf(add(mul(y, c.fy), c.ppy))", "roundf(add(mul(y, c.fy), c.ppy))"),
    ],
    "a splat binned only into the tile of its centre": [
        ("  q.tu0 = q.u0 / kTile;\n  q.tu1 = q.u1 / kTile;\n", "  q.tu0 = q.tu1 = min(max(ui, q.u0), q.u1) / kTile;\n"),
        ("  q.tv0 = q.v0 / kTile;\n  q.tv1 = q.v1 / kTile;\n", "  q.tv0 = q.tv1 = min(max(vi, q.v0), q.v1) / kTile;\n"),
    ],
}
# the scene and point size on which each broken variant must show
SPLAT_BROKEN_SHOWN_ON = {
    "ties to the lowest index": (_tie_and_round_scene, 1),
    "roundf in place of round half to even": (_tie_and_round_scene, 1),
    "a splat binned only into the tile of its centre": (_border_scene, 5),
}


@pytest.mark.parametrize("variant", list(SPLAT_BROKEN))
def test_splat_broken_variants_are_caught(cuda_device, variant, monkeypatch):
    """The comparison with the plain version must catch a kernel that gives
    ties to the lowest point index, one that rounds halves away from zero
    (both on the tie scene at point size 1), and one that bins a splat only
    into the tile of its centre (squares across tile borders at point size
    5); the tree's kernel passes the same scenes."""
    from nerf_prv_tpu_torch.ops import _build
    from nerf_prv_tpu_torch.ops import splat as splat_mod

    scene, ps = SPLAT_BROKEN_SHOWN_ON[variant]
    pts, cols, w2c, cam = scene(cuda_device)
    want = splat_mod.splat_plain(pts, cols, w2c, cam, ps)
    assert torch.equal(splat_mod.splat(pts, cols, w2c, cam, ps), want)
    lib = splat_mod.bind(_build.edited("splat", SPLAT_BROKEN[variant]))
    monkeypatch.setattr(splat_mod, "_lib", lambda: lib)
    assert not torch.equal(splat_mod.splat(pts, cols, w2c, cam, ps), want)


def _splat_edge_case(case, dev):
    """(points, colours, w2c, camera, point size) of one case of the
    binning: every point on one pixel (one bin holds them all, half of them
    tied in depth); points on and around tile borders and corners; squares
    of side 2, 4, 33 and 40 (wider than a tile); centres up to the point size
    outside the frame; 100 frames; no points."""
    rng = np.random.default_rng(len(case))
    w2c = _mirror_poses(seed=len(case)).to(dev)
    cam, ps = BIN_CAMERA, 5
    if case == "one_pixel":
        n = 50_000
        z = np.where(np.arange(n) % 2 == 0, 1.0, rng.uniform(1.0, 2.0, n))
        pts = np.stack([40 / 64.0 * z, 40 / 64.0 * z, z], axis=1)
        w2c = w2c[:1]
    elif case == "tile_borders":
        pts = _border_cloud(ps, 16, seed=1).numpy()
    elif case.startswith("ps"):
        ps = int(case[2:])
        pts = _border_cloud(ps, 32, seed=ps).numpy()
    elif case == "beyond_edges":  # centres within ps outside the frame, four exactly on the limits
        ps, n = 7, 4000
        u = np.concatenate([rng.uniform(-ps, 0, n // 2), rng.uniform(cam.width, cam.width + ps, n // 2)])
        v = rng.uniform(-ps, cam.height + ps, n)
        z = rng.uniform(0.5, 2.0, n)
        u[:4], v[:4], z[:4] = [-ps, -ps, cam.width + ps - 1, cam.width + ps], [-ps, cam.height + ps - 1, 3, 3], 1.0
        pts = np.stack([u / 64.0 * z, v / 64.0 * z, z], axis=1)
    elif case == "frames100":
        pts, cols = _splat_scene(3000, seed=100, dev=dev)
        return pts, cols, _poses(100, seed=100, dev=dev), _camera("small", 2), ps
    else:  # empty
        pts = np.zeros((0, 3))
    cols = rng.uniform(0, 1, size=(len(pts), 3))
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)  # noqa: E731
    return as_t(pts), as_t(cols), w2c.contiguous(), cam, ps


@pytest.mark.parametrize("u8", [True, False], ids=["u8", "f32"])
@pytest.mark.parametrize("case", ["one_pixel", "tile_borders", "ps2", "ps4", "ps33", "ps40", "beyond_edges",
                                  "frames100", "empty"])
def test_splat_kernel_equals_plain_on_binning_edge_cases(cuda_device, case, u8):
    """Bit-equal to ``splat_plain`` where the binning by tile is most likely
    to go wrong (``_splat_edge_case``)."""
    from nerf_prv_tpu_torch.ops.splat import splat, splat_plain

    pts, cols, w2c, cam, ps = _splat_edge_case(case, cuda_device)
    before = splat.launches
    got = splat(pts, cols, w2c, cam, ps, rgba_u8=u8)
    torch.cuda.synchronize()
    assert splat.launches == before + 1
    want = splat_plain(pts, cols, w2c, cam, ps, rgba_u8=u8)
    if u8:
        assert got.shape == want.shape and torch.equal(got, want)
        alpha = got[..., 3].float() / 255
    else:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        alpha = got[1]
    covered = float(alpha.mean())
    assert covered == 0.0 if case == "empty" else 0.0 < covered <= 1.0


def _cast_inputs(n_rays, seed, dev, miss_share=0.3):
    """A 40 x 30 x 20 grid of ~8% occupied voxels with colours, and rays
    from outside it: most aimed at it, ``miss_share`` aimed away."""
    rng = np.random.default_rng(seed)
    occ = rng.uniform(size=(40, 30, 20)) < 0.08
    col = rng.uniform(size=(40, 30, 20, 3))
    origin = np.array([-0.04, -0.03, -0.02])
    o = rng.normal(size=(n_rays, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 0.2
    d = -o + rng.normal(size=(n_rays, 3)) * 0.02
    away = rng.uniform(size=n_rays) < miss_share
    d[away] = -d[away]
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)  # noqa: E731
    return torch.from_numpy(occ).to(dev), as_t(col), origin, as_t(o), as_t(d)


@pytest.mark.parametrize("n_rays,n_steps", [(1, 10), (4099, 200), (65_536, 1000)])
def test_voxel_cast_kernel_equals_plain(cuda_device, n_rays, n_steps):
    """Hit flags, voxel centres and colours bit-equal to
    ``voxel_cast_plain``, all-miss rays (step 0's clipped voxel) included."""
    from nerf_prv_tpu_torch.ops.voxel_cast import voxel_cast, voxel_cast_plain

    occ, col, origin, o, d = _cast_inputs(n_rays, seed=n_steps, dev=cuda_device)
    before = voxel_cast.launches
    got = voxel_cast(occ, col, origin, 0.002, o, d, 0.4, n_steps)
    torch.cuda.synchronize()
    assert voxel_cast.launches == before + 1
    want = voxel_cast_plain(occ, col, origin, 0.002, o, d, 0.4, n_steps)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if n_rays > 1:
        assert 0.1 < float(got[0].float().mean()) < 0.9  # hits and misses both


CAST_BROKEN = {
    "returns the last hit": [("      found = true;\n      break;", "      found = true;")],
    "marches an interval one step too tight": [("constexpr int kMarginSteps = 2;", "constexpr int kMarginSteps = -1;")],
}


def test_voxel_cast_last_hit_variant_is_caught(cuda_device, monkeypatch):
    """A kernel that returns the last occupied voxel on the ray, not the
    first, must disagree with the plain version."""
    from nerf_prv_tpu_torch.ops import _build
    from nerf_prv_tpu_torch.ops import voxel_cast as cast_mod

    occ, col, origin, o, d = _cast_inputs(4099, seed=1, dev=cuda_device)
    args = (occ, col, origin, 0.002, o, d, 0.4, 400)
    want = cast_mod.voxel_cast_plain(*args)
    lib = cast_mod.bind(_build.edited("voxel_cast", CAST_BROKEN["returns the last hit"]))
    monkeypatch.setattr(cast_mod, "_lib", lambda: lib)
    got = cast_mod.voxel_cast(*args)
    assert torch.equal(got[0], want[0]) and not torch.equal(got[1], want[1])


@pytest.mark.parametrize("kind", ["random", "inside_origin"])
def test_voxel_cast_tight_interval_variant_is_caught(cuda_device, kind, monkeypatch):
    """A kernel whose step interval is one step inside the exact in-grid
    interval at each end misses hits on a ray's first in-grid step (and,
    for rays from inside the box, on step 0): it must disagree with the
    plain version, which the tree's kernel equals on the same rays."""
    from nerf_prv_tpu_torch.ops import _build
    from nerf_prv_tpu_torch.ops import voxel_cast as cast_mod

    dims, corner, res, max_range, n_steps = GRIDS["test grid"]
    rng = np.random.default_rng(2)
    occ = torch.from_numpy(rng.uniform(size=dims) < 0.08).to(cuda_device)
    col = torch.from_numpy(rng.uniform(size=(*dims, 3)).astype(np.float32)).to(cuda_device)
    o, d = (t.to(cuda_device) for t in _rays(kind, GRIDS["test grid"], 4099, seed=2))
    args = (occ, col, corner, res, o, d, max_range, n_steps)
    want = cast_mod.voxel_cast_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(cast_mod.voxel_cast(*args), want))
    lib = cast_mod.bind(_build.edited("voxel_cast", CAST_BROKEN["marches an interval one step too tight"]))
    monkeypatch.setattr(cast_mod, "_lib", lambda: lib)
    got = cast_mod.voxel_cast(*args)
    assert not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("kind", ["random", "inside_origin", "axis_parallel", "grazing", "zero_component",
                                  "non_finite"])
def test_voxel_cast_kernel_equals_plain_on_ray_kinds(cuda_device, kind, grid):
    """Hit flags, centres and colours bit-equal to ``voxel_cast_plain`` on
    the rays that test the kernel's step interval (``_rays``): random rays
    (a quarter aimed away, never meeting the box), rays from inside the
    box, axis-parallel and grazing rays, rays with zero direction
    components, and non-finite rays (zero directions, NaN and infinite
    coordinates, which march no step), on a grid of 8% occupied voxels."""
    from nerf_prv_tpu_torch.ops.voxel_cast import voxel_cast, voxel_cast_plain

    dims, corner, res, max_range, n_steps = GRIDS[grid]
    rng = np.random.default_rng(len(kind))
    occ = torch.from_numpy(rng.uniform(size=dims) < 0.08).to(cuda_device)
    col = torch.from_numpy(rng.uniform(size=(*dims, 3)).astype(np.float32)).to(cuda_device)
    o, d = (t.to(cuda_device) for t in _rays(kind, GRIDS[grid], 4099, seed=len(kind) + len(grid)))
    args = (occ, col, corner, res, o.contiguous(), d.contiguous(), max_range, n_steps)
    got = voxel_cast(*args)
    torch.cuda.synchronize()
    want = voxel_cast_plain(*args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    if kind != "non_finite":
        assert 0.0 < float(got[0].float().mean()) < 1.0


# PRVNet's forward on the card against the CPU, cuDNN's convolutions in full
# float32 (the predictor's default): the logit of seeded weights whose every
# layer is O(1), and the continuous budget
PRV_LOGIT_TOL = 1e-4


def test_budget_predictor_card_logit_matches_cpu(cuda_device):
    from nerf_prv_tpu_torch.prvnet.infer import BudgetPredictor
    from nerf_prv_tpu_torch.prvnet.model import make_pvbnet

    gen = torch.Generator().manual_seed(0)
    sd = {}
    for k, v in make_pvbnet("convnextv2_atto").state_dict().items():
        noise = torch.randn(v.shape, generator=gen)
        if v.ndim >= 2 and not k.endswith(("grn.gamma", "grn.beta")):
            sd[k] = noise / math.sqrt(v[0].numel())  # convolutions and linear layers, by fan-in
        elif v.ndim == 1 and k.endswith("weight"):
            sd[k] = 1 + 0.1 * noise  # the LayerNorms
        else:
            sd[k] = 0.05 * noise
    views = np.random.default_rng(1).random((3, 128, 128, 3), dtype=np.float32)
    card = BudgetPredictor(params=sd, arch="convnextv2_atto", crop=128)
    cpu = BudgetPredictor(params=sd, arch="convnextv2_atto", crop=128, device="cpu")
    assert card.device.type == "cuda"
    a, b = float(card.logits(views)[0]), float(cpu.logits(views)[0])
    assert abs(b) > 0.1  # a logit the encoder moves, not the head's bias alone
    assert abs(a - b) <= PRV_LOGIT_TOL * max(1.0, abs(b)), (a, b)
    assert abs(card.predict_value_from_arrays(views) - cpu.predict_value_from_arrays(views)) <= 45 / 4 * PRV_LOGIT_TOL
