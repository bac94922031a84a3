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
from nerf_prv_tpu_torch.ops.hash_encode import hash_encode
from nerf_prv_tpu_torch.ops.row_gather import row_gather, row_gather_plain
from nerf_prv_tpu_torch.ops.row_scatter_add import row_scatter_add, row_scatter_add_plain

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


@pytest.mark.parametrize(
    "cfg,n",
    [
        (HashGridConfig(features=1), 4099),
        (HashGridConfig(features=2), 4099),
        (HashGridConfig(features=4), 4099),
        (HashGridConfig(features=8), 4099),
        (HashGridConfig(levels=4, log2_table=12, n_min=4, n_max=64), 33),
    ],
    ids=["f1", "f2", "f4", "f8", "small"],
)
def test_hash_encode_kernel_matches_plain(cuda_device, cfg, n):
    table, x = _inputs(cfg, n, seed=cfg.features, dev=cuda_device)
    before = hash_encode.launches
    got = hash_encode(table, x, cfg)
    torch.cuda.synchronize()
    assert hash_encode.launches == before + 1
    want = encode(table, x, cfg)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= TOL


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
