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

TOL = 1e-5  # f32 trilinear blend of table values in [-1, 1]; FMA vs mul+add


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hash-encode kernel has no CPU mode")
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
