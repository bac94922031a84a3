"""Multiresolution hash encoding (instant-ngp style) in PyTorch.

Counterpart of ``nerf_prv_tpu/nerf/hashgrid.py``.  :func:`encode` is the
plain version: the CPU path of the hash field and the reference that the
CUDA kernel (``ops/hash_encode.py``) is held against on the card.

Defaults follow instant-ngp's base config: L=16 levels, F=2 features,
2^19-entry tables, resolutions 16 -> 2048 on the unit cube.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# spatial hash primes (Teschner et al.; same constants as instant-ngp)
_PRIMES = (1, 2654435761, 805459861)


@dataclass(frozen=True)
class HashGridConfig:
    levels: int = 16
    features: int = 2
    log2_table: int = 19
    n_min: int = 16
    n_max: int = 2048

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table

    @property
    def out_dim(self) -> int:
        return self.levels * self.features

    def resolutions(self) -> np.ndarray:
        if self.levels == 1:
            return np.array([self.n_min])
        b = np.exp((np.log(self.n_max) - np.log(self.n_min)) / (self.levels - 1))
        return np.floor(self.n_min * b ** np.arange(self.levels)).astype(np.int32)


def is_dense(res: int, table_size: int) -> bool:
    """Whether a level of resolution ``res`` indexes its table densely.

    Python integers: at the default config (res + 1)^3 exceeds 2^31 from
    level 14 on, where an int32 product wraps negative and would wrongly
    select dense indexing.
    """
    return (int(res) + 1) ** 3 <= table_size


def init_table(
    generator: torch.Generator,
    cfg: HashGridConfig,
    scale: float = 1e-4,
    device="cuda",
) -> torch.Tensor:
    """(levels * table_size, features), uniform +-scale like instant-ngp."""
    u = torch.rand(
        (cfg.levels * cfg.table_size, cfg.features),
        generator=generator,
        device=generator.device,
        dtype=torch.float32,
    )
    return (u * (2.0 * scale) - scale).to(device)


def _corner_indices(cells: torch.Tensor, res: int, table_size: int) -> torch.Tensor:
    """Hash (or densely index) int64 cell coords (..., 3) -> (...,) table idx.

    The hash is uint32 arithmetic that wraps; here it runs in int64 (every
    product is < 2^43) and the mask keeps the low bits, which equal the
    wrapped uint32 result because the table size divides 2^32.
    """
    if is_dense(res, table_size):
        return (
            cells[..., 0]
            + cells[..., 1] * (res + 1)
            + cells[..., 2] * (res + 1) * (res + 1)
        )
    idx = (
        cells[..., 0] * _PRIMES[0]
        ^ cells[..., 1] * _PRIMES[1]
        ^ cells[..., 2] * _PRIMES[2]
    )
    return idx & (table_size - 1)


_CORNERS = [(i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)]


def encode(table: torch.Tensor, x: torch.Tensor, cfg: HashGridConfig) -> torch.Tensor:
    """Encode positions x (N, 3) in [0,1]^3 -> features (N, levels*features)."""
    feats = []
    for level, res in enumerate(cfg.resolutions()):
        res = int(res)
        pos = x * float(res)
        # clamp to the last cell so boundary samples (x == 1.0) interpolate
        # within the grid (frac == 1.0) instead of indexing corner res+1
        cell = torch.clamp(torch.floor(pos), 0, res - 1)
        frac = pos - cell
        cell = cell.to(torch.int64)
        acc = torch.zeros((x.shape[0], cfg.features), dtype=table.dtype, device=x.device)
        base = level * cfg.table_size
        for di, dj, dk in _CORNERS:
            corner = cell + torch.tensor([di, dj, dk], dtype=torch.int64, device=x.device)
            idx = _corner_indices(corner, res, cfg.table_size) + base
            vals = table[idx]  # (N, F)
            wx = frac[:, 0] if di else 1.0 - frac[:, 0]
            wy = frac[:, 1] if dj else 1.0 - frac[:, 1]
            wz = frac[:, 2] if dk else 1.0 - frac[:, 2]
            acc = acc + vals * (wx * wy * wz)[:, None]
        feats.append(acc)
    return torch.cat(feats, dim=-1)
