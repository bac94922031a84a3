"""The yardstick's arithmetic: the published peaks of the card, the MLP
operations the protocol needs, and the least time of a kernel launch from
the bytes it must move or the operations it must do.

The bound functions are copies of ``chip_smoke.py``'s ``gather_bound_ms``,
``scatter_bound_ms``, ``encode_bound_ms`` and ``backward_bound_ms``, in
seconds: every input byte read once, every output byte written once, the
rows a gather or an encode reads counted from the launch's own indices.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .spec import HERE, load_json


def peaks(kind: str) -> Optional[dict]:
    """The card's published peaks (``peaks.json``), or None for a card the
    table does not hold."""
    return load_json(HERE / "peaks.json")["cards"].get(kind)


# ------------------------------------------------------------- operations
def mlp_flops(nerf: dict) -> tuple:
    """(density MLP, colour MLP) multiply-add operations per sample, forward."""
    h, geo = nerf["hidden"], nerf["geo_features"]
    if nerf["field_impl"] == "voxel":
        n_in = nerf["voxel_features"] + 6 * nerf["voxel_pe_freqs"]
    else:
        n_in = nerf["grid"]["levels"] * nerf["grid"]["features"]
    density = 2 * (n_in * h + h * (geo + 1))
    colour = 2 * ((16 + geo) * h + h * h + h * 3)
    return density, colour


def train_phases(nerf: dict) -> list:
    """(probe samples, march samples, steps) of the warmup and the tight march."""
    n_warm = min(nerf["train_warmup_steps"], nerf["n_steps"]) if nerf["train_coarse"] > 0 else 0
    out = [(0, nerf["train_warmup_samples"], n_warm)] if n_warm else []
    out.append((nerf["train_coarse"], nerf["n_samples"], nerf["n_steps"] - n_warm))
    return [p for p in out if p[2] > 0]


def train_flops(nerf: dict, k: int) -> float:
    """MLP operations one training of K fields needs: forward and backward
    (three times the forward) at every march sample, the density forward at
    every probe sample."""
    dens, col = mlp_flops(nerf)
    rays = k * nerf["train_rays"]
    return float(sum(steps * rays * (ns * 3 * (dens + col) + coarse * dens)
                     for coarse, ns, steps in train_phases(nerf)))


def eval_flops(nerf: dict, sphere_hits: int, marched: int, samples: int) -> float:
    """MLP operations one eval needs: the march's forward at every sample of
    the rays the probes keep, plus the voxel field's corner-density table
    (the density forward at 8 corners of every cell) or the hash field's
    MLP probes at every sphere-hitting ray."""
    dens, col = mlp_flops(nerf)
    march = marched * samples * (dens + col)
    if nerf["field_impl"] == "voxel":
        return float(march + nerf["voxel_grid_size"] ** 3 * 8 * dens)
    return float(march + sphere_hits * nerf["render_coarse"] * dens)


# ------------------------------------------------------------- bounds
def gather_bound_s(idx: torch.Tensor, row_bytes: int, hbm: float) -> float:
    """Indices and the distinct rows they name read once, output written once."""
    rows = int(torch.unique(idx).numel())
    return (idx.numel() * idx.element_size() + rows * row_bytes + idx.numel() * row_bytes) / hbm


def scatter_bound_s(n_idx: int, idx_bytes: int, width: int, n_rows: int, hbm: float, f32: float) -> float:
    """Indices and float32 updates read once, the whole output written once;
    or one add per element."""
    moved = n_idx * idx_bytes + 4 * n_idx * width + 4 * n_rows * width
    return max(moved / hbm, n_idx * width / f32)


def resolutions(grid: dict) -> list:
    """Each level's resolution: ``n_min`` grown geometrically to ``n_max``."""
    if grid["levels"] == 1:
        return [int(grid["n_min"])]
    b = np.exp((np.log(grid["n_max"]) - np.log(grid["n_min"])) / (grid["levels"] - 1))
    return [int(r) for r in np.floor(grid["n_min"] * b ** np.arange(grid["levels"])).astype(np.int32)]


def hash_levels(grid: dict) -> tuple:
    """(resolutions, dense flags) of a hash grid's levels."""
    res = resolutions(grid)
    return res, [(r + 1) ** 3 <= (1 << grid["log2_table"]) for r in res]


def table_rows_touched(x: torch.Tensor, grid: dict) -> int:
    """Distinct table rows an encode of points x (N, 3) reads, over all levels."""
    size = 1 << grid["log2_table"]
    res, dense = hash_levels(grid)
    total = 0
    for r, is_dense in zip(res, dense):
        cell = torch.clamp(torch.floor(x * float(r)), 0, r - 1).to(torch.int64)
        idx = []
        for c in ((i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)):
            cx, cy, cz = (cell[:, a] + c[a] for a in range(3))
            if is_dense:
                idx.append(cx + cy * (r + 1) + cz * (r + 1) * (r + 1))
            else:
                idx.append((cx * 1 ^ cy * 2654435761 ^ cz * 805459861) & (size - 1))
        total += int(torch.unique(torch.cat(idx)).numel())
    return total


def encode_ops(n: int, grid: dict) -> int:
    # per (point, level): 3 scale + 3 frac + 3 (1 - frac), then per corner 2
    # weight products and F multiply-adds
    return n * grid["levels"] * (9 + 8 * (2 + 2 * grid["features"]))


def encode_bound_s(x: torch.Tensor, grid: dict, hbm: float, f32: float) -> float:
    """K1: x and the rows it needs read once, the output written once; or
    its float32 arithmetic."""
    n, out_dim = x.shape[0], grid["levels"] * grid["features"]
    moved = 4 * (n * 3 + table_rows_touched(x, grid) * grid["features"] + n * out_dim)
    return max(moved / hbm, encode_ops(n, grid) / f32)


def backward_bound_s(n: int, grid: dict, hbm: float, f32: float) -> float:
    """K1b: x and the output gradient read once, the whole table gradient
    written once; or its float32 arithmetic."""
    rows = grid["levels"] * (1 << grid["log2_table"])
    moved = 4 * (n * 3 + n * grid["levels"] * grid["features"] + rows * grid["features"])
    return max(moved / hbm, encode_ops(n, grid) / f32)
