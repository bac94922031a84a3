"""Sort-based hash-table gradient in plain PyTorch.

Counterpart of ``nerf_prv_tpu/ops/sorted_grad.py``.  The natural backward of
the hash-grid gather is a scatter-add of N*8*levels updates with heavily
duplicated rows; the reference reorganises it as

    sort updates by table row  ->  segmented sums (cumsum + run bounds)
    ->  scatter of per-run totals at unique rows,

because a TPU serialises a duplicate-index scatter.  A GPU adds duplicate
rows with atomics, so on the card the table gradient is the CUDA kernel
behind :func:`~.hash_encode.hash_encode_backward`, and this module is that
kernel's plain version: the CPU path, what the tests and ``chip_smoke.py``
hold the kernel against, and ``encode_impl="sorted"``.
"""

from __future__ import annotations

import torch

from ..nerf.hashgrid import HashGridConfig, _CORNERS, _corner_indices, encode


def _levelwise_indices_weights(x: torch.Tensor, cfg: HashGridConfig):
    """All (row, trilinear weight) pairs: (levels, N, 8) each, int64 and
    float32, with the per-level table offset folded into the row."""
    corners = torch.tensor(_CORNERS, dtype=torch.int64, device=x.device)  # (8, 3)
    is_one = corners[None, :, :] == 1
    idx_all, w_all = [], []
    for level, res in enumerate(cfg.resolutions()):
        res = int(res)
        pos = x * float(res)
        # same boundary clamp as hashgrid.encode: keeps the backward's rows
        # identical to the forward gather's
        cell = torch.clamp(torch.floor(pos), 0, res - 1)
        frac = pos - cell
        cpos = cell.to(torch.int64)[:, None, :] + corners[None, :, :]
        idx_all.append(_corner_indices(cpos, res, cfg.table_size) + level * cfg.table_size)
        w = torch.where(is_one, frac[:, None, :], 1.0 - frac[:, None, :])
        w_all.append(w[..., 0] * w[..., 1] * w[..., 2])
    return torch.stack(idx_all), torch.stack(w_all)


def segmented_scatter_add(indices: torch.Tensor, updates: torch.Tensor, n_rows: int) -> torch.Tensor:
    """``zeros((n_rows, F)).index_add_(0, indices, updates)`` via sort +
    segmented sums + a scatter whose writing rows are unique.

    indices: (M,) integer, updates: (M, F) float32.  Shapes are static and
    nothing is read back to the host.
    """
    m, f = updates.shape
    out = torch.zeros((n_rows + 1, f), dtype=updates.dtype, device=updates.device)
    if m == 0:
        return out[:n_rows]
    sidx, order = torch.sort(indices.to(torch.int64), stable=True)
    # scanned along the contiguous axis of an (F, M) layout: PyTorch scans an
    # outer axis with one serial thread per column (2 s for M = 25 M, F = 2
    # on an NVIDIA H100 80GB HBM3)
    csum = torch.cumsum(updates.t()[:, order], dim=1)
    pos = torch.arange(m, dtype=torch.int64, device=updates.device)
    is_last = torch.cat([sidx[1:] != sidx[:-1], sidx.new_ones((1,), dtype=torch.bool)])
    # position of the previous run's last element (or -1)
    last_marks = torch.where(is_last, pos, -1)
    prev_last = torch.cat([pos.new_full((1,), -1), torch.cummax(last_marks, dim=0).values[:-1]])
    prev_csum = torch.where(prev_last >= 0, csum[:, torch.clamp_min(prev_last, 0)], 0.0)
    run_totals = csum - prev_csum  # (F, M)
    # every element that is not the last of its run writes a zero to the
    # spare row n_rows, so each real row is written exactly once (a copy,
    # not an add: adds on the one spare row would all contend for it)
    scatter_idx = torch.where(is_last, sidx, n_rows)
    out.index_copy_(0, scatter_idx, torch.where(is_last, run_totals, 0.0).t())
    return out[:n_rows]


def table_grad_sorted(x: torch.Tensor, g: torch.Tensor, cfg: HashGridConfig) -> torch.Tensor:
    """d_table (levels*table_size, F) for the output cotangent g
    (N, levels*F) at positions x (N, 3): the reference's ``_bwd``."""
    n = x.shape[0]
    f = cfg.features
    idx_all, w_all = _levelwise_indices_weights(x, cfg)  # (L, N, 8)
    g_lvl = g.reshape(n, cfg.levels, f).permute(1, 0, 2)  # (L, N, F)
    updates = w_all[..., None] * g_lvl[:, :, None, :]  # (L, N, 8, F)
    return segmented_scatter_add(
        idx_all.reshape(-1), updates.reshape(-1, f), cfg.levels * cfg.table_size
    )


class _EncodeSorted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, x, cfg):
        ctx.save_for_backward(x)
        ctx.cfg = cfg
        return encode(table, x, cfg)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return table_grad_sorted(x, g.contiguous(), ctx.cfg), None, None


def encode_sorted(table: torch.Tensor, x: torch.Tensor, cfg: HashGridConfig) -> torch.Tensor:
    """Hash encoding whose backward is the sorted unique scatter.

    Positions are treated as non-differentiable (the pipeline never
    backpropagates into camera geometry)."""
    return _EncodeSorted.apply(table, x.detach(), cfg)
