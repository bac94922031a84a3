"""Wide-row voxel field: one grid row per sample, in PyTorch.

Counterpart of ``nerf_prv_tpu/nerf/voxelfield.py``, whose module docstring
explains the design: each grid row stores the whole 2x2x2 corner feature
block of its cell (features x 8), so a sample needs exactly one row; the
trilinear blend happens after the gather, and an MLP over (blended
features, position encoding) gives density and geometry features.

The forward's one gather per sample is :func:`~..ops.row_gather.row_gather`
and the grid's gradient is :func:`~..ops.row_scatter_add.row_scatter_add`:
on CUDA tensors both are hand-written kernels, on CPU tensors their plain
versions.

The field functions also take K objects' parameters stacked on a leading
axis (``grid`` (K, g^3, 8F), weights (K, in, out); ``nerf/batch_train.py``)
with the points object-major, K equal blocks: the K grids are read as one
(K*g^3, 8F) table through one gather and one scatter-add, object k's rows
offset by k*g^3, and each MLP layer is one batched product.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..ops.row_gather import row_gather
from ..ops.row_scatter_add import row_scatter_add


class _GatherRows(torch.autograd.Function):
    """``grid[row_idx]`` whose backward is the f32 row scatter-add.

    With ``bf16`` the rows are gathered from a bfloat16 copy of the grid
    and returned in bfloat16 (≙ ``_gather_rows_bf16``): the caller's cast
    back to float32 hands the backward a cotangent already rounded to
    bfloat16, and only the accumulation of those cotangents runs in
    float32.  That rounding is part of what the reference computes.
    """

    @staticmethod
    def forward(ctx, grid, row_idx, bf16):
        ctx.save_for_backward(row_idx)
        ctx.n_rows = grid.shape[0]
        return row_gather(grid.to(torch.bfloat16) if bf16 else grid, row_idx)

    @staticmethod
    def backward(ctx, g):
        (row_idx,) = ctx.saved_tensors
        upd = g.to(torch.float32).contiguous()
        return row_scatter_add(row_idx, upd, ctx.n_rows), None, None


def pe_encode(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """Sin/cos positional encoding, (N, 3) -> (N, 6*n_freqs)."""
    freqs = 2.0 ** torch.arange(n_freqs, dtype=torch.float32, device=x.device) * math.pi
    ang = x[..., None, :] * freqs[:, None]  # (N, F, 3)
    enc = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return enc.reshape(x.shape[:-1] + (6 * n_freqs,))


# the 2x2x2 corner enumeration every row stores, in row-slice order
CORNERS = tuple((i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1))


def cell_and_frac(x: torch.Tensor, g: int):
    """[0,1]^3 positions -> (flat cell row index (N,) int32, frac (N, 3)).

    The clip at ``1 - 1e-6`` and the ``g - 1`` scale keep the cell at or
    below ``g - 2`` on every axis.
    """
    pos = torch.clamp(x, 0.0, 1.0 - 1e-6) * (g - 1)
    cell_f = torch.floor(pos)
    cell = cell_f.to(torch.int32)
    row_idx = (cell[:, 0] * g + cell[:, 1]) * g + cell[:, 2]
    return row_idx, pos - cell_f


def corner_weights(frac: torch.Tensor) -> torch.Tensor:
    """Trilinear weights (N, 8) in CORNERS order."""
    fx, fy, fz = frac[:, 0], frac[:, 1], frac[:, 2]
    return torch.stack(
        [
            (fx if di else 1.0 - fx)
            * (fy if dj else 1.0 - fy)
            * (fz if dk else 1.0 - fz)
            for di, dj, dk in CORNERS
        ],
        dim=-1,
    )


def blend_rows(rows: torch.Tensor, frac: torch.Tensor, f: int) -> torch.Tensor:
    """Blend gathered corner-block rows (N, 8*F) -> features (N, F)."""
    w = corner_weights(frac)
    return (w[:, :, None] * rows.reshape(-1, 8, f)).sum(dim=1)


def dense(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w`` for one field's weight (in, out), or one batched product
    for K fields' stacked weights (K, in, out) over h's object-major rows."""
    if w.dim() == 2:
        return h @ w
    k = w.shape[0]
    return torch.bmm(h.reshape(k, -1, h.shape[-1]), w).reshape(-1, w.shape[-1])


def density_mlp(params, feats: torch.Tensor, x: torch.Tensor, cfg) -> torch.Tensor:
    """(blended features, positions) -> raw (N, 1 + geo_features)."""
    pe = pe_encode(x, cfg.voxel_pe_freqs)
    ct = cfg.compute_dtype
    h = torch.cat([feats, pe], dim=-1).to(ct)
    h = torch.clamp_min(dense(h, params["sigma_w0"].to(ct)), 0)
    return dense(h, params["sigma_w1"].to(ct)).to(torch.float32)


def init_voxel_params(generator: torch.Generator, cfg, device="cuda") -> Dict[str, torch.Tensor]:
    """Random voxel-field parameters drawn from ``generator``.

    Same shapes and distributions as the reference's ``init_voxel_params``
    (grid uniform in +-1e-4, Glorot-uniform MLPs); the numbers differ
    because the two frameworks' generators differ.
    """
    g = cfg.voxel_grid_size
    f = cfg.voxel_features
    h = cfg.hidden
    geo = cfg.geo_features + 1
    n_pe = 6 * cfg.voxel_pe_freqs

    def uniform(shape, lim):
        u = torch.rand(shape, generator=generator, device=generator.device)
        return (u * (2.0 * lim) - lim).to(device)

    def dense(n_in, n_out):
        return uniform((n_in, n_out), (6.0 / (n_in + n_out)) ** 0.5)

    return {
        "grid": uniform((g * g * g, 8 * f), 1e-4),
        "sigma_w0": dense(f + n_pe, h),
        "sigma_w1": dense(h, geo),
        "color_w0": dense(16 + cfg.geo_features, h),
        "color_w1": dense(h, h),
        "color_w2": dense(h, 3),
    }


def _gather(params, row_idx, cfg):
    """The single wide gather, (N,) -> (N, 8*F) float32.

    ``voxel_grad_impl="sorted"`` exists in the reference only to dodge the
    TPU's serialized duplicate-index scatter; here it takes the same
    atomic row scatter-add as every other setting (and, like the
    reference's sorted path, gathers in float32).
    """
    bf16 = cfg.voxel_gather_dtype == "bf16" and cfg.voxel_grad_impl != "sorted"
    grid = params["grid"]
    if grid.dim() == 3:
        # K grids as one table: object k's rows follow k * g^3
        k, rows = grid.shape[:2]
        base = torch.arange(k, dtype=row_idx.dtype, device=row_idx.device) * rows
        row_idx = (row_idx.reshape(k, -1) + base[:, None]).reshape(-1)
        grid = grid.reshape(k * rows, grid.shape[2])
    return _GatherRows.apply(grid, row_idx, bf16).to(torch.float32)


def _blend(params, x, cfg):
    """One gather per sample + trilinear blend -> (N, F)."""
    row_idx, frac = cell_and_frac(x, cfg.voxel_grid_size)
    return blend_rows(_gather(params, row_idx, cfg), frac, cfg.voxel_features)


def lattice_corner_raw(params, cfg) -> torch.Tensor:
    """RAW log-density at every cell's 8 corners -> (g^3, 8) float32.

    One dense pass over the grid that render-time probing reads instead of
    running the field MLP per probe sample.  Raw (pre-exp) values
    interpolate on the safe side; see the reference's docstring.
    """
    g = cfg.voxel_grid_size
    f = cfg.voxel_features
    rows = params["grid"]  # (g^3, 8*F)
    ar = torch.arange(g, dtype=torch.float32, device=rows.device)
    cell = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), dim=-1).reshape(-1, 3)
    sig = []
    for c, corner in enumerate(CORNERS):
        offset = torch.tensor(corner, dtype=torch.float32, device=rows.device)
        pos = torch.clamp((cell + offset) / (g - 1), 0.0, 1.0)
        sig.append(density_mlp(params, rows[:, c * f : (c + 1) * f], pos, cfg)[:, 0])
    return torch.stack(sig, dim=-1)  # (g^3, 8)


def voxel_density_raw(params, x, cfg):
    """x (N,3) in [0,1]^3 -> (raw log-density (N,), geo features (N, G))."""
    feats = _blend(params, x, cfg)
    out = density_mlp(params, feats, x, cfg)
    return out[..., 0], out[..., 1:]


def voxel_field(params, x, dirs, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Positions + dirs -> (sigma (N,), rgb (N,3))."""
    from .model import radiance

    raw, geo = voxel_density_raw(params, x, cfg)
    rgb = radiance(params, geo, dirs, cfg)
    return torch.exp(raw), rgb
