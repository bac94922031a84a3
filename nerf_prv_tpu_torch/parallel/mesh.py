"""Device mesh, object-axis sharding and the row-sharded voxel grid, in PyTorch.

Counterpart of ``nerf_prv_tpu/parallel/mesh.py``: a mesh is an ndarray of
``torch.device`` with axis names, and a batch's leading axis is split into
one chunk per device.  The reference's ``batch_sharding`` and
``replicated`` build ``jax.sharding.NamedSharding`` objects, which have no
PyTorch counterpart: :func:`shard_batch` places the chunks directly.

The reference is one controller over every device, and so is the port: one
process drives all of a mesh's devices, values cross devices by
``Tensor.to(device)`` (which autograd differentiates: its backward moves
the gradient back), and sums run on the receiving device.  A mesh may list
one device several times; it then runs the same code as a mesh of distinct
cards, without the peer copies.

Tensor parallelism: :func:`shard_rows` lays the voxel grid's rows out as
one contiguous shard per device along a ``tp`` axis (≙ ``device_put(grid,
NamedSharding(mesh, P("tp")))``), :func:`tp_gather_rows` gathers global
rows from the shards (each on its own device, out-of-shard rows masked to
zero, the shards' results summed: the reference's ``psum``), and
:func:`tp_voxel_field` is the voxel field over such a grid, with the
samples optionally split over a second (``dp``) axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class Mesh:
    """``devices``: an ndarray of ``torch.device`` shaped by the axes;
    ``axis_names``: one name per axis (≙ ``jax.sharding.Mesh``)."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def _all_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: no CUDA card is visible; pass devices=['cpu'] to build a mesh on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    axis_names: Sequence[str] = ("dp",),
    axis_sizes: Optional[Sequence[int]] = None,
    devices=None,
) -> Mesh:
    """A mesh over ``devices`` (every CUDA card by default; without a card
    this raises, and a CPU mesh is asked for with ``devices=["cpu"]``);
    ``axis_sizes`` default to all devices on the first axis."""
    devices = list(devices) if devices is not None else _all_devices()
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if axis_sizes is None:
        axis_sizes = [n] + [1] * (len(axis_names) - 1)
    if int(np.prod(axis_sizes)) != n:
        raise ValueError(f"mesh {axis_sizes} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(axis_sizes), tuple(axis_names))


def _axis_devices(mesh: Mesh, axis: str) -> List[torch.device]:
    """The devices along ``axis``, the other axes at index 0."""
    k = mesh.axis_names.index(axis)
    index = [0] * mesh.devices.ndim
    index[k] = slice(None)
    return list(mesh.devices[tuple(index)])


def shard_batch(batch, mesh: Mesh, axis: str = "dp") -> list:
    """Split the leading axis of every tensor or array in ``batch`` (a
    tensor, an array, or a dict / list / tuple of them) into equal chunks,
    one per device along ``axis``, each chunk moved to its device as a
    tensor.  Returns one such tree per device, in mesh order.  The leading
    axis must divide evenly (pad it with :func:`pad_to_multiple`)."""
    devices = _axis_devices(mesh, axis)
    m = len(devices)

    def split(x, i):
        if isinstance(x, dict):
            return {k: split(v, i) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(split(v, i) for v in x)
        t = torch.as_tensor(x)
        if t.shape[0] % m:
            raise ValueError(f"leading axis {t.shape[0]} does not divide over {m} devices")
        c = t.shape[0] // m
        return t[i * c : (i + 1) * c].to(devices[i])

    return [split(batch, i) for i in range(m)]


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0) -> Tuple[np.ndarray, int]:
    """Pad the batch axis so it divides the mesh; returns (padded, n_real)."""
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, mode="edge"), n


# ---------------------------------------------------------------------------
# Tensor parallelism: grid rows sharded over a "tp" mesh axis (the
# reference's sharded-embedding layout; its comment block explains why and
# why there is no pipeline parallelism).  Each shard gathers through the
# voxel field's own row gather in float32 (``row_gather`` forward,
# ``row_scatter_add`` backward, on the shard's device); the masked results
# are summed on each batch device, and since every global row lives on
# exactly one shard, the sum adds exact zeros: the result equals a gather
# from the whole grid to the bit.
# ---------------------------------------------------------------------------


def shard_rows(grid: torch.Tensor, mesh: Mesh, axis: str = "tp") -> List[torch.Tensor]:
    """One contiguous row shard of ``grid`` (R, W) per device along ``axis``,
    in mesh order, each a new tensor on its device that requires grad as
    ``grid`` does (≙ ``device_put(grid, NamedSharding(mesh, P(axis)))``).
    R must divide evenly over the axis."""
    devices = _axis_devices(mesh, axis)
    m = len(devices)
    if grid.shape[0] % m:
        raise ValueError(f"{grid.shape[0]} rows do not divide over {m} devices along {axis!r}")
    rows = grid.shape[0] // m
    with torch.no_grad():
        shards = [grid[i * rows : (i + 1) * rows].to(d, copy=True).contiguous() for i, d in enumerate(devices)]
    return [s.requires_grad_(grid.requires_grad) for s in shards]


def _masked_gather(shard: torch.Tensor, idx: torch.Tensor, offset: int) -> torch.Tensor:
    """One shard's part of every global row ``idx``: the row where the
    shard holds it (its rows are the global rows from ``offset``), zero
    elsewhere.  An index outside the shard reads its row ``mod rows``, which
    keeps every index the gather sees inside the shard (``row_gather`` does
    not clamp) and spreads the backward's zero updates over the shard
    instead of piling them onto one row, as the reference's ``clip`` does."""
    from ..nerf.voxelfield import _GatherRows

    rows = shard.shape[0]
    local = idx - offset
    in_shard = (local >= 0) & (local < rows)
    got = _GatherRows.apply(shard, torch.remainder(local, rows).contiguous(), False)
    return torch.where(in_shard[:, None], got, 0.0)


def tp_gather_rows(shards: Sequence[torch.Tensor], row_idx: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Gather global rows from a row-sharded table (≙ the reference's
    ``tp_gather_rows`` inside ``shard_map``, over all shards at once).

    shards: the (rows_i, W) float32 shards of :func:`shard_rows`, shard i
    holding the global rows that follow the shards before it.
    row_idx: one (N_j,) tensor of global row ids per batch device.
    Returns the (N_j, W) rows of each, on its index tensor's device.  Each
    shard gathers every index in one ``row_gather`` launch on its own device
    (:func:`_masked_gather`), and each batch device sums the shards' parts
    (the ``psum``); the backward is one ``row_scatter_add`` a shard.
    """
    parts = list(row_idx)
    sizes = [p.shape[0] for p in parts]
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    offset = 0
    for shard in shards:
        got = _masked_gather(shard, torch.cat([p.to(shard.device) for p in parts]), offset)
        for j, piece in enumerate(torch.split(got, sizes)):
            piece = piece.to(parts[j].device)
            out[j] = piece if out[j] is None else out[j] + piece
        offset += shard.shape[0]
    return out


def tp_voxel_field(
    mesh: Mesh, params, x: torch.Tensor, dirs: torch.Tensor, cfg, axis: str = "tp",
    batch_axis: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Voxel-field forward with the grid row-sharded over ``axis``
    (≙ the reference's ``tp_voxel_field``): ``params["grid"]`` is the list
    of :func:`shard_rows`, every other leaf one tensor (replicated by
    ``.to`` where it is used).  With ``batch_axis`` the samples split over
    that mesh axis (:func:`shard_batch`), each chunk's blend and MLPs run on
    its device, and (sigma (N,), rgb (N, 3)) come back concatenated in order
    on ``x``'s device."""
    from ..nerf.model import radiance
    from ..nerf.voxelfield import blend_rows, cell_and_frac, density_mlp

    shards = list(params["grid"])
    if len(shards) != len(_axis_devices(mesh, axis)):
        raise ValueError(f"{len(shards)} grid shards for {len(_axis_devices(mesh, axis))} devices along {axis!r}")
    others = {k: v for k, v in params.items() if k != "grid"}
    parts = shard_batch((x, dirs), mesh, batch_axis) if batch_axis else [(x, dirs)]
    cells = [cell_and_frac(xj, cfg.voxel_grid_size) for xj, _ in parts]
    rows = tp_gather_rows(shards, [idx for idx, _ in cells])
    sigmas, rgbs = [], []
    for (xj, dj), (_, frac), rj in zip(parts, cells, rows):
        local = {k: v.to(xj.device) for k, v in others.items()}
        feats = blend_rows(rj, frac, cfg.voxel_features)
        raw = density_mlp(local, feats, xj, cfg)
        sigmas.append(torch.exp(raw[..., 0]).to(x.device))
        rgbs.append(radiance(local, raw[..., 1:], dj, cfg).to(x.device))
    return torch.cat(sigmas), torch.cat(rgbs)
