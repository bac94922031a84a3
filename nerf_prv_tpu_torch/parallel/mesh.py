"""Device mesh and object-axis sharding helpers, in PyTorch.

Counterpart of the object-axis part of ``nerf_prv_tpu/parallel/mesh.py``:
a mesh is an ndarray of ``torch.device`` with axis names, and a batch's
leading axis is split into one chunk per device.  The reference's
``batch_sharding`` and ``replicated`` build ``jax.sharding.NamedSharding``
objects, which have no PyTorch counterpart: :func:`shard_batch` places the
chunks directly.

Not ported yet: ``tp_gather_rows`` and ``tp_voxel_field``, the voxel grid's
rows sharded over a ``tp`` axis with a ``psum``.  They exist only across
cards (on one card there is nothing to shard over) and will come as a
multi-card item over ``torch.distributed``.
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
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(
    axis_names: Sequence[str] = ("dp",),
    axis_sizes: Optional[Sequence[int]] = None,
    devices=None,
) -> Mesh:
    """A mesh over ``devices`` (every CUDA card by default, else the CPU);
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
