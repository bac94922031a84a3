"""Carry field parameters between the JAX package and the port.

Both sides keep parameters as flat dicts under the same key names
(``grid`` for the voxel field or ``table`` for the hash field, then
``sigma_w0``, ``sigma_w1``, ``color_w0``, ``color_w1``, ``color_w2``), and
both write them as the same npz snapshot (``nerf/api.py``
``save_snapshot``), so conversion is a dtype-preserving copy between numpy
arrays and tensors.  Only parameters cross: a snapshot carries no
optimizer state on either side.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Union

import numpy as np
import torch


def params_from_numpy(
    d: Union[Mapping[str, np.ndarray], str, os.PathLike], device="cuda"
) -> Dict[str, torch.Tensor]:
    """Numpy arrays (``np.asarray`` of a JAX parameter tree), or the path
    of an npz snapshot, -> the port's tensors on ``device``."""
    if isinstance(d, (str, os.PathLike)):
        with np.load(d) as z:
            d = {k: z[k] for k in z.files}
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in d.items()}


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's tensors -> host numpy arrays (``jnp.asarray`` takes them)."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
