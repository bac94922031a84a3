"""The neural field: a spatial encoding + small MLPs, in PyTorch.

Counterpart of ``nerf_prv_tpu/nerf/model.py``.  ``NerfConfig`` keeps every
field, default and check of the reference; the comments there record why
each default was chosen.  ``field_impl="voxel"`` (the default) dispatches
to :mod:`.voxelfield`, ``"hash"`` to the multiresolution hash encoding.

Parameters are a dict of tensors under the reference's key names, so
snapshots interchange (``convert.py``).  The field functions also take K
objects' parameters stacked on a leading axis, the points object-major
(``nerf/batch_train.py``; see :mod:`.voxelfield`).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, Tuple

import torch

from ..ops.fused import encode_fused
from ..ops.sorted_grad import encode_sorted
from .hashgrid import HashGridConfig, encode, init_table
from .voxelfield import dense, init_voxel_params, voxel_density_raw, voxel_field


@dataclass(frozen=True)
class NerfConfig:
    grid: HashGridConfig = dc_field(default_factory=HashGridConfig)
    hidden: int = 64
    geo_features: int = 15
    sh_degree: int = 4  # 16 direction coefficients
    density_activation: str = "exp"
    n_samples: int = 16
    n_importance: int = 0
    render_n_samples: int = 16
    render_coarse: int = 24
    render_probe_coarse: int = 8
    render_probe_fine: int = 20
    render_span_bucket: bool = False
    render_short_samples: int = 12
    train_coarse: int = 12
    train_probe_refresh: int = 0
    train_warmup_steps: int = 125
    train_warmup_samples: int = 48
    train_warmup_rays: int = 0
    train_rays: int = 4096
    train_rng: str = "split"
    train_scan_unroll: int = 4
    train_hit_oversample: int = 4
    n_steps: int = 2500
    lr: float = 1e-2
    weight_decay: float = 1e-6
    adam_moment_dtype: str = "float32"
    huber_delta: float = 0.1
    compute_dtype: Any = torch.bfloat16
    # "fused" (and "auto" for CUDA tensors) runs the CUDA hash-encode kernels;
    # "xla" and "sorted" (the reference's names) run the plain encode, under
    # autograd or with the sort-based backward
    encode_impl: str = "auto"
    field_impl: str = "voxel"
    voxel_grid_size: int = 40
    voxel_features: int = 8
    voxel_pe_freqs: int = 4
    voxel_grad_impl: str = "xla"
    voxel_gather_dtype: str = "bf16"
    bound: str = "sphere"

    def __post_init__(self):
        if self.train_rng not in ("split", "split_inloop", "fused"):
            raise ValueError(
                f"train_rng must be one of 'split', 'split_inloop', 'fused';"
                f" got {self.train_rng!r}"
            )
        if self.train_scan_unroll < 1:
            raise ValueError(
                f"train_scan_unroll must be >= 1; got {self.train_scan_unroll}"
            )
        if self.adam_moment_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"adam_moment_dtype must be 'float32' or 'bfloat16'; "
                f"got {self.adam_moment_dtype!r}"
            )


def sh_encode_deg4(d: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics up to degree 3 (16 coeffs), unit dirs (N,3)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    return torch.stack(
        [
            torch.full_like(x, 0.28209479177387814),
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.31539156525252005 * (3.0 * zz - 1.0),
            -1.0925484305920792 * xz,
            0.5462742152960396 * (xx - yy),
            -0.5900435899266435 * y * (3.0 * xx - yy),
            2.890611442640554 * xy * z,
            -0.4570457994644658 * y * (5.0 * zz - 1.0),
            0.3731763325901154 * z * (5.0 * zz - 3.0),
            -0.4570457994644658 * x * (5.0 * zz - 1.0),
            1.445305721320277 * (xx - yy) * z,
            -0.5900435899266435 * x * (xx - 3.0 * yy),
        ],
        dim=-1,
    )


def init_params(
    generator: torch.Generator, cfg: NerfConfig, device="cuda"
) -> Dict[str, torch.Tensor]:
    """Random field parameters drawn from ``generator``.

    Same shapes and distributions as the reference's ``init_params``
    (Glorot-uniform MLPs, +-1e-4 table or grid); the numbers differ
    because the two frameworks' generators differ.
    """
    if cfg.field_impl == "voxel":
        return init_voxel_params(generator, cfg, device=device)
    in_dim = cfg.grid.out_dim
    h = cfg.hidden
    geo = cfg.geo_features + 1
    col_in = 16 + cfg.geo_features

    def dense(n_in, n_out):
        lim = (6.0 / (n_in + n_out)) ** 0.5
        u = torch.rand((n_in, n_out), generator=generator, device=generator.device)
        return (u * (2.0 * lim) - lim).to(device)

    return {
        "table": init_table(generator, cfg.grid, device=device),
        "sigma_w0": dense(in_dim, h),
        "sigma_w1": dense(h, geo),
        "color_w0": dense(col_in, h),
        "color_w1": dense(h, h),
        "color_w2": dense(h, 3),
    }


def _encode(table, x, cfg: NerfConfig):
    """Dispatch as the reference does: "fused" runs the kernels (forward
    and table gradient), "sorted" the plain encode with the sort-based
    backward, "xla" the plain encode under autograd; "auto" is "fused" for
    CUDA tensors and "xla" on the CPU.  K stacked tables (K, L*T, F) encode
    their own blocks of the object-major points, one call each."""
    if table.dim() == 3:
        xs = x.reshape(table.shape[0], -1, 3)
        return torch.cat([_encode(t, xk, cfg) for t, xk in zip(table.unbind(0), xs.unbind(0))])
    impl = cfg.encode_impl
    if impl == "auto":
        impl = "fused" if x.device.type == "cuda" else "xla"
    if impl == "fused":
        return encode_fused(table, x, cfg.grid)
    if impl == "sorted":
        return encode_sorted(table, x, cfg.grid)
    return encode(table, x, cfg.grid)


def density_raw(params, x, cfg: NerfConfig):
    """x (N,3) in [0,1]^3 -> (raw log-density (N,), geo features (N, G))."""
    feats = _encode(params["table"], x, cfg)
    ct = cfg.compute_dtype
    hmid = torch.clamp_min(dense(feats.to(ct), params["sigma_w0"].to(ct)), 0)
    out = dense(hmid, params["sigma_w1"].to(ct)).to(torch.float32)
    return out[..., 0], out[..., 1:]


def radiance(params, geo_feats, dirs, cfg: NerfConfig):
    """Geometry features + unit view dirs -> rgb in [0,1]."""
    sh = sh_encode_deg4(dirs)
    ct = cfg.compute_dtype
    hcol = torch.cat([sh, geo_feats], dim=-1).to(ct)
    hcol = torch.clamp_min(dense(hcol, params["color_w0"].to(ct)), 0)
    hcol = torch.clamp_min(dense(hcol, params["color_w1"].to(ct)), 0)
    logits = dense(hcol, params["color_w2"].to(ct)).to(torch.float32)
    return torch.sigmoid(logits)


def field(params, x, dirs, cfg: NerfConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Positions + dirs -> (sigma (N,), rgb (N,3))."""
    if cfg.field_impl == "voxel":
        return voxel_field(params, x, dirs, cfg)
    raw, geo = density_raw(params, x, cfg)
    rgb = radiance(params, geo, dirs, cfg)
    return torch.exp(raw), rgb


def density(params, x, cfg: NerfConfig):
    if cfg.field_impl == "voxel":
        raw, _ = voxel_density_raw(params, x, cfg)
        return torch.exp(raw)
    raw, _ = density_raw(params, x, cfg)
    return torch.exp(raw)
