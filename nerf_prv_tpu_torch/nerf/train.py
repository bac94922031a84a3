"""NeRF training loop.

Counterpart of ``nerf_prv_tpu/nerf/train.py``: every step samples a fresh
ray batch from the training images on the device, marches it, and applies
Adam.  Huber loss and Adam(1e-2, 0.9/0.99, eps 1e-15) follow instant-ngp's
defaults.  Losses stay on the device until the end: nothing in the step
loop waits for the host.

What the reference has only to drive a TPU has no counterpart here: the
``lax.scan`` chunks and their ``chunk_steps``, ``cfg.train_scan_unroll``,
the hoisted, packed or fused random streams that ``cfg.train_rng`` chooses
between (all three values draw from the one ``torch.Generator``, in the
order pool index, background, jitter, then the importance uniforms where
``n_importance > 0``), and the frame-bucket padding that spares recompiles
(with it ``build_hit_pool``'s ``n_frames`` mask).  The baked train probe
(``train_probe_refresh > 0``) is rebaked on the step count of its phase,
where the reference counts within each scan chunk.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .model import NerfConfig, init_params
from .rays import RayDataset, pixel_dirs_cam, ray_sphere, rays_from_pixels
from .render import render_rays
from .voxelfield import lattice_corner_raw


class AdamLowp(torch.optim.Optimizer):
    """Adam with both moments stored in ``moment_dtype`` (bfloat16) and
    computed in float32 (≙ ``_scale_by_adam_lowp``).

    The update is memory-bound, several passes over parameters and moments
    per step, and halving the moments' bytes removes about a third of that
    traffic.  bf16's 8-bit mantissa puts ~0.4% relative error on the stored
    moments.  ``weight_decay`` is coupled (added to the gradient before the
    moments), as in ``torch.optim.Adam``.  The step count lives on the
    host, so a step reads nothing back from the device.
    """

    def __init__(self, params, lr, betas=(0.9, 0.99), eps=1e-15, weight_decay=0.0,
                 moment_dtype=torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        self.moment_dtype = moment_dtype

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["mu"] = torch.zeros_like(p, dtype=self.moment_dtype)
                    state["nu"] = torch.zeros_like(p, dtype=self.moment_dtype)
                state["step"] += 1
                # the bias corrections in float32, as the reference takes them
                cf = np.float32(state["step"])
                bc1 = float(np.float32(1.0) - np.float32(b1) ** cf)
                bc2 = float(np.float32(1.0) - np.float32(b2) ** cf)
                g = p.grad
                if group["weight_decay"]:
                    g = g.add(p, alpha=group["weight_decay"])
                mu32 = state["mu"].to(torch.float32).mul_(b1).add_(g, alpha=1.0 - b1)
                nu32 = state["nu"].to(torch.float32).mul_(b2).addcmul_(g, g, value=1.0 - b2)
                state["mu"].copy_(mu32)
                state["nu"].copy_(nu32)
                denom = nu32.div_(bc2).sqrt_().add_(group["eps"])
                p.addcdiv_(mu32.div_(bc1), denom, value=-group["lr"])


def make_optimizer(params: Dict[str, torch.Tensor], cfg: NerfConfig) -> torch.optim.Optimizer:
    """Adam over ``params`` with L2 decay on the MLP weights only.

    ``torch.optim.Adam``'s ``weight_decay`` adds ``wd * p`` to the gradient
    before the moments, which is what the reference's
    ``add_decayed_weights`` then ``scale_by_adam`` chain does (it is not
    AdamW).  ``grid`` and ``table`` are not decayed.  With
    ``cfg.adam_moment_dtype="bfloat16"`` the moments are stored in bf16
    (:class:`AdamLowp`).
    """
    sparse = [v for k, v in params.items() if k in ("table", "grid")]
    dense = [v for k, v in params.items() if k not in ("table", "grid")]
    groups = [
        {"params": dense, "weight_decay": cfg.weight_decay},
        {"params": sparse, "weight_decay": 0.0},
    ]
    if cfg.adam_moment_dtype == "bfloat16":
        return AdamLowp(groups, lr=cfg.lr, betas=(0.9, 0.99), eps=1e-15)
    return torch.optim.Adam(groups, lr=cfg.lr, betas=(0.9, 0.99), eps=1e-15)


@torch.no_grad()
def build_hit_pool(rot, org, camera):
    """Precompute the sphere-hitting pixel set for a training scene.

    The hit set is static per scene, so it is computed once and every
    step samples uniformly from it.  Returns (pool, n_hit): ``pool`` is a
    flat (F*H*W,) int32 tensor whose first ``n_hit`` entries are the flat
    indices (f*H*W + v*W + u) of sphere-hitting pixels, in raster order
    (zeros after them); ``n_hit`` is a Python int, the one count the
    trainer reads back.
    """
    h, w = camera.height, camera.width
    dev = rot.device
    u, v = torch.meshgrid(
        torch.arange(w, dtype=torch.float32, device=dev),
        torch.arange(h, dtype=torch.float32, device=dev),
        indexing="xy",
    )
    d_cam = pixel_dirs_cam(camera, u.reshape(-1), v.reshape(-1))  # (HW, 3)
    d = torch.einsum("fij,nj->fni", rot, d_cam)  # rot orthonormal: stays unit
    _, _, valid = ray_sphere(org[:, None, :], d)
    hits = torch.nonzero(valid.reshape(-1))[:, 0].to(torch.int32)
    n_hit = hits.shape[0]
    pool = torch.zeros((valid.numel(),), dtype=torch.int32, device=dev)
    pool[:n_hit] = hits
    return pool, n_hit


def _pool_ray_batch(flat_idx, pixels_u8, rot, org, camera):
    """Decode flat pool indices -> (origins, dirs, rgba)."""
    n_f, h, w = pixels_u8.shape[:3]
    flat_idx = flat_idx.to(torch.int64)
    f = flat_idx // (h * w)
    p = flat_idx % (h * w)
    vi, ui = p // w, p % w
    o, d = rays_from_pixels(rot, org, camera, f, ui.to(torch.float32), vi.to(torch.float32))
    flat = pixels_u8.reshape(n_f * h * w, pixels_u8.shape[3])
    rgba = flat[flat_idx].to(torch.float32) / 255.0
    return o, d, rgba


def _blend_target(rgba, bg):
    return rgba[:, :3] * rgba[:, 3:4] + bg * (1.0 - rgba[:, 3:4])


def _sample_batch_pooled(generator, pixels_u8, rot, org, camera, n_rays, pool, n_hit):
    """Draw a ray batch uniformly from the precomputed hit-pixel pool.

    A random background colour per ray supervises opacity through the
    known alpha channel.  Returns (origins, dirs, target, bg).
    """
    dev = pixels_u8.device
    r = torch.randint(0, max(n_hit, 1), (n_rays,), generator=generator, device=dev)
    o, d, rgba = _pool_ray_batch(pool[r], pixels_u8, rot, org, camera)
    bg = torch.rand((n_rays, 3), generator=generator, device=dev)
    return o, d, _blend_target(rgba, bg), bg


def _sample_batch(generator, pixels_u8, rot, org, camera, n_rays):
    """Draw a ray batch uniformly over all pixels (the cube bound, which
    has no hit pool and no oversampling)."""
    dev = pixels_u8.device
    n_f, h, w = pixels_u8.shape[:3]
    f = torch.randint(0, n_f, (n_rays,), generator=generator, device=dev)
    ui = torch.randint(0, w, (n_rays,), generator=generator, device=dev)
    vi = torch.randint(0, h, (n_rays,), generator=generator, device=dev)
    o, d = rays_from_pixels(rot, org, camera, f, ui.to(torch.float32), vi.to(torch.float32))
    flat = pixels_u8.reshape(n_f * h * w, pixels_u8.shape[3])
    rgba = flat[(f * h + vi) * w + ui].to(torch.float32) / 255.0
    bg = torch.rand((n_rays, 3), generator=generator, device=dev)
    return o, d, _blend_target(rgba, bg), bg


def _huber_mean(err, cfg: NerfConfig):
    delta = cfg.huber_delta
    abs_err = torch.abs(err)
    huber = torch.where(abs_err <= delta, 0.5 * err * err, delta * (abs_err - 0.5 * delta))
    return torch.mean(huber)


def batch_loss(params, batch, jitter, cfg: NerfConfig, probe_raw=None, generator=None):
    """Huber loss of one ray batch ``(origins, dirs, target, bg)`` marched
    with the stratified ``jitter`` (N, cfg.n_samples), or with uniforms
    drawn from ``generator`` (which ``cfg.n_importance > 0`` needs for its
    resampling); ``probe_raw`` is the baked train probe's table."""
    o, d, target, bg = batch
    rgb, acc = render_rays(
        params, o, d, cfg, jitter=jitter, probe_raw=probe_raw, generator=generator
    )
    return _huber_mean(rgb + bg * (1.0 - acc[:, None]) - target, cfg)


def train_step(params, opt, batch, jitter, cfg: NerfConfig, probe_raw=None, generator=None):
    """One optimizer step on one batch, in place; returns the loss as a
    0-d tensor still on the device."""
    opt.zero_grad(set_to_none=True)
    loss = batch_loss(params, batch, jitter, cfg, probe_raw=probe_raw, generator=generator)
    loss.backward()
    opt.step()
    return loss.detach()


def uses_baked_probe(cfg: NerfConfig) -> bool:
    """Whether training at ``cfg`` probes a baked corner-density table
    (rebaked every ``cfg.train_probe_refresh`` steps) instead of the field."""
    return (
        cfg.train_coarse > 0
        and cfg.train_probe_refresh > 0
        and cfg.field_impl == "voxel"
        and cfg.bound == "sphere"
    )


@torch.no_grad()
def bake_train_probe(params, cfg: NerfConfig) -> torch.Tensor:
    """(g^3, 8) bfloat16 raw corner densities of the live grid."""
    return lattice_corner_raw(params, cfg).to(torch.bfloat16)


def _phases(cfg: NerfConfig, warm_start: bool):
    """(config, steps) per phase: with ``train_coarse`` on, geometry first
    forms during a flat warmup march, then the probe-tightened march takes
    over (the probe needs a meaningful density field to bound against)."""
    if cfg.train_coarse > 0 and cfg.train_warmup_steps > 0 and not warm_start:
        warm = dataclasses.replace(
            cfg,
            train_coarse=0,
            n_samples=cfg.train_warmup_samples,
            train_rays=cfg.train_warmup_rays or cfg.train_rays,
        )
        n_warm = min(cfg.train_warmup_steps, cfg.n_steps)
        return [(warm, n_warm), (cfg, cfg.n_steps - n_warm)]
    return [(cfg, cfg.n_steps)]


def train(
    dataset: RayDataset,
    cfg: Optional[NerfConfig] = None,
    seed: int = 0,
    init_from: Optional[dict] = None,
    device="cuda",
) -> Tuple[dict, np.ndarray]:
    """Train a NeRF on a loaded dataset; returns (params, per-step losses).

    Parameters, pixels (as uint8, moved once) and every random draw live
    on ``device``; the draws come from one ``torch.Generator`` seeded with
    ``seed``.  ``init_from`` warm-starts from a copy of previously trained
    parameters instead of a fresh init; the flat warmup phase is then
    skipped since geometry already exists.
    """
    cfg = cfg or NerfConfig()
    device = torch.device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    if init_from is not None:
        params = {k: torch.as_tensor(v).detach().to(device, copy=True) for k, v in init_from.items()}
    else:
        params = init_params(generator, cfg, device=device)
    for v in params.values():
        v.requires_grad_(True)
    opt = make_optimizer(params, cfg)

    pixels_np = np.clip(np.asarray(dataset.pixels) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    pixels_u8 = torch.from_numpy(pixels_np).to(device)
    rot = torch.as_tensor(np.asarray(dataset.rotations, np.float32), device=device)
    org = torch.as_tensor(np.asarray(dataset.origins, np.float32), device=device)
    camera = dataset.camera
    pool = n_hit = None
    if cfg.bound == "sphere":
        pool, n_hit = build_hit_pool(rot, org, camera)  # the one count read

    losses = []
    for phase_cfg, phase_steps in _phases(cfg, warm_start=init_from is not None):
        n_rays = phase_cfg.train_rays
        baked = uses_baked_probe(phase_cfg)
        probe_raw = None
        for i in range(phase_steps):
            if baked and i % phase_cfg.train_probe_refresh == 0:
                probe_raw = bake_train_probe(params, phase_cfg)
            if pool is not None:
                batch = _sample_batch_pooled(generator, pixels_u8, rot, org, camera, n_rays, pool, n_hit)
            else:
                batch = _sample_batch(generator, pixels_u8, rot, org, camera, n_rays)
            if phase_cfg.n_importance > 0:
                # the march draws its jitter and its resampling uniforms itself
                loss = train_step(params, opt, batch, None, phase_cfg, probe_raw, generator)
            else:
                jitter = torch.rand((n_rays, phase_cfg.n_samples), generator=generator, device=device)
                loss = train_step(params, opt, batch, jitter, phase_cfg, probe_raw)
            losses.append(loss)
    all_losses = torch.stack(losses).cpu().numpy() if losses else np.zeros(0)
    if all_losses.size and not np.isfinite(all_losses[-min(100, all_losses.size):]).all():
        print(
            "[train] WARNING: non-finite losses in the final steps: "
            "fit diverged; downstream metrics for this scene are suspect"
        )
    return {k: v.detach() for k, v in params.items()}, all_losses
