"""The multi-chip dry run, in PyTorch: one training step on each of the
reference's three meshes.

Counterpart of ``__graft_entry__.py``'s ``dryrun_multichip`` /
``_dryrun_impl``, at its tiny configuration, with its asserts:

- **ep x dp ensemble step.**  ``2 * ep`` voxel NeRFs stacked on a leading
  axis (as ``nerf/batch_train.py`` stacks objects), their member chunks
  split over ``ep``, the rays (the same for every member) over ``dp``; one
  loss-and-Adam step, each device marching its members on its rays through
  the K-grids-as-one-table gather of ``nerf/voxelfield.py``;
- **batched dp step.**  ``train_batch`` over a ``dp`` mesh, one 16x16
  object per device, 2 steps;
- **tp x dp step.**  The voxel field with its grid rows sharded over ``tp``
  and the samples over ``dp`` (:func:`.mesh.tp_voxel_field`), one Adam
  step; the grid stays row-sharded.

The reference re-executes itself on virtual CPU devices where fewer chips
exist; the port's mesh may list one device several times instead, so the
dry run takes the first ``n_devices`` cards, or ``cuda:0`` ``n_devices``
times where fewer cards exist (or the ``devices`` the caller names, such as
``["cpu"] * 4``).  ``torch.func.vmap`` cannot map over the ctypes kernels,
so the ensemble is written as a stacked batch, not a vmap.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .mesh import Mesh, make_mesh, shard_rows, tp_voxel_field


def _tiny_cfg():
    from ..nerf.model import NerfConfig

    return NerfConfig(
        voxel_grid_size=16,
        voxel_features=4,
        hidden=64,
        n_samples=16,
        render_probe_coarse=4,
        render_probe_fine=8,
        train_rays=256,
        n_steps=4,
    )


def _devices(n_devices: int, devices: Optional[Sequence]) -> List[torch.device]:
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if len(devices) != n_devices:
            raise ValueError(f"{len(devices)} devices named for a dry run on {n_devices}")
        return devices
    if not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA card is visible; pass devices=['cpu'] * n to run on the CPU")
    if torch.cuda.device_count() >= n_devices:
        return [torch.device("cuda", i) for i in range(n_devices)]
    return [torch.device("cuda", 0)] * n_devices


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def _leaf(t: torch.Tensor, device) -> torch.Tensor:
    return t.detach().to(device, copy=True).requires_grad_(True)


def ensemble_step(mesh: Mesh, cfg, seed: int = 0) -> np.ndarray:
    """One loss-and-Adam step of ``2 * ep`` stacked members on an (ep, dp)
    mesh; returns each member's loss (n_ensemble,).  Member chunk e lives on
    ``mesh.devices[e, 0]``; device (e, j) renders chunk e's members on ray
    chunk j (its parameters moved there by ``.to``), and each member's loss
    is the rays' mean, summed on the chunk's device from the ray chunks'
    shares."""
    from ..nerf.batch_train import init_batched_params
    from ..nerf.render import render_rays
    from ..nerf.train import make_optimizer

    ep, dp = mesh.devices.shape
    n_ensemble = ep * 2  # more members than shards: each shard holds several
    per = n_ensemble // ep
    n_rays = dp * 64
    home = mesh.devices[0, 0]
    g = torch.Generator(device=home).manual_seed(seed)
    params = init_batched_params(g, cfg, n_ensemble, device=home)
    chunks = [{k: _leaf(v[e * per:(e + 1) * per], mesh.devices[e, 0]) for k, v in params.items()} for e in range(ep)]
    opts = [make_optimizer(c, cfg) for c in chunks]
    origins = torch.cat([torch.rand((n_rays, 2), generator=g, device=home),
                         torch.full((n_rays, 1), -0.5, device=home)], dim=-1)
    dirs = torch.tensor([[0.0, 0.0, 1.0]], device=home).expand(n_rays, 3).contiguous()
    targets = torch.rand((n_rays, 3), generator=g, device=home)
    c = n_rays // dp
    losses = []
    for e in range(ep):
        total = None
        for j in range(dp):
            dev = mesh.devices[e, j]
            p = {k: v.to(dev) for k, v in chunks[e].items()}
            rays = slice(j * c, (j + 1) * c)
            o, d, t = (v[rays].to(dev).repeat(per, 1) for v in (origins, dirs, targets))
            rgb, _ = render_rays(p, o, d, cfg)  # members' rays object-major
            share = ((rgb - t) ** 2).reshape(per, -1).mean(dim=1) * (c / n_rays)
            share = share.to(mesh.devices[e, 0])
            total = share if total is None else total + share
        losses.append(total)
    for opt in opts:
        opt.zero_grad(set_to_none=True)
    torch.autograd.backward([l.sum() for l in losses])  # each member's gradient its own loss's
    for opt in opts:
        opt.step()
    return torch.cat([l.detach().to(home) for l in losses]).cpu().numpy()


def batched_dp_step(mesh: Mesh, cfg, n_steps: int = 2, seed: int = 3) -> np.ndarray:
    """``train_batch`` over the mesh's ``dp`` devices with one random 16x16
    object (2 frames) per device, ``n_steps`` steps; returns the (steps, K)
    losses."""
    import dataclasses

    from ..core.config import CameraConfig
    from ..nerf.batch_train import train_batch
    from ..nerf.rays import RayDataset

    cam = CameraConfig(width=16, height=16, fx=16.0, fy=16.0, ppx=8.0, ppy=8.0, model=0)
    k_obj = mesh.size  # one tiny object per device
    rng = np.random.default_rng(0)
    datasets = [
        RayDataset(
            origins=np.tile(np.array([0.5, 0.5, -0.5], np.float32), (2, 1)),
            rotations=np.tile(np.eye(3, dtype=np.float32), (2, 1, 1)),
            pixels=rng.integers(0, 255, (2, 16, 16, 4)).astype(np.float32) / 255.0,
            camera=cam, scale=1.0, offset=np.zeros(3, np.float32),
        )
        for _ in range(k_obj)
    ]
    _, losses = train_batch(datasets, dataclasses.replace(cfg, n_steps=n_steps), seed=seed, mesh=mesh)
    return losses


def tp_dp_step(mesh: Mesh, seed: int = 4):
    """One Adam step of the voxel field at the reference's tp-step config
    with its grid rows sharded over ``tp`` and the samples over ``dp``;
    returns (loss, the grid's shards after the step)."""
    from ..nerf.model import NerfConfig, init_params
    from ..nerf.train import make_optimizer

    vcfg = NerfConfig(voxel_grid_size=20, voxel_features=4, hidden=32)
    tp, dp = mesh.shape["tp"], mesh.shape["dp"]
    home = mesh.devices[0, 0]
    g = torch.Generator(device=home).manual_seed(seed)
    vparams = init_params(g, vcfg, device=home)
    others = {k: _leaf(v, home) for k, v in vparams.items() if k != "grid"}
    shards = shard_rows(vparams["grid"].requires_grad_(True), mesh)
    n = dp * 128
    x = torch.rand((n, 3), generator=g, device=home) * 0.98 + 0.01
    dv = torch.randn((n, 3), generator=g, device=home)
    dv = dv / torch.linalg.norm(dv, dim=-1, keepdim=True)
    tgt = torch.rand((n, 3), generator=g, device=home)
    opt = make_optimizer(others, vcfg)
    opt.add_param_group({"params": shards, "weight_decay": 0.0})  # the grid is not decayed
    opt.zero_grad(set_to_none=True)
    sig, rgb = tp_voxel_field(mesh, dict(others, grid=shards), x, dv, vcfg, batch_axis="dp")
    loss = torch.mean((rgb - tgt) ** 2) + 1e-6 * torch.mean(sig)
    loss.backward()
    opt.step()
    _check(all(s.grad is not None for s in shards), "a grid shard got no gradient")
    return float(loss.detach()), shards


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> dict:
    """Run and check one step on each of the reference's three meshes over
    ``n_devices`` devices (see the module docstring); returns the ensemble's
    losses (n_ensemble,), the batched step's (2, n_devices), the tp step's
    loss and the grid shards' shapes."""
    devices = _devices(n_devices, devices)
    cfg = _tiny_cfg()
    ep = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(("ep", "dp"), (ep, n_devices // ep), devices)
    losses = ensemble_step(mesh, cfg)
    _check(losses.shape == (ep * 2,), f"ensemble losses {losses.shape}")
    _check(bool(np.isfinite(losses).all()), "ensemble losses not finite")

    blosses = batched_dp_step(make_mesh(("dp",), devices=devices), cfg)
    _check(blosses.shape == (2, n_devices), f"batched losses {blosses.shape}")
    _check(bool(np.isfinite(blosses).all()), "batched losses not finite")

    tp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh_tp = make_mesh(("tp", "dp"), (tp, n_devices // tp), devices)
    vloss, shards = tp_dp_step(mesh_tp)
    _check(bool(np.isfinite(vloss)), "tp step loss not finite")
    rows = 20 ** 3 // tp
    tp_devices = list(mesh_tp.devices[:, 0])
    _check(len(shards) == tp and all(s.shape[0] == rows and s.device == d for s, d in zip(shards, tp_devices)),
           "the grid is not row-sharded over tp after the step")
    return dict(ensemble_losses=losses, batch_losses=blosses, tp_loss=vloss,
                grid_shards=[tuple(s.shape) for s in shards])
