"""Batched multi-object NeRF training: the dataset-generation scaling axis.

Counterpart of ``nerf_prv_tpu/nerf/batch_train.py``.  Generating the PRV
dataset means training one field per (object, view count), thousands of
them (SURVEY.md §7 hard part (e)); here K objects train together, every
step one program for all K.  Parameters carry a leading object axis
(``grid`` (K, g^3, 8F) or ``table`` (K, L*T, F), the MLP weights (K, in,
out)), and the K objects' rays are flattened into one object-major ray
axis, so the existing march and compositing run on all K*N rays at once:

- the voxel field reads the K grids as one (K*g^3, 8F) table, object k's
  rows offset by k*g^3, so each march gathers through one ``row_gather``
  launch and the backward scatter-adds through one ``row_scatter_add``
  launch for all K objects (:mod:`.voxelfield`);
- each MLP layer is one batched product over the object axis;
- the hash field encodes each object's block with its own table, one
  K1 launch (and one K1b in the backward) per object and march.

A single-object step on the card is host-bound (the device idles while
Python dispatches a few hundred small kernels), and a K-object step pays
that dispatch once for all K.

Each object samples only its own frames: padded frames are never drawn,
and with ``cfg.bound == "sphere"`` each object draws from its own hit
pool.  The loss is the sum of the objects' mean Huber losses, so each
object's gradient is the gradient of its own mean loss, and one Adam over
the stacked tensors is K independent Adams (it is elementwise; the bias
correction shares one step count, as the reference's vmapped optax state
does).  All draws come from one ``torch.Generator`` per device, in (K, N)
blocks, and the step loop never waits for the host.

Where the port differs from the reference: training follows the
single-object trainer's phase plan (:func:`.train._phases`: a flat warmup
march, then the probe-tightened one), where the reference's batched scan
runs ``cfg`` for every step; the train probe reads the field (as the
reference's batched step does), so ``train_probe_refresh`` has no effect
here.  With a ``mesh``, K is padded to a multiple of its ``dp`` size by
repeating the last dataset (≙ ``pipeline/modes.py:199-205``) and each
device trains its chunk of objects with its own generator and Adam; the
devices' step loops are interleaved (step s on every device, then step
s + 1), so that, the loop never waiting for the host, one device's launches
queue while another runs (≙ the reference's object axis sharded over
``dp``).  The result equals training the chunks one after another, and the
padded objects are dropped from it.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .model import NerfConfig, init_params
from .rays import RayDataset, rays_from_pixels
from .render import render_rays
from .train import _blend_target, _huber, _phases, _pool_ray_batch, build_hit_pool, make_optimizer


def stack_datasets(datasets: Sequence[RayDataset]):
    """Pad + stack K datasets -> (pixels (K, F, H, W, 4) uint8, rotations
    (K, F, 3, 3), origins (K, F, 3), frame counts (K,)), F the largest
    count; padded frames are black with identity rotations."""
    max_f = max(ds.n_frames for ds in datasets)
    h, w = datasets[0].hw
    k = len(datasets)
    pixels = np.zeros((k, max_f, h, w, 4), np.uint8)
    rot = np.zeros((k, max_f, 3, 3), np.float32)
    org = np.zeros((k, max_f, 3), np.float32)
    n_frames = np.zeros((k,), np.int32)
    for i, ds in enumerate(datasets):
        f = ds.n_frames
        pixels[i, :f] = np.clip(np.asarray(ds.pixels) * 255.0 + 0.5, 0, 255).astype(np.uint8)
        rot[i, :f] = ds.rotations
        org[i, :f] = ds.origins
        rot[i, f:] = np.eye(3)  # harmless padding
        n_frames[i] = f
    return pixels, rot, org, n_frames


class Objects(NamedTuple):
    """K objects' training data on one device, frames flattened to K*F."""

    pixels: torch.Tensor      # (K*F, H, W, 4) uint8
    rot: torch.Tensor         # (K*F, 3, 3)
    org: torch.Tensor         # (K*F, 3)
    n_frames: torch.Tensor    # (K,) float64, each object's real frame count
    pools: Optional[torch.Tensor]  # (K, F*H*W): hit pixels, flat into ``pixels``
    n_hit: Optional[torch.Tensor]  # (K,) float64, each pool's length
    camera: object

    @property
    def k(self) -> int:
        return self.n_frames.shape[0]


def upload_objects(datasets: Sequence[RayDataset], cfg: NerfConfig, device="cuda") -> Objects:
    """Stack the datasets and move them to ``device``; with the sphere bound,
    build each object's hit pool over its real frames only."""
    device = torch.device(device)
    pixels, rot, org, n_frames = stack_datasets(datasets)
    k, f, h, w = pixels.shape[:4]
    camera = datasets[0].camera
    px = torch.from_numpy(pixels).to(device).reshape(k * f, h, w, 4)
    rot_t = torch.from_numpy(rot).to(device).reshape(k * f, 3, 3)
    org_t = torch.from_numpy(org).to(device).reshape(k * f, 3)
    pools = n_hit = None
    if cfg.bound == "sphere":
        dtype = torch.int32 if k * f * h * w < 2**31 else torch.int64
        pools = torch.zeros((k, f * h * w), dtype=dtype, device=device)
        hits = []
        for i in range(k):
            lo, hi = i * f, i * f + int(n_frames[i])
            pool, n = build_hit_pool(rot_t[lo:hi], org_t[lo:hi], camera)
            pools[i] = lo * h * w  # a scene with no hit draws its own first pixel
            pools[i, :n] += pool[:n].to(dtype)
            hits.append(max(n, 1))
        n_hit = torch.tensor(hits, dtype=torch.float64, device=device)
    counts = torch.as_tensor(n_frames, dtype=torch.float64, device=device)
    return Objects(px, rot_t, org_t, counts, pools, n_hit, camera)


def sample_objects(generator: torch.Generator, obj: Objects, n_rays: int):
    """One ray batch of ``n_rays`` per object, object-major: (origins,
    dirs, target, bg), each (K*n_rays, 3).  Each object draws uniformly
    from its own hit pool, or (cube bound) over its own real frames."""
    dev = obj.pixels.device
    k = obj.k
    nf, h, w = obj.pixels.shape[:3]
    u = torch.rand((k, n_rays), generator=generator, device=dev, dtype=torch.float64)
    if obj.pools is not None:
        r = (u * obj.n_hit[:, None]).to(torch.int64)
        flat = torch.gather(obj.pools, 1, r).reshape(-1)
        o, d, rgba = _pool_ray_batch(flat, obj.pixels, obj.rot, obj.org, obj.camera)
    else:
        first = torch.arange(k, device=dev)[:, None] * (nf // k)
        f = ((u * obj.n_frames[:, None]).to(torch.int64) + first).reshape(-1)
        ui = torch.randint(0, w, (k * n_rays,), generator=generator, device=dev)
        vi = torch.randint(0, h, (k * n_rays,), generator=generator, device=dev)
        o, d = rays_from_pixels(obj.rot, obj.org, obj.camera, f, ui.to(torch.float32), vi.to(torch.float32))
        flat_px = obj.pixels.reshape(nf * h * w, obj.pixels.shape[3])
        rgba = flat_px[(f * h + vi) * w + ui].to(torch.float32) / 255.0
    bg = torch.rand((k * n_rays, 3), generator=generator, device=dev)
    return o, d, _blend_target(rgba, bg), bg


def n_objects(params) -> int:
    return params["sigma_w0"].shape[0]


def batch_loss(params, batch, jitter, cfg: NerfConfig, generator=None) -> torch.Tensor:
    """Each object's mean Huber loss (K,) over its block of the object-major
    ray batch ``(origins, dirs, target, bg)``, marched with ``jitter``
    (K*N, cfg.n_samples) or with draws from ``generator``."""
    o, d, target, bg = batch
    rgb, acc = render_rays(params, o, d, cfg, jitter=jitter, generator=generator)
    err = rgb + bg * (1.0 - acc[:, None]) - target
    return _huber(err, cfg).reshape(n_objects(params), -1).mean(dim=1)


def train_step(params, opt, batch, jitter, cfg: NerfConfig, generator=None) -> torch.Tensor:
    """One optimizer step for all K objects, in place; returns the (K,)
    losses, still on the device."""
    opt.zero_grad(set_to_none=True)
    losses = batch_loss(params, batch, jitter, cfg, generator=generator)
    losses.sum().backward()  # object k's gradient: that of its own mean loss
    opt.step()
    return losses.detach()


def init_batched_params(generator: torch.Generator, cfg: NerfConfig, k: int, device="cuda"):
    """K fresh parameter sets from ``generator``, stacked on a leading axis."""
    sets = [init_params(generator, cfg, device=device) for _ in range(k)]
    return {name: torch.stack([p[name] for p in sets]) for name in sets[0]}


class _ObjectsTrainer:
    """K objects trained together on one device, one step a call: the
    generator (seeded ``seed``), the stacked parameters and their Adam."""

    def __init__(self, datasets, cfg: NerfConfig, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.k = len(datasets)
        self.params = init_batched_params(self.generator, cfg, self.k, device=self.device)
        for v in self.params.values():
            v.requires_grad_(True)
        self.opt = make_optimizer(self.params, cfg)
        self.obj = upload_objects(datasets, cfg, self.device)
        self.losses: List[torch.Tensor] = []

    def step(self, phase_cfg: NerfConfig) -> None:
        n_rays = phase_cfg.train_rays
        batch = sample_objects(self.generator, self.obj, n_rays)
        if phase_cfg.n_importance > 0:
            # the march draws its jitter and its resampling uniforms itself
            loss = train_step(self.params, self.opt, batch, None, phase_cfg, self.generator)
        else:
            jitter = torch.rand((self.k * n_rays, phase_cfg.n_samples), generator=self.generator, device=self.device)
            loss = train_step(self.params, self.opt, batch, jitter, phase_cfg)
        self.losses.append(loss)

    def result(self) -> Tuple[dict, np.ndarray]:
        k = self.k
        all_losses = torch.stack(self.losses).cpu().numpy() if self.losses else np.zeros((0, k), np.float32)
        if all_losses.size and not np.isfinite(all_losses[-min(100, len(all_losses)):]).all():
            print(
                "[train_batch] WARNING: non-finite losses in the final steps: "
                "a fit diverged; downstream metrics for those scenes are suspect"
            )
        return {name: v.detach() for name, v in self.params.items()}, all_losses


def _train_interleaved(trainers: Sequence[_ObjectsTrainer], cfg: NerfConfig) -> None:
    """Every trainer's steps, step s on each in turn before step s + 1."""
    for phase_cfg, phase_steps in _phases(cfg, warm_start=False):
        for _ in range(phase_steps):
            for t in trainers:
                t.step(phase_cfg)


def _train_objects(datasets, cfg: NerfConfig, seed: int, device) -> Tuple[dict, np.ndarray]:
    """Train K objects together on one device."""
    trainer = _ObjectsTrainer(datasets, cfg, seed, device)
    _train_interleaved([trainer], cfg)
    return trainer.result()


def train_batch(
    datasets: Sequence[RayDataset],
    cfg: Optional[NerfConfig] = None,
    seed: int = 0,
    mesh=None,
    chunk_steps: int = 500,
    device="cuda",
) -> Tuple[dict, np.ndarray]:
    """Train K NeRFs at once on ``device``; returns (params with a leading K
    axis, per-object per-step losses (steps, K) as numpy).

    With a ``mesh`` (``parallel.make_mesh``) the objects are padded to a
    multiple of its ``dp`` size and each device trains its chunk, chunk i
    from a generator seeded with ``seed + i``, the devices' steps
    interleaved; the result lies on the first device (``device`` is then
    unused).  ``chunk_steps`` is kept for the reference's signature: it
    sizes the reference's scan chunks, and the port has no scan (the losses
    stay on the device until the end).
    """
    del chunk_steps
    cfg = cfg or NerfConfig()
    datasets = list(datasets)
    if mesh is None:
        return _train_objects(datasets, cfg, seed, device)
    from ..parallel.mesh import _axis_devices

    devices = _axis_devices(mesh, "dp")
    k, m = len(datasets), len(devices)
    padded = datasets + [datasets[-1]] * ((-k) % m)
    c = len(padded) // m
    trainers = [_ObjectsTrainer(padded[i * c : (i + 1) * c], cfg, seed + i, dev) for i, dev in enumerate(devices)]
    _train_interleaved(trainers, cfg)
    results = [t.result() for t in trainers]
    first = devices[0]
    params = {name: torch.cat([p[name].to(first) for p, _ in results])[:k] for name in results[0][0]}
    losses = np.concatenate([ls for _, ls in results], axis=1)[:, :k]
    return params, losses


def slice_params(batched_params, i: int) -> dict:
    """Object i's parameters from a batched train, as ``eval_nerf`` and
    ``save_snapshot`` take them."""
    return {k: v[i] for k, v in batched_params.items()}
