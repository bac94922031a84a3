"""High-level NeRF API mirroring the reference's ``run.py`` semantics.

Counterpart of ``nerf_prv_tpu/nerf/api.py``: train a field or load a
snapshot, score it against a test set, render screenshots, export the
surface and render a camera-path video.

- :func:`train_nerf`        — ``--train --scene ... --n_steps ...``
- :func:`eval_nerf`         — ``--test_transforms ... --save_metrics ...``
- :func:`screenshot_nerf`   — ``--screenshot_transforms ... --screenshot_dir``
- :func:`run`               — all of the above in one call, as the command line does.

Training runs on the ``device``
the caller names (the card by default); renders and metrics run on the
device of the parameters.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..convert import params_from_numpy, params_to_numpy
from ..utils.timing import span
from .extract import render_video, save_geometry
from .metrics import evaluate_pair, mse2psnr
from .model import NerfConfig
from .rays import RayDataset, load_dataset
from .render import build_render_aux, render_views
from .train import train


def train_nerf(
    scene_json: str,
    cfg: Optional[NerfConfig] = None,
    seed: int = 0,
    init_from: Optional[dict] = None,
    device="cuda",
) -> Tuple[dict, RayDataset]:
    """Train a field on the scene's images; returns (params, dataset)."""
    cfg = cfg or NerfConfig()
    dataset = load_dataset(scene_json, with_images=True)
    params, _ = train(dataset, cfg, seed=seed, init_from=init_from, device=device)
    return params, dataset


def save_snapshot(path: str, params: dict) -> None:
    """Persist field parameters as the reference's npz snapshot (≙
    ``--save_snapshot``).  Writes to ``path`` exactly."""
    with open(path, "wb") as f:
        np.savez(f, **params_to_numpy(params))


def load_snapshot(path: str, cfg: Optional[NerfConfig] = None, device="cuda") -> dict:
    """Load parameters saved by either package's ``save_snapshot`` (≙
    ``--load_snapshot``) onto ``device``, validated against ``cfg`` when
    given.  The npz format is not instant-ngp's ``.ingp`` msgpack."""
    params = params_from_numpy(path, device)
    if cfg is not None:
        validate_snapshot(params, cfg)
    return params


def validate_snapshot(params: dict, cfg: NerfConfig) -> None:
    """Raise ValueError when a loaded parameter tree cannot belong to cfg."""
    if cfg.field_impl == "voxel":
        if "grid" not in params:
            raise ValueError(
                "snapshot has no 'grid' — not a voxel-field snapshot "
                f"(keys: {sorted(params)}); cfg.field_impl='voxel'"
            )
        g = cfg.voxel_grid_size
        want = (g * g * g, 8 * cfg.voxel_features)
        got = tuple(params["grid"].shape)
        if got != want:
            raise ValueError(
                f"snapshot grid shape {got} != cfg's {want} "
                f"(voxel_grid_size={g}, voxel_features={cfg.voxel_features})"
            )
    elif cfg.field_impl == "hash":
        if "table" not in params:
            raise ValueError(
                "snapshot has no 'table' — not a hash-field snapshot "
                f"(keys: {sorted(params)}); cfg.field_impl='hash'"
            )


@torch.no_grad()
def eval_nerf(params, test_json, cfg: Optional[NerfConfig] = None) -> Dict[str, float]:
    """PSNR/SSIM against the test set (≙ run.py:213-277: per-image PSNR
    averaged, black background, sRGB-clipped).

    ``test_json`` may be a transforms.json path or a preloaded
    :class:`RayDataset`.
    """
    with span("eval_nerf"):
        cfg = cfg or NerfConfig()
        ds = (
            test_json
            if isinstance(test_json, RayDataset)
            else load_dataset(test_json, with_images=True)
        )
        device = next(iter(params.values())).device
        aux = build_render_aux(params, cfg)  # once per eval, not per group
        psnrs, ssims, mses = [], [], []
        group = 8  # frames rendered + scored per batch
        for start in range(0, ds.n_frames, group):
            stop = min(start + group, ds.n_frames)
            with span("eval.render"):
                imgs = render_views(
                    params, ds.origins[start:stop], ds.rotations[start:stop], ds.camera, cfg, aux=aux
                )
            with span("eval.score"):
                gt = torch.as_tensor(ds.pixels[start:stop], device=device)
                p, s, m = evaluate_pair(imgs[..., :3], gt[..., :3] * gt[..., 3:4])
                psnrs.append(p.cpu().numpy())
                ssims.append(s.cpu().numpy())
                mses.append(m.cpu().numpy())
        psnr = np.concatenate(psnrs) if psnrs else np.zeros(0, np.float32)
        ssim = np.concatenate(ssims) if ssims else np.zeros(0, np.float32)
        mse = np.concatenate(mses) if mses else np.zeros(0, np.float32)
        return {
            "PSNR": float(psnr.mean()) if len(psnr) else 0.0,
            "SSIM": float(ssim.mean()) if len(ssim) else 0.0,
            "PSNR_avgmse": float(mse2psnr(torch.tensor(mse.mean()))) if len(mse) else 0.0,
            "min_PSNR": float(psnr.min()) if len(psnr) else float("inf"),
            "max_PSNR": float(psnr.max()) if len(psnr) else -float("inf"),
        }


def save_metrics(path: str, metrics: Dict[str, float]) -> None:
    """``PSNR\\t<v>\\nSSIM\\t<v>`` file (≙ run.py:274-277)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(f"PSNR\t{metrics['PSNR']}\n")
        f.write(f"SSIM\t{metrics['SSIM']}")


def load_metrics(path: str) -> Dict[str, float]:
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 2:
                out[parts[0]] = float(parts[1])
    return out


@torch.no_grad()
def screenshot_nerf(params, render_json: str, out_dir: str, cfg: Optional[NerfConfig] = None) -> None:
    """Render every frame of ``render_json`` to ``out_dir/<basename>.png``
    as RGBA (alpha = accumulated density) (≙ run.py:284-309)."""
    from PIL import Image

    from ..core.transforms import load_transforms

    cfg = cfg or NerfConfig()
    ds = load_dataset(render_json, with_images=False)
    tf = load_transforms(render_json)
    os.makedirs(out_dir, exist_ok=True)
    aux = build_render_aux(params, cfg)  # once per screenshot set
    group = 16
    for start in range(0, ds.n_frames, group):
        stop = min(start + group, ds.n_frames)
        imgs = render_views(
            params, ds.origins[start:stop], ds.rotations[start:stop], ds.camera, cfg, aux=aux
        )
        u8 = torch.clamp(torch.round(imgs * 255.0), 0, 255).to(torch.uint8).cpu().numpy()
        for i in range(stop - start):
            name = os.path.basename(tf.file_paths[start + i])
            if not os.path.splitext(name)[1]:
                name += ".png"
            Image.fromarray(u8[i], "RGBA").save(os.path.join(out_dir, name))


def run(
    scene: str,
    n_steps: Optional[int] = None,
    test_transforms: Optional[str] = None,
    save_metrics_path: Optional[str] = None,
    screenshot_transforms: Optional[str] = None,
    screenshot_dir: Optional[str] = None,
    cfg: Optional[NerfConfig] = None,
    seed: int = 0,
    load_snapshot_path: Optional[str] = None,
    save_snapshot_path: Optional[str] = None,
    save_mesh_path: Optional[str] = None,
    marching_cubes_res: int = 128,
    video_camera_path: Optional[str] = None,
    video_output: str = "video.mp4",
    video_fps: int = 30,
    device="cuda",
) -> Optional[Dict[str, float]]:
    """In-process equivalent of one ``run.py`` invocation, on ``device``:
    train on ``scene`` (or load a snapshot instead), then score,
    screenshot, export the surface (``save_mesh_path``, sampled at
    ``marching_cubes_res``^3) and render a camera-path video.
    """
    cfg = cfg or NerfConfig()
    if n_steps is not None:
        cfg = dataclasses.replace(cfg, n_steps=n_steps)
    if load_snapshot_path:
        params = load_snapshot(load_snapshot_path, cfg, device=device)
    else:
        params, _ = train_nerf(scene, cfg, seed=seed, device=device)
    if save_snapshot_path:
        save_snapshot(save_snapshot_path, params)
    metrics = None
    if test_transforms:
        metrics = eval_nerf(params, test_transforms, cfg)
        if save_metrics_path:
            save_metrics(save_metrics_path, metrics)
    if screenshot_transforms and screenshot_dir:
        screenshot_nerf(params, screenshot_transforms, screenshot_dir, cfg)
    if save_mesh_path:
        save_geometry(params, cfg, save_mesh_path, resolution=marching_cubes_res)
    if video_camera_path:
        render_video(params, video_camera_path, video_output, cfg, fps=video_fps)
    return metrics
