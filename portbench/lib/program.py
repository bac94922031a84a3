"""What the benchmark takes from the program under test: its configuration
type, its dataset type, its kernel build and its entry points.  Imported
only after the card has been found, and never by the reference."""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from .scene import Camera


def nerf_config(nerf: dict):
    """The program's ``NerfConfig`` from a configuration file's ``nerf`` keys."""
    model = importlib.import_module("nerf_prv_tpu_torch.nerf.model")
    hashgrid = importlib.import_module("nerf_prv_tpu_torch.nerf.hashgrid")
    kw = dict(nerf)
    kw["grid"] = hashgrid.HashGridConfig(**kw["grid"])
    kw["compute_dtype"] = getattr(torch, kw["compute_dtype"])
    return model.NerfConfig(**kw)


def camera(cam: Camera):
    """The program's camera: the pinhole the frames were splatted through."""
    config = importlib.import_module("nerf_prv_tpu_torch.core.config")
    return config.CameraConfig(width=cam.width, height=cam.height, fx=cam.fx, fy=cam.fy, ppx=cam.ppx,
                               ppy=cam.ppy, model=0, k1=0.0, k2=0.0, k3=0.0, p1=0.0, p2=0.0)


def ray_dataset(views, cam: Camera):
    """The program's in-memory dataset of one object's frames, pixels as the
    loader gives them (float32 in [0, 1])."""
    rays = importlib.import_module("nerf_prv_tpu_torch.nerf.rays")
    return rays.RayDataset(origins=views.origins, rotations=views.rotations,
                           pixels=views.pixels.astype(np.float32) / np.float32(255.0),
                           camera=camera(cam), scale=views.scale, offset=views.offset)


def build(kernels, device) -> float:
    """Build the kernels the cell runs, together (on the CPU the program
    takes their plain versions and builds nothing); returns the seconds it
    took, which only the first run in a checkout spends compiling."""
    t0 = time.perf_counter()
    if device.type == "cuda":
        importlib.import_module("nerf_prv_tpu_torch.ops._build").build(list(kernels))
    return time.perf_counter() - t0


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def entry(module: str, name: str):
    return getattr(importlib.import_module(module), name)
