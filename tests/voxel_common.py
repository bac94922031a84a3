"""Shared fixtures of the voxel-field parity tests: one small configuration
on both sides and numpy parameters that both read."""

import jax.numpy as jnp
import numpy as np
import torch

from nerf_prv_tpu.nerf import model as jm
from nerf_prv_tpu_torch.convert import params_from_numpy
from nerf_prv_tpu_torch.nerf import model as tm

G = 12  # voxel_grid_size


def cfgs(compute="f32", **kw):
    """(JAX config, port config): grid 12^3, hidden 64, the rest default."""
    kw = dict(voxel_grid_size=G, **kw)
    jcfg = jm.NerfConfig(compute_dtype=jnp.float32 if compute == "f32" else jnp.bfloat16, **kw)
    tcfg = tm.NerfConfig(compute_dtype=torch.float32 if compute == "f32" else torch.bfloat16, **kw)
    return jcfg, tcfg


def np_params(cfg, seed=0, grid_scale=1.0, density_gain=4.0):
    """Voxel parameters from numpy: O(1) grid features so the blend
    matters, and a density column scaled so sigma runs from ~0 to
    saturating."""
    rng = np.random.default_rng(seed)
    g, f, h = cfg.voxel_grid_size, cfg.voxel_features, cfg.hidden
    geo = cfg.geo_features + 1

    def dense(n_in, n_out):
        lim = np.sqrt(6.0 / (n_in + n_out))
        return rng.uniform(-lim, lim, size=(n_in, n_out)).astype(np.float32)

    p = {
        "grid": rng.uniform(-grid_scale, grid_scale, size=(g ** 3, 8 * f)).astype(np.float32),
        "sigma_w0": dense(f + 6 * cfg.voxel_pe_freqs, h),
        "sigma_w1": dense(h, geo),
        "color_w0": dense(16 + cfg.geo_features, h),
        "color_w1": dense(h, h),
        "color_w2": dense(h, 3),
    }
    p["sigma_w1"][:, 0] *= density_gain
    return p


def both(p):
    """numpy parameters -> (JAX tree, port tensors on the CPU)."""
    return {k: jnp.asarray(v) for k, v in p.items()}, params_from_numpy(p, device="cpu")


def points(n=400, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    # the volume's corners and faces, the clip point, and cell faces
    x[:6] = [[0, 0, 0], [1, 1, 1], [1 - 1e-6] * 3, [0, 1, 0.5], [1 / (G - 1), 2 / (G - 1), 1], [0.5, 0.5, 0.5]]
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return x, d


def rays(n=256, seed=0):
    """Rays towards the volume from outside; the first 16 point away."""
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 0.1 + np.array([0.5, 0.5, 2.0])).astype(np.float32)
    tgt = rng.uniform(0.2, 0.8, size=(n, 3))
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[:16] = [0.0, 0.0, 1.0]
    return o, d
