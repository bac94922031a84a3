"""How many times the path launches each hand-written kernel, from the code.

The card checks and ``chip_smoke.py`` hold the wrappers' launch counts
(``row_gather.launches``, ``row_scatter_add.launches``, ``splat.launches``)
to these numbers.  Where a count depends on the run's data (how many rays
hit the bounding sphere, or survive the level-1 probe), the data is
counted here by replaying the render's own compaction, which launches no
kernel.
"""

from __future__ import annotations

import math

import torch

from ..nerf import render as render_mod
from ..nerf.model import NerfConfig
from ..nerf.rays import load_dataset
from ..ops.row_gather import row_gather

EVAL_GROUP = 8  # frames ``api.eval_nerf`` renders at once
SCREENSHOT_GROUP = 16  # frames ``api.screenshot_nerf`` renders at once
TILE_PATH_WIDTH = 512  # ``render_views`` compacts by tile from this width on


def train_launches(cfg: NerfConfig) -> tuple:
    """(row_gather, row_scatter_add) launches of one ``train`` from scratch:
    a warmup step gathers once (the march) and a tight step twice (the
    no-grad probe, then the march); every step scatter-adds once."""
    n_warm = min(cfg.train_warmup_steps, cfg.n_steps) if cfg.train_coarse > 0 else 0
    probes = 2 if cfg.train_coarse > 0 else 1
    return n_warm + probes * (cfg.n_steps - n_warm), cfg.n_steps


def _frames(ds, start: int, group: int, dev) -> tuple:
    o = torch.as_tensor(ds.origins[start:start + group], dtype=torch.float32, device=dev)
    r = torch.as_tensor(ds.rotations[start:start + group], dtype=torch.float32, device=dev)
    return o, r


def _dataset(ds):
    return load_dataset(ds, with_images=False) if isinstance(ds, str) else ds


def narrow_gathers(ds, cfg: NerfConfig, dev, group: int = EVAL_GROUP) -> tuple:
    """``row_gather`` launches of rendering ``ds``'s frames (narrower than
    512) in groups of ``group``: ``render_views`` compacts each group's rays
    that hit the bounding sphere (no gather) and marches them in chunks of
    ``_default_chunk``, each chunk one level-2 probe gather and one field
    gather.  Returns (launches, each group's hits)."""
    ds = _dataset(ds)
    if ds.camera.width >= TILE_PATH_WIDTH:
        raise ValueError("narrow_gathers counts the per-ray path of frames under 512 wide")
    chunk = render_mod._default_chunk(cfg)
    d_cam = render_mod._pixel_dirs(ds.camera, dev)
    hits = []
    for start in range(0, ds.n_frames, group):
        _, _, n_hit = render_mod._hit_order(*render_mod._assemble_rays(*_frames(ds, start, group, dev), d_cam))
        hits.append(int(n_hit))
    return 2 * sum(math.ceil(n / chunk) for n in hits), hits


def tile_gathers(params, ds, cfg: NerfConfig, dev, group: int = EVAL_GROUP) -> tuple:
    """``row_gather`` launches of rendering ``ds``'s frames (512 wide or
    more) in groups of ``group``: the tile path probes level 1 on every ray
    of the active 128-ray tiles against the pooled volume (no gather) and
    compacts the survivors, which ``_probe_march`` takes in chunks of
    ``_default_chunk`` rays, each chunk one level-2 probe gather and one
    field gather.  The level-1 probe is replayed here, group by group, and
    launches no gather (held).  Returns (launches, each group's survivors)."""
    ds = _dataset(ds)
    chunk = render_mod._default_chunk(cfg)
    t = render_mod._RENDER_TILE
    ct = max(chunk // t, 1)
    before = row_gather.launches
    with torch.no_grad():
        aux = render_mod.build_render_aux(params, cfg)
        d_cam = render_mod._pixel_dirs(ds.camera, dev)
        survivors = []
        for start in range(0, ds.n_frames, group):
            o, r = _frames(ds, start, group, dev)
            npad = (-(o.shape[0] * d_cam.shape[0])) % t
            od_t, order_t, n_act = render_mod._assemble_tiles(o, r, d_cam, t, npad)
            n_act = int(n_act)
            n1 = sum(int((render_mod._probe_tiles_l1(od_t, order_t[i:i + ct], cfg, aux)[:, 8] > 0.5).sum())
                     for i in range(0, n_act, ct))
            survivors.append(n1)
    if row_gather.launches != before:
        raise RuntimeError("the level-1 replay launched a gather")
    return 2 * sum(math.ceil(n / chunk) for n in survivors), survivors


def render_gathers(params, ds, cfg: NerfConfig, dev, group: int) -> tuple:
    """Either path, by the frames' width, for the voxel field with a sphere
    bound (the default)."""
    ds = _dataset(ds)
    if ds.camera.width >= TILE_PATH_WIDTH:
        return tile_gathers(params, ds, cfg, dev, group)
    return narrow_gathers(ds, cfg, dev, group)


def eval_gathers(params, ds, cfg: NerfConfig, dev) -> tuple:
    """One ``eval_nerf`` of ``params`` on ``ds``."""
    return render_gathers(params, ds, cfg, dev, EVAL_GROUP)


def screenshot_gathers(params, ds, cfg: NerfConfig, dev) -> tuple:
    """One ``screenshot_nerf`` of ``params`` on ``ds`` (a render json)."""
    return render_gathers(params, ds, cfg, dev, SCREENSHOT_GROUP)
