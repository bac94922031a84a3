"""Volume rendering: probe-tightened fixed-step march + compositing.

Counterpart of ``nerf_prv_tpu/nerf/render.py``.  Deterministic renders
(no ``jitter``) tighten each ray's interval with a probe and march a flat
``render_n_samples`` inside it: the voxel field probes two precomputed
occupancy tables (:class:`RenderAux`: a pooled block-max volume, then a
corner-density table read through the row-gather kernel), the hash field
the field MLP at ``render_coarse`` midpoints.  The training march (a
``jitter`` tensor, or a ``torch.Generator`` to draw one from) draws
stratified samples, tightened by a ``train_coarse``-sample probe that no
gradient flows through: the field MLP, or with ``probe_raw`` a baked
corner-density table read through the row-gather kernel.  With
``n_importance > 0`` training resamples the fine positions from a
density-only coarse pass (inverse CDF).

Reference names map one to one, except that the reference's ``_jit_``
prefixes are dropped (PyTorch runs eagerly): ``_assemble_tiles`` is
``_jit_assemble_tiles``, ``_render_tiles`` is ``_jit_render_tiles``.  The
reference's speculative, deferred dispatch of ``_render_tiles_two_phase``
(chunk bounds guessed from the previous call, verified by one late
readback) hides the readback latency of a remote TPU and has no
counterpart here: every path reads its counts directly, so ``defer=True``
returns a ``finish()`` that always returns None.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..ops.row_gather import row_gather
from ..utils.timing import span
from .model import NerfConfig, density, field
from .rays import pixel_dirs_cam, ray_aabb, ray_sphere
from .voxelfield import cell_and_frac, corner_weights, lattice_corner_raw

MIN_TRANSMITTANCE = 1e-4  # ≙ render_min_transmittance (run.py:235)

_PROBE_BLOCK = 2  # cells per pooled occupancy block (render aux level 1)

# NerfConfig.render_n_samples dataclass default; render_rays bumps only this
# value to 32 on the aux-less path (an explicit user setting is honored)
_RENDER_NS_DEFAULT = NerfConfig.__dataclass_fields__["render_n_samples"].default

_RENDER_TILE = 128  # rays per compaction tile (render_views sphere path)

# a ray pointing away from the volume: misses the bounding sphere
_MISS_RAY = (0.5, 0.5, 2.0, 0.0, 0.0, 1.0)


class RenderAux(NamedTuple):
    """Per-render-pass precomputed occupancy tables (see build_render_aux)."""

    cell_raw: torch.Tensor  # (g^3, 8) bf16: raw log-density at cell corners
    pooled: torch.Tensor    # (nb, nb, nb) f32: dilated block-max sigma


@torch.no_grad()
def build_render_aux(params, cfg: NerfConfig) -> Optional[RenderAux]:
    """Precompute the two-level occupancy tables for fast render probing.

    Level 2 is raw density at every cell corner (one dense MLP pass);
    level 1 is sigma's per-block max, dilated by one block so that a
    nearest-block lookup is conservative for samples whose probe segment
    overhangs the block.  Rebuilt per render pass: the field is frozen
    while rendering.  None wherever the reference returns None (hash
    field, cube bound).
    """
    if cfg.field_impl != "voxel" or cfg.bound != "sphere":
        return None
    g = cfg.voxel_grid_size
    cs = lattice_corner_raw(params, cfg)  # (g^3, 8) f32
    cell_max = torch.exp(torch.amax(cs, dim=-1)).reshape(g, g, g)
    # cells with any index g-1 are never gathered (cell_and_frac caps the
    # cell at g-2); their clipped-corner sigmas would otherwise leak
    # phantom occupancy into the pooled volume at the upper boundary
    cell_max[g - 1, :, :] = 0.0
    cell_max[:, g - 1, :] = 0.0
    cell_max[:, :, g - 1] = 0.0
    nb = -(-g // _PROBE_BLOCK)
    pad = nb * _PROBE_BLOCK - g
    cm = F.pad(cell_max, (0, pad) * 3)
    pooled = cm.reshape(nb, _PROBE_BLOCK, nb, _PROBE_BLOCK, nb, _PROBE_BLOCK).amax(dim=(1, 3, 5))
    # 3x3x3 dilation over an edge-padded copy
    p = F.pad(pooled[None, None], (1,) * 6, mode="replicate")
    dil = F.max_pool3d(p, kernel_size=3, stride=1)[0, 0]
    return RenderAux(cs.to(torch.bfloat16), dil)


def _pooled_lookup(pooled: torch.Tensor, pos: torch.Tensor, g: int) -> torch.Tensor:
    """Nearest-block values for pos (N, S, 3) in [0,1].

    The reference looks the block up with one-hot bfloat16 matmuls, which
    round the pooled sigmas to bfloat16; that rounding is kept here, or
    rays near the occupancy threshold would flip.
    """
    nb = pooled.shape[0]
    n, s = pos.shape[:2]
    b = torch.clamp(
        (pos.reshape(-1, 3) * (g - 1) / _PROBE_BLOCK).to(torch.int64), 0, nb - 1
    )
    flat = pooled.to(torch.bfloat16).to(torch.float32).reshape(-1)
    return flat[(b[:, 0] * nb + b[:, 1]) * nb + b[:, 2]].reshape(n, s)


def _cell_sigma_at(cell_raw: torch.Tensor, pos: torch.Tensor, g: int) -> torch.Tensor:
    """Sigma from trilinear RAW log-density interpolation at pos (N, S, 3):
    one 16-byte row gather per sample (exp after interpolation, the
    conservative side for saturation clamping)."""
    n, s = pos.shape[:2]
    row_idx, frac = cell_and_frac(pos.reshape(-1, 3), g)
    rows = row_gather(cell_raw, row_idx).to(torch.float32)  # (M, 8)
    w = corner_weights(frac)
    return torch.exp(torch.sum(rows * w, dim=-1)).reshape(n, s)


def _eval_field(params, pos, dirs_b, cfg):
    n, ns = pos.shape[:2]
    flat_pos = pos.reshape(n * ns, 3)
    flat_dirs = dirs_b[:, None, :].expand(n, ns, 3).reshape(n * ns, 3)
    sigma, rgb = field(params, flat_pos, flat_dirs, cfg)
    return sigma.reshape(n, ns), rgb.reshape(n, ns, 3)


class _ExclusiveCumprod(torch.autograd.Function):
    """``T[:, i] = prod(a[:, :i])`` along the last axis of (N, S).

    ``torch.cumprod``'s own backward reads a flag back to the host to look
    for zeros in its input, which would stall every training step; every
    ``a`` here is at least 1e-10, so the quotient form needs no such look.
    """

    @staticmethod
    def forward(ctx, a):
        ones = torch.ones_like(a[:, :1])
        trans = torch.cat([ones, torch.cumprod(a, dim=-1)[:, :-1]], dim=-1)
        ctx.save_for_backward(a, trans)
        return trans

    @staticmethod
    def backward(ctx, g):
        a, trans = ctx.saved_tensors
        w = g * trans
        # sum of w over the samples after each one
        after = torch.flip(torch.cumsum(torch.flip(w, dims=[-1]), dim=-1), dims=[-1]) - w
        return after / a


def _composite(sigma, rgb, deltas):
    alpha = 1.0 - torch.exp(-sigma * deltas)
    trans = _ExclusiveCumprod.apply(1.0 - alpha + 1e-10)
    # transmittance cutoff ≙ ngp's early ray termination
    weights = torch.where(trans > MIN_TRANSMITTANCE, trans * alpha, 0.0)
    out_rgb = torch.sum(weights[..., None] * rgb, dim=1)
    out_alpha = torch.sum(weights, dim=1)
    return out_rgb, out_alpha, weights


def _coarse_density(params, pos, cfg):
    n, ns = pos.shape[:2]
    return density(params, pos.reshape(n * ns, 3), cfg).reshape(n, ns)


def _chord_midpoints(origins, dirs, tmin, tmax, nc):
    """(positions (N, nc, 3) of the ``nc`` segment midpoints of each ray's
    [tmin, tmax], clipped into the volume; the chords' lengths (N,))."""
    base_c = (torch.arange(nc, dtype=torch.float32, device=tmin.device)[None, :] + 0.5) / nc
    span_c = tmax - tmin
    ts_c = tmin[:, None] + base_c * span_c[:, None]
    pos_c = origins[:, None, :] + dirs[:, None, :] * ts_c[..., None]
    return torch.clamp(pos_c, 0.0, 1.0 - 1e-6), span_c


def _tighten_interval(params, origins, dirs, tmin, tmax, valid, nc, cfg):
    """Probe density at ``nc`` midpoints and return the tightened
    (t_lo, t_hi, any_occ) of the occupied-and-visible interval."""
    pos_c, span_c = _chord_midpoints(origins, dirs, tmin, tmax, nc)
    sigma_c = _coarse_density(params, pos_c, cfg) * valid[:, None]
    return _clamp_occupied(sigma_c, tmin, span_c, nc)


def _tighten_interval_baked(cell_raw, origins, dirs, tmin, tmax, valid, nc, cfg):
    """Train-time probe against a periodically rebaked corner-density table.

    The clamp of ``_tighten_interval``, but sigma comes from trilinear
    interpolation of the baked (g^3, 8) raw table (one 16-byte row gather
    per probe sample, ``_cell_sigma_at``) instead of a field-MLP
    evaluation.  The trainer rebakes the table every
    ``cfg.train_probe_refresh`` steps, so it lags the live field by at most
    that many steps; rays whose stale probes all read empty fall back to
    the full chord (``render_rays``).
    """
    pos_c, span_c = _chord_midpoints(origins, dirs, tmin, tmax, nc)
    sigma_c = _cell_sigma_at(cell_raw, pos_c, cfg.voxel_grid_size) * valid[:, None]
    return _clamp_occupied(sigma_c, tmin, span_c, nc)


def _first_true(mask):
    """Index of the first True along the last axis (0 when none is)."""
    return torch.argmax(mask.to(torch.int32), dim=-1)


def _clamp_occupied(sigma_c, tmin, span_c, nc):
    """Saturation-aware occupied-interval clamp from probe sigmas (N, nc)."""
    alpha_c = 1.0 - torch.exp(-sigma_c * (span_c[:, None] / nc))
    occ = alpha_c > 1e-3
    any_occ = torch.any(occ, dim=-1)
    first = _first_true(occ)
    last = nc - 1 - _first_true(torch.flip(occ, dims=[-1]))
    trans_probe = torch.cumprod(1.0 - alpha_c + 1e-10, dim=-1)
    sat = trans_probe < MIN_TRANSMITTANCE
    first_sat = torch.where(torch.any(sat, dim=-1), _first_true(sat), nc - 1)
    last = torch.minimum(last, first_sat)
    # one-coarse-cell margin on both sides
    lo = torch.clamp_min(first - 1, 0).to(torch.float32) / nc
    hi = torch.clamp_max(last + 2, nc).to(torch.float32) / nc
    return tmin + lo * span_c, tmin + hi * span_c, any_occ


def _probe_level1(aux: RenderAux, origins, dirs, tmin, tmax, valid, cfg):
    """Level-1 render probe: render_probe_coarse samples against the
    dilated block-max volume.  Returns the tightened (t1min, t1max, any1).
    """
    g = cfg.voxel_grid_size
    # level-1 detection reach per sample is (1 + 2 dilation) * block cells;
    # keep sample spacing below it whatever the grid size (a chord spans up
    # to ~1.04 * (g-1) cells)
    reach = 3 * _PROBE_BLOCK
    n1 = max(cfg.render_probe_coarse, -(-int(1.04 * (g - 1)) // reach))
    span = tmax - tmin

    base1 = (torch.arange(n1, dtype=torch.float32, device=tmin.device)[None, :] + 0.5) / n1
    ts1 = tmin[:, None] + base1 * span[:, None]
    pos1 = torch.clamp(
        origins[:, None, :] + dirs[:, None, :] * ts1[..., None], 0.0, 1.0 - 1e-6
    )
    pool = _pooled_lookup(aux.pooled, pos1, g)
    delta1 = span[:, None] / n1
    occ1 = (1.0 - torch.exp(-pool * delta1) > 1e-3) & valid[:, None]
    any1 = torch.any(occ1, dim=-1)
    first1 = _first_true(occ1).to(torch.float32)
    last1 = (n1 - 1 - _first_true(torch.flip(occ1, dims=[-1]))).to(torch.float32)
    # half-segment margin; the block dilation already covers overhang
    lo1 = torch.clamp_min(first1 - 0.5, 0.0) / n1
    hi1 = torch.clamp_max(last1 + 1.5, n1) / n1
    return tmin + lo1 * span, tmin + hi1 * span, any1


def _probe_level2(aux: RenderAux, origins, dirs, t1min, t1max, cfg):
    """Level-2 render probe: render_probe_fine samples of trilinear
    corner density, one 16-byte row gather each.  Same saturation-aware
    clamping as ``_tighten_interval``.
    """
    n2 = cfg.render_probe_fine
    span2 = t1max - t1min
    base2 = (torch.arange(n2, dtype=torch.float32, device=t1min.device)[None, :] + 0.5) / n2
    ts2 = t1min[:, None] + base2 * span2[:, None]
    pos2 = torch.clamp(
        origins[:, None, :] + dirs[:, None, :] * ts2[..., None], 0.0, 1.0 - 1e-6
    )
    sig2 = _cell_sigma_at(aux.cell_raw, pos2, cfg.voxel_grid_size)
    return _clamp_occupied(sig2, t1min, span2, n2)


def _tighten_interval_aux(aux: RenderAux, origins, dirs, tmin, tmax, valid, cfg):
    """Two-level render probe (level-1 pooled + level-2 corner density),
    the fused form; the tile render calls the levels separately with a
    compaction in between."""
    t1min, t1max, any1 = _probe_level1(aux, origins, dirs, tmin, tmax, valid, cfg)
    tlo, thi, any2 = _probe_level2(aux, origins, dirs, t1min, t1max, cfg)
    return tlo, thi, any1 & any2


def _sample_cdf(ts, weights, n_fine, u=None, generator=None):
    """Inverse-CDF sampling of fine ts from coarse weights (jaxnerf-style).

    ``ts`` (N, S) ascending coarse sample positions define S-1 bins; bin
    mass is the mean of its endpoint weights.  ``u`` (N, n_fine) are the
    uniforms; without them they are drawn from ``generator``, and without
    either they are the ``n_fine`` bin midpoints (deterministic).  The
    result is not sorted.
    """
    n, s = weights.shape
    w = 0.5 * (weights[:, :-1] + weights[:, 1:]) + 1e-5  # (N, S-1)
    cdf = torch.cumsum(w, dim=-1)
    cdf = cdf / cdf[:, -1:]
    cdf = torch.cat([cdf.new_zeros((n, 1)), cdf], dim=-1)  # (N, S)
    if u is None and generator is not None:
        u = torch.rand((n, n_fine), generator=generator, device=ts.device)
    elif u is None:
        mid = (torch.arange(n_fine, dtype=torch.float32, device=ts.device) + 0.5) / n_fine
        u = mid.expand(n, n_fine)
    # the reference's branchless search: count the cdf entries <= u
    idx = torch.clamp(
        torch.sum(cdf[:, None, :] <= u[:, :, None], dim=-1) - 1, 0, s - 2
    )
    c0 = torch.gather(cdf, 1, idx)
    c1 = torch.gather(cdf, 1, idx + 1)
    t0 = torch.gather(ts, 1, idx)
    t1 = torch.gather(ts, 1, idx + 1)
    frac = torch.clamp((u - c0) / torch.clamp_min(c1 - c0, 1e-8), 0.0, 1.0)
    return t0 + (t1 - t0) * frac


def render_rays(
    params, origins, dirs, cfg: NerfConfig, aux=None, jitter=None,
    probe_raw=None, generator=None, importance_u=None,
):
    """March rays through the bounded volume; returns (rgb (N,3), alpha (N,)).

    Without ``jitter`` and ``generator`` this is the deterministic (eval)
    march: midpoint samples inside the probe-tightened interval, through
    ``aux`` when one is given.  A ``jitter`` (N, cfg.n_samples) tensor of
    uniforms, or a ``generator`` to draw it from (the port has no ``key``),
    selects the training march; ``probe_raw`` is the baked train probe's
    table.  With ``cfg.n_importance > 0`` training runs a density-only
    coarse pass and evaluates the field at importance-resampled points,
    whose uniforms come from ``generator`` or ``importance_u``
    (N, cfg.n_importance); a precomputed ``jitter`` without them raises
    ValueError, as in the reference.  Deterministic renders always use the
    flat ``cfg.render_n_samples`` march.
    """
    training = jitter is not None or generator is not None
    importance = training and cfg.n_importance > 0
    if importance and jitter is not None and generator is None and importance_u is None:
        raise ValueError("precomputed jitter requires cfg.n_importance == 0")
    n = origins.shape[0]
    if training:
        ns = cfg.n_samples
        if jitter is None:
            jitter = torch.rand((n, ns), generator=generator, device=origins.device)
    else:
        ns = cfg.render_n_samples or cfg.n_samples
        if aux is None and cfg.render_n_samples == _RENDER_NS_DEFAULT:
            # the aux-less MLP probe gets the larger default count (the
            # reference measured -0.08 dB at 24 vs 32); an explicit
            # render_n_samples is honored
            ns = max(ns, 32)
    if cfg.bound == "sphere":
        tmin, tmax, valid = ray_sphere(origins, dirs)
    else:
        tmin, tmax, valid = ray_aabb(origins, dirs)

    if not training and cfg.render_coarse > 0:
        if aux is not None:
            tmin, tmax, any_occ = _tighten_interval_aux(aux, origins, dirs, tmin, tmax, valid, cfg)
        else:
            tmin, tmax, any_occ = _tighten_interval(
                params, origins, dirs, tmin, tmax, valid, cfg.render_coarse, cfg
            )
        valid = valid & any_occ
    elif training and cfg.train_coarse > 0:
        # the same probe for training; no gradient flows through it.  Rays
        # whose occupied probes vanished fall back to the full chord so
        # density can (re)grow anywhere (with probe_raw, delayed by at most
        # cfg.train_probe_refresh steps until the next bake)
        with torch.no_grad():
            if probe_raw is not None:
                t_lo, t_hi, any_occ = _tighten_interval_baked(
                    probe_raw, origins, dirs, tmin, tmax, valid, cfg.train_coarse, cfg
                )
            else:
                t_lo, t_hi, any_occ = _tighten_interval(
                    params, origins, dirs, tmin, tmax, valid, cfg.train_coarse, cfg
                )
            tmin = torch.where(any_occ, t_lo, tmin)
            tmax = torch.where(any_occ, t_hi, tmax)

    if importance:
        return _march_importance(
            params, origins, dirs, tmin, tmax, valid, cfg, ns, jitter, importance_u, generator
        )
    return _march_body(
        params, origins, dirs, tmin, tmax, valid, cfg, ns, 0.5 if jitter is None else jitter
    )


def _march_importance(params, o, d, tmin, tmax, valid, cfg, ns, jitter, u, generator):
    """Training march with importance resampling: a density-only pass at the
    ``ns`` stratified positions gives coarse weights (no gradient flows
    through it), ``cfg.n_importance`` positions are drawn from their CDF and
    sorted, and the field is composited there with the gaps between
    consecutive positions as deltas (the last one a coarse span)."""
    n = o.shape[0]
    span = (tmax - tmin) / ns
    with torch.no_grad():
        base = torch.arange(ns, dtype=torch.float32, device=tmin.device)[None, :]
        ts = tmin[:, None] + (base + jitter) * span[:, None]
        pos = torch.clamp(o[:, None, :] + d[:, None, :] * ts[..., None], 0.0, 1.0 - 1e-6)
        sigma_c = _coarse_density(params, pos, cfg) * valid[:, None]
        alpha_c = 1.0 - torch.exp(-sigma_c * span[:, None])
        trans_c = torch.cumprod(1.0 - alpha_c + 1e-10, dim=-1)
        trans_c = torch.cat([trans_c.new_ones((n, 1)), trans_c[:, :-1]], dim=-1)
        t_fine = _sample_cdf(ts, trans_c * alpha_c, cfg.n_importance, u, generator)
        t_fine = torch.sort(t_fine, dim=-1).values
        pos_f = torch.clamp(o[:, None, :] + d[:, None, :] * t_fine[..., None], 0.0, 1.0 - 1e-6)
        deltas = torch.diff(t_fine, dim=-1, append=t_fine[:, -1:] + span[:, None])
    sigma, rgb = _eval_field(params, pos_f, d, cfg)
    sigma = sigma * valid[:, None]
    out_rgb, out_alpha, _ = _composite(sigma, rgb, deltas)
    return out_rgb, out_alpha


def _march_body(params, o, d, tlo, thi, occ, cfg, ns, jitter=0.5):
    """Fine march of ``ns`` samples inside [t_lo, t_hi] -> (rgb, alpha);
    rays with ``occ`` false composite to exact zeros."""
    span = (thi - tlo) / ns
    base = torch.arange(ns, dtype=torch.float32, device=tlo.device)[None, :]
    ts = tlo[:, None] + (base + jitter) * span[:, None]
    pos = o[:, None, :] + d[:, None, :] * ts[..., None]  # (N, S, 3)
    pos = torch.clamp(pos, 0.0, 1.0 - 1e-6)
    sigma, rgb = _eval_field(params, pos, d, cfg)
    sigma = sigma * occ[:, None]
    out_rgb, out_alpha, _ = _composite(sigma, rgb, span[:, None].expand_as(sigma))
    return out_rgb, out_alpha


def _default_chunk(cfg: NerfConfig) -> int:
    # the hash field's per-level temporaries cap the chunk
    return 1 << 14 if cfg.field_impl == "hash" else 1 << 17


def render_image(params, origin, rotation, camera, cfg: NerfConfig, chunk: Optional[int] = None):
    """Full-frame render; returns (H, W, 4) float32 RGBA on black background.

    The alpha channel carries accumulated density.
    """
    return render_views(params, origin[None], rotation[None], camera, cfg, chunk=chunk)[0]


def _finish_noop():
    """Deferred-render finish: every path verified inline, valid as-is."""
    return None


@torch.no_grad()
def render_views(
    params,
    origins,    # (F, 3) grid-space camera centers
    rotations,  # (F, 3, 3)
    camera,
    cfg: NerfConfig,
    chunk: Optional[int] = None,
    aux=None,
    defer: bool = False,
):
    """Batched multi-frame render -> (F, H, W, 4), on the params' device.

    All frames' rays form one stream, compacted so that only rays that hit
    the bounding sphere are marched: by 128-ray tile for frames at least
    512 wide, by ray for narrower ones.  With an ``aux`` (the voxel field)
    the tile path probes level 1 on every active ray and compacts again
    before the level-2 probe and the march.  ``defer=True`` returns
    ``(rgba, finish)`` with a ``finish()`` that returns None.
    """
    with span("render.assemble"):
        if aux is None and cfg.render_coarse > 0:
            aux = build_render_aux(params, cfg)
        if cfg.render_coarse <= 0:
            aux = None  # render_rays reads the aux only when it probes
        device = next(iter(params.values())).device
        chunk = chunk or _default_chunk(cfg)
        origins = torch.as_tensor(origins, dtype=torch.float32, device=device)
        rotations = torch.as_tensor(rotations, dtype=torch.float32, device=device)
        n_frames = origins.shape[0]
        h, w = camera.height, camera.width
        d_cam = _pixel_dirs(camera, device)
        n = n_frames * h * w
        tiles = cfg.bound == "sphere" and w >= 512
        if tiles:
            # tile-level compaction: march only tiles with a sphere hit
            t = _RENDER_TILE
            npad = (-n) % t
            n_p = n + npad
            n_tiles = n_p // t
            od_t, order_t, n_act = _assemble_tiles(origins, rotations, d_cam, t, npad)
            n_act = int(n_act)
        elif cfg.bound == "sphere":
            # per-ray compaction: hits first, then a gather back to pixel order
            o_all, d_all = _assemble_rays(origins, rotations, d_cam)
            od_sorted, pos, n_hit = _compact_rays(o_all, d_all)
            n_hit = int(n_hit)
        else:
            o_all, d_all = _assemble_rays(origins, rotations, d_cam)
    with span("render.march"):
        if tiles:
            ct = max(chunk // t, 1)
            if aux is not None:
                rgba_t = _render_tiles_two_phase(params, od_t, order_t[:n_act], cfg, aux, chunk)
            else:
                outs = [
                    _render_tiles(params, od_t, order_t[i : min(i + ct, n_act)], cfg)
                    for i in range(0, n_act, ct)
                ]
                rgba_t = torch.cat(outs) if outs else torch.zeros((0, 4 * t), device=device)
            out = _scatter_tiles(rgba_t, order_t[:n_act], n_tiles)
            rgba = out.reshape(n_p, 4)[:n]
            rgb, a = rgba[:, :3], rgba[:, 3]
        elif cfg.bound == "sphere":
            outs = []
            for i in range(0, n_hit, chunk):
                od = od_sorted[i : min(i + chunk, n_hit)]
                rgb, a = render_rays(params, od[:, :3], od[:, 3:], cfg, aux=aux)
                outs.append(torch.cat([rgb, a[:, None]], dim=-1))
            rgba_hit = torch.cat(outs) if outs else torch.zeros((0, 4), device=device)
            rgb, a = _gather_back(rgba_hit, pos)
        else:
            outs_rgb, outs_a = [], []
            for i in range(0, n, chunk):
                rgb, a = render_rays(params, o_all[i : i + chunk], d_all[i : i + chunk], cfg, aux=aux)
                outs_rgb.append(rgb)
                outs_a.append(a)
            rgb = torch.cat(outs_rgb)
            a = torch.cat(outs_a)
        rgba = torch.cat(
            [rgb.reshape(n_frames, h, w, 3), a.reshape(n_frames, h, w)[..., None]], dim=-1
        )
    return (rgba, _finish_noop) if defer else rgba


def _pixel_dirs(camera, device):
    """(HW, 3) camera-frame unit directions, row-major over the frame."""
    u, v = torch.meshgrid(
        torch.arange(camera.width, dtype=torch.float32, device=device),
        torch.arange(camera.height, dtype=torch.float32, device=device),
        indexing="xy",
    )
    return pixel_dirs_cam(camera, u.reshape(-1), v.reshape(-1))


def _assemble_rays(origins, rotations, d_cam):
    """(F,3) origins + (F,3,3) rotations + camera dirs -> flat ray stream."""
    n_frames = origins.shape[0]
    hw = d_cam.shape[0]
    d_grid = torch.einsum("fij,nj->fni", rotations, d_cam)
    d_grid = d_grid / torch.linalg.norm(d_grid, dim=-1, keepdim=True)
    o_all = origins[:, None, :].expand(n_frames, hw, 3).reshape(-1, 3)
    return o_all, d_grid.reshape(-1, 3)


def _assemble_tiles(origins, rotations, d_cam, t, npad):
    """The tile path's ray stream: (o | d) rows padded with miss rays to a
    whole number of ``t``-ray tiles, and the active-tiles-first order."""
    o_all, d_all = _assemble_rays(origins, rotations, d_cam)
    od = torch.cat([o_all, d_all], dim=-1)
    if npad:
        miss = torch.tensor(_MISS_RAY, dtype=od.dtype, device=od.device)
        od = torch.cat([od, miss.expand(npad, 6)])
    n_tiles = od.shape[0] // t
    order_t, n_act = _tile_order(od, t)
    return od.reshape(n_tiles, 6 * t), order_t, n_act


def _partition(flags):
    """Stable flagged-first permutation of a bool vector.

    Returns (order, pos, count): ``order[k]`` is the element in slot k,
    ``pos[j]`` the slot of element j, ``count`` the number flagged.
    """
    m = flags.shape[0]
    count = torch.sum(flags)
    pos_hit = torch.cumsum(flags, dim=0) - 1
    pos_miss = count + torch.cumsum(~flags, dim=0) - 1
    pos = torch.where(flags, pos_hit, pos_miss)
    order = torch.empty((m,), dtype=torch.int64, device=flags.device)
    order[pos] = torch.arange(m, dtype=torch.int64, device=flags.device)
    return order, pos, count


def _tile_order(od, t):
    """Active-tiles-first permutation over ``t``-ray tiles."""
    _, _, valid = ray_sphere(od[:, :3], od[:, 3:])
    order, _, n_act = _partition(torch.any(valid.reshape(-1, t), dim=1))
    return order, n_act


def _scatter_tiles(rgba_t, tidx, n_tiles):
    """Place marched tiles in frame order; unmarched tiles stay zero."""
    out = torch.zeros((n_tiles, rgba_t.shape[1]), dtype=rgba_t.dtype, device=rgba_t.device)
    out[tidx] = rgba_t
    return out


def _hit_order(origins, dirs):
    _, _, valid = ray_sphere(origins, dirs)
    return _partition(valid)


def _compact_rays(origins, dirs):
    """Partition rays hits-first; returns (od_sorted (N,6), pos, n_hit)."""
    order, pos, n_hit = _hit_order(origins, dirs)
    od = torch.cat([origins, dirs], dim=-1)
    return od[order], pos, n_hit


def _unpermute_rays(rgba, pos):
    """Un-permute marched rays (M, 4) to the order ``pos`` was made for;
    rays whose slot lies beyond the marched prefix read zeros."""
    m = rgba.shape[0]
    padded = torch.cat([rgba, rgba.new_zeros((1, 4))])
    return padded[torch.clamp_max(pos, m)]


def _gather_back(rgba_hit, pos):
    out = _unpermute_rays(rgba_hit, pos)
    return out[:, :3], out[:, 3]


def _render_tiles(params, od_t, tidx, cfg):
    """March the tiles ``tidx`` of ``od_t``: tile gather + march + repack."""
    ct = tidx.shape[0]
    t = od_t.shape[1] // 6
    rays = od_t[tidx].reshape(ct * t, 6)
    rgb, a = render_rays(params, rays[:, :3], rays[:, 3:], cfg)
    return torch.cat([rgb, a[:, None]], dim=-1).reshape(ct, 4 * t)


def _render_tiles_two_phase(params, od_t, tidx, cfg, aux, chunk):
    """Probe-then-march render of the active tiles ``tidx`` -> (n_act, 4t).

    Level 1 probes every active-tile ray against the pooled volume; the
    occupied rays are compacted to the front; level 2 and the fine march
    run only on them, in chunks.  Per ray the result equals
    ``render_rays(aux=aux)``: a ray dropped at level 1 composites to exact
    zeros either way.

    With ``cfg.render_span_bucket`` the level-2 probe runs on its own, its
    survivors are compacted again and partitioned short spans first, and
    whole chunks of short-span rays march with ``cfg.render_short_samples``
    samples; the chunk that straddles the boundary and all later ones march
    at the full count.

    The reference's version of this function also guesses its chunk counts
    from the previous call and verifies them with one late readback, which
    hides a remote TPU's readback latency; that speculative, deferred
    dispatch has no counterpart here, where each count is read directly.
    """
    n_act = tidx.shape[0]
    t = od_t.shape[1] // 6
    ct = max(chunk // t, 1)
    if n_act == 0:
        return od_t.new_zeros((0, 4 * t))
    packed = torch.cat(
        [_probe_tiles_l1(od_t, tidx[i : i + ct], cfg, aux) for i in range(0, n_act, ct)]
    )
    order, pos, n1 = _partition(packed[:, 8] > 0.5)
    n1 = int(n1)
    pack1 = packed[order[:n1]]
    ns_long = cfg.render_n_samples or cfg.n_samples
    if cfg.render_span_bucket and cfg.render_short_samples < ns_long:
        rgba_l1 = _march_span_bucketed(params, pack1, cfg, aux, chunk, ns_long)
    else:
        outs = [_probe_march(params, pack1[i : i + chunk], cfg, aux) for i in range(0, n1, chunk)]
        rgba_l1 = torch.cat(outs) if outs else packed.new_zeros((0, 4))
    return _unpermute_rays(rgba_l1, pos).reshape(n_act, 4 * t)


def _march_span_bucketed(params, pack1, cfg, aux, chunk, ns_long):
    """Level-2 probe, compaction, short-spans-first partition and the march
    of level-1 survivors ``pack1`` -> (n1, 4) rgba in ``pack1``'s order."""
    n1 = pack1.shape[0]
    if n1 == 0:
        return pack1.new_zeros((0, 4))
    packed2 = torch.cat([_probe_l2(pack1[i : i + chunk], cfg, aux) for i in range(0, n1, chunk)])
    order2, pos2, n2 = _partition(packed2[:, 8] > 0.5)
    n2 = int(n2)
    pack2 = packed2[order2[:n2]]
    pos3, c0 = None, 0
    if n2 > chunk:
        pack2, pos3, n_short = _partition_short(pack2, cfg.render_short_samples, ns_long)
        c0 = (int(n_short) // chunk) * chunk  # only whole chunks switch
    outs = [
        _march_interval(
            params, pack2[i : i + chunk], cfg, cfg.render_short_samples if i < c0 else ns_long
        )
        for i in range(0, n2, chunk)
    ]
    rgba_occ = torch.cat(outs) if outs else pack1.new_zeros((0, 4))
    if pos3 is not None:
        rgba_occ = _unpermute_rays(rgba_occ, pos3)  # pack2's order
    return _unpermute_rays(rgba_occ, pos2)


def _partition_short(packed, ns_short, ns_long):
    """Short-span-first stable partition of packed level-2 survivors.

    A ray is "short" when marching its tightened span with ``ns_short``
    samples keeps the sample spacing at or below the spacing the uniform
    ``ns_long`` march gives the longest occupied span: span <= smax *
    ns_short / ns_long.  Stable, so an occupied-first input stays
    occupied-first.  Returns (packed rows in the new order, each input
    row's slot, the number of short rays).
    """
    occ = packed[:, 8] > 0.5
    spans = packed[:, 7] - packed[:, 6]
    smax = torch.max(torch.where(occ, spans, 0.0))
    short = occ & (spans <= smax * (ns_short / ns_long))
    order, pos, n_short = _partition(short)
    return packed[order], pos, n_short


def _probe_l2(packed, cfg, aux):
    """Level-2 corner-density probe on packed level-1 survivors; returns
    packed rows with the tightened interval and the combined occupancy."""
    o, d = packed[:, :3], packed[:, 3:6]
    tlo, thi, any2 = _probe_level2(aux, o, d, packed[:, 6], packed[:, 7], cfg)
    occ = (any2 & (packed[:, 8] > 0.5)).to(packed.dtype)
    return torch.cat([packed[:, :6], tlo[:, None], thi[:, None], occ[:, None]], dim=-1)


def _march_interval(params, packed, cfg, ns):
    """Deterministic fine march of ``ns`` samples inside the packed rows'
    precomputed [t_lo, t_hi] -> (N, 4) rgba."""
    o, d = packed[:, :3], packed[:, 3:6]
    rgb, a = _march_body(params, o, d, packed[:, 6], packed[:, 7], packed[:, 8] > 0.5, cfg, ns)
    return torch.cat([rgb, a[:, None]], dim=-1)


def _probe_tiles_l1(od_t, tidx, cfg, aux):
    """Level-1 probe of the tiles ``tidx``; emits packed rows
    ``[o(3) | d(3) | t_lo | t_hi | occ]`` (N, 9)."""
    ct = tidx.shape[0]
    t = od_t.shape[1] // 6
    rays = od_t[tidx].reshape(ct * t, 6)
    o, d = rays[:, :3], rays[:, 3:]
    tmin, tmax, valid = ray_sphere(o, d)
    t1lo, t1hi, any1 = _probe_level1(aux, o, d, tmin, tmax, valid, cfg)
    occ = (any1 & valid).to(rays.dtype)
    return torch.cat([rays, t1lo[:, None], t1hi[:, None], occ[:, None]], dim=-1)


def _probe_march(params, packed, cfg, aux):
    """Level-2 probe, interval tightening and the fine march on packed
    level-1 survivors -> (N, 4) rgba."""
    o, d = packed[:, :3], packed[:, 3:6]
    tlo, thi, any2 = _probe_level2(aux, o, d, packed[:, 6], packed[:, 7], cfg)
    occ = any2 & (packed[:, 8] > 0.5)
    ns = cfg.render_n_samples or cfg.n_samples
    rgb, a = _march_body(params, o, d, tlo, thi, occ, cfg, ns)
    return torch.cat([rgb, a[:, None]], dim=-1)
