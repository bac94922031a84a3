"""Procedural object families of the PRV corpus.

The port's own copy of ``experiments/families.py`` (numpy only; the port
imports nothing of the JAX package): the twelve families, ``FAMILIES`` and
``object_roster`` line for line, and ``make_family_object`` writing through
the port's ``scene/ply.py::save_ply_binary``.  The same name gives the same
arrays bit for bit: the rng is seeded with ``zlib.crc32(name)`` and
``hardness = (idx % 8) / 7``, as there.

What moves the gradient@0.02 label (the first view count where the fitted
lognormal PSNR curve gains <= 0.02 dB/view) is the shape of the
PSNR-vs-views curve:

- low labels need objects whose few-view reconstruction is already near
  the ceiling: convex, smooth, low-frequency colors (``uni``, ``ell``);
- high labels need objects that stay learnable but reveal new surface
  slowly: self-occlusion (clusters, cups, vanes), thin features seen
  edge-on (plates, spikes).

Twelve families, 3-letter name prefixes doubling as the dataset's category
keys (≙ the 20 ShapeNet class prefixes, main.cpp:2706-2725).  Every family
takes a scalar ``hardness`` in [0, 1] that tunes its occlusion/complexity
knobs, so labels also spread within a family.
"""

from __future__ import annotations

import os
import zlib

import numpy as np

from ..scene.ply import save_ply_binary

__all__ = ["FAMILIES", "make_family_object", "object_roster"]


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _smooth_colors(pts: np.ndarray, rng: np.random.Generator, freq: float = 2.0,
                   sat: float = 0.9) -> np.ndarray:
    """Low-frequency position-driven RGB: learnable at grid resolution, so
    the PSNR ceiling stays high and the curve keeps discriminating."""
    span = pts.max(0) - pts.min(0) + 1e-9
    q = (pts - pts.min(0)) / span  # [0,1]^3
    cols = np.empty((len(pts), 3))
    for c in range(3):
        k = rng.normal(size=3)
        k = k / np.linalg.norm(k) * freq * np.pi
        cols[:, c] = 0.5 + 0.5 * sat * np.sin(q @ k + rng.uniform(0, 2 * np.pi))
    return np.clip(cols * 255, 0, 255).astype(np.uint8)


def _sphere_points(n, rng, radius=1.0, fuzz=0.0):
    p = _unit(rng.normal(size=(n, 3)))
    r = radius * (1.0 - fuzz * rng.uniform(0, 1, (n, 1)))
    return p * r


# --------------------------------------------------------------------------
# families — each returns (pts (N,3) float, cols (N,3) uint8)
# --------------------------------------------------------------------------

def uni(rng, hardness=0.0, n=90_000):
    """Near-uniform pastel ball: the LOW-label anchor.  3 views already see
    most of a convex smooth surface; PSNR saturates almost immediately."""
    pts = _sphere_points(n, rng, fuzz=0.02)
    base = rng.uniform(90, 200, 3)
    wob = 10 + 35 * hardness  # barely-there gradient
    cols = base + wob * np.stack(
        [np.sin(pts[:, i] * (1.5 + hardness) + rng.uniform(0, 6)) for i in range(3)],
        axis=1,
    )
    return pts, np.clip(cols, 0, 255).astype(np.uint8)


def ell(rng, hardness=0.0, n=100_000):
    """Smooth ellipsoid, gentle two-tone gradient; hardness stretches the
    aspect ratio (grazing-angle faces take longer to pin down)."""
    axes = np.array([1.0, 1.0 - 0.45 * hardness, 0.55 + 0.25 * hardness])
    pts = _sphere_points(n, rng) * axes
    cols = _smooth_colors(pts, rng, freq=1.0 + 1.5 * hardness)
    return pts, cols


def blo(rng, hardness=0.0, n=80_000):
    """Round-2 blob (fuzzy ball, position-gradient colors) — the measured
    ~28-33 mid anchor (exp_prvnet_real.py round 2)."""
    size = 0.6 + 0.5 * hardness
    pts = _sphere_points(n, rng, radius=size, fuzz=0.3)
    cols = np.clip(((pts / size) * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)
    return pts, cols


def tor(rng, hardness=0.0, n=120_000):
    """Torus; hardness thins the tube and tilts it (the hole face hides)."""
    R = 0.8
    r = 0.32 - 0.22 * hardness
    u = rng.uniform(0, 2 * np.pi, n)
    v = rng.uniform(0, 2 * np.pi, n)
    pts = np.stack(
        [(R + r * np.cos(v)) * np.cos(u), (R + r * np.cos(v)) * np.sin(u),
         r * np.sin(v)], axis=1)
    tilt = 0.9 * hardness
    rot = np.array([[1, 0, 0],
                    [0, np.cos(tilt), -np.sin(tilt)],
                    [0, np.sin(tilt), np.cos(tilt)]])
    pts = pts @ rot.T
    cols = _smooth_colors(pts, rng, freq=1.5 + 2.0 * hardness)
    return pts, cols


def box(rng, hardness=0.0, n=120_000):
    """Box with checkered faces (round-2 mid anchor ~27); hardness raises
    the checker frequency toward the grid's Nyquist."""
    ext = np.array([1.0, 0.55 + 0.4 * rng.uniform(), 0.4 + 0.4 * rng.uniform()])
    face = rng.integers(0, 6, n)
    uvw = rng.uniform(-1, 1, (n, 2))
    pts = np.zeros((n, 3))
    for f in range(6):
        m = face == f
        ax, sgn = f // 2, 1.0 if f % 2 else -1.0
        rest = [a for a in range(3) if a != ax]
        pts[m, ax] = sgn * ext[ax]
        pts[m, rest[0]] = uvw[m, 0] * ext[rest[0]]
        pts[m, rest[1]] = uvw[m, 1] * ext[rest[1]]
    fr = 2.0 + 6.0 * hardness
    checker = (np.floor(pts[:, 0] * fr) + np.floor(pts[:, 1] * fr)
               + np.floor(pts[:, 2] * fr)) % 2
    cols = np.stack([40 + 200 * checker,
                     127 + 120 * np.sin(pts[:, 0] * 3),
                     240 - 200 * checker], axis=1)
    return pts, np.clip(cols, 0, 255).astype(np.uint8)


def clu(rng, hardness=0.5, n=130_000):
    """Multi-part cluster: k separated smooth lobes shadow one another, so
    each new view exposes a previously-occluded lobe face -> HIGH labels.
    hardness drives the part count and tightness of packing."""
    k = int(4 + round(6 * hardness))
    centers = rng.uniform(-1, 1, (k, 3)) * np.array([1.0, 1.0, 0.6])
    radii = rng.uniform(0.25, 0.5, k) * (1.0 - 0.3 * hardness)
    per = n // k
    parts, cols = [], []
    for j in range(k):
        p = _sphere_points(per, rng, radius=radii[j], fuzz=0.08) + centers[j]
        parts.append(p)
        base = rng.uniform(40, 220, 3)
        cols.append(np.clip(base + 30 * np.sin(p * 4), 0, 255))
    return np.concatenate(parts), np.concatenate(cols).astype(np.uint8)


def cup(rng, hardness=0.5, n=130_000):
    """Open hollow vessel: outer wall + inner wall + floor.  The interior
    is visible only from steep views; hardness deepens it and narrows the
    mouth, hiding more of the inner surface per view."""
    Ro = 1.0
    t = 0.1
    depth = 1.0 + 1.2 * hardness
    mouth = 1.0 - 0.35 * hardness  # top-opening radius factor
    n_out, n_in, n_bot = int(n * 0.4), int(n * 0.4), n - int(n * 0.4) * 2
    th = rng.uniform(0, 2 * np.pi, n_out)
    z = rng.uniform(0, depth, n_out)
    taper = 1.0 + (mouth - 1.0) * (z / depth)
    outer = np.stack([Ro * taper * np.cos(th), Ro * taper * np.sin(th), z], axis=1)
    th = rng.uniform(0, 2 * np.pi, n_in)
    z = rng.uniform(t, depth, n_in)
    taper = 1.0 + (mouth - 1.0) * (z / depth)
    inner = np.stack([(Ro - t) * taper * np.cos(th),
                      (Ro - t) * taper * np.sin(th), z], axis=1)
    rr = Ro * np.sqrt(rng.uniform(0, 1, n_bot))
    th = rng.uniform(0, 2 * np.pi, n_bot)
    bottom = np.stack([rr * np.cos(th), rr * np.sin(th),
                       rng.uniform(0, t, n_bot)], axis=1)
    pts = np.concatenate([outer, inner, bottom])
    cols = _smooth_colors(pts, rng, freq=2.0)
    # make inner/outer visually distinct so occluded surface carries signal
    cols[n_out:n_out + n_in] = 255 - cols[n_out:n_out + n_in]
    return pts, cols


def pla(rng, hardness=0.5, n=120_000):
    """Thin intersecting plates: edge-on from most directions; hardness
    adds plates and shrinks their thickness."""
    k = int(3 + round(3 * hardness))
    th = 0.04 - 0.025 * hardness
    per = n // k
    parts, cols = [], []
    for j in range(k):
        q = rng.normal(size=(3, 3))
        q, _ = np.linalg.qr(q)  # random orthonormal frame
        uv = rng.uniform(-1, 1, (per, 2)) * np.array([1.0, 0.7])
        w = rng.uniform(-th, th, (per, 1))
        p = uv[:, :1] * q[0] + uv[:, 1:] * q[1] + w * q[2]
        parts.append(p)
        cols.append(_smooth_colors(p, rng, freq=1.5))
    return np.concatenate(parts), np.concatenate(cols)


def spi(rng, hardness=0.5, n=130_000):
    """Ball with radial spikes (cones): spikes occlude each other and the
    core; hardness adds spikes and lengthens them."""
    k = int(12 + round(24 * hardness))
    n_core = n // 3
    core = _sphere_points(n_core, rng, radius=0.45)
    dirs = _unit(rng.normal(size=(k, 3)))
    per = (n - n_core) // k
    parts = [core]
    length = 0.9 + 0.7 * hardness
    for j in range(k):
        s = rng.uniform(0, 1, per) ** 0.7
        base_r = 0.16 * (1 - s)
        # random orthobasis around dirs[j]
        a = np.cross(dirs[j], [0.31, 0.51, 0.81])
        a /= np.linalg.norm(a)
        b = np.cross(dirs[j], a)
        phi = rng.uniform(0, 2 * np.pi, per)
        p = (0.4 + s[:, None] * length) * dirs[j] \
            + (base_r * np.cos(phi))[:, None] * a \
            + (base_r * np.sin(phi))[:, None] * b
        parts.append(p)
    pts = np.concatenate(parts)
    return pts, _smooth_colors(pts, rng, freq=1.2)


def van(rng, hardness=0.5, n=120_000):
    """Turbine vanes: k twisted half-planes around a vertical axis; the
    gaps between vanes are visible only in a narrow azimuth band each."""
    k = int(4 + round(6 * hardness))
    per = n // k
    parts, cols = [], []
    twist = 0.5 + 1.0 * hardness
    for j in range(k):
        r = rng.uniform(0.15, 1.0, per)
        z = rng.uniform(-0.7, 0.7, per)
        ang = 2 * np.pi * j / k + twist * z
        th = 0.025
        w = rng.uniform(-th, th, per)
        p = np.stack([r * np.cos(ang) - w * np.sin(ang),
                      r * np.sin(ang) + w * np.cos(ang), z], axis=1)
        parts.append(p)
        base = rng.uniform(60, 220, 3)
        cols.append(np.clip(base + 40 * np.sin(p * 3 + j), 0, 255))
    return np.concatenate(parts), np.concatenate(cols).astype(np.uint8)


def nos(rng, hardness=0.5, n=100_000):
    """Per-point color noise the 40^3 grid cannot represent.  DESIGNED as
    a low-label anchor (low ceiling -> early flattening), but pilot 2
    MEASURED the opposite: nos0=36, nos7=57 — with heavy noise the fitted
    lognormal keeps creeping (every view adds a sliver of per-pixel
    average) and the gradient@0.02 point moves far RIGHT.  Kept as the
    dataset's HIGH-label tail anchor; the docstring records the measured
    role, not the design intent (artifacts/label_spread_pilot2.json).
    hardness raises the noise share of the color: h=1 is pure noise."""
    pts = _sphere_points(n, rng, fuzz=0.05)
    smooth = _smooth_colors(pts, rng, freq=1.0).astype(np.float64)
    noise = rng.uniform(0, 255, (n, 3))
    w = 0.45 + 0.55 * hardness
    cols = (1 - w) * smooth + w * noise
    return pts, np.clip(cols, 0, 255).astype(np.uint8)


def fan(rng, hardness=0.5, n=130_000):
    """van taken past its pilot-1 sweet spot (van h=1 scored 34, +11 over
    h=0).  DESIGNED as the high-label anchor, but pilot 2 MEASURED
    fan0=34, fan7=25: past a blade-density threshold the grid can only
    represent the vanes' angular AVERAGE, the ceiling drops, and the
    curve flattens early — fan's hard end anchors the LOW-mid band
    instead (artifacts/label_spread_pilot2.json).  Deliberately kept a
    near-copy of :func:`van` (same rng call order) so the two families'
    label difference is attributable to the constants alone."""
    k = int(12 + round(8 * hardness))
    per = n // k
    parts, cols = [], []
    twist = 1.4 + 1.2 * hardness
    for j in range(k):
        r = rng.uniform(0.15, 1.0, per)
        z = rng.uniform(-0.7, 0.7, per)
        ang = 2 * np.pi * j / k + twist * z
        th = 0.02
        w = rng.uniform(-th, th, per)
        p = np.stack([r * np.cos(ang) - w * np.sin(ang),
                      r * np.sin(ang) + w * np.cos(ang), z], axis=1)
        parts.append(p)
        base = rng.uniform(60, 220, 3)
        cols.append(np.clip(base + 40 * np.sin(p * 3 + j), 0, 255))
    return np.concatenate(parts), np.concatenate(cols).astype(np.uint8)


FAMILIES = {
    "uni": uni, "ell": ell, "blo": blo, "tor": tor, "box": box,
    "clu": clu, "cup": cup, "pla": pla, "spi": spi, "van": van,
    "nos": nos, "fan": fan,
}


def make_family_object(name: str, model_dir: str) -> str:
    """Create ``<model_dir>/<name>.ply`` for ``name`` = '<fam><idx>'.

    Deterministic: rng is seeded from the name, hardness ramps with the
    object index so each family sweeps easy -> hard.  Idempotent (skips
    existing files) to preserve the pipeline's resume guards."""
    fam, idx = name[:3], int(name[3:])
    path = os.path.join(model_dir, f"{name}.ply")
    if os.path.exists(path):
        return path
    os.makedirs(model_dir, exist_ok=True)
    rng = np.random.default_rng(zlib.crc32(name.encode()))  # process-stable seed
    hardness = (idx % 8) / 7.0  # 8-step sweep per family
    pts, cols = FAMILIES[fam](rng, hardness=hardness)
    save_ply_binary(path, pts, cols)
    return path


def object_roster(per_family: int, families=None) -> list:
    fams = list(families or FAMILIES)
    return [f"{fam}{i}" for fam in fams for i in range(per_family)]
