"""The Python mirrors of K8's binning and K9's step interval, on the CPU.

K8 (``ops/csrc/splat.cu``) bins splats by screen tile into bins sized from
the shapes alone (``splat.bin_capacity``); K9 (``ops/csrc/voxel_cast.cu``)
marches only the steps of ``voxel_cast.step_interval``.  Neither kernel runs
here, so these tests hold the formulas the kernels implement: the capacity
is never below the entries the binning makes, and the interval holds every
step whose sample the plain march finds inside the grid.  Each also shows
that its check catches a formula one tile or one step too tight.
"""

import numpy as np
import pytest
import torch

from nerf_prv_tpu_torch.core.config import CameraConfig
from nerf_prv_tpu_torch.ops import splat as splat_mod
from nerf_prv_tpu_torch.ops import voxel_cast as cast_mod
from nerf_prv_tpu_torch.ops.splat import _frame_projection, bin_capacity, bin_counts_plain, tiles_per_axis

torch.set_num_threads(1)

# fx a power of two and the principal point at 0: a point at (u / 64, v / 64, 1)
# projects exactly onto pixel (u, v)
BIN_CAMERA = CameraConfig(width=200, height=120, fx=64.0, fy=64.0, ppx=0.0, ppy=0.0, model=0)
POINT_SIZES = [1, 2, 3, 4, 5, 7, 15, 16, 17, 31, 32, 33, 34, 40]


def _border_cloud(ps, tile, seed, n_random=1500):
    """Points on every tile border of the frame (the last pixel of a tile,
    the first of the next, half a square to either side) and up to ``ps``
    beyond the frame's edges, at depth 1; then random points at random depths."""
    rng = np.random.default_rng(seed)
    half = ps // 2
    borders = np.arange(0, max(BIN_CAMERA.width, BIN_CAMERA.height) + tile, tile)
    marks = np.unique(np.concatenate([borders + k for k in (-half - 1, -half, -1, 0, 1, ps - half - 1, ps - half)]))
    marks = np.concatenate([marks, [-ps, -ps + 1, BIN_CAMERA.width + ps - 1, BIN_CAMERA.height + ps - 1]])
    u, v = np.meshgrid(marks, marks[::3], indexing="ij")
    exact = np.stack([u.ravel() / 64.0, v.ravel() / 64.0, np.ones(u.size)], axis=1)
    z = rng.uniform(0.5, 2.0, size=(n_random, 1))
    uv = np.stack([rng.uniform(-ps, BIN_CAMERA.width + ps, n_random), rng.uniform(-ps, BIN_CAMERA.height + ps, n_random)],
                  axis=1)
    rand = np.concatenate([uv / 64.0 * z, z], axis=1)
    return torch.from_numpy(np.concatenate([exact, rand]).astype(np.float32))


def _poses(seed):
    """The identity and a small rotation and shift."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=3) * 0.05
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    m = np.eye(3, 4)
    m[:, :3] += k
    m[:, 3] = rng.normal(size=3) * 0.01
    return torch.from_numpy(np.stack([np.eye(3, 4), m]).astype(np.float32))


def _pairs_by_pixel(points, w2c, ps, tile):
    """Bin entries counted the long way: every in-frame pixel of every
    square, then the distinct (point, tile) pairs among them."""
    cam = BIN_CAMERA
    tiles_x, tiles_y = -(-cam.width // tile), -(-cam.height // tile)
    half = ps // 2
    offs = torch.arange(-half, ps - half)
    du, dv = (t.reshape(-1) for t in torch.meshgrid(offs, offs, indexing="ij"))
    out = []
    for m in w2c:
        uf, vf, _, valid = _frame_projection(points, m, cam, ps)
        idx = torch.nonzero(valid)[:, 0]
        uu = (uf[valid].long()[:, None] + du).reshape(-1)
        vv = (vf[valid].long()[:, None] + dv).reshape(-1)
        who = idx.repeat_interleave(ps * ps)
        ok = (uu >= 0) & (uu < cam.width) & (vv >= 0) & (vv < cam.height)
        t = (vv[ok] // tile) * tiles_x + uu[ok] // tile
        pairs = torch.unique(who[ok] * (tiles_x * tiles_y) + t)
        out.append(torch.bincount(pairs % (tiles_x * tiles_y), minlength=tiles_x * tiles_y).reshape(tiles_y, tiles_x))
    return torch.stack(out)


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("ps", POINT_SIZES)
def test_splat_bin_capacity_holds_the_binning(ps, tile):
    """``bin_capacity`` from shapes is never below a frame's entries as the
    binning mirror counts them, on clouds with points on every tile border
    and beyond the frame's edges; the mirror agrees with a count over the
    squares' pixels; and a point whose square starts on a tile's last pixel
    fills the capacity exactly."""
    pts = _border_cloud(ps, tile, seed=ps * 100 + tile)
    w2c = _poses(seed=ps)
    counts = bin_counts_plain(pts, w2c, BIN_CAMERA, ps, tile)
    assert counts.shape == (2, -(-BIN_CAMERA.height // tile), -(-BIN_CAMERA.width // tile))
    assert torch.equal(counts, _pairs_by_pixel(pts, w2c, ps, tile))
    per_frame = counts.sum(dim=(1, 2))
    assert int(per_frame.min()) > 0
    assert bool((per_frame <= bin_capacity(len(pts), ps, tile)).all())
    # the worst case: the square's first pixel is a tile's last, u and v
    corner = tile - 1 + ps // 2
    one = torch.tensor([[corner / 64.0, corner / 64.0, 1.0]], dtype=torch.float32)
    assert tile - 1 + ps <= BIN_CAMERA.height  # the whole square is in the frame
    worst = bin_counts_plain(one, w2c[:1], BIN_CAMERA, ps, tile)
    assert int(worst.sum()) == bin_capacity(1, ps, tile) == tiles_per_axis(ps, tile) ** 2


def test_splat_bin_capacity_check_catches_one_tile_too_few(monkeypatch):
    """A capacity of one tile fewer a side is below the binning's entries
    where the squares straddle a tile corner."""
    ps, tile = 5, 32
    pts = torch.tensor([[tile / 64.0, tile / 64.0, 1.0]], dtype=torch.float32).repeat(100, 1)
    counts = bin_counts_plain(pts, _poses(seed=7), BIN_CAMERA, ps, tile)
    monkeypatch.setattr(splat_mod, "tiles_per_axis", lambda p, t: (p - 2) // t + 1)
    assert not bool((counts.sum(dim=(1, 2)) <= splat_mod.bin_capacity(len(pts), ps, tile)).all())


def test_splat_bins_of_one_pixel_cloud_hold_every_point():
    """All points on one pixel inside a tile: that bin holds N entries."""
    pts = torch.tensor([[40 / 64.0, 40 / 64.0, 1.0]], dtype=torch.float32).repeat(1000, 1)
    counts = bin_counts_plain(pts, _poses(0)[:1], BIN_CAMERA, 5, 32)
    assert int(counts[0, 1, 1]) == 1000 and int(counts.sum()) == 1000


# --- K9's step interval -------------------------------------------------------

GRIDS = {  # dims, corner, voxel size, max range, steps
    "test grid": ((40, 30, 20), (-0.04, -0.03, -0.02), 0.002, 0.4, 400),
    "object grid": ((44, 43, 77), (-0.044, -0.043, -0.077), 0.002, 1.0, 1000),
}


def _rays(kind, grid, n, seed):
    """(origins, dirs) f32 of one kind of ray against ``grid``."""
    dims, corner, res, max_range, _ = grid
    rng = np.random.default_rng(seed)
    lo = np.asarray(corner, np.float64)
    size = np.asarray(dims) * res
    hi = lo + size
    centre = lo + size / 2
    if kind == "random":  # from a sphere around the box, aimed near it or away
        o = rng.normal(size=(n, 3))
        o = centre + o / np.linalg.norm(o, axis=1, keepdims=True) * max_range * 0.6
        d = centre + rng.normal(size=(n, 3)) * size - o
        d[: n // 4] *= -1
    elif kind == "inside_origin":
        o = lo + rng.uniform(0, 1, size=(n, 3)) * size
        d = rng.normal(size=(n, 3))
    elif kind == "axis_parallel":  # along +-x, +-y, +-z from outside the box
        axis = rng.integers(0, 3, n)
        sign = rng.choice([-1.0, 1.0], n)
        o = lo + rng.uniform(-0.2, 1.2, size=(n, 3)) * size
        o[np.arange(n), axis] = np.where(sign > 0, lo[axis] - 0.05, hi[axis] + 0.05)
        d = np.zeros((n, 3))
        d[np.arange(n), axis] = sign
    elif kind == "grazing":  # on a face's plane or an edge, along the face or nearly
        axis = rng.integers(0, 3, n)
        o = lo + rng.uniform(-0.2, 1.2, size=(n, 3)) * size
        face = np.where(rng.uniform(size=n) < 0.5, lo[axis], hi[axis])
        o[np.arange(n), axis] = face + rng.choice([0.0, 1e-9, -1e-9, res * 1e-3], n)
        edge = rng.uniform(size=n) < 0.3  # on an edge: a second axis on its face too
        other = (axis + 1) % 3
        o[edge, other[edge]] = lo[other[edge]]
        d = rng.normal(size=(n, 3))
        d[np.arange(n), axis] = rng.choice([0.0, 1e-7, -1e-7, 1e-4], n)
        d[edge, other[edge]] = 0.0
        start = rng.uniform(size=n) < 0.5  # half of them start before the box
        o[start] -= d[start] / np.linalg.norm(d[start], axis=1, keepdims=True) * 0.05
    elif kind == "zero_component":  # one or two direction components exactly 0
        o = centre + rng.uniform(-1, 1, size=(n, 3)) * size
        d = rng.normal(size=(n, 3))
        d[np.arange(n), rng.integers(0, 3, n)] = 0.0
        two = rng.uniform(size=n) < 0.4
        d[two, (rng.integers(0, 3, n)[two])] = 0.0
        o[: n // 2] -= d[: n // 2] * 0.1
    else:  # non_finite: zero directions, NaN and inf in origins or directions
        o = centre + rng.uniform(-1, 1, size=(n, 3)) * size
        d = rng.normal(size=(n, 3))
        d[0::4] = 0.0
        o[1::4, 0] = np.nan
        d[2::4, 1] = np.nan
        o[3::4, 2] = np.inf
    return torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d.astype(np.float32))


def _interval_and_inside(grid, o, d):
    dims, corner, res, max_range, n_steps = grid
    occ = torch.zeros(dims, dtype=torch.bool)
    inside = torch.cat([c[3] for c in cast_mod.march_chunks(occ, corner, res, o, d, max_range, n_steps)])
    lo, hi = cast_mod.step_interval(dims, corner, res, o, d, max_range, n_steps)
    return lo, hi, inside


def _outside_interval(lo, hi, inside):
    s = torch.arange(inside.shape[1])[None, :]
    return inside & ((s < lo[:, None]) | (s > hi[:, None]))


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("kind", ["random", "inside_origin", "axis_parallel", "grazing", "zero_component",
                                  "non_finite"])
def test_voxel_cast_step_interval_holds_every_inside_step(kind, grid):
    """``step_interval`` contains every step whose sample ``march_chunks``
    finds inside the grid, for random rays, rays from inside the box,
    axis-parallel and grazing rays (on a face's plane or an edge, along it
    or nearly), rays with zero direction components, and non-finite rays
    (none of whose samples is inside).  Rays that never meet the box, and
    non-finite rays, get no step."""
    g = GRIDS[grid]
    o, d = _rays(kind, g, 3000, seed=len(kind) * 7 + len(grid))
    lo, hi, inside = _interval_and_inside(g, o, d)
    assert int(_outside_interval(lo, hi, inside).sum()) == 0
    n_steps = g[4]
    assert bool(((lo >= 0) & (hi <= n_steps - 1)).all())
    met = inside.any(dim=1)
    if kind == "non_finite":
        assert bool((hi < lo).all())
        return
    assert bool(met.any())
    marched = torch.clamp(hi - lo + 1, min=0)
    if kind in ("random", "axis_parallel", "inside_origin"):
        # the interval is the box's chord and a few steps: a small share of the march
        assert float(marched.sum()) < 0.5 * n_steps * len(o)
        assert float(marched.sum()) <= float(inside.sum()) + (2 * cast_mod.MARGIN_STEPS + 2) * len(o)
    if kind in ("random", "axis_parallel"):
        assert int((hi[~met] < lo[~met]).sum()) > 0.5 * int((~met).sum())


def test_voxel_cast_step_interval_check_catches_one_step_too_tight(monkeypatch):
    """With the margin at -1 (one step inside the exact interval at each
    end) the interval misses inside steps, and the check says so."""
    g = GRIDS["test grid"]
    o, d = _rays("random", g, 3000, seed=5)
    monkeypatch.setattr(cast_mod, "MARGIN_STEPS", -1)
    lo, hi, inside = _interval_and_inside(g, o, d)
    assert int(_outside_interval(lo, hi, inside).sum()) > 0
