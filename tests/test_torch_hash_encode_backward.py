"""The table-gradient kernel's arithmetic, mirrored in PyTorch on the CPU,
against the port's plain version and the JAX package's sorted VJP.

The CUDA kernel (``ops/csrc/hash_encode_backward.cu``) runs only on the card,
where tests/test_torch_cuda_kernels.py holds it against a float64 sum.  The
mirror here computes the table gradient the way that kernel's design does:
runs of equal cells among each 32 consecutive points (a warp) summed first,
and the two x-corners of a (y, z) added as one 16-byte update where their
rows form an aligned pair.  Its count of atomic adds is held against the
count that ``chip_smoke.py`` prints beside the kernel's time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from nerf_prv_tpu.nerf import hashgrid as jhg
from nerf_prv_tpu.ops import sorted_grad as jsg
from nerf_prv_tpu_torch.nerf import hashgrid as thg
from nerf_prv_tpu_torch.ops.hash_encode import hash_encode_backward, level_plan
from nerf_prv_tpu_torch.ops.sorted_grad import table_grad_sorted

# one thread for PyTorch: the tests' tensors are tiny, and several test workers on
# a few cores otherwise spend their time contending for them (minutes, not seconds)
torch.set_num_threads(1)

WARP = 32

# Table gradients, as a share of the largest entry.  The mirror, the sorted
# plain version and JAX sum the same f32 products in orders of their own (run
# totals first; pairs; index_add_ against run totals taken as differences
# of one f32 cumsum over all N x levels x 8 updates, which is the loosest);
# measured 1.4e-7 to 3.0e-6 against the plain version and 2.1e-7 to 4.5e-6
# against JAX over these 18 cases.  1e-5 leaves room for another PyTorch
# or XLA build's order.
GRAD_TOL = 1e-5


def table_grad_as_kernel(x, g, cfg):
    """(d_table, atomic adds) for positions x (N, 3) and output cotangent g
    (N, levels*F), computed the way the CUDA kernel computes them: per level
    each point's 8 corner products w*g; runs of consecutive points in one
    cell, ending at every 32nd point, summed into their first point; per
    run and (y, z) the two x-corners' updates as one update of an aligned
    pair of rows where the rows differ in bit 0 only and F <= 2, else one
    update per row (two 16-byte adds for F = 8); then ``index_add_``."""
    res_list, dense = level_plan(cfg)
    n, f, t = x.shape[0], cfg.features, cfg.table_size
    out = torch.zeros((cfg.levels * t, f), dtype=torch.float32)
    per_row = 2 if f == 8 else 1
    warp_start = torch.arange(n) % WARP == 0
    adds = 0
    for level in range(cfg.levels):
        res = res_list[level]
        assert bool(dense[level]) == thg.is_dense(res, t)
        pos = x * float(res)
        cell = torch.clamp(torch.floor(pos), 0, res - 1)
        frac = pos - cell
        cell = cell.to(torch.int64)
        g_level = g[:, level * f : (level + 1) * f]
        u = []  # corner c = (di, dj, dk) = (c >> 2, (c >> 1) & 1, c & 1)
        for c in range(8):
            wx = frac[:, 0] if c & 4 else 1.0 - frac[:, 0]
            wy = frac[:, 1] if c & 2 else 1.0 - frac[:, 1]
            wz = frac[:, 2] if c & 1 else 1.0 - frac[:, 2]
            u.append((wx * wy * wz)[:, None] * g_level)
        u = torch.stack(u, dim=1)  # (N, 8, F)
        head = warp_start.clone()
        head[1:] |= (cell[1:] != cell[:-1]).any(dim=1)
        run = torch.cumsum(head.to(torch.int64), 0) - 1
        sums = torch.zeros((int(head.sum()), 8, f)).index_add_(0, run, u)
        cells = cell[head]
        base = level * t
        for jk in range(4):
            dj, dk = jk >> 1, jk & 1
            r0 = thg._corner_indices(cells + torch.tensor([0, dj, dk]), res, t)
            r1 = thg._corner_indices(cells + torch.tensor([1, dj, dk]), res, t)
            a, b = sums[:, jk], sums[:, 4 + jk]
            merged = ((r0 ^ r1) == 1) if f <= 2 else torch.zeros_like(r0, dtype=torch.bool)
            if bool(merged.any()):
                odd = ((r0 & 1) == 1)[:, None]
                pair = torch.cat([torch.where(odd, b, a), torch.where(odd, a, b)], dim=1)
                out.view(-1, 2 * f).index_add_(0, ((base + (r0 & ~1)) // 2)[merged], pair[merged])
            single = ~merged
            out.index_add_(0, base + r0[single], a[single])
            out.index_add_(0, base + r1[single], b[single])
            adds += int(merged.sum()) + 2 * per_row * int(single.sum())
    return out, adds


def _points(kind, n, seed):
    """(n, 3) float32 points: uniform with the cube's boundaries (0, 1 - 1e-6
    and 1 on every axis) first, all in one cell of every level, or rays of 5
    to 40 samples each, one after another, so that runs start anywhere in a
    warp and cross its edges."""
    rng = np.random.default_rng(seed)
    if kind == "boundary":
        x = rng.uniform(0, 1, size=(n, 3))
        edge = [0.0, 1.0 - 1e-6, 1.0]
        corners = np.array([[a, b, c] for a in edge for b in edge for c in edge])
        x[: min(n, 27)] = corners[: min(n, 27)]
    elif kind == "one_cell":
        x = 0.3 + rng.uniform(0, 1e-4, size=(n, 3))  # one cell up to res 2048
    else:
        rays = []
        while sum(len(r) for r in rays) < n:
            k = int(rng.integers(5, 41))
            o = rng.uniform(0.1, 0.9, size=3)
            d = rng.normal(size=3)
            d /= np.linalg.norm(d)
            ts = np.sort(rng.uniform(0, 1, size=k)) * rng.uniform(0.005, 0.2)
            rays.append(o + ts[:, None] * d)
        x = np.clip(np.concatenate(rays)[:n], 0.0, 1.0 - 1e-6)
    return torch.from_numpy(x.astype(np.float32))


CONFIGS = {
    "default_6_levels": dict(levels=6),  # 16 -> 2048: levels 0-1 dense, 2-5 hashed
    "log2_table14": dict(log2_table=14),  # the default grid, levels 2-15 hashed
    "f1": dict(levels=5, features=1, log2_table=12, n_min=4, n_max=64),
    "f2": dict(levels=5, features=2, log2_table=12, n_min=4, n_max=64),
    "f4": dict(levels=5, features=4, log2_table=12, n_min=4, n_max=64),
    "f8": dict(levels=5, features=8, log2_table=12, n_min=4, n_max=64),
}


def _jax_table_grad(cfg_kw, table_shape, x, g):
    jcfg = jhg.HashGridConfig(**cfg_kw)
    loss = lambda t: jnp.sum(jsg.encode_sorted(t, jnp.asarray(x), jcfg) * jnp.asarray(g))  # noqa: E731
    return np.asarray(jax.grad(loss)(jnp.zeros(table_shape, jnp.float32)))


@pytest.mark.parametrize("kind", ["boundary", "one_cell", "ray_ordered"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_kernel_mirror_matches_plain_version_and_jax(name, kind):
    """N = 203 (a ragged last warp).  Boundary points, every point in one
    cell (one run per warp and level) and ray-ordered runs that cross warp
    edges; dense and hashed levels; F = 1, 2, 4 and 8."""
    cfg_kw = CONFIGS[name]
    cfg = thg.HashGridConfig(**cfg_kw)
    n = 203
    x = _points(kind, n, seed=len(name))
    g = torch.from_numpy(np.random.default_rng(7).normal(size=(n, cfg.out_dim)).astype(np.float32))
    got, adds = table_grad_as_kernel(x, g, cfg)
    plain = table_grad_sorted(x, g, cfg)
    want = _jax_table_grad(cfg_kw, tuple(plain.shape), x.numpy(), g.numpy())
    scale = float(np.abs(want).max())
    assert scale > 0.5
    assert float((got - plain).abs().max()) <= GRAD_TOL * scale
    assert np.abs(got.numpy() - want).max() <= GRAD_TOL * scale
    assert torch.equal(hash_encode_backward(x, g, cfg), plain)  # the wrapper's CPU path

    per_row = 2 if cfg.features == 8 else 1
    assert adds == chip_smoke.backward_atomics(x, cfg)
    assert chip_smoke.backward_atomics(x, cfg, merge_pairs=False, presum_runs=False) == n * cfg.levels * 8 * per_row
    if kind == "one_cell":  # one run per warp and level
        warps = -(-n // WARP)
        assert chip_smoke.backward_atomics(x, cfg, merge_pairs=False) == warps * cfg.levels * 8 * per_row
    if cfg.features <= 2 and kind != "one_cell":
        # about every other x-pair merges: 6 of 8 adds per (run, level)
        unmerged = chip_smoke.backward_atomics(x, cfg, merge_pairs=False)
        assert 0.65 <= adds / unmerged <= 0.85


@settings(max_examples=40, deadline=None, database=None)
@given(
    features=st.sampled_from([1, 2, 4, 8]),
    log2_table=st.integers(min_value=0, max_value=14),
    n=st.integers(min_value=1, max_value=150),
    kind=st.sampled_from(["boundary", "one_cell", "ray_ordered"]),
    seed=st.integers(min_value=0, max_value=2**31 - 1),
)
def test_mirror_issues_the_adds_that_chip_smoke_counts(features, log2_table, n, kind, seed):
    """The mirror's adds, one by one, and ``chip_smoke.backward_atomics``,
    vectorised, count the same for any points, width and table size (down
    to one row a level, where no pair merges); never more than one add per
    corner row."""
    cfg = thg.HashGridConfig(levels=3, features=features, log2_table=log2_table, n_min=4, n_max=40)
    x = _points(kind, n, seed)
    g = torch.ones((n, cfg.out_dim))
    _, adds = table_grad_as_kernel(x, g, cfg)
    assert adds == chip_smoke.backward_atomics(x, cfg)
    assert adds <= n * cfg.levels * 8 * (2 if features == 8 else 1)
