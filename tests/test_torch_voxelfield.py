"""The port's voxel field against the JAX package, function by function,
from the same numpy parameters and points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_prv_tpu.nerf import model as jm
from nerf_prv_tpu.nerf import voxelfield as jvf
from nerf_prv_tpu_torch.convert import params_from_numpy, params_to_numpy
from nerf_prv_tpu_torch.nerf import model as tm
from nerf_prv_tpu_torch.nerf import voxelfield as tvf
from voxel_common import G, both, cfgs, np_params, points

# one thread for PyTorch: the tests' tensors are tiny, and several test workers on
# a few cores otherwise spend their time contending for them (minutes, not seconds)
torch.set_num_threads(1)

# f32 end to end; sin/cos/exp and the matmuls' summation order differ
# between XLA and PyTorch on the CPU: measured below 4e-6 on raw densities
# of magnitude up to ~10, the bound leaves a few times that
F32_TOL = 2e-5
# bf16 matmuls round each activation to 8 mantissa bits and the two
# frameworks may round one an ulp apart, which the next layer carries
BF16_TOL = dict(raw=6e-2, rgb=2e-2)
# gradients of a mean over a few hundred samples, f32; relative to the
# largest entry of each parameter's gradient
GRAD_TOL = 2e-4


def test_cell_and_frac_bitwise():
    x, _ = points(2000)
    # more points exactly on cell faces and around the clip
    x[6:30, 0] = np.arange(24, dtype=np.float32) / (G - 1)
    x[30:40] = np.float32(1.0) - np.float32(1e-6) * np.arange(10, dtype=np.float32)[:, None]
    for g in (G, 40):
        idx_j, frac_j = jvf.cell_and_frac(jnp.asarray(x), g)
        idx_t, frac_t = tvf.cell_and_frac(torch.from_numpy(x), g)
        assert idx_t.dtype == torch.int32
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
        np.testing.assert_array_equal(frac_t.numpy(), np.asarray(frac_j))
        cell = np.stack(np.unravel_index(idx_t.numpy(), (g, g, g)), -1)
        assert cell.max() <= g - 2 and idx_t.min() >= 0


def test_corner_weights_and_blend_match():
    rng = np.random.default_rng(2)
    frac = rng.uniform(0, 1, size=(300, 3)).astype(np.float32)
    frac[:2] = [[0, 0, 0], [1, 1, 1]]
    rows = rng.uniform(-1, 1, size=(300, 64)).astype(np.float32)
    assert tvf.CORNERS == jvf.CORNERS
    w_t = tvf.corner_weights(torch.from_numpy(frac)).numpy()
    np.testing.assert_allclose(w_t, np.asarray(jvf.corner_weights(jnp.asarray(frac))), rtol=0, atol=1e-7)
    np.testing.assert_allclose(w_t.sum(-1), 1.0, atol=1e-6)
    np.testing.assert_allclose(
        tvf.blend_rows(torch.from_numpy(rows), torch.from_numpy(frac), 8).numpy(),
        np.asarray(jvf.blend_rows(jnp.asarray(rows), jnp.asarray(frac), 8)), rtol=0, atol=1e-6,
    )


def test_pe_encode_matches():
    x, _ = points()
    got = tvf.pe_encode(torch.from_numpy(x), 4).numpy()
    want = np.asarray(jvf.pe_encode(jnp.asarray(x), 4))
    assert got.shape == want.shape == (len(x), 24)
    # sin/cos of arguments up to 8 pi: an f32 ulp of the argument
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-6)


def test_init_voxel_params_shapes_and_ranges():
    jcfg, tcfg = cfgs()
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tm.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert sorted(jp) == sorted(tp)
    for k in jp:
        assert tuple(jp[k].shape) == tuple(tp[k].shape), k
        assert tp[k].dtype == torch.float32
        # the same uniform range on both sides, and both fill it
        lim = float(np.abs(np.asarray(jp[k])).max())
        assert float(tp[k].abs().max()) <= lim * 1.05 + 1e-12
        assert float(tp[k].abs().max()) >= lim * 0.9
    again = tm.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert all(torch.equal(tp[k], again[k]) for k in tp)


@pytest.mark.parametrize("gather", ["bf16", "f32"])
def test_voxel_field_f32_matches(gather):
    jcfg, tcfg = cfgs(voxel_gather_dtype=gather)
    jp, tp = both(np_params(jcfg))
    x, d = points()
    sig_j, rgb_j = jm.field(jp, jnp.asarray(x), jnp.asarray(d), jcfg)
    sig_t, rgb_t = tm.field(tp, torch.from_numpy(x), torch.from_numpy(d), tcfg)
    raw_j, geo_j = jvf.voxel_density_raw(jp, jnp.asarray(x), jcfg)
    raw_t, geo_t = tvf.voxel_density_raw(tp, torch.from_numpy(x), tcfg)
    assert float(raw_t.max() - raw_t.min()) > 2.0  # the field is not flat
    np.testing.assert_allclose(raw_t.numpy(), np.asarray(raw_j), rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(geo_t.numpy(), np.asarray(geo_j), rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), rtol=1e-4, atol=F32_TOL)
    np.testing.assert_allclose(
        tm.density(tp, torch.from_numpy(x), tcfg).numpy(), sig_t.numpy(), rtol=0, atol=0
    )


def test_voxel_field_bf16_compute_matches():
    jcfg, tcfg = cfgs("bf16")
    jp, tp = both(np_params(jcfg))
    x, d = points()
    raw_j, _ = jvf.voxel_density_raw(jp, jnp.asarray(x), jcfg)
    raw_t, _ = tvf.voxel_density_raw(tp, torch.from_numpy(x), tcfg)
    _, rgb_j = jm.field(jp, jnp.asarray(x), jnp.asarray(d), jcfg)
    _, rgb_t = tm.field(tp, torch.from_numpy(x), torch.from_numpy(d), tcfg)
    np.testing.assert_allclose(raw_t.numpy(), np.asarray(raw_j), rtol=0, atol=BF16_TOL["raw"])
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=0, atol=BF16_TOL["rgb"])


def test_sorted_grad_impl_takes_the_f32_gather():
    """``voxel_grad_impl="sorted"`` gathers in f32 on both sides (and in the
    port scatter-adds like every other setting)."""
    jcfg, tcfg = cfgs(voxel_grad_impl="sorted")
    _, tcfg_f32 = cfgs(voxel_gather_dtype="f32")
    jp, tp = both(np_params(jcfg))
    x, _ = points()
    raw_t, _ = tvf.voxel_density_raw(tp, torch.from_numpy(x), tcfg)
    raw_f, _ = tvf.voxel_density_raw(tp, torch.from_numpy(x), tcfg_f32)
    raw_j, _ = jvf.voxel_density_raw(jp, jnp.asarray(x), jcfg)
    assert torch.equal(raw_t, raw_f)
    np.testing.assert_allclose(raw_t.numpy(), np.asarray(raw_j), rtol=0, atol=F32_TOL)


def test_lattice_corner_raw_matches():
    jcfg, tcfg = cfgs()
    jp, tp = both(np_params(jcfg))
    want = np.asarray(jvf.lattice_corner_raw(jp, jcfg))
    got = tvf.lattice_corner_raw(tp, tcfg).numpy()
    assert got.shape == want.shape == (G ** 3, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("gather", ["bf16", "f32"])
def test_voxel_field_gradients_match(gather):
    """d loss / d every parameter, loss = mean(sigma-weighted rgb + raw^2)."""
    jcfg, tcfg = cfgs(voxel_gather_dtype=gather)
    p = np_params(jcfg, density_gain=1.0)
    jp, tp = both(p)
    x, d = points(600)
    w = np.random.default_rng(7).uniform(-1, 1, size=(600, 3)).astype(np.float32)

    def jloss(q):
        sig, rgb = jm.field(q, jnp.asarray(x), jnp.asarray(d), jcfg)
        return jnp.mean(jnp.tanh(sig)[:, None] * rgb * jnp.asarray(w)) + 1e-2 * jnp.mean(jnp.log(sig) ** 2)

    want = jax.grad(jloss)(jp)
    for v in tp.values():
        v.requires_grad_(True)
    sig, rgb = tm.field(tp, torch.from_numpy(x), torch.from_numpy(d), tcfg)
    loss = torch.mean(torch.tanh(sig)[:, None] * rgb * torch.from_numpy(w)) + 1e-2 * torch.mean(torch.log(sig) ** 2)
    np.testing.assert_allclose(float(loss.detach()), float(jloss(jp)), rtol=1e-5)
    loss.backward()
    for k in p:
        gj = np.asarray(want[k])
        gt = tp[k].grad.numpy()
        assert gt.shape == gj.shape and np.isfinite(gt).all()
        scale = np.abs(gj).max()
        assert scale > 0, k
        assert np.abs(gt - gj).max() <= GRAD_TOL * scale, (k, np.abs(gt - gj).max(), scale)
    # only gathered rows get gradient
    touched = np.unique(np.asarray(jvf.cell_and_frac(jnp.asarray(x), G)[0]))
    rest = np.setdiff1d(np.arange(G ** 3), touched)
    assert float(np.abs(tp["grid"].grad.numpy()[rest]).max()) == 0.0


def test_bf16_gather_rounds_the_cotangent():
    """With the bf16 gather the row cotangents reach the scatter-add
    bf16-rounded (as in JAX) and are summed in f32: the grid gradient of
    sum(rows * c) is the scatter-add of bf16(c), not of c."""
    _, tcfg = cfgs(voxel_gather_dtype="bf16")
    _, tp = both(np_params(tcfg))
    x, _ = points(600)
    c = np.random.default_rng(8).uniform(-1, 1, size=(600, 64)).astype(np.float32)
    idx_j, _ = jvf.cell_and_frac(jnp.asarray(x), G)
    idx, _ = tvf.cell_and_frac(torch.from_numpy(x), G)
    tp["grid"].requires_grad_(True)
    (tvf._gather(tp, idx, tcfg) * torch.from_numpy(c)).sum().backward()
    got = tp["grid"].grad.numpy()
    c_bf = torch.from_numpy(c).to(torch.bfloat16).float().numpy()
    want = np.zeros_like(got)
    np.add.at(want, np.asarray(idx_j), c_bf)
    exact = np.zeros_like(got)
    np.add.at(exact, np.asarray(idx_j), c)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)  # a few f32 adds per row
    assert np.abs(got - exact).max() > 1e-4  # bf16 keeps 8 bits of c


def test_voxel_params_round_trip_through_convert(tmp_path):
    """``grid`` and the MLP weights cross unchanged, through arrays and
    through an npz snapshot written by the JAX package."""
    from nerf_prv_tpu.nerf import api as japi

    jcfg, _ = cfgs()
    p = np_params(jcfg)
    back = params_to_numpy(params_from_numpy(p, device="cpu"))
    assert sorted(back) == sorted(p) and "grid" in back
    for k in p:
        np.testing.assert_array_equal(back[k], p[k])
        assert back[k].dtype == p[k].dtype
    snap = str(tmp_path / "v.ingp")
    japi.save_snapshot(snap, {k: jnp.asarray(v) for k, v in p.items()})
    loaded = params_from_numpy(snap, device="cpu")
    np.testing.assert_array_equal(loaded["grid"].numpy(), p["grid"])
