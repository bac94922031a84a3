"""The port's hash-field model against the JAX package, module by module."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_prv_tpu.nerf import hashgrid as jhg
from nerf_prv_tpu.nerf import model as jm
from nerf_prv_tpu_torch.convert import params_from_numpy, params_to_numpy
from nerf_prv_tpu_torch.nerf import hashgrid as thg
from nerf_prv_tpu_torch.nerf import model as tm

GRID = dict(levels=4, features=2, log2_table=12, n_min=4, n_max=64)
F32_TOL = 1e-5
# bf16 rounds each matmul output to 8 mantissa bits; the two frameworks'
# bf16 GEMMs may round an element one ulp apart (0.0039 at |raw| < 1),
# which the next layer carries: about two ulps of slack (the CPU run of
# this test agrees exactly)
BF16_TOL = dict(raw=1e-2, rgb=5e-3)


def _cfgs(compute):
    jcfg = jm.NerfConfig(
        grid=jhg.HashGridConfig(**GRID), hidden=16, field_impl="hash",
        encode_impl="xla", compute_dtype=jnp.float32 if compute == "f32" else jnp.bfloat16,
    )
    tcfg = tm.NerfConfig(
        grid=thg.HashGridConfig(**GRID), hidden=16, field_impl="hash",
        encode_impl="fused", compute_dtype=torch.float32 if compute == "f32" else torch.bfloat16,
    )
    return jcfg, tcfg


def _params(jcfg, seed=0):
    p = jm.init_params(jax.random.PRNGKey(seed), jcfg)
    p = {k: np.asarray(v) for k, v in p.items()}
    p["table"] = p["table"] * 1e4  # O(1) features so the MLPs see signal
    return p


def _inputs(n=300, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return x, d


def test_nerf_config_defaults_match_jax():
    jf = {f.name: f for f in dataclasses.fields(jm.NerfConfig)}
    tf = {f.name: f for f in dataclasses.fields(tm.NerfConfig)}
    assert list(jf) == list(tf)
    j, t = jm.NerfConfig(), tm.NerfConfig()
    for name in jf:
        if name == "compute_dtype":
            assert j.compute_dtype == jnp.bfloat16 and t.compute_dtype == torch.bfloat16
        elif name == "grid":
            assert dataclasses.asdict(j.grid) == dataclasses.asdict(t.grid)
        else:
            assert getattr(j, name) == getattr(t, name), name


@pytest.mark.parametrize(
    "bad", [dict(train_rng="bogus"), dict(train_scan_unroll=0), dict(adam_moment_dtype="fp16")]
)
def test_nerf_config_checks_match_jax(bad):
    with pytest.raises(ValueError):
        jm.NerfConfig(**bad)
    with pytest.raises(ValueError):
        tm.NerfConfig(**bad)


def test_voxel_field_not_ported_yet():
    with pytest.raises(NotImplementedError):
        tm.init_params(torch.Generator().manual_seed(0), tm.NerfConfig(), device="cpu")
    with pytest.raises(NotImplementedError):
        tm.field({}, torch.zeros(1, 3), torch.zeros(1, 3), tm.NerfConfig())


def test_init_params_shapes_match_jax():
    jcfg, tcfg = _cfgs("bf16")
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tm.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert sorted(jp) == sorted(tp)
    for k in jp:
        assert tuple(jp[k].shape) == tuple(tp[k].shape), k
        assert tp[k].dtype == torch.float32


def test_params_round_trip():
    jcfg, _ = _cfgs("f32")
    p = _params(jcfg)
    back = params_to_numpy(params_from_numpy(p, device="cpu"))
    for k in p:
        np.testing.assert_array_equal(back[k], p[k])
        assert back[k].dtype == p[k].dtype


def test_sh_encode_matches_jax():
    _, d = _inputs()
    want = np.asarray(jm.sh_encode_deg4(jnp.asarray(d)))
    got = tm.sh_encode_deg4(torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_field_matches_jax(compute):
    jcfg, tcfg = _cfgs(compute)
    p = _params(jcfg)
    x, d = _inputs()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = params_from_numpy(p, device="cpu")
    xt, dt = torch.from_numpy(x), torch.from_numpy(d)

    raw_j, geo_j = jm.density_raw(jp, jnp.asarray(x), jcfg)
    raw_t, geo_t = tm.density_raw(tp, xt, tcfg)
    rgb_j = jm.radiance(jp, geo_j, jnp.asarray(d), jcfg)
    rgb_t = tm.radiance(tp, torch.from_numpy(np.array(geo_j)), dt, tcfg)
    sig_j, frgb_j = jm.field(jp, jnp.asarray(x), jnp.asarray(d), jcfg)
    sig_t, frgb_t = tm.field(tp, xt, dt, tcfg)
    dens_t = tm.density(tp, xt, tcfg)

    tol_raw = F32_TOL if compute == "f32" else BF16_TOL["raw"]
    tol_rgb = F32_TOL if compute == "f32" else BF16_TOL["rgb"]
    np.testing.assert_allclose(raw_t.numpy(), np.asarray(raw_j), rtol=0, atol=tol_raw)
    np.testing.assert_allclose(geo_t.numpy(), np.asarray(geo_j), rtol=0, atol=tol_raw)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=0, atol=tol_rgb)
    np.testing.assert_allclose(frgb_t.numpy(), np.asarray(frgb_j), rtol=0, atol=tol_rgb)
    # sigma = exp(raw): compare relative to its size
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), rtol=tol_raw * 1.2, atol=0)
    np.testing.assert_array_equal(dens_t.numpy(), sig_t.numpy())
