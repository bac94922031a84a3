"""The port's rays, eval render and metrics against the JAX package."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_prv_tpu.core.config import CameraConfig as JCam
from nerf_prv_tpu.core.pose import camera_to_world
from nerf_prv_tpu.nerf import hashgrid as jhg
from nerf_prv_tpu.nerf import metrics as jmet
from nerf_prv_tpu.nerf import model as jm
from nerf_prv_tpu.nerf import rays as jr
from nerf_prv_tpu.nerf import render as jrd
from nerf_prv_tpu_torch.convert import params_from_numpy
from nerf_prv_tpu_torch.core.config import CameraConfig as TCam
from nerf_prv_tpu_torch.nerf import hashgrid as thg
from nerf_prv_tpu_torch.nerf import metrics as tmet
from nerf_prv_tpu_torch.nerf import model as tm
from nerf_prv_tpu_torch.nerf import rays as tr
from nerf_prv_tpu_torch.nerf import render as trd
from synthetic import write_scene

GRID = dict(levels=4, features=2, log2_table=12, n_min=4, n_max=64)
# f32 end to end; the two sides sum the composite and the matmuls in other
# orders: renders measured within 3.5e-5 of each other (the wide frame's
# saturating rays), and the bound leaves about three times that
RENDER_TOL = 1e-4


def _cfgs(**kw):
    jcfg = jm.NerfConfig(
        grid=jhg.HashGridConfig(**GRID), hidden=16, field_impl="hash",
        encode_impl="xla", compute_dtype=jnp.float32, **kw,
    )
    tcfg = tm.NerfConfig(
        grid=thg.HashGridConfig(**GRID), hidden=16, field_impl="hash",
        encode_impl="fused", compute_dtype=torch.float32, **kw,
    )
    return jcfg, tcfg


def _params(jcfg):
    p = {k: np.array(v) for k, v in jm.init_params(jax.random.PRNGKey(0), jcfg).items()}
    p["table"] *= 1e4  # O(1) features
    p["sigma_w1"][:, 0] *= 20.0  # densities from ~0 to saturating
    return {k: jnp.asarray(v) for k, v in p.items()}, params_from_numpy(p, device="cpu")


def _views(n, seed):
    rng = np.random.default_rng(seed)
    vv = rng.normal(size=(n, 3))
    vv[:, 2] = np.abs(vv[:, 2])
    vv /= np.linalg.norm(vv, axis=1, keepdims=True)
    c2w = camera_to_world(vv * 0.3, np.zeros(3) + 1e-4)
    rot = c2w[:, :3, :3][:, [2, 0, 1], :].astype(np.float32)
    org = (c2w[:, :3, 3][:, [2, 0, 1]] * 5.0 + 0.5).astype(np.float32)
    return org, rot


def _rays(n=256, seed=0):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 0.1 + np.array([0.5, 0.5, 2.0])).astype(np.float32)
    tgt = rng.uniform(0.2, 0.8, size=(n, 3))
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[:16] = [0.0, 0.0, 1.0]  # pointing away: misses
    return o, d


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_scene(str(tmp_path_factory.mktemp("scene")), n_train=2, n_test=2, n_points=4000)


def test_load_dataset_identical(scene):
    for path in scene[:2]:
        j = jr.load_dataset(path)
        t = tr.load_dataset(path)
        np.testing.assert_array_equal(t.origins, j.origins)
        np.testing.assert_array_equal(t.rotations, j.rotations)
        np.testing.assert_array_equal(t.pixels, j.pixels)
        np.testing.assert_array_equal(t.offset, j.offset)
        assert t.scale == j.scale and t.n_frames == j.n_frames and t.hw == j.hw
        assert dataclasses.asdict(t.camera) == dataclasses.asdict(j.camera)


def test_pixel_dirs_and_ray_bounds_match():
    cam = dict(width=64, height=48, fx=60.0, fy=61.0, ppx=31.0, ppy=25.0, model=0)
    u = np.arange(64, dtype=np.float32).repeat(48)
    v = np.tile(np.arange(48, dtype=np.float32), 64)
    np.testing.assert_allclose(
        tr.pixel_dirs_cam(TCam(**cam), torch.from_numpy(u), torch.from_numpy(v)).numpy(),
        np.asarray(jr.pixel_dirs_cam(JCam(**cam), jnp.asarray(u), jnp.asarray(v))),
        rtol=0, atol=1e-6,
    )
    o, d = _rays()
    for jf, tf in ((jr.ray_sphere, tr.ray_sphere), (jr.ray_aabb, tr.ray_aabb)):
        for a, b in zip(jf(jnp.asarray(o), jnp.asarray(d)), tf(torch.from_numpy(o), torch.from_numpy(d))):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)


def test_composite_and_clamp_occupied_match():
    rng = np.random.default_rng(4)
    n, s = 200, 24
    sigma = np.exp(rng.normal(size=(n, s)) * 4).astype(np.float32)
    sigma[:20] = 0.0  # empty rays
    rgb = rng.uniform(size=(n, s, 3)).astype(np.float32)
    deltas = rng.uniform(0.01, 0.05, size=(n, s)).astype(np.float32)
    want = jrd._composite(jnp.asarray(sigma), jnp.asarray(rgb), jnp.asarray(deltas))
    got = trd._composite(torch.from_numpy(sigma), torch.from_numpy(rgb), torch.from_numpy(deltas))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)
    tmin = rng.uniform(0, 1, n).astype(np.float32)
    span = rng.uniform(0.1, 1.0, n).astype(np.float32)
    want = jrd._clamp_occupied(jnp.asarray(sigma), jnp.asarray(tmin), jnp.asarray(span), s)
    got = trd._clamp_occupied(torch.from_numpy(sigma), torch.from_numpy(tmin), torch.from_numpy(span), s)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)


@pytest.mark.parametrize("bound", ["sphere", "cube"])
def test_render_rays_eval_matches(bound):
    jcfg, tcfg = _cfgs(bound=bound)
    jp, tp = _params(jcfg)
    o, d = _rays()
    rgb_j, a_j = jrd.render_rays(jp, jnp.asarray(o), jnp.asarray(d), jcfg)
    rgb_t, a_t = trd.render_rays(tp, torch.from_numpy(o), torch.from_numpy(d), tcfg)
    assert float(a_t.max()) > 0.5  # the field is not empty
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=0, atol=RENDER_TOL)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=0, atol=RENDER_TOL)


@pytest.mark.parametrize(
    "w,h,bound",
    [(48, 40, "sphere"), (640, 12, "sphere"), (48, 40, "cube")],
    ids=["per_ray", "tile_path_wide_frame", "cube"],
)
def test_render_views_matches(w, h, bound):
    jcfg, tcfg = _cfgs(bound=bound)
    jp, tp = _params(jcfg)
    kw = dict(width=w, height=h, fx=w / 6.4, fy=w / 6.4, ppx=w / 2, ppy=h / 2, model=0)
    org, rot = _views(2, seed=2)
    want = np.asarray(jrd.render_views(jp, jnp.asarray(org), jnp.asarray(rot), JCam(**kw), jcfg, chunk=1024))
    got, finish = trd.render_views(tp, org, rot, TCam(**kw), tcfg, chunk=1024, defer=True)
    assert finish() is None
    assert got.shape == (2, h, w, 4)
    assert float(got[..., 3].max()) > 0.5 and float(got[..., 3].min()) == 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RENDER_TOL)


def test_metrics_match():
    rng = np.random.default_rng(5)
    a = rng.uniform(-0.1, 1.1, size=(2, 40, 50, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape) * 0.05, 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for i in range(2):
        want = jmet.evaluate_pair(jnp.asarray(a[i]), jnp.asarray(b[i]))
        got = tmet.evaluate_pair(ta[i], tb[i])
        batched = tmet.evaluate_pair(ta, tb)
        for x, y, z in zip(want, got, batched):
            np.testing.assert_allclose(float(y), float(x), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(float(z[i]), float(x), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            float(tmet.psnr(ta[i], tb[i])), float(jmet.psnr(jnp.asarray(a[i]), jnp.asarray(b[i]))),
            rtol=1e-5,
        )
        np.testing.assert_allclose(
            float(tmet.ssim(ta[i], tb[i])), float(jmet.ssim(jnp.asarray(a[i]), jnp.asarray(b[i]))),
            rtol=0, atol=1e-5,
        )
    for jf, tf in ((jmet.linear_to_srgb, tmet.linear_to_srgb), (jmet.srgb_to_linear, tmet.srgb_to_linear)):
        np.testing.assert_allclose(tf(ta).numpy(), np.asarray(jf(jnp.asarray(a))), rtol=0, atol=1e-6)
