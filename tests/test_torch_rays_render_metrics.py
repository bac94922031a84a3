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

# one thread for PyTorch: the tests' tensors are tiny, and several test workers on
# a few cores otherwise spend their time contending for them (minutes, not seconds)
torch.set_num_threads(1)

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


# --- the voxel field's occupancy probe and its aux-probed renders -----------

from nerf_prv_tpu_torch.nerf.rays import ray_sphere as t_ray_sphere  # noqa: E402
from voxel_common import G, both, cfgs as vcfgs, np_params, rays as vrays  # noqa: E402


def _voxel(seed=0, **kw):
    jcfg, tcfg = vcfgs(**kw)
    jp, tp = both(np_params(jcfg, seed=seed))
    return jcfg, tcfg, jp, tp


def test_build_render_aux_matches():
    jcfg, tcfg, jp, tp = _voxel()
    want = jrd.build_render_aux(jp, jcfg)
    got = trd.build_render_aux(tp, tcfg)
    assert got.cell_raw.dtype == torch.bfloat16 and got.cell_raw.shape == (G ** 3, 8)
    assert got.pooled.shape == (G // 2, G // 2, G // 2)
    # the corner densities agree to ~1e-6 in f32 (test_torch_voxelfield), so
    # as bf16 they are bit-equal except where a value sits on a rounding
    # boundary: allow one bf16 ulp on at most 0.1% of them
    a = got.cell_raw.view(torch.int16).numpy().astype(np.int32)
    b = np.asarray(want.cell_raw).view(np.int16).astype(np.int32)
    assert np.abs(a - b).max() <= 1 and (a != b).mean() <= 1e-3
    np.testing.assert_allclose(got.pooled.numpy(), np.asarray(want.pooled), rtol=1e-5, atol=1e-6)
    assert float(got.pooled.max()) > 1.0  # the field is occupied
    # no aux where the reference has none
    assert trd.build_render_aux(tp, dataclasses.replace(tcfg, bound="cube")) is None


def test_pooled_lookup_keeps_the_bf16_rounding():
    jcfg, tcfg, jp, tp = _voxel()
    pooled = np.array(jrd.build_render_aux(jp, jcfg).pooled)
    pos = np.random.default_rng(3).uniform(0, 1, size=(50, 8, 3)).astype(np.float32)
    pos[0, 0] = [1 - 1e-6] * 3
    want = np.asarray(jrd._pooled_lookup(jnp.asarray(pooled), jnp.asarray(pos), G))
    got = trd._pooled_lookup(torch.from_numpy(pooled), torch.from_numpy(pos), G).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != pooled.reshape(-1)[0]).any() and np.abs(got).max() > 0


def test_probe_levels_match():
    jcfg, tcfg, jp, tp = _voxel()
    jaux = jrd.build_render_aux(jp, jcfg)
    # both sides probe the same tables, so thresholds cannot flip on them
    taux = trd.RenderAux(
        torch.from_numpy(np.array(jaux.cell_raw.astype(jnp.float32))).to(torch.bfloat16),
        torch.from_numpy(np.array(jaux.pooled)),
    )
    o, d = vrays(512, seed=5)
    jo, jd, to, td = jnp.asarray(o), jnp.asarray(d), torch.from_numpy(o), torch.from_numpy(d)
    jb = jr.ray_sphere(jo, jd)
    tb = t_ray_sphere(to, td)
    l1_j = jrd._probe_level1(jaux, jo, jd, *jb, jcfg)
    l1_t = trd._probe_level1(taux, to, td, *tb, tcfg)
    assert 0 < int(l1_t[2].sum()) < 512
    np.testing.assert_array_equal(l1_t[2].numpy(), np.asarray(l1_j[2]))
    for a, b in zip(l1_j[:2], l1_t[:2]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)
    l2_j = jrd._probe_level2(jaux, jo, jd, l1_j[0], l1_j[1], jcfg)
    l2_t = trd._probe_level2(taux, to, td, torch.from_numpy(np.asarray(l1_j[0])), torch.from_numpy(np.asarray(l1_j[1])), tcfg)
    np.testing.assert_array_equal(l2_t[2].numpy(), np.asarray(l2_j[2]))
    for a, b in zip(l2_j[:2], l2_t[:2]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)
    sig_j = jrd._cell_sigma_at(jaux.cell_raw, jnp.asarray(o[:, None, :] * 0 + 0.4), G)
    sig_t = trd._cell_sigma_at(taux.cell_raw, torch.from_numpy(o[:, None, :] * 0 + 0.4), G)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), rtol=1e-5)


def test_render_rays_with_aux_matches():
    jcfg, tcfg, jp, tp = _voxel()
    o, d = vrays(512, seed=6)
    rgb_j, a_j = jrd.render_rays(jp, jnp.asarray(o), jnp.asarray(d), jcfg, aux=jrd.build_render_aux(jp, jcfg))
    rgb_t, a_t = trd.render_rays(tp, torch.from_numpy(o), torch.from_numpy(d), tcfg, aux=trd.build_render_aux(tp, tcfg))
    assert float(a_t.max()) > 0.5 and float(a_t[:16].max()) == 0.0
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=0, atol=RENDER_TOL)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=0, atol=RENDER_TOL)


@pytest.mark.parametrize(
    "w,h,chunk",
    [(48, 40, 512), (640, 12, 1024), (640, 12, 1 << 17)],
    ids=["per_ray", "tile_path_wide_frame", "tile_path_one_chunk"],
)
def test_render_views_with_aux_matches(w, h, chunk):
    jcfg, tcfg, jp, tp = _voxel()
    kw = dict(width=w, height=h, fx=w / 6.4, fy=w / 6.4, ppx=w / 2, ppy=h / 2, model=0)
    org, rot = _views(2, seed=2)
    want = np.asarray(jrd.render_views(jp, jnp.asarray(org), jnp.asarray(rot), JCam(**kw), jcfg, chunk=chunk))
    got, finish = trd.render_views(tp, org, rot, TCam(**kw), tcfg, chunk=chunk, defer=True)
    assert finish() is None and got.shape == (2, h, w, 4)
    assert float(got[..., 3].max()) > 0.5 and float(got[..., 3].min()) == 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RENDER_TOL)
    # an aux the caller built serves every group, as eval_nerf passes it
    again = trd.render_views(tp, org, rot, TCam(**kw), tcfg, chunk=chunk, aux=trd.build_render_aux(tp, tcfg))
    assert torch.equal(again, got)


def test_tile_path_equals_render_rays_per_ray():
    """The two-phase tile render gives each ray what ``render_rays(aux)``
    gives it, bit for bit."""
    _, tcfg, _, tp = _voxel()
    w, h = 640, 6
    cam = TCam(width=w, height=h, fx=100.0, fy=100.0, ppx=w / 2, ppy=h / 2, model=0)
    org, rot = _views(1, seed=4)
    aux = trd.build_render_aux(tp, tcfg)
    frame = trd.render_views(tp, org, rot, cam, tcfg, chunk=512, aux=aux)[0].reshape(-1, 4)
    o_all, d_all = trd._assemble_rays(torch.from_numpy(org), torch.from_numpy(rot), trd._pixel_dirs(cam, "cpu"))
    rgb, a = trd.render_rays(tp, o_all, d_all, tcfg, aux=aux)
    assert torch.equal(frame[:, :3], rgb) and torch.equal(frame[:, 3], a)


# --- importance resampling, the baked train probe, the span bucket ----------


def _cdf_inputs(n=64, s=16, seed=7):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.uniform(2.0, 4.0, size=(n, s)).astype(np.float32), axis=1)
    w = rng.uniform(0, 1, size=(n, s)).astype(np.float32) ** 4
    w[:4] = 0.0  # rays without any mass: the 1e-5 floor makes the cdf uniform
    u = rng.uniform(size=(n, 8)).astype(np.float32)
    u[4, :3] = [0.0, 1.0 - 2.0 ** -24, 0.5]
    return ts, w, u


def test_sample_cdf_matches_with_given_and_deterministic_uniforms(monkeypatch):
    """Given the same uniforms (handed to the reference in place of
    ``jax.random.uniform``) and with the deterministic bin midpoints.
    Tolerance 2e-6 on positions in [2, 4]: a cumsum and a division in f32;
    measured 4.8e-7."""
    ts, w, u = _cdf_inputs()
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(u))
    want = np.asarray(jrd._sample_cdf(jnp.asarray(ts), jnp.asarray(w), 8, jax.random.PRNGKey(0)))
    monkeypatch.undo()
    got = trd._sample_cdf(torch.from_numpy(ts), torch.from_numpy(w), 8, u=torch.from_numpy(u))
    assert got.shape == (64, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
    assert (got.numpy() >= ts[:, :1] - 1e-6).all() and (got.numpy() <= ts[:, -1:] + 1e-6).all()
    want_det = np.asarray(jrd._sample_cdf(jnp.asarray(ts), jnp.asarray(w), 5, None))
    got_det = trd._sample_cdf(torch.from_numpy(ts), torch.from_numpy(w), 5)
    np.testing.assert_allclose(got_det.numpy(), want_det, rtol=0, atol=2e-6)
    # a generator draws the uniforms: reproducible, inside the bins, not the midpoints
    a = trd._sample_cdf(torch.from_numpy(ts), torch.from_numpy(w), 5, generator=torch.Generator().manual_seed(1))
    b = trd._sample_cdf(torch.from_numpy(ts), torch.from_numpy(w), 5, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, got_det)


def _jax_training_uniforms(key, n, ns, n_fine):
    """The jitter and the importance uniforms ``render_rays(key=key)`` draws."""
    key, kj = jax.random.split(key)
    jitter = jax.random.uniform(kj, (n, ns))
    _, kf = jax.random.split(key)
    return np.asarray(jitter), np.asarray(jax.random.uniform(kf, (n, n_fine)))


@pytest.mark.parametrize("field_impl,train_coarse", [("voxel", 12), ("voxel", 0), ("hash", 12)])
def test_render_rays_with_importance_matches(field_impl, train_coarse):
    """The training march with ``n_importance=8`` given the uniforms the
    reference draws from its key: coarse density pass, inverse-CDF
    resampling, sorted fine positions, ``diff`` deltas.  Tolerance: the
    eval renders' (f32 composites and matmuls in other orders)."""
    kw = dict(n_importance=8, train_coarse=train_coarse)
    if field_impl == "voxel":
        jcfg, tcfg, jp, tp = _voxel(**kw)
        o, d = vrays(256, seed=8)
    else:
        jcfg, tcfg = _cfgs(**kw)
        jp, tp = _params(jcfg)
        o, d = _rays(256, seed=8)
    key = jax.random.PRNGKey(3)
    jitter, u = _jax_training_uniforms(key, 256, jcfg.n_samples, 8)
    rgb_j, a_j = jrd.render_rays(jp, jnp.asarray(o), jnp.asarray(d), jcfg, key=key)
    rgb_t, a_t = trd.render_rays(
        tp, torch.from_numpy(o), torch.from_numpy(d), tcfg,
        jitter=torch.from_numpy(jitter), importance_u=torch.from_numpy(u),
    )
    assert float(a_t.max()) > 0.5 and float(a_t[:16].max()) == 0.0
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=0, atol=RENDER_TOL)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=0, atol=RENDER_TOL)
    # and it differs from the flat march with the same jitter
    flat = trd.render_rays(tp, torch.from_numpy(o), torch.from_numpy(d),
                           dataclasses.replace(tcfg, n_importance=0), jitter=torch.from_numpy(jitter))
    assert float((flat[1] - a_t).abs().max()) > 1e-3


def test_importance_needs_uniforms_and_takes_a_generator():
    """A precomputed jitter without a source of importance uniforms raises
    on both sides; a generator draws jitter and uniforms, reproducibly, and
    gradients flow to the parameters but not through the coarse pass."""
    jcfg, tcfg, jp, tp = _voxel(n_importance=4)
    o, d = vrays(64, seed=9)
    jitter = np.random.default_rng(0).uniform(size=(64, 16)).astype(np.float32)
    with pytest.raises(ValueError, match="n_importance"):
        jrd.render_rays(jp, jnp.asarray(o), jnp.asarray(d), jcfg, jitter=jnp.asarray(jitter))
    with pytest.raises(ValueError, match="n_importance"):
        trd.render_rays(tp, torch.from_numpy(o), torch.from_numpy(d), tcfg, jitter=torch.from_numpy(jitter))
    for v in tp.values():
        v.requires_grad_(True)
    args = (tp, torch.from_numpy(o), torch.from_numpy(d), tcfg)
    a = trd.render_rays(*args, generator=torch.Generator().manual_seed(2))
    b = trd.render_rays(*args, generator=torch.Generator().manual_seed(2))
    c = trd.render_rays(*args, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    a[0].sum().backward()
    assert all(v.grad is not None and bool(torch.isfinite(v.grad).all()) for v in tp.values())
    assert float(tp["grid"].grad.abs().max()) > 0


def test_tighten_interval_baked_matches():
    """The baked train probe on one bf16 table (made by JAX, handed to
    both): the same occupancy flags, intervals within 1e-6."""
    jcfg, tcfg, jp, tp = _voxel(train_probe_refresh=10)
    praw_j = jrd.build_render_aux(jp, jcfg).cell_raw
    praw_t = torch.from_numpy(np.array(praw_j.astype(jnp.float32))).to(torch.bfloat16)
    o, d = vrays(512, seed=10)
    jo, jd, to, td = jnp.asarray(o), jnp.asarray(d), torch.from_numpy(o), torch.from_numpy(d)
    want = jrd._tighten_interval_baked(praw_j, jo, jd, *jr.ray_sphere(jo, jd), jcfg.train_coarse, jcfg)
    got = trd._tighten_interval_baked(praw_t, to, td, *t_ray_sphere(to, td), tcfg.train_coarse, tcfg)
    assert 0 < int(got[2].sum()) < 512
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for a, b in zip(want[:2], got[:2]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)
    # through render_rays: the training march probes the table, not the field
    jitter = np.random.default_rng(1).uniform(size=(512, 16)).astype(np.float32)
    rgb_j, a_j = jrd.render_rays(jp, jo, jd, jcfg, jitter=jnp.asarray(jitter), probe_raw=praw_j)
    rgb_t, a_t = trd.render_rays(tp, to, td, tcfg, jitter=torch.from_numpy(jitter), probe_raw=praw_t)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=0, atol=RENDER_TOL)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=0, atol=RENDER_TOL)


def test_span_bucket_partition_and_render():
    """``_partition_short`` moves short-span occupied rays first (stable,
    occupied rays stay ahead of non-occupied) exactly as the reference's
    ``_jit_partition_short``, and the span-bucketed ``render_views`` gives
    the reference's frame at the same chunk size."""
    tlo = np.zeros(8, np.float32)
    thi = np.asarray([0.1, 0.8, 0.3, 0.6, 0.7, 0.4, 0.5, 0.2], np.float32)
    occ = np.asarray([1, 1, 1, 1, 1, 1, 1, 0], np.float32)
    rays_np = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    packed = np.concatenate([rays_np, tlo[:, None], thi[:, None], occ[:, None]], axis=-1)
    out_j, pos_j, n_j = jrd._jit_partition_short(jnp.asarray(packed), 12, 24)
    out_t, pos_t, n_t = trd._partition_short(torch.from_numpy(packed), 12, 24)
    assert int(n_t) == int(n_j) == 3  # short = occupied & span <= 0.4: rows 0, 2, 5
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
    np.testing.assert_allclose(out_t[:3, 7].numpy(), [0.1, 0.3, 0.4])
    assert bool((out_t[:7, 8] > 0.5).all()) and not bool(out_t[7, 8] > 0.5)

    # 655 of the 1,772 level-2 survivors are short here: five whole
    # 128-ray chunks march at 12 samples, the rest at 16
    jcfg, tcfg, jp, tp = _voxel(render_span_bucket=True, render_short_samples=12)
    w, h, chunk = 640, 12, 128
    kw = dict(width=w, height=h, fx=w / 6.4, fy=w / 6.4, ppx=w / 2, ppy=h / 2, model=0)
    org, rot = _views(2, seed=2)
    jrd._SPEC_COUNTS.clear()  # the reference's first call per shape is exact
    want = np.asarray(jrd.render_views(jp, jnp.asarray(org), jnp.asarray(rot), JCam(**kw), jcfg, chunk=chunk))
    got = trd.render_views(tp, org, rot, TCam(**kw), tcfg, chunk=chunk)
    assert got.shape == (2, h, w, 4) and float(got[..., 3].max()) > 0.5
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RENDER_TOL)
    plain = trd.render_views(tp, org, rot, TCam(**kw), dataclasses.replace(tcfg, render_span_bucket=False), chunk=chunk)
    diff = float((plain - got).abs().max())
    assert 1e-3 < diff  # some whole chunks marched at the short count
    psnr = -10.0 * np.log10(float(((plain - got) ** 2).mean()))
    assert psnr > 25.0, psnr  # and stayed close to the uniform march
    # a short count that is not shorter switches nothing
    same = trd.render_views(tp, org, rot, TCam(**kw), dataclasses.replace(tcfg, render_short_samples=16), chunk=chunk)
    assert torch.equal(same, plain)
