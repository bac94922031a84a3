"""The port's coverage-dataset stages against the JAX package's, on the
CPU: ``get_coverage``, ``generate_novel_sets``, ``get_size_test``,
``shapenet_preprocess`` and ``get_clean_data`` write the same files (PNGs
compared as arrays, jsons field by field)."""

import json
import os

import numpy as np
import torch
from PIL import Image

from nerf_prv_tpu.core.config import CameraConfig as JCam
from nerf_prv_tpu.core.config import Config as JConfig
from nerf_prv_tpu.pipeline import coverage as jc
from nerf_prv_tpu.scene.object_setup import load_object as j_load
from nerf_prv_tpu.viewspace.hemisphere import generate_hemisphere, save_view_space
from nerf_prv_tpu.viewspace.novel import sample_novel_views
from nerf_prv_tpu_torch.core.config import CameraConfig as TCam
from nerf_prv_tpu_torch.core.config import Config as TConfig
from nerf_prv_tpu_torch.pipeline import coverage as tc
from nerf_prv_tpu_torch.scene.object_setup import load_object as t_load
from nerf_prv_tpu_torch.scene.ply import load_ply, save_ply_binary

from synthetic import make_object

torch.set_num_threads(1)

CAM = dict(width=96, height=64, fx=80.0, fy=80.0, ppx=48.3, ppy=31.7, model=2, k1=0.12, k2=-0.21)
N_VIEWS = 6  # the coverage set's size
N_NOVEL = 4  # each novel set's size


def _workspaces(tmp_path):
    """One toy object, view spaces and novel view files written by the
    reference; a config per side with its own workspace."""
    pts, cols = make_object(6000, seed=0, size=1.0)
    save_ply_binary(str(tmp_path / "models" / "ShapeNet" / "obj0.ply"), pts, cols)
    vs = str(tmp_path / "viewspace")
    for n in sorted({5, N_VIEWS, 7}):
        save_view_space(vs, generate_hemisphere(n, seed=n, restarts=2, steps=100))
    common = dict(model_path=str(tmp_path / "models"), viewspace_path=vs, name_of_pcd="obj0", num_of_views=7,
                  num_of_novel_test_views=N_NOVEL, points_size_cloud=3)
    cfgs = (JConfig(workspace=str(tmp_path / "jax"), camera=JCam(**CAM), **common),
            TConfig(workspace=str(tmp_path / "port"), camera=TCam(**CAM), **common))
    for i, name in enumerate(("novel_train_views.txt", "novel_test_views.txt")):
        views = sample_novel_views(N_NOVEL, seed=i, restarts=32)
        for cfg in cfgs:
            os.makedirs(cfg.workspace, exist_ok=True)
            np.savetxt(os.path.join(cfg.workspace, name), views)
    return cfgs


def _same_json(a, b):
    ja, jb = json.load(open(a)), json.load(open(b))
    assert ja.keys() == jb.keys()
    for k in ja:
        if k == "frames":
            assert len(ja[k]) == len(jb[k])
            for fa, fb in zip(ja[k], jb[k]):
                assert fa["file_path"] == fb["file_path"]
                np.testing.assert_array_equal(np.asarray(fa["transform_matrix"]), np.asarray(fb["transform_matrix"]))
        else:
            assert ja[k] == jb[k], k


def _same_pngs(dir_a, dir_b, n):
    assert sorted(os.listdir(dir_a)) == sorted(os.listdir(dir_b)) == sorted(f"rgbaClip_{i}.png" for i in range(n))
    for i in range(n):
        a = np.asarray(Image.open(os.path.join(dir_a, f"rgbaClip_{i}.png")))
        b = np.asarray(Image.open(os.path.join(dir_b, f"rgbaClip_{i}.png")))
        assert a.shape == b.shape and a.shape[-1] == 4
        # every pixel (measured: 0 differ; both round the same f32 operations)
        np.testing.assert_array_equal(b, a)


def test_coverage_and_novel_sets_write_the_same_files(tmp_path):
    jcfg, tcfg = _workspaces(tmp_path)
    jscene, tscene = j_load(jcfg, "obj0"), t_load(tcfg, "obj0", device="cpu")
    assert tscene.size == jscene.size
    ja = jc.get_coverage(jscene, jcfg, N_VIEWS)
    ta = tc.get_coverage(tscene, tcfg, N_VIEWS, device="cpu")
    assert os.path.relpath(ta, tcfg.workspace) == os.path.relpath(ja, jcfg.workspace)
    _same_json(ta, ja)
    _same_pngs(os.path.join(tcfg.gt_path, str(N_VIEWS)), os.path.join(jcfg.gt_path, str(N_VIEWS)), N_VIEWS)
    lit = np.asarray(Image.open(os.path.join(tcfg.gt_path, str(N_VIEWS), "rgbaClip_0.png")))[..., 3] > 0
    assert 0.02 < lit.mean() < 0.9
    assert tc.get_coverage(tscene, tcfg, N_VIEWS, device="cpu") == ta  # idempotent on the json

    jn = jc.generate_novel_sets(jscene, jcfg)
    tn = tc.generate_novel_sets(tscene, tcfg, device="cpu")
    for a, b, sub in zip(tn, jn, ("novel_train", "novel_test")):
        _same_json(a, b)
        _same_pngs(os.path.join(tcfg.gt_path, sub), os.path.join(jcfg.gt_path, sub), N_NOVEL)

    out_t, out_j = str(tmp_path / "one_t.png"), str(tmp_path / "one_j.png")
    v = tscene.view_space.views[2]
    np.testing.assert_array_equal(tc.render_view_to_png(tscene, v, tcfg, out_t, device="cpu"),
                                  jc.render_view_to_png(jscene, v, jcfg, out_j))
    np.testing.assert_array_equal(np.asarray(Image.open(out_t)), np.asarray(Image.open(out_j)))


def test_size_test_shapenet_preprocess_and_clean_data(tmp_path):
    jcfg, tcfg = _workspaces(tmp_path)
    # ShapeNet layout: <root>/<synset>/<model>/models/model_normalized_sample.ply
    root = tmp_path / "shapenet"
    rng = np.random.default_rng(5)
    for synset in ("03001627", "99999999"):
        for k, model in enumerate(("m0", "m1")):
            pts = rng.normal(size=(300, 3))
            cols = rng.integers(0, 256, size=(300, 3), dtype=np.uint8)
            cols[:40] = 255  # white is clamped to 250
            save_ply_binary(str(root / synset / model / "models" / "model_normalized_sample.ply"), pts,
                            None if k else cols)
    names = {}
    for side, mod, cfg in (("port", tc, tcfg), ("jax", jc, jcfg)):
        cfg = cfg.replace(shape_net=str(root), model_path=str(tmp_path / f"models_{side}"))
        names[side] = (mod.shapenet_preprocess(cfg, ["03001627", "99999999", "00000000"]), cfg)
    assert names["port"][0] == names["jax"][0] == ["chair0", "chair1", "999999990", "999999991"]
    for n in names["port"][0]:
        a = load_ply(os.path.join(names["port"][1].model_path, "ShapeNet", n + ".ply"))
        b = load_ply(os.path.join(names["jax"][1].model_path, "ShapeNet", n + ".ply"))
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert not (a[1] == 255).all(axis=1).any()  # no white point left
    for side in ("port", "jax"):
        path = os.path.join(names[side][1].model_path, "ShapeNet_names.txt")
        assert open(path).read() == "chair0\nchair1\n999999990\n999999991\n"

    # size test (mode 2) on the toy object, then cleaning (mode 11) with
    # written sizes inside and outside the window
    assert tc.get_size_test(tcfg, ["obj0"], device="cpu") == jc.get_size_test(jcfg, ["obj0"]) == ["obj0"]
    for cfg in (tcfg, jcfg):
        for name, size in (("a", 0.08), ("b", 0.2), ("c", 0.1)):
            d = cfg.replace(name_of_pcd=name).gt_path
            os.makedirs(d, exist_ok=True)
            open(os.path.join(d, "size.txt"), "w").write(str(size))
    got = tc.get_clean_data(tcfg, ["a", "b", "c", "missing", "obj0"], batch_size=2)
    want = jc.get_clean_data(jcfg, ["a", "b", "c", "missing", "obj0"], batch_size=2)
    assert got == want
    for name in got:
        for b in range(2):
            pa = os.path.join(tcfg.workspace, "Coverage_images", f"ShapeNet_{b}", name, "size.txt")
            pb = os.path.join(jcfg.workspace, "Coverage_images", f"ShapeNet_{b}", name, "size.txt")
            assert os.path.exists(pa) == os.path.exists(pb)
            if os.path.exists(pa):
                assert open(pa).read() == open(pb).read()
    assert open(os.path.join(tcfg.model_path, "clean_names.txt")).read() == \
        open(os.path.join(jcfg.model_path, "clean_names.txt")).read()
    assert tc.ID2NAME == jc.ID2NAME
