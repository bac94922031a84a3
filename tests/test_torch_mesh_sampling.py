"""The port's mesh sampling and native PLY loader against the JAX
package's: the same OBJ through load, dedupe, sampling and voxel thinning
gives the same points for the same seed; the native ``load_ply`` (over
``csrc/libprv_runtime.so``) reads what the Python parser reads."""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch
from PIL import Image

from nerf_prv_tpu.scene import mesh_sampling as jm
from nerf_prv_tpu_torch.runtime import native
from nerf_prv_tpu_torch.scene import mesh_sampling as tm
from nerf_prv_tpu_torch.scene import ply as tply

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")


def _write_obj(d, textured=True, duplicate=True):
    """A box of two materials: a textured one and a plain ``Kd`` one, with
    some faces listed twice (once rewound)."""
    tex = np.zeros((16, 16, 3), np.uint8)
    tex[:, :8] = [200, 30, 30]
    tex[:, 8:] = [30, 30, 200]
    Image.fromarray(tex).save(os.path.join(d, "tex.png"))
    with open(os.path.join(d, "m.mtl"), "w") as f:
        f.write("newmtl a\nKd 0.2 0.7 0.3\n" + ("map_Kd tex.png\n" if textured else ""))
        f.write("newmtl b\nKd 0.9 0.6 0.1\n")
    v = [(0, 0, 0), (1, 0, 0), (1, 0.5, 0), (0, 0.5, 0), (0, 0, 0.3), (1, 0, 0.3), (1, 0.5, 0.3), (0, 0.5, 0.3)]
    quads = [(1, 2, 3, 4), (5, 8, 7, 6), (1, 5, 6, 2), (2, 6, 7, 3), (3, 7, 8, 4), (5, 1, 4, 8)]
    path = os.path.join(d, "model_normalized.obj")
    with open(path, "w") as f:
        f.write("mtllib m.mtl\n")
        f.writelines(f"v {x} {y} {z}\n" for x, y, z in v)
        f.write("vt 0.1 0.1\nvt 0.9 0.1\nvt 0.9 0.9\nvt 0.1 0.9\n")
        for k, q in enumerate(quads):
            if k in (0, 3):
                f.write("usemtl " + ("a" if k == 0 else "b") + "\n")
            f.write(f"f {q[0]}/1 {q[1]}/2 {q[2]}/3 {q[3]}/4\n")
        if duplicate:
            f.write(f"f {quads[1][0]}/1 {quads[1][1]}/2 {quads[1][2]}/3 {quads[1][3]}/4\n")
            f.write(f"f {quads[4][3]} {quads[4][2]} {quads[4][1]} {quads[4][0]}\n")
    return path


def test_load_dedupe_and_sample_equal(tmp_path):
    path = _write_obj(str(tmp_path))
    a, b = tm.load_obj(path), jm.load_obj(path)
    for f in ("vertices", "faces", "uvs", "face_uvs", "face_materials"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert [m.name for m in a.materials] == [m.name for m in b.materials] and tm.is_textured(a)
    n_loaded = len(a.faces)
    a, b = tm.remove_duplicate_faces(a), jm.remove_duplicate_faces(b)
    np.testing.assert_array_equal(a.faces, b.faces)
    assert len(a.faces) < n_loaded
    for seed in (0, 3):
        pa, ca = tm.sample_mesh(a, 5000, seed)
        pb, cb = jm.sample_mesh(b, 5000, seed)
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(ca, cb)
    assert len(np.unique(ca, axis=0)) > 2  # texture and Kd colours both sampled


@pytest.mark.parametrize("binary", [True, False])
def test_sample_and_voxelize_same_points(tmp_path, binary):
    path = _write_obj(str(tmp_path))
    out_t, out_j = str(tmp_path / "t" / "s.ply"), str(tmp_path / "j" / "s.ply")
    assert tm.sample_and_voxelize(path, out_t, n_points=20000, grid_resolution=64, seed=2, binary=binary)
    assert jm.sample_and_voxelize(path, out_j, n_points=20000, grid_resolution=64, seed=2, binary=binary)
    assert open(out_t, "rb").read() == open(out_j, "rb").read()
    pts, cols = tply.load_ply(out_t)
    assert 500 < len(pts) < 20000 and cols.shape == pts.shape


def test_batch_sample_shapenet_same_outputs(tmp_path):
    for side in ("t", "j"):
        for synset, model, textured in (("02958343", "a", True), ("02958343", "b", False), ("03001627", "c", True)):
            d = tmp_path / side / synset / model / "models"
            d.mkdir(parents=True)
            _write_obj(str(d), textured=textured)
    got = tm.batch_sample_shapenet(str(tmp_path / "t"), ["02958343", "03001627", "0"], n_points=3000,
                                   grid_resolution=32, workers=2)
    want = jm.batch_sample_shapenet(str(tmp_path / "j"), ["02958343", "03001627", "0"], n_points=3000,
                                    grid_resolution=32, workers=2)
    assert [os.path.relpath(p, tmp_path / "t") for p in got] == [os.path.relpath(p, tmp_path / "j") for p in want]
    assert len(got) == 2  # the untextured model is skipped
    for a, b in zip(got, want):
        assert open(a, "rb").read() == open(b, "rb").read()


@pytest.fixture
def native_lib(tmp_path, monkeypatch):
    """The native runtime: ``csrc/libprv_runtime.so`` where it is built,
    else a private build of ``csrc/prv_runtime.cpp``; skipped without a
    C++ compiler."""
    path = os.path.join(CSRC, "libprv_runtime.so")
    if not os.path.exists(path):
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            pytest.skip("csrc/libprv_runtime.so is not built and no C++ compiler is here")
        path = str(tmp_path / "libprv_runtime.so")
        subprocess.run([cxx, "-O2", "-fPIC", "-std=c++17", "-shared", "-o", path,
                        os.path.join(CSRC, "prv_runtime.cpp")], check=True, capture_output=True)
    monkeypatch.setattr(native, "_lib_path", lambda: path)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    assert native.available()
    return native


@pytest.mark.parametrize("writer", ["binary", "ascii"])
def test_native_load_ply_matches_python(tmp_path, native_lib, writer):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.1, 0.1, size=(3000, 3))
    cols = rng.integers(0, 255, size=(3000, 3), dtype=np.uint8)
    p = str(tmp_path / "c.ply")
    (tply.save_ply_binary if writer == "binary" else tply.save_ply_ascii)(p, pts, cols)
    got = native_lib.load_ply(p)
    want = tply._load_ply_py(p)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    via = tply.load_ply(p)  # the native path, taken because the library loads
    np.testing.assert_array_equal(via[0], want[0])
    keep = native_lib.voxel_first_win(pts, 0.01)
    assert len(keep) == len(tm.voxel_downsample(pts, None, 0.01)[0])
