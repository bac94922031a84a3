"""The scenes of the NeRF quality studies, and the benchmark's scene.

The port's copies of the writers that ``experiments/``'s quality scripts
share:
- ``write_scene``: ``tests/synthetic.py:33-71`` (a coloured blob of
  ``make_object`` points splatted from a hemisphere of views).  The quality
  studies' "splat" scene calls it at 24 train + 8 test views, point size 2
  and 60,000 points (``exp_quality.py:31-35``); ``bench.py:104-107``'s scene
  at ``CameraConfig()``, 16 + 8 views, point size 3 and 120,000 points.
- ``make_thin_object`` and ``write_thin_scene``: ``exp_thin_geometry.py:22-50``
  and ``exp_hashgrid_r3.py:52-74`` (blob, three rods and a disk one or two
  voxels thick at G40, splatted at point size 2).  ``exp_thin_geometry.py:67-87``
  and ``exp_train16.py:58-75`` write the same scene; with ``seed=1`` it is
  ``exp_share_march.py:94-114``'s, which ``exp_train24.py:42`` reads (that
  script wrote absolute frame paths into its JSONs; these are relative).

The views are the JAX package's ``generate_hemisphere`` output, shipped as
``.npy`` files under ``viewspace/quality/`` with every bit (the port's
generator draws other start points, and a rounded pose can move a splat
across a pixel edge).  The frames of each view set are splatted in one K8
launch (``render_pointcloud_views``, u8 RGBA), whose bytes equal the
reference's per-frame ``render_pointcloud`` + ``rgba_from_render``; the PNGs
and both JSONs equal the JAX writer's byte for byte
(``tests/test_torch_quality_scenes.py``, the digests in
``results/quality_scenes_cpu.json``).
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
from PIL import Image

from ..core.config import CameraConfig
from ..core.pose import camera_to_world
from ..core.transforms import add_frame, make_root, write_transforms
from ..scene.render import render_pointcloud_views
from .runs import RESULTS_DIR
from .toy import make_object

VIEWS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "viewspace", "quality")
DIGESTS = os.path.join(RESULTS_DIR, "quality_scenes_cpu.json")
# (count, seed) of every generate_hemisphere(count, seed=seed, restarts=2, steps=200) call the writers make
HEMISPHERES = ((24, 1), (16, 1), (11, 2))

QUALITY_CAMERA = CameraConfig(width=320, height=180, fx=228.9, fy=228.3, ppx=161.8, ppy=93.1, model=0)
# name -> (writer, keywords); "splat" and "thin" are the studies' two scenes, "thin_s1" exp_train24's thin
# scene, "bench" bench.py's
SCENES = {
    "splat": ("splat", dict(n_train=24, n_test=8, camera=QUALITY_CAMERA, point_size=2, n_points=60000)),
    "thin": ("thin", dict(camera=QUALITY_CAMERA, seed=0)),
    "thin_s1": ("thin", dict(camera=QUALITY_CAMERA, seed=1)),
    "bench": ("splat", dict(n_train=16, n_test=8, camera=CameraConfig(), point_size=3, n_points=120000)),
}


def hemisphere_path(n: int, seed: int) -> str:
    return os.path.join(VIEWS_DIR, f"hemisphere_{n}_seed{seed}.npy")


def hemisphere(n: int, seed: int) -> np.ndarray:
    """The JAX package's ``generate_hemisphere(n, seed=seed, restarts=2,
    steps=200)``: (n, 3) float64 unit views, as shipped."""
    path = hemisphere_path(n, seed)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no shipped view set for {n} views at seed {seed} (shipped: {HEMISPHERES}); "
                                "tests/jax_reference_runs.py quality-scenes writes them")
    return np.load(path)


def make_thin_object(n: int = 60000, seed: int = 0, size: float = 0.05):
    """Blob + 3 thin rods + a thin disk, all ~1-2 voxels thick at G40:
    (n, 3) float64 points and (n, 3) uint8 colours."""
    rng = np.random.default_rng(seed)
    parts = []
    # small central blob
    b = rng.normal(size=(n // 4, 3))
    b = b / np.linalg.norm(b, axis=1, keepdims=True) * size * 0.35
    parts.append(b)
    # three axis rods, radius ~ size/40 (~1 cell at G40)
    for axis in range(3):
        t = rng.uniform(-1, 1, n // 4)
        r = rng.normal(size=(n // 4, 2)) * size / 40
        rod = np.zeros((n // 4, 3))
        rod[:, axis] = t * size
        others = [a for a in range(3) if a != axis]
        rod[:, others[0]] = r[:, 0]
        rod[:, others[1]] = r[:, 1]
        parts.append(rod)
    # thin disk in the xy plane
    ang = rng.uniform(0, 2 * np.pi, n // 4)
    rad = np.sqrt(rng.uniform(0.25, 1.0, n // 4)) * size * 0.9
    disk = np.stack([rad * np.cos(ang), rad * np.sin(ang), rng.normal(size=n // 4) * size / 50], axis=-1)
    parts.append(disk)
    pts = np.concatenate(parts)
    cols = np.clip(((pts / size) * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)
    return pts, cols


def view_sets(n_train: int, n_test: int) -> tuple:
    """(("train", views), ("test", views)) as the writers draw them."""
    return (("train", hemisphere(n_train, 1)), ("test", hemisphere(n_test + 3, 2)[3:]))


def poses(views: np.ndarray, center: np.ndarray, radius: float) -> np.ndarray:
    """(F, 4, 4) camera-to-world poses, one ``camera_to_world`` a view as the
    reference writes them."""
    return np.stack([camera_to_world((v / np.linalg.norm(v) * radius + center)[None], center)[0] for v in views])


def _write(out_dir: str, pts, cols, sets, camera: CameraConfig, radius: float, point_size: int, device) -> tuple:
    center = pts.mean(axis=0)
    predicted_size = float(np.linalg.norm(pts - center, axis=1).max() * 17 / 16)
    os.makedirs(out_dir, exist_ok=True)
    jsons = []
    for name, views in sets:
        root = make_root(camera, 1, predicted_size, center)
        sub = os.path.join(out_dir, name)
        os.makedirs(sub, exist_ok=True)
        c2ws = poses(views, center, radius)
        rgbas = render_pointcloud_views(pts, cols, c2ws, camera, point_size=point_size, device=device,
                                        rounding="frame").cpu().numpy()
        for i in range(len(views)):
            fname = f"rgbaClip_{i}.png"
            Image.fromarray(rgbas[i], "RGBA").save(os.path.join(sub, fname))
            add_frame(root, f"{name}/{fname}", c2ws[i])
        jpath = os.path.join(out_dir, f"{name}.json")
        write_transforms(jpath, root)
        jsons.append(jpath)
    return jsons[0], jsons[1]


def write_scene(out_dir: str, n_train: int, n_test: int, camera: CameraConfig, radius: float = 0.3,
                point_size: int = 3, seed: int = 0, n_points: int = 20000, device="cuda") -> tuple:
    """Render the train and test sets of ``make_object(n_points, seed)``;
    returns (train_json, test_json, pts, cols)."""
    pts, cols = make_object(n=n_points, seed=seed)
    train, test = _write(out_dir, pts, cols, view_sets(n_train, n_test), camera, radius, point_size, device)
    return train, test, pts, cols


def write_thin_scene(out_dir: str, camera: CameraConfig, seed: int = 0, device="cuda") -> tuple:
    """The thin-geometry scene of ``make_thin_object(seed=seed)``: 24 train
    + 8 test views at point size 2; returns (train_json, test_json)."""
    pts, cols = make_thin_object(seed=seed)
    return _write(out_dir, pts, cols, view_sets(24, 8), camera, 0.3, 2, device)


def complete(d: str) -> bool:
    """Both JSONs and each set's first frame are there (a stale directory
    can hold the JSON but not the images)."""
    return all(os.path.exists(os.path.join(d, p))
               for p in ("train.json", "test.json", "train/rgbaClip_0.png", "test/rgbaClip_0.png"))


def write_named(name: str, out_dir: str, device="cuda", camera: CameraConfig = None) -> tuple:
    """The scene ``name`` of :data:`SCENES` (at ``camera`` where given) under
    ``out_dir``, written where it is not complete; returns (train_json,
    test_json)."""
    writer, kw = SCENES[name]
    if not complete(out_dir):
        kw = kw if camera is None else dict(kw, camera=camera)
        (write_scene if writer == "splat" else write_thin_scene)(out_dir, device=device, **kw)
    return os.path.join(out_dir, "train.json"), os.path.join(out_dir, "test.json")


def make_scenes(camera: CameraConfig, root: str, device="cuda") -> dict:
    """``exp_hashgrid_r3.make_scenes``: the splat and thin scenes at
    ``camera`` under ``root``, each written where it is not complete;
    ``{"splat": (train, test), "thin": (train, test)}``."""
    return {name: write_named(name, os.path.join(root, name), device, camera) for name in ("splat", "thin")}


def scene_files(out_dir: str) -> list:
    """The scene's JSONs and PNGs, relative to ``out_dir``, sorted."""
    files = []
    for name in ("train", "test"):
        files.append(f"{name}.json")
        sub = os.path.join(out_dir, name)
        files += sorted((f"{name}/{f}" for f in os.listdir(sub) if f.endswith(".png")),
                        key=lambda p: int(p.rsplit("_", 1)[1][:-4]))
    return files


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def pixels_sha256(path: str) -> str:
    """sha256 of a PNG's decoded RGBA bytes (with its shape): the frame
    itself, whatever zlib the encoder used."""
    a = np.asarray(Image.open(path).convert("RGBA"))
    return hashlib.sha256(repr(a.shape).encode() + a.tobytes()).hexdigest()


def scene_digests(out_dir: str) -> dict:
    """{"files": {relative path: sha256 of its bytes}, "pixels": {PNG:
    sha256 of its decoded RGBA}} of every file of a written scene."""
    files = scene_files(out_dir)
    return dict(files={f: sha256(os.path.join(out_dir, f)) for f in files},
                pixels={f: pixels_sha256(os.path.join(out_dir, f)) for f in files if f.endswith(".png")})


def committed_digests() -> dict:
    """{scene name: digests} the JAX writer's scenes gave on the CPU."""
    with open(DIGESTS) as f:
        return json.load(f)["scenes"]


def compare_digests(got: dict, want: dict) -> dict:
    """Which files differ: ``bytes`` lists every file whose bytes differ,
    ``pixels`` every PNG whose decoded frame differs (a PNG can differ in
    its bytes alone where another zlib encoded it), ``missing`` the files
    on one side only."""
    files = set(got["files"]) | set(want["files"])
    return dict(
        n_files=len(want["files"]),
        missing=sorted(set(got["files"]) ^ set(want["files"])),
        bytes=sorted(f for f in files if got["files"].get(f) != want["files"].get(f)),
        pixels=sorted(f for f in want["pixels"] if got["pixels"].get(f) != want["pixels"][f]),
    )
