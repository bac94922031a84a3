"""Two textured meshes through the production label protocol on the port.

Counterpart of ``experiments/exp_real_object.py``: a textured OBJ (+ MTL +
PNG texture) goes through L0's ``sample_and_voxelize(require_texture=True)``
(300,000 points, a 512³ thinning grid), mode 0's view spaces, mode 3's
coverage sets at the 1280x720 inverse-Brown-Conrady camera (model 2), mode 4's
2,500-step voxel fields scored on the 100-view set (the 100-view anchor
first), the lognormal fit and the gradient@0.02 label (≙ NeRF_fit_curve.cpp,
main.cpp:2641-2645).  The two meshes are the reference's: a torus (a hole,
self-occlusion) and a trefoil-knot tube (crossing strands).

    python -m nerf_prv_tpu_torch.experiments.real_object --object torus
    python -m nerf_prv_tpu_torch.experiments.real_object --object knot --step 6 --max 45

The reference's ``PRV_REAL_STEP``, ``PRV_REAL_MAX`` and ``PRV_REAL_COUNTS``
are the arguments ``step``, ``cmax`` and ``counts``.  A pinned count that is
neither on the ``step``/``cmax`` grid nor already scored on disk is refused
before any training (the reference reads its missing ``<v>.txt`` after the
sweep and fails there).

View spaces: mode 0's files of the production grid (3, 5, ..., 49 and 100)
ship with this package, written by the JAX package's ``generate_hemisphere(n,
seed=n)`` on the CPU (:func:`install_production_viewspace`).  The committed
runs generated theirs on a TPU, whose float32 descent lands about 5e-6
(relative) away from the CPU's.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..core.config import Config
from ..labeling.labels import fit_object_from_metrics
from ..nerf.model import NerfConfig
from ..pipeline import modes
from .label_protocol import (
    LABEL_INDEX, VIEWSPACE_DIR, _instant_ngp_seeded, fit_counts, require_device, seed_workspace,
)

KINDS = ("torus", "knot")
N_POINTS = 300_000
GRID_RESOLUTION = 512
N_STEPS = 2500
# the committed runs' grids (step, max): the torus at the script's defaults, the
# knot's run with PRV_REAL_STEP=6 PRV_REAL_MAX=45 (its artifact's view_counts)
SWEEPS = {"torus": (2, 50), "knot": (6, 45)}
# mode 0's files of the production grid that the 320x180 protocol's do not cover
PRODUCTION_DIR = os.path.join(VIEWSPACE_DIR, "production")
ARTIFACTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                         "experiments", "artifacts")


def write_textured_torus(root: str, R: float = 0.35, r: float = 0.16,
                         nu: int = 64, nv: int = 32) -> str:
    """Torus OBJ with UVs, MTL, and a structured color texture."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    tex = np.zeros((256, 256, 3), np.uint8)
    # color bands around the tube + checker overlay: gives the sampled
    # cloud real texture-derived color variation to reconstruct
    yy, xx = np.mgrid[0:256, 0:256]
    tex[..., 0] = (127 + 120 * np.sin(2 * np.pi * xx / 256)).astype(np.uint8)
    tex[..., 1] = (127 + 120 * np.sin(4 * np.pi * yy / 256 + 1)).astype(np.uint8)
    tex[..., 2] = ((xx // 32 + yy // 32) % 2) * 180 + 40
    Image.fromarray(tex).save(os.path.join(root, "tex.png"))
    with open(os.path.join(root, "model.mtl"), "w") as f:
        f.write("newmtl torus\nKd 1 1 1\nmap_Kd tex.png\n")

    verts, uvs, faces = [], [], []
    for i in range(nu):
        for j in range(nv):
            u = 2 * np.pi * i / nu
            v = 2 * np.pi * j / nv
            x = (R + r * np.cos(v)) * np.cos(u)
            y = (R + r * np.cos(v)) * np.sin(u)
            z = r * np.sin(v)
            verts.append((x, y, z))
            uvs.append((i / nu, j / nv))
    for i in range(nu):
        for j in range(nv):
            a = i * nv + j
            b = ((i + 1) % nu) * nv + j
            c = ((i + 1) % nu) * nv + (j + 1) % nv
            d = i * nv + (j + 1) % nv
            faces.append((a, b, c))
            faces.append((a, c, d))
    path = os.path.join(root, "model.obj")
    with open(path, "w") as f:
        f.write("mtllib model.mtl\n")
        for x, y, z in verts:
            f.write(f"v {x:.6f} {y:.6f} {z:.6f}\n")
        for u, v in uvs:
            f.write(f"vt {u:.6f} {v:.6f}\n")
        f.write("usemtl torus\n")
        for a, b, c in faces:
            f.write(f"f {a+1}/{a+1} {b+1}/{b+1} {c+1}/{c+1}\n")
    return path


def write_textured_knot(root: str, scale: float = 0.16, r: float = 0.07,
                        nu: int = 256, nv: int = 24) -> str:
    """Trefoil-knot tube OBJ with UVs, MTL and texture: knot topology,
    strong self-occlusion between crossing strands, higher curvature
    variation than the torus."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    tex = np.zeros((256, 256, 3), np.uint8)
    yy, xx = np.mgrid[0:256, 0:256]
    tex[..., 0] = (127 + 120 * np.cos(6 * np.pi * xx / 256)).astype(np.uint8)
    tex[..., 1] = ((xx // 16 + yy // 16) % 2) * 160 + 60
    tex[..., 2] = (127 + 120 * np.sin(2 * np.pi * yy / 256 + 0.7)).astype(np.uint8)
    Image.fromarray(tex).save(os.path.join(root, "tex.png"))
    with open(os.path.join(root, "model.mtl"), "w") as f:
        f.write("newmtl knot\nKd 1 1 1\nmap_Kd tex.png\n")

    ref = np.array([0.13, 0.27, 0.95])
    ref /= np.linalg.norm(ref)
    verts, uvs, faces = [], [], []
    for i in range(nu):
        t = 2 * np.pi * i / nu
        c = scale * np.array([
            np.sin(t) + 2 * np.sin(2 * t),
            np.cos(t) - 2 * np.cos(2 * t),
            -np.sin(3 * t),
        ])
        tang = np.array([
            np.cos(t) + 4 * np.cos(2 * t),
            -np.sin(t) + 4 * np.sin(2 * t),
            -3 * np.cos(3 * t),
        ])
        tang /= np.linalg.norm(tang)
        n0 = np.cross(tang, ref)
        n0 /= np.linalg.norm(n0)
        b0 = np.cross(tang, n0)
        for j in range(nv):
            v = 2 * np.pi * j / nv
            pxyz = c + r * (np.cos(v) * n0 + np.sin(v) * b0)
            verts.append(tuple(pxyz))
            uvs.append((i / nu, j / nv))
    for i in range(nu):
        for j in range(nv):
            a = i * nv + j
            b = ((i + 1) % nu) * nv + j
            cc = ((i + 1) % nu) * nv + (j + 1) % nv
            d = i * nv + (j + 1) % nv
            faces.append((a, b, cc))
            faces.append((a, cc, d))
    path = os.path.join(root, "model.obj")
    with open(path, "w") as f:
        f.write("mtllib model.mtl\n")
        for x, y, z in verts:
            f.write(f"v {x:.6f} {y:.6f} {z:.6f}\n")
        for u, v in uvs:
            f.write(f"vt {u:.6f} {v:.6f}\n")
        f.write("usemtl knot\n")
        for a, b, c in faces:
            f.write(f"f {a+1}/{a+1} {b+1}/{b+1} {c+1}/{c+1}\n")
    return path


WRITERS = {"torus": write_textured_torus, "knot": write_textured_knot}


def object_name(kind: str) -> str:
    return f"{kind}0"


def artifact_name(kind: str) -> str:
    """The committed artifact's file name (≙ exp_real_object.py:237-239)."""
    return "real_object_calibration.json" if kind == "torus" else f"real_object_calibration_{kind}.json"


def committed(kind: str, art: str = ARTIFACTS) -> dict:
    """The JAX package's committed run of ``kind``."""
    with open(os.path.join(art, artifact_name(kind))) as f:
        return json.load(f)


def real_object_config(kind: str, root: str, step: int = 2, cmax: int = 50) -> Config:
    """The run's configuration under ``root`` (≙ exp_real_object.py:184-192):
    the default 1280x720 model-2 camera, 2,500 NeRF steps, the sweep
    3..``cmax`` step ``step`` (+ 100 for the maximum)."""
    return Config(
        workspace=os.path.join(root, "ws"),
        model_path=os.path.join(root, "models"),
        viewspace_path=os.path.join(root, "ws", "viewspace"),
        name_of_pcd=object_name(kind),
        coverage_view_num_max=cmax,
        coverage_view_num_add=step,
        n_steps=N_STEPS,
    )


def install_production_viewspace(cfg: Config, sizes: Sequence[int]) -> None:
    """Copy mode 0's shipped file of each size in ``sizes`` into
    ``cfg.viewspace_path`` where missing (``VIEWSPACE_DIR``, else
    ``PRODUCTION_DIR``); a size with neither is left to mode 0.  Where 5 is
    not among ``sizes``, the size test's 5-view file goes in as the
    reference's ``load_object`` writes it (seed 0).  The files are the
    reference's at ``cfg.seed == 0`` only."""
    if cfg.seed != 0:
        raise ValueError(f"the shipped view spaces are the reference's at seed 0, not {cfg.seed}")
    os.makedirs(cfg.viewspace_path, exist_ok=True)
    files = []
    for n in sizes:
        for d in (VIEWSPACE_DIR, PRODUCTION_DIR):
            if os.path.exists(os.path.join(d, f"{n}.txt")):
                files.append((os.path.join(d, f"{n}.txt"), f"{n}.txt"))
                break
    if 5 not in sizes:
        files.append((os.path.join(VIEWSPACE_DIR, "probe", "5.txt"), "5.txt"))
    for src, name in files:
        dst = os.path.join(cfg.viewspace_path, name)
        if not os.path.exists(dst):
            shutil.copyfile(src, dst)


def check_pinned(cfg: Config, counts: Sequence[int], seed: int = 0) -> None:
    """Refuse a pinned count that the sweep will not train and that has no
    ``<v>.txt`` on disk yet: the fit would miss it after every training."""
    gt = seed_workspace(cfg, seed).gt_path
    grid = set(fit_counts(cfg))
    missing = [v for v in counts if v not in grid and not os.path.exists(os.path.join(gt, f"{v}.txt"))]
    if missing:
        raise ValueError(f"pinned view counts {missing} are not on the sweep {sorted(grid)} and have no "
                         f"metrics file under {gt}: nothing would score them")


def sample_object(kind: str, root: str) -> str:
    """The mesh written under ``<root>/mesh`` and sampled (``N_POINTS``
    points thinned on a ``GRID_RESOLUTION``³ grid) into the model folder's
    ``<name>.ply``, kept where it exists."""
    from ..scene.mesh_sampling import sample_and_voxelize

    obj = WRITERS[kind](os.path.join(root, "mesh"))
    ply = os.path.join(root, "models", "ShapeNet", f"{object_name(kind)}.ply")
    if not os.path.exists(ply):
        if not sample_and_voxelize(obj, ply, n_points=N_POINTS, grid_resolution=GRID_RESOLUTION,
                                   require_texture=True):
            raise RuntimeError(f"{obj} did not sample: no faces or no texture")
    return ply


def prepare(kind: str, root: str, cfg: Config, counts: Sequence[int], device) -> None:
    """Stages that every NeRF seed shares: the mesh and its PLY, mode 0's
    view spaces of the sweep and of ``counts`` (the shipped files first)."""
    sample_object(kind, root)
    sizes = sorted(set(fit_counts(cfg)) | set(counts)) + [100]
    install_production_viewspace(cfg, sizes)
    modes.mode_view_cover(cfg, sizes=sizes, device=device)


def shape_flags(curve: np.ndarray) -> Tuple[bool, bool]:
    """(monotone, diminishing returns) of the fitted curve as the reference
    judges them (≙ exp_real_object.py:212-218)."""
    d = np.diff(curve)
    # tolerance: the fitted CDF is mathematically increasing but its f32
    # evaluation jitters ~1e-5 on the saturated tail
    monotone = bool((d > -1e-3).all())
    # tail gradient far below head gradient = saturating curve
    diminishing = bool(d[-10:].mean() < 0.25 * max(d[:10].mean(), 1e-9))
    return monotone, diminishing


def fit_artifact(gt_path: str, counts: Sequence[int], device) -> dict:
    """The lognormal fit of ``gt_path``'s metric files (``label.txt``
    written) and the committed artifact's keys (≙ exp_real_object.py:200-230)."""
    from ..nerf.api import load_metrics

    counts = list(counts)
    result = fit_object_from_metrics(gt_path, view_counts=counts, label_path=os.path.join(gt_path, "label.txt"),
                                     device=device)
    curve = np.asarray(result.curve)
    psnrs = [load_metrics(os.path.join(gt_path, f"{v}.txt"))["PSNR"] for v in counts]
    max_psnr = load_metrics(os.path.join(gt_path, "100.txt"))["PSNR"]
    label = int(result.gradient_labels[LABEL_INDEX])  # ΔPSNR <= 0.02/view (main.cpp:2641)
    monotone, diminishing = shape_flags(curve)
    return {
        "converged": bool(result.converged),
        "view_counts": counts,
        "measured_psnr": [round(float(p), 3) for p in psnrs],
        "max_psnr_100": round(float(max_psnr), 3),
        "fitted_curve_3_100": [round(float(c), 3) for c in curve],
        "gradient_label_0.02": label,
        "label_in_clip_window": 13 <= label <= 58,
        "curve_monotone": monotone,
        "curve_diminishing_returns": diminishing,
    }


def run_real_object(kind: str, root: str, counts: Optional[Sequence[int]] = None, step: int = 2, cmax: int = 50,
                    seed: int = 0, device="cuda", nerf_cfg: NerfConfig = None) -> Tuple[dict, Dict[str, float]]:
    """``kind``'s mesh from OBJ to label under ``root`` (≙
    exp_real_object.py:140-251): L0 sampling, mode 0, mode 3, the 100-view
    anchor, the mode-4 sweep over 3..``cmax`` step ``step``, the fit on
    ``counts`` (default the sweep).  ``seed`` is the NeRF seed; a seed other
    than 0 trains in a workspace of its own (``seed_workspace``), on the
    same view spaces.  Every stage skips what its files say is done.
    Returns (the artifact, with the committed run's keys; each stage's wall)."""
    device = require_device(device)
    cfg = real_object_config(kind, root, step, cmax)
    counts = sorted(set(counts)) if counts else fit_counts(cfg)
    check_pinned(cfg, counts, seed)
    name = object_name(kind)
    walls = {}
    t = time.perf_counter()
    prepare(kind, root, cfg, counts, device)
    walls["sample and mode 0"] = time.perf_counter() - t
    work = seed_workspace(cfg, seed)
    nerf_cfg = nerf_cfg or NerfConfig(n_steps=cfg.n_steps)
    t = time.perf_counter()
    modes.mode_get_coverage(work, [name], device=device)
    walls["mode 3"] = time.perf_counter() - t
    # the 100-view anchor first: a sweep cut after it leaves a state that refits
    t = time.perf_counter()
    _instant_ngp_seeded(work.replace(coverage_view_num_max=2), name, nerf_cfg, seed, device)
    walls["mode 4 anchor"] = time.perf_counter() - t
    t = time.perf_counter()
    _instant_ngp_seeded(work, name, nerf_cfg, seed, device)
    walls["mode 4 sweep"] = time.perf_counter() - t
    art = fit_artifact(work.replace(name_of_pcd=name).gt_path, counts, device)
    print(f"{name} (NeRF seed {seed}): label {art['gradient_label_0.02']} converged {art['converged']}; "
          + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()), flush=True)
    return art, walls


def main(argv=None) -> int:
    from .runs import LOG_DIR, WORKSPACE, write_json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--object", default="torus", choices=KINDS)
    ap.add_argument("--step", type=int, default=2, help="the sweep's step (the reference's PRV_REAL_STEP)")
    ap.add_argument("--max", type=int, default=50, help="the sweep's largest count (PRV_REAL_MAX)")
    ap.add_argument("--counts", type=int, nargs="*", default=None, help="the counts to fit on (PRV_REAL_COUNTS)")
    ap.add_argument("--seed", type=int, default=0, help="the NeRF seed")
    ap.add_argument("--root", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = args.root or os.path.join(WORKSPACE, f"real_object_{args.object}")
    art, _ = run_real_object(args.object, root, args.counts, args.step, args.max, args.seed, args.device)
    write_json(args.out or os.path.join(LOG_DIR, artifact_name(args.object)), art)
    print(json.dumps({k: v for k, v in art.items() if k not in ("measured_psnr", "fitted_curve_3_100")}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
