"""Coverage image generation and dataset-prep pipeline stages.

Modes 2/3/10/11 of the reference's dispatcher:
- :func:`get_coverage`        — render a whole view space + transforms.json
                                (≙ ``get_coverage``, main.cpp:1581-1656)
- :func:`get_size_test`       — size augmentation only (mode 2, main.cpp:2329)
- :func:`generate_novel_sets` — novel train/test renders (mode 1,
                                main.cpp:1415-1579)
- :func:`shapenet_preprocess` — sampled-PLY rewrite + names list (mode 10,
                                main.cpp:3466-3562)
- :func:`get_clean_data`      — size-window filter + batch sharding (mode 11,
                                main.cpp:3563-3621)

The port of ``nerf_prv_tpu/pipeline/coverage.py``: the same files (PNGs,
jsons, size and name lists) for the same inputs, the renders through the
K8 kernel on ``device`` (one launch per view set), the PNGs encoded on the
host.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
from PIL import Image

from ..core.config import Config
from ..core.pose import camera_to_world
from ..core.transforms import add_frame, make_root, write_transforms
from ..scene.object_setup import ObjectScene, load_object, _ensure_viewspace
from ..scene.ply import load_ply, save_ply_ascii
from ..scene.render import (
    render_pointcloud,
    render_pointcloud_views,
    rgba_from_render,
)
from ..viewspace.hemisphere import ViewSpace

# ShapeNet synset id -> readable class name (≙ main.cpp:3467-3487)
ID2NAME = {
    "04379243": "table",
    "02958343": "car",
    "03001627": "chair",
    "02691156": "airplane",
    "04256520": "sofa",
    "04090263": "rifle",
    "03636649": "lamp",
    "04530566": "watercraft",
    "02828884": "bench",
    "03691459": "loudspeaker",
    "02933112": "cabinet",
    "03211117": "display",
    "04401088": "telephone",
    "02924116": "bus",
    "02808440": "bathtub",
    "03467517": "guitar",
    "03325088": "faucet",
    "03046257": "clock",
    "03991062": "flowerpot",
    "03593526": "jar",
}


def render_view_to_png(scene: ObjectScene, view_pos, cfg: Config, out_path: str, camera=None,
                       device="cuda"):
    camera = camera or cfg.camera
    c2w = camera_to_world(np.asarray(view_pos)[None], scene.object_center)[0]
    rgb, alpha = render_pointcloud(
        scene.points, scene.colors, c2w, camera, point_size=cfg.points_size_cloud, device=device
    )
    rgba = rgba_from_render(rgb, alpha)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    Image.fromarray(rgba, "RGBA").save(out_path)
    return c2w


def get_coverage(
    scene: ObjectScene,
    cfg: Config,
    n_views: int,
    gt_path: Optional[str] = None,
    file_prefix: Optional[str] = None,
    device="cuda",
) -> str:
    """Render the n-view coverage set + ``<n>.json`` (≙ main.cpp:1581-1656).

    Idempotent on the json file like the reference's mode-3 guard
    (main.cpp:2351-2352).  Returns the json path.
    """
    gt_path = gt_path or cfg.gt_path
    json_path = os.path.join(gt_path, f"{n_views}.json")
    if os.path.exists(json_path):
        return json_path
    unit_views = _ensure_viewspace(cfg.viewspace_path, n_views, device)
    vs = ViewSpace(unit_views, scene.points, cfg.view_space_radius)
    root = make_root(
        cfg.camera, cfg.ray_casting_aabb_scale, vs.predicted_size, vs.object_center
    )
    sub = os.path.join(gt_path, str(n_views))
    rel = file_prefix if file_prefix is not None else str(n_views)
    c2ws = camera_to_world(np.asarray(vs.views), scene.object_center)
    rgbas = render_pointcloud_views(
        scene.points, scene.colors, c2ws, cfg.camera,
        point_size=cfg.points_size_cloud, device=device,
    ).cpu().numpy()
    os.makedirs(sub, exist_ok=True)
    for i in range(len(vs.views)):
        Image.fromarray(rgbas[i], "RGBA").save(
            os.path.join(sub, f"rgbaClip_{i}.png")
        )
        add_frame(root, f"{rel}/rgbaClip_{i}.png", c2ws[i])
    write_transforms(json_path, root)
    return json_path


def get_size_test(cfg: Config, names: Sequence[str], device="cuda") -> List[str]:
    """Mode 2: run the size augmentation for each object lacking size.txt;
    returns the accepted names (≙ main.cpp:2329-2342)."""
    ok = []
    for name in names:
        obj_cfg = cfg.replace(name_of_pcd=name)
        scene = load_object(obj_cfg, name, build_scene=False, device=device)
        if scene.ok:
            ok.append(name)
    return ok


def generate_novel_sets(scene: ObjectScene, cfg: Config, device="cuda") -> List[str]:
    """Mode 1 rendering stage: novel train/test views -> PNGs + jsons
    (≙ get_train_test_novel, main.cpp:1415-1579)."""
    from ..viewspace.novel import get_or_create_novel_views

    train_views, test_views = get_or_create_novel_views(
        cfg.workspace, cfg.viewspace_path, cfg.num_of_novel_test_views, cfg.seed, device=device
    )
    jsons = []
    for name, views in (("novel_train", train_views), ("novel_test", test_views)):
        root = make_root(
            cfg.camera,
            cfg.ray_casting_aabb_scale,
            scene.predicted_size,
            scene.object_center,
        )
        sub = os.path.join(cfg.gt_path, name)
        pos = (
            views / np.linalg.norm(views, axis=1, keepdims=True)
        ) * cfg.view_space_radius + scene.object_center
        c2ws = camera_to_world(pos, scene.object_center)
        rgbas = render_pointcloud_views(
            scene.points, scene.colors, c2ws, cfg.camera,
            point_size=cfg.points_size_cloud, device=device,
        ).cpu().numpy()
        os.makedirs(sub, exist_ok=True)
        for i in range(len(views)):
            Image.fromarray(rgbas[i], "RGBA").save(
                os.path.join(sub, f"rgbaClip_{i}.png")
            )
            add_frame(root, f"{name}/rgbaClip_{i}.png", c2ws[i])
        json_path = os.path.join(cfg.gt_path, f"{name}_views.json")
        write_transforms(json_path, root)
        jsons.append(json_path)
    return jsons


def shapenet_preprocess(cfg: Config, synset_ids: Sequence[str]) -> List[str]:
    """Mode 10: walk ShapeNetCore.v2, rewrite each sampled cloud as an ascii
    XYZRGB PLY named ``<class><idx>.ply`` (white 255 clamped to 250,
    ≙ main.cpp:3536-3543); returns and writes the names list."""
    out_dir = os.path.join(cfg.model_path, "ShapeNet")
    os.makedirs(out_dir, exist_ok=True)
    names = []
    for synset in synset_ids:
        cls = ID2NAME.get(synset, synset)
        count = 0
        synset_dir = os.path.join(cfg.shape_net, synset)
        if not os.path.isdir(synset_dir):
            continue
        for model_id in sorted(os.listdir(synset_dir)):
            sample = os.path.join(
                synset_dir, model_id, "models", "model_normalized_sample.ply"
            )
            if not os.path.exists(sample):
                sample = os.path.join(synset_dir, model_id, "model_normalized_sample.ply")
                if not os.path.exists(sample):
                    continue
            out_name = f"{cls}{count}"
            out_path = os.path.join(out_dir, out_name + ".ply")
            if not os.path.exists(out_path):
                pts, cols = load_ply(sample)
                if cols is None:
                    cols = np.full((len(pts), 3), 250, np.uint8)
                white = (cols == 255).all(axis=1)
                cols = cols.copy()
                cols[white] = 250
                save_ply_ascii(out_path, pts, cols)
            names.append(out_name)
            count += 1
    with open(os.path.join(cfg.model_path, "ShapeNet_names.txt"), "w") as f:
        f.write("\n".join(names) + ("\n" if names else ""))
    return names


def get_clean_data(cfg: Config, names: Sequence[str], batch_size: int = 3000) -> List[str]:
    """Mode 11: keep objects with accepted size in (0.070, 0.120) m, write
    clean_names.txt and shard size.txt into batch dirs (≙ main.cpp:3563-3621)."""
    clean = []
    for name in names:
        obj_cfg = cfg.replace(name_of_pcd=name)
        size_file = os.path.join(obj_cfg.gt_path, "size.txt")
        if not os.path.exists(size_file):
            continue
        size = float(open(size_file).read().strip())
        if cfg.clean_size_min < size < cfg.clean_size_max:
            batch = len(clean) // batch_size
            batch_dir = os.path.join(
                cfg.workspace, "Coverage_images", f"ShapeNet_{batch}", name
            )
            os.makedirs(batch_dir, exist_ok=True)
            with open(os.path.join(batch_dir, "size.txt"), "w") as f:
                f.write(str(size))
            clean.append(name)
    with open(os.path.join(cfg.model_path, "clean_names.txt"), "w") as f:
        f.write("\n".join(clean) + ("\n" if clean else ""))
    return clean
