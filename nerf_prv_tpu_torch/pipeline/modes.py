"""Mode dispatcher — the reference's 12-mode console loop as functions.

≙ ``main()`` (``main.cpp:2294-4007``).  Mode numbers match:

====  ==================  ==========================================
 0    ViewCover           hemisphere view-space generation
 1    ViewNovel           novel train/test view sampling + rendering
 2    GetSizeTest         ShapeNet size augmentation
 3    GetCoverage         coverage images for v=3..50 step 2 and 100
 4    InstantNGP          per-view-count NeRF train + eval
 5    ReadLabel           label statistics
 6    GetDataset          PRVNet dataset assembly
 7    TestObjects         statistics comparison
10    ShapeNetPreProcess  sampled-PLY rewrite
11    GetCleanData        size-window filter
20    GetPathPlan         TSP path precompute
21    ViewPlanning        the flagship NBV experiment
====  ==================  ==========================================

Counterpart of ``nerf_prv_tpu/pipeline/modes.py``: every mode runs through
the port's modules, and every function that reaches the card takes
``device`` (the card by default).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.config import Config
from ..nerf.model import NerfConfig

MODE_NAMES = {
    0: "ViewCover",
    1: "ViewNovel",
    2: "GetSizeTest",
    3: "GetCoverage",
    4: "InstantNGP",
    5: "ReadLabel",
    6: "GetDataset",
    7: "TestObjects",
    10: "ShapeNetPreProcess",
    11: "GetCleanData",
    20: "GetPathPlan",
    21: "ViewPlanning",
}


def mode_view_cover(cfg: Config, sizes=range(3, 101), device="cuda") -> None:
    """Mode 0 (≙ get_cover_view_cases, main.cpp:1117-1182)."""
    from ..viewspace.hemisphere import generate_all

    generate_all(cfg.viewspace_path, sizes=sizes, seed=cfg.seed, device=device)


def mode_view_novel(cfg: Config, names: Sequence[str] = (), device="cuda") -> None:
    """Mode 1 (≙ get_novel_view_cases + get_train_test_novel,
    main.cpp:1184-1579)."""
    from ..scene.object_setup import load_object
    from ..viewspace.novel import get_or_create_novel_views
    from .coverage import generate_novel_sets

    get_or_create_novel_views(
        cfg.workspace, cfg.viewspace_path, cfg.num_of_novel_test_views, cfg.seed, device=device
    )
    for name in names:
        obj_cfg = cfg.replace(name_of_pcd=name)
        scene = load_object(obj_cfg, name, device=device)
        if scene.ok:
            generate_novel_sets(scene, obj_cfg, device=device)


def mode_get_size_test(cfg: Config, names: Sequence[str], device="cuda") -> List[str]:
    from .coverage import get_size_test

    return get_size_test(cfg, names, device=device)


def _coverage_counts(cfg: Config) -> List[int]:
    counts = list(
        range(3, cfg.effective_coverage_max + 1, cfg.effective_coverage_add)
    )
    counts.append(100)
    return counts


def mode_get_coverage(cfg: Config, names: Sequence[str], device="cuda") -> None:
    """Mode 3 (≙ main.cpp:2343-2462)."""
    from ..scene.object_setup import load_object
    from .coverage import get_coverage

    for name in names:
        obj_cfg = cfg.replace(name_of_pcd=name)
        scene = load_object(obj_cfg, name, device=device)
        if not scene.ok:
            continue
        for n in _coverage_counts(obj_cfg):
            get_coverage(scene, obj_cfg, n, device=device)


def mode_instant_ngp(
    cfg: Config,
    names: Sequence[str],
    nerf_cfg: Optional[NerfConfig] = None,
    batch_size: int = 1,
    warm_start_steps: int = 0,
    mesh=None,
    device="cuda",
) -> None:
    """Mode 4 (≙ main.cpp:2463-2489): per-view-count NeRF train + eval vs the
    100-view set, writing ``<v>.txt`` metric files (idempotent).

    ``batch_size > 1`` trains that many (object, view-count) NeRFs at
    once through ``nerf/batch_train.py`` (K grids read as one table), on
    ``device`` or over ``mesh``'s devices; undersized groups are padded to
    a multiple of the mesh size and the padding is not evaluated.

    ``warm_start_steps > 0`` is an extension beyond the reference (which
    retrains every view count from scratch): each count in an object's
    ascending sweep initializes from the previous count's trained field and
    trains only that many steps (the first count, and any count whose
    predecessor was skipped by the resume guard, still trains the full
    ``n_steps`` from scratch).  It shifts the fitted label, so it is off by
    default and is not for label generation (mode 5/6 inputs).
    """
    from ..nerf.api import eval_nerf, save_metrics
    from ..scene.object_setup import load_object
    from .coverage import get_coverage

    from ..nerf.rays import load_dataset

    nerf_cfg = nerf_cfg or NerfConfig(n_steps=cfg.n_steps)
    per_object = []  # (name, [(train_json, test_json, metrics_file), ...])
    for name in names:
        obj_cfg = cfg.replace(name_of_pcd=name)
        scene = load_object(obj_cfg, name, device=device)
        if not scene.ok:
            continue
        test_json = get_coverage(scene, obj_cfg, 100, device=device)
        counts = []  # ascending: _coverage_counts order
        for n in _coverage_counts(obj_cfg):
            metrics_file = os.path.join(obj_cfg.gt_path, f"{n}.txt")
            counts.append((get_coverage(scene, obj_cfg, n, device=device), test_json, metrics_file))
        per_object.append((name, counts))

    # decode each 100-view test set once per object, not once per count
    test_cache: Dict[str, object] = {}

    def test_ds(path):
        if path not in test_cache:
            test_cache.clear()  # keep at most one object's test set in RAM
            test_cache[path] = load_dataset(path)
        return test_cache[path]

    if batch_size <= 1:
        import dataclasses

        from ..nerf.api import train_nerf

        warm_cfg = (
            dataclasses.replace(nerf_cfg, n_steps=warm_start_steps)
            if warm_start_steps > 0
            else None
        )
        for _, counts in per_object:
            prev = None
            for train_json, test_json, metrics_file in counts:
                if os.path.exists(metrics_file):
                    prev = None  # resume guard breaks the warm chain
                    continue
                if warm_cfg is not None and prev is not None:
                    params, _ = train_nerf(train_json, warm_cfg, init_from=prev, device=device)
                else:
                    params, _ = train_nerf(train_json, nerf_cfg, device=device)
                metrics = eval_nerf(params, test_ds(test_json), nerf_cfg)
                save_metrics(metrics_file, metrics)
                prev = params if warm_cfg is not None else None
        return

    jobs = [
        job
        for _, counts in per_object
        for job in counts
        if not os.path.exists(job[2])
    ]

    from ..nerf.batch_train import slice_params, train_batch

    for start in range(0, len(jobs), batch_size):
        group = jobs[start : start + batch_size]
        datasets = [load_dataset(j[0]) for j in group]
        if mesh is not None:
            # pad the object axis to a multiple of the mesh size so the
            # dp shards split evenly; padded replicas train redundantly
            # and are simply not evaluated
            m = mesh.size
            while len(datasets) % m:
                datasets.append(datasets[-1])
        params, _ = train_batch(datasets, nerf_cfg, mesh=mesh, device=device)
        for i, (_, test_json, metrics_file) in enumerate(group):
            metrics = eval_nerf(slice_params(params, i), test_ds(test_json), nerf_cfg)
            save_metrics(metrics_file, metrics)


def mode_fit_labels(cfg: Config, names: Sequence[str], device="cuda") -> None:
    """The OriginPro stage (``Fit_ShapeNet``/``Fit_HB``): batched lognormal
    fits over all objects' metric files -> per-object label.txt."""
    from ..labeling.labels import fit_object_from_metrics

    counts = [n for n in _coverage_counts(cfg) if n != 100]
    for name in names:
        obj_cfg = cfg.replace(name_of_pcd=name)
        label_path = os.path.join(obj_cfg.gt_path, "label.txt")
        if not os.path.exists(label_path):
            fit_object_from_metrics(
                obj_cfg.gt_path, counts, label_path, hb=not cfg.is_shape_net, device=device
            )


def mode_read_label(cfg: Config, names: Sequence[str]):
    """Mode 5 (≙ main.cpp:2490-2638)."""
    from ..labeling.labels import parse_label_file
    from ..labeling.stats import write_label_stats

    results = []
    for name in names:
        obj_cfg = cfg.replace(name_of_pcd=name)
        results.append(parse_label_file(os.path.join(obj_cfg.gt_path, "label.txt")))
    return write_label_stats(cfg.workspace, results)


def mode_get_dataset(cfg: Config, names: Sequence[str], split: str = "reference"):
    """Mode 6 (≙ main.cpp:2639-2885).  ``split``: see
    ``labeling.dataset.stratified_split`` ("holdout" keeps a real val set
    at sub-ShapeNet object counts)."""
    from ..labeling.dataset import build_dataset
    from ..labeling.labels import parse_label_file

    results = []
    for name in names:
        obj_cfg = cfg.replace(name_of_pcd=name)
        results.append(parse_label_file(os.path.join(obj_cfg.gt_path, "label.txt")))
    coverage_root = os.path.dirname(cfg.replace(name_of_pcd="x").gt_path)
    return build_dataset(
        cfg.workspace, names, results, coverage_root=coverage_root, seed=cfg.seed,
        split=split,
    )


def mode_test_objects(
    cfg: Config,
    names: Sequence[str],
    labels: Dict[str, int],
    predictor=None,
    nerf_cfg: Optional[NerfConfig] = None,
    stat_budgets: Optional[Dict[str, int]] = None,
    predictions: Optional[Dict[str, int]] = None,
    device="cuda",
):
    """Mode 7 (≙ main.cpp:2886-3465).  ``stat_budgets`` overrides the
    reference's hard-coded 32/34/35 baselines — pass
    ``compare.stat_budgets_from_labels(val_labels)`` to derive them from
    the dataset in use (≙ how the reference's constants were obtained).
    ``predictions`` pins the PRV budgets to precomputed values (see
    ``compare.compare_objects``)."""
    from .compare import compare_objects

    return compare_objects(cfg, names, labels, predictor=predictor,
                           nerf_cfg=nerf_cfg, stat_budgets=stat_budgets,
                           predictions=predictions, device=device)


def mode_shapenet_preprocess(cfg: Config, synset_ids: Sequence[str]):
    from .coverage import shapenet_preprocess

    return shapenet_preprocess(cfg, synset_ids)


def mode_get_clean_data(cfg: Config, names: Sequence[str]):
    from .coverage import get_clean_data

    return get_clean_data(cfg, names)


def mode_get_path_plan(cfg: Config, sizes=range(3, 101), device="cuda") -> None:
    """Mode 20 (≙ main.cpp:3622-3833)."""
    from ..planning.tsp import precompute_paths

    precompute_paths(cfg.viewspace_path, sizes=sizes, device=device)


def mode_view_planning(
    cfg: Config,
    names: Sequence[str],
    method_ids: Sequence[int] = (4, 0, 1, 2, 3),
    init_view_cases: Sequence[Sequence[int]] = ((0, 1, 3),),
    num_random_tests: int = 1,
    nerf_cfg: Optional[NerfConfig] = None,
    predictor=None,
    coverage_sizes: Optional[Sequence[int]] = None,
    device="cuda",
) -> List[str]:
    """Mode 21 — the flagship experiment (≙ main.cpp:3834-4004).

    ``coverage_sizes``: view-space sizes to pre-render (default: the
    reference's full space + 5..60 + 100, main.cpp:3882-3957).
    """
    from ..scene.object_setup import _ensure_viewspace, load_object
    from ..viewspace.hemisphere import ViewSpace
    from .coverage import get_coverage
    from .nbv import NBVRunner

    save_paths = []
    for name in names:
        for method in method_ids:
            obj_cfg = cfg.replace(name_of_pcd=name, method_of_IG=method)
            scene = load_object(obj_cfg, name, device=device)
            if not scene.ok:
                continue
            # ensure coverage sets: full space, 5..60, 100, plus 5-view init
            sizes = (
                coverage_sizes
                if coverage_sizes is not None
                else [obj_cfg.num_of_views] + list(range(5, 61)) + [100]
            )
            for n in dict.fromkeys([obj_cfg.num_of_views, 5, *sizes]):
                get_coverage(scene, obj_cfg, n, device=device)
            init_units = _ensure_viewspace(obj_cfg.viewspace_path, 5, device)
            init_vs = ViewSpace(init_units, scene.points, obj_cfg.view_space_radius)
            for case in init_view_cases:
                for test_id in range(num_random_tests):
                    runner = NBVRunner(
                        obj_cfg, scene, nerf_cfg=nerf_cfg, predictor=predictor, device=device
                    )
                    runner.init_views = init_vs.views
                    first = scene.view_space.top_view_id()
                    save_paths.append(runner.nbv_loop(first, list(case), test_id))
    return save_paths
