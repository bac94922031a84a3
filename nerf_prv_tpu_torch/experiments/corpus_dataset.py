"""The PRV corpus's PRVNet dataset on the port, from the committed labels.

Counterpart of ``experiments/exp_dataset300.py``'s phase R (``:117-146``,
the 64-view sets of the 320x180 camera only) and phase B (``:283-446``, the
``pvb_dataset`` only).  The labels are not recomputed: they come from the
two committed label files (``dataset100_labels.json``, 120 objects, and
``dataset300_labels.json``, 14 more), as phase B takes them.  An object is
usable when it converged and its label lies in [MIN_VIEWS, MAX_VIEWS]; the
committed test roster (``dataset300_stats.json``) stays out of the dataset,
the committed val list (``dataset100_stats.json``) is the val split and
every other usable object trains: 117 objects, 90 train / 27 val.

The JSON files are read as data; nothing of the JAX package is imported.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np

from ..core.config import Config
from ..labeling.dataset import MAX_VIEWS, MIN_VIEWS, build_dataset
from ..labeling.labels import N_GAPS, N_GRADIENTS, X_EVAL, LabelResult
from .families import make_family_object
from .label_protocol import fit_counts, install_reference_viewspace, model_dir, require_device

ARTIFACTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "experiments", "artifacts"
)
N_VIEWS = 64  # the dataset's view space (the pretrain's samples, IMG_PATTERN's source)


def _read(art: str, name: str) -> dict:
    with open(os.path.join(art, name)) as f:
        return json.load(f)


def usable(objects: Dict[str, dict]) -> Dict[str, int]:
    """name -> label of the converged objects whose label the dataset keeps
    (≙ exp_dataset300.py:291-293)."""
    return {n: o["label"] for n, o in objects.items()
            if o["converged"] and MIN_VIEWS <= o["label"] <= MAX_VIEWS}


def corpus_roster(art: str = ARTIFACTS) -> dict:
    """The committed corpus: ``labels`` (name -> label of every dataset
    object, sorted legacy names first, then the new ones that train, as
    phase B orders them), the ``val`` list and the ``test`` roster."""
    legacy = usable(_read(art, "dataset100_labels.json")["objects"])
    new = usable(_read(art, "dataset300_labels.json")["objects"])
    test = sorted(_read(art, "dataset300_stats.json")["test"])
    val = _read(art, "dataset100_stats.json")["val"]
    train_new = sorted(set(new) - set(test))
    names = sorted(legacy) + train_new
    return dict(labels={n: legacy.get(n, new.get(n)) for n in names}, val=val, test=test)


def render_corpus(cfg: Config, names: Sequence[str], device="cuda") -> List[str]:
    """Phase R at the 320x180 camera: each object's PLY (families) and its
    64-view coverage set, skipped where ``64.json`` and the PLY exist;
    returns the names whose object loaded.  Mode 0's view spaces are the
    reference's (``install_reference_viewspace``; phase R's mode 0 wrote the
    5-view size-test space too)."""
    from ..pipeline import modes
    from ..pipeline.coverage import get_coverage
    from ..scene.object_setup import load_object

    device = require_device(device)
    sizes = fit_counts(cfg) + [5, N_VIEWS, 100]
    install_reference_viewspace(cfg, sizes, probe=False)
    modes.mode_view_cover(cfg, sizes=sizes, device=device)
    done = []
    for name in names:
        obj_cfg = cfg.replace(name_of_pcd=name)
        ply = os.path.join(model_dir(cfg), f"{name}.ply")
        if not (os.path.exists(os.path.join(obj_cfg.gt_path, f"{N_VIEWS}.json")) and os.path.exists(ply)):
            make_family_object(name, model_dir(cfg))
            scene = load_object(obj_cfg, name, device=device)
            if not scene.ok:
                print(f"[regen] {name}: load failed", flush=True)
                continue
            get_coverage(scene, obj_cfg, N_VIEWS, device=device)
        done.append(name)
    return done


def _as_result(label: int) -> LabelResult:
    """A label file's worth for ``build_dataset``: only the converged flag
    and gradient[1] are read (≙ exp_dataset300.py:328-332)."""
    grads = np.full(N_GRADIENTS, -1, dtype=np.int64)
    grads[1] = label
    return LabelResult(True, np.zeros(len(X_EVAL)), np.full(N_GAPS, -1, dtype=np.int64), grads)


def assemble_dataset(cfg: Config, art: str = ARTIFACTS, copy_images: bool = True,
                     names: Sequence[str] = None) -> dict:
    """Phase B for ``pvb_dataset``: ``build_dataset(..., split="holdout")``
    over the committed labels, then the split rewritten to the committed val
    list and the rest as train (≙ exp_dataset300.py:334-349).  ``names``
    cuts the corpus to those of its objects (a rehearsal).  Returns the
    dataset root, the labels, the train / val / test names."""
    roster = corpus_roster(art)
    names = [n for n in roster["labels"] if names is None or n in names]
    coverage_root = os.path.dirname(cfg.replace(name_of_pcd="x").gt_path)
    info = build_dataset(cfg.workspace, names, [_as_result(roster["labels"][n]) for n in names],
                         coverage_root=coverage_root, n_views=N_VIEWS, seed=cfg.seed,
                         copy_images=copy_images, split="holdout")
    ds_root = os.path.join(cfg.workspace, "pvb_dataset")
    val = sorted(n for n in roster["val"] if n in info["labels"])
    train = sorted(set(info["labels"]) - set(val))
    for split, part in (("train", train), ("val", val)):
        with open(os.path.join(ds_root, f"{split}_split.txt"), "w") as f:
            f.write("\n".join(part) + "\n")
    return dict(root=ds_root, labels=info["labels"], train=train, val=val, test=roster["test"])


def render_job(job: tuple) -> List[str]:
    """:func:`render_corpus` of (root, names, device) in a worker process,
    on the protocol's configuration under ``root``."""
    import torch

    from .label_protocol import pipeline_config

    root, names, device = job
    torch.set_num_threads(1)
    return render_corpus(pipeline_config(root), names, device=device)


def prepare_dataset(root: str, workers: int, device) -> dict:
    """The committed corpus's ``pvb_dataset`` under ``root``, as the
    predictor check and ``predict_budgets`` build it: the reference's view
    spaces, the objects' 64-view sets rendered in ``workers`` processes,
    then :func:`assemble_dataset`.  Returns its dict with ``n_loaded`` (the
    objects that loaded) and ``n_names`` (the roster's)."""
    from ..pipeline import modes
    from ..scene.object_setup import _ensure_viewspace
    from .label_protocol import pipeline_config
    from .runs import run_jobs

    cfg = pipeline_config(root)
    sizes = fit_counts(cfg) + [5, N_VIEWS, 100]
    install_reference_viewspace(cfg, sizes, probe=False)
    modes.mode_view_cover(cfg, sizes=sizes, device=device)
    _ensure_viewspace(cfg.viewspace_path, cfg.num_of_views, device)
    names = list(corpus_roster()["labels"])
    chunks = [(root, names[i::workers], str(device)) for i in range(max(workers, 1))]
    loaded = [n for part in run_jobs(render_job, chunks, workers) for n in part]
    return dict(assemble_dataset(cfg), n_loaded=len(loaded), n_names=len(names))
