"""The PRV corpus's PRVNet datasets on the port, from the committed labels.

Counterpart of ``experiments/exp_dataset300.py``'s phase R (``:117-146``)
and phase B (``:283-446``).  The labels are not recomputed: they come from
the two committed label files (``dataset100_labels.json``, 120 objects, and
``dataset300_labels.json``, 14 more), as phase B takes them.  An object is
usable when it converged and its label lies in [MIN_VIEWS, MAX_VIEWS]; the
committed test roster (``dataset300_stats.json``) stays out of the dataset,
the committed val list (``dataset100_stats.json``) is the val split and
every other usable object trains: 117 objects, 90 train / 27 val.

Two datasets share those objects and labels (``:71-115``, ``:351-417``):
``pvb_dataset``, each object's 64-view set at the 320x180 camera, and
``pvb_dataset_hd``, its ``HD_VIEWS``-view set at the production camera
(1280x720, ``pvb_cfg``) under ``<gt_path>/hd/``, which the tiny@720 recipe
trains on.  Every object, the test roster's too, also gets an hd 5-view
set: the views the tiny@720 predictor reads (``mode7_compare.HDPredictor``).

The JSON files are read as data; nothing of the JAX package is imported.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np

from ..core.config import CameraConfig, Config
from ..labeling.dataset import MAX_VIEWS, MIN_VIEWS, build_dataset
from ..labeling.labels import N_GAPS, N_GRADIENTS, X_EVAL, LabelResult
from .families import make_family_object
from .label_protocol import fit_counts, install_reference_viewspace, model_dir, require_device

ARTIFACTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "experiments", "artifacts"
)
N_VIEWS = 64  # the dataset's view space (the pretrain's samples, IMG_PATTERN's source)
# the hd dataset's view space: the regression reads views 0..4 and the
# pretrain takes each view as a sample, so 16 well-spread views keep ~1,900
# pretrain samples at a quarter of the 1280x720 renders (exp_dataset300.py:104-113)
HD_VIEWS = 16
HD_INIT_VIEWS = 5  # the live predictor's init set, rendered for every object


def pvb_cfg(cfg: Config) -> Config:
    """``cfg`` at the production camera (``CameraConfig()``, 1280x720), where
    the hd sets render so that CenterCrop(720) sees the reference's image
    geometry (≙ exp_dataset300.py:71-83)."""
    return cfg.replace(camera=CameraConfig())


def hd_path(obj_cfg: Config) -> str:
    """The object's hd coverage root, ``<gt_path>/hd``."""
    return os.path.join(obj_cfg.gt_path, "hd")


def render_hd_sets(scene, obj_cfg: Config, hd_train: bool = True, device="cuda") -> None:
    """The object's hd sets (≙ exp_dataset300.py:93-104 less its 64-view
    set): ``HD_VIEWS`` views where ``hd_train``, then the 5-view init set,
    each one K8 launch at the production camera."""
    from ..pipeline.coverage import get_coverage

    hd_cfg, hd = pvb_cfg(obj_cfg), hd_path(obj_cfg)
    if hd_train:
        get_coverage(scene, hd_cfg, HD_VIEWS, gt_path=hd, device=device)
    get_coverage(scene, hd_cfg, HD_INIT_VIEWS, gt_path=hd, device=device)


def hd_done(obj_cfg: Config, hd_train: bool = True) -> bool:
    """Whether the object's 64-view set and its hd sets are on disk
    (≙ exp_dataset300.py:107-112)."""
    want = [f"{N_VIEWS}.json", os.path.join("hd", f"{HD_INIT_VIEWS}.json")]
    if hd_train:
        want.append(os.path.join("hd", f"{HD_VIEWS}.json"))
    return all(os.path.exists(os.path.join(obj_cfg.gt_path, p)) for p in want)


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


def render_corpus(cfg: Config, names: Sequence[str], device="cuda", hd: bool = False) -> List[str]:
    """Phase R at the 320x180 camera: each object's PLY (families) and its
    64-view coverage set, skipped where ``64.json`` and the PLY exist;
    returns the names whose object loaded.  Mode 0's view spaces are the
    reference's (``install_reference_viewspace``; phase R's mode 0 wrote the
    5-view size-test space too).  ``hd`` adds the hd sets
    (:func:`render_hd_sets`): the 5-view one for every name, the
    ``HD_VIEWS``-view one for the dataset's objects only (the test roster
    never trains)."""
    from ..pipeline import modes
    from ..pipeline.coverage import get_coverage
    from ..scene.object_setup import load_object

    device = require_device(device)
    sizes = fit_counts(cfg) + [5, N_VIEWS, 100]
    install_reference_viewspace(cfg, sizes + ([HD_VIEWS] if hd else []), probe=False)
    modes.mode_view_cover(cfg, sizes=sizes, device=device)
    trains = set(corpus_roster()["labels"]) if hd else set()
    done = []
    for name in names:
        obj_cfg = cfg.replace(name_of_pcd=name)
        ply = os.path.join(model_dir(cfg), f"{name}.ply")
        sets_done = (hd_done(obj_cfg, name in trains) if hd
                     else os.path.exists(os.path.join(obj_cfg.gt_path, f"{N_VIEWS}.json")))
        if not (sets_done and os.path.exists(ply)):
            make_family_object(name, model_dir(cfg))
            scene = load_object(obj_cfg, name, device=device)
            if not scene.ok:
                print(f"[regen] {name}: load failed", flush=True)
                continue
            get_coverage(scene, obj_cfg, N_VIEWS, device=device)
            if hd:
                render_hd_sets(scene, obj_cfg, name in trains, device=device)
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


def assemble_hd_dataset(cfg: Config, ds: dict) -> dict:
    """Phase B for ``pvb_dataset_hd`` (≙ exp_dataset300.py:365-417), from
    :func:`assemble_dataset`'s ``ds``: each object's ``HD_VIEWS`` hd PNGs
    hard-linked (a link to another render of the same index is replaced),
    images of a larger earlier view space removed, ``view_budget.txt``
    written; an object that lacks an image is dropped, with a printed line.
    The split files are ``pvb_dataset``'s filtered to the complete objects.
    Returns the root, the labels, train / val names, the linked and the
    dropped objects (name -> images found)."""
    hd_root = os.path.join(cfg.workspace, "pvb_dataset_hd")
    complete, dropped = set(), {}
    for name, label in ds["labels"].items():
        obj_dir = os.path.join(hd_root, name)
        os.makedirs(obj_dir, exist_ok=True)
        src_dir = os.path.join(hd_path(cfg.replace(name_of_pcd=name)), str(HD_VIEWS))
        n_linked = 0
        for j in range(HD_VIEWS):
            src = os.path.join(src_dir, f"rgbaClip_{j}.png")
            dst = os.path.join(obj_dir, f"rgbaClip_{j}.png")
            if os.path.exists(dst) and (not os.path.exists(src) or os.path.samefile(src, dst)):
                n_linked += 1
            elif os.path.exists(src):
                if os.path.exists(dst):
                    os.remove(dst)
                os.link(src, dst)
                n_linked += 1
        for stale in os.listdir(obj_dir):
            j = stale[len("rgbaClip_"):-len(".png")]
            if stale.startswith("rgbaClip_") and stale.endswith(".png") and j.isdigit() and int(j) >= HD_VIEWS:
                os.remove(os.path.join(obj_dir, stale))
        with open(os.path.join(obj_dir, "view_budget.txt"), "w") as f:
            f.write(str(label))
        if n_linked == HD_VIEWS:
            complete.add(name)
        else:
            dropped[name] = n_linked
            print(f"[hd] dropped {name}: {n_linked}/{HD_VIEWS} images", flush=True)
    splits = {}
    for split_file in ("train_split.txt", "val_split.txt", "names_all.txt"):
        with open(os.path.join(ds["root"], split_file)) as f:
            splits[split_file] = [n for n in f.read().split() if n in complete]
        with open(os.path.join(hd_root, split_file), "w") as f:
            f.write("\n".join(splits[split_file]) + "\n")
    return dict(root=hd_root, labels={n: ds["labels"][n] for n in splits["names_all.txt"]},
                train=splits["train_split.txt"], val=splits["val_split.txt"], linked=sorted(complete),
                dropped=dropped)


def render_job(job: tuple) -> List[str]:
    """:func:`render_corpus` of (root, names, device, hd) in a worker
    process, on the protocol's configuration under ``root``."""
    import torch

    from .label_protocol import pipeline_config

    root, names, device, hd = job
    torch.set_num_threads(1)
    return render_corpus(pipeline_config(root), names, device=device, hd=hd)


def prepare_dataset(root: str, workers: int, device, hd: bool = False) -> dict:
    """The committed corpus's ``pvb_dataset`` under ``root``, as the
    predictor check and ``predict_budgets`` build it: the reference's view
    spaces, the objects' 64-view sets rendered in ``workers`` processes,
    then :func:`assemble_dataset`.  Returns its dict with ``n_loaded`` (the
    objects that loaded) and ``n_names`` (the roster's).  ``hd`` renders the
    hd sets too, the test roster's 5-view ones included, and adds ``hd``:
    :func:`assemble_hd_dataset`'s dict."""
    from ..pipeline import modes
    from ..scene.object_setup import _ensure_viewspace
    from .label_protocol import pipeline_config
    from .runs import run_jobs

    cfg = pipeline_config(root)
    sizes = fit_counts(cfg) + [5, N_VIEWS, 100]
    install_reference_viewspace(cfg, sizes + ([HD_VIEWS] if hd else []), probe=False)
    modes.mode_view_cover(cfg, sizes=sizes, device=device)
    _ensure_viewspace(cfg.viewspace_path, cfg.num_of_views, device)
    roster = corpus_roster()
    names = list(roster["labels"]) + (roster["test"] if hd else [])
    chunks = [(root, names[i::workers], str(device), hd) for i in range(max(workers, 1))]
    loaded = [n for part in run_jobs(render_job, chunks, workers) for n in part]
    out = dict(assemble_dataset(cfg), n_loaded=len(loaded), n_names=len(names))
    if hd:
        out["hd"] = assemble_hd_dataset(cfg, out)
    return out
