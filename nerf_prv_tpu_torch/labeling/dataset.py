"""PRVNet dataset assembly — mode 6 (GetDataset) equivalent.

Counterpart of ``nerf_prv_tpu/labeling/dataset.py`` (numpy, copied: the
same seed gives the same split).

≙ ``main.cpp:2639-2885``: the supervision label is the gradient-0.02 view
count (index 1), 3-sigma clipped to [13, 58]; objects are grouped by their
20 ShapeNet category prefixes and split 80/20 per (category, label) with at
least one object per label kept in train; the per-object 64-view images and
``view_budget.txt`` are copied into ``pvb_dataset/`` and the split /
distribution bookkeeping files are written.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .labels import LabelResult

# 3-letter prefixes of the 20 ShapeNet categories (≙ main.cpp:2706-2725)
CATEGORY_PREFIXES = [
    "tab", "car", "cha", "air", "sof", "rif", "lam", "wat", "ben", "lou",
    "cab", "dis", "tel", "bus", "bat", "gui", "fau", "clo", "flo", "jar",
]

LABEL_KIND = "gradient"   # ≙ main.cpp:2641
LABEL_INDEX = 1           # gradient 0.02 dB/view
MIN_VIEWS = 13            # ≙ main.cpp:2644-2645 (3-sigma clip)
MAX_VIEWS = 58


def select_labels(
    names: Sequence[str], results: Sequence[LabelResult]
) -> Dict[str, int]:
    """Usable (name -> label) pairs after convergence + range filtering
    (≙ main.cpp:2727-2743)."""
    out = {}
    for name, r in zip(names, results):
        if not r.converged:
            continue
        label = int(
            r.gap_labels[LABEL_INDEX] if LABEL_KIND == "gap" else r.gradient_labels[LABEL_INDEX]
        )
        if label == -1 or label < MIN_VIEWS or label > MAX_VIEWS:
            continue
        out[name] = label
    return out


def stratified_split(
    labels: Dict[str, int], seed: int = 0, split: str = "reference"
) -> Tuple[List[str], List[str]]:
    """Per-category, per-label 80/20 split with >=1 object per (cat, label)
    in train (≙ main.cpp:2837-2873).

    ``split="reference"`` reproduces the reference's threshold
    ``count < (n+1)*0.8`` exactly — which sends a (cat, label) cell to val
    only once it holds >= 5 objects.  That is fine at ShapeNet scale
    (3000 objects / 20 categories) but starves val at the ~100-object
    procedural scale (round 2: 1 val object).  ``split="holdout"`` keeps
    the >=1-in-train guarantee and the 80/20 intent, but splits each
    cell's REMAINDER as floor(n*0.8) train / rest val, so every cell with
    >= 2 members contributes at least one val object."""
    rng = np.random.default_rng(seed)
    train, val = [], []
    by_cat: Dict[str, Dict[int, List[str]]] = {}
    for name, label in sorted(labels.items()):
        cat = name[:3]
        by_cat.setdefault(cat, {}).setdefault(label, []).append(name)
    for cat in sorted(by_cat):
        for label in range(MIN_VIEWS, MAX_VIEWS + 1):
            group = by_cat[cat].get(label)
            if not group:
                continue
            group = list(group)
            # first one always to train (≙ "guarantee one per label in train")
            train.append(group.pop(0))
            rng.shuffle(group)
            if split == "reference":
                cut = max(0, int((len(group) + 2) * 0.8) - 1)  # ≙ (n+1)*0.8 w/ 1 taken
            elif split == "holdout":
                cut = int(len(group) * 0.8)
            else:
                raise ValueError(f"unknown split mode {split!r}")
            train.extend(group[:cut])
            val.extend(group[cut:])
    return train, val


def build_dataset(
    workspace: str,
    names: Sequence[str],
    results: Sequence[LabelResult],
    coverage_root: Optional[str] = None,
    n_views: int = 64,
    seed: int = 0,
    copy_images: bool = True,
    split: str = "reference",
) -> Dict[str, object]:
    """Assemble ``pvb_dataset/`` + split files (≙ main.cpp:2639-2885).

    ``coverage_root``: directory containing ``<name>/64/rgbaClip_<i>.png``;
    defaults to ``<workspace>/Coverage_images/ShapeNet``.
    """
    labels = select_labels(names, results)
    ds_root = os.path.join(workspace, "pvb_dataset")
    os.makedirs(ds_root, exist_ok=True)
    coverage_root = coverage_root or os.path.join(workspace, "Coverage_images", "ShapeNet")

    names_all_path = os.path.join(ds_root, "names_all.txt")
    with open(names_all_path, "w") as f_names:
        for name, label in sorted(labels.items()):
            obj_dir = os.path.join(ds_root, name)
            os.makedirs(obj_dir, exist_ok=True)
            if copy_images:
                src_dir = os.path.join(coverage_root, name, str(n_views))
                for j in range(n_views):
                    src = os.path.join(src_dir, f"rgbaClip_{j}.png")
                    dst = os.path.join(obj_dir, f"rgbaClip_{j}.png")
                    if os.path.exists(src) and not os.path.exists(dst):
                        shutil.copyfile(src, dst)
            with open(os.path.join(obj_dir, "view_budget.txt"), "w") as f:
                f.write(str(label))
            f_names.write(name + "\n")

    train, val = stratified_split(labels, seed=seed, split=split)
    with open(os.path.join(ds_root, "train_split.txt"), "w") as f:
        f.write("\n".join(train) + ("\n" if train else ""))
    with open(os.path.join(ds_root, "val_split.txt"), "w") as f:
        f.write("\n".join(val) + ("\n" if val else ""))

    # sorted_object_names.txt summary (≙ main.cpp:2805-2814)
    vals = np.array(list(labels.values()))
    with open(os.path.join(workspace, "sorted_object_names.txt"), "w") as f:
        f.write(f"count_dataset\t{len(labels)}\n")
        f.write(f"mean_label\t{vals.mean() if len(vals) else 0}\n")
        f.write(f"min_label\t{vals.min() if len(vals) else -1}\n")
        f.write(f"max_label\t{vals.max() if len(vals) else -1}\n")
        f.write("Label\tObject\n")
        for name, label in sorted(labels.items(), key=lambda kv: (kv[1], kv[0])):
            f.write(f"{label}\t{name}\n")

    # train/val label distributions (≙ main.cpp:2877-2884)
    for split_name, split in (("train", train), ("val", val)):
        dist = np.zeros(MAX_VIEWS + 1, dtype=int)
        for n in split:
            dist[labels[n]] += 1
        with open(os.path.join(workspace, f"{split_name}_distribution.txt"), "w") as f:
            for label in range(MIN_VIEWS, MAX_VIEWS + 1):
                f.write(f"{label}\t{dist[label]}\n")

    return {"labels": labels, "train": train, "val": val}


def read_sorted_object_names(path: str) -> Dict[str, int]:
    """Parse ``sorted_object_names.txt`` (consumed by mode 7,
    main.cpp:2888-2903)."""
    out = {}
    with open(path) as f:
        lines = f.read().splitlines()
    for line in lines[5:]:
        parts = line.split()
        if len(parts) == 2:
            out[parts[1]] = int(parts[0])
    return out
