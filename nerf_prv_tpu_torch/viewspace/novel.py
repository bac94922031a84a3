"""Novel (held-out) view sampling — mode 1 equivalent.

The port of ``nerf_prv_tpu/viewspace/novel.py``: 10,000 candidate sets of
100 random hemisphere views, each scored by its top-weighted pairwise
dispersion (``main.cpp:1184-1413``), all sampled and scored as one batched
tensor program on the device; the best set is kept.  Draws come from a
``torch.Generator``, so one seed gives another set than the reference's.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Tuple

import numpy as np
import torch


def _score(raw: torch.Tensor):
    """Hemisphere sets from raw normal draws (restarts, num_views, 3) and
    their scores: (points, score (restarts,))."""
    pts = raw / torch.linalg.vector_norm(raw, dim=-1, keepdim=True)
    pts = torch.cat([pts[..., :2], pts[..., 2:].abs()], dim=-1)
    diff = pts[:, :, None, :] - pts[:, None, :, :]
    d = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=0.0))
    dis = 0.5 * d.sum(dim=(1, 2))
    # top-view weighting (≙ main.cpp:1271-1275): each view with z >= 0.8
    # adds dis / num_views to the score
    num_views = pts.shape[1]
    top = (pts[..., 2] >= 0.8).sum(-1).to(torch.float32)
    return pts, dis * (1.0 + top / num_views)


def _sample_and_score(generator: torch.Generator, num_views: int, restarts: int):
    """``restarts`` random sets of ``num_views`` hemisphere directions
    (normal -> normalize -> |z|) on the generator's device, and their
    scores."""
    raw = torch.randn((restarts, num_views, 3), generator=generator, device=generator.device)
    return _score(raw)


def sample_novel_views(
    num_views: int = 100,
    seed: int = 0,
    restarts: int = 10000,
    exclude: Optional[np.ndarray] = None,
    device="cuda",
) -> np.ndarray:
    """Max-dispersion random hemisphere view set (≙ main.cpp:1252-1280).

    ``exclude``: (M, 3) coverage directions that must not be duplicated
    (collisions are measure-zero for continuous sampling; asserted anyway,
    matching the reference's exact-tuple check at ``main.cpp:1260``).
    """
    g = torch.Generator(device=torch.device(device)).manual_seed(seed)
    pts, score = _sample_and_score(g, num_views, restarts)
    best = pts[int(torch.argmax(score))].cpu().numpy().astype(np.float64)
    if exclude is not None and len(exclude):
        ex = np.asarray(exclude)
        ex = ex / np.linalg.norm(ex, axis=1, keepdims=True)
        d = np.linalg.norm(best[:, None, :] - ex[None, :, :], axis=-1)
        assert d.min() > 1e-9, "novel view collides with a coverage view"
    return best


def coverage_directions(viewspace_dir: str, sizes: Iterable[int] = range(3, 101)) -> np.ndarray:
    """All normalized coverage view directions (≙ main.cpp:1190-1201)."""
    from .hemisphere import load_view_space

    dirs = []
    for n in sizes:
        try:
            pts = load_view_space(viewspace_dir, n)
        except (OSError, ValueError):
            continue
        dirs.append(pts / np.linalg.norm(pts, axis=1, keepdims=True))
    return np.concatenate(dirs, axis=0) if dirs else np.zeros((0, 3))


def get_or_create_novel_views(
    workspace: str,
    viewspace_dir: str,
    num_views: int = 100,
    seed: int = 0,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Idempotent train/test novel view sets (≙ main.cpp:1246-1330).

    Writes/reads ``<workspace>/novel_train_views.txt`` and
    ``novel_test_views.txt``.
    """
    os.makedirs(workspace, exist_ok=True)
    out = []
    exclude = coverage_directions(viewspace_dir)
    for i, name in enumerate(("novel_train_views.txt", "novel_test_views.txt")):
        path = os.path.join(workspace, name)
        if os.path.exists(path):
            views = np.loadtxt(path).reshape(-1, 3)
        else:
            views = sample_novel_views(num_views, seed=seed + i, exclude=exclude, device=device)
            np.savetxt(path, views)
        exclude = np.concatenate([exclude, views], axis=0) if len(exclude) else views
        out.append(views)
    return out[0], out[1]
