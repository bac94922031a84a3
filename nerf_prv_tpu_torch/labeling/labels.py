"""Label extraction and ``label.txt`` IO.

Counterpart of ``nerf_prv_tpu/labeling/labels.py`` (numpy, copied; the fit
runs through the port's :mod:`.lognormal` on ``device``).

≙ ``Fit_ShapeNet`` / ``Fit_HB`` (``NeRF_fit_curve.cpp:56-363``): fit the
PSNR-vs-views curve, evaluate it on v = 3..100, then emit
- gap labels:      for g in 0..10, first v with FitY(v) >= (1-0.01g)*maxPSNR
- gradient labels: for t in 0.01..0.20, first v (from 4) with
                   FitY(v) - FitY(v-1) <= t
with -1 when never reached, and a ``Converged`` flag that also rejects fits
whose *measured* samples exceed the 100-view PSNR
(``NeRF_fit_curve.cpp:149-157``).  File format is byte-compatible with the
reference so mode-5/6 artifacts interchange.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from .lognormal import eval_curve, fit_batch

X_EVAL = np.arange(3, 101)
N_GAPS = 11
N_GRADIENTS = 20

# view counts excluded from the HB fit (≙ Fit_HB, NeRF_fit_curve.cpp:238,251)
HB_SKIP = {13, 17, 31, 41, 47}


def hb_view_counts(view_num_max: int = 50, view_num_add: int = 2) -> list:
    """The Fit_HB sample grid: 3..50 step 2 minus the skip set."""
    return [v for v in range(3, view_num_max + 1, view_num_add) if v not in HB_SKIP]


@dataclass
class LabelResult:
    converged: bool
    curve: np.ndarray          # FitY at v = 3..100
    gap_labels: np.ndarray     # (11,) int
    gradient_labels: np.ndarray  # (20,) int


def labels_from_curve(curve: np.ndarray, max_psnr: float) -> Dict[str, np.ndarray]:
    curve = np.asarray(curve)
    gaps = np.full(N_GAPS, -1, dtype=np.int64)
    for g in range(N_GAPS):
        hit = np.nonzero(curve / max_psnr >= 1.0 - 0.01 * g)[0]
        if len(hit):
            gaps[g] = X_EVAL[hit[0]]
    grads = np.full(N_GRADIENTS, -1, dtype=np.int64)
    diffs = np.diff(curve)  # FitY(v) - FitY(v-1) for v = 4..100
    for k in range(N_GRADIENTS):
        t = 0.01 * (k + 1)
        hit = np.nonzero(diffs <= t + 1e-12)[0]
        if len(hit):
            grads[k] = X_EVAL[hit[0] + 1]
    return {"gap": gaps, "gradient": grads}


def fit_objects(
    x_samples: Sequence[float],
    psnr_samples: np.ndarray,   # (B, n) measured PSNR at x_samples
    max_psnrs: np.ndarray,      # (B,) PSNR at 100 views
    check_samples_below_max: bool = True,
    device="cuda",
) -> List[LabelResult]:
    """Batched fit + labeling of many objects at once (≙ Fit_ShapeNet;
    ``check_samples_below_max=False`` gives Fit_HB's convergence rule, which
    omits the sample-vs-max rejection, NeRF_fit_curve.cpp:305-309).  The
    fits run on ``device``; the curves and flags are read back once."""
    psnr_samples = np.atleast_2d(np.asarray(psnr_samples, np.float64))
    max_psnrs = np.atleast_1d(np.asarray(max_psnrs, np.float64))
    res = fit_batch(np.asarray(x_samples, np.float64), psnr_samples, device=device)
    curves = eval_curve(res.params, X_EVAL)
    fit_converged = res.converged.cpu().numpy()
    out = []
    for i in range(len(psnr_samples)):
        converged = bool(fit_converged[i])
        # reject when measured samples exceed the 100-view PSNR
        if check_samples_below_max and (psnr_samples[i] > max_psnrs[i]).any():
            converged = False
        lab = labels_from_curve(curves[i], max_psnrs[i])
        out.append(
            LabelResult(
                converged=converged,
                curve=curves[i],
                gap_labels=lab["gap"],
                gradient_labels=lab["gradient"],
            )
        )
    return out


def write_label_file(path: str, result: LabelResult) -> None:
    """Byte-compatible ``label.txt`` (≙ NeRF_fit_curve.cpp:165-206)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(f"Converged {1 if result.converged else 0}\n")
        for v, y in zip(X_EVAL, result.curve):
            f.write(f"{v} {y:.6f}\n")
        for g in range(N_GAPS):
            f.write(f"gap {g}% {result.gap_labels[g]}\n")
        for k in range(N_GRADIENTS):
            f.write(f"gradient {0.01 * (k + 1):.2f} {result.gradient_labels[k]}\n")


def parse_label_file(path: str) -> LabelResult:
    """≙ the mode-5 label reader incl. token validation (main.cpp:2509-2542)."""
    with open(path) as f:
        tokens = f.read().split()
    it = iter(tokens)

    def expect(word):
        tok = next(it)
        if tok != word:
            raise ValueError(f"label wrong {tok} (expected {word}) in {path}")

    expect("Converged")
    converged = bool(int(next(it)))
    curve = np.zeros(len(X_EVAL))
    for i, v in enumerate(X_EVAL):
        got = int(next(it))
        if got != v:
            raise ValueError(f"label wrong {got} in {path}")
        curve[i] = float(next(it))
    gaps = np.zeros(N_GAPS, dtype=np.int64)
    for g in range(N_GAPS):
        expect("gap")
        next(it)  # "<g>%"
        gaps[g] = int(next(it))
    grads = np.zeros(N_GRADIENTS, dtype=np.int64)
    for k in range(N_GRADIENTS):
        expect("gradient")
        next(it)  # "0.01".."0.20"
        grads[k] = int(next(it))
    return LabelResult(converged, curve, gaps, grads)


def fit_object_from_metrics(
    metrics_dir: str,
    view_counts: Optional[Sequence[int]] = None,
    label_path: Optional[str] = None,
    hb: bool = False,
    device="cuda",
) -> LabelResult:
    """Read per-view-count ``<v>.txt`` PSNR files + ``100.txt`` like
    ``Fit_ShapeNet`` (NeRF_fit_curve.cpp:90-116), fit, optionally write
    ``label.txt``.  ``hb=True`` applies the Fit_HB grid (skip set) and
    convergence rule."""
    from ..nerf.api import load_metrics

    if view_counts is None:
        view_counts = hb_view_counts() if hb else list(range(3, 51, 2))
    elif hb:
        view_counts = [v for v in view_counts if v not in HB_SKIP]
    psnrs = [load_metrics(os.path.join(metrics_dir, f"{v}.txt"))["PSNR"] for v in view_counts]
    max_psnr = load_metrics(os.path.join(metrics_dir, "100.txt"))["PSNR"]
    result = fit_objects(
        view_counts,
        np.asarray(psnrs)[None],
        np.asarray([max_psnr]),
        check_samples_below_max=not hb,
        device=device,
    )[0]
    if label_path:
        write_label_file(label_path, result)
    return result
