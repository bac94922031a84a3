"""Pilot 2 on the port: the two tail-anchor families through the label
protocol.

Counterpart of ``experiments/exp_label_spread2.py``: ``nos0``, ``nos7``
(noise colours, the low tail) and ``fan0``, ``fan7`` (dense twisted vanes,
the high tail) through ``label_protocol.run_label_protocol`` (modes 0 -> 3
-> 4 -> fit at the 320x180 camera, 1,200-step fields), on the view-space
files the reference's workspace held (``install_reference_viewspace``).
The artifact has the committed ``label_spread_pilot2.json``'s keys:
``objects`` ({name: {label, converged}}), ``seconds_per_object``,
``total_seconds`` and ``distinct_labels``.

    python -m nerf_prv_tpu_torch.experiments.label_spread2 [--root DIR] [--seed 0]

The artifact goes to ``--out`` (default ``runs.LOG_DIR/label_spread_pilot2.json``)
and is printed; the check against the committed labels at three NeRF seeds
is ``check_pilot2``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Tuple

from .label_protocol import fit_counts, install_reference_viewspace, pipeline_config, run_label_protocol
from .runs import LOG_DIR, WORKSPACE, write_json

PILOT2 = ("nos0", "nos7", "fan0", "fan7")


def pilot2_artifact(out: Dict[str, Tuple[int, bool]], times: Dict[str, float], total_s: float) -> dict:
    """The committed artifact's keys from ``run_label_protocol``'s output
    (≙ exp_label_spread2.py:33-39)."""
    return {
        "objects": {k: {"label": v[0], "converged": v[1]} for k, v in out.items()},
        "seconds_per_object": times,
        "total_seconds": round(total_s, 1),
        "distinct_labels": sorted({v[0] for v in out.values() if v[0] > 0}),
    }


def run_pilot2(root: str, seed: int = 0, device="cuda") -> dict:
    """The pilot under ``root`` at NeRF seed ``seed``; returns the artifact."""
    cfg = pipeline_config(root)
    install_reference_viewspace(cfg, fit_counts(cfg) + [64, 100], probe=True)
    t0 = time.perf_counter()
    out, times = run_label_protocol(cfg, PILOT2, seed=seed, device=device)
    return pilot2_artifact(out, times, time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.join(WORKSPACE, "label_spread2"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(LOG_DIR, "label_spread_pilot2.json"))
    args = ap.parse_args(argv)
    artifact = run_pilot2(args.root, seed=args.seed, device=args.device)
    write_json(args.out, artifact)
    print(json.dumps(artifact), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
