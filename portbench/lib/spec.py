"""What a cell is made of, found by name: ``BENCHMARK.json`` at the root of
the checkout, the configuration file it names, the traffic file
``workloads/<traffic>.json``, the limits file ``limits/<cell>.json`` and the
per-layer metric readers ``metrics/<metric>.py``.  A later cell, traffic mix,
configuration or metric is added as files and entries; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import List, NamedTuple

HERE = Path(__file__).resolve().parents[1]  # portbench/
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config_name: str
    config: dict          # the configuration file
    traffic_name: str
    traffic: dict         # the traffic file
    limits: dict          # number compared -> limit
    end_to_end: List[dict]
    per_layer: List[dict]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have: {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    end_to_end = [m for m in bench["end_to_end"] if applies(m, name)]
    moved = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"] if applies(m, name) and m["moves"] in moved]
    return Cell(name, int(w["chips"]), w["config"], load_json(root / cfg_entry["file"]), w["traffic"],
                load_json(HERE / "workloads" / f"{w['traffic']}.json"),
                load_json(HERE / "limits" / f"{name}.json"), end_to_end, per_layer)


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def runner(kind: str):
    """The runner module ``kinds/<kind>.py`` of a traffic file's ``kind``."""
    return importlib.import_module(f"kinds.{kind}")
