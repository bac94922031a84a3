"""What a cell is made of, found by name: ``BENCHMARK.json`` at the root of
the checkout, the configuration file it names, the traffic file
``workloads/<traffic>.json``, the limits file ``limits/<cell>.json``, the
per-layer metric readers ``metrics/<metric>.py`` and the registry of the
program's own kernels, ``kernels/<wrapper>.py``.

A later cell, traffic mix, configuration, metric or kernel is added as files
and entries; nothing here, in ``run.py`` or in ``lib/trace.py`` changes:

- A configuration is its file of sizes.  The harness reads none of its keys
  itself: only the runner of its cells' kind does.
- A traffic file's ``kind`` picks the runner ``kinds/<kind>.py``.  A new kind
  brings that file, whose ``Runner(cell, seed, device)`` has ``setup()``,
  ``call(i)`` (one unit of work, ended when it returns), ``judged(n_calls)``
  (the call the check judges, or None for every call), ``check(results)``
  (the numbers compared), ``readings(result, with_control)`` (the program's,
  the control's and each fault's numbers, for ``calibrate.py``),
  ``units_per_call``, ``build_s`` and ``reference_s``, and whatever its own
  readers use; beside it ``CONFIG_KEYS`` (the configuration keys the kind
  reads, which the spec test holds its cells' configuration files to) and
  ``cpu_cut(cell)`` (the cell at a size the CPU tests run in seconds).
  A kind's plain reference is ``lib/reference*.py``.
- A per-layer reader ``read(run)`` gets the cell (``run.cell``, with its
  configuration), the runner, the window's calls, wall time and launches,
  the trace and the card's peaks; it returns None where it finds nothing.
- A kernel of the program that the trace should count is a registry file
  ``kernels/<wrapper>.py``: ``MODULE`` (the port module that holds the
  wrapper ``<wrapper>``, which counts its launches in ``.launches``),
  ``KERNEL`` (the kernel's name in the trace), ``MEMSET_BEFORE`` (the
  wrapper zeroes its output with a memset just before the kernel) and
  ``record(args, i)`` (what the i-th launch's bound needs, from the
  wrapper's arguments; ``n``, its rows, 0 where it launches nothing).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, NamedTuple

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


def _load(path: Path, prefix: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(f"{prefix}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return _load(HERE / "metrics" / f"{metric}.py", "portbench_metric").read


def kernels() -> Dict[str, ModuleType]:
    """Wrapper name -> its registry file ``kernels/<wrapper>.py``, in sorted
    order of the names."""
    return {path.stem: _load(path, "portbench_kernel") for path in sorted((HERE / "kernels").glob("*.py"))}


def runner(kind: str):
    """The runner module ``kinds/<kind>.py`` of a traffic file's ``kind``."""
    return importlib.import_module(f"kinds.{kind}")
