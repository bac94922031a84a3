"""A configuration of a kind the tree does not have, with a kernel of its
own, joins the benchmark as new files and list entries only.

A copy of ``BENCHMARK.json`` and ``portbench/`` gets the files of
``tests/newkind/``: a configuration with no ``nerf`` key, a traffic file of
the kind ``toy_matmul``, that kind's runner, the cell's limits, one
per-layer reader, the registry file of the counted wrapper ``toy_axpy`` and
the toy program that holds it.  ``BENCHMARK.json`` gets the configuration,
the cell and the reader's metric as entries, and the cell's name in the
lists of the metrics it reports.  On the CPU the copy resolves the cell,
runs it untraced through ``run.run_cell``, builds its result lines untraced
and over a hand-made trace of its recorded launches (``lib/trace.profile``
needs the card), and passes its own spec and kernel tests; it differs from
the tree only by the added files and entries.  On the card the copy's
``run.py`` runs the cell traced."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from lib import spec

NEWKIND = Path(__file__).resolve().parent / "newkind"
CELL = "toy-train"
SEED = 2**31 + 4242
ADDED = dict(
    configs=[dict(name="toy-mlp", source="a fixture of the benchmark's own tests; no published model",
                  file="portbench/configs/toy-mlp.json", reduced=[], why="a kind of cell the tree does not have")],
    workloads=[dict(name=CELL, config="toy-mlp", traffic="toy-matmul", chips=1,
                    why="20 gradient steps a call, each two products and one counted toy_axpy launch")],
    per_layer=[dict(name="toy.roofline.axpy", unit="%", better="higher", source="device_trace",
                    layer="kernels: the toy program", moves="train_obj_steps_per_s", workloads=[CELL])],
)
LISTED = ("train_obj_steps_per_s", "train.device_idle", "train.launches_per_step")
REPORTED = {"toy.roofline.axpy", "train.device_idle", "train.launches_per_step"}

# run from the copy's ``portbench/``: the cell untraced, then its result
# lines, the traced one over the recorded launches of one more call, each
# given a made-up 400 ns on the device (the card's peaks, so that the
# readers that need them read it)
DRIVE = f"""
import json, sys
from types import SimpleNamespace
sys.path[:0] = ["."]
import run
run.environment()
import torch
from lib import spec
from lib import trace as tracing

cell = spec.cell({CELL!r})
r = run.run_cell(cell, {SEED}, 0.0, False, torch.device("cpu"))
dev = dict(platform="cpu", kind="NVIDIA H100 80GB HBM3", power_limit="not read")
untraced = run.result_line(cell, SimpleNamespace(trace=0), r, dev)
before = tracing.launch_counts()
with tracing.Recorder() as rec:
    r["runner"].call(r["calls"])
counted = {{name: n - before[name] for name, n in tracing.launch_counts().items()}}
kernel = tracing.OWN_KERNELS["toy_axpy"].KERNEL
ops = [tracing.Op(kernel, 1000 * i, 1000 * i + 400) for i in range(len(rec.calls["toy_axpy"]))]
r["trace"] = tracing.Trace(ops, {{}}, dict(rec.calls), counted, True, 0.5, 1)
traced = run.result_line(cell, SimpleNamespace(trace=1), r, dev)
print(json.dumps(dict(untraced=untraced, traced=traced, counted=counted,
                      recorded=len(rec.calls["toy_axpy"]), steps=r["runner"].steps)))
"""


def _copy(tmp_path: Path) -> Path:
    root = tmp_path / "checkout"
    root.mkdir()
    bench = spec.benchmark()
    for key, entries in ADDED.items():
        bench[key] = bench[key] + entries
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in LISTED:
            m["workloads"] = m["workloads"] + [CELL]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1) + "\n")
    shutil.copytree(spec.HERE, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(NEWKIND, root / "portbench", dirs_exist_ok=True, ignore=shutil.ignore_patterns("__pycache__"))
    return root


def _env() -> dict:
    """The program from the tree; the harness only from the copy."""
    return dict(os.environ, PYTHONPATH=str(spec.ROOT))


def _changed(tree: Path, copy: Path) -> list:
    """Files of ``tree`` that ``copy`` lacks or holds otherwise."""
    out = []
    for path in sorted(tree.rglob("*")):
        if path.is_file() and "__pycache__" not in path.parts:
            other = copy / path.relative_to(tree)
            if not other.is_file() or other.read_bytes() != path.read_bytes():
                out.append(str(path.relative_to(tree)))
    return out


def _only_added(old, new) -> bool:
    """``new`` is ``old`` with list entries added: every key the same, every
    named entry kept as it was, every other list kept as its head."""
    if isinstance(old, dict):
        return isinstance(new, dict) and set(new) == set(old) and all(_only_added(v, new[k]) for k, v in old.items())
    if isinstance(old, list) and all(isinstance(e, dict) and "name" in e for e in old):
        by_name = {e["name"]: e for e in new if isinstance(e, dict)}
        return all(e["name"] in by_name and _only_added(e, by_name[e["name"]]) for e in old)
    if isinstance(old, list):
        return isinstance(new, list) and new[: len(old)] == old
    return old == new


def test_only_added_tells_an_addition_from_an_edit():
    old = dict(workloads=[dict(name="a", chips=1)], per_layer=[dict(name="m", workloads=["a"])])
    assert _only_added(old, dict(workloads=[dict(name="a", chips=1), dict(name="b", chips=1)],
                                 per_layer=[dict(name="m", workloads=["a", "b"])]))
    assert not _only_added(old, dict(workloads=[dict(name="a", chips=4)], per_layer=old["per_layer"]))
    assert not _only_added(old, dict(workloads=old["workloads"], per_layer=[dict(name="m", workloads=["b"])]))
    assert not _only_added(old, dict(workloads=old["workloads"], per_layer=[dict(name="m")]))  # a list taken away
    assert not _only_added(dict(end_to_end=[dict(name="setup_s")]),
                           dict(end_to_end=[dict(name="setup_s", workloads=["b"])]))  # a metric narrowed


def test_a_new_kind_with_its_own_kernel_is_added_as_files_and_entries(tmp_path):
    root = _copy(tmp_path)
    r = subprocess.run([sys.executable, "-c", DRIVE], cwd=root / "portbench", env=_env(), capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    untraced, traced = got["untraced"], got["traced"]
    assert untraced["correct"] and set(untraced["metrics"]) == {"train_obj_steps_per_s", "setup_s"}
    assert set(untraced["checks"]) == {"weight_gap"}
    # every launch of the toy wrapper recorded and counted, one a step
    assert got["recorded"] == got["counted"]["toy_axpy"] == got["steps"]
    assert set(traced["metrics"]) == REPORTED
    assert traced["metrics"]["train.launches_per_step"]["value"] == 1.0
    assert traced["breakdown"]["device_ops"][0][0] == "toy_axpy"
    # the copy's own tests of the spec and of the kernel registry take it as it is
    t = subprocess.run([sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider", "tests/test_portbench_spec.py",
                        "tests/test_portbench_kernels.py"], cwd=root / "portbench", env=_env(), capture_output=True,
                       text=True, timeout=600)
    assert t.returncode == 0, t.stdout[-4000:]
    for case in ("test_config_file_resolves[toy-mlp]", "test_cell_resolves[toy-train]",
                 "test_metric_reader_resolves[toy.roofline.axpy]", "test_registry_file_resolves_to_a_counted_wrapper[toy_axpy]"):
        assert f"{case} PASSED" in t.stdout, case
    # nothing of the harness changed: files and entries were only added
    assert _changed(spec.HERE, root / "portbench") == []
    assert _only_added(spec.benchmark(), spec.benchmark(root))


@pytest.mark.card
def test_the_new_kind_runs_traced_on_the_card(card, tmp_path):
    """The copy's ``run.py``, traced: the toy kernel's launches are recorded,
    the trace is complete, and the cell's readers read it."""
    root = _copy(tmp_path)
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELL, "--seed", str(SEED), "--seconds", "2",
                        "--trace", "1"], cwd=root, env=_env(), capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    print(json.dumps(line))
    assert line["correct"] and set(line["metrics"]) == REPORTED
    assert "trace: complete" in r.stderr
    assert line["metrics"]["train.launches_per_step"]["value"] == 1.0
    assert 0 < line["metrics"]["toy.roofline.axpy"]["value"] <= 100
    assert "toy_axpy" in [name for name, _ in line["breakdown"]["device_ops"]]
