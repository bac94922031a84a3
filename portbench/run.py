#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the card, and print one JSON
line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (``configs/<config>.json``) and a traffic mix
(``workloads/<traffic>.json``), whose ``kind`` picks the runner
(``kinds/<kind>.py``) that makes the inputs from the seed and calls the
program.  Set-up (the program's kernel build, the inputs, the warm-up of
every shape the window uses) counts as ``setup_s``, from the start of the
process, less any of it spent on the reference (an eval cell's fit of its
weights); the kernel build's own seconds are reported beside it under
``setup_parts``.  The window then calls the program's entry back to back, a
call starting while less than ``--seconds`` have passed; it ends when the last
call returns, and every rate is all the window's work over all its time.
With ``--trace 1`` one more call runs under the profiler after the window,
and the per-layer metrics (``metrics/<name>.py``) are read from it and from
the window.  Once the window has closed and the memory peak has been read,
the runner's check holds what the program produced to the reference: each
number compared and its limit (``limits/<cell>.json``) are printed as the
last lines of standard error and under ``checks``, the last key of the
result line.

Exits 3, printing no result, without a card or with fewer cards than the
cell asks for; exits 4 if JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from lib.clock import log  # noqa: E402  (the harness's directory is the script's)

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "nerf_prv_tpu")


def environment() -> None:
    """Paths before anything is imported: the harness and the program on
    sys.path, every cache inside the checkout, no JAX for libraries that
    would load it."""
    sys.path[:0] = [str(HERE), str(ROOT)]
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    # the program's work is on the card: one host thread of ops, so that the
    # process adds no thread pools of its own to the host's load
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``nerf_prv_tpu_torch`` is not ``nerf_prv_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def power_limit_query():
    """``nvidia-smi``'s reading of the card's power limit, started now and
    read by :func:`power_limit` once set-up is over."""
    try:
        return subprocess.Popen(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "--id=0"],
                                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    except OSError:
        return None


def power_limit(proc) -> str:
    if proc is None:
        return "not read"
    try:
        out, _ = proc.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        return "not read"
    return out.strip().splitlines()[0] if out.strip() else "not read"


def run_cell(cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """Set up, run the window, trace, check; returns the result's parts."""
    import torch

    from lib import spec

    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    log("set-up begins")
    runner = spec.runner(cell.traffic["kind"]).Runner(cell, seed, device)
    runner.setup()
    sync()
    from lib import trace as tracing

    # set-up is the program's: the reference's own work in it is left out
    reference_s = getattr(runner, "reference_s", 0.0)
    setup_s = time.perf_counter() - T0 - reference_s
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    before = tracing.launch_counts()
    results, ends = {}, []
    t0 = time.perf_counter()
    while not results or time.perf_counter() - t0 < seconds:
        results[len(results)] = runner.call(len(results))
        ends.append(time.perf_counter())
    sync()
    wall = time.perf_counter() - t0
    log("calls end at " + ", ".join(f"{e - t0:.3f}" for e in ends) + " s")
    launches = {name: n - before[name] for name, n in tracing.launch_counts().items()}
    n_calls = len(results)
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    build_s = getattr(runner, "build_s", 0.0)
    log(f"window: {n_calls} calls in {wall:.6f} s; set-up {setup_s:.6f} s (kernel build {build_s:.6f} s; "
        f"the reference's {reference_s:.6f} s left out); memory peak {memory_peak} B")
    profiled = None
    if trace:
        profiled = tracing.profile(lambda: runner.call(n_calls))
        log(f"trace: {'complete' if profiled.complete else 'INCOMPLETE'} after {profiled.attempts} tries, "
            f"profiled call {profiled.wall_s:.6f} s, own launches {profiled.counted}")
    judged = runner.judged(n_calls)
    if judged is not None:
        results = {judged: results[judged]}
    if on_card:
        torch.cuda.empty_cache()
    answers = len(results)
    numbers = runner.check(results)
    del results
    return dict(runner=runner, setup_s=setup_s, build_s=build_s, reference_s=reference_s, wall_s=wall, calls=n_calls, launches=launches,
                memory_peak=memory_peak, trace=profiled, numbers=numbers, answers=answers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    from lib import spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"needs {cell.chips} CUDA card(s), found {n}: nothing measured")
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = power_limit_query()
    try:
        r = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    finally:
        limit = power_limit(smi)
    dev_info = dict(platform="gpu", kind=torch.cuda.get_device_name(device), power_limit=limit)
    log(f"card {dev_info['kind']}, power limit {dev_info['power_limit']}")
    line = result_line(cell, args, r, dev_info)
    bad = loaded_forbidden()
    if bad:
        log(f"modules of JAX or the JAX package were loaded: {bad}; no result")
        return 4
    for name, c in line["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r} {'ok' if c['value'] <= c['limit'] else 'FAIL'}")
    print(json.dumps(line), flush=True)
    return 0


def result_line(cell, args, r: dict, dev_info: dict) -> dict:
    from lib import arith, spec
    from lib import trace as tracing

    runner = r["runner"]
    # the limits file names the numbers compared; any other is only reported
    checks = {name: dict(value=v, limit=cell.limits[name]) for name, v in r["numbers"].items() if name in cell.limits}
    missing = set(cell.limits) - set(checks)
    if missing:
        raise SystemExit(f"the check gave no {sorted(missing)}")
    for name in sorted(set(r["numbers"]) - set(checks)):
        log(f"not compared: {name} {r['numbers'][name]!r}")
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device = dict(platform=dev_info["platform"], kind=dev_info["kind"], count=cell.chips,
                  memory_peak_bytes=int(r["memory_peak"]), power_limit=dev_info["power_limit"])
    line = dict(correct=correct, attempted=r["calls"], failed=0 if correct else r["answers"])
    if args.trace:
        t = r["trace"]
        run = SimpleNamespace(cell=cell, runner=runner, calls=r["calls"],
                              wall_s=r["wall_s"], launches=r["launches"], trace=t,
                              peaks=arith.peaks(dev_info["kind"]))
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
        device.update(busy_s=tracing.busy_ns(t.device_ops) / 1e9, window_s=t.wall_s)
        line["metrics"] = metrics
        line["device"] = device
        line["breakdown"] = dict(device_ops=tracing.device_breakdown(t), idle_gaps=tracing.idle_gaps(t))
    else:
        rate = cell.traffic["rate_metric"]
        values = {"setup_s": r["setup_s"], rate: runner.units_per_call * r["calls"] / r["wall_s"]}
        line["metrics"] = {m["name"]: dict(value=values[m["name"]], unit=m["unit"]) for m in cell.end_to_end}
        line["device"] = device
    # what set-up spent building kernels (the first run in a checkout
    # compiles them) and the reference's work left out of it
    line["setup_parts"] = dict(build_s=r["build_s"], reference_s=r["reference_s"])
    line["checks"] = checks
    return line


if __name__ == "__main__":
    sys.exit(main())
