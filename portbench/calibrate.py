#!/usr/bin/env python3
"""Readings for a cell's correctness limits: the program, the control and
the planted faults, each held to the reference as a run's check holds it.

    python3 portbench/calibrate.py --workload <name> --seeds <n> ... [--control-seeds <n> ...] [--out <file>]

For every seed: the cell's set-up, one call of the program's timed entry at
the cell's own size (for a training cell, call 0 of that seed, the call a
run judges when its window holds one), and the compared numbers.  For every
control seed, also the control (the reference with float8 in place of the
configuration's bfloat16, put in the program's place) and each fault the
cell can have: a training cell's half batch (each object's loss over half
its rays), an eval cell's altered frame (the first frame rendered black) and
half of the frames (the scores of the first half only).  A training step
that leaves its state unchanged reads 1 on ``param_change`` by that number's
definition and needs no run.  The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time

import run as harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    harness.environment()
    import torch

    from lib import spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        harness.log("needs a CUDA card: nothing read")
        return 3
    calibrate(cell, args.seeds, args.control_seeds, args.out, torch.device("cuda", 0))
    return 0


def calibrate(cell, seeds, control_seeds, out="", device=None) -> dict:
    import torch

    from lib import spec

    readings = dict(workload=cell.name, program={}, control={}, faults={})
    for seed in seeds:
        t0 = time.perf_counter()
        runner = spec.runner(cell.traffic["kind"]).Runner(cell, seed, device)
        runner.setup()
        program, control, faults = runner.readings(runner.call(0), seed in control_seeds)
        readings["program"][seed] = program
        if control is not None:
            readings["control"][seed] = control
        for fault, numbers in faults.items():
            readings["faults"].setdefault(fault, {})[seed] = numbers
        del runner
        if device.type == "cuda":
            torch.cuda.empty_cache()
        harness.log(f"seed {seed}: {program} control {control} ({time.perf_counter() - t0:.1f} s)")
    for name in next(iter(readings["program"].values())):
        prog = [r[name] for r in readings["program"].values()]
        ctrl = [r[name] for r in readings["control"].values()]
        faults = {f: min(r[name] for r in v.values()) for f, v in readings["faults"].items()}
        harness.log(f"{name}: program max {max(prog):.6g} over {len(prog)} seeds; control min "
                    f"{min(ctrl) if ctrl else float('nan'):.6g}; faults min {faults}")
    if out:
        with open(out, "w") as f:
            json.dump(readings, f, indent=1)
    return readings


if __name__ == "__main__":
    sys.exit(main())
