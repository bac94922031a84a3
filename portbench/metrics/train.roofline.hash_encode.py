"""The hash-encode kernels' (K1 and K1b) share of their roofline in the
traced training call: the least time a launch needs (``arith.encode_bound_s``:
the points, the distinct table rows they read and the features written once;
``arith.backward_bound_s``: the points and the output gradient read and the
whole table gradient written once; or their float32 arithmetic) over its
device time (K1b with the memset that zeroes its output), summed over an
evenly spaced sample of at most 256 launches of each kernel (from the one in
eight whose points the trace keeps): counting the
rows of every one of a call's thousands of launches would outlast the run."""

from lib import arith
from lib.trace import kernel_times

SAMPLE = 256


def read(run):
    t, pk = run.trace, run.peaks
    if t is None or pk is None or not t.complete:
        return None
    hbm, f32 = pk["hbm_bytes_per_s"], pk["f32_flops_per_s"]
    grid = run.cell.config["nerf"]["grid"]
    bound = ns = 0.0
    for name in ("hash_encode", "hash_encode_backward"):
        pairs = [(a, dt) for a, dt in zip(t.launches.get(name, []), kernel_times(t, name)) if a["x"] is not None]
        for a, dt in pairs[::max(1, len(pairs) // SAMPLE)]:
            if name == "hash_encode":
                bound += arith.encode_bound_s(a["x"], grid, hbm, f32)
            else:
                bound += arith.backward_bound_s(a["n"], grid, hbm, f32)
            ns += dt
    return 100.0 * bound / (ns / 1e9) if ns else None
