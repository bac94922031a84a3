"""The row kernels' share of their roofline in the traced training call:
the least time every row_gather and row_scatter_add launch needs at the
card's published HBM rate (``arith.gather_bound_s``, ``scatter_bound_s``:
the indices, the distinct rows a gather names and its output, or a
scatter-add's updates and whole output, each moved once), summed, over the
launches' summed device time (a scatter-add with the memset that zeroes its
output)."""

from lib import arith
from lib.trace import kernel_times


def read(run):
    t, pk = run.trace, run.peaks
    if t is None or pk is None or not t.complete:
        return None
    hbm, f32 = pk["hbm_bytes_per_s"], pk["f32_flops_per_s"]
    bound = ns = 0.0
    for a, dt in zip(t.launches.get("row_gather", []), kernel_times(t, "row_gather")):
        bound += arith.gather_bound_s(a["idx"], a["row_bytes"], hbm)
        ns += dt
    for a, dt in zip(t.launches.get("row_scatter_add", []), kernel_times(t, "row_scatter_add")):
        bound += arith.scatter_bound_s(a["n"], a["idx_bytes"], a["width"], a["n_rows"], hbm, f32)
        ns += dt
    return 100.0 * bound / (ns / 1e9) if ns else None
