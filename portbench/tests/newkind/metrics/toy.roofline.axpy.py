"""The toy update kernel's share of its roofline in the traced call: two
float32 operands read and the result written once, 12 bytes an element, at
the card's published HBM rate, over the launches' device time."""

from lib.trace import kernel_times


def read(run):
    t, pk = run.trace, run.peaks
    if t is None or pk is None or not t.complete:
        return None
    ns = sum(kernel_times(t, "toy_axpy"))
    moved = sum(12 * a["n"] for a in t.launches.get("toy_axpy", []))
    return 100.0 * moved / pk["hbm_bytes_per_s"] / (ns / 1e9) if ns else None
