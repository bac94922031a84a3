"""``lib/spans.py`` on hand-made traces: the device's idle time under one
span over a known gap, under overlapping spans, and the spans of an
earlier try left out; the span readers with and without the program's
recorder.  On the card: a wait under a span reads as idle, on the
profiler's clock."""

import time
from types import SimpleNamespace

import pytest
import torch

from lib import spans as lspans
from lib import spec
from lib.trace import Op, Trace

from nerf_prv_tpu_torch.utils import timing

READERS = ("train.prep_idle_s", "train.step_idle_ms", "eval.render_idle_ms_per_frame", "eval.score_idle_ms_per_frame")


def _trace(device, host=()):
    return Trace([Op("k", lo, hi) for lo, hi in device], {1: [Op("aten::op", lo, hi) for lo, hi in host]},
                 {}, {}, True, 1.0, 1)


def _span(name, lo, hi, i=1, parent=None, root=1):
    return timing.Span(name, lo, hi, i, parent, root)


def test_one_span_over_a_known_gap():
    t = _trace([(0, 100), (300, 400)])
    assert lspans.idle_under(t, [_span("s", 50, 350)], "s") == 200  # 100..300
    assert lspans.idle_under(t, [_span("s", 100, 300)], "s") == 200
    assert lspans.idle_under(t, [_span("s", 0, 100)], "s") == 0  # all busy
    assert lspans.idle_under(t, [_span("s", 450, 500)], "s") == 50  # after the last op
    assert lspans.idle_under(t, [_span("s", 50, 350)], "other") is None
    assert lspans.idle_under(t, None, "s") is None


def test_overlapping_spans_and_ops_count_once():
    t = _trace([(0, 100), (80, 150), (300, 400)])  # two ops overlap: busy 0..150
    two = [_span("s", 50, 200, 1), _span("s", 150, 350, 2)]  # union 50..350
    assert lspans.idle_under(t, two, "s") == 150  # 150..300
    nested = [_span("s", 50, 350, 1), _span("s", 160, 170, 2, parent=1)]
    assert lspans.idle_under(t, nested, "s") == 150
    assert lspans.idle_under(t, two + [_span("x", 0, 400, 3)], "s") == 150  # another name is not read


def test_union_and_overlap():
    assert lspans.union([(5, 7), (0, 2), (1, 3), (3, 4)]) == [(0, 4), (5, 7)]
    assert lspans.covered_ns([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert lspans.covered_ns([], [(0, 1)]) == 0


def test_spans_outside_the_calls_interval_are_left_out(monkeypatch):
    """The call's interval runs from its earliest to its latest host or
    device event; an earlier try's spans end before it, and a root that
    opens just before the first op still belongs."""
    t = _trace([(1000, 1100), (1500, 1600)], host=[(990, 1010), (1590, 1700)])
    earlier = [_span("train.step", 100, 200, 1), _span("train_batch", 50, 300, 2)]
    this = [_span("train.step", 1050, 1550, 3, parent=4, root=4), _span("train_batch", 980, 1710, 4, root=4)]
    monkeypatch.setattr(timing, "spans", lambda: earlier + this)
    assert lspans.program_spans(t) == this
    assert lspans.idle_under(t, lspans.program_spans(t), "train.step") == 400  # 1100..1500
    assert lspans.program_spans(None) is None
    assert lspans.program_spans(_trace([])) is None  # nothing traced


def test_a_program_without_the_recorder_gives_no_spans(monkeypatch):
    monkeypatch.delattr(timing, "spans")
    assert lspans.program_spans(_trace([(0, 1)])) is None


def _run(trace, **runner):
    cell = SimpleNamespace(traffic=dict(test_views=4))
    return SimpleNamespace(trace=trace, runner=SimpleNamespace(cell=cell, steps_per_call=lambda: 2, **runner))


def test_span_readers(monkeypatch):
    t = _trace([(0, 1_000_000), (3_000_000, 4_000_000)])
    names = ("train.prep", "train.step", "eval.render", "eval.score")
    monkeypatch.setattr(timing, "spans", lambda: [_span(n, 0, 4_000_000, i) for i, n in enumerate(names)])
    got = {m: spec.reader(m)(_run(t)) for m in READERS}
    # 2 ms idle under each span: 0.002 s; over 2 steps 1 ms; over 4 frames 0.5 ms
    assert got == pytest.approx({"train.prep_idle_s": 0.002, "train.step_idle_ms": 1.0,
                                 "eval.render_idle_ms_per_frame": 0.5, "eval.score_idle_ms_per_frame": 0.5})
    for m in READERS:
        assert spec.reader(m)(_run(None)) is None
    monkeypatch.setattr(timing, "spans", lambda: [])
    for m in READERS:
        assert spec.reader(m)(_run(t)) is None
    monkeypatch.delattr(timing, "spans")  # the parent commit's program
    for m in READERS:
        assert spec.reader(m)(_run(t)) is None


def test_a_wait_under_a_span_reads_as_idle_on_the_card(card):
    """A long product, a synchronised 20 ms wait under a span, a second
    product: at least 95% of the device's gap between the two reads as idle
    under the span (a clock offset between the span and the trace would put
    the products' time under it)."""
    from lib import trace as tracing

    a = torch.randn(8192, 8192, device=card)
    (a @ a).sum().item()

    def call():
        a @ a
        torch.cuda.synchronize()
        with timing.span("wait"):
            time.sleep(0.02)
        a @ a

    t = tracing.profile(call)
    spans = lspans.program_spans(t)
    (wait,) = [s for s in spans if s.name == "wait"]
    mid = (wait.start_ns + wait.end_ns) // 2
    gap = min(op.start for op in t.device_ops if op.start >= mid) - max(op.end for op in t.device_ops if op.end <= mid)
    idle = lspans.idle_under(t, spans, "wait")
    products = [op.end - op.start for op in t.device_ops]
    print(f"gap {gap} ns, idle under the span {idle} ns ({100 * idle / gap:.3f}%), span "
          f"{wait.end_ns - wait.start_ns} ns, products {products} ns")
    assert max(products) > 2_000_000  # long enough that an offset would show
    assert 20_000_000 <= gap and 0.95 * gap <= idle <= gap
