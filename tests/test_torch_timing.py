"""The port's span recorder and device trace (``utils/timing.py``): nothing
recorded and no clock read without a profiler; parents, roots and
exceptions; the spans on kineto's clock, in the recorder and in
``device_trace``'s file.  The spans of ``train_batch`` and ``eval_nerf``:
``test_torch_batch_train.py``."""

import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nerf_prv_tpu_torch.utils import timing

torch.set_num_threads(1)  # six test workers share the host's cores


@pytest.fixture(autouse=True)
def empty_buffer():
    timing.drain()
    yield
    timing.drain()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _by_name(recorded):
    return {s.name: s for s in recorded}


def test_span_without_a_profiler_records_nothing_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("a clock was read with no profiler running")

    monkeypatch.setattr(time, "time_ns", no_clock)
    assert not torch._C._autograd._profiler_enabled()
    with timing.span("outer"):
        with timing.span("inner"):
            pass
    assert timing.span("a") is timing.span("b")  # one shared context, nothing made
    assert timing.spans() == [] and timing.drain() == []


def test_span_parents_and_roots():
    with _cpu_profile():
        with timing.span("a"):
            with timing.span("b"):
                with timing.span("c"):
                    pass
            with timing.span("d"):
                pass
        with timing.span("e"):
            pass
    got = timing.drain()
    assert [s.name for s in got] == ["c", "b", "d", "a", "e"]  # in the order they closed
    s = _by_name(got)
    assert s["a"].parent is None and s["a"].root == s["a"].id
    assert s["b"].parent == s["a"].id and s["d"].parent == s["a"].id and s["c"].parent == s["b"].id
    assert {s[n].root for n in "abcd"} == {s["a"].id}
    assert s["e"].parent is None and s["e"].root == s["e"].id != s["a"].id
    for x in got:
        assert x.start_ns <= x.end_ns
    assert s["a"].start_ns <= s["b"].start_ns <= s["c"].start_ns <= s["c"].end_ns <= s["b"].end_ns
    assert s["b"].end_ns <= s["d"].start_ns and s["d"].end_ns <= s["a"].end_ns <= s["e"].start_ns
    assert timing.spans() == []


def test_span_closes_when_an_exception_leaves_it():
    with _cpu_profile():
        with pytest.raises(ValueError):
            with timing.span("outer"):
                with timing.span("inner"):
                    raise ValueError("left the span")
        with timing.span("after"):
            pass
    s = _by_name(timing.drain())
    assert set(s) == {"outer", "inner", "after"}
    assert s["inner"].parent == s["outer"].id and s["inner"].end_ns <= s["outer"].end_ns
    assert s["after"].parent is None  # the stack was unwound


def test_spans_share_kinetos_clock():
    """Every kineto ``aten::`` event run inside a span lies inside it."""
    a = torch.randn(300, 300)
    with _cpu_profile() as prof:
        for i in range(3):
            with timing.span(f"mm{i}"):
                a @ a
            with timing.span(f"add{i}"):
                a + 1.0
    s = _by_name(timing.drain())
    events = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("aten::")]
    for op, kind in (("aten::mm", "mm"), ("aten::add", "add")):
        ops = sorted((e for e in events if e.name() == op), key=lambda e: e.start_ns())
        assert len(ops) == 3, [e.name() for e in events]
        for i, e in enumerate(ops):
            sp = s[f"{kind}{i}"]
            assert sp.start_ns <= e.start_ns() and e.start_ns() + e.duration_ns() <= sp.end_ns, (op, i)


def test_device_trace_writes_the_spans_beside_kinetos_events(tmp_path):
    with timing.span("before"):  # no profiler yet: not recorded
        pass
    x = torch.randn(200, 200)
    with timing.device_trace(str(tmp_path / "trace")):
        with timing.span("outer"):
            torch.ones(4).sum()
            with timing.span("inner"):
                x @ x
    path = tmp_path / "trace" / "trace.json"
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    mine = [e for e in events if e.get("cat") == "program_span"]
    assert sorted(e["name"] for e in mine) == ["inner", "outer"]
    assert len({(e["pid"], e["tid"]) for e in mine}) == 1  # one track
    track = [e for e in events if e.get("ph") == "M" and e.get("name") == "thread_name"
             and (e["pid"], e["tid"]) == (mine[0]["pid"], mine[0]["tid"])]
    assert track and track[0]["args"]["name"] == "program spans"
    s = {e["name"]: e for e in mine}
    assert s["inner"]["args"]["parent"] == s["outer"]["args"]["id"]

    def within(op, sp):
        return sp["ts"] <= op["ts"] and op["ts"] + op["dur"] <= sp["ts"] + sp["dur"]

    ops = {e["name"]: e for e in events if e.get("cat") == "cpu_op" and e["name"] in ("aten::sum", "aten::mm")}
    assert within(ops["aten::mm"], s["inner"]) and within(ops["aten::mm"], s["outer"])
    assert within(ops["aten::sum"], s["outer"]) and not within(ops["aten::sum"], s["inner"])
