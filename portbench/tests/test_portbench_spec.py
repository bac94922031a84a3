"""Every file the benchmark names parses and resolves by name, and
``BENCHMARK.json`` keeps to the shape the harness and the check read."""

import json
import re

import pytest

from lib import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_plain(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_resolves(config):
    """The file holds the keys that the kind of each cell run on it reads
    (its runner module's ``CONFIG_KEYS``), and no others are required."""
    data = spec.load_json(spec.ROOT / config["file"])
    assert data["name"] == config["name"]
    assert sorted(data["reduced"]) == sorted(config["reduced"])
    assert all(NAME.match(k) for k in config["reduced"])
    kinds = {spec.cell(w["name"]).traffic["kind"] for w in BENCH["workloads"] if w["config"] == config["name"]}
    assert kinds, "every configuration is used by a cell"
    for kind in sorted(kinds):
        for key, inner in spec.runner(kind).CONFIG_KEYS.items():
            assert key in data and set(data[key]) >= set(inner), (kind, key)
    assert set(config) == {"name", "source", "file", "reduced", "why"}


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(cell):
    c = spec.cell(cell["name"])
    assert c.chips == 1
    kind = spec.runner(c.traffic["kind"])  # found by the traffic's kind, whatever it is
    assert hasattr(kind, "Runner") and callable(kind.cpu_cut) and isinstance(kind.CONFIG_KEYS, dict)
    ends = {m["name"] for m in c.end_to_end}
    assert "setup_s" in ends and c.traffic["rate_metric"] in ends and len(ends) == 2
    assert c.per_layer, "every cell reports a per-layer metric"
    assert set(c.limits) and all(v > 0 for v in c.limits.values())
    assert len(cell["why"]) <= 200 and set(cell) == {"name", "config", "traffic", "chips", "why"}


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_resolves(metric):
    assert callable(spec.reader(metric["name"]))
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for w in metric["workloads"]:
        assert metric["moves"] in {m["name"] for m in spec.cell(w).end_to_end}


def test_end_to_end_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"])
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_one_layer_name_per_layer():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all("\n" not in name and len(name) <= 200 for name in layers)
