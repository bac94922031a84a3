"""A measurement that finds no card fails and prints no result: it never
times the CPU."""

import shutil
import subprocess
import sys

import pytest
import torch

from lib import spec


def _run(cwd, *args):
    return subprocess.run([sys.executable, *args], capture_output=True, text=True, cwd=cwd, timeout=300)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is here: these runs would measure it")


@pytest.mark.parametrize("workload", [w["name"] for w in spec.benchmark()["workloads"]])
def test_run_without_a_card_exits_nonzero_and_prints_nothing(no_card, workload):
    r = _run(spec.ROOT, "portbench/run.py", "--workload", workload, "--seed", str(2**31 + 5), "--seconds", "1",
             "--trace", "0")
    assert r.returncode == 3 and r.stdout == "", (r.returncode, r.stdout)
    assert "CUDA card" in r.stderr


def test_calibrate_without_a_card_exits_nonzero(no_card):
    r = _run(spec.ROOT, "portbench/calibrate.py", "--workload", "voxel-eval", "--seeds", "1")
    assert r.returncode == 3 and r.stdout == ""


def test_benchmark_alone_prints_no_result(no_card, tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path, "portbench/run.py", "--workload", "voxel-train-k24", "--seed", "7", "--seconds", "1",
             "--trace", "0")
    assert r.returncode != 0 and r.stdout == ""
