"""Fixtures of the benchmark's own tests (run with ``python -m pytest
portbench/tests``): the harness on ``sys.path``, cells cut to a size the CPU
runs in seconds, and the card fixture that skips where there is none."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


def tiny(name: str, **traffic):
    """Cell ``name`` at a CPU size, as its kind cuts it (``cpu_cut`` of
    ``kinds/<kind>.py``), with ``traffic`` over its traffic file."""
    from lib import spec

    c = spec.cell(name)
    c = spec.runner(c.traffic["kind"]).cpu_cut(c)
    return c._replace(traffic=dict(c.traffic, **traffic))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures only on the card")
    return torch.device("cuda", 0)
