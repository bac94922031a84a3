"""Traffic kind ``toy_matmul``: a least-squares fit of one matrix by
gradient descent from zeros, ``steps`` steps a call, each two products on
the rows and one ``toyprog.toy_axpy`` launch for the update.  It reads the
configuration's ``model`` keys and no traffic keys.

The check holds the judged call's matrix to a float64 replay of the same
steps on the host; the control is that replay in float16."""

import importlib

import numpy as np
import torch

CONFIG_KEYS = {"model": ("rows", "width", "steps", "lr")}


def cpu_cut(cell):
    """The cell runs on the CPU in well under a second as it is."""
    return cell


class Runner:
    build_s = 0.0      # Triton builds the kernel inside the warm-up
    reference_s = 0.0

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        m = cell.config["model"]
        self.rows, self.width, self.steps, self.lr = m["rows"], m["width"], m["steps"], m["lr"]
        self.units_per_call = self.steps

    def setup(self) -> None:
        g = torch.Generator(device=self.device).manual_seed(self.seed)
        self.x = torch.randn((self.rows, self.width), generator=g, device=self.device)
        self.y = torch.randn((self.rows, self.width), generator=g, device=self.device)
        self.axpy = importlib.import_module("toyprog").toy_axpy
        self.call(-1)

    def call(self, i: int):
        w = torch.zeros((self.width, self.width), device=self.device)
        for _ in range(self.steps):
            w = self.axpy(-self.lr / self.rows, self.x.T @ (self.x @ w - self.y), w)
        return w.cpu()  # the matrix comes back to the host: the call has ended

    def steps_per_call(self) -> int:
        return self.steps

    def judged(self, n_calls: int) -> int:
        return n_calls - 1

    def reference(self, dtype=np.float64) -> np.ndarray:
        x, y = self.x.cpu().numpy().astype(dtype), self.y.cpu().numpy().astype(dtype)
        w = np.zeros((self.width, self.width), dtype)
        for _ in range(self.steps):
            w = w - dtype(self.lr / self.rows) * (x.T @ (x @ w - y))
        return w.astype(np.float64)

    @staticmethod
    def compare(w: np.ndarray, want: np.ndarray) -> dict:
        """``weight_gap``: the widest gap of an element over the reference's
        largest element."""
        return dict(weight_gap=float(np.abs(w - want).max() / np.abs(want).max()))

    def readings(self, result, with_control: bool) -> tuple:
        want = self.reference()
        program = self.compare(result.numpy().astype(np.float64), want)
        if not with_control:
            return program, None, {}
        return program, self.compare(self.reference(np.float16), want), {}

    def check(self, results: dict) -> dict:
        (w,) = results.values()
        return self.compare(w.numpy().astype(np.float64), self.reference())
