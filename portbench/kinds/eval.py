"""Traffic kind ``eval``: one object's trained field scored on a test set,
one ``nerf_prv_tpu_torch.nerf.api.eval_nerf(params, test_ds, cfg)`` call per
unit of work.

Traffic keys: ``train_views`` and ``test_views`` of the object, ``points``,
``point_size``, ``radius``, ``elevation_deg`` and ``camera`` as for
``train_batch``.

The field's weights are the benchmark's: set-up trains them from the seed
with the reference (the configuration's ``n_steps`` on the training views),
so that their occupancy is a trained object's, and hands the same weights
to the program and to the check.  That fit is the reference's work, not
the program's: its seconds (``reference_s``) are left out of ``setup_s``.  Every eval of the window is judged: the
reference renders and scores the same frames once, in float32.
"""

from __future__ import annotations

import time

import numpy as np
import torch

# the NeRF kinds read one configuration and share one CPU cut
from kinds.train_batch import CONFIG_KEYS, cpu_cut  # noqa: F401
from lib import arith, program, scene
from lib.clock import log
from lib.reference import Ref, TrainData, eval_views

SCORES = ("PSNR", "SSIM", "PSNR_avgmse", "min_PSNR", "max_PSNR")
WARM_FRAMES = 16


class Runner:
    unit = "rays"

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.nerf = cell.config["nerf"]
        tr = cell.traffic
        self.cam = scene.Camera(**tr["camera"])
        (obj,), (az,) = scene.seeds(seed, "objects", 1), scene.azimuths(seed, "objects", 1)

        def views(n, tag):
            return scene.object_views(obj, n, az + tag, self.cam, tr["points"], tr["point_size"], tr["radius"],
                                      tr["elevation_deg"], self.device)

        # the test spiral is turned half a golden angle from the training one
        self.train_views = views(tr["train_views"], 0.0)
        self.test_views = views(tr["test_views"], scene.GOLDEN_ANGLE / 2)
        self.units_per_call = tr["test_views"] * self.cam.width * self.cam.height
        self.counts = None
        log(f"{tr['train_views']} + {tr['test_views']} frames splatted")

    def setup(self) -> None:
        self.build_s = program.build(self.cell.config["kernels"], self.device)
        log(f"kernels built in {self.build_s:.3f} s")
        t0 = time.perf_counter()
        fit = Ref(self.nerf).train(TrainData([self.train_views], self.cam, self.device),
                                   scene.seeds(self.seed, "fit", 1)[0])
        self.params = {name: v[0].contiguous() for name, v in fit.params.items()}
        del fit
        program.sync(self.device)
        self.reference_s = time.perf_counter() - t0
        log(f"weights fitted by the reference in {self.reference_s:.3f} s (not set-up)")
        self.cfg = program.nerf_config(self.nerf)
        self.test_ds = program.ray_dataset(self.test_views, self.cam)
        self.eval_nerf = program.entry("nerf_prv_tpu_torch.nerf.api", "eval_nerf")
        warm = self.test_views._replace(origins=self.test_views.origins[:WARM_FRAMES],
                                        rotations=self.test_views.rotations[:WARM_FRAMES],
                                        pixels=self.test_views.pixels[:WARM_FRAMES])
        self.eval_nerf(self.params, program.ray_dataset(warm, self.cam), self.cfg)
        program.sync(self.device)
        log("warmed up")

    def call(self, i: int):
        return self.eval_nerf(self.params, self.test_ds, self.cfg)  # floats: the eval has ended

    def judged(self, n_calls: int):
        return None  # every eval

    def flops_per_call(self):
        """Known once the check has counted the rays the probes keep."""
        if self.counts is None:
            return None
        return arith.eval_flops(self.nerf, *self.counts)

    def reference(self, lowp: str = "float32", fault: str = ""):
        """The reference's eval of the same field and frames; with ``lowp``
        or ``fault``, the control or a planted fault put in the program's place."""
        return Ref(self.nerf, lowp).evaluate(self.params, eval_views(self.test_views, self.cam, self.device), fault)

    def readings(self, result, with_control: bool) -> tuple:
        """The numbers of one eval's ``result``, and with ``with_control`` the
        control's and each fault's, against one reference eval."""
        want = self.reference()
        program = compare([result], want.scores)
        if not with_control:
            return program, None, {}
        control = compare([self.reference(lowp="float8").scores], want.scores)
        return program, control, {f: compare([self.reference(fault=f).scores], want.scores) for f in ("frame", "half")}

    def check(self, results: dict) -> dict:
        """The widest gap of each score over the window's evals against the
        reference's scores of the same frames."""
        self.test_ds = None
        want = self.reference()
        self.counts = (want.sphere_hits, want.marched, want.samples)
        log(f"{len(results)} evals checked")
        return compare(list(results.values()), want.scores)


def compare(got: list, want: dict) -> dict:
    out = {}
    for key in SCORES:
        vals = np.array([g[key] for g in got], np.float64)
        out[key.lower() + "_gap"] = float(np.abs(vals - want[key]).max()) if np.isfinite(vals).all() else float("inf")
    return out
