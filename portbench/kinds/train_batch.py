"""Traffic kind ``train_batch``: K objects' fields trained together, one
``nerf_prv_tpu_torch.nerf.batch_train.train_batch(datasets, cfg, seed)`` call
per unit of work, each call from its own seed and fresh fields.

Traffic keys: ``objects`` (K), ``train_views`` per object, ``points`` and
``point_size`` of the splatted blob, ``radius`` and ``elevation_deg`` of the
views, ``camera`` (pinhole intrinsics).

The check judges one call of the window, drawn from the seed: the reference
replays that call's seed (the same initial parameters and the same rays,
backgrounds and jitter) in float32 and the call's outputs are held to it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lib import arith, program, scene
from lib.clock import log
from lib.reference import Ref, TrainData

# the configuration keys the NeRF kinds read (``train_batch`` and ``eval``)
CONFIG_KEYS = {"nerf": ("field_impl", "hidden", "n_steps", "train_rays", "compute_dtype"), "kernels": ()}
CPU_CAMERA = dict(width=64, height=36, fx=915.606689453125 / 20, fy=913.32666015625 / 20,
                  ppx=647.1453247070312 / 20, ppy=372.51531982421875 / 20)


def cpu_cut(cell):
    """A NeRF cell at a CPU size for the tests: a 12^3 voxel grid, a
    2^12-entry hash table a level, 12 steps of 128 rays, 2 objects of 3
    views at 64x36."""
    nerf = dict(cell.config["nerf"], voxel_grid_size=12, train_rays=128, n_steps=12, train_warmup_steps=4,
                train_warmup_samples=8, n_samples=6, train_coarse=4, render_coarse=6, render_probe_fine=6,
                grid=dict(cell.config["nerf"]["grid"], log2_table=12))
    tr = dict(cell.traffic, objects=2, train_views=3, test_views=3, points=3000, camera=CPU_CAMERA)
    return cell._replace(config=dict(cell.config, nerf=nerf), traffic=tr)


class Runner:
    unit = "object-steps"
    reference_s = 0.0  # set-up spends nothing on the reference

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.nerf = cell.config["nerf"]
        tr = cell.traffic
        self.k = tr["objects"]
        self.cam = scene.Camera(**tr["camera"])
        self.views = [
            scene.object_views(s, tr["train_views"], a, self.cam, tr["points"], tr["point_size"], tr["radius"],
                               tr["elevation_deg"], self.device)
            for s, a in zip(scene.seeds(seed, "objects", self.k), scene.azimuths(seed, "objects", self.k))]
        self.units_per_call = self.k * self.nerf["n_steps"]
        log(f"{self.k} objects' {tr['train_views']} frames splatted")

    def call_seed(self, i: int) -> int:
        return scene.seeds(self.seed, f"call{i}", 1)[0]

    def setup(self) -> None:
        self.build_s = program.build(self.cell.config["kernels"], self.device)
        log(f"kernels built in {self.build_s:.3f} s")
        self.cfg = program.nerf_config(self.nerf)
        self.datasets = [program.ray_dataset(v, self.cam) for v in self.views]
        self.train_batch = program.entry("nerf_prv_tpu_torch.nerf.batch_train", "train_batch")
        log("datasets made")
        # every shape of a step: one step of each phase, on one frame an
        # object (a step's shapes do not depend on the frames)
        one = [program.ray_dataset(v._replace(origins=v.origins[:1], rotations=v.rotations[:1],
                                              pixels=v.pixels[:1]), self.cam) for v in self.views]
        warm = dataclasses.replace(self.cfg, n_steps=2, train_warmup_steps=1)
        self.train_batch(one, warm, seed=self.call_seed(-1), device=self.device)
        program.sync(self.device)
        log("warmed up")

    def call(self, i: int):
        params, losses = self.train_batch(self.datasets, self.cfg, seed=self.call_seed(i), device=self.device)
        return params, losses  # the losses come back to the host: the call has ended

    def flops_per_call(self) -> float:
        return arith.train_flops(self.nerf, self.k)

    def steps_per_call(self) -> int:
        return self.nerf["n_steps"]

    # ----------------------------------------------------------------- check
    def judged(self, n_calls: int) -> int:
        return scene.seeds(self.seed, "judged", 1)[0] % n_calls

    def reference_data(self) -> TrainData:
        return TrainData(self.views, self.cam, self.device)

    def reference(self, i: int, lowp: str = "float32", fault: str = ""):
        """The reference's replay of call ``i``'s seed; with ``lowp`` or
        ``fault``, the control or a planted fault put in the program's place."""
        return Ref(self.nerf, lowp).train(self.reference_data(), self.call_seed(i), keep_init=True, fault=fault)

    def readings(self, result, with_control: bool) -> tuple:
        """The numbers of call 0's ``result``, and with ``with_control`` the
        control's and each fault's, against one replay of the call's seed."""
        want = self.reference(0)
        params, losses = result
        program = compare(losses, params, want)
        if not with_control:
            return program, None, {}
        v = self.reference(0, lowp="float8")
        control = compare(v.losses, v.params, want)
        v = self.reference(0, fault="half")
        return program, control, {"half_batch": compare(v.losses, v.params, want)}

    def check(self, results: dict) -> dict:
        """The numbers compared for the judged call (the one in
        ``results``): its step losses and parameter changes against the
        reference's replay of its seed."""
        (i, (params, losses)), = results.items()
        out = compare(losses, params, self.reference(i))
        log(f"call {i} checked")
        return out


def compare(losses: np.ndarray, params: dict, want) -> dict:
    """``loss_steps_1_3``: the widest relative gap of a step's loss, steps
    1-3, any object; ``loss_last_100``: the widest relative gap of an
    object's mean loss over the last 100 steps; ``param_change``: the widest
    gap between the norms of a leaf's change from its initial value (a
    leaf: one parameter tensor of one object), over the reference's norm of
    that leaf or of the median leaf, whichever is larger.  Leaves whose
    first gradient in the reference is under a thousandth of the median
    leaf's are left out of ``param_change``."""
    losses = np.asarray(losses, np.float64)
    ref_l = np.asarray(want.losses, np.float64)
    if losses.shape != ref_l.shape or not np.isfinite(losses).all():
        return dict(loss_steps_1_3=float("inf"), loss_last_100=float("inf"), param_change=float("inf"))
    first = np.abs(losses[:3] - ref_l[:3]) / ref_l[:3]
    tail = min(100, len(ref_l))
    last = np.abs(losses[-tail:].mean(0) - ref_l[-tail:].mean(0)) / ref_l[-tail:].mean(0)
    g0 = torch.stack([want.grad0[name] for name in want.params]).cpu().numpy()  # (leaves, K)
    moved_p, moved_r = [], []
    for name in want.params:
        init = want.init[name]
        k = init.shape[0]
        got = params[name].to(init.device, torch.float32)
        moved_p.append((got - init).reshape(k, -1).norm(dim=1).cpu().numpy())
        moved_r.append((want.params[name] - init).reshape(k, -1).norm(dim=1).cpu().numpy())
    moved_p, moved_r = np.array(moved_p, np.float64), np.array(moved_r, np.float64)
    keep = g0 >= 1e-3 * np.median(g0)
    floor = np.median(moved_r[keep])
    change = np.abs(moved_p - moved_r)[keep] / np.maximum(moved_r[keep], floor)
    return dict(loss_steps_1_3=float(first.max()), loss_last_100=float(last.max()),
                param_change=float(change.max()))
