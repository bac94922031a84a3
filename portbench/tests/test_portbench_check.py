"""The comparison that decides ``correct``, on the CPU at a small size: the
program's plain path agrees with the reference within each cell's limits;
the control (the reference in float8 where the configuration states
bfloat16, put in the program's place) fails them; and a run with the timed
path broken underneath comes out not correct, once for each fault the cell
can have.  The card's own readings and limits are in PERF.md."""

import numpy as np
import pytest
import torch

import calibrate
import run
from conftest import tiny

CPU = torch.device("cpu")
SEED = 2**31 + 12345
# big enough on the CPU for float8's rounding to stand out of bfloat16's
TRAIN = dict(objects=2, train_views=3)
EVAL = dict(test_views=4, camera=dict(width=160, height=90, fx=915.606689453125 / 8, fy=913.32666015625 / 8,
                                      ppx=647.1453247070312 / 8, ppy=372.51531982421875 / 8))
CELLS = {"voxel-train-k24": TRAIN, "hash-train-k8": TRAIN, "hash-train-k24": TRAIN, "voxel-eval": EVAL,
         "hash-eval": EVAL}


def cell(name):
    c = tiny(name, **CELLS[name])
    # a training's first losses average bfloat16's rounding over an object's
    # rays, so the CPU runs the cell's 4,096 rays an object (a few steps)
    more = (dict(n_steps=60, train_rays=512) if c.traffic["kind"] == "eval"
            else dict(train_rays=4096, n_steps=6, train_warmup_steps=3))
    return c._replace(config=dict(c.config, nerf=dict(c.config["nerf"], **more)))


def correct(c, numbers):
    return all(numbers[k] <= lim for k, lim in c.limits.items())


def _program_in_control_out(c, device):
    r = calibrate.calibrate(c, [SEED], [SEED], device=device)
    prog, ctrl = r["program"][SEED], r["control"][SEED]
    assert correct(c, prog), (prog, c.limits)
    assert not correct(c, ctrl), (ctrl, c.limits)
    for fault, readings in r["faults"].items():
        assert not correct(c, readings[SEED]), (fault, readings[SEED], c.limits)


# hash-eval's one compared number, SSIM, separates float8 from bfloat16 only
# at the cell's size (at the CPU's, float8 moves its SSIM less than bfloat16)
@pytest.mark.parametrize("name", ["voxel-train-k24", "hash-train-k8", "hash-train-k24", "voxel-eval"])
def test_program_within_limits_control_outside(name):
    _program_in_control_out(cell(name), CPU)


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CELLS))
def test_program_within_limits_control_outside_at_the_cells_size(card, name):
    from lib import spec

    _program_in_control_out(spec.cell(name), card)


class _Frozen(torch.optim.Optimizer):
    """An optimizer whose step leaves the parameters as they are."""

    def __init__(self, params):
        super().__init__(params, {})

    def step(self, closure=None):
        return None


def _half_batch_loss(orig):
    from nerf_prv_tpu_torch.nerf import batch_train

    def batch_loss(params, batch, jitter, cfg, generator=None):
        o, d, target, bg = batch
        rgb, acc = batch_train.render_rays(params, o, d, cfg, jitter=jitter, generator=generator)
        per = batch_train._huber(rgb + bg * (1.0 - acc[:, None]) - target, cfg)
        per = per.reshape(batch_train.n_objects(params), -1, 3)
        return per[:, : per.shape[1] // 2].mean(dim=(1, 2))

    return batch_loss


def _altered_frame(orig):
    def render_views(params, origins, rotations, camera, cfg, **kw):
        out = orig(params, origins, rotations, camera, cfg, **kw)
        out[0] = out[0] * 0.5  # the first frame of every group, half as bright
        return out

    return render_views


def _half_frames(orig):
    def evaluate_pair(pred, gt):
        n = max(1, pred.shape[0] // 2)
        return orig(pred[:n], gt[:n])

    return evaluate_pair


TRAIN_CELLS = ("voxel-train-k24", "hash-train-k8", "hash-train-k24")
FAULTS = [
    *[(name, "nerf_prv_tpu_torch.nerf.batch_train", "make_optimizer", lambda orig: (lambda p, cfg: _Frozen(list(p.values()))))
      for name in TRAIN_CELLS],
    *[(name, "nerf_prv_tpu_torch.nerf.batch_train", "batch_loss", _half_batch_loss) for name in TRAIN_CELLS],
    ("voxel-eval", "nerf_prv_tpu_torch.nerf.api", "render_views", _altered_frame),
    ("hash-eval", "nerf_prv_tpu_torch.nerf.api", "render_views", _altered_frame),
    ("voxel-eval", "nerf_prv_tpu_torch.nerf.api", "evaluate_pair", _half_frames),
    ("hash-eval", "nerf_prv_tpu_torch.nerf.api", "evaluate_pair", _half_frames),
]


@pytest.mark.parametrize("name,module,attr,broken", FAULTS, ids=[f"{f[0]}-{f[2]}" for f in FAULTS])
def test_broken_timed_path_is_not_correct(monkeypatch, name, module, attr, broken):
    """A whole run past the look for a card (set-up, window, check) with one
    function of the timed path broken: ``correct`` comes out false."""
    import importlib

    mod = importlib.import_module(module)
    c = cell(name)
    sound = run.run_cell(c, SEED, 0.0, False, CPU)
    assert correct(c, sound["numbers"])
    monkeypatch.setattr(mod, attr, broken(getattr(mod, attr)))
    r = run.run_cell(c, SEED, 0.0, False, CPU)
    assert not correct(c, r["numbers"]), r["numbers"]


def test_a_state_left_unchanged_reads_one():
    """``param_change`` of a step that returns its state unchanged is 1 by
    definition, whatever the reference did."""
    from kinds.train_batch import compare
    from lib.reference import TrainResult

    init = {"sigma_w0": torch.zeros((2, 4, 4))}
    moved = {"sigma_w0": torch.ones((2, 4, 4))}
    want = TrainResult(np.ones((3, 2)), {"sigma_w0": torch.ones(2)}, moved, init)
    assert compare(np.ones((3, 2)), init, want)["param_change"] == 1.0
