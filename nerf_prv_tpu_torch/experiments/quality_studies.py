"""The NeRF quality studies of ``experiments/``: each script's table of
``NerfConfig`` arms, trained on the quality scenes and scored on their test
sets, and the runner that trains each field once.

The tables copy each script's labels and keywords verbatim (held by
``tests/test_torch_quality_studies.py``, which parses the scripts):
- ``exp_hashgrid_r3.py:89-107`` (``field_impl`` voxel / hash, both scenes,
  seeds 0-1), ``exp_thin_geometry.py:90-94``, ``exp_quality.py:39-46`` (five
  train arms x render 32 / 24), ``exp_trainrays.py:32-38`` and
  ``exp_gridsize.py:31-37``;
- the studies whose decisions set today's defaults:
  ``exp_adam_lowp.py:109-121`` (f32 / bf16 moments; bf16 at the unroll its
  speed phase chose, ``adam_lowp.json``'s ``bf16_best_unroll``),
  ``exp_train16.py:78-82``, ``exp_render20.py:38-47``,
  ``exp_warmup2.py:77-81`` and ``exp_warmup3.py:78-82``;
- the rest that train on these scenes: ``exp_train24.py:44-48`` (the splat
  scene and ``exp_share_march.py``'s thin scene, seed 1), ``exp_warmup.py:32-39``,
  ``exp_pe.py:52-58`` (``voxel_pe_freqs`` 4 / 2 x ``render_n_samples`` 32 / 24,
  the 24-sample arm twice, at the two render chunks the script timed) and the
  quality half of ``exp_baked_probe.py:92-95`` (``train_probe_refresh`` 0 /
  16 / 8).
Their speed halves (step and render times on the bench scene) are the
benchmark's and are not here.

**Shared fields.**  ``train`` reads only :data:`TRAIN_OPTIONS` of a
``NerfConfig`` (found from ``nerf/train.py`` and what it calls, and held by
recording every read of a training run in the tests).  The runner trains one
field per (scene, those options, seed) and evaluates it under every arm that
differs only in other options, so such deltas are exact, as
``exp_render20.py`` intended.  Arms that equal another arm under today's
defaults (``exp_train16.py``'s "s16 p8" and "s16 p12" are ``NerfConfig()``)
keep their labels and share its field and evaluation; the result says which.

    run_study("render20", root, device="cuda", workers=6)

writes ``<root>/results/<name>.json``: per arm its keywords, field and
evaluation, and per "scene/sN" the PSNR, SSIM, ``min_PSNR``, train and eval
seconds the script prints; for ``hashgrid_r3`` and ``adam_lowp`` also the
script's own artifact keys (``artifact``), with its rounding, stats and gate.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np

from ..nerf.model import NerfConfig
from .quality_scenes import write_named
from .real_object import ARTIFACTS
from .runs import KERNELS, card_line, run_jobs, write_json

# Every NerfConfig option that nerf/train.py::train and what it calls read: the phases and the sampler
# (train.py), the optimizer (make_optimizer), the training march (render.render_rays with jitter, the baked
# probe), the field (model.py, voxelfield.py, hashgrid.py) and its initialisation.  No render_* option, and
# neither train_rng nor train_scan_unroll nor train_hit_oversample (JAX-only mechanisms the port does not have).
TRAIN_OPTIONS = (
    "grid", "hidden", "geo_features", "n_samples", "n_importance", "train_coarse", "train_probe_refresh",
    "train_warmup_steps", "train_warmup_samples", "train_warmup_rays", "train_rays", "n_steps", "lr",
    "weight_decay", "adam_moment_dtype", "huber_delta", "compute_dtype", "encode_impl", "field_impl",
    "voxel_grid_size", "voxel_features", "voxel_pe_freqs", "voxel_grad_impl", "voxel_gather_dtype", "bound",
)
METRICS = ("PSNR", "SSIM", "min_PSNR")
# the voxel arms' kernels and the hash arm's two
QUALITY_KERNELS = KERNELS + ("hash_encode", "hash_encode_backward")


def _bf16_unroll() -> int:
    """The unroll ``exp_adam_lowp.py``'s speed phase chose for its bf16 arm
    (``:85-86``), from its committed artifact."""
    with open(os.path.join(ARTIFACTS, "adam_lowp.json")) as f:
        return int(json.load(f)["bf16_best_unroll"])


@dataclasses.dataclass(frozen=True)
class Study:
    """One script's quality table: ``arms`` maps each label to the
    ``NerfConfig`` keywords the script gives it; the fields train on
    ``scenes`` at the script's own ``seeds``."""

    script: str
    scenes: tuple
    seeds: tuple
    arms: dict
    artifact: str = ""


def _quality_arms() -> dict:
    train = {"tight16+48": dict(train_coarse=16, n_samples=48), "tight24+48": dict(train_coarse=24, n_samples=48),
             "tight16+32": dict(train_coarse=16, n_samples=32), "tight24+32": dict(train_coarse=24, n_samples=32),
             "tight16+24": dict(train_coarse=16, n_samples=24)}
    render = {"r32": 32, "r24": 24}
    return {f"{t} {r}": dict(kw, render_n_samples=ns) for t, kw in train.items() for r, ns in render.items()}


def _pe_arms() -> dict:
    return {f"pe{pe} r{ns} c{chunk >> 10}k": dict(voxel_pe_freqs=pe, render_n_samples=ns)
            for pe in (4, 2) for ns, chunk in ((32, 1 << 17), (24, 1 << 17), (24, 1 << 18))}


SPLAT, BOTH = ("splat",), ("splat", "thin")
STUDIES = {
    "hashgrid_r3": Study("experiments/exp_hashgrid_r3.py:89-107", BOTH, (0, 1),
                         {f: dict(field_impl=f) for f in ("voxel", "hash")}, artifact="hashgrid_r3.json"),
    "thin_geometry": Study("experiments/exp_thin_geometry.py:90-94", ("thin",), (0,), {
        "blk2 rp32 (prod)": {}, "blk2 rp24": dict(render_probe_fine=24), "blk2 rp20": dict(render_probe_fine=20)}),
    "quality": Study("experiments/exp_quality.py:39-46", SPLAT, (0,), _quality_arms()),
    "trainrays": Study("experiments/exp_trainrays.py:32-38", SPLAT, (0,), {
        "r4096 p24 (prod)": {}, "r3072 p24": dict(train_rays=3072), "r2048 p24": dict(train_rays=2048),
        "r4096 p16": dict(train_coarse=16), "r2048 p16": dict(train_rays=2048, train_coarse=16)}),
    "gridsize": Study("experiments/exp_gridsize.py:31-37", SPLAT, (0,), {
        "G40 (prod)": {}, "G32": dict(voxel_grid_size=32), "G36": dict(voxel_grid_size=36),
        "G32 p2fine12": dict(voxel_grid_size=32, render_probe_fine=12), "G40 p2fine12": dict(render_probe_fine=12)}),
    "adam_lowp": Study("experiments/exp_adam_lowp.py:109-121", BOTH, (0, 1, 2, 3, 4, 5), {
        "f32": {}, "bf16": dict(adam_moment_dtype="bfloat16", train_scan_unroll=_bf16_unroll())},
        artifact="adam_lowp.json"),
    "train16": Study("experiments/exp_train16.py:78-82", BOTH, (0, 1), {
        "s24 p8 (prod)": {}, "s20 p8": dict(n_samples=20), "s16 p8": dict(n_samples=16),
        "s16 p12": dict(n_samples=16, train_coarse=12)}),
    "render20": Study("experiments/exp_render20.py:38-47", BOTH, (0, 1), {
        "rp24 rs24 (prod)": {}, "rp24 rs16": dict(render_n_samples=16),
        "rp20 rs16": dict(render_probe_fine=20, render_n_samples=16),
        "rp16 rs16": dict(render_probe_fine=16, render_n_samples=16)}),
    "warmup2": Study("experiments/exp_warmup2.py:77-81", BOTH, (0, 1), {
        "w125x48 (prod)": {}, "w125x24": dict(train_warmup_samples=24), "w64x48": dict(train_warmup_steps=64),
        "none": dict(train_warmup_steps=0)}),
    "warmup3": Study("experiments/exp_warmup3.py:78-82", BOTH, (0, 1), {
        "wr4096 (prod)": {}, "wr3072": dict(train_warmup_rays=3072), "wr2048": dict(train_warmup_rays=2048)}),
    "train24": Study("experiments/exp_train24.py:44-48", ("splat", "thin_s1"), (0,), {
        "t-base": {}, "t24": dict(n_samples=24), "t24p8": dict(n_samples=24, train_coarse=8)}),
    "warmup": Study("experiments/exp_warmup.py:32-39", SPLAT, (0,), {
        "w500s96 (prod)": {}, "w500s48": dict(train_warmup_samples=48), "w250s96": dict(train_warmup_steps=250),
        "w250s48": dict(train_warmup_steps=250, train_warmup_samples=48),
        "w125s48": dict(train_warmup_steps=125, train_warmup_samples=48), "w0 (none)": dict(train_warmup_steps=0)}),
    "pe": Study("experiments/exp_pe.py:52-58", SPLAT, (0,), _pe_arms()),
    "baked_probe": Study("experiments/exp_baked_probe.py:92-95", SPLAT, (0,),
                         {f"refresh {r}": dict(train_probe_refresh=r) for r in (0, 16, 8)}),
}


def _diff(cfg: NerfConfig, names) -> dict:
    base = NerfConfig()
    return {k: getattr(cfg, k) for k in names if getattr(cfg, k) != getattr(base, k)}


def _tag(kw: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(kw.items())) or "default"


def field_options(kw: dict) -> dict:
    """The keywords of an arm that training reads (its field's)."""
    return _diff(NerfConfig(**kw), TRAIN_OPTIONS)


def eval_options(kw: dict) -> dict:
    """Every keyword of an arm that changes its ``NerfConfig`` (its
    evaluation's)."""
    return _diff(NerfConfig(**kw), [f.name for f in dataclasses.fields(NerfConfig)])


def field_key(scene: str, seed: int, kw: dict) -> str:
    """One trained field: the scene, the seed and the options training reads."""
    return f"{scene}/s{seed}/{_tag(field_options(kw))}"


def eval_key(kw: dict) -> str:
    return _tag(eval_options(kw))


def plan(seeds_by_study: dict) -> dict:
    """{field key: dict(scene, seed, field keywords, evals {eval key:
    keywords})} over the studies named (``{name: seeds}``)."""
    fields = {}
    for name, seeds in seeds_by_study.items():
        st = STUDIES[name]
        for scene in st.scenes:
            for s in seeds:
                for kw in st.arms.values():
                    f = fields.setdefault(field_key(scene, s, kw),
                                          dict(scene=scene, seed=s, kw=field_options(kw), evals={}))
                    f["evals"][eval_key(kw)] = eval_options(kw)
    return fields


def scene_root(root: str, scene: str) -> str:
    return os.path.join(root, "scenes", scene)


def write_scenes(root: str, scenes, device) -> dict:
    """Each scene under ``<root>/scenes/<name>`` (written where it is not
    complete); {name: (train_json, test_json)}."""
    return {s: write_named(s, scene_root(root, s), device=device) for s in scenes}


def _sync(device) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def train_and_evaluate(train_json: str, test_json: str, kw: dict, evals: dict, seed: int, device) -> dict:
    """Train ``NerfConfig(**kw)`` on ``train_json`` at ``seed``, then score
    it on ``test_json`` under each of ``evals`` ({key: keywords}): the train
    seconds, and per evaluation the PSNR, SSIM, ``min_PSNR`` and seconds."""
    from ..nerf.api import eval_nerf, train_nerf
    from ..nerf.rays import load_dataset

    t0 = time.perf_counter()
    params, _ = train_nerf(train_json, NerfConfig(**kw), seed=seed, device=device)
    _sync(device)
    out = dict(train_seconds=time.perf_counter() - t0, evals={})
    test = load_dataset(test_json, with_images=True)
    for key, ekw in evals.items():
        t0 = time.perf_counter()
        m = eval_nerf(params, test, NerfConfig(**ekw))
        out["evals"][key] = dict({k: float(m[k]) for k in METRICS}, eval_seconds=time.perf_counter() - t0)
    return out


def field_job(job: tuple) -> dict:
    """One planned field in a worker process: (root, key, field, device)."""
    import torch

    root, key, f, device = job
    torch.set_num_threads(1)
    train, test = (os.path.join(scene_root(root, f["scene"]), f"{s}.json") for s in ("train", "test"))
    return dict(key=key, **train_and_evaluate(train, test, f["kw"], f["evals"], f["seed"], device))


def run_fields(root: str, planned: dict, device, workers: int, on_field=None) -> dict:
    """Train and evaluate every planned field ({key: field}), ``workers`` at
    a time; ``on_field(key, result)`` as each finishes.  Returns {key: result}."""
    jobs = [(root, k, f, str(device)) for k, f in planned.items()]
    done = {}
    for rec in run_jobs(field_job, jobs, workers):
        key = rec.pop("key")
        done[key] = rec
        if on_field is not None:
            on_field(key, rec)
    return done


def adam_stats(psnr: dict, seeds) -> dict:
    """``exp_adam_lowp.py:126-140``: per scene and arm the mean, std
    (ddof 1) and min over the seeds, each rounded to 3 decimals; bf16 passes
    a scene where its mean is at least f32's - 0.05 dB and its min at least
    f32's - 0.10 dB; the default flips only on both scenes."""
    stats, flip = {}, True
    for scene in ("splat", "thin"):
        for mode in ("f32", "bf16"):
            v = np.array([psnr[f"{mode}/{scene}/s{s}"] for s in seeds])
            stats[f"{mode}/{scene}"] = {"mean": round(float(v.mean()), 3), "std": round(float(v.std(ddof=1)), 3),
                                        "min": round(float(v.min()), 3)}
        fm, bm = stats[f"f32/{scene}"], stats[f"bf16/{scene}"]
        ok = bm["mean"] >= fm["mean"] - 0.05 and bm["min"] >= fm["min"] - 0.10
        stats[f"gate_bf16_{scene}_ok"] = ok
        flip = flip and ok
    stats["flip_default_to_bf16"] = flip
    return stats


def study_result(name: str, seeds, fields: dict) -> dict:
    """One study from the trained fields: per arm its keywords, its field and
    evaluation (and the arms that share them) and, per "scene/sN" it has,
    what the script prints; with the script's artifact keys where it writes
    a file."""
    st = STUDIES[name]
    arms = {}
    for label, kw in st.arms.items():
        runs = {}
        for scene in st.scenes:
            for s in seeds:
                f = fields.get(field_key(scene, s, kw))
                if f is None:
                    continue
                e = f["evals"][eval_key(kw)]
                runs[f"{scene}/s{s}"] = dict({k: e[k] for k in METRICS}, train_seconds=f["train_seconds"],
                                             eval_seconds=e["eval_seconds"])
        arms[label] = dict(
            config=kw, field=_tag(field_options(kw)), evaluation=eval_key(kw),
            same_field_as=[o for o, okw in st.arms.items() if o != label and field_options(okw) == field_options(kw)],
            same_evaluation_as=[o for o, okw in st.arms.items() if o != label and eval_key(okw) == eval_key(kw)],
            runs=runs)
    out = dict(script=st.script, scenes=list(st.scenes), seeds=list(seeds), arms=arms)
    complete = all(len(a["runs"]) == len(st.scenes) * len(seeds) for a in arms.values())
    if st.artifact == "hashgrid_r3.json" and complete:
        out["artifact"] = {f"{label}/{scene}/s{s}": {"train_seconds": round(r["train_seconds"], 1),
                                                      "PSNR": round(r["PSNR"], 2), "SSIM": round(r["SSIM"], 4)}
                           for label, a in arms.items() for scene in st.scenes for s in seeds
                           for r in [a["runs"][f"{scene}/s{s}"]]}
    if st.artifact == "adam_lowp.json" and complete:
        psnr = {f"{label}/{scene}/s{s}": round(a["runs"][f"{scene}/s{s}"]["PSNR"], 3)
                for label, a in arms.items() for scene in st.scenes for s in seeds}
        out["artifact"] = dict(psnr=psnr, stats=adam_stats(psnr, seeds))
    return out


def run_study(name: str, root: str, seeds=None, device="cuda", workers: int = 1) -> dict:
    """The study ``name`` at ``seeds`` (the script's own by default): its
    scenes written on ``device``, each of its fields trained once and
    evaluated under every arm that shares it, ``workers`` at a time; the
    result (``study_result``, with the card line) in
    ``<root>/results/<name>.json`` and returned."""
    from .label_protocol import require_device
    from .runs import build_kernels

    device = require_device(device)
    seeds = tuple(STUDIES[name].seeds if seeds is None else seeds)
    build_kernels(device, QUALITY_KERNELS)
    write_scenes(root, STUDIES[name].scenes, device)
    fields = run_fields(root, plan({name: seeds}), device, workers)
    out = dict(study_result(name, seeds, fields), card=card_line())
    write_json(os.path.join(root, "results", f"{name}.json"), out)
    return out
