"""Reference runs of the JAX package on the CPU, beside the port's card runs.

Not a test module (pytest collects ``test_*.py`` only): a script that imports
both packages, as only the tests may.  It answers where a gap between the
port's card results and the committed artifacts lies: in the port, or between
today's JAX package and the run that wrote the artifacts (a TPU).

    # the label protocol (experiments/exp_label_spread.py) on the CPU, full width:
    JAX_PLATFORMS=cpu python tests/jax_reference_runs.py labels --root WS cup0 nos7
    # then its labels and per-count PSNRs into labels_check.json, under "jax_cpu":
    python tests/jax_reference_runs.py merge-labels --root WS
    # one protocol field (320x180, NerfConfig(n_steps=STEPS)) on both packages on
    # the CPU, from the port's coverage sets of OBJ at NV views and 100:
    JAX_PLATFORMS=cpu python tests/jax_reference_runs.py field --root WS --obj uni11 --views 28 \\
        --steps 1200 --seeds 0 1 --package jax
    JAX_PLATFORMS=cpu python tests/jax_reference_runs.py field ... --package port
    # then every such field into fields_cpu.json, beside the committed PSNR and
    # the port's card runs of the same (object, budget):
    python tests/jax_reference_runs.py merge-fields --root WS
    # the tiny@180 recipe's two stages cut in size (ConvNeXt-V2 atto, crop 32,
    # 2 + 150 epochs), by each package's trainer on the CPU, on the corpus's
    # dataset as the port renders it (once, under WS/corpus), any number of
    # processes a package and seed:
    JAX_PLATFORMS=cpu python tests/jax_reference_runs.py trainers --root WS --package jax --seeds 0
    python tests/jax_reference_runs.py merge-trainers --root WS
    # one field of the textured torus's production protocol (1280x720, 2,500
    # steps) on both packages on the CPU, from the port's coverage sets at NV
    # views and 100, then into real_object_cpu.json beside the card's runs:
    JAX_PLATFORMS=cpu python tests/jax_reference_runs.py real-object --root WS --views 25 --steps 2500 \\
        --seeds 0 1 --package jax
    python tests/jax_reference_runs.py merge-real-object --root WS --views 25 --steps 2500
    # the quality studies' scenes (splat, thin at seeds 0 and 1, bench.py's) by the JAX
    # writers on the CPU: the generate_hemisphere views they draw, shipped as .npy under
    # nerf_prv_tpu_torch/experiments/viewspace/quality/, and the sha256 of every PNG and JSON
    # into quality_scenes_cpu.json:
    JAX_PLATFORMS=cpu python tests/jax_reference_runs.py quality-scenes --root WS
    # NerfConfig() at seed 0 on one quality scene by one package on the CPU (2,500 steps),
    # then every such field into quality_cpu.json beside the committed six-seed record:
    JAX_PLATFORMS=cpu python tests/jax_reference_runs.py quality --root WS --scene splat --package jax
    python tests/jax_reference_runs.py merge-quality --root WS

Each writes ``<root>/<what>.json``; a full label protocol takes about 75
minutes an object on three CPU threads, a 1,200-step field 5-7 minutes.
"""

import argparse
import json
import os
import platform
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(REPO, "nerf_prv_tpu_torch", "experiments", "results")
LABELS_CHECK = os.path.join(RESULTS, "labels_check.json")
PILOT2_CHECK = os.path.join(RESULTS, "label_spread_pilot2_check.json")
FIELDS_CPU = os.path.join(RESULTS, "fields_cpu.json")
TRAINERS_CPU = os.path.join(RESULTS, "trainers_cpu.json")
QUALITY_SCENES_CPU = os.path.join(RESULTS, "quality_scenes_cpu.json")
QUALITY_CPU = os.path.join(RESULTS, "quality_cpu.json")
CUT = dict(arch="convnextv2_atto", image_size=32, batch_size=64, pretrain_epochs=2, epochs=150)


def _cpu() -> str:
    return f"CPU ({platform.processor() or platform.machine()}, {os.cpu_count()} cores visible)"


def run_labels(root: str, names) -> None:
    """``exp_label_spread.run_label_protocol`` for ``names`` in ``root``
    (the reference's own view spaces, written by its generator), with each
    count's PSNR, into ``<root>/labels.json``."""
    os.environ["PRV_WS_ROOT"] = root
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "experiments"))
    import exp_label_spread as spread
    from nerf_prv_tpu.nerf.api import load_metrics
    from nerf_prv_tpu.pipeline import modes

    cfg = spread.pipeline_config()
    path = os.path.join(root, "labels.json")
    out = json.load(open(path)) if os.path.exists(path) else {}
    for name in names:
        t0 = time.perf_counter()
        res, _ = spread.run_label_protocol(cfg, [name])
        gt = cfg.replace(name_of_pcd=name).gt_path
        psnr = {str(n): load_metrics(os.path.join(gt, f"{n}.txt"))["PSNR"] for n in modes._coverage_counts(cfg)}
        out[name] = dict(label=res[name][0], converged=res[name][1], psnr=psnr, wall_s=time.perf_counter() - t0,
                         platform=_cpu())
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        print("DONE", name, out[name], flush=True)


def merge_labels(root: str) -> None:
    """``<root>/labels.json`` into ``labels_check.json`` under ``jax_cpu``
    (beside the runs merged before), with the port's card runs of the same
    objects: their PSNRs and labels by NeRF seed, from the label check and
    from pilot 2's check."""
    with open(os.path.join(root, "labels.json")) as f:
        jax_runs = json.load(f)
    with open(LABELS_CHECK) as f:
        check = json.load(f)
    port_runs = dict(check["runs"])
    if os.path.exists(PILOT2_CHECK):
        with open(PILOT2_CHECK) as f:
            port_runs.update({k: v for k, v in json.load(f)["runs"].items() if k not in port_runs})
    runs = {**check.get("jax_cpu", {}).get("runs", {}), **jax_runs}
    card = {n: {s: port_runs[f"{n}@{s}"] for s in (0, 1, 2) if f"{n}@{s}" in port_runs} for n in runs}
    check["jax_cpu"] = dict(
        what="today's JAX package, exp_label_spread.run_label_protocol at the full protocol on the CPU "
             "(tests/jax_reference_runs.py labels)",
        runs=runs,
        port_card={n: {s: r["psnr"] for s, r in by_seed.items()} for n, by_seed in card.items()},
        port_card_labels={n: {s: r["label"] for s, r in by_seed.items()} for n, by_seed in card.items()},
    )
    with open(LABELS_CHECK, "w") as f:
        json.dump(check, f, indent=1)
        f.write("\n")


def run_field(root: str, obj: str, views: int, steps: int, seeds, package: str) -> None:
    """One protocol field of ``obj`` at ``views`` per seed, scored on its
    100-view set, by ``package``; the coverage sets are the port's (equal to
    the reference's, tests/test_torch_experiments.py), rendered once."""
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 4))
    from nerf_prv_tpu_torch.experiments import label_protocol as lp
    from nerf_prv_tpu_torch.experiments import mode7_compare as m7
    from nerf_prv_tpu_torch.experiments.families import make_family_object
    from nerf_prv_tpu_torch.pipeline.coverage import get_coverage
    from nerf_prv_tpu_torch.scene.object_setup import load_object

    cfg = lp.pipeline_config(root)
    m7.install_eval_viewspace(cfg)
    make_family_object(obj, lp.model_dir(cfg))
    obj_cfg = cfg.replace(name_of_pcd=obj)
    if not all(os.path.exists(os.path.join(obj_cfg.gt_path, f"{n}.json")) for n in (views, 100)):
        scene = load_object(obj_cfg, obj, device="cpu")
        for n in (views, 100):
            get_coverage(scene, obj_cfg, n, device="cpu")
    train, test = (os.path.join(obj_cfg.gt_path, f"{n}.json") for n in (views, 100))
    path = os.path.join(root, f"field_{obj}{views}_{steps}_{package}.json")
    out = json.load(open(path)) if os.path.exists(path) else {}
    for seed in seeds:
        t0 = time.perf_counter()
        if package == "jax":
            from nerf_prv_tpu.nerf import NerfConfig
            from nerf_prv_tpu.nerf.api import run

            m = run(train, test_transforms=test, cfg=NerfConfig(n_steps=steps), seed=seed)
        else:
            from nerf_prv_tpu_torch.nerf.api import run
            from nerf_prv_tpu_torch.nerf.model import NerfConfig

            m = run(train, test_transforms=test, cfg=NerfConfig(n_steps=steps), seed=seed, device="cpu")
        out[str(seed)] = dict(PSNR=float(m["PSNR"]), SSIM=float(m["SSIM"]), wall_s=time.perf_counter() - t0,
                              platform=_cpu())
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        print(package, obj, views, steps, seed, out[str(seed)], flush=True)


def merge_fields(root: str) -> None:
    """``<root>/field_*.json`` into ``fields_cpu.json``: per (object, budget)
    the PSNR and SSIM of each package on the CPU by NeRF seed, the committed
    ``mode7_r4.json`` values and the port's card runs (``mode7_check.json``:
    the comparison's seed-0 field and the limit's seeds), and the mean
    differences over the pairs."""
    import glob
    import re

    with open(os.path.join(REPO, "experiments", "artifacts", "mode7_r4.json")) as f:
        ref = json.load(f)["rows"]
    with open(os.path.join(RESULTS, "mode7_check.json")) as f:
        card = json.load(f)
    pairs = {}
    for path in sorted(glob.glob(os.path.join(root, "field_*.json"))):
        obj, views, steps, package = re.fullmatch(r"field_([a-z]+\d+?)(\d\d)_(\d+)_(jax|port)\.json",
                                                  os.path.basename(path)).groups()
        with open(path) as f:
            runs = json.load(f)
        key = f"{obj}@{views}"
        entry = pairs.setdefault(key, dict(steps=int(steps)))
        entry[f"{package}_cpu"] = runs
        committed = next(r for r in ref[obj].values() if r["budget"] == int(views))
        entry["committed"] = {k: committed[k] for k in ("PSNR", "SSIM")}
        port_card = {"0": {k: card["comparison"][key]["port"][k] for k in ("PSNR", "SSIM")}}
        if int(views) == 28:
            port_card.update({str(r["seed"]): {k: r[k] for k in ("PSNR", "SSIM")}
                              for r in card["limit_runs"].values() if r["name"] == obj})
        entry["port_card"] = port_card

    def mean(runs):
        return sum(r["PSNR"] for r in runs.values()) / len(runs)

    both = {k: e for k, e in pairs.items() if "jax_cpu" in e and "port_cpu" in e}
    seeds = [(k, s) for k, e in both.items() for s in e["jax_cpu"] if s in e["port_cpu"]]
    diffs = [both[k]["port_cpu"][s]["PSNR"] - both[k]["jax_cpu"][s]["PSNR"] for k, s in seeds]
    out = dict(
        what="one protocol field (320x180, NerfConfig(n_steps=steps)) by each package on the CPU from the same "
             "coverage sets (tests/jax_reference_runs.py field), beside the committed mode7_r4.json value and "
             "the port's card runs",
        platform=_cpu(),
        pairs=pairs,
        summary=dict(
            n_pairs=len(both),
            port_cpu_minus_jax_cpu_by_seed=sum(diffs) / len(diffs),
            n_port_cpu_higher=sum(d > 0 for d in diffs), n_seed_pairs=len(diffs),
            jax_cpu_minus_committed=sum(mean(e["jax_cpu"]) - e["committed"]["PSNR"] for e in both.values())
            / len(both),
            port_cpu_minus_committed=sum(mean(e["port_cpu"]) - e["committed"]["PSNR"] for e in both.values())
            / len(both),
            port_card_minus_committed=sum(mean(e["port_card"]) - e["committed"]["PSNR"] for e in both.values())
            / len(both),
        ),
    )
    with open(FIELDS_CPU, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


def run_real_object_field(root: str, views: int, steps: int, seeds, package: str) -> None:
    """One field of the textured torus's production protocol (1280x720
    model-2 camera, ``NerfConfig(n_steps=steps)``) at ``views`` per seed,
    scored on its 100-view set, by ``package``; the PLY, view spaces and
    coverage sets are the port's (the PLY and view spaces equal the
    reference's, tests/test_torch_real_object.py), rendered once."""
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 4))
    from nerf_prv_tpu_torch.experiments import real_object as ro
    from nerf_prv_tpu_torch.pipeline.coverage import get_coverage
    from nerf_prv_tpu_torch.scene.object_setup import _ensure_viewspace, load_object

    cfg = ro.real_object_config("torus", root, *ro.SWEEPS["torus"])
    ro.sample_object("torus", root)
    ro.install_production_viewspace(cfg, ro.fit_counts(cfg) + [100])
    obj_cfg = cfg.replace(name_of_pcd=ro.object_name("torus"))
    if not all(os.path.exists(os.path.join(obj_cfg.gt_path, f"{n}.json")) for n in (views, 100)):
        _ensure_viewspace(cfg.viewspace_path, cfg.num_of_views, "cpu")
        scene = load_object(obj_cfg, obj_cfg.name_of_pcd, device="cpu")
        for n in (views, 100):
            get_coverage(scene, obj_cfg, n, device="cpu")
    train, test = (os.path.join(obj_cfg.gt_path, f"{n}.json") for n in (views, 100))
    path = os.path.join(root, f"real_object_torus{views}_{steps}_{package}.json")
    out = json.load(open(path)) if os.path.exists(path) else {}
    for seed in seeds:
        t0 = time.perf_counter()
        if package == "jax":
            from nerf_prv_tpu.nerf import NerfConfig
            from nerf_prv_tpu.nerf.api import run

            m = run(train, test_transforms=test, cfg=NerfConfig(n_steps=steps), seed=seed)
        else:
            from nerf_prv_tpu_torch.nerf.api import run
            from nerf_prv_tpu_torch.nerf.model import NerfConfig

            m = run(train, test_transforms=test, cfg=NerfConfig(n_steps=steps), seed=seed, device="cpu")
        out[str(seed)] = dict(PSNR=float(m["PSNR"]), SSIM=float(m["SSIM"]), wall_s=time.perf_counter() - t0,
                              platform=_cpu())
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        print(package, "torus", views, steps, seed, out[str(seed)], flush=True)


def merge_real_object(root: str, views: int, steps: int) -> None:
    """``<root>/real_object_torus<views>_<steps>_*.json`` into
    ``real_object_cpu.json``: each package's PSNR on the CPU by NeRF seed,
    the committed calibration's, the port's card runs (``real_object_check.json``)
    and the differences."""
    with open(os.path.join(REPO, "experiments", "artifacts", "real_object_calibration.json")) as f:
        ref = json.load(f)
    with open(os.path.join(RESULTS, "real_object_check.json")) as f:
        card = json.load(f)
    runs = {}
    for package in ("jax", "port"):
        with open(os.path.join(root, f"real_object_torus{views}_{steps}_{package}.json")) as f:
            runs[f"{package}_cpu"] = json.load(f)
    committed = ref["measured_psnr"][ref["view_counts"].index(views)]
    port_card = {k.split("@")[1]: v[str(views)] for k, v in card["fields"].items() if k.startswith("torus@")}

    def mean(r):
        return sum(x["PSNR"] for x in r.values()) / len(r)

    seeds = [s for s in runs["jax_cpu"] if s in runs["port_cpu"]]
    out = dict(
        what=f"one field of the textured torus's production protocol (1280x720 model 2, {views} views, "
             f"NerfConfig(n_steps={steps})) by each package on the CPU from the same coverage sets "
             "(tests/jax_reference_runs.py real-object), beside the committed real_object_calibration.json "
             "value and the port's card runs",
        platform=_cpu(), views=views, steps=steps, committed=committed, port_card=port_card, **runs,
        summary=dict(
            port_cpu_minus_jax_cpu_by_seed={s: runs["port_cpu"][s]["PSNR"] - runs["jax_cpu"][s]["PSNR"]
                                            for s in seeds},
            jax_cpu_minus_committed=mean(runs["jax_cpu"]) - committed,
            port_cpu_minus_committed=mean(runs["port_cpu"]) - committed,
            port_card_minus_committed=mean(port_card) - committed,
        ),
    )
    with open(os.path.join(RESULTS, "real_object_cpu.json"), "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


def run_trainers(root: str, seeds, package: str, workers: int) -> None:
    """``prvnet_recipe.run_two_stage``'s two stages at the size ``CUT``
    (the recipe's learning rates and schedules) by ``package``'s trainer on
    the corpus's dataset under ``<root>/corpus`` (rendered by the port on
    the CPU where missing), one seed after another, each into
    ``<root>/trainers_<package>_<seed>/result.json``: its val L1 by epoch and
    the best checkpoint's val predictions, read by the port's
    ``val_metrics``."""
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 4))
    from nerf_prv_tpu_torch.experiments import prvnet_recipe as recipe
    from nerf_prv_tpu_torch.experiments.corpus_dataset import prepare_dataset
    from nerf_prv_tpu_torch.experiments.label_protocol import pipeline_config
    from nerf_prv_tpu_torch.parallel.mesh import make_mesh
    from nerf_prv_tpu_torch.prvnet import train as ttrain

    corpus = os.path.join(root, "corpus")
    ds_root = os.path.join(pipeline_config(corpus).workspace, "pvb_dataset")
    if not os.path.exists(os.path.join(ds_root, "val_split.txt")):
        ds_root = prepare_dataset(corpus, workers, "cpu")["root"]
    if package == "jax":
        from nerf_prv_tpu.parallel.mesh import make_mesh as jmake_mesh
        from nerf_prv_tpu.prvnet import train as trainer

        mesh = jmake_mesh()
    else:
        trainer, mesh = ttrain, make_mesh(devices=["cpu"])
    train_split, val_split = (os.path.join(ds_root, f"{s}_split.txt") for s in ("train", "val"))
    common = dict(arch=CUT["arch"], batch_size=CUT["batch_size"], accum_steps=1, image_size=CUT["image_size"])
    for seed in seeds:
        run_dir = os.path.join(root, f"trainers_{package}_{seed}")
        pre_cfg = trainer.TrainConfig(**common, epochs=CUT["pretrain_epochs"], blr=recipe.PRETRAIN_BLR,
                                      use_schedule=True, warmup_epochs=max(CUT["pretrain_epochs"] // 20, 2),
                                      seed=seed)
        t0 = time.perf_counter()
        trainer.pretrain(ds_root, train_split, val_split, cfg=pre_cfg, checkpoint_dir=os.path.join(run_dir, "pre"),
                         mesh=mesh, viewspace_size=64)
        reg_cfg = trainer.TrainConfig(**common, epochs=CUT["epochs"], blr=recipe.BLR, use_schedule=False, seed=seed)
        ckpt = os.path.join(run_dir, "reg")
        trainer.train_regression(ds_root, train_split, val_split, cfg=reg_cfg, pattern=recipe.PATTERN,
                                 checkpoint_dir=ckpt, mesh=mesh,
                                 premodel_file=os.path.join(run_dir, "pre", "best_pretrain_checkpoint.msgpack"))
        val = recipe.val_metrics(ttrain.TrainConfig(**common, seed=seed), ckpt, ds_root, val_split,
                                 make_mesh(devices=["cpu"]))
        with open(os.path.join(ckpt, "log.jsonl")) as f:
            by_epoch = [json.loads(line)["l1_mean"] for line in f]
        out = dict(val_l1_by_epoch=by_epoch, best_val_l1=min(by_epoch),
                   **{k: val[k] for k in ("val_pred_gt_corr", "val_pred_min_max", "val_pred_std")},
                   wall_s=time.perf_counter() - t0, platform=_cpu())
        with open(os.path.join(run_dir, "result.json"), "w") as f:
            json.dump(out, f, indent=1)
        print(package, seed, {k: v for k, v in out.items() if k != "val_l1_by_epoch"}, flush=True)


def merge_trainers(root: str) -> None:
    """``<root>/trainers_<package>_<seed>/result.json`` into
    ``trainers_cpu.json`` with, per package, the seeds that left the
    constant predictor (predictions spanning at least
    ``predictor_gate.MIN_SPAN`` views, correlation at least ``MIN_CORR``)."""
    import glob

    sys.path.insert(0, REPO)
    from nerf_prv_tpu_torch.experiments.predictor_gate import MIN_CORR, MIN_SPAN

    out = dict(what="prvnet_recipe's two stages cut to " + json.dumps(CUT) + " with the recipe's learning rates, "
                    "by each package's trainer on the CPU, on the corpus's dataset as the port renders it "
                    "(tests/jax_reference_runs.py trainers)", platform=_cpu(), packages={})
    for package in ("jax", "port"):
        runs = {}
        for path in sorted(glob.glob(os.path.join(root, f"trainers_{package}_*", "result.json"))):
            with open(path) as f:
                runs[os.path.basename(os.path.dirname(path)).rsplit("_", 1)[1]] = json.load(f)
        passed = [s for s, r in runs.items() if r["val_pred_gt_corr"] >= MIN_CORR
                  and r["val_pred_min_max"][1] - r["val_pred_min_max"][0] >= MIN_SPAN]
        out["packages"][package] = dict(runs=runs, n_seeds=len(runs), seeds_past_the_gate=passed)
    with open(TRAINERS_CPU, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


def jax_write_thin_scene(out_dir: str, camera, seed: int = 0) -> tuple:
    """``experiments/exp_hashgrid_r3.py:52-74``'s thin-scene writer on the
    JAX package (``exp_thin_geometry.py:67-87`` and ``exp_train16.py:58-75``
    write the same), for ``make_thin_object(seed=seed)``: seed 1 is
    ``exp_share_march.py:94-114``'s object.  Returns (train, test) JSONs."""
    sys.path.insert(0, os.path.join(REPO, "experiments"))
    import numpy as np
    from PIL import Image

    from exp_thin_geometry import make_thin_object
    from nerf_prv_tpu.core.pose import camera_to_world
    from nerf_prv_tpu.core.transforms import add_frame, make_root, write_transforms
    from nerf_prv_tpu.scene import render_pointcloud, rgba_from_render
    from nerf_prv_tpu.viewspace import generate_hemisphere

    pts, cols = make_thin_object(seed=seed)
    center = pts.mean(axis=0)
    predicted_size = float(np.linalg.norm(pts - center, axis=1).max() * 17 / 16)
    views_train = generate_hemisphere(24, seed=1, restarts=2, steps=200)
    views_test = generate_hemisphere(11, seed=2, restarts=2, steps=200)[3:]
    os.makedirs(out_dir, exist_ok=True)
    for name, views in (("train", views_train), ("test", views_test)):
        root = make_root(camera, 1, predicted_size, center)
        sub = os.path.join(out_dir, name)
        os.makedirs(sub, exist_ok=True)
        for i, v in enumerate(views):
            pos = v / np.linalg.norm(v) * 0.3 + center
            c2w = camera_to_world(pos[None], center)[0]
            rgb, alpha = render_pointcloud(pts, cols, c2w, camera, point_size=2)
            rgba = rgba_from_render(rgb, alpha)
            Image.fromarray(rgba, "RGBA").save(os.path.join(sub, f"rgbaClip_{i}.png"))
            add_frame(root, os.path.join(name, f"rgbaClip_{i}.png"), c2w)
        write_transforms(os.path.join(out_dir, f"{name}.json"), root)
    return os.path.join(out_dir, "train.json"), os.path.join(out_dir, "test.json")


def jax_write_quality_scene(name: str, out_dir: str) -> tuple:
    """The JAX writer of ``quality_scenes.SCENES[name]``: ``tests/synthetic.py``'s
    ``write_scene`` at the studies' (``exp_quality.py:31-35``) or ``bench.py:104-107``'s
    settings, or the thin writer.  Returns (train, test) JSONs."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from nerf_prv_tpu.core.config import CameraConfig
    from synthetic import write_scene

    cam = CameraConfig(width=320, height=180, fx=228.9, fy=228.3, ppx=161.8, ppy=93.1, model=0)
    if name == "splat":
        return write_scene(out_dir, n_train=24, n_test=8, camera=cam, point_size=2, n_points=60000)[:2]
    if name == "bench":
        return write_scene(out_dir, n_train=16, n_test=8, camera=CameraConfig(), point_size=3,
                           n_points=120000)[:2]
    return jax_write_thin_scene(out_dir, cam, seed={"thin": 0, "thin_s1": 1}[name])


def run_quality_scenes(root: str) -> None:
    """The ``generate_hemisphere`` calls of the quality writers, saved as
    shipped ``.npy`` files, then every quality scene by the JAX writer under
    ``<root>/jax/<name>`` and the sha256 of its files into
    ``quality_scenes_cpu.json``."""
    sys.path.insert(0, REPO)
    import numpy as np

    from nerf_prv_tpu.viewspace import generate_hemisphere
    from nerf_prv_tpu_torch.experiments import quality_scenes as qs

    os.makedirs(qs.VIEWS_DIR, exist_ok=True)
    for n, seed in qs.HEMISPHERES:
        np.save(qs.hemisphere_path(n, seed), generate_hemisphere(n, seed=seed, restarts=2, steps=200))
    scenes = {}
    for name in qs.SCENES:
        d = os.path.join(root, "jax", name)
        jax_write_quality_scene(name, d)
        scenes[name] = qs.scene_digests(d)
        print(name, len(scenes[name]["files"]), "files", flush=True)
    out = dict(what="the quality scenes by the JAX writers on the CPU (tests/jax_reference_runs.py "
                    "quality-scenes): sha256 of each file's bytes and of each PNG's decoded RGBA",
               platform=_cpu(), scenes=scenes)
    with open(QUALITY_SCENES_CPU, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


def run_quality(root: str, scene: str, seeds, package: str) -> None:
    """``NerfConfig()`` (2,500 steps) on the quality scene ``scene`` by
    ``package`` on the CPU, each seed scored on the scene's test set, into
    ``<root>/quality_<package>_<scene>.json``.  Each package trains on its own
    writer's scene (the two are equal, tests/test_torch_quality_scenes.py)."""
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 4))
    d = os.path.join(root, package, scene)
    if package == "jax":
        from nerf_prv_tpu.nerf import NerfConfig
        from nerf_prv_tpu.nerf.api import run

        from nerf_prv_tpu_torch.experiments.quality_scenes import complete

        if not complete(d):
            jax_write_quality_scene(scene, d)
    else:
        from nerf_prv_tpu_torch.experiments.quality_scenes import write_named
        from nerf_prv_tpu_torch.nerf.api import run
        from nerf_prv_tpu_torch.nerf.model import NerfConfig

        write_named(scene, d, device="cpu")
    path = os.path.join(root, f"quality_{package}_{scene}.json")
    out = json.load(open(path)) if os.path.exists(path) else {}
    train, test = (os.path.join(d, f"{s}.json") for s in ("train", "test"))
    for seed in seeds:
        t0 = time.perf_counter()
        kw = {} if package == "jax" else dict(device="cpu")
        m = run(train, test_transforms=test, cfg=NerfConfig(), seed=seed, **kw)
        out[str(seed)] = dict(PSNR=float(m["PSNR"]), SSIM=float(m["SSIM"]), min_PSNR=float(m["min_PSNR"]),
                              wall_s=time.perf_counter() - t0, platform=_cpu())
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        print(package, scene, seed, out[str(seed)], flush=True)


def merge_quality(root: str) -> None:
    """``<root>/quality_<package>_<scene>.json`` into ``quality_cpu.json``
    beside the committed record of ``NerfConfig()`` (``fused_rng_seeds.json``,
    arm "split", the same values as ``adam_lowp.json``'s "f32") and the port's
    card runs (``quality_check.json``'s anchor) at the same seeds."""
    import glob
    import re

    with open(os.path.join(REPO, "experiments", "artifacts", "fused_rng_seeds.json")) as f:
        committed = json.load(f)["psnr"]
    card = {}
    if os.path.exists(os.path.join(RESULTS, "quality_check.json")):
        with open(os.path.join(RESULTS, "quality_check.json")) as f:
            anchor = json.load(f)["verdicts"].get("anchor", {})
        card = {sc: {str(s): p for s, p in enumerate(a["psnr"])} for sc, a in anchor.items()}
    scenes = {}
    for path in sorted(glob.glob(os.path.join(root, "quality_*_*.json"))):
        package, scene = re.fullmatch(r"quality_(jax|port)_(\w+)\.json", os.path.basename(path)).groups()
        with open(path) as f:
            scenes.setdefault(scene, {})[f"{package}_cpu"] = json.load(f)
    for scene, e in scenes.items():
        seeds = sorted(set(e.get("jax_cpu", {})) | set(e.get("port_cpu", {})))
        e["committed"] = {s: committed[f"split/{scene}/s{s}"] for s in seeds}
        e["port_card"] = {s: card[scene][s] for s in seeds if s in card.get(scene, {})}
        for package in ("jax_cpu", "port_cpu"):
            if package in e:
                e[f"{package}_mean_minus_committed"] = sum(
                    r["PSNR"] - e["committed"][s] for s, r in e[package].items()) / len(e[package])
        for package in ("jax_cpu", "port_cpu"):
            if package in e:
                e[f"{package}_minus_committed"] = {s: r["PSNR"] - e["committed"][s] for s, r in e[package].items()}
        if "jax_cpu" in e and "port_cpu" in e:
            e["port_cpu_minus_jax_cpu"] = {s: e["port_cpu"][s]["PSNR"] - e["jax_cpu"][s]["PSNR"]
                                           for s in e["port_cpu"] if s in e["jax_cpu"]}
    out = dict(what="NerfConfig() (2,500 steps) on the quality scenes by each package on the CPU "
                    "(tests/jax_reference_runs.py quality), beside the committed TPU record "
                    "(fused_rng_seeds.json, arm split) and the port's card runs (quality_check.json)",
               platform=_cpu(), scenes=scenes)
    with open(QUALITY_CPU, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("labels", "merge-labels", "field", "merge-fields", "trainers", "merge-trainers",
                                     "real-object", "merge-real-object", "quality-scenes", "quality",
                                     "merge-quality"))
    ap.add_argument("names", nargs="*")
    ap.add_argument("--root", required=True)
    ap.add_argument("--obj", default="uni11")
    ap.add_argument("--views", type=int, default=28)
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--seeds", type=int, nargs="*", default=[0], help="none: render the coverage sets only")
    ap.add_argument("--package", choices=("jax", "port"), default="jax")
    ap.add_argument("--workers", type=int, default=4, help="render processes for the corpus's dataset")
    ap.add_argument("--scene", default="splat", help="the quality scene (quality)")
    args = ap.parse_args(argv)
    if args.what == "labels":
        run_labels(args.root, args.names)
    elif args.what == "merge-labels":
        merge_labels(args.root)
    elif args.what == "merge-fields":
        merge_fields(args.root)
    elif args.what == "trainers":
        run_trainers(args.root, args.seeds, args.package, args.workers)
    elif args.what == "merge-trainers":
        merge_trainers(args.root)
    elif args.what == "real-object":
        run_real_object_field(args.root, args.views, args.steps, args.seeds, args.package)
    elif args.what == "merge-real-object":
        merge_real_object(args.root, args.views, args.steps)
    elif args.what == "quality-scenes":
        run_quality_scenes(args.root)
    elif args.what == "quality":
        run_quality(args.root, args.scene, args.seeds, args.package)
    elif args.what == "merge-quality":
        merge_quality(args.root)
    else:
        run_field(args.root, args.obj, args.views, args.steps, args.seeds, args.package)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
