"""The quality check: every quality table of ``experiments/`` re-run on the
card (``quality_studies``), held against the committed records.

    python -m nerf_prv_tpu_torch.experiments.check_quality [--workers 6] [--max-fields N]

In this order:
1. Limits, written to the result file and the log before any field runs:
   (i) the anchor: the six-seed mean PSNR of ``NerfConfig()`` on each scene
   lies within [record - 0.15, record + 0.80] dB, the record being
   ``fused_rng_seeds.json``'s "split" arm (the same per-seed values as
   ``adam_lowp.json``'s "f32"; the upper side allows the largest offset of
   today's packages over the TPU records, +0.66 dB, ROADMAP §3 item 2, and 3
   SE of a six-seed mean); (ii) each decision row of ``experiments/README.md``
   (:data:`ROWS`): the paired delta d = arm - the script's reference arm, on
   the same scene and seed, its mean and SE; the row **holds** where its
   recorded delta lies within mean +- max(3 SE, 0.10 dB), keeps **the same
   decision** where the sign agrees (for a "neutral" / "lossless" row: where
   |mean| <= 2 SE), and is "not comparable" where its reference arm is gone
   from the script or its arms collapsed (said before the run); (iii) the
   script's own gate over ``adam_lowp``'s f32 / bf16 arms, against the
   committed "bf16 fails, f32 stays"; (iv) the hash arm (no record): finite
   and at least 3 dB above an all-black frame; (v) every PNG and both JSONs
   of each scene written on the card equal to the JAX writer's digests.
2. The scenes (splat, thin, and exp_share_march's thin at seed 1), written
   on the card (K8) and held against the digests.
3. Every field of every table at its seeds (:data:`SEEDS`): seeds 0-5 for
   the anchor and the five tables whose decisions the repo gates at six
   seeds, the script's own for the rest; each field trained once and
   evaluated under every arm that shares it, ``--workers`` at a time (the
   training is host-bound, so several share the card).  ``--max-fields``
   cuts a call; a later call resumes from the result file.
4. Once every field is in: each study's table (``quality_studies.study_result``),
   then the verdicts of (i)-(v).  A miss fails nothing: it is recorded with
   its numbers.

The scenes go under ``.workspace/quality_check``, the result to
``nerf_prv_tpu_torch/experiments/results/quality_check.json``; the log and
a copy of the result to the gitignored ``runs.LOG_DIR``.  Walls are taken
under the workers' sharing.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np

from . import quality_scenes as qs
from . import quality_studies as qst
from .label_protocol import require_device
from .real_object import ARTIFACTS
from .runs import LOG_DIR, RESULTS_DIR, WORKSPACE, Log, black_psnr, build_kernels, card_line, write_json

SIX = (0, 1, 2, 3, 4, 5)
# the seeds of each table: six where the repo moved its quality gates to six seeds (experiments/README.md:60-61),
# the script's own for the rest
SEEDS = {name: (SIX if name in ("quality", "trainrays", "gridsize", "thin_geometry", "adam_lowp")
                else st.seeds) for name, st in qst.STUDIES.items()}
# adam_lowp's f32 arm is the anchor (NerfConfig() on both scenes at seeds 0-5): its fields train first
ORDER = ("adam_lowp",) + tuple(n for n in qst.STUDIES if n != "adam_lowp")
ANCHOR_SCENES = ("splat", "thin")
ANCHOR_BAND = (-0.15, 0.80)  # dB about the record
ROW_FLOOR_DB = 0.10  # the smallest half-width of a row's band
HASH_MARGIN_DB = 3.0
SCENES = ("splat", "thin", "thin_s1")


def committed_anchor() -> dict:
    """{scene: per-seed PSNRs} of ``NerfConfig()`` as recorded on the TPU."""
    with open(os.path.join(ARTIFACTS, "fused_rng_seeds.json")) as f:
        psnr = json.load(f)["psnr"]
    return {sc: {str(s): psnr[f"split/{sc}/s{s}"] for s in SIX} for sc in ANCHOR_SCENES}


def one_seed_sd() -> float:
    """The seed SD of a paired delta, from the committed six-seed pairs
    (``adam_lowp.json``: bf16 - f32 on each scene and seed): the SE a delta
    measured at one seed is given."""
    with open(os.path.join(ARTIFACTS, "adam_lowp.json")) as f:
        psnr = json.load(f)["psnr"]
    d = [psnr[f"bf16/{sc}/s{s}"] - psnr[f"f32/{sc}/s{s}"] for sc in ANCHOR_SCENES for s in SIX]
    return float(np.std(d, ddof=1))


def _row(row, study, claim, arm=None, ref=None, recorded=None, decision=None, scenes=None, note=None,
         not_comparable=None) -> dict:
    return dict(row=f"experiments/README.md:{row}", study=study, claim=claim, arm=arm, reference=ref,
                recorded_db=recorded, decision=decision, scenes=scenes, note=note, not_comparable=not_comparable)


# Each claim of the README rows the check re-decides: the arm, the script's reference arm, the recorded delta
# ([low, high] dB, or None where the row gives no number) and the decision ("negative": the arm loses;
# "neutral": lossless, within noise; "not_negative": at least as good).
ROWS = [
    _row(15, "quality", "tight24+48 lossless", not_comparable=(
        "the reference arm, the flat-96 baseline the script's docstring compares against, is not in its table")),
    _row(15, "quality", "CDF importance -1.2 dB", not_comparable="no arm of the table trains with CDF importance"),
    _row(16, "warmup", "125 steps x 48 samples best (against 250 steps)", "w250s96", "w500s96 (prod)", None,
         "negative", note="the (prod) arm, w500s48 and w125s48 are all NerfConfig() today (125 x 48), and w250s96 "
                          "equals w250s48"),
    _row(16, "warmup", "none also works", "w0 (none)", "w500s96 (prod)", None, "neutral",
         note="the reference is 125 x 48 today"),
    _row(16, "warmup", "125 x 48 best against 500 x 96 and 500 x 48", not_comparable=(
        "collapsed: w500s96 (prod), w500s48 and w125s48 are all NerfConfig() today")),
    _row(17, "trainrays", "3,072 train rays -0.1..-0.2 dB", "r3072 p24", "r4096 p24 (prod)", [-0.2, -0.1],
         "negative"),
    _row(17, "trainrays", "2,048 train rays -0.1..-0.2 dB", "r2048 p24", "r4096 p24 (prod)", [-0.2, -0.1],
         "negative"),
    _row(17, "trainrays", "16 train probes neutral", "r4096 p16", "r4096 p24 (prod)", [0.0, 0.0], "neutral",
         note="the (prod) arm trains 12 probes today, not 24"),
    _row(18, "gridsize", "G32 -0.5 dB", "G32", "G40 (prod)", [-0.5, -0.5], "negative"),
    _row(18, "gridsize", "G36 -0.3 dB", "G36", "G40 (prod)", [-0.3, -0.3], "negative"),
    _row(18, "gridsize", "12 fine probes -0.11 dB", "G40 p2fine12", "G40 (prod)", [-0.11, -0.11], "negative",
         note="the (prod) arm renders 20 fine probes today"),
    _row(19, "pe", "PE freqs 4 -> 2 -0.1 dB", "pe2 r32 c128k", "pe4 r32 c128k", [-0.1, -0.1], "negative"),
    _row(19, "pe", "24 fine render samples lossless", "pe4 r24 c128k", "pe4 r32 c128k", [0.0, 0.0], "neutral"),
    _row(22, "thin_geometry", "16 fine probes over 4-cell blocks -0.31 dB", not_comparable=(
        "the 4-cell-block arm is gone from the script: its table holds 2-cell blocks only")),
    _row(22, "thin_geometry", "2-cell blocks + 24 probes hold -0.07 dB", "blk2 rp24", "blk2 rp32 (prod)",
         [-0.07, -0.07], "neutral", note="the (prod) arm renders 20 fine probes today, not 32"),
    _row(22, "thin_geometry", "2-cell blocks + 20 probes", not_comparable=(
        "collapsed: blk2 rp20 is NerfConfig() today, as is the (prod) arm")),
    _row(22, "thin_geometry", "train tightening vindicated", not_comparable=(
        "the conservative flat-96 / MLP-probe arm the docstring compares against is not in the table")),
    _row(33, "train24", "24 samples / 8 probes at least the base", "t24p8", "t-base", None, "not_negative",
         note="t-base trains 16 samples / 12 probes today, not 32 / 16"),
    _row(33, "train24", "24 samples / 16 probes -0.20 dB", "t24", "t-base", [-0.20, -0.20], "negative",
         note="t24 trains 12 probes today, not 16, and t-base 16 / 12"),
    _row(34, "train16", "16 / 12 beats 20 / 8", "s20 p8", "s24 p8 (prod)", None, "negative",
         note="the (prod) arm is 16 samples / 12 probes today; s20 p8 trains 12 probes"),
    _row(34, "train16", "16 / 12 the best of 24 / 8, 16 / 8 and 16 / 12", not_comparable=(
        "collapsed: s16 p8 and s16 p12 are NerfConfig() today, as is the (prod) arm")),
    _row(35, "render20", "20 / 16 beats 24 / 24 on all four (scene, seed)", not_comparable=(
        "collapsed: rp24 rs24 (prod), rp24 rs16 and rp20 rs16 are all NerfConfig() today")),
    _row(35, "render20", "16 / 16 lost 0.15 dB on thin", "rp16 rs16", "rp24 rs24 (prod)", [-0.15, -0.15],
         "negative", scenes=["thin"], note="the (prod) arm is 20 / 16 today, the adopted one"),
    _row(41, "baked_probe", "baked probe, refresh 16, -0.16..-0.30 dB", "refresh 16", "refresh 0",
         [-0.30, -0.16], "negative"),
    _row(41, "baked_probe", "baked probe, refresh 8, -0.16..-0.30 dB", "refresh 8", "refresh 0", [-0.30, -0.16],
         "negative"),
    _row(43, "warmup2", "125 x 24 warmup loses on splat", "w125x24", "w125x48 (prod)", None, "negative",
         scenes=["splat"]),
    _row(43, "warmup2", "64 x 48 warmup loses on splat", "w64x48", "w125x48 (prod)", None, "negative",
         scenes=["splat"]),
    _row(43, "warmup2", "no warmup loses on splat", "none", "w125x48 (prod)", None, "negative", scenes=["splat"]),
    _row(46, "warmup3", "3,072 warmup rays lose on splat", "wr3072", "wr4096 (prod)", None, "negative",
         scenes=["splat"]),
    _row(46, "warmup3", "2,048 warmup rays lose on splat", "wr2048", "wr4096 (prod)", None, "negative",
         scenes=["splat"]),
    _row(46, "warmup3", "thin unaffected by 3,072 warmup rays", "wr3072", "wr4096 (prod)", [0.0, 0.0], "neutral",
         scenes=["thin"]),
    _row(46, "warmup3", "thin unaffected by 2,048 warmup rays", "wr2048", "wr4096 (prod)", [0.0, 0.0], "neutral",
         scenes=["thin"]),
    _row(56, "hashgrid_r3", "voxel re-validated at 35.38-35.51 dB", not_comparable=(
        "the row records absolute PSNRs, not a delta against a reference arm: the voxel arm is held by limit (i), "
        "the hash arm by limit (iv)")),
]


def limits(sd1: float) -> dict:
    """Limits (i)-(v) and their rules, as the result file states them."""
    means = {sc: float(np.mean(list(v.values()))) for sc, v in committed_anchor().items()}
    return dict(
        anchor={sc: dict(record_mean_db=m, window_db=[m + ANCHOR_BAND[0], m + ANCHOR_BAND[1]])
                for sc, m in means.items()},
        anchor_rule="(i) the six-seed mean of NerfConfig() on each scene within [record - 0.15, record + 0.80] dB; "
                    "record: fused_rng_seeds.json split (= adam_lowp.json f32), TPU",
        rows=ROWS,
        row_rule=f"(ii) d = arm - reference on each (scene, seed); holds where the recorded delta lies within mean "
                 f"+- max(3 SE, {ROW_FLOOR_DB} dB); same decision where the sign agrees (neutral: |mean| <= 2 SE; "
                 f"not_negative: mean >= -2 SE); SE = SD / sqrt(n), and at one pair the committed paired-delta SD "
                 f"{sd1:.4f} dB (adam_lowp.json, 12 pairs)",
        one_seed_sd_db=sd1,
        adam_rule="(iii) exp_adam_lowp.py's own gate over its f32 / bf16 arms at seeds 0-5; the committed "
                  "decision: bf16 fails, f32 stays",
        hash_rule=f"(iv) the hash arm finite and at least {HASH_MARGIN_DB} dB above an all-black frame's PSNR",
        scenes_rule="(v) every PNG and both JSONs of each scene written on the card equal to the JAX writer's "
                    "(results/quality_scenes_cpu.json)",
        seeds={k: list(v) for k, v in SEEDS.items()},
    )


def paired(study_out: dict, arm: str, ref: str, scenes) -> list:
    """d = arm - reference on each (scene, seed) both have."""
    a, r = study_out["arms"][arm]["runs"], study_out["arms"][ref]["runs"]
    return [a[k]["PSNR"] - r[k]["PSNR"] for k in a if k in r and k.split("/")[0] in scenes]


def row_verdict(row: dict, studies: dict, sd1: float) -> dict:
    if row["not_comparable"]:
        return dict(verdict="not comparable", reason=row["not_comparable"])
    st = studies[row["study"]]
    d = paired(st, row["arm"], row["reference"], row["scenes"] or st["scenes"])
    n = len(d)
    mean = float(np.mean(d))
    se = float(np.std(d, ddof=1) / math.sqrt(n)) if n > 1 else sd1
    band = max(3 * se, ROW_FLOOR_DB)
    holds = row["recorded_db"] is not None and row["recorded_db"][0] <= mean + band and \
        row["recorded_db"][1] >= mean - band
    same = {"negative": mean < 0, "neutral": abs(mean) <= 2 * se, "not_negative": mean >= -2 * se}[row["decision"]]
    verdict = "holds" if holds else ("same decision" if same else "miss")
    return dict(verdict=verdict, n=n, mean_db=mean, se_db=se, band_db=band, deltas_db=d, holds=holds,
                same_decision=same)


def verdicts(result: dict, black: dict) -> dict:
    studies, sd1 = result["studies"], result["limits"]["one_seed_sd_db"]
    voxel = studies["adam_lowp"]["arms"]["f32"]["runs"]
    anchor = {}
    for sc in ANCHOR_SCENES:
        v = [voxel[f"{sc}/s{s}"]["PSNR"] for s in SIX]
        lo, hi = result["limits"]["anchor"][sc]["window_db"]
        m = float(np.mean(v))
        anchor[sc] = dict(mean_db=m, sd_db=float(np.std(v, ddof=1)), psnr=v, within=lo <= m <= hi,
                          minus_record_db=m - result["limits"]["anchor"][sc]["record_mean_db"])
    rows = [dict(row, **row_verdict(row, studies, sd1)) for row in ROWS]
    stats = studies["adam_lowp"]["artifact"]["stats"]
    adam = dict(stats=stats, committed_flip=False, holds=stats["flip_default_to_bf16"] is False)
    hash_runs = studies["hashgrid_r3"]["arms"]["hash"]["runs"]
    hashes = {k: dict(PSNR=r["PSNR"], SSIM=r["SSIM"], black_db=black[k.split("/")[0]],
                      ok=math.isfinite(r["PSNR"]) and r["PSNR"] >= black[k.split("/")[0]] + HASH_MARGIN_DB,
                      voxel_PSNR=studies["hashgrid_r3"]["arms"]["voxel"]["runs"][k]["PSNR"])
              for k, r in hash_runs.items()}
    scenes_ok = all(not (c["bytes"] or c["missing"]) for c in result["scenes"].values())
    counts = {v: sum(r["verdict"] == v for r in rows) for v in ("holds", "same decision", "miss", "not comparable")}
    return dict(anchor=anchor, rows=rows, row_counts=counts, adam_lowp=adam, hash=hashes, scenes_equal=scenes_ok)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.join(WORKSPACE, "quality_check"))
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--max-fields", type=int, default=0, help="train at most this many fields in this call (0: all)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR, "quality_check.json"))
    ap.add_argument("--log", default=os.path.join(LOG_DIR, "quality_check.log"))
    args = ap.parse_args(argv)
    device = require_device(args.device)
    log = Log(args.log)
    card = card_line()
    log(f"quality check on {card}; workspace {args.root}, {args.workers} workers")
    sd1 = one_seed_sd()
    planned = qst.plan({name: SEEDS[name] for name in ORDER})
    result = dict(card=card, protocol=dict(seeds={k: list(v) for k, v in SEEDS.items()}, n_fields=len(planned),
                                           n_evaluations=sum(len(f["evals"]) for f in planned.values())),
                  limits=limits(sd1), calls=[], scenes={}, fields={}, studies={}, verdicts={})
    if os.path.exists(args.out):  # an earlier call's fields
        with open(args.out) as f:
            prior = json.load(f)
        if prior.get("protocol") == result["protocol"]:
            result = prior
    result["calls"].append(dict(card=card, workers=args.workers))
    write_json(args.out, result, LOG_DIR)
    log("LIMITS written before any field: " + json.dumps({k: v for k, v in result["limits"].items() if k != "rows"}))
    for row in ROWS:
        log(f"  row {row['row']} {row['study']}: {row['claim']}: " + (
            f"not comparable ({row['not_comparable']})" if row["not_comparable"] else
            f"{row['arm']} - {row['reference']}, recorded {row['recorded_db']}, decision {row['decision']}"))

    build_kernels(device, qst.QUALITY_KERNELS)
    t0 = time.perf_counter()
    paths = qst.write_scenes(args.root, SCENES, device)
    want = qs.committed_digests()
    for sc in SCENES:
        result["scenes"][sc] = qs.compare_digests(qs.scene_digests(qst.scene_root(args.root, sc)), want[sc])
        log(f"scene {sc}: {result['scenes'][sc]}")
    result["calls"][-1]["scenes_wall_s"] = time.perf_counter() - t0
    write_json(args.out, result, LOG_DIR)

    todo = {k: f for k, f in planned.items() if k not in result["fields"]}
    log(f"{len(planned) - len(todo)} of {len(planned)} fields done before")
    if args.max_fields:
        todo = dict(list(todo.items())[:args.max_fields])
    log(f"{len(todo)} to train in this call")
    t_fields = time.perf_counter()

    def done(key, rec):
        result["fields"][key] = rec
        write_json(args.out, result, LOG_DIR)
        log(f"{key}: trained in {rec['train_seconds']:.1f} s; " + "; ".join(
            f"{e}: PSNR {m['PSNR']:.3f} SSIM {m['SSIM']:.4f}" for e, m in rec["evals"].items()))

    qst.run_fields(args.root, todo, device, args.workers, on_field=done)
    result["calls"][-1].update(fields_wall_s=time.perf_counter() - t_fields, n_fields=len(todo))
    missing = [k for k in planned if k not in result["fields"]]
    if missing:
        write_json(args.out, result, LOG_DIR)
        log(f"{len(missing)} fields still to train: run again")
        return 0

    result["studies"] = {name: qst.study_result(name, SEEDS[name], result["fields"]) for name in qst.STUDIES}
    black = {sc: black_psnr(paths[sc][1]) for sc in SCENES}
    result["verdicts"] = verdicts(result, black)
    result["calls"][-1]["wall_s"] = time.perf_counter() - log.t0
    write_json(args.out, result, LOG_DIR)
    v = result["verdicts"]
    for sc, a in v["anchor"].items():
        log(f"(i) anchor {sc}: six-seed mean {a['mean_db']:.3f} dB ({a['minus_record_db']:+.3f} against the record), "
            f"within {result['limits']['anchor'][sc]['window_db']}: {a['within']}")
    for r in v["rows"]:
        log(f"(ii) {r['row']} {r['study']}: {r['claim']}: {r['verdict']}" + (
            "" if r["verdict"] == "not comparable" else
            f" (d {r['mean_db']:+.3f} +- {r['se_db']:.3f} dB over {r['n']}, recorded {r['recorded_db']})"))
    log(f"(iii) adam_lowp gate: {json.dumps(v['adam_lowp'])}")
    log(f"(iv) hash: {json.dumps(v['hash'])}")
    log(f"(v) scenes equal to the JAX writer's: {v['scenes_equal']}; rows {v['row_counts']} ({card})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
