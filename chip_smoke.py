"""Drive the PyTorch port's training and serving paths on one NVIDIA GPU and
hold every kernel on them against its plain PyTorch version.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases:
(1) build the seven kernels from ``nerf_prv_tpu_torch/ops/csrc``, one nvcc
    process each, started together;
(2) each kernel against its plain version at the paths' full shapes (and
    the row kernels at the batched trainer's, four grids read as one table),
    timed beside its bound and the library call for the same work:
    ``hash_encode`` against ``hashgrid.encode`` per level, on uniform points
    and on the probe and march points of one served chunk, at three
    configs, and on one training batch's own warmup-march, tight-march and
    probe points at a training step's three shapes; ``row_gather`` (exact) and ``row_scatter_add`` (against
    ``index_add_`` and a float64 sum, on uniform and on ray-ordered
    indices) against theirs; ``hash_encode_backward`` (the table gradient)
    against a float64 sum within a bound computed from the data and against
    the sort-based plain version, at both training shapes on uniform points
    and on a training batch's own march points, with two broken variants
    that must fail, beside the atomic adds its design rules issue and its
    waves (both worked out on the host, and logged only); ``frames_to_u8``
    (the training frames' uint8 quantisation) on one object's 16 frames at
    1280x720, byte-equal to ``frames_to_u8_plain`` on the same card tensor
    and to numpy's formula on the host, beside its byte bound and the plain
    version's time.  Every kernel time is a device time
    (``device_ms``: a replayed CUDA graph of the wrapper's calls), printed
    beside the time of a call through the wrapper (``time_ms``), and the
    two are cross-checked where the kernel outlasts the host;
(3) serve a random full-width hash-field snapshot at 1280x720 through
    ``run(load_snapshot_path=...)`` on 4 frames, count its launches, time
    one ``eval_nerf`` and profile another;
(4) one hash frame through the kernel against the plain encode, and two
    small f32 frames on the card against the CPU;
(5) train the default full-width voxel field through ``run(scene, ...)``
    on 16 frames at 1280x720 for the full 2,500 steps, score it on 4
    held-out frames and write screenshots; check the losses, the PSNR and
    the launch counts (one ``frames_to_u8`` a training); time and profile
    steps and one eval;
(6) one training step through the kernels against the same step through
    the plain versions (loss and every gradient), the same through two
    deliberately broken kernels (which must fail), and one small f32 voxel
    frame on the card against the CPU;
(7) train the full-width hash field through ``run(scene, ...)`` for the full
    2,500 steps (forward kernel once or twice and table-gradient kernel
    once per step), score it on the held-out frames; check the losses, the
    PSNR and the launch counts; time and profile steps;
(8) one hash training step through the two hash kernels against the same
    step through their plain versions (loss and every gradient);
(9) a short run each of the other training and render options on the card:
    bf16 Adam moments, the baked train probe, importance resampling, the
    span-bucketed eval against the unbucketed one, mesh export;
(10) the coverage-dataset path at full width: a procedural OBJ sampled to a
    500,000-point PLY, ``load_object`` with the ShapeNet size augmentation
    (K8), ``precept`` of the loaded object (K9), ``get_coverage`` (50 views)
    and ``generate_novel_sets`` (100 + 100), with the files checked; K8 held
    bit-equal to ``splat_plain`` on full-size frames and K9 to
    ``voxel_cast_plain`` on a chunk of one view's rays, each with broken
    variants that must fail; the voxel field trained on the port-rendered
    coverage set and scored on the novel test set; both kernels timed
    beside their bounds, each held bit-equal to the timed plain call, and
    one ``get_coverage`` profiled;
(11) (a) four different objects (the sphere in four colour patterns, 12 and
    3 x 16 frames) trained together through ``train_batch`` at full width
    for the full 2,500 steps, each scored on its own 4 held-out frames,
    with exactly one training's row launches for all four and one
    ``frames_to_u8`` launch an object a call; tight steps of
    one object and of four timed in turns, one batched step profiled;
    (b) one batched step through the kernels against the four single-object
    steps on the same rays and jitter, and a broken gather that drops the
    object offset, which must fail; (c) two hash fields trained together
    for 150 steps, K1 and K1b counted per object, ``frames_to_u8`` once an
    object; (d) 3,000 PSNR curves fit
    and labeled on the card against the CPU; (e) ``precompute_paths`` for
    3..60 views on the port's view spaces, and the card's edge matrix
    against the float64 scalar local path;
(12) the PRV experiment at full width: (a) PRVNet (ConvNeXt-V2 tiny, seeded
    random weights) predicts a view budget from the init views [0, 1, 3] of
    phase 10's object's 5-view coverage set through
    ``BudgetPredictor.predict_from_coverage``, its encoder features and logit
    on the card held against the same model on the CPU, its weights carried
    through the Flax layout and back, its forward timed and profiled with
    cuDNN's convolutions in full float32 (the predictor's own setting) and,
    on its model directly, in TF32; (b) mode 21, method 4
    (PVBCoverage) at the reference's defaults (540-view space, 5 init views,
    the default voxel field trained 2,500 steps on the planned views and
    scored on the 100-view set at 1280x720), its artifacts, PSNR and the
    launches of K8, K9 and the row kernels held to the code's prediction
    (the eval's gathers from the render's chunking of this run's level-1
    survivors), the first, middle and last frames of each of K8's coverage
    launches (F = 540 among them) bit-equal to ``splat_plain``, each stage
    timed; (c) methods 0-3 on the same object at a cut depth
    (1 iteration, 300-step NeRFs), their artifacts and methods 0 and 1's
    choices held to the numpy draws;
(13) PRVNet training at full width (ConvNeXt-V2 tiny, 720x720, 5 views,
    float32): (a) 12 seeded variants of phase 10's object through the
    coverage path (the size test, 64-view sets, K8; one launch's frames
    bit-equal to ``splat_plain``), labels fit on the card from synthetic
    curves, ``build_dataset``; (b) the peak memory of micro-batches of 2, 4
    and 8 objects, the largest under 70 GB taken, one optimizer application
    of each model timed, profiled and beside its f32 bound, ``pretrain`` on
    4 objects at batch 64; (c) ``train_regression`` 2 epochs at batch 8 from
    the pretrain checkpoint, and one streaming epoch against one resident
    epoch; (d) ``BudgetPredictor`` on the written ``best_checkpoint.msgpack``
    against the trainer's eval step, the card against the CPU; (e) mode 21
    method 4 through ``pipeline.cli.main`` with that checkpoint (``--sizes``:
    6 coverage sets at most), its budget, launches and PSNR held as in
    (12b).  Depth cuts: 12 objects (24 until the e2e phase came), synthetic
    labels, a regression batch of 8 (the micro-batch is the full
    configuration's), pretraining on 4 objects, 1 and 2 epochs, 13e's
    coverage sets cut from 58;
(14) the multi-device path on one card listed several times: the tp-sharded
    voxel field, PRVNet data-parallel, ``train_batch`` over dp and the dry
    run;
(15) the PRV corpus's entry points (``nerf_prv_tpu_torch.experiments``) at a
    cut size: (a) one family object through the label protocol (modes 0 ->
    3 -> 4 -> fit at the 320x180 camera, counts 3, 7 and 100, 300-step
    fields) with the launches of K8 and the row kernels held to the code's
    prediction and K8's kept frames bit-equal to ``splat_plain``; (b) the
    corpus dataset of three objects from the committed labels and split;
    (c) two epochs of each stage of the tiny@180 recipe on it.  Phase 2b
    also times the single-object training shapes of the row kernels cold;
(16) the held-out evaluation's entry points at a cut size: one test-roster
    object (``spi10``, committed budget 23) through mode 7 at budgets 23
    and 28 (``mode7_compare.run_mode7``) and mode 21 methods 4, 0 and 1
    (``mode21_table.run_rows`` with ``PinnedPredictor``, coverage sizes cut
    to 64, 5, 23, 28 and 100), 300-step fields: the launches of K8 and the
    row kernels held to the code's prediction, K8's kept frames bit-equal
    to ``splat_plain``, the path lengths and movements (which do not depend
    on the fields' depth) equal to the JAX package's on the shipped view
    spaces and to the committed artifacts' 4 decimals where those agree,
    every field above an all-black frame by a margin.  Phase 2b also times
    the batched (K = 4) shapes of the row kernels cold;
(17) the production label protocol on a textured mesh at full width
    (``experiments.real_object.run_real_object``): the torus's OBJ + MTL +
    PNG sampled to 300,000 points, mode 0 from the shipped view spaces, mode
    3 at the 1280x720 model-2 camera, the 100-view anchor, the sweep and
    the lognormal fit, cut to counts 3, 15 and 27 and 300-step fields; the
    launches of K8 and the row kernels held to the code's prediction (the
    evals' gathers from a replay of each field's level-1 probe), K8's kept
    frames bit-equal to ``splat_plain``, every field above an all-black
    frame by a margin;
(18) the end-to-end mode 21 (``experiments.e2e_mode21.run_e2e``): the PRV
    method, the random baseline and the ensemble-NeRF baseline on ``toy0``
    at the script's width (the 1280x720 model-2 camera, the 40^3 voxel
    field at 4,096 rays, a 60-view candidate space, ``ensemble_num=2``),
    cut to 300-step fields and a budget pinned at 4 (methods 0 and 2 replay
    it as 3 iterations), ``evaluate=True``: the launches of K8 and the row
    kernels held to the code's prediction (each training's, each eval's and
    each screenshot set's), K8's kept frames bit-equal to ``splat_plain``,
    method 2's choices equal to the plain score's argmax on its
    screenshots, every final field above an all-black frame by a margin;
(19) the NeRF quality studies' path (``experiments.quality_scenes`` and
    ``quality_studies``): the splat scene (24 + 8 views at 320x180, 60,000
    points) written on the card, one K8 launch a view set, every PNG and
    both JSONs equal to the JAX writer's digests; one ``NerfConfig()`` field,
    cut to 300 steps, evaluated under the default and under
    ``render_probe_fine=24`` (``exp_thin_geometry.py``'s arm) on the same
    field; the launches of K8 and the row kernels held to the code's
    prediction, each evaluation above an all-black frame by a margin;
(20) the hd arm (``experiments.corpus_dataset.render_hd_sets``,
    ``mode7_compare.HDPredictor``, the tiny@720 recipe): one family
    object's hd 5-view set at 1280x720 (its size test and one K8 launch,
    held to the code; kept frames bit-equal to ``splat_plain``), K8 timed at
    the hd sets' 16- and 5-frame shapes; a fresh tiny@720 predictor behind
    ``HDPredictor`` sent to the hd set, its budget on the card within 1e-4
    views of the CPU's; one tiny@720 regression application of two
    one-object micro-steps, timed.
Any failure exits non-zero.  The line before the last is the kernel table
as JSON, the last line the device.  It imports nothing of JAX or of
``nerf_prv_tpu``.

To compare other builds of the hash-encode kernel (a parent commit's
source, an ablated copy) with this tree's on one card in one call:

    python3 chip_smoke.py --k1 old=build/parent/hash_encode.cu --k1 ...

builds each source (same C interface), prints its distance from
``hashgrid.encode`` and times all of them in turns, first to last and back,
at the probe and march shapes on uniform and on served points.

    python3 chip_smoke.py --k1b old=build/k1b/old.cu --k1b ...

does the same for the table-gradient kernel: each source is held against
the float64 sum within phase 2c's bound and all are timed in turns at phase
2c's four shapes and on the four coarsest levels alone, beside the atomic
adds each design rule issues (a host count) and each build's waves (the
occupancy calculator's).

    python3 chip_smoke.py --k8 old=build/k8/old.cu --k9 old=build/k9/old.cu

does the same for the point-splat and the ray-cast kernels on phase 10's
object: each build (the tree's C interface) is held bit-equal to
``splat_plain`` or ``voxel_cast_plain``, and all are timed in turns at phase
10's shapes.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from nerf_prv_tpu_torch.core.config import CameraConfig, Config  # noqa: E402
from nerf_prv_tpu_torch.core.pose import camera_to_world  # noqa: E402
from nerf_prv_tpu_torch.core.transforms import (  # noqa: E402
    add_frame, load_transforms, make_root, scaled_camera, unmap_pose, write_transforms,
)
from nerf_prv_tpu_torch.labeling import labels as labels_mod  # noqa: E402
from nerf_prv_tpu_torch.labeling.labels import fit_objects  # noqa: E402
from nerf_prv_tpu_torch.labeling.lognormal import fit_batch  # noqa: E402
from nerf_prv_tpu_torch.nerf import api as api_mod  # noqa: E402
from nerf_prv_tpu_torch.nerf import batch_train as batch_mod  # noqa: E402
from nerf_prv_tpu_torch.nerf import model as model_mod  # noqa: E402
from nerf_prv_tpu_torch.nerf import render as render_mod  # noqa: E402
from nerf_prv_tpu_torch.nerf import train as train_mod  # noqa: E402
from nerf_prv_tpu_torch.nerf import voxelfield  # noqa: E402
from nerf_prv_tpu_torch.nerf.api import (  # noqa: E402
    eval_nerf, load_snapshot, run, save_snapshot, screenshot_nerf,
)
from nerf_prv_tpu_torch.nerf.hashgrid import (  # noqa: E402
    _CORNERS, HashGridConfig, _corner_indices, encode, init_table,
)
from nerf_prv_tpu_torch.nerf.metrics import mse2psnr  # noqa: E402
from nerf_prv_tpu_torch.nerf.model import NerfConfig, init_params  # noqa: E402
from nerf_prv_tpu_torch.nerf.rays import grid_cameras, load_dataset, pixel_dirs_cam, ray_sphere  # noqa: E402
from nerf_prv_tpu_torch.nerf.render import render_views  # noqa: E402
from nerf_prv_tpu_torch.ops import _build  # noqa: E402
from nerf_prv_tpu_torch.ops import fused as fused_mod  # noqa: E402
from nerf_prv_tpu_torch.ops.frames_u8 import frames_to_u8, frames_to_u8_plain  # noqa: E402
from nerf_prv_tpu_torch.ops.hash_encode import hash_encode, hash_encode_backward  # noqa: E402
from nerf_prv_tpu_torch.ops.row_gather import row_gather, row_gather_plain  # noqa: E402
from nerf_prv_tpu_torch.ops.row_scatter_add import row_scatter_add, row_scatter_add_plain  # noqa: E402
from nerf_prv_tpu_torch.ops import splat as splat_mod  # noqa: E402
from nerf_prv_tpu_torch.ops import voxel_cast as cast_mod  # noqa: E402
from nerf_prv_tpu_torch.ops.sorted_grad import _levelwise_indices_weights, table_grad_sorted  # noqa: E402
from nerf_prv_tpu_torch.ops.splat import splat, splat_plain  # noqa: E402
from nerf_prv_tpu_torch.ops.voxel_cast import voxel_cast, voxel_cast_plain  # noqa: E402
from nerf_prv_tpu_torch.convert import prvnet_state_dict_from_flax, prvnet_state_dict_to_flax  # noqa: E402
from nerf_prv_tpu_torch.experiments import launches as launch_counts  # noqa: E402
from nerf_prv_tpu_torch.experiments import runs as experiment_runs  # noqa: E402
from nerf_prv_tpu_torch.pipeline import coverage as coverage_mod  # noqa: E402
from nerf_prv_tpu_torch.pipeline import modes as modes_mod  # noqa: E402
from nerf_prv_tpu_torch.pipeline import nbv as nbv_mod  # noqa: E402
from nerf_prv_tpu_torch.pipeline.coverage import generate_novel_sets, get_coverage  # noqa: E402
from nerf_prv_tpu_torch.pipeline.nbv import NBVRunner  # noqa: E402
from nerf_prv_tpu_torch.planning.tsp import GlobalPathPlanner  # noqa: E402
from nerf_prv_tpu_torch.labeling.dataset import CATEGORY_PREFIXES, build_dataset, select_labels  # noqa: E402
from nerf_prv_tpu_torch.parallel import mesh as parallel_mesh  # noqa: E402
from nerf_prv_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from nerf_prv_tpu_torch.parallel.mesh import make_mesh, shard_rows  # noqa: E402
from nerf_prv_tpu_torch.prvnet import train as prv_train_mod  # noqa: E402
from nerf_prv_tpu_torch.prvnet.data import PVBDataset, PVBPretrainDataset, load_rgb, read_split  # noqa: E402
from nerf_prv_tpu_torch.prvnet.infer import BudgetPredictor  # noqa: E402
from nerf_prv_tpu_torch.prvnet.model import IMG_PATTERN, make_pvbnet, make_pvbpretrain  # noqa: E402
from nerf_prv_tpu_torch.prvnet.train import (  # noqa: E402
    TrainConfig, load_checkpoint, pretrain, train_regression,
)
from nerf_prv_tpu_torch.planning.local_path import (  # noqa: E402
    CIRCLE_PATH, LINE_PATH, WRONG_PATH, local_path, pairwise_lengths,
)
from nerf_prv_tpu_torch.planning.tsp import precompute_paths  # noqa: E402
from nerf_prv_tpu_torch.runtime import native  # noqa: E402
from nerf_prv_tpu_torch.scene.mesh_sampling import sample_and_voxelize  # noqa: E402
from nerf_prv_tpu_torch.scene import object_setup as object_setup_mod  # noqa: E402
from nerf_prv_tpu_torch.scene.object_setup import _ensure_viewspace, load_object  # noqa: E402
from nerf_prv_tpu_torch.scene.ply import load_ply  # noqa: E402
from nerf_prv_tpu_torch.scene.render import _colors01, _points, _world_to_camera, object_pixel_rate  # noqa: E402
from nerf_prv_tpu_torch.scene.voxel import precept, precept_rays  # noqa: E402
from nerf_prv_tpu_torch.viewspace.hemisphere import (  # noqa: E402
    ViewSpace, generate_hemisphere, load_path_order, load_view_space, save_view_space,
)

# the hash-encode wrapper's module (the package exports the function under
# the module's name, so ``import`` yields the function)
hash_encode_mod = sys.modules[hash_encode.__module__]
_MASKED_GATHER = parallel_mesh._masked_gather  # phase 14's broken variants stand in for it

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and f32 rate
# outside the tensor cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50e6  # the H100's L2 cache (the on-chip-measurement guide's 50 MB)
COLD_SPAN = 4  # a cold timing cycles its calls over copies of the inputs that hold this many L2s
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12  # dense, the tensor cores

ENCODE_TOL = 1e-5  # f32 blend of table values in [-1, 1]; FMA vs mul+add
# dB between kernel and plain-encode renders of the served frame.  On an
# H100 80GB HBM3 (700 W): 120 dB (the cap) through the right kernel, but
# only 63.0-64.4 dB through a kernel that zeroes one level, so 60 dB would
# not hold the kernel
SERVE_PSNR_MIN = 90.0
# f32 renders, card vs CPU, other summation orders: measured 1.5e-4 on an
# H100 80GB HBM3 (700 W), and 1.3e-2 to 1.5e-2 with one level zeroed
CPU_RENDER_TOL = 3e-4
CHUNK_RAYS = 1 << 14  # the hash field's render chunk (render._default_chunk)
PROBE_N = CHUNK_RAYS * 24  # render_coarse probes per chunk
MARCH_N = CHUNK_RAYS * 32  # aux-less render_n_samples per chunk

CAMERA = CameraConfig()  # 1280x720
N_TRAIN_FRAMES = 16
N_TEST_FRAMES = 4  # held out: another spiral than the training views
VOXEL_CFG = NerfConfig()  # the default: full-width voxel field, 2,500 steps
N_STEPS = VOXEL_CFG.n_steps

# the row kernels' shapes: the TPU experiments' (4,096 rays x 96 samples,
# and 131,072 updates) and the voxel paths' own
E_N = 393_216
E2_N = 131_072
VOXEL_CHUNK = 1 << 17  # the voxel field's render chunk
PROBE2_N = VOXEL_CHUNK * VOXEL_CFG.render_probe_fine
EVAL_MARCH_N = VOXEL_CHUNK * VOXEL_CFG.render_n_samples

# training must pull the mean loss of the last 100 steps below this share
# of the mean of the first 20 (a field that learns nothing stays near 1);
# measured 0.0087 on an H100 80GB HBM3 (700 W)
LOSS_DROP = 0.05
# dB by which the trained field's eval PSNR must beat an all-black frame's
# on the held-out views; measured 43.39 against 19.72 dB, 23.7 dB above
PSNR_MARGIN_DB = 15.0
# one step through the kernels against the plain versions: the forward is
# bit-identical (the gather is exact), so the loss and the MLP gradients
# differ only through the f32 summation order of the grid's gradient.
# Measured 0 and 3.5e-8; a gather off by one row gives 11.6 and 1.2, a
# scatter-add that drops duplicates 0 and 0.91
STEP_LOSS_TOL = 1e-6  # relative
STEP_GRAD_TOL = 1e-5  # max |a - b| / max |b| per parameter
# dB between the card's and the CPU's f32 render of one small voxel frame;
# a probe threshold may flip a single ray, so PSNR rather than a max.
# Measured 120 dB (the cap, max difference 7.0e-6); 29.3 dB through a
# gather off by one row
VOXEL_CPU_PSNR_MIN = 60.0


# the hash field that trains: full width (16 levels x 2^19 rows x 2 f32, a
# 64 MiB table; hidden 64; 4,096 rays), the full 2,500 steps
HASH_CFG = NerfConfig(field_impl="hash", encode_impl="fused")
HASH_STEPS = HASH_CFG.n_steps
# the table gradient's two shapes: 4,096 rays x 48 warmup samples, x 16 tight ones
BWD_WARM_N = HASH_CFG.train_rays * HASH_CFG.train_warmup_samples
BWD_TIGHT_N = HASH_CFG.train_rays * HASH_CFG.n_samples
# the tight step's no-grad probe: 4,096 rays x 12 probes through the forward
TRAIN_PROBE_N = HASH_CFG.train_rays * HASH_CFG.train_coarse
# |kernel - sorted plain version| as a share of the largest entry: the plain
# version takes a run's total as the difference of two entries of one f32
# cumsum over all N x 16 x 8 updates, so it is the looser of the two
# (measured 3.9e-5 to 1.3e-4, all of it the plain version's distance from
# the float64 sum; the kernel's own is 2e-7 to 8e-7)
SORTED_TOL = 1e-3
# dB by which the trained hash field's eval PSNR must beat an all-black
# frame's on the held-out views; measured 44.70 against 19.72 dB, 25.0 dB
# above, on an H100 80GB HBM3 (700 W)
HASH_PSNR_MARGIN_DB = 15.0
# one hash step through the kernels against the plain versions, f32 compute
# (relative loss difference; worst gradient difference over its max).
# Measured 0 to 3.9e-7 and 2.1e-5 to 5.2e-5 (the table's, whose plain version
# sums through one long f32 cumsum; the MLPs' 4e-7 to 6e-7); a table gradient
# that lands one level too high gives 1.1 to 1.6
HASH_STEP_LOSS_TOL = 1e-5
HASH_STEP_GRAD_TOL = 1e-3
# dB between the span-bucketed and the unbucketed render of two trained
# frames; measured 49.67 dB with 1.6% of the values changed, on an H100 80GB
# HBM3 (700 W)
SPAN_BUCKET_PSNR_MIN = 40.0
SPAN_BUCKET_CHUNK = 1 << 15
OPTION_STEPS = 150  # depth of each option's short training run

# phase 10, the coverage-dataset path at the reference's full width: the L0
# sampling defaults, the default camera, 50 coverage and 100 + 100 novel views
OBJ_NAME = "procedural0"
OBJ_POINTS = 500_000
OBJ_GRID = 1024
COVERAGE_VIEWS = 50
# rows of one 1280x720 view whose rays K9 is held against the plain march
# on (the plain version materialises 1,000 steps a ray)
CAST_ROWS = (320, 400)
# the voxel field trained on the port-rendered coverage set, scored on the
# novel test views: steps, and the dB by which its eval PSNR must beat an
# all-black frame's; measured 32.40 against 16.30 dB, 16.1 dB above, on an
# H100 80GB HBM3 (700 W)
COVERAGE_STEPS = 500
COVERAGE_PSNR_MARGIN_DB = 10.0
# the broken K8 and K9 variants (edited copies of the sources) the checks must
# catch, each with the point size (K8) at which it must show
SPLAT_BROKEN = {
    "ties to the lowest index": [
        ("if (q.z <= add(zmin, 1e-7f) && winner[p] < i) atomicMax(winner + p, i);",
         "if (q.z <= add(zmin, 1e-7f)) atomicMax(winner + p, 2147483646 - i);"),
        ("    const int w = winner[p];\n",
         "    const int w = winner[p] < 0 ? -1 : 2147483646 - winner[p];\n"),
    ],
    "roundf in place of round half to even": [
        ("rintf(__fmaf_rn(x, c.fx, c.ppx))", "roundf(__fmaf_rn(x, c.fx, c.ppx))"),
        ("rintf(__fmaf_rn(y, c.fy, c.ppy))", "roundf(__fmaf_rn(y, c.fy, c.ppy))"),
    ],
    "a splat binned only into the tile of its centre": [
        ("  q.tu0 = q.u0 / kTile;\n  q.tu1 = q.u1 / kTile;\n", "  q.tu0 = q.tu1 = min(max(ui, q.u0), q.u1) / kTile;\n"),
        ("  q.tv0 = q.v0 / kTile;\n  q.tv1 = q.v1 / kTile;\n", "  q.tv0 = q.tv1 = min(max(vi, q.v0), q.v1) / kTile;\n"),
    ],
}
CAST_BROKEN = {
    "returns the last hit": [("      found = true;\n      break;", "      found = true;")],
    "marches an interval one step too tight": [("constexpr int kMarginSteps = 2;", "constexpr int kMarginSteps = -1;")],
}


def log(*a):
    print(*a, flush=True)


def sync():
    torch.cuda.synchronize()


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of one call of ``fn`` as its caller sees it: two CUDA
    events around ``iters`` Python calls.  Where the host needs longer for a
    call (checks, ``torch.empty``, the ctypes call: 25-45 us measured) than the
    device for the kernel, this is the host's time, not the kernel's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 50, replays: int = 3) -> float:
    """Mean device time of one ``fn()``, the host's share left out.

    ``iters`` calls are captured into one CUDA graph (the wrappers launch on
    the current stream, ``cudaMemsetAsync`` is capturable and ``torch.empty``
    draws from the graph's pool); the graph is replayed once to warm up and
    then ``replays`` times between two CUDA events.  A replay launches the
    captured kernels back to back from the device's own queue: no Python,
    no ctypes call and no allocator runs inside the timed span.
    """
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def enqueue_ms(fn, iters: int = 50) -> float:
    """Host time of one ``fn()`` that only enqueues work (host clock, no
    wait for the device inside the span)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e3


# device_ms against time_ms: where a call's host work takes at most this
# share of the kernel's device time, the device is never idle between two
# calls and the two figures must agree within CALL_AGREES.  The host's time
# per call wanders (0.02-0.08 ms for the same call on H100 hosts) and the
# scatter-add's two launches leave a gap the graph does not have (5-6% at a
# share of 0.4), so the share leaves room and the call time is the best of
# three rounds
HOST_SHARE_MAX = 0.4
CALL_AGREES = 0.10


def kernel_times(fn, label: str) -> dict:
    """``ms`` (device), ``call_ms`` (through the wrapper) and ``host_ms``
    (enqueue only) of one kernel call, cross-checked: where the kernel
    outlasts the host the first two agree within CALL_AGREES, or the run
    fails.  ``call_checked`` says whether the comparison could be made."""
    t = dict(ms=device_ms(fn), call_ms=min(time_ms(fn, iters=50) for _ in range(3)),
             host_ms=enqueue_ms(fn))
    if t["host_ms"] <= HOST_SHARE_MAX * t["ms"]:
        if abs(t["call_ms"] - t["ms"]) > CALL_AGREES * t["ms"]:
            raise SystemExit(
                f"{label}: device {t['ms']:.4f} ms and call {t['call_ms']:.4f} ms differ by more than "
                f"{CALL_AGREES:.0%} though the host needs only {t['host_ms']:.4f} ms per call")
        t["call_checked"] = True
    else:
        t["call_checked"] = False  # call_ms is the host's time here
    return t


def times_text(t: dict) -> str:
    note = f"agree within {CALL_AGREES:.0%}" if t["call_checked"] else "host too slow to compare"
    return f"device {t['ms']:.4f} ms, call {t['call_ms']:.4f} ms, host {t['host_ms']:.4f} ms ({note})"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def phase_build():
    log("== phase 1: build")
    t0 = time.perf_counter()
    logs = _build.build(["hash_encode", "hash_encode_backward", "row_gather", "row_scatter_add", "splat",
                         "voxel_cast", "frames_u8"])
    log(f"built in {time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def table_rows_touched(x: torch.Tensor, cfg: HashGridConfig) -> int:
    """Distinct table rows that encoding ``x`` reads, summed over levels.

    A dense level holds only (res+1)^3 of its T rows, and a hashed level
    is read only where a corner of ``x``'s cells lands.
    """
    rows = 0
    for res in cfg.resolutions():
        res = int(res)
        cell = torch.clamp(torch.floor(x * float(res)), 0, res - 1).to(torch.int64)
        idx = torch.cat([
            _corner_indices(cell + torch.tensor(c, device=x.device), res, cfg.table_size)
            for c in _CORNERS
        ])
        rows += int(torch.unique(idx).numel())
    return rows


def encode_bound_ms(x: torch.Tensor, cfg: HashGridConfig) -> tuple:
    """Least time for one encode call of ``x``: x and the table rows it
    needs read once and the output written once over HBM, or its f32
    arithmetic at the f32 peak."""
    n = x.shape[0]
    bytes_moved = 4 * (n * 3 + table_rows_touched(x, cfg) * cfg.features + n * cfg.out_dim)
    # per (point, level): 3 scale + 3 frac + 3 (1 - frac), then per corner
    # 2 weight products and F multiply-adds
    ops = n * cfg.levels * (9 + 8 * (2 + 2 * cfg.features))
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_hash_field(dev) -> tuple:
    """The served hash field: the full-width config and random weights."""
    cfg = NerfConfig(field_impl="hash", encode_impl="fused")
    params = init_params(torch.Generator(device=dev).manual_seed(1), cfg, device=dev)
    # init_params' table is +-1e-4, which leaves the MLPs blind to the
    # encode; at +-1 the renders depend on every level of the output
    params["table"] *= 1e4
    return cfg, params


def served_chunk_points(params, ds, cfg: NerfConfig) -> tuple:
    """(probe (PROBE_N, 3), march (MARCH_N, 3)) positions of the first chunk
    the tile path serves of frame 0, ray by ray: the 24 midpoint probes on
    each ray's chord as ``_tighten_interval`` places them, and the 32 march
    samples inside the interval that probe (through the field) tightens it
    to, as ``_march_body`` places them."""
    dev = params["table"].device
    t = render_mod._RENDER_TILE
    origins = torch.as_tensor(ds.origins[:1], dtype=torch.float32, device=dev)
    rotations = torch.as_tensor(ds.rotations[:1], dtype=torch.float32, device=dev)
    npad = (-ds.camera.height * ds.camera.width) % t
    od_t, order_t, _ = render_mod._assemble_tiles(
        origins, rotations, render_mod._pixel_dirs(ds.camera, dev), t, npad)
    rays = od_t[order_t[: CHUNK_RAYS // t]].reshape(-1, 6)
    if rays.shape[0] != CHUNK_RAYS:
        raise SystemExit("frame 0 has less than one chunk of active tiles")
    o, d = rays[:, :3], rays[:, 3:]
    tmin, tmax, valid = ray_sphere(o, d)

    def midpoints(lo, hi, k):
        base = torch.arange(k, dtype=torch.float32, device=dev)[None, :] + 0.5
        ts = lo[:, None] + base * ((hi - lo) / k)[:, None]
        pos = torch.clamp(o[:, None, :] + d[:, None, :] * ts[..., None], 0.0, 1.0 - 1e-6)
        return pos.reshape(-1, 3).contiguous()

    with torch.no_grad():
        tlo, thi, _ = render_mod._tighten_interval(
            params, o, d, tmin, tmax, valid, cfg.render_coarse, cfg)
    return midpoints(tmin, tmax, cfg.render_coarse), midpoints(tlo, thi, MARCH_N // CHUNK_RAYS)


def same_cell_share(x: torch.Tensor, res: int) -> float:
    """Share of points that lie in the cell of the point before them."""
    cell = torch.clamp(torch.floor(x * float(res)), 0, res - 1)
    return float((cell[1:] == cell[:-1]).all(dim=-1).float().mean())


def check_encode(table, x, cfg: HashGridConfig, label: str) -> float:
    """The kernel against ``hashgrid.encode`` on ``x``, level by level."""
    n = x.shape[0]
    got = hash_encode(table, x, cfg)
    want = encode(table, x, cfg)
    sync()
    err = (got - want).abs().reshape(n, cfg.levels, cfg.features).amax(dim=(0, 2)).cpu()
    log(f"max |kernel - plain| per level, {label}: " + " ".join(f"{e:.1e}" for e in err.tolist()))
    if not (torch.isfinite(got).all() and bool((err <= ENCODE_TOL).all())):
        raise SystemExit(f"hash_encode disagrees with hashgrid.encode beyond {ENCODE_TOL} ({label})")
    return float(err.max())


def encode_row(table, pts, cfg: HashGridConfig, label: str, max_err: float) -> dict:
    """One shape of K1's table: its times beside the plain version's and its bound."""
    row = dict(shape=label, max_abs_err=max_err, library_ms=None)
    row.update(kernel_times(lambda: hash_encode(table, pts, cfg), f"hash_encode {label}"))
    row["plain_ms"] = time_ms(lambda: encode(table, pts, cfg), iters=3, warmup=1)
    row["bound_ms"], row["bound_by"] = encode_bound_ms(pts, cfg)
    log(f"hash_encode {label}: {times_text(row)}, plain {row['plain_ms']:.4f} ms, "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}) = {row['bound_ms'] / row['ms']:.3f} of the time")
    return row


def encode_point_sets(dev, params, ds, cfg: NerfConfig) -> dict:
    """The points K1 is checked and timed on: uniform ones with the cube's
    boundaries among them, and one served chunk's, at both path shapes."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((MARCH_N + 37, 3), generator=g, device=dev)  # not a multiple of any block
    x[:5] = torch.tensor(
        [[0.0, 0.0, 0.0], [1 - 1e-6] * 3, [1.0, 1.0, 1.0], [0.0, 1.0, 1 - 1e-6], [1.0, 0.5, 0.0]],
        device=dev,
    )
    probe, march = served_chunk_points(params, ds, cfg)
    res = [int(r) for r in cfg.grid.resolutions()]
    for name, pts in (("probe", probe), ("march", march)):
        log(f"served {name} points {tuple(pts.shape)}: share in the cell of the point before, by level: "
            + " ".join(f"{same_cell_share(pts, r):.2f}" for r in res))
    return {
        "uniform ragged": x,
        f"march N={MARCH_N} uniform": x[:MARCH_N].contiguous(),
        f"march N={MARCH_N} ray-ordered": march,
        f"probe N={PROBE_N} uniform": x[:PROBE_N].contiguous(),
        f"probe N={PROBE_N} ray-ordered": probe,
    }


def phase_kernel_check(dev, params, ds, nerf_cfg: NerfConfig) -> dict:
    log("== phase 2a: hash_encode kernel against hashgrid.encode")
    cfg = nerf_cfg.grid
    table = params["table"]
    sets = encode_point_sets(dev, params, ds, nerf_cfg)
    ragged = sets.pop("uniform ragged")
    ray_march = sets[f"march N={MARCH_N} ray-ordered"]
    ray_probe = sets[f"probe N={PROBE_N} ray-ordered"]
    max_err = max(
        check_encode(table, ragged, cfg, f"default config, uniform N={ragged.shape[0]}"),
        check_encode(table, ray_probe, cfg, "default config, served probe points"),
        check_encode(table, ray_march, cfg, "default config, served march points"),
    )
    g = torch.Generator(device=dev).manual_seed(4)
    for other in (HashGridConfig(log2_table=14), HashGridConfig(features=4)):
        note = f"log2_table={other.log2_table} features={other.features}"
        t2 = init_table(g, other, scale=1.0, device=dev)
        check_encode(t2, ragged, other, f"{note}, uniform")
        check_encode(t2, ray_march, other, f"{note}, served march points")
        del t2

    rows = [encode_row(table, pts, cfg, label, max_err) for label, pts in sets.items()]
    head = rows[1]  # the march's own points
    return dict(
        name="hash_encode", route="cuda",
        source="nerf_prv_tpu_torch/ops/csrc/hash_encode.cu",
        replaces="nerf_prv_tpu/ops/hash_encode.py:31",
        launches=0, **{k: head[k] for k in
                       ("max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        shape=head["shape"], shapes=rows,
    )


def build_sources(specs: list, tag: str, bind) -> dict:
    """nvcc every ``name=path`` source (all started together) into the build
    directory; returns name -> library bound by ``bind``."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for spec in specs:
        name, _, path = spec.partition("=")
        out = _build.BUILD_DIR / f"{tag}-{name}-{os.getpid()}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), path]
        running.append((name, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, out, proc in running:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{text}")
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
        libs[name] = bind(ctypes.CDLL(str(out)))
    return libs


@contextlib.contextmanager
def wrapper_library(loader: str, lib, module=hash_encode_mod):
    """Send a wrapper's launches to another build: ``loader`` is the wrapper
    module's function that returns the built library, ``_lib``
    (``hash_encode``, ``splat``, ``voxel_cast``) or ``_lib_backward``
    (``hash_encode_backward``)."""
    saved = getattr(module, loader)
    setattr(module, loader, lambda: lib)
    try:
        yield
    finally:
        setattr(module, loader, saved)


def compare_k1(dev, specs: list, card: str):
    """Other builds of the hash-encode kernel against this tree's, in turns
    on one card: first to last and back, two device times each per shape."""
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        ds = load_dataset(write_scene(root, dev, "test", 1, turn=0.5))
    nerf_cfg, params = make_hash_field(dev)
    cfg, table = nerf_cfg.grid, params["table"]
    libs = {"tree": hash_encode_mod._lib()}
    libs.update(build_sources(specs, "k1", hash_encode_mod.bind))
    sets = encode_point_sets(dev, params, ds, nerf_cfg)
    ragged = sets.pop("uniform ragged")
    coarse = coarse_levels(cfg)  # resolutions 16, 22, 30, 42
    want = encode(table, ragged, cfg)
    for name, lib in libs.items():
        with wrapper_library("_lib", lib):
            got = hash_encode(table, ragged, cfg)
        sync()
        log(f"{name}: max |kernel - plain| {float((got - want).abs().max()):.3e}")
    order = list(libs) + list(reversed(libs))
    cases = [(label, pts, cfg) for label, pts in sets.items()]
    cases.append(("levels 0-3 only, march ray-ordered", sets[f"march N={MARCH_N} ray-ordered"], coarse))
    cases.append(("levels 0-3 only, march uniform", sets[f"march N={MARCH_N} uniform"], coarse))
    for label, pts, c in cases:
        tab = table[: c.levels * c.table_size]
        bound, by = encode_bound_ms(pts, c)
        times = {name: [] for name in libs}
        for name in order:
            with wrapper_library("_lib", libs[name]):
                times[name].append(device_ms(lambda: hash_encode(tab, pts, c)))
        log(f"{label} (bound {bound:.5f} ms, {by}; {card}): " + "; ".join(
            f"{name} {a:.4f} {b:.4f}" for name, (a, b) in times.items()))


class BatchSource:
    """A training set on the device, set up as ``train`` sets it up: uint8
    pixels, cameras and the sphere-hit pool; ``draw`` samples as its loop does."""

    def __init__(self, ds, dev):
        self.camera = ds.camera
        self.pixels = torch.from_numpy(
            np.clip(ds.pixels * 255.0 + 0.5, 0, 255).astype(np.uint8)).to(dev)
        self.rot = torch.as_tensor(ds.rotations, device=dev)
        self.org = torch.as_tensor(ds.origins, device=dev)
        self.pool, self.n_hit = train_mod.build_hit_pool(self.rot, self.org, ds.camera)

    def draw(self, g: torch.Generator, cfg: NerfConfig, n_samples: int = 0):
        """((origins, dirs, target, bg), jitter) for one step at ``cfg``."""
        batch = train_mod._sample_batch_pooled(
            g, self.pixels, self.rot, self.org, self.camera, cfg.train_rays, self.pool, self.n_hit)
        jitter = torch.rand(
            (cfg.train_rays, n_samples or cfg.n_samples), generator=g, device=self.pixels.device)
        return batch, jitter


def ray_ordered_indices(source: BatchSource, cfg: NerfConfig, n_samples: int, seed: int = 3,
                        midpoints: bool = False):
    """Grid row indices of one real training batch, ray by ray: cfg.train_rays
    rays drawn from the scene's hit pool, ``n_samples`` stratified samples
    along each ray's chord (or their midpoints, as the no-grad probe of a
    tight step places them), through ``cell_and_frac``."""
    dev = source.pixels.device
    (o, d, _, _), jitter = source.draw(torch.Generator(device=dev).manual_seed(seed), cfg, n_samples)
    if midpoints:
        jitter = 0.5
    tmin, tmax, _ = ray_sphere(o, d)
    base = torch.arange(n_samples, dtype=torch.float32, device=dev)[None, :]
    ts = tmin[:, None] + (base + jitter) * ((tmax - tmin) / n_samples)[:, None]
    pos = torch.clamp(o[:, None, :] + d[:, None, :] * ts[..., None], 0.0, 1.0 - 1e-6)
    idx, _ = voxelfield.cell_and_frac(pos.reshape(-1, 3), cfg.voxel_grid_size)
    return idx.contiguous()


def cold_copies(args: tuple) -> int:
    """Copies of ``args`` enough that the calls between two turns of one
    copy read COLD_SPAN times the L2."""
    return math.ceil(COLD_SPAN * L2_BYTES / sum(a.numel() * a.element_size() for a in args)) + 1


def cold_calls(fn, args: tuple):
    """``fn`` over :func:`cold_copies` copies of ``args``, a different copy
    each call, so every call finds its inputs in HBM, as the HBM byte bound
    assumes (a call whose inputs stay in the L2 across back-to-back calls
    can beat that bound)."""
    sets = itertools.cycle([tuple(a.clone() for a in args) for _ in range(cold_copies(args))])
    return lambda: fn(*next(sets))


def gather_bound_ms(table, idx) -> float:
    """Bytes over the HBM rate: the indices and the distinct rows they name
    read once, the output written once.  The kernel does no arithmetic."""
    row_bytes = table.shape[1] * table.element_size()
    rows = int(torch.unique(idx).numel())
    moved = idx.numel() * idx.element_size() + rows * row_bytes + idx.numel() * row_bytes
    return moved / HBM_BYTES_PER_S * 1e3


def scatter_bound_ms(idx, upd, n_rows) -> tuple:
    """Bytes (indices and updates read once, the output written once) over
    the HBM rate, or one f32 add per element at the f32 peak."""
    moved = idx.numel() * idx.element_size() + 4 * upd.numel() + 4 * n_rows * upd.shape[1]
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = upd.numel() / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_gather(table, idx, note, cold: bool = False) -> dict:
    """One row_gather shape: exact equality with the plain version, then
    kernel, plain, library and bound times.  ``cold``: every call reads
    its own copy of the table and indices (:func:`cold_calls`), for a shape
    whose working set fits in the L2; the time of back-to-back calls on one
    copy is kept as ``warm_ms``."""
    dtype = "f32" if table.dtype == torch.float32 else "bf16"
    label = f"{dtype} {tuple(table.shape)} N={idx.numel()} {note}"
    got = row_gather(table, idx)
    want = row_gather_plain(table, idx)
    sync()
    if got.shape != want.shape or got.dtype != table.dtype:
        raise SystemExit(f"row_gather {label}: shape or dtype {tuple(got.shape)} {got.dtype}")
    as_bits = torch.int32 if table.dtype == torch.float32 else torch.int16
    if not torch.equal(got.view(as_bits), want.view(as_bits)):
        raise SystemExit(f"row_gather {label} is not bit-equal to table[idx]")
    err = float((got.float() - want.float()).abs().max()) if idx.numel() else 0.0
    row = dict(shape=label, max_abs_err=err, bound_ms=0.0, ms=0.0, call_ms=0.0, plain_ms=0.0, library_ms=0.0)
    if idx.numel():
        def timed(fn):
            return cold_calls(fn, (table, idx)) if cold else (lambda: fn(table, idx))
        row.update(
            kernel_times(timed(row_gather), f"row_gather {label}"),
            plain_ms=device_ms(timed(row_gather_plain), iters=20),
            library_ms=device_ms(timed(lambda t, i: torch.index_select(t, 0, i)), iters=20),
            bound_ms=gather_bound_ms(table, idx),
        )
        row["bound_share"] = row["bound_ms"] / row["ms"]
        note = ""
        if cold:
            row["warm_ms"] = device_ms(lambda: row_gather(table, idx))
            note = (f" (inputs cycled over {cold_copies((table, idx))} copies; warm, one copy "
                    f"in the L2, device {row['warm_ms']:.4f} ms)")
        log(f"row_gather {label}: equal; {times_text(row)}{note}, table[idx] {row['plain_ms']:.4f} ms, "
            f"index_select {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms (bytes), "
            f"{row['bound_share']:.0%} of it")
    return row


def check_scatter(idx, upd, n_rows, label, cold: bool = False) -> dict:
    """One row_scatter_add shape against index_add_ and a float64 sum;
    ``cold`` as for :func:`check_gather`, over copies of the indices and
    updates.

    The tolerance is the f32 summation bound itself: a row that receives k
    updates is the result of k rounded adds, each off by at most 2^-24 of
    a partial sum that never exceeds the row's sum of |updates|; so
    |kernel - float64| <= k * 2^-24 * sum|upd| per element, whatever the
    order the atomics ran in (a few hundred terms per row at most here).
    """
    got = row_scatter_add(idx, upd, n_rows)
    plain = row_scatter_add_plain(idx, upd, n_rows)
    sync()
    i64 = idx.to(torch.int64)
    want = torch.zeros((n_rows, upd.shape[1]), dtype=torch.float64, device=upd.device)
    want.index_add_(0, i64, upd.double())
    mag = torch.zeros_like(want).index_add_(0, i64, upd.double().abs())
    count = torch.bincount(i64, minlength=n_rows).double()[:, None]
    tol = count * 2.0 ** -24 * mag
    err = (got.double() - want).abs()
    if got.shape != plain.shape or not bool((err <= tol).all()):
        raise SystemExit(
            f"row_scatter_add {label}: off the float64 sum by {float((err - tol).max()):.3e} beyond the bound"
        )
    vs_plain = float((got - plain).abs().max())
    if not bool(((got - plain).abs().double() <= 2 * tol).all()):
        raise SystemExit(f"row_scatter_add {label} disagrees with index_add_ by {vs_plain:.3e}")
    row = dict(shape=label, max_abs_err=vs_plain, plain_ms=0.0, library_ms=0.0)
    row["bound_ms"], row["bound_by"] = scatter_bound_ms(idx, upd, n_rows)

    def timed(fn):
        return cold_calls(fn, (idx, upd)) if cold else (lambda: fn(idx, upd))

    # with no updates the call is its memset alone: timed too, so that the
    # kernel's own share of a call can be told from the zeroing's
    row.update(kernel_times(timed(lambda i, u: row_scatter_add(i, u, n_rows)), f"row_scatter_add {label}"))
    row["bound_share"] = row["bound_ms"] / row["ms"]
    if idx.numel():
        zero = torch.zeros((n_rows, upd.shape[1]), dtype=torch.float32, device=upd.device)
        row.update(
            plain_ms=device_ms(timed(lambda i, u: row_scatter_add_plain(i, u, n_rows)), iters=20),
            library_ms=device_ms(timed(lambda i, u: torch.index_add(zero, 0, i, u)), iters=20),
        )
    note = ""
    if cold:
        row["warm_ms"] = device_ms(lambda: row_scatter_add(idx, upd, n_rows))
        note = (f" (inputs cycled over {cold_copies((idx, upd))} copies; warm, one copy in "
                f"the L2, device {row['warm_ms']:.4f} ms)")
    log(f"row_scatter_add {label}: max rows' updates {int(count.max())}, |kernel - f64| max "
        f"{float(err.max()):.3e} (bound {float(tol.max()):.3e}), |kernel - index_add_| {vs_plain:.3e}; "
        f"{times_text(row)} (memset included){note}, zeros+index_add_ {row['plain_ms']:.4f} ms, "
        f"index_add {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
        f"{row['bound_share']:.0%} of it")
    return row


def phase_row_kernels(dev, source: BatchSource) -> tuple:
    log("== phase 2b: row_gather and row_scatter_add against their plain versions")
    cfg = VOXEL_CFG
    n_rows = cfg.voxel_grid_size ** 3
    width = 8 * cfg.voxel_features
    g = torch.Generator(device=dev).manual_seed(2)
    grid = torch.rand((n_rows, width), generator=g, device=dev) * 2.0 - 1.0
    grid_bf = grid.to(torch.bfloat16)
    cell_raw = (torch.rand((n_rows, 8), generator=g, device=dev) * 8.0 - 4.0).to(torch.bfloat16)

    def uniform(n):
        return torch.randint(0, n_rows, (n,), generator=g, device=dev, dtype=torch.int32)

    ray96 = ray_ordered_indices(source, cfg, 96)  # 4,096 rays x 96 samples
    ray_tight = ray_ordered_indices(source, cfg, cfg.n_samples)
    ray_warm = ray_ordered_indices(source, cfg, cfg.train_warmup_samples)
    ray_probe = ray_ordered_indices(source, cfg, cfg.train_coarse, midpoints=True)
    # the wrappers do not clamp: the range is checked here, once, on the
    # indices cell_and_frac gives a real batch
    for name, idx in (("96", ray96), ("tight", ray_tight), ("warmup", ray_warm), ("probe", ray_probe)):
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi >= n_rows:
            raise SystemExit(f"cell_and_frac gave a row outside [0, {n_rows}): {lo}..{hi}")
    runs = float((ray96[1:] != ray96[:-1]).sum() + 1)
    log(f"ray-ordered indices, {cfg.train_rays} rays x 96: {ray96.numel() / runs:.2f} consecutive "
        f"samples per cell, {int(torch.unique(ray96).numel())} distinct rows, range ok")

    gathers = [
        check_gather(grid_bf, ray_tight, "tight-step march, ray-ordered"),
        check_gather(grid_bf, ray_probe, "tight-step probe, ray-ordered"),
        check_gather(grid_bf, ray_warm, "warmup-step march, ray-ordered"),
        check_gather(grid, uniform(E_N), "uniform"),
        check_gather(grid_bf, uniform(E_N), "uniform"),
        check_gather(grid_bf, ray96, "ray-ordered"),
        check_gather(grid_bf, uniform(EVAL_MARCH_N), "eval march chunk"),
        check_gather(cell_raw, uniform(PROBE2_N), "level-2 probe chunk"),
        check_gather(grid, uniform(E_N + 37).to(torch.int64), "int64 ragged"),
        check_gather(grid_bf, uniform(0), ""),
    ]

    def upd(n):
        return torch.rand((n, width), generator=g, device=dev) * 2.0 - 1.0

    scatters = [
        check_scatter(ray_tight, upd(ray_tight.numel()), n_rows,
                      f"N={ray_tight.numel()} tight-step march, ray-ordered"),
        check_scatter(ray_warm, upd(ray_warm.numel()), n_rows,
                      f"N={ray_warm.numel()} warmup march, ray-ordered"),
        check_scatter(uniform(E_N), upd(E_N), n_rows, f"N={E_N} uniform"),
        check_scatter(ray96, upd(ray96.numel()), n_rows, f"N={ray96.numel()} ray-ordered"),
        check_scatter(uniform(E2_N), upd(E2_N), n_rows, f"N={E2_N} uniform"),
        check_scatter(ray96[:E2_N].contiguous(), upd(min(E2_N, ray96.numel())), n_rows,
                      f"N={min(E2_N, ray96.numel())} ray-ordered"),
        check_scatter(uniform(E_N + 37).to(torch.int64), upd(E_N + 37), n_rows, f"N={E_N + 37} int64 ragged"),
        check_scatter(uniform(0), upd(0), n_rows, "N=0 (the memset alone)"),
    ]
    # one tight step's three launches on the device, the scatter-add's memset
    # left out as a profile files it among the copies: held against the
    # profiled step in phase 5
    tight_us = 1e3 * (gathers[0]["ms"] + gathers[1]["ms"] + scatters[0]["ms"] - scatters[-1]["ms"])
    log(f"one tight step's row launches: probe gather {gathers[1]['ms'] * 1e3:.1f} us + march gather "
        f"{gathers[0]['ms'] * 1e3:.1f} us + scatter-add {scatters[0]['ms'] * 1e3:.1f} us less its memset "
        f"{scatters[-1]['ms'] * 1e3:.1f} us = {tight_us:.1f} us")

    # the batched trainer's shapes (phase 11): K grids read as one (K*g^3, 8F)
    # table, each object's ray-ordered indices offset by k*g^3
    n_obj = len(BATCH_FRAMES)
    grid_k = (torch.rand((n_obj * n_rows, width), generator=g, device=dev) * 2.0 - 1.0).to(torch.bfloat16)

    def batched(n_samples, midpoints=False):
        return torch.cat([ray_ordered_indices(source, cfg, n_samples, seed=30 + i, midpoints=midpoints) + i * n_rows
                          for i in range(n_obj)]).contiguous()

    b_tight, b_probe = batched(cfg.n_samples), batched(cfg.train_coarse, midpoints=True)
    b_warm = batched(cfg.train_warmup_samples)
    gathers += [
        check_gather(grid_k, b_tight, f"K={n_obj} tight-step march, ray-ordered"),
        check_gather(grid_k, b_probe, f"K={n_obj} tight-step probe, ray-ordered"),
        check_gather(grid_k, b_warm, f"K={n_obj} warmup-step march, ray-ordered"),
    ]
    scatters += [
        check_scatter(b_tight, upd(b_tight.numel()), n_obj * n_rows,
                      f"N={b_tight.numel()} K={n_obj} tight-step march, ray-ordered"),
        check_scatter(b_warm, upd(b_warm.numel()), n_obj * n_rows,
                      f"N={b_warm.numel()} K={n_obj} warmup march, ray-ordered"),
    ]
    # the single-object training shapes again, cold: each call reads its own
    # copy of the inputs, where back to back a shape's working set stays in
    # the L2 (the grid is 8.2 MB) and its bound share can read high
    gathers += [
        check_gather(grid_bf, ray_tight, "tight-step march, ray-ordered, cold", cold=True),
        check_gather(grid_bf, ray_probe, "tight-step probe, ray-ordered, cold", cold=True),
    ]
    scatters += [
        check_scatter(ray_tight, upd(ray_tight.numel()), n_rows,
                      f"N={ray_tight.numel()} tight-step march, ray-ordered, cold", cold=True),
        check_scatter(ray_warm, upd(ray_warm.numel()), n_rows,
                      f"N={ray_warm.numel()} warmup march, ray-ordered, cold", cold=True),
    ]
    # the batched shapes cold too: the K = 4 table (32.8 MB in bf16) and a
    # step's indices fit in the L2 together, so back to back they read warm
    # (the probe gathers without a gradient: it has no scatter-add)
    gathers += [
        check_gather(grid_k, b_tight, f"K={n_obj} tight-step march, ray-ordered, cold", cold=True),
        check_gather(grid_k, b_probe, f"K={n_obj} tight-step probe, ray-ordered, cold", cold=True),
        check_gather(grid_k, b_warm, f"K={n_obj} warmup-step march, ray-ordered, cold", cold=True),
    ]
    scatters += [
        check_scatter(b_tight, upd(b_tight.numel()), n_obj * n_rows,
                      f"N={b_tight.numel()} K={n_obj} tight-step march, ray-ordered, cold", cold=True),
        check_scatter(b_warm, upd(b_warm.numel()), n_obj * n_rows,
                      f"N={b_warm.numel()} K={n_obj} warmup march, ray-ordered, cold", cold=True),
    ]
    gather = dict(
        name="row_gather", route="cuda",
        source="nerf_prv_tpu_torch/ops/csrc/row_gather.cu",
        replaces="experiments/exp_vmem_gather.py:72",
        launches=0, bound_by="bytes", **{k: gathers[0][k] for k in
                                        ("max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms", "library_ms")},
        shape=gathers[0]["shape"], shapes=gathers,
    )
    scatter = dict(
        name="row_scatter_add", route="cuda",
        source="nerf_prv_tpu_torch/ops/csrc/row_scatter_add.cu",
        replaces="experiments/exp_scatter_kernel.py:120",
        also_replaces=["experiments/exp_scatter_banks.py:60", "experiments/exp_vmem_gather.py:124"],
        launches=0, **{k: scatters[0][k] for k in
                       ("max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        shape=scatters[0]["shape"], shapes=scatters,
    )
    return gather, scatter, tight_us


def frames_bound_ms(n: int) -> float:
    """``frames_to_u8``'s byte bound: four bytes read and one written an element."""
    return n * 5 / HBM_BYTES_PER_S * 1e3


def phase_frames_u8(dev) -> dict:
    log("== phase 2d: frames_to_u8 against frames_to_u8_plain and numpy's formula, one object's training frames")
    shape = (N_TRAIN_FRAMES, CAMERA.height, CAMERA.width, 4)
    src = torch.rand(shape, generator=torch.Generator(device=dev).manual_seed(9), device=dev)
    # the values where rounding decides the byte lead the set: every level, every
    # point half way between two with its float32 neighbours, the range's ends
    levels = np.arange(256, dtype=np.float64)
    halves = ((levels + 0.5) / 255).astype(np.float32)
    edges = np.concatenate([
        (levels / 255).astype(np.float32), np.nextafter(halves, np.float32(-1)), halves,
        np.nextafter(halves, np.float32(2)), np.array([0.0, 1.0, -0.0, -1e-8, 1 + 1e-7, 2.0, -3.0], np.float32),
    ])
    src.view(-1)[: edges.size] = torch.from_numpy(edges).to(dev)
    out = torch.empty(shape, dtype=torch.uint8, device=dev)
    before = frames_to_u8.launches
    frames_to_u8(src, out)
    plain = frames_to_u8_plain(src)
    sync()
    if frames_to_u8.launches != before + 1:
        raise SystemExit("frames_to_u8 did not launch its kernel once on a card tensor")
    host = src.cpu().numpy()
    want = np.clip(host * 255.0 + 0.5, 0, 255).astype(np.uint8)
    off_plain = int((out != plain).sum())
    off_numpy = int((out.cpu().numpy() != want).sum())
    plain_off_numpy = int((plain.cpu().numpy() != want).sum())
    log(f"frames_to_u8 on {src.numel():,} elements ({edges.size} edge values first): {off_plain} bytes differ from "
        f"frames_to_u8_plain on the card, {off_numpy} from numpy on the host (need 0 and 0); the plain version on "
        f"the card differs from numpy in {plain_off_numpy}")
    if off_plain or off_numpy:
        raise SystemExit("frames_to_u8 is not byte-equal to its plain version and to numpy's formula")
    del plain, host, want
    label = f"F={N_TRAIN_FRAMES} {CAMERA.width}x{CAMERA.height} RGBA, one object's training frames"
    row = dict(shape=label, max_abs_err=0.0, library_ms=None, bound_by="bytes", bound_ms=frames_bound_ms(src.numel()))
    row.update(kernel_times(lambda: frames_to_u8(src, out), f"frames_to_u8 {label}"))
    row["plain_ms"] = time_ms(lambda: frames_to_u8_plain(src), iters=50, warmup=5)
    log(f"frames_to_u8 {label}: {times_text(row)}, plain on the card {row['plain_ms']:.4f} ms (5 warm-up calls, "
        f"50 timed), bound {row['bound_ms']:.4f} ms (bytes) = {row['bound_ms'] / row['ms']:.3f} of the time")
    return dict(
        name="frames_to_u8", route="cuda", source="nerf_prv_tpu_torch/ops/csrc/frames_u8.cu",
        replaces="nerf_prv_tpu/nerf/batch_train.py:51",
        note="numpy on the host in the JAX package (stack_datasets), no XLA op or Pallas kernel; "
             "plain_ms is frames_to_u8_plain on the card",
        launches=0, **{k: row[k] for k in
                       ("max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        shape=label, shapes=[row],
    )


def spiral_views(n: int, turn: float) -> np.ndarray:
    """``n`` unit view directions on a Fibonacci spiral over the upper
    hemisphere; another ``turn`` gives another, interleaved set."""
    i = np.arange(n) + 0.5
    z = i / n
    phi = (i + turn) * math.pi * (3.0 - math.sqrt(5.0))
    return np.stack([np.sqrt(1 - z * z) * np.cos(phi), np.sqrt(1 - z * z) * np.sin(phi), z], -1)


def normal_colour(n: torch.Tensor) -> torch.Tensor:
    """The analytic sphere's colour at unit normal ``n``."""
    return n * 0.5 + 0.5


def write_scene(root: str, dev, name: str, n_frames: int, turn: float, colour=normal_colour) -> str:
    """Hemisphere views of an analytic sphere coloured by ``colour`` of its
    unit normal, at the camera's full size, written as ``<name>.json`` with
    RGBA PNGs."""
    from PIL import Image

    cam = CAMERA
    center = np.full(3, 1e-4)
    tf_root = make_root(cam, 1, 0.05, center)  # scale 10: the bounding sphere at 3 units
    c2w = camera_to_world(spiral_views(n_frames, turn) * 0.3 + center, center)
    os.makedirs(os.path.join(root, name), exist_ok=True)
    for k in range(n_frames):
        add_frame(tf_root, f"{name}/r_{k}", c2w[k])  # extensionless, Blender style
    path = os.path.join(root, f"{name}.json")
    write_transforms(path, tf_root)

    origins, rotations = grid_cameras(load_transforms(path))
    u, v = torch.meshgrid(
        torch.arange(cam.width, dtype=torch.float32, device=dev),
        torch.arange(cam.height, dtype=torch.float32, device=dev),
        indexing="xy",
    )
    d_cam = pixel_dirs_cam(cam, u.reshape(-1), v.reshape(-1))
    for k in range(n_frames):
        d = d_cam @ torch.as_tensor(rotations[k], device=dev).T
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        o = torch.as_tensor(origins[k], device=dev).expand_as(d)
        tmin, _, hit = ray_sphere(o, d, center=0.5, radius=0.3)
        p = o + d * tmin[:, None]
        rgb = torch.clamp(colour((p - 0.5) / 0.3), 0, 1) * hit[:, None]
        rgba = torch.cat([rgb, hit[:, None].float()], -1).reshape(cam.height, cam.width, 4)
        u8 = torch.round(rgba * 255).to(torch.uint8).cpu().numpy()
        Image.fromarray(u8, "RGBA").save(os.path.join(root, name, f"r_{k}.png"))
    return path


def phase_serve(dev, root: str, test_json: str, cfg: NerfConfig, params, kernel: dict, card: str):
    log(f"== phase 3: serve a full-width hash-field snapshot at {CAMERA.width}x{CAMERA.height}")
    log("params: " + ", ".join(f"{k} {tuple(v.shape)}" for k, v in params.items()))
    snap = os.path.join(root, "snap.ingp")
    save_snapshot(snap, params)
    shots = os.path.join(root, "shots")
    metrics_path = os.path.join(root, "metrics.txt")

    hash_encode.launches = 0
    t0 = time.perf_counter()
    metrics = run(
        test_json, test_transforms=test_json, save_metrics_path=metrics_path,
        screenshot_transforms=test_json, screenshot_dir=shots, cfg=cfg,
        load_snapshot_path=snap, device=dev,
    )
    sync()
    wall = time.perf_counter() - t0
    kernel["launches"] = hash_encode.launches
    log(f"run: {wall:.2f} s, metrics {metrics}, hash_encode launches {hash_encode.launches}")
    if not all(math.isfinite(metrics[k]) for k in ("PSNR", "SSIM", "PSNR_avgmse")):
        raise SystemExit(f"non-finite metrics {metrics}")
    if not os.path.exists(metrics_path):
        raise SystemExit("run wrote no metrics file")
    pngs = sorted(os.listdir(shots))
    if len(pngs) != N_TEST_FRAMES:
        raise SystemExit(f"expected {N_TEST_FRAMES} screenshots, found {pngs}")
    if kernel["launches"] == 0:
        raise SystemExit("the serving path launched no hash_encode kernel")

    params = load_snapshot(snap, cfg, device=dev)
    ds = load_dataset(test_json)
    hash_encode.launches = 0
    dt = timed_eval(params, ds, cfg)
    log(f"eval_nerf: {rays_per_s_line(ds, dt)}, {hash_encode.launches} hash_encode launches ({card})")
    profile_device(lambda: eval_nerf(params, ds, cfg), "one hash eval_nerf", dt)
    return params, ds


def timed_eval(params, ds, cfg) -> float:
    sync()
    t0 = time.perf_counter()
    eval_nerf(params, ds, cfg)
    sync()
    return time.perf_counter() - t0


def rays_per_s_line(ds, dt: float) -> str:
    rays = ds.n_frames * ds.camera.height * ds.camera.width
    return (f"{ds.n_frames} frames {ds.camera.width}x{ds.camera.height} in {dt:.4f} s "
            f"= {rays / dt:.6e} rays/s")


_FAMILIES = (  # first match wins
    ("own kernels", ("hash_encode_kernel", "hash_encode_backward_kernel", "row_gather_kernel",
                     "row_scatter_add_kernel", "splat_bin", "splat_scan", "splat_raster", "voxel_cast_kernel")),
    ("GEMMs", ("gemm", "nvjet", "cutlass", "cublas", "splitK")),
    ("Adam", ("multi_tensor_apply",)),
    ("copies and cats", ("CatArray", "copy_kernel", "Memcpy", "Memset")),
    ("library indexing", ("index", "gather", "scatter")),
    ("reductions and scans", ("reduce_kernel", "scan")),
    ("elementwise", ("elementwise",)),
)


def kernel_family(name: str) -> str:
    for family, keys in _FAMILIES:
        if any(k in name for k in keys):
            return family
    return "other"


def profile_device(fn, label: str, wall_s: float, top: int = 20, tries: int = 3, named: tuple = ()):
    """Device time by kernel over one call of ``fn``, and the device's busy
    share of ``wall_s``, the same call's wall time without the profiler.

    A trace can lose events (on a loaded host the same work has shown a
    third less device time), so the trace counts the port's own kernels
    and is taken again, up to ``tries`` times, until that count equals the
    launches the wrappers counted; the line printed says which it was.
    Returns ({family: (us, kernels)}, whether the trace was complete).
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # (wrapper, kernels one of its launches runs): K8 runs four (count, scan,
    # fill, raster)
    wrappers = ((hash_encode, 1), (hash_encode_backward, 1), (row_gather, 1), (row_scatter_add, 1), (splat, 4),
                (voxel_cast, 1))
    for attempt in range(1, tries + 1):
        sync()
        before = sum(w.launches * k for w, k in wrappers)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        wall_us = (time.perf_counter() - t0) * 1e6
        launched = sum(w.launches * k for w, k in wrappers) - before
        by_name = {}
        for e in prof.events():
            # kernels and copies, not host ops; "Optimizer.step#..." is a span
            # the profiler draws on the device's track over the kernels inside it
            if e.device_type == DeviceType.CUDA and not e.name.startswith("Optimizer."):
                us, count = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (us + e.device_time_total, count + 1)
        seen = sum(c for name, (_, c) in by_name.items() if kernel_family(name) == "own kernels")
        if seen == launched:
            break
    busy = sum(us for us, _ in by_name.values())
    state = "complete" if seen == launched else "INCOMPLETE"
    log(f"profile of {label}: device busy {busy:.0f} us = {busy / (wall_s * 1e6):.4f} "
        f"of the un-profiled wall {wall_s * 1e6:.0f} us (profiled wall {wall_us:.0f} us; trace {state}: "
        f"{seen} of {launched} own kernel launches seen, attempt {attempt})")
    families = {}
    for name, (us, count) in by_name.items():
        f_us, f_count = families.get(kernel_family(name), (0.0, 0))
        families[kernel_family(name)] = (f_us + us, f_count + count)
    log("  by family: " + "; ".join(
        f"{fam} {us:.0f} us in {count}" for fam, (us, count) in sorted(families.items(), key=lambda kv: -kv[1][0])))
    for key in named:
        us, count = (sum(v[i] for name, v in by_name.items() if key in name) for i in (0, 1))
        log(f"  {key}: {us:.1f} us in {count} launches")
    for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"  {us:12.0f} us  {count:6d}x  {name[:100]}")
    return families, seen == launched


def phase_serve_vs_plain(params, ds, cfg):
    log("== phase 4: hash renders through the kernel against the plain encode and the CPU")
    before = hash_encode.launches
    a = render_views(params, ds.origins[:1], ds.rotations[:1], ds.camera, cfg)
    if hash_encode.launches == before:
        raise SystemExit("the fused render launched no kernel")
    plain = dataclasses.replace(cfg, encode_impl="xla")
    after = hash_encode.launches
    b = render_views(params, ds.origins[:1], ds.rotations[:1], ds.camera, plain)
    if hash_encode.launches != after:
        raise SystemExit("the plain render launched the kernel")
    if not (torch.isfinite(a).all() and a.shape == (1, *ds.hw, 4)):
        raise SystemExit(f"bad render {tuple(a.shape)}")
    psnr = float(mse2psnr(torch.mean((a - b) ** 2)))
    log(f"kernel vs plain render: PSNR {psnr:.2f} dB (need >= {SERVE_PSNR_MIN}), "
        f"max |diff| {float((a - b).abs().max()):.3e}, alpha mean {float(a[..., 3].mean()):.4f}")
    if psnr < SERVE_PSNR_MIN:
        raise SystemExit("kernel render disagrees with the plain-encode render")

    # the same snapshot in f32 at 1/8 resolution (the per-ray path, w < 512):
    # on the card through the kernel, and on the CPU through the plain path
    small = scaled_camera(ds.camera, 8)
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    on_card = render_views(params, ds.origins[:2], ds.rotations[:2], small, f32).cpu()
    cpu_params = {k: v.cpu() for k, v in params.items()}
    on_cpu = render_views(cpu_params, ds.origins[:2], ds.rotations[:2], small, f32)
    diff = float((on_card - on_cpu).abs().max())
    log(f"card vs CPU render, 2 frames {small.width}x{small.height} f32: max |diff| {diff:.3e} "
        f"(need <= {CPU_RENDER_TOL}), alpha max {float(on_card[..., 3].max()):.4f}")
    if not diff <= CPU_RENDER_TOL or float(on_card[..., 3].max()) <= 0.0:
        raise SystemExit("the card's render disagrees with the CPU's")


# the launch counts the code predicts (shared with the card checks)
expected_train_launches = launch_counts.train_launches
expected_eval_gathers = launch_counts.tile_gathers  # one eval_nerf of frames 512 wide or more
expected_narrow_eval_gathers = launch_counts.narrow_gathers  # one eval_nerf of narrower frames


def step_ms(step, n: int) -> float:
    """Mean wall ms of ``n`` calls of ``step`` after 3 to warm up (host
    clock around a sync)."""
    for _ in range(3):
        step()
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    sync()
    return (time.perf_counter() - t0) / n * 1e3


def time_steps(params, cfg: NerfConfig, source: BatchSource, n: int, seed: int) -> float:
    """Mean wall ms of ``n`` optimizer steps at ``cfg`` on a copy of
    ``params``, sampling as ``train`` does (host clock around a sync)."""
    return step_ms(make_stepper(params, cfg, source, seed), n)


def make_stepper(params, cfg: NerfConfig, source: BatchSource, seed: int):
    """A closure that samples one batch and takes one ``train_step`` on a
    copy of ``params``."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    opt = train_mod.make_optimizer(p, cfg)
    g = torch.Generator(device=source.pixels.device).manual_seed(seed)

    def step():
        batch, jitter = source.draw(g, cfg)
        return train_mod.train_step(p, opt, batch, jitter, cfg)

    return step


black_psnr = experiment_runs.black_psnr  # an all-black frame's PSNR on a test set: the fields' floor


# one tight step's three row launches: the sum of their device times from
# phase 2b (L2 warm, back to back) against the same launches inside a
# profiled step (between other kernels), as a ratio either way
STEP_ROWS_FACTOR = 2.0


def phase_train(dev, root: str, train_json: str, test_json: str, source: BatchSource,
                gather: dict, scatter: dict, frames: dict, tight_us: float, card: str):
    cfg = dataclasses.replace(VOXEL_CFG, n_steps=N_STEPS)
    log(f"== phase 5: train the default voxel field, {cfg.n_steps} steps x {cfg.train_rays} rays, "
        f"{N_TRAIN_FRAMES} frames {CAMERA.width}x{CAMERA.height}")
    snap = os.path.join(root, "voxel.ingp")
    shots = os.path.join(root, "voxel_shots")
    losses = []
    real_train = train_mod.train

    def recording_train(*a, **kw):
        params, ls = real_train(*a, **kw)
        losses.append(ls)
        return params, ls

    # run() does not return the losses; listen in on its trainer
    api_mod.train = recording_train
    row_gather.launches = 0
    row_scatter_add.launches = 0
    frames_to_u8.launches = 0
    t0 = time.perf_counter()
    try:
        metrics = run(
            train_json, test_transforms=test_json, screenshot_transforms=test_json,
            screenshot_dir=shots, save_snapshot_path=snap, cfg=cfg, seed=0, device=dev,
        )
    finally:
        api_mod.train = real_train
    sync()
    wall = time.perf_counter() - t0
    gather["launches"], scatter["launches"] = row_gather.launches, row_scatter_add.launches
    frames["launches"] = frames_to_u8.launches
    log(f"frames_to_u8 launches in run: {frames['launches']} (need 1: one training's frames)")
    if frames["launches"] != 1:
        raise SystemExit("the trainer did not quantise its frames through one frames_to_u8 launch")
    ls = losses[0]
    first, last = float(ls[:20].mean()), float(ls[-100:].mean())
    log(f"run: {wall:.2f} s, metrics {metrics}")
    log(f"losses: {ls.size} steps, first 20 mean {first:.6f}, last 100 mean {last:.6f} "
        f"(need <= {LOSS_DROP} of the first)")
    if ls.size != cfg.n_steps or not np.isfinite(ls).all():
        raise SystemExit("training losses are missing or not finite")
    if not last <= LOSS_DROP * first:
        raise SystemExit("training did not bring the loss down")
    if len(os.listdir(shots)) != N_TEST_FRAMES:
        raise SystemExit(f"expected {N_TEST_FRAMES} voxel screenshots")

    params = load_snapshot(snap, cfg, device=dev)
    test_ds = load_dataset(test_json)
    base = black_psnr(test_ds)
    log(f"eval PSNR {metrics['PSNR']:.3f} dB, SSIM {metrics['SSIM']:.4f}; an all-black frame scores "
        f"{base:.3f} dB (need >= {PSNR_MARGIN_DB} dB above it)")
    if not (math.isfinite(metrics["PSNR"]) and metrics["PSNR"] >= base + PSNR_MARGIN_DB):
        raise SystemExit("the trained field does not beat a black frame by the margin")

    # launches: the trainer's are predicted from the config; the eval's and
    # the screenshots' are counted again on the saved snapshot
    row_gather.launches = 0
    dt = timed_eval(params, test_ds, cfg)
    eval_g = row_gather.launches
    screenshot_nerf(params, test_json, os.path.join(root, "voxel_shots2"), cfg)
    shot_g = row_gather.launches - eval_g
    want_g, want_s = expected_train_launches(cfg)
    log(f"launches in run: row_gather {gather['launches']} (train {want_g} predicted + eval {eval_g} "
        f"+ screenshots {shot_g}), row_scatter_add {scatter['launches']} (train {want_s} predicted)")
    if gather["launches"] != want_g + eval_g + shot_g or scatter["launches"] != want_s:
        raise SystemExit("the launch counts are not the ones the code predicts")
    if gather["launches"] == 0 or scatter["launches"] == 0:
        raise SystemExit("the training path launched no row kernel")
    log(f"eval_nerf (voxel): {rays_per_s_line(test_ds, dt)}, {eval_g} row_gather launches ({card})")
    profile_device(lambda: eval_nerf(params, test_ds, cfg), "one voxel eval_nerf", dt)

    warm_cfg, _ = train_mod._phases(cfg, warm_start=False)[0]
    fresh = init_params(torch.Generator(device=dev).manual_seed(5), cfg, device=dev)
    warm_ms = time_steps(fresh, warm_cfg, source, 50, seed=6)
    tight_ms = time_steps(params, cfg, source, 100, seed=7)
    log(f"ms/step (host clock, {card}): warmup {warm_ms:.4f} ({warm_cfg.n_samples} samples, "
        f"1 gather + 1 scatter-add), tight {tight_ms:.4f} ({cfg.n_samples} samples after a "
        f"{cfg.train_coarse}-probe, 2 gathers + 1 scatter-add)")
    step = make_stepper(params, cfg, source, seed=8)
    for _ in range(3):
        step()
    # the step loop must never wait for the device: any synchronizing call
    # (.item(), a boolean index, a copy to the host) raises in this mode
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("3 tight steps under torch.cuda.set_sync_debug_mode('error'): no host sync")
    families, complete = profile_device(step, "one tight training step", tight_ms * 1e-3)
    in_step_us, in_step_n = families.get("own kernels", (0.0, 0))
    log(f"row kernels in the profiled step: {in_step_us:.1f} us in {in_step_n} launches; their device "
        f"times alone add up to {tight_us:.1f} us (need within {STEP_ROWS_FACTOR}x either way)")
    if complete and not (tight_us / STEP_ROWS_FACTOR <= in_step_us <= tight_us * STEP_ROWS_FACTOR):
        raise SystemExit("the row kernels' device times do not add up to the profiled step's")
    if not complete:
        log("  the trace lost events: not compared")
    t_cast = time_ms(lambda: params["grid"].to(torch.bfloat16), iters=50)
    log(f"grid f32 -> bf16 cast (twice per tight step, once per render chunk): {t_cast:.4f} ms")
    return params, cfg, test_ds, tight_ms


@contextlib.contextmanager
def row_ops(gather_fn, scatter_fn):
    """Route the voxel field's and the probe's row operations elsewhere."""
    saved = (voxelfield.row_gather, voxelfield.row_scatter_add, render_mod.row_gather)
    voxelfield.row_gather, voxelfield.row_scatter_add, render_mod.row_gather = (
        gather_fn, scatter_fn, gather_fn)
    try:
        yield
    finally:
        voxelfield.row_gather, voxelfield.row_scatter_add, render_mod.row_gather = saved


def gather_off_by_one(table, idx):
    """A broken gather: every row from its neighbour."""
    return row_gather(table, ((idx + 1) % table.shape[0]).contiguous())


def scatter_drops_duplicates(idx, upd, n_rows):
    """A broken scatter-add: one update per row survives."""
    out = torch.zeros((n_rows, upd.shape[1]), dtype=upd.dtype, device=upd.device)
    out[idx.to(torch.int64)] = upd
    return out


def loss_and_grads(params, batch, jitter, cfg):
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    loss = train_mod.batch_loss(p, batch, jitter, cfg)
    loss.backward()
    return float(loss.detach()), {k: v.grad for k, v in p.items()}


def step_disagreement(ref, got) -> tuple:
    """(relative loss difference, worst per-parameter max|a-b| / max|b|)."""
    (l0, g0), (l1, g1) = ref, got
    worst = max(
        float((g1[k] - g0[k]).abs().max()) / max(float(g0[k].abs().max()), 1e-30) for k in g0
    )
    return abs(l1 - l0) / abs(l0), worst


def phase_step_vs_plain(dev, params, cfg, source: BatchSource, test_ds):
    log("== phase 6: one step through the kernels against the plain versions, and card against CPU")
    batch, jitter = source.draw(torch.Generator(device=dev).manual_seed(11), cfg)

    g0, s0 = row_gather.launches, row_scatter_add.launches
    through_kernels = loss_and_grads(params, batch, jitter, cfg)
    if (row_gather.launches - g0, row_scatter_add.launches - s0) != (2, 1):
        raise SystemExit("a tight step must launch row_gather twice and row_scatter_add once")
    g0, s0 = row_gather.launches, row_scatter_add.launches
    with row_ops(row_gather_plain, row_scatter_add_plain):
        through_plain = loss_and_grads(params, batch, jitter, cfg)
    if (row_gather.launches, row_scatter_add.launches) != (g0, s0):
        raise SystemExit("the plain step launched a kernel")
    grads = through_kernels[1]
    if not all(bool(torch.isfinite(v).all()) for v in grads.values()):
        raise SystemExit("non-finite gradient")
    d_loss, d_grad = step_disagreement(through_plain, through_kernels)
    log(f"step, kernels vs plain: loss {through_kernels[0]:.8f}, relative loss diff {d_loss:.3e} "
        f"(need <= {STEP_LOSS_TOL}), worst gradient diff {d_grad:.3e} of its max (need <= {STEP_GRAD_TOL}); "
        f"|grid grad| max {float(grads['grid'].abs().max()):.3e}")
    if not (d_loss <= STEP_LOSS_TOL and d_grad <= STEP_GRAD_TOL):
        raise SystemExit("the step through the kernels disagrees with the plain step")
    for name, gfn, sfn in (
        ("a gather off by one row", gather_off_by_one, row_scatter_add),
        ("a scatter-add that drops duplicates", row_gather, scatter_drops_duplicates),
    ):
        with row_ops(gfn, sfn):
            bad = step_disagreement(through_plain, loss_and_grads(params, batch, jitter, cfg))
        caught = bad[0] > STEP_LOSS_TOL or bad[1] > STEP_GRAD_TOL
        log(f"  broken on purpose, {name}: loss diff {bad[0]:.3e}, gradient diff {bad[1]:.3e} -> "
            f"{'caught' if caught else 'NOT caught'}")
        if not caught:
            raise SystemExit(f"the step tolerances do not catch {name}")

    # one held-out frame at 1/8 size in f32: the card through the kernels
    # against the CPU through the plain versions
    small = scaled_camera(test_ds.camera, 8)
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    view = (test_ds.origins[:1], test_ds.rotations[:1])
    on_card = render_views(params, *view, small, f32).cpu()
    cpu_params = {k: v.cpu() for k, v in params.items()}
    on_cpu = render_views(cpu_params, *view, small, f32)
    with row_ops(gather_off_by_one, row_scatter_add):
        broken = render_views(params, *view, small, f32).cpu()
    psnr = float(mse2psnr(torch.mean((on_card - on_cpu) ** 2)))
    psnr_broken = float(mse2psnr(torch.mean((broken - on_cpu) ** 2)))
    over = float(((on_card - on_cpu).abs() > CPU_RENDER_TOL).float().mean())
    log(f"card vs CPU voxel render, {small.width}x{small.height} f32: PSNR {psnr:.2f} dB (need >= "
        f"{VOXEL_CPU_PSNR_MIN}), max |diff| {float((on_card - on_cpu).abs().max()):.3e}, share of values "
        f"over {CPU_RENDER_TOL}: {over:.5f}, alpha max {float(on_card[..., 3].max()):.4f}; "
        f"through the off-by-one gather: {psnr_broken:.2f} dB")
    if psnr < VOXEL_CPU_PSNR_MIN or float(on_card[..., 3].max()) <= 0.0:
        raise SystemExit("the card's voxel render disagrees with the CPU's")
    if psnr_broken >= VOXEL_CPU_PSNR_MIN:
        raise SystemExit("the render tolerance does not catch a gather off by one row")


def train_march_points(source: BatchSource, cfg: NerfConfig, params=None, seed: int = 21):
    """(cfg.train_rays * cfg.n_samples, 3) positions of one training batch's
    march, ray by ray, placed as ``render_rays`` places them: stratified
    samples on each ray's chord, or with ``params`` and ``cfg.train_coarse``
    inside the interval the no-grad probe of that field tightens it to."""
    dev = source.pixels.device
    (o, d, _, _), jitter = source.draw(torch.Generator(device=dev).manual_seed(seed), cfg)
    tmin, tmax, valid = ray_sphere(o, d)
    if params is not None and cfg.train_coarse > 0:
        with torch.no_grad():
            t_lo, t_hi, any_occ = render_mod._tighten_interval(
                params, o, d, tmin, tmax, valid, cfg.train_coarse, cfg)
        tmin, tmax = torch.where(any_occ, t_lo, tmin), torch.where(any_occ, t_hi, tmax)
    base = torch.arange(cfg.n_samples, dtype=torch.float32, device=dev)[None, :]
    ts = tmin[:, None] + (base + jitter) * ((tmax - tmin) / cfg.n_samples)[:, None]
    pos = torch.clamp(o[:, None, :] + d[:, None, :] * ts[..., None], 0.0, 1.0 - 1e-6)
    return pos.reshape(-1, 3).contiguous()


def train_probe_points(source: BatchSource, cfg: NerfConfig, seed: int = 21):
    """(cfg.train_rays * cfg.train_coarse, 3) positions of the same batch's
    no-grad probe, ray by ray, where ``_tighten_interval`` places them."""
    dev = source.pixels.device
    (o, d, _, _), _ = source.draw(torch.Generator(device=dev).manual_seed(seed), cfg)
    tmin, tmax, _ = ray_sphere(o, d)
    pos, _ = render_mod._chord_midpoints(o, d, tmin, tmax, cfg.train_coarse)
    return pos.reshape(-1, 3).contiguous()


def table_grad_updates(x, g, cfg: HashGridConfig) -> tuple:
    """The materialised updates of the table gradient: (rows (M,) int64,
    updates (M, F) f32) with M = levels * N * 8, as the sort-based plain
    version builds them."""
    n, f = x.shape[0], cfg.features
    idx, w = _levelwise_indices_weights(x, cfg)
    upd = w[..., None] * g.reshape(n, cfg.levels, f).permute(1, 0, 2)[:, :, None, :]
    return idx.reshape(-1), upd.reshape(-1, f).contiguous()


def table_grad_reference(x, g, cfg: HashGridConfig) -> tuple:
    """(float64 sum, per-element tolerance, most updates on one row) of the
    table gradient.

    The tolerance is the f32 summation bound itself, as for the row
    scatter-add: a row that receives k updates is the result of k rounded
    adds, each off by at most 2^-24 of a partial sum that never exceeds the
    row's sum of |w g|, in whatever order the atomics ran; one more term
    covers the rounding of each product w * g.
    """
    rows = cfg.levels * cfg.table_size
    idx, upd = table_grad_updates(x, g, cfg)
    upd = upd.double()
    want = torch.zeros((rows, cfg.features), dtype=torch.float64, device=x.device).index_add_(0, idx, upd)
    mag = torch.zeros_like(want).index_add_(0, idx, upd.abs())
    count = torch.bincount(idx, minlength=rows).double()[:, None]
    return want, (count + 1.0) * 2.0 ** -24 * mag, int(count.max())


def table_grad_excess(d_table, want, tol) -> float:
    """Largest |d_table - float64 sum| beyond the per-element bound (<= 0: within)."""
    return float(((d_table.double() - want).abs() - tol).max())


def bwd_drops_a_corner(x, g, cfg: HashGridConfig):
    """A broken table gradient: the kernel's, less every point's last corner."""
    out = hash_encode_backward(x, g, cfg)
    idx, upd = table_grad_updates(x, g, cfg)
    return out.index_add_(0, idx[7::8], -upd[7::8])


def bwd_shifts_a_level(x, g, cfg: HashGridConfig):
    """A broken table gradient: level l's output gradient added into level
    l + 1's rows (the last level's into level 0's)."""
    return hash_encode_backward(x, torch.roll(g, cfg.features, dims=1).contiguous(), cfg)


def backward_bound_ms(x, cfg: HashGridConfig) -> tuple:
    """Least time for one table-gradient call on ``x``: x and g read once
    and the whole output written once over HBM (as for the row scatter-add:
    zeroing first and adding into the touched rows afterwards is this
    kernel's choice, not the function's need), or its f32 arithmetic at the
    f32 peak."""
    n = x.shape[0]
    rows = cfg.levels * cfg.table_size
    bytes_moved = 4 * (n * 3 + n * cfg.out_dim + rows * cfg.features)
    # per (point, level): 3 scale + 3 frac + 3 (1 - frac), then per corner 2
    # weight products, F products and F adds
    ops = n * cfg.levels * (9 + 8 * (2 + 2 * cfg.features))
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def backward_atomics(x, cfg: HashGridConfig, merge_pairs: bool = True, presum_runs: bool = True) -> int:
    """Atomic adds (vector instructions) that the table-gradient kernel
    issues for ``x``, counted on the host by the kernel's rules: per level
    one set of corner adds for each run of consecutive points in one cell
    among each 32 (a warp; each point on its own without ``presum_runs``),
    and per (y, z) one add for the two x-corners where their rows form an
    aligned pair and F <= 2 (with ``merge_pairs``), else one per row (two
    for F = 8)."""
    n, f = x.shape[0], cfg.features
    per_row = 2 if f == 8 else 1
    warp_start = torch.arange(n, device=x.device) % 32 == 0
    total = 0
    for res in cfg.resolutions():
        res = int(res)
        cell = torch.clamp(torch.floor(x * float(res)), 0, res - 1).to(torch.int64)
        if presum_runs:
            head = warp_start.clone()
            head[1:] |= (cell[1:] != cell[:-1]).any(dim=1)
            cell = cell[head]
        for dj, dk in ((0, 0), (0, 1), (1, 0), (1, 1)):
            r0 = _corner_indices(cell + torch.tensor([0, dj, dk], device=x.device), res, cfg.table_size)
            r1 = _corner_indices(cell + torch.tensor([1, dj, dk], device=x.device), res, cfg.table_size)
            pairs = int(((r0 ^ r1) == 1).sum()) if merge_pairs and f <= 2 else 0
            total += pairs + 2 * per_row * (cell.shape[0] - pairs)
    return total


def backward_occupancy(lib, n: int, cfg: HashGridConfig):
    """(blocks one SM holds at once, blocks in the grid, waves) of a build
    of the table-gradient kernel on ``n`` points, from the build's own
    ``hash_encode_backward_occupancy``; None for a build without it."""
    fn = getattr(lib, "hash_encode_backward_occupancy", None)
    if fn is None:
        return None
    fn.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64)]
    fn.restype = ctypes.c_int
    per_sm, grid = ctypes.c_int(), ctypes.c_int64()
    if fn(n, cfg.levels, cfg.features, ctypes.byref(per_sm), ctypes.byref(grid)) != 0:
        raise SystemExit("hash_encode_backward_occupancy failed")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return per_sm.value, grid.value, grid.value / (per_sm.value * sms)


def occupancy_text(occ) -> str:
    if occ is None:
        return "waves not reported by this build"
    return f"{occ[2]:.2f} waves ({occ[1]} blocks, {occ[0]} per SM at once)"


def check_backward(x, g, cfg: HashGridConfig, label: str, timed: bool = False) -> dict:
    """One table-gradient shape: the kernel against a float64 sum within the
    data-computed bound and against the sort-based plain version, two broken
    variants that must fail the same check, and (``timed``) its times."""
    got = hash_encode_backward(x, g, cfg)
    plain = table_grad_sorted(x, g, cfg)
    sync()
    want, tol, most = table_grad_reference(x, g, cfg)
    excess = table_grad_excess(got, want, tol)
    scale = float(want.abs().max())
    vs_f64 = float((got.double() - want).abs().max())
    vs_plain = float((got - plain).abs().max())
    log(f"hash_encode_backward {label}: at most {most} updates on a row, |kernel - f64| max {vs_f64:.3e} "
        f"(largest bound {float(tol.max()):.3e}, largest entry {scale:.3e}), |kernel - sorted| {vs_plain:.3e} "
        f"= {vs_plain / scale:.2e} of the largest entry (need <= {SORTED_TOL}), "
        f"|sorted - f64| {float((plain.double() - want).abs().max()):.3e}")
    if got.shape != plain.shape or not bool(torch.isfinite(got).all()) or excess > 0.0:
        raise SystemExit(f"hash_encode_backward {label}: off the float64 sum by {excess:.3e} beyond the bound")
    if vs_plain > SORTED_TOL * scale:
        raise SystemExit(f"hash_encode_backward {label} disagrees with the sorted plain version")
    for name, broken in (("drops a corner", bwd_drops_a_corner), ("shifts a level", bwd_shifts_a_level)):
        bad = table_grad_excess(broken(x, g, cfg), want, tol)
        log(f"  broken on purpose, {name}: {bad:.3e} beyond the bound -> {'caught' if bad > 0 else 'NOT caught'}")
        if not bad > 0:
            raise SystemExit(f"the table gradient's bound does not catch a kernel that {name}")
    row = dict(shape=label, max_abs_err=vs_f64, ms=0.0, call_ms=0.0, plain_ms=0.0, library_ms=0.0)
    row["bound_ms"], row["bound_by"] = backward_bound_ms(x, cfg)
    del plain, want, tol
    if timed:
        row.update(kernel_times(lambda: hash_encode_backward(x, g, cfg), f"hash_encode_backward {label}"))
        row["plain_ms"] = time_ms(lambda: table_grad_sorted(x, g, cfg), iters=3, warmup=1)
        # the library call sums updates that something else has to write
        # first: that pass (rows and weighted gradients of every corner, in
        # PyTorch ops) is timed beside it and is not part of library_ms
        updates_ms = time_ms(lambda: table_grad_updates(x, g, cfg), iters=3, warmup=1)
        idx, upd = table_grad_updates(x, g, cfg)
        rows = cfg.levels * cfg.table_size
        row["library_ms"] = device_ms(
            lambda: torch.zeros((rows, cfg.features), device=x.device).index_add_(0, idx, upd), iters=5)
        del idx, upd
        log(f"hash_encode_backward {label}: {times_text(row)} (memset included), sorted plain version "
            f"{row['plain_ms']:.4f} ms, zeros + index_add_ on the materialised updates {row['library_ms']:.4f} ms "
            f"(materialising them {updates_ms:.4f} ms more), bound {row['bound_ms']:.4f} ms ({row['bound_by']}) = {row['bound_ms'] / row['ms']:.3f} of the time")
        # the kernel's own time (the call less its memset, a call on no
        # points) against the atomics its design rules issue.  The count and
        # the waves are worked out on the host (the rules; the occupancy
        # calculator), not read from the card, so they stay in the log and
        # out of the measured row
        row["memset_ms"] = device_ms(lambda: hash_encode_backward(x[:0], g[:0], cfg))
        adds = backward_atomics(x, cfg)
        occ = backward_occupancy(hash_encode_mod._lib_backward(), x.shape[0], cfg)
        own_ms = row["ms"] - row["memset_ms"]
        corners = x.shape[0] * cfg.levels * 8 * (2 if cfg.features == 8 else 1)
        log(f"hash_encode_backward {label}: kernel's own {own_ms:.4f} ms (memset {row['memset_ms']:.4f} ms); "
            f"by the design's rules, counted on the host: {adds} atomic adds ({adds / corners:.3f} of one per "
            f"corner), {adds / own_ms / 1e6:.1f} G adds/s; by the occupancy calculator: {occupancy_text(occ)}")
    return row


def backward_point_sets(dev, params, source: BatchSource) -> dict:
    """The points the table gradient is checked and timed on, at a warmup
    and a tight step's shapes: one training batch's own march points, ray
    by ray (the tight ones inside the intervals that ``params``' probe
    tightens them to), and uniform ones with the cube's corners first."""
    warm_cfg, _ = train_mod._phases(HASH_CFG, warm_start=False)[0]
    uniform = torch.rand((BWD_WARM_N, 3), generator=torch.Generator(device=dev).manual_seed(12), device=dev)
    uniform[:3] = torch.tensor([[0.0, 0.0, 0.0], [1 - 1e-6] * 3, [1.0, 1.0, 1.0]], device=dev)
    warm_pts = train_march_points(source, warm_cfg)
    tight_pts = train_march_points(source, HASH_CFG, params)
    if (warm_pts.shape[0], tight_pts.shape[0]) != (BWD_WARM_N, BWD_TIGHT_N):
        raise SystemExit("the training march's shapes are not the ones the table gradient is timed at")
    res = [int(r) for r in HASH_CFG.grid.resolutions()]
    for name, pts in (("warmup", warm_pts), ("tight", tight_pts)):
        log(f"{name} march points {tuple(pts.shape)}: share in the cell of the point before, by level: "
            + " ".join(f"{same_cell_share(pts, r):.2f}" for r in res))
    return {
        f"warmup N={BWD_WARM_N} ray-ordered": warm_pts,
        f"warmup N={BWD_WARM_N} uniform": uniform,
        f"tight N={BWD_TIGHT_N} ray-ordered": tight_pts,
        f"tight N={BWD_TIGHT_N} uniform": uniform[:BWD_TIGHT_N].contiguous(),
    }


def coarse_levels(cfg: HashGridConfig) -> HashGridConfig:
    """The four coarsest levels of ``cfg`` alone, at the same resolutions."""
    res = [int(r) for r in cfg.resolutions()]
    coarse = HashGridConfig(levels=4, n_max=res[3])
    if [int(r) for r in coarse.resolutions()] != res[:4]:
        raise SystemExit("the coarse config does not reproduce the first four levels")
    return coarse


def phase_backward_kernel(dev, params, source: BatchSource, k_hash: dict) -> dict:
    log("== phase 2c: both hash kernels at a training step's shapes: hash_encode against hashgrid.encode, "
        "hash_encode_backward against a float64 sum and the sorted plain version")
    cfg = HASH_CFG.grid
    gen = torch.Generator(device=dev).manual_seed(14)

    def cotangent(n, c):
        return torch.randn((n, c.out_dim), generator=gen, device=dev)

    sets = backward_point_sets(dev, params, source)
    warm_pts, uniform, tight_pts, _ = sets.values()
    # the forward at the three shapes a training step launches it at, on the
    # batch's own points, through the field whose probe placed them
    probe_pts = train_probe_points(source, HASH_CFG)
    if probe_pts.shape[0] != TRAIN_PROBE_N:
        raise SystemExit("the training probe's shape is not the one the encode kernel is held at")
    for label, pts in ((f"warmup step's march N={BWD_WARM_N} ray-ordered", warm_pts),
                       (f"tight step's march N={BWD_TIGHT_N} ray-ordered", tight_pts),
                       (f"tight step's probe N={TRAIN_PROBE_N} ray-ordered", probe_pts)):
        err = check_encode(params["table"], pts, cfg, f"default config, {label}")
        k_hash["shapes"].append(encode_row(params["table"], pts, cfg, label, err))
        k_hash["max_abs_err"] = max(k_hash["max_abs_err"], err)
    rows = [check_backward(pts, cotangent(pts.shape[0], cfg), cfg, label, timed=True)
            for label, pts in sets.items()]
    ragged = uniform[: BWD_TIGHT_N + 37].contiguous()
    for other in (HashGridConfig(log2_table=14), HashGridConfig(features=4)):
        note = f"log2_table={other.log2_table} features={other.features}"
        check_backward(ragged, cotangent(ragged.shape[0], other), other, f"{note}, uniform N={ragged.shape[0]}")
        check_backward(tight_pts, cotangent(BWD_TIGHT_N, other), other, f"{note}, tight march points")

    # where the time goes by level: the four coarsest levels alone (dense,
    # a few thousand rows for millions of adds) against all sixteen, each
    # less the memset of its own table (a call on no points)
    coarse = coarse_levels(cfg)
    nothing = torch.zeros((0, 3), device=dev)
    for label, pts in (("warmup ray-ordered", warm_pts), ("warmup uniform", uniform), ("tight ray-ordered", tight_pts)):
        g16, g4 = cotangent(pts.shape[0], cfg), cotangent(pts.shape[0], coarse)
        t16 = device_ms(lambda: hash_encode_backward(pts, g16, cfg))
        t4 = device_ms(lambda: hash_encode_backward(pts, g4, coarse))
        z16 = device_ms(lambda: hash_encode_backward(nothing, g16[:0], cfg))
        z4 = device_ms(lambda: hash_encode_backward(nothing, g4[:0], coarse))
        log(f"hash_encode_backward by level, {label}: all 16 levels {t16:.4f} ms (memset {z16:.4f}), levels 0-3 "
            f"alone {t4:.4f} ms (memset {z4:.4f}): {(t4 - z4) / (t16 - z16):.3f} of the kernel's own time, "
            f"{backward_atomics(pts, coarse) / backward_atomics(pts, cfg):.3f} of its atomic adds")
    head = rows[0]
    return dict(
        name="hash_encode_backward", route="cuda",
        source="nerf_prv_tpu_torch/ops/csrc/hash_encode_backward.cu",
        replaces="nerf_prv_tpu/ops/sorted_grad.py:100",
        note="the backward of nerf_prv_tpu/ops/hash_encode.py:31, which the JAX package computes with XLA ops",
        launches=0, **{k: head[k] for k in
                       ("max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        shape=head["shape"], shapes=rows,
    )


def compare_k1b(dev, specs: list, card: str):
    """Other builds of the table-gradient kernel against this tree's, on one
    card: each held against the float64 sum within its bound on phase 2c's
    four point sets (the run fails only where this tree's misses it; an
    ablation may drop work on purpose), then all timed in turns (first to last and back, two
    device times each, memset included) beside ``zeros`` + ``index_add_`` on
    the materialised updates, at those four shapes and on the four coarsest
    levels alone."""
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        source = BatchSource(load_dataset(write_scene(root, dev, "train", N_TRAIN_FRAMES, turn=0.0)), dev)
    _, params = make_hash_field(dev)
    cfg = HASH_CFG.grid
    libs = {"tree": hash_encode_mod._lib_backward()}
    libs.update(build_sources(specs, "k1b", hash_encode_mod.bind_backward))
    sets = backward_point_sets(dev, params, source)
    del params
    gen = torch.Generator(device=dev).manual_seed(14)
    for label, pts in sets.items():
        g = torch.randn((pts.shape[0], cfg.out_dim), generator=gen, device=dev)
        want, tol, _ = table_grad_reference(pts, g, cfg)
        for name, lib in libs.items():
            with wrapper_library("_lib_backward", lib):
                got = hash_encode_backward(pts, g, cfg)
            excess = table_grad_excess(got, want, tol)
            right = bool(torch.isfinite(got).all()) and excess <= 0.0
            log(f"{name}, {label}: |kernel - f64| max {float((got.double() - want).abs().max()):.3e}, "
                f"{excess:.3e} beyond the bound: {'within it' if right else 'WRONG'}")
            # another build may drop work on purpose (an ablation): only this
            # tree's kernel has to be right
            if name == "tree" and not right:
                raise SystemExit(f"the tree's kernel misses the float64 sum's bound on {label}")
        del want, tol, got
    coarse = coarse_levels(cfg)
    cases = [(label, pts, cfg) for label, pts in sets.items()]
    cases += [(f"levels 0-3 only, {label}", sets[label], coarse)
              for label in (f"warmup N={BWD_WARM_N} ray-ordered", f"warmup N={BWD_WARM_N} uniform",
                            f"tight N={BWD_TIGHT_N} ray-ordered")]
    order = list(libs) + list(reversed(libs))
    for label, pts, c in cases:
        g = torch.randn((pts.shape[0], c.out_dim), generator=gen, device=dev)
        memset = device_ms(lambda: hash_encode_backward(pts[:0], g[:0], c))
        n_corner = pts.shape[0] * c.levels * 8 * (2 if c.features == 8 else 1)
        log(f"{label}: atomic adds one per corner {n_corner}, without the pair merge "
            f"{backward_atomics(pts, c, merge_pairs=False)}, without the run pre-sum "
            f"{backward_atomics(pts, c, presum_runs=False)}, with both {backward_atomics(pts, c)}; memset "
            f"{memset:.4f} ms; " + "; ".join(
                f"{name} {occupancy_text(backward_occupancy(lib, pts.shape[0], c))}" for name, lib in libs.items()))
        times = {name: [] for name in libs}
        for name in order:
            with wrapper_library("_lib_backward", libs[name]):
                times[name].append(device_ms(lambda: hash_encode_backward(pts, g, c)))
        idx, upd = table_grad_updates(pts, g, c)
        rows = c.levels * c.table_size
        library = device_ms(lambda: torch.zeros((rows, c.features), device=dev).index_add_(0, idx, upd), iters=5)
        del idx, upd
        bound, by = backward_bound_ms(pts, c)
        log(f"{label} (bound {bound:.5f} ms, {by}; {card}): " + "; ".join(
            f"{name} {a:.4f} {b:.4f}" for name, (a, b) in times.items())
            + f"; zeros + index_add_ {library:.4f}")


def phase_hash_train(dev, root: str, train_json: str, test_json: str, source: BatchSource,
                     k_hash: dict, k_bwd: dict, card: str):
    cfg = dataclasses.replace(HASH_CFG, n_steps=HASH_STEPS)
    log(f"== phase 7: train the full-width hash field, {cfg.n_steps} steps x {cfg.train_rays} rays, "
        f"{N_TRAIN_FRAMES} frames {CAMERA.width}x{CAMERA.height}")
    snap = os.path.join(root, "hash.ingp")
    losses = []
    real_train = train_mod.train

    def recording_train(*a, **kw):
        params, ls = real_train(*a, **kw)
        losses.append(ls)
        return params, ls

    api_mod.train = recording_train
    hash_encode.launches = 0
    hash_encode_backward.launches = 0
    frames_to_u8.launches = 0
    t0 = time.perf_counter()
    try:
        metrics = run(train_json, test_transforms=test_json, save_snapshot_path=snap, cfg=cfg, seed=0, device=dev)
    finally:
        api_mod.train = real_train
    sync()
    wall = time.perf_counter() - t0
    if frames_to_u8.launches != 1:
        raise SystemExit(f"the hash trainer launched frames_to_u8 {frames_to_u8.launches} times, not once")
    launched = (hash_encode.launches, hash_encode_backward.launches)
    k_hash["launches_serving"] = k_hash["launches"]
    k_hash["launches"], k_bwd["launches"] = launched
    ls = losses[0]
    first, last = float(ls[:20].mean()), float(ls[-100:].mean())
    log(f"run: {wall:.2f} s, metrics {metrics}")
    log(f"losses: {ls.size} steps, first 20 mean {first:.6f}, last 100 mean {last:.6f} "
        f"(need <= {LOSS_DROP} of the first)")
    if ls.size != cfg.n_steps or not np.isfinite(ls).all():
        raise SystemExit("hash training losses are missing or not finite")
    if not last <= LOSS_DROP * first:
        raise SystemExit("hash training did not bring the loss down")

    params = load_snapshot(snap, cfg, device=dev)
    test_ds = load_dataset(test_json)
    base = black_psnr(test_ds)
    log(f"eval PSNR {metrics['PSNR']:.3f} dB, SSIM {metrics['SSIM']:.4f}; an all-black frame scores "
        f"{base:.3f} dB (need >= {HASH_PSNR_MARGIN_DB} dB above it)")
    if not (math.isfinite(metrics["PSNR"]) and metrics["PSNR"] >= base + HASH_PSNR_MARGIN_DB):
        raise SystemExit("the trained hash field does not beat a black frame by the margin")

    hash_encode.launches = 0
    dt = timed_eval(params, test_ds, cfg)
    eval_k1 = hash_encode.launches
    # as the voxel path's gathers and scatter-adds: a warmup step encodes once
    # (the march), a tight step twice (the no-grad probe, then the march), and
    # every step takes the table's gradient once
    want_k1, want_bwd = expected_train_launches(cfg)
    log(f"launches in run: hash_encode {launched[0]} (train {want_k1} predicted + eval {eval_k1}), "
        f"hash_encode_backward {launched[1]} (train {want_bwd} predicted)")
    if launched != (want_k1 + eval_k1, want_bwd):
        raise SystemExit("the hash launch counts are not the ones the code predicts")
    if min(launched) == 0:
        raise SystemExit("the hash training path launched no kernel")
    log(f"eval_nerf (trained hash field): {rays_per_s_line(test_ds, dt)}, {eval_k1} hash_encode launches ({card})")

    warm_cfg, _ = train_mod._phases(cfg, warm_start=False)[0]
    fresh = init_params(torch.Generator(device=dev).manual_seed(5), cfg, device=dev)
    warm_ms = time_steps(fresh, warm_cfg, source, 30, seed=6)
    del fresh
    tight_ms = time_steps(params, cfg, source, 60, seed=7)
    log(f"ms/step (host clock, {card}): warmup {warm_ms:.4f} ({warm_cfg.n_samples} samples, 1 encode + 1 table "
        f"gradient), tight {tight_ms:.4f} ({cfg.n_samples} samples after a {cfg.train_coarse}-probe, 2 encodes + "
        f"1 table gradient)")
    step = make_stepper(params, cfg, source, seed=8)
    for _ in range(3):
        step()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("3 tight hash steps under torch.cuda.set_sync_debug_mode('error'): no host sync")
    profile_device(step, "one tight hash training step", tight_ms * 1e-3,
                   named=("hash_encode_kernel", "hash_encode_backward_kernel"))
    return params, cfg


@contextlib.contextmanager
def hash_ops_plain():
    """Route the fused encode's two kernels to their plain versions."""
    saved = (fused_mod.hash_encode, fused_mod.hash_encode_backward)
    fused_mod.hash_encode, fused_mod.hash_encode_backward = encode, table_grad_sorted
    try:
        yield
    finally:
        fused_mod.hash_encode, fused_mod.hash_encode_backward = saved


def phase_hash_step_vs_plain(dev, params, cfg: NerfConfig, source: BatchSource):
    log("== phase 8: one hash step through the kernels against the same step through the plain versions")
    for name, c in (("f32", dataclasses.replace(cfg, compute_dtype=torch.float32)), ("bf16", cfg)):
        batch, jitter = source.draw(torch.Generator(device=dev).manual_seed(13), c)
        k1, k1b = hash_encode.launches, hash_encode_backward.launches
        through_kernels = loss_and_grads(params, batch, jitter, c)
        if (hash_encode.launches - k1, hash_encode_backward.launches - k1b) != (2, 1):
            raise SystemExit("a tight hash step must launch hash_encode twice and hash_encode_backward once")
        k1, k1b = hash_encode.launches, hash_encode_backward.launches
        with hash_ops_plain():
            through_plain = loss_and_grads(params, batch, jitter, c)
        if (hash_encode.launches, hash_encode_backward.launches) != (k1, k1b):
            raise SystemExit("the plain hash step launched a kernel")
        grads = through_kernels[1]
        if not all(bool(torch.isfinite(v).all()) for v in grads.values()):
            raise SystemExit("non-finite gradient in the hash step")
        d_loss, d_grad = step_disagreement(through_plain, through_kernels)
        per = {k: float((grads[k] - through_plain[1][k]).abs().max())
               / max(float(through_plain[1][k].abs().max()), 1e-30) for k in grads}
        limits = f"(need <= {HASH_STEP_LOSS_TOL} and <= {HASH_STEP_GRAD_TOL})" if name == "f32" else "(printed only)"
        log(f"hash step, kernels vs plain, {name} compute: loss {through_kernels[0]:.8f}, relative loss diff "
            f"{d_loss:.3e}, worst gradient diff {d_grad:.3e} of its max {limits}; by parameter: "
            + ", ".join(f"{k} {v:.2e}" for k, v in per.items())
            + f"; |table grad| max {float(grads['table'].abs().max()):.3e}, rows touched "
            f"{int((grads['table'] != 0).any(dim=1).sum())}")
        if name == "f32" and not (d_loss <= HASH_STEP_LOSS_TOL and d_grad <= HASH_STEP_GRAD_TOL):
            raise SystemExit("the hash step through the kernels disagrees with the plain step")
        if name == "f32":
            # a table gradient that lands a level too high must not pass
            saved = fused_mod.hash_encode_backward
            fused_mod.hash_encode_backward = bwd_shifts_a_level
            try:
                bad = step_disagreement(through_plain, loss_and_grads(params, batch, jitter, c))
            finally:
                fused_mod.hash_encode_backward = saved
            caught = bad[1] > HASH_STEP_GRAD_TOL
            log(f"  broken on purpose, a table gradient that shifts a level: gradient diff {bad[1]:.3e} -> "
                f"{'caught' if caught else 'NOT caught'}")
            if not caught:
                raise SystemExit("the hash step tolerance does not catch a shifted table gradient")


def phase_options(dev, root: str, train_json: str, vparams, vcfg, test_ds, card: str):
    log(f"== phase 9: the other options on the card, {OPTION_STEPS} steps each")
    train_ds = load_dataset(train_json)
    short = dict(n_steps=OPTION_STEPS, train_warmup_steps=50)
    runs = (
        ("bf16 Adam moments, voxel", dataclasses.replace(vcfg, adam_moment_dtype="bfloat16", **short)),
        ("bf16 Adam moments, hash", dataclasses.replace(HASH_CFG, adam_moment_dtype="bfloat16", **short)),
        ("baked train probe, refresh 10", dataclasses.replace(vcfg, train_probe_refresh=10, **short)),
        ("importance resampling, n_importance=8", dataclasses.replace(vcfg, n_importance=8, **short)),
        ("encode_impl='sorted' (the plain table gradient), hash",
         dataclasses.replace(HASH_CFG, encode_impl="sorted", n_steps=10, train_warmup_steps=5)),
    )
    for name, cfg in runs:
        g0 = row_gather.launches
        t0 = time.perf_counter()
        _, ls = train_mod.train(train_ds, cfg, seed=0, device=dev)
        sync()
        dt = time.perf_counter() - t0
        first, last = float(ls[:5].mean()), float(ls[-5:].mean())
        log(f"{name}: {ls.size} steps in {dt:.2f} s, loss {first:.6f} -> {last:.6f}"
            + (f", {row_gather.launches - g0} row_gather launches" if cfg.field_impl == "voxel" else ""))
        if ls.size != cfg.n_steps or not np.isfinite(ls).all() or not last < first:
            raise SystemExit(f"{name}: losses missing, not finite or not falling")

    # two frames in chunks of 32,768 rays: only whole chunks of short-span
    # rays switch to the short march, and one frame's sphere does not fill
    # the voxel field's default chunk
    view = (test_ds.origins[:2], test_ds.rotations[:2])
    bucketed = dataclasses.replace(vcfg, render_span_bucket=True)
    sync()
    t0 = time.perf_counter()
    a = render_views(vparams, *view, test_ds.camera, vcfg, chunk=SPAN_BUCKET_CHUNK)
    sync()
    t1 = time.perf_counter()
    b = render_views(vparams, *view, test_ds.camera, bucketed, chunk=SPAN_BUCKET_CHUNK)
    sync()
    t2 = time.perf_counter()
    psnr = float(mse2psnr(torch.mean((a - b) ** 2)))
    log(f"span-bucketed render of two trained voxel frames against the unbucketed one: PSNR {psnr:.2f} dB "
        f"(need >= {SPAN_BUCKET_PSNR_MIN}), share of values that differ {float((a != b).float().mean()):.4f}, "
        f"{(t1 - t0) * 1e3:.1f} ms unbucketed, {(t2 - t1) * 1e3:.1f} ms bucketed ({card})")
    if not (torch.isfinite(b).all() and psnr >= SPAN_BUCKET_PSNR_MIN):
        raise SystemExit("the span-bucketed render strays from the unbucketed one")
    if torch.equal(a, b):
        raise SystemExit("the span bucket switched no chunk to the short march")

    mesh = os.path.join(root, "mesh.ply")
    video = os.path.join(root, "video", "clip.mp4")
    one_view = write_scene(root, dev, "path", 2, turn=0.25)
    run(train_json, cfg=vcfg, load_snapshot_path=os.path.join(root, "voxel.ingp"), device=dev,
        save_mesh_path=mesh, marching_cubes_res=64, video_camera_path=one_view, video_output=video)
    pts, cols = load_ply(mesh)
    frames = sorted(os.listdir(os.path.join(root, "video", "clip_frames")))
    log(f"save_mesh_path: {len(pts)} surface points at 64^3 (colours {None if cols is None else cols.shape}), "
        f"centre {np.round(pts.mean(0), 3).tolist() if len(pts) else None}; video frames {frames}")
    if len(pts) == 0 or cols is None or len(frames) != 2:
        raise SystemExit("mesh export or video frames are missing")
    # the trained sphere: radius 0.3 about the volume's centre
    radius = np.linalg.norm(pts - 0.5, axis=1)
    if not 0.2 < float(np.median(radius)) < 0.35:
        raise SystemExit(f"the exported surface is not the trained sphere (median radius {np.median(radius):.3f})")


# --- phase 10: the coverage-dataset path --------------------------------------


def write_procedural_obj(path: str, seed=None) -> None:
    """A chair-like mesh in ShapeNet's frame (Y up, extent ~1.5): seat,
    cushion, back and four legs as boxes, each part with its own ``Kd``
    colour from ``parts.mtl``.  With a ``seed``, a variant: the width,
    depth, leg length and back height scaled by 0.7-1.4 and every part's
    colour drawn."""
    parts = [  # (material, Kd, lo, hi)
        ("seat", (0.75, 0.25, 0.1), (-0.4, 0.0, -0.4), (0.4, 0.08, 0.4)),
        ("cushion", (0.9, 0.8, 0.2), (-0.32, 0.08, -0.3), (0.32, 0.15, 0.34)),
        ("back", (0.1, 0.35, 0.8), (-0.4, 0.08, -0.4), (0.4, 0.9, -0.32)),
        ("legs", (0.25, 0.25, 0.25), (-0.4, -0.6, -0.4), (-0.32, 0.0, -0.32)),
        ("legs", None, (0.32, -0.6, -0.4), (0.4, 0.0, -0.32)),
        ("legs", None, (-0.4, -0.6, 0.32), (-0.32, 0.0, 0.4)),
        ("legs", None, (0.32, -0.6, 0.32), (0.4, 0.0, 0.4)),
    ]
    if seed is not None:
        rng = np.random.default_rng(seed)
        w, d, legs, back = rng.uniform(0.7, 1.4, 4)

        def warp(p):
            x, y, z = p
            y = y * legs if y < 0 else (0.15 + (y - 0.15) * back if y > 0.15 else y)
            return (x * w, y, z * d)

        parts = [(name, None if kd is None else tuple(rng.uniform(0.05, 0.95, 3)), warp(lo), warp(hi))
                 for name, kd, lo, hi in parts]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(os.path.join(os.path.dirname(path), "parts.mtl"), "w") as f:
        for name, kd, _, _ in parts:
            if kd is not None:
                f.write(f"newmtl {name}\nKd {kd[0]} {kd[1]} {kd[2]}\n")
    quads = [(1, 2, 3, 4), (5, 8, 7, 6), (1, 5, 6, 2), (2, 6, 7, 3), (3, 7, 8, 4), (5, 1, 4, 8)]
    with open(path, "w") as f:
        f.write("mtllib parts.mtl\n")
        for k, (name, _, lo, hi) in enumerate(parts):
            for x, y, z in ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)):
                f.write(f"v {(lo, hi)[x][0]} {(lo, hi)[y][1]} {(lo, hi)[z][2]}\n")
            f.write(f"usemtl {name}\n")
            for q in quads:
                f.write("f " + " ".join(str(8 * k + i) for i in q) + "\n")


def native_loader_line() -> str:
    """Build the repo's native IO runtime (``make -C csrc``) where it is not
    built yet, and say which PLY loader the path takes."""
    if not native.available():
        csrc = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
        proc = subprocess.run(["make", "-C", csrc], capture_output=True, text=True)
        native._TRIED, native._LIB = False, None
        if proc.returncode != 0:
            return f"native PLY loader not built (make -C csrc: exit {proc.returncode}); the Python parser reads"
    return "native PLY loader (csrc/libprv_runtime.so)" if native.available() else "Python PLY parser"


def check_dataset_files(cfg, scene, cov_json: str, novel_jsons: list) -> tuple:
    """The coverage and novel sets on disk: PNG counts, every json pose
    against ``camera_to_world`` of the views it was rendered from, and the
    coverage frames' object pixel rate (mean, min)."""
    from PIL import Image

    unit = load_view_space(cfg.viewspace_path, COVERAGE_VIEWS)
    views = ViewSpace(unit, scene.points, cfg.view_space_radius).views
    center = scene.object_center
    train_v = np.loadtxt(os.path.join(cfg.workspace, "novel_train_views.txt"))
    test_v = np.loadtxt(os.path.join(cfg.workspace, "novel_test_views.txt"))
    sets = [(cov_json, str(COVERAGE_VIEWS), views)]
    for path, sub, v in zip(novel_jsons, ("novel_train", "novel_test"), (train_v, test_v)):
        sets.append((path, sub, v / np.linalg.norm(v, axis=1, keepdims=True) * cfg.view_space_radius + center))
    for path, sub, pos in sets:
        pngs = sorted(os.listdir(os.path.join(cfg.gt_path, sub)))
        want = camera_to_world(pos, center)
        with open(path) as f:
            got = np.array([unmap_pose(np.asarray(fr["transform_matrix"])) for fr in json.load(f)["frames"]])
        err = float(np.abs(got - want).max()) if got.shape == want.shape else float("inf")
        log(f"{os.path.basename(path)}: {len(pngs)} PNGs, {len(got)} frames, poses off camera_to_world by {err:.1e}")
        # the coverage views were rendered from the generated view space before
        # its file (8 significant digits) was written, and are read back here
        if len(pngs) != len(pos) or len(got) != len(pos) or err > 1e-7:
            raise SystemExit(f"{path}: wrong PNG count or poses")
    rates = [object_pixel_rate(np.asarray(Image.open(os.path.join(cfg.gt_path, str(COVERAGE_VIEWS),
                                                                  f"rgbaClip_{i}.png")))[..., 3])
             for i in range(COVERAGE_VIEWS)]
    return float(np.mean(rates)), float(np.min(rates))


def splat_check_inputs(scene, dev, c2ws):
    """The loaded object's points with every 7th repeated at the end in a
    random colour (exact depth ties whose colours differ), and the first
    four coverage frames' world-to-camera matrices."""
    pts = torch.from_numpy(np.asarray(scene.points, np.float32)).to(dev)
    col = _colors01(scene.colors, len(pts), dev)
    g = torch.Generator(device=dev).manual_seed(31)
    dup = pts[::7]
    pts = torch.cat([pts, dup]).contiguous()
    col = torch.cat([col, torch.rand((len(dup), 3), generator=g, device=dev)]).contiguous()
    return pts, col, _world_to_camera(c2ws[:4]).to(dev)


def check_splat(pts, col, w2c, variants: dict) -> None:
    """K8 against ``splat_plain`` on four full-size frames at point sizes 5
    and 1 (u8 RGBA, every pixel) and on one frame in f32; then each broken
    variant, which must differ somewhere."""
    wants = {}
    for ps in (5, 1):
        got, want = splat(pts, col, w2c, CAMERA, ps), splat_plain(pts, col, w2c, CAMERA, ps)
        wants[ps] = want
        sync()
        covered = float((want[..., 3] > 0).float().mean())
        log(f"K8, {w2c.shape[0]} frames {CAMERA.width}x{CAMERA.height}, {len(pts)} points, point size {ps}: "
            f"{'bit-equal' if torch.equal(got, want) else 'DIFFERENT'} to splat_plain, {covered:.4f} of pixels covered")
        if not torch.equal(got, want):
            raise SystemExit(f"K8 disagrees with splat_plain at point size {ps}: "
                             f"{int((got != want).any(-1).sum())} pixels differ")
    rgb, alpha = splat(pts, col, w2c[:1], CAMERA, 5, rgba_u8=False)
    rgb_p, alpha_p = splat_plain(pts, col, w2c[:1], CAMERA, 5, rgba_u8=False)
    if not (torch.equal(rgb, rgb_p) and torch.equal(alpha, alpha_p)):
        raise SystemExit("K8's f32 output disagrees with splat_plain")
    log("K8 f32 rgb + alpha, one frame, point size 5: bit-equal to splat_plain")
    for name, lib in variants.items():
        with wrapper_library("_lib", lib, splat_mod):
            diff = [int((splat(pts, col, w2c, CAMERA, ps) != wants[ps]).any(-1).sum()) for ps in (5, 1)]
        log(f"  broken on purpose, K8 with {name}: {diff[0]} / {diff[1]} pixels differ at point size 5 / 1 -> "
            f"{'caught' if sum(diff) else 'NOT caught'}")
        if not sum(diff):
            raise SystemExit(f"the K8 check does not catch {name}")


def inside_rays(gs, n: int = 20_000) -> tuple:
    """(origins, dirs) of up to ``n`` rays that start inside the grid's box:
    each 0.6 of a voxel into an occupied voxel along +x, heading +x, so that
    step 0 (a quarter voxel on at 2 steps a voxel) samples that voxel and
    step 1 the next one.  A march that skips a ray's first in-grid step
    reports another voxel for every one of them."""
    idx = torch.nonzero(gs.occupancy)
    idx = idx[torch.linspace(0, len(idx) - 1, min(len(idx), n), device=idx.device).long()]
    go = torch.tensor([float(np.float32(v)) for v in gs.origin], device=idx.device)
    shift = torch.tensor([0.6, 0.5, 0.5], device=idx.device)
    o = ((idx.float() + shift) * float(np.float32(gs.resolution)) + go).contiguous()
    d = torch.tensor([[1.0, 0.0, 0.0]], device=idx.device).expand_as(o).contiguous()
    return o, d


def check_cast(scene, c2w, dev, variants: dict) -> None:
    """K9 through ``precept`` on one full view against ``voxel_cast_plain``
    on the rays of rows CAST_ROWS, and on rays that start inside occupied
    voxels (``inside_rays``; hit flags, centres, colours bit-equal); then
    each broken variant, which must differ somewhere: in the full view from
    the kernel (whose full view is held bit-equal to ``voxel_cast_plain``
    where K9 is timed), or on the inside rays."""
    lo, hi = (r * CAMERA.width for r in CAST_ROWS)
    o, d = precept_rays(c2w, CAMERA, dev)
    full = precept(scene.gt_scene, c2w, CAMERA)
    got = [t.reshape(CAMERA.height * CAMERA.width, -1)[lo:hi] for t in full]
    gs = scene.gt_scene
    n_steps = int(np.ceil(1.0 / gs.resolution * 2.0))
    want = voxel_cast_plain(gs.occupancy, gs.color_grid, gs.origin, gs.resolution, o[lo:hi].contiguous(),
                            d[lo:hi].contiguous(), 1.0, n_steps)
    same = [torch.equal(a.reshape(b.shape), b) for a, b in zip(got, want)]
    share = float(want[0].float().mean())
    log(f"K9 through precept, rows {CAST_ROWS[0]}-{CAST_ROWS[1]} of a {CAMERA.width}x{CAMERA.height} view "
        f"({hi - lo} rays, {n_steps} steps, {share:.4f} hit): hit/centre/colour bit-equal to voxel_cast_plain: {same}")
    if not all(same) or not 0.0 < share < 1.0:
        raise SystemExit("K9 disagrees with voxel_cast_plain, or the rays compared are all hits or all misses")
    o_in, d_in = inside_rays(gs)
    args_in = (gs.occupancy, gs.color_grid, gs.origin, gs.resolution, o_in, d_in, 1.0, n_steps)
    want_in = voxel_cast_plain(*args_in)
    same_in = [torch.equal(a, b) for a, b in zip(voxel_cast(*args_in), want_in)]
    log(f"K9 on {len(o_in)} rays from inside occupied voxels: hit/centre/colour bit-equal to voxel_cast_plain: "
        f"{same_in}")
    if not all(same_in):
        raise SystemExit("K9 disagrees with voxel_cast_plain on rays from inside the grid")
    for name, lib in variants.items():
        with wrapper_library("_lib", lib, cast_mod):
            bad = precept(scene.gt_scene, c2w, CAMERA)
            bad_in = voxel_cast(*args_in)
        moved = int(((bad[0] != full[0]) | (bad[1] != full[1]).any(-1)).sum())
        in_rows = int((bad[1].reshape(-1, 3)[lo:hi] != want[1]).any(-1).sum())
        moved_in = int(((bad_in[0] != want_in[0]) | (bad_in[1] != want_in[1]).any(-1)).sum())
        log(f"  broken on purpose, K9 that {name}: {moved} of {full[0].numel()} rays' hits or centres differ from "
            f"the kernel's ({in_rows} in rows {CAST_ROWS[0]}-{CAST_ROWS[1]} from voxel_cast_plain's), {moved_in} of "
            f"the {len(o_in)} inside rays' -> {'caught' if moved + moved_in else 'NOT caught'}")
        if not moved + moved_in:
            raise SystemExit(f"the K9 check does not catch a kernel that {name}")


def splat_masks(pts, w2c, ps: int):
    """(flat pixel index, depth) of every in-frame splat of every frame, as
    ``splat_plain`` builds them: the work K8's atomics do, and the input of
    the library call it is timed beside."""
    from nerf_prv_tpu_torch.ops.splat import _frame_projection

    half = ps // 2
    offs = torch.arange(-half, ps - half, device=pts.device)
    du, dv = (t.reshape(-1) for t in torch.meshgrid(offs, offs, indexing="ij"))
    flats, depths = [], []
    for f, m in enumerate(w2c):
        uf, vf, z, valid = _frame_projection(pts, m, CAMERA, ps)
        ui, vi = uf[valid].to(torch.int64), vf[valid].to(torch.int64)
        uu, vv = (ui[:, None] + du).reshape(-1), (vi[:, None] + dv).reshape(-1)
        ok = (uu >= 0) & (uu < CAMERA.width) & (vv >= 0) & (vv < CAMERA.height)
        flats.append(((vv * CAMERA.width + uu) + f * CAMERA.width * CAMERA.height)[ok])
        depths.append(z[valid].repeat_interleave(ps * ps)[ok])
    return torch.cat(flats), torch.cat(depths)


def splat_bound_ms(n_points: int, frames: int, u8: bool, ps: int, n_splats: int) -> tuple:
    """Least time for one K8 call: points and colours read once and the
    frames written once over HBM, or the arithmetic at the f32 peak: per
    (point, frame) the transform (9 multiplies, 9 adds), 2 divides, the
    distortion (27 operations at models 1-2) and the pixel (2 multiply-adds,
    2 roundings, 6 tests), once; per splat a depth test and a winner test."""
    out = frames * CAMERA.width * CAMERA.height * (4 if u8 else 16)
    bytes_moved = n_points * 24 + frames * 48 + out
    ops = n_points * frames * (18 + 2 + 27 + 12) + 2 * n_splats
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bin_stats(pts, w2c, ps: int, tile: int) -> str:
    """K8's bins on these inputs by its binning's plain mirror: the largest
    and the mean bin, and the entries against the capacity sized from shapes."""
    bins = splat_mod.bin_counts_plain(pts, w2c, CAMERA, ps, tile)
    full = bins[bins > 0].float()
    cap = w2c.shape[0] * splat_mod.bin_capacity(len(pts), ps, tile)
    return (f"{tile}x{tile}-pixel tiles: {bins.numel()} bins, largest {int(bins.max())}, mean "
            f"{float(bins.float().mean()):.1f}, mean of the {full.numel()} non-empty {float(full.mean()):.1f}; "
            f"{int(bins.sum())} entries in a capacity of {cap}")


def splat_memory(pts, col, w2c, frames: int, ps: int) -> str:
    """K8's scratch for one u8 call at ``frames`` frames (bins, counts and
    cursors, from the shapes, as the wrapper sizes them) and the peak device
    memory the call adds, output included.  The frames cycle through
    ``w2c``: the scratch depends on the shapes alone."""
    m = w2c[torch.arange(frames, device=w2c.device) % w2c.shape[0]].contiguous()
    tile = splat_mod._lib().splat_tile_side()
    tiles = -(-CAMERA.width // tile) * -(-CAMERA.height // tile)
    scratch = frames * (splat_mod.bin_capacity(len(pts), ps, tile) * 16 + tiles * 12)
    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = splat(pts, col, m, CAMERA, ps, rgba_u8=True)
    sync()
    peak = torch.cuda.max_memory_allocated() - base
    return (f"F={frames} u8: scratch {scratch / 1e6:.1f} MB from the shapes, output {out.numel() / 1e6:.1f} MB, "
            f"peak device memory the call adds {peak / 1e6:.1f} MB")


def cast_steps(gs, o, d, n_steps: int) -> dict:
    """Steps of the rays (o, d) through the scene's grid, by the plain march:
    ``to_hit``, every step up to and including the first hit (all
    ``n_steps`` for a miss), what a march of every step takes; ``needed``,
    each ray's step 0 (whose clipped voxel a miss reports) and its later
    steps whose sample lies inside the grid, up to the hit: the work the
    function needs, which K9's bound counts; ``marched``, step 0 and the
    steps of ``step_interval`` (the kernel's interval, mirrored on the
    host) up to the hit: what the kernel should take, counted here, not on
    the card."""
    lo, hi = cast_mod.step_interval(tuple(gs.occupancy.shape), gs.origin, gs.resolution, o, d, 1.0, n_steps)
    steps = torch.arange(n_steps, device=o.device)
    out, r0 = dict(to_hit=0, needed=0, marched=0), 0
    for hit, first, _, inside in cast_mod.march_chunks(gs.occupancy, gs.origin, gs.resolution, o, d, 1.0, n_steps):
        r = hit.shape[0]
        last = torch.where(hit, first, n_steps - 1)
        out["to_hit"] += int((last + 1).sum())
        out["needed"] += r + int((inside & (steps <= last[:, None]))[:, 1:].sum())
        out["marched"] += r + int(torch.clamp(torch.minimum(hi[r0:r0 + r], last) - lo[r0:r0 + r] + 1, min=0).sum())
        r0 += r
    return out


def cast_bound_ms(n_rays: int, grid_cells: int, steps: int) -> tuple:
    """Least time for one K9 call: rays read and hit, centre and colour
    written once, the occupancy grid and each ray's voxel colour read once,
    over HBM; or the ``steps`` the function needs (``cast_steps``'s
    ``needed``) at the f32 peak, 20 operations a step (the sample's t, then
    per axis a multiply, two adds, a divide and a floor, and the bounds
    tests)."""
    bytes_moved = n_rays * (24 + 1 + 12 + 12 + 12) + grid_cells
    ops = 20 * steps + 9 * n_rays
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed_output(fn, warmup: int) -> tuple:
    """``time_ms`` of one call of ``fn``, and that call's output."""
    out = []
    ms = time_ms(lambda: out.append(fn()), iters=1, warmup=warmup)
    return ms, out[-1]


def outputs_err(label: str, got, want) -> float:
    """Largest |kernel - plain| over the outputs (a tensor or a tuple of
    them; a flipped hit flag counts 1).  The run fails unless every output
    is bit-equal."""
    pairs = list(zip(got, want)) if isinstance(want, tuple) else [(got, want)]
    err = max(float((a.double() - b.double()).abs().max()) if b.numel() else 0.0 for a, b in pairs)
    if err or not all(torch.equal(a, b) for a, b in pairs):
        raise SystemExit(f"{label}: the kernel disagrees with its plain version on the timed inputs "
                         f"(max |kernel - plain| {err})")
    return err


def splat_row(pts, col, m, u8: bool, ps: int, card: str) -> dict:
    """K8 on ``m``'s frames at ``CAMERA``: device and call time, the plain
    version's time and output (the kernel's must be bit-equal to it), the
    bound, and ``scatter_reduce_`` "amin" on the same splats."""
    frames = m.shape[0]
    label = f"F={frames} {'u8 RGBA' if u8 else 'f32 rgb + alpha'} {CAMERA.width}x{CAMERA.height}, N={len(pts)}, ps={ps}"
    flat, depth = splat_masks(pts, m, ps)
    zero = torch.full((frames * CAMERA.width * CAMERA.height,), float("inf"), device=pts.device)
    row = dict(shape=label)
    iters = 50 if frames == 1 else 5
    row["ms"] = device_ms(lambda: splat(pts, col, m, CAMERA, ps, rgba_u8=u8), iters=iters)
    row["call_ms"] = min(time_ms(lambda: splat(pts, col, m, CAMERA, ps, rgba_u8=u8), iters=iters) for _ in range(2))
    # the plain version takes ~0.5 s a frame: one call, no warmup
    row["plain_ms"], want = timed_output(lambda: splat_plain(pts, col, m, CAMERA, ps, rgba_u8=u8),
                                         warmup=0 if frames > 1 else 1)
    row["max_abs_err"] = outputs_err(f"K8 {label}", splat(pts, col, m, CAMERA, ps, rgba_u8=u8), want)
    del want
    row["library_ms"] = device_ms(lambda: zero.clone().scatter_reduce_(0, flat, depth, "amin"), iters=iters)
    row["bound_ms"], row["bound_by"] = splat_bound_ms(len(pts), frames, u8, ps, flat.numel())
    log(f"K8 {label}: device {row['ms']:.4f} ms, call {row['call_ms']:.4f} ms, splat_plain {row['plain_ms']:.4f} ms, "
        f"scatter_reduce_ amin on the {flat.numel()} materialised splats (z-buffer only) {row['library_ms']:.4f} ms, "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}) = {row['bound_ms'] / row['ms']:.3f} of the time; "
        f"{flat.numel() / frames:.0f} in-frame splats a frame, each a depth test and a winner test; "
        f"bit-equal to the timed splat_plain call ({card})")
    log(f"K8 {label}: {bin_stats(pts, m, ps, splat_mod._lib().splat_tile_side())}")
    return row


def time_kernels_coverage(scene, dev, c2ws, card) -> tuple:
    """K8 at the size test's shape (one frame, f32) and the coverage set's
    (50 frames, u8), and K9 on one full view, each beside its plain version,
    its bound and (K8) ``scatter_reduce_`` "amin" on the same splats."""
    pts = torch.from_numpy(np.asarray(scene.points, np.float32)).to(dev)
    col = _colors01(scene.colors, len(pts), dev)
    w2c = _world_to_camera(c2ws).to(dev)
    ps = 5
    rows = [splat_row(pts, col, w2c[:frames].contiguous(), u8, ps, card)
            for frames, u8 in ((1, False), (COVERAGE_VIEWS, True))]
    for frames in (COVERAGE_VIEWS, 100):
        log(f"K8 memory, N={len(pts)}, ps={ps}: {splat_memory(pts, col, w2c, frames, ps)} ({card})")
    gs = scene.gt_scene
    o, d = precept_rays(c2ws[0], CAMERA, dev)
    n_steps = int(np.ceil(1.0 / gs.resolution * 2.0))
    args = (gs.occupancy, gs.color_grid, gs.origin, gs.resolution, o, d, 1.0, n_steps)
    cast = dict(shape=f"R={o.shape[0]} rays, {n_steps} steps, grid {tuple(gs.occupancy.shape)}", library_ms=None)
    cast.update(kernel_times(lambda: voxel_cast(*args), "voxel_cast"))
    cast["plain_ms"], want = timed_output(lambda: voxel_cast_plain(*args), warmup=1)
    cast["max_abs_err"] = outputs_err(f"K9 {cast['shape']}", voxel_cast(*args), want)
    steps = cast_steps(gs, o, d, n_steps)
    cast["bound_ms"], cast["bound_by"] = cast_bound_ms(o.shape[0], gs.occupancy.numel(), steps["needed"])
    log(f"K9 {cast['shape']}: {times_text(cast)}, voxel_cast_plain {cast['plain_ms']:.4f} ms; steps: "
        f"{steps['needed']} needed (step 0 and the in-grid steps up to the hit, {steps['needed'] / o.shape[0]:.1f} a "
        f"ray), {steps['marched']} in the kernel's interval by its host mirror, {steps['to_hit']} by a march of every "
        f"step to the hit "
        f"(bound on that count {cast_bound_ms(o.shape[0], gs.occupancy.numel(), steps['to_hit'])[0]:.4f} ms); "
        f"bound {cast['bound_ms']:.4f} ms ({cast['bound_by']}) = "
        f"{cast['bound_ms'] / cast['ms']:.3f} of the time; hit/centre/colour bit-equal to the timed voxel_cast_plain call "
        f"({card})")
    return rows, cast


def coverage_config(root: str) -> tuple:
    """Phase 10's pipeline config under ``root``, the procedural OBJ's path
    and the PLY its sampling writes."""
    ws = os.path.join(root, "coverage_ws")
    cfg = Config(workspace=ws, model_path=os.path.join(ws, "models"), viewspace_path=os.path.join(ws, "viewspace"),
                 name_of_pcd=OBJ_NAME, is_shape_net=True, camera=CAMERA, seed=0)
    obj = os.path.join(ws, "mesh", "model_normalized.obj")
    return cfg, obj, os.path.join(cfg.model_path, "ShapeNet", OBJ_NAME + ".ply")


def coverage_object(dev, root: str) -> tuple:
    """Phase 10's object on the card and the camera-to-world matrices of its
    coverage set (as ``get_coverage`` makes them), without the dataset path
    around them: the inputs of ``--k8`` and ``--k9``."""
    from nerf_prv_tpu_torch.scene.object_setup import _ensure_viewspace

    cfg, obj, ply = coverage_config(root)
    write_procedural_obj(obj)
    if not sample_and_voxelize(obj, ply, n_points=OBJ_POINTS, grid_resolution=OBJ_GRID):
        raise SystemExit("sample_and_voxelize wrote nothing")
    scene = load_object(cfg, device=dev)
    unit = _ensure_viewspace(cfg.viewspace_path, COVERAGE_VIEWS, dev)
    c2ws = camera_to_world(np.asarray(ViewSpace(unit, scene.points, cfg.view_space_radius).views),
                           scene.object_center)
    return scene, c2ws


def k8_caller(lib):
    """``call(pts, col, w2c, ps, u8)`` through the wrapper on one bound
    build of K8 (the tree's C interface)."""
    def call(pts, col, w2c, ps, u8):
        with wrapper_library("_lib", lib, splat_mod):
            return splat(pts, col, w2c, CAMERA, ps, rgba_u8=u8)
    return call


def in_turns(builds: dict, fn, iters: int) -> dict:
    """Device time of ``fn(build)`` for every build, first to last and back."""
    times = {name: [] for name in builds}
    for name in list(builds) + list(reversed(builds)):
        times[name].append(device_ms(lambda: fn(builds[name]), iters=iters))
    return times


def turns_text(times: dict) -> str:
    return "; ".join(f"{name} {a:.4f} {b:.4f}" for name, (a, b) in times.items())


def kernel_breakdown(fn, keys: tuple) -> str:
    """Device time by kernel of one ``fn()`` under the profiler, for the
    kernels and copies whose names hold one of ``keys``."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and any(k in e.name for k in keys):
            short = re.search(r"[A-Za-z_]\w*(<\w+>)?(?=\()|Memset|Memcpy \w+", e.name)
            name = short.group(0) if short else e.name[:40]
            by_name[name] = by_name.get(name, 0.0) + e.device_time_total
    return ", ".join(f"{name} {us:.1f} us" for name, us in sorted(by_name.items(), key=lambda kv: -kv[1]))


def compare_k8(dev, specs: list, card: str):
    """Other builds of K8 against this tree's, in turns on one card.  Each is
    held against ``splat_plain`` on phase 10's tie scene (4 frames, point
    sizes 5 and 1, u8) and on the size test's frame (f32), and against the
    tree's output on the 50-frame coverage set (whose agreement with
    ``splat_plain`` the whole smoke checks); the run fails only where the
    tree's kernel disagrees (an ablation may drop work on purpose).  Then
    all are timed, first to last and back, at phase 10's two shapes, and
    each one's kernels by the profiler."""
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        scene, c2ws = coverage_object(dev, root)
    libs = {"tree": splat_mod._lib()}
    libs.update(build_sources(specs, "k8", splat_mod.bind))
    calls = {name: k8_caller(lib) for name, lib in libs.items()}
    pts_t, col_t, w2c_t = splat_check_inputs(scene, dev, c2ws)
    wants = {ps: splat_plain(pts_t, col_t, w2c_t, CAMERA, ps) for ps in (5, 1)}
    pts = torch.from_numpy(np.asarray(scene.points, np.float32)).to(dev)
    col = _colors01(scene.colors, len(pts), dev)
    w2c = _world_to_camera(c2ws).to(dev)
    want1 = splat_plain(pts, col, w2c[:1], CAMERA, 5, rgba_u8=False)
    ref = calls["tree"](pts, col, w2c, 5, True)
    for name, call in calls.items():
        same = [torch.equal(call(pts_t, col_t, w2c_t, ps, True), wants[ps]) for ps in (5, 1)]
        rgb, alpha = call(pts, col, w2c[:1], 5, False)
        same += [torch.equal(rgb, want1[0]) and torch.equal(alpha, want1[1]),
                 torch.equal(call(pts, col, w2c, 5, True), ref)]
        log(f"K8 {name}: tie scene at point size 5 / 1, size-test frame f32, coverage set against the tree: {same}"
            + ("" if all(same) else " WRONG"))
        # another build may drop work on purpose (an ablation): only this tree's kernel has to be right
        if name == "tree" and not all(same):
            raise SystemExit("the tree's K8 disagrees with splat_plain")
        log(f"K8 {name}, the coverage set: {bin_stats(pts, w2c, 5, libs[name].splat_tile_side())}")
    del ref, wants
    for frames, u8, iters in ((1, False, 50), (COVERAGE_VIEWS, True, 5)):
        m = w2c[:frames].contiguous()
        flat, _ = splat_masks(pts, m, 5)
        bound, by = splat_bound_ms(len(pts), frames, u8, 5, flat.numel())
        del flat
        times = in_turns(calls, lambda call: call(pts, col, m, 5, u8), iters)
        log(f"K8 F={frames} {'u8' if u8 else 'f32'}, N={len(pts)}, ps 5 (bound {bound:.4f} ms, {by}; {card}): "
            + turns_text(times))
        for name, call in calls.items():
            log(f"  {name} by kernel: {kernel_breakdown(lambda: call(pts, col, m, 5, u8), ('splat_', 'Memset'))}")


def compare_k9(dev, specs: list, card: str):
    """Other builds of K9 (the tree's C interface) against this tree's, in
    turns on one card: each held bit-equal to ``voxel_cast_plain`` on two
    full views of phase 10's object, then all timed, first to last and back,
    on both, beside the steps each view needs and the tree's kernel's
    interval holds (``cast_steps``)."""
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        scene, c2ws = coverage_object(dev, root)
    libs = {"tree": cast_mod._lib()}
    libs.update(build_sources(specs, "k9", cast_mod.bind))
    gs = scene.gt_scene
    n_steps = int(np.ceil(1.0 / gs.resolution * 2.0))
    for view in (0, 1):
        o, d = precept_rays(c2ws[view], CAMERA, dev)
        args = (gs.occupancy, gs.color_grid, gs.origin, gs.resolution, o, d, 1.0, n_steps)
        want = voxel_cast_plain(*args)

        def cast(lib):
            with wrapper_library("_lib", lib, cast_mod):
                return voxel_cast(*args)
        for name, lib in libs.items():
            if not all(torch.equal(a, b) for a, b in zip(cast(lib), want)):
                raise SystemExit(f"K9 build {name} disagrees with voxel_cast_plain on view {view}")
        times = in_turns(libs, cast, 50)
        steps = cast_steps(gs, o, d, n_steps)
        bound, by = cast_bound_ms(o.shape[0], gs.occupancy.numel(), steps["needed"])
        log(f"K9 view {view}, {o.shape[0]} rays, grid {tuple(gs.occupancy.shape)}, {float(want[0].float().mean()):.4f} "
            f"hit, every build bit-equal to voxel_cast_plain; steps needed {steps['needed']}, in the tree's kernel's "
            f"interval by its host mirror {steps['marched']}, by a march of every step to the hit {steps['to_hit']} (bound {bound:.4f} ms, "
            f"{by}; {card}): " + turns_text(times))


def phase_coverage(dev, root: str, card: str) -> tuple:
    from concurrent.futures import ThreadPoolExecutor

    log(f"== phase 10: object to coverage dataset: a {OBJ_POINTS}-point object, {COVERAGE_VIEWS} coverage and "
        f"2 x 100 novel views at {CAMERA.width}x{CAMERA.height}")
    t_phase = time.perf_counter()
    # the broken variants build while the path runs
    broken = [("splat", name, reps) for name, reps in SPLAT_BROKEN.items()]
    broken += [("voxel_cast", name, reps) for name, reps in CAST_BROKEN.items()]
    pool = ThreadPoolExecutor(max_workers=len(broken))
    builds = {(src, name): pool.submit(_build.edited, src, reps) for src, name, reps in broken}
    cfg, obj, ply = coverage_config(root)
    ws = cfg.workspace
    write_procedural_obj(obj)
    log(native_loader_line())

    splat.launches = 0
    voxel_cast.launches = 0
    stages = {}
    t0 = time.perf_counter()
    if not sample_and_voxelize(obj, ply, n_points=OBJ_POINTS, grid_resolution=OBJ_GRID):
        raise SystemExit("sample_and_voxelize wrote nothing")
    stages["sample_and_voxelize"] = time.perf_counter() - t0
    t = time.perf_counter()
    scene = load_object(cfg, device=dev)
    sync()
    stages["load_object"] = time.perf_counter() - t
    t = time.perf_counter()
    top = scene.view_space.views[scene.view_space.top_view_id()]
    hit, _, _ = precept(scene.gt_scene, camera_to_world(top[None], scene.object_center)[0], CAMERA)
    sync()
    stages["precept"] = time.perf_counter() - t
    t = time.perf_counter()
    cov_json = get_coverage(scene, cfg, COVERAGE_VIEWS, device=dev)
    stages["get_coverage"] = time.perf_counter() - t
    t = time.perf_counter()
    novel_jsons = generate_novel_sets(scene, cfg, device=dev)
    stages["generate_novel_sets"] = time.perf_counter() - t
    wall = time.perf_counter() - t0
    launched = (splat.launches, voxel_cast.launches)
    log(f"path: {wall:.2f} s (" + ", ".join(f"{k} {v:.2f} s" for k, v in stages.items()) + f"); "
        f"K8 {launched[0]} launches, K9 {launched[1]}")
    size_txt = open(os.path.join(cfg.gt_path, "size.txt")).read()
    log(f"object: {len(scene.points)} points, size {scene.size:.6f} m (size.txt {size_txt}), voxel grid "
        f"{tuple(scene.gt_scene.occupancy.shape)} at {cfg.ground_truth_resolution} m ({scene.gt_scene.full_voxels} "
        f"voxels), top view precept hits {int(hit.sum())} pixels")
    if not (scene.ok and cfg.size_min <= scene.size <= cfg.size_max and int(hit.sum()) > 0):
        raise SystemExit("the object was rejected, sized out of range, or invisible to precept")
    # the size test renders its 5 probe views in one launch a try; the
    # coverage set and the two novel sets one launch each; precept one K9 launch
    tries = launched[0] - 3
    if tries < 1 or launched[1] != 1:
        raise SystemExit(f"unexpected launch counts {launched}: 1 per size try + 3, and 1 K9")
    mean_rate, min_rate = check_dataset_files(cfg, scene, cov_json, novel_jsons)
    log(f"{tries} size tries; coverage frames' object pixel rate mean {mean_rate:.4f}, min {min_rate:.4f} "
        f"(need mean > {cfg.object_pixel_rate})")
    if not mean_rate > cfg.object_pixel_rate:
        raise SystemExit("the coverage frames show too little of the object")

    c2ws = camera_to_world(ViewSpace(load_view_space(cfg.viewspace_path, COVERAGE_VIEWS), scene.points,
                                     cfg.view_space_radius).views, scene.object_center)
    variants = {name: fut.result() for name, fut in builds.items()}
    pool.shutdown()
    pts, col, w2c = splat_check_inputs(scene, dev, c2ws)
    check_splat(pts, col, w2c, {k: splat_mod.bind(variants["splat", k]) for k in SPLAT_BROKEN})
    del pts, col, w2c
    check_cast(scene, c2ws[0], dev, {k: cast_mod.bind(variants["voxel_cast", k]) for k in CAST_BROKEN})

    # the voxel field on the port-rendered coverage set, scored on the novel test set
    ncfg = dataclasses.replace(VOXEL_CFG, n_steps=COVERAGE_STEPS)
    t = time.perf_counter()
    metrics = run(cov_json, test_transforms=novel_jsons[1], cfg=ncfg, seed=0, device=dev)
    sync()
    base = black_psnr(load_dataset(novel_jsons[1]))
    log(f"voxel field, {COVERAGE_STEPS} steps on the {COVERAGE_VIEWS} coverage frames, scored on the 100 novel test "
        f"frames: {time.perf_counter() - t:.2f} s, PSNR {metrics['PSNR']:.3f} dB, SSIM {metrics['SSIM']:.4f}; an "
        f"all-black frame scores {base:.3f} dB (need >= {COVERAGE_PSNR_MARGIN_DB} dB above it)")
    if not (math.isfinite(metrics["PSNR"]) and metrics["PSNR"] >= base + COVERAGE_PSNR_MARGIN_DB):
        raise SystemExit("the field trained on the coverage set does not beat a black frame by the margin")

    k8_rows, k9 = time_kernels_coverage(scene, dev, c2ws, card)
    # the first get_coverage also wrote the view-space file; the profile is
    # held against a second call, which only reads it
    t = time.perf_counter()
    get_coverage(scene, cfg, COVERAGE_VIEWS, device=dev, gt_path=os.path.join(ws, "timed"))
    again_s = time.perf_counter() - t
    log(f"get_coverage again, view-space file already written: {again_s:.3f} s")
    calls = iter(range(1000))
    profile_device(lambda: get_coverage(scene, cfg, COVERAGE_VIEWS, device=dev,
                                        gt_path=os.path.join(ws, f"profiled_{next(calls)}")),
                   f"one get_coverage ({COVERAGE_VIEWS} frames, PNG encoding included)", again_s,
                   named=("splat_",))
    log(f"phase 10 took {time.perf_counter() - t_phase:.1f} s")
    head = k8_rows[1]  # the coverage set's shape
    k_splat = dict(
        name="splat", route="cuda", source="nerf_prv_tpu_torch/ops/csrc/splat.cu",
        replaces="nerf_prv_tpu/scene/render.py:38",
        note="XLA scatters in the JAX package (_splat_core, batched by _splat_batch_u8 at :90), not Pallas; "
             "library_ms is scatter_reduce_ amin on the materialised splats, the z-buffer alone",
        launches=launched[0], **{k: head[k] for k in
                                 ("max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        shape=head["shape"], shapes=k8_rows,
    )
    k_cast = dict(
        name="voxel_cast", route="cuda", source="nerf_prv_tpu_torch/ops/csrc/voxel_cast.cu",
        replaces="nerf_prv_tpu/scene/voxel.py:170",
        note="XLA ops in the JAX package (_cast_rays_grid), not Pallas",
        launches=launched[1], **{k: k9[k] for k in
                                 ("max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        shape=k9["shape"], shapes=[k9],
    )
    return k_splat, k_cast


# --- phase 11: batched multi-object training, labeling and path planning -----

# four different objects (bench.py's BATCH_OBJECTS = 4): the analytic sphere
# in four colour patterns of its unit normal, the first with fewer training
# frames than the others, so that the frame padding runs
BATCH_PATTERNS = (
    normal_colour,
    lambda n: n[:, [1, 2, 0]] * 0.5 + 0.5,
    lambda n: 0.5 - n * 0.5,
    lambda n: n[:, [2, 0, 1]] ** 2,
)
BATCH_FRAMES = (12, 16, 16, 16)
# the short batched hash run (its losses must fall, as phase 9's runs')
BATCH_HASH_K = 2
BATCH_HASH_STEPS = OPTION_STEPS
# labeling at a dataset's size: SURVEY's ~3,000 ShapeNet objects on
# Fit_ShapeNet's 24 view counts (labels.py:151), curves from known lognormal
# parameters with 0.05 dB of noise on each sample
FIT_B = 3000
FIT_X = np.arange(3, 51, 2)
FIT_NOISE = 0.05
# card fit against CPU fit: the CPU tests' tolerances of the port against
# the JAX package at this noise (tests/test_torch_labeling.py: curves
# measured within 2.0e-3 dB, their differences within 4.2e-4)
FIT_CURVE_TOL = 4e-3
FIT_DIFF_TOL = 1e-3
# planning: every view-space size the pipeline ships, on view spaces the
# port generates (2 restarts x 200 steps each); the card's edge matrix
# against the float64 scalar local path (float32 rounding, the CPU tests' 1e-5)
PLAN_SIZES = range(3, 61)  # cut from 3..100 to leave phase 13 room in the smoke's time
PLAN_RTOL = 1e-5


def batched_stepper(params, cfg: NerfConfig, obj, seed: int):
    """A closure that samples one batch for all K objects and takes one
    batched ``train_step`` on a copy of ``params``."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    opt = train_mod.make_optimizer(p, cfg)
    dev = obj.pixels.device
    g = torch.Generator(device=dev).manual_seed(seed)

    def step():
        batch = batch_mod.sample_objects(g, obj, cfg.train_rays)
        jitter = torch.rand((obj.k * cfg.train_rays, cfg.n_samples), generator=g, device=dev)
        return batch_mod.train_step(p, opt, batch, jitter, cfg)

    return step


def phase_batch_train(dev, root: str, gather: dict, scatter: dict, frames: dict, source: BatchSource,
                      single_ms: float, card: str):
    cfg = VOXEL_CFG
    k = len(BATCH_FRAMES)
    log(f"== phase 11a: train {k} objects together through train_batch, {cfg.n_steps} steps x {cfg.train_rays} "
        f"rays each, {'/'.join(map(str, BATCH_FRAMES))} frames {CAMERA.width}x{CAMERA.height}")
    trains, tests = [], []
    for i, (n_frames, colour) in enumerate(zip(BATCH_FRAMES, BATCH_PATTERNS)):
        trains.append(write_scene(root, dev, f"obj{i}_train", n_frames, turn=0.0, colour=colour))
        tests.append(load_dataset(write_scene(root, dev, f"obj{i}_test", N_TEST_FRAMES, turn=0.5, colour=colour)))
    datasets = [load_dataset(j) for j in trains]
    row_gather.launches = 0
    row_scatter_add.launches = 0
    frames_to_u8.launches = 0
    sync()
    t0 = time.perf_counter()
    params, losses = batch_mod.train_batch(datasets, cfg, seed=0, device=dev)
    sync()
    wall = time.perf_counter() - t0
    launched = (row_gather.launches, row_scatter_add.launches)
    gather["launches_batched"], scatter["launches_batched"] = launched
    frames["launches_batched"] = frames_to_u8.launches
    want = expected_train_launches(cfg)
    log(f"train_batch: {wall:.2f} s for {k} objects, params "
        + ", ".join(f"{name} {tuple(v.shape)}" for name, v in params.items()))
    log(f"launches in train_batch: row_gather {launched[0]}, row_scatter_add {launched[1]} "
        f"(predicted {want[0]} + {want[1]} for all {k} objects, as for one), frames_to_u8 "
        f"{frames['launches_batched']} (need {k}: one an object)")
    if launched != want or frames["launches_batched"] != k:
        raise SystemExit("the batched launch counts are not the ones the code predicts")
    if losses.shape != (cfg.n_steps, k) or not np.isfinite(losses).all():
        raise SystemExit(f"batched losses are missing or not finite: {losses.shape}")
    for i in range(k):
        first, last = float(losses[:20, i].mean()), float(losses[-100:, i].mean())
        metrics = eval_nerf(batch_mod.slice_params(params, i), tests[i], cfg)
        base = black_psnr(tests[i])
        log(f"object {i} ({BATCH_FRAMES[i]} frames): loss first 20 {first:.6f}, last 100 {last:.6f} "
            f"(ratio {last / first:.4f}, need <= {LOSS_DROP}); eval PSNR {metrics['PSNR']:.3f} dB, SSIM "
            f"{metrics['SSIM']:.4f}, black {base:.3f} dB (need >= {PSNR_MARGIN_DB} dB above)")
        if not last <= LOSS_DROP * first:
            raise SystemExit(f"batched object {i} did not bring its loss down")
        if not (math.isfinite(metrics["PSNR"]) and metrics["PSNR"] >= base + PSNR_MARGIN_DB):
            raise SystemExit(f"batched object {i} does not beat a black frame by the margin")

    obj = batch_mod.upload_objects(datasets, cfg, dev)
    steppers = {"single": make_stepper(batch_mod.slice_params(params, 1), cfg, source, seed=7),
                "batched": batched_stepper(params, cfg, obj, seed=7)}
    times = {"single": [], "batched": []}
    for name in ("single", "batched", "single", "batched"):
        times[name].append(step_ms(steppers[name], 50))
    single, batched = min(times["single"]), min(times["batched"])
    log(f"tight ms/step in turns (host clock, {card}): one object {times['single'][0]:.4f} / "
        f"{times['single'][1]:.4f}, {k} objects {times['batched'][0]:.4f} / {times['batched'][1]:.4f}; "
        f"object-steps/s {k * 1e3 / batched:.1f} batched against {1e3 / single:.1f} one at a time "
        f"({k * single / batched:.2f}x); phase 5's one-object tight step {single_ms:.4f} ms")
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            steppers["batched"]()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("3 tight batched steps under torch.cuda.set_sync_debug_mode('error'): no host sync")
    profile_device(steppers["batched"], f"one tight batched step (K={k})", batched * 1e-3)
    del steppers
    return params, cfg, obj, datasets


def batched_loss_and_grads(params, batch, jitter, cfg):
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    losses = batch_mod.batch_loss(p, batch, jitter, cfg)
    losses.sum().backward()
    return losses.detach().cpu(), {k: v.grad for k, v in p.items()}


def offset_dropped(rows: int):
    """A broken gather for K stacked grids: every object reads object 0's rows."""
    def gather_fn(table, idx):
        return row_gather(table, (idx % rows).contiguous())
    return gather_fn


def batched_vs_single(params, cfg: NerfConfig, batch, jitter, k: int, n: int) -> tuple:
    """Per object, (single step's loss and gradients, (batched vs single
    relative loss difference, worst gradient difference over its max)) of
    one batched step against each object's single step on its own rays."""
    g0, s0 = row_gather.launches, row_scatter_add.launches
    losses, grads = batched_loss_and_grads(params, batch, jitter, cfg)
    if (row_gather.launches - g0, row_scatter_add.launches - s0) != (2, 1):
        raise SystemExit(f"a tight batched step must launch row_gather twice and row_scatter_add once for all {k}")
    out = []
    for i in range(k):
        rays = slice(i * n, (i + 1) * n)
        one = loss_and_grads(batch_mod.slice_params(params, i), tuple(t[rays] for t in batch), jitter[rays], cfg)
        out.append((one, step_disagreement(one, (float(losses[i]), {name: v[i] for name, v in grads.items()}))))
    return out


def phase_batch_step(dev, params, cfg: NerfConfig, obj):
    k, n = obj.k, cfg.train_rays
    log(f"== phase 11b: one batched step through the kernels against {k} single-object steps on the same rays")
    g = torch.Generator(device=dev).manual_seed(13)
    batch = batch_mod.sample_objects(g, obj, n)
    jitter = torch.rand((k * n, cfg.n_samples), generator=g, device=dev)
    # held at f64 compute: a batched product and one object's product sum
    # their 65,536-sample weight gradients in other orders (other GEMM
    # kernels), which moved a gradient by up to 6.7e-6 of its max in f32 and
    # 6.7e-3 in bf16 on an H100 80GB HBM3 at 700 W (both logged below); in
    # f64 that is ~1e-16, and what is left is the kernels' and the object
    # offsets' doing (measured 1.2e-8 to 5.5e-8)
    f64 = dataclasses.replace(cfg, compute_dtype=torch.float64)
    held = batched_vs_single(params, f64, batch, jitter, k, n)
    for i, (one, (d_loss, d_grad)) in enumerate(held):
        log(f"object {i}, f64 products: loss {one[0]:.8f}, batched vs single relative loss diff {d_loss:.3e} "
            f"(need <= {STEP_LOSS_TOL}), worst gradient diff {d_grad:.3e} of its max (need <= {STEP_GRAD_TOL})")
        if not (d_loss <= STEP_LOSS_TOL and d_grad <= STEP_GRAD_TOL):
            raise SystemExit(f"the batched step disagrees with object {i}'s single step")
    for label, c in (("f32", dataclasses.replace(cfg, compute_dtype=torch.float32)), ("the trained bf16", cfg)):
        gaps = batched_vs_single(params, c, batch, jitter, k, n)
        log(f"at {label} products (no limit: the two GEMMs' own rounding): " + "; ".join(
            f"object {i} loss diff {d[0]:.3e}, gradient diff {d[1]:.3e}" for i, (_, d) in enumerate(gaps)))
    rows = cfg.voxel_grid_size ** 3
    saved = voxelfield.row_gather
    voxelfield.row_gather = offset_dropped(rows)
    try:
        bad_losses, bad_grads = batched_loss_and_grads(params, batch, jitter, f64)
    finally:
        voxelfield.row_gather = saved
    worst = max(step_disagreement(held[i][0], (float(bad_losses[i]), {name: v[i] for name, v in bad_grads.items()}))
                for i in range(1, k))
    caught = worst[0] > STEP_LOSS_TOL or worst[1] > STEP_GRAD_TOL
    log(f"  broken on purpose, the object offset dropped (every object reads object 0's rows): worst loss diff "
        f"{worst[0]:.3e}, gradient diff {worst[1]:.3e} over objects 1-{k - 1} -> {'caught' if caught else 'NOT caught'}")
    if not caught:
        raise SystemExit("the batched step tolerances do not catch a dropped object offset")


def phase_batch_hash(dev, datasets, k_hash: dict, k_bwd: dict, card: str):
    cfg = dataclasses.replace(HASH_CFG, n_steps=BATCH_HASH_STEPS)
    k = BATCH_HASH_K
    log(f"== phase 11c: train {k} full-width hash fields together, {cfg.n_steps} steps")
    hash_encode.launches = 0
    hash_encode_backward.launches = 0
    frames_to_u8.launches = 0
    sync()
    t0 = time.perf_counter()
    _, losses = batch_mod.train_batch(datasets[:k], cfg, seed=0, device=dev)
    sync()
    wall = time.perf_counter() - t0
    launched = (hash_encode.launches, hash_encode_backward.launches)
    k_hash["launches_batched"], k_bwd["launches_batched"] = launched
    # one encode (and one table gradient) per object and march: this slice's
    # batched hash step launches K1 and K1b once per object
    want_k1, want_bwd = expected_train_launches(cfg)
    want = (k * want_k1, k * want_bwd)
    log(f"train_batch (hash): {wall:.2f} s ({card}); hash_encode {launched[0]}, hash_encode_backward "
        f"{launched[1]} launches (predicted {want[0]} + {want[1]}: once per object and march), frames_to_u8 "
        f"{frames_to_u8.launches} (need {k})")
    if launched != want or frames_to_u8.launches != k:
        raise SystemExit("the batched hash launch counts are not the ones the code predicts")
    if losses.shape != (cfg.n_steps, k) or not np.isfinite(losses).all():
        raise SystemExit("batched hash losses are missing or not finite")
    for i in range(k):
        first, last = float(losses[:20, i].mean()), float(losses[-20:, i].mean())
        log(f"hash object {i}: mean of the first 20 losses {first:.6f}, of the last 20 {last:.6f} (need lower)")
        if not last < first:
            raise SystemExit(f"batched hash object {i} did not learn")


def robust_labels(curve, max_psnr):
    """(gap, gradient) masks of the labels that any curve within
    FIT_CURVE_TOL of ``curve``, its view-to-view differences within
    FIT_DIFF_TOL, must share with it: the first view that meets each
    threshold meets it by more than the tolerance, and every earlier view
    misses it by more."""
    def robust(margins, tol):
        hit = margins > 0
        first = np.where(hit.any(axis=1), hit.argmax(axis=1), margins.shape[1])
        return np.array([bool((row[:j] < -tol).all() and (j == len(row) or row[j] > tol))
                         for row, j in zip(margins, first)])
    gap = robust(curve[None, :] - np.outer(1.0 - 0.01 * np.arange(labels_mod.N_GAPS), [max_psnr]), FIT_CURVE_TOL)
    ts = 0.01 * (np.arange(labels_mod.N_GRADIENTS) + 1)
    grad = robust(ts[:, None] - np.diff(curve)[None, :], FIT_DIFF_TOL)
    return gap, grad


def synthetic_curves(seed: int = 0) -> tuple:
    """FIT_B noisy lognormal-CDF PSNR curves on FIT_X, their 100-view tops
    and the noiseless truth as a function of the view counts."""
    rng = np.random.default_rng(seed)
    y0, a = rng.uniform(8, 15, FIT_B), rng.uniform(10, 25, FIT_B)
    mu, sg = np.log(rng.uniform(6, 30, FIT_B)), rng.uniform(0.4, 1.3, FIT_B)
    erf = np.vectorize(math.erf)

    def truth(x):
        return y0[:, None] + a[:, None] * 0.5 * (1.0 + erf((np.log(x)[None] - mu[:, None]) / sg[:, None] / math.sqrt(2)))

    ys = truth(FIT_X.astype(np.float64)) + rng.normal(0, FIT_NOISE, (FIT_B, len(FIT_X)))
    tops = truth(np.array([100.0]))[:, 0] + rng.uniform(-0.2, 0.8, FIT_B)
    return ys, tops, truth


def phase_labeling(dev, card: str):
    log(f"== phase 11d: labeling, {FIT_B} PSNR curves on {len(FIT_X)} view counts fit on the card and on the CPU")
    ys, tops, truth = synthetic_curves()
    fit_batch(FIT_X, ys[:8], device=dev)  # warm up
    sync()
    t0 = time.perf_counter()
    res = fit_batch(FIT_X, ys, device=dev)
    sync()
    t_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = fit_objects(FIT_X, ys, tops, device=dev)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = fit_objects(FIT_X, ys, tops, device="cpu")
    t_cpu = time.perf_counter() - t0
    curves_g = np.stack([r.curve for r in got]).astype(np.float64)
    curves_w = np.stack([r.curve for r in want]).astype(np.float64)
    d_curve = float(np.abs(curves_g - curves_w).max())
    d_diff = float(np.abs(np.diff(curves_g, axis=1) - np.diff(curves_w, axis=1)).max())
    same_conv = [g.converged for g in got] == [w.converged for w in want]
    compared = differ = 0
    for g, w, m in zip(got, want, tops):
        gap, grad = robust_labels(w.curve.astype(np.float64), m)
        differ += int((g.gap_labels[gap] != w.gap_labels[gap]).sum() + (g.gradient_labels[grad] != w.gradient_labels[grad]).sum())
        compared += int(gap.sum() + grad.sum())
    all_differ = sum(int((g.gap_labels != w.gap_labels).sum() + (g.gradient_labels != w.gradient_labels).sum())
                     for g, w in zip(got, want))
    off_truth = float(np.abs(curves_g - truth(labels_mod.X_EVAL.astype(np.float64))).mean())
    log(f"fit_batch of {FIT_B} curves on the card: {t_fit:.4f} s; fit_objects (fit + labels) {t_card:.3f} s on the "
        f"card, {t_cpu:.3f} s on the CPU ({card}); {int(res.converged.sum())} converged")
    log(f"card vs CPU: curves within {d_curve:.3e} dB (need <= {FIT_CURVE_TOL}), differences within {d_diff:.3e} "
        f"(need <= {FIT_DIFF_TOL}), converged flags {'equal' if same_conv else 'DIFFER'}; {compared} of "
        f"{FIT_B * 31} labels away from a threshold, {differ} of them differ (need 0), {all_differ} differ in all; "
        f"mean |card curve - the noiseless truth| {off_truth:.4f} dB")
    if not (d_curve <= FIT_CURVE_TOL and d_diff <= FIT_DIFF_TOL and same_conv and differ == 0):
        raise SystemExit("the card's labeling disagrees with the CPU's")
    if int(res.converged.sum()) < 0.9 * FIT_B or compared < 0.5 * FIT_B * 31:
        raise SystemExit("too few fits converged or too few labels compared")


def phase_planning(dev, root: str, card: str):
    log(f"== phase 11e: path planning, precompute_paths for {PLAN_SIZES.start}..{PLAN_SIZES.stop - 1} views")
    vs_dir = os.path.join(root, "hemisphere")
    sync()
    t0 = time.perf_counter()
    for n in PLAN_SIZES:
        save_view_space(vs_dir, generate_hemisphere(n, seed=n, restarts=2, steps=200, device=dev))
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    precompute_paths(vs_dir, PLAN_SIZES, device=dev)
    t_plan = time.perf_counter() - t0
    for n in PLAN_SIZES:
        views, order = load_view_space(vs_dir, n), load_path_order(vs_dir, n)
        top = int(np.argmin(np.linalg.norm(views - np.array([0.0, 0.0, 1.0]), axis=1)))
        if sorted(order.tolist()) != list(range(n)) or int(order[0]) != top:
            raise SystemExit(f"{n}_path.txt is not a visit order from the top view")
    log(f"generate_hemisphere x {len(PLAN_SIZES)}: {t_gen:.2f} s; precompute_paths: {t_plan:.2f} s ({card}); "
        f"every N_path.txt a permutation from the top view")
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(60, 3))
    pts = pts / np.linalg.norm(pts, axis=1, keepdims=True) * rng.uniform(0.8, 2.5, size=(60, 1))
    n_max = max(PLAN_SIZES)
    cases = ((f"{n_max}-view hemisphere", load_view_space(vs_dir, n_max), np.zeros(3) + 1e-10, 0.5),
             ("60 points about a unit sphere, some inside", pts, np.array([0.0, 0.0, 0.05]), 1.0))
    for label, views, center, r in cases:
        got = pairwise_lengths(views, center, r, device=dev).cpu().numpy().astype(np.float64)
        n = len(views)
        ref = [[local_path(views[i], views[j], center, r) for j in range(n)] for i in range(n)]
        modes = np.array([[m for m, _ in row] for row in ref])
        lengths = np.array([[v for _, v in row] for row in ref])
        off = ~np.eye(n, dtype=bool)
        wrong = modes == WRONG_PATH
        ok = off & ~wrong
        rel = float((np.abs(got - lengths)[ok] / lengths[ok]).max())
        kinds = {int(m) for m in modes[off].ravel()}
        log(f"pairwise_lengths on the card, {label}: {int(wrong.sum())} wrong, {int((modes[ok] == CIRCLE_PATH).sum())} "
            f"detour and {int((modes[ok] == LINE_PATH).sum())} line paths; worst relative gap to the float64 scalar "
            f"{rel:.3e} (need <= {PLAN_RTOL})")
        if rel > PLAN_RTOL or not (got[wrong] == 1e10).all() or not (got[ok] < 1e10).all() or CIRCLE_PATH not in kinds:
            raise SystemExit(f"the card's edge matrix disagrees with the scalar local path ({label})")


def phase_batch(dev, root: str, source: BatchSource, k_gather: dict, k_scatter: dict, k_frames: dict, k_hash: dict,
                k_bwd: dict, single_ms: float, card: str):
    t_phase = time.perf_counter()
    params, cfg, obj, datasets = phase_batch_train(dev, root, k_gather, k_scatter, k_frames, source, single_ms, card)
    phase_batch_step(dev, params, cfg, obj)
    del params, obj
    phase_batch_hash(dev, datasets, k_hash, k_bwd, card)
    del datasets
    phase_labeling(dev, card)
    phase_planning(dev, root, card)
    log(f"phase 11 took {time.perf_counter() - t_phase:.1f} s")


# --- phase 12: the PRV experiment: PRVNet serves a budget, mode 21 plans, captures and trains -----

PRV_ARCH = "convnextv2_tiny"
PRV_SEED = 0
PRV_CASE = tuple(IMG_PATTERN[2])  # the init views the budget is predicted from
# card against CPU, cuDNN's convolutions in full float32 on the card: the
# encoder's 1000 features relative to their largest, and the logit
PRV_FEATURE_RTOL = 1e-4
PRV_LOGIT_ATOL = 1e-4
# TF32 convolutions against full float32 on the card: logged, not held
MODE21_PSNR_MARGIN_DB = 15.0  # phase 5's margin over an all-black frame
NBV_ITERATIONS = 1  # 12c: methods 0-3 at a cut depth (cut from 2 to leave phase 13 room)
NBV_STEPS = 300
NBV_TEST_ID = 1  # no method-4 budget file for it: num_of_max_iteration applies


def count_macs(model: torch.nn.Module, x: torch.Tensor) -> int:
    """Multiply-adds of the convolutions and linear layers in one forward."""
    macs = [0]

    def hook(m, inp, out):
        if isinstance(m, torch.nn.Conv2d):
            macs[0] += out.numel() * (m.in_channels // m.groups) * m.kernel_size[0] * m.kernel_size[1]
        else:
            macs[0] += out.numel() * m.in_features

    hooks = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return macs[0]


def forward(pred: BudgetPredictor, x: torch.Tensor, tf32: bool, encoder_only: bool = False) -> torch.Tensor:
    """The predictor's model (or its encoder) on the device tensor ``x`` with
    cuDNN's convolutions in TF32 or in full f32, scoped to this call."""
    b = torch.backends.cudnn
    with torch.no_grad(), b.flags(enabled=b.enabled, benchmark=b.benchmark, deterministic=b.deterministic,
                                  allow_tf32=tf32):
        return (pred.model.encoder if encoder_only else pred.model)(x)


def encoder_features(pred: BudgetPredictor, views: np.ndarray, tf32: bool = False) -> torch.Tensor:
    """The encoder's (K, 1000) features, its convolutions in TF32 or f32."""
    x = torch.as_tensor(views, device=pred.device).permute(0, 3, 1, 2)
    return forward(pred, x, tf32, encoder_only=True).float().cpu()


def phase_prvnet(dev, root: str, card: str) -> tuple:
    log(f"== phase 12a: PRVNet ({PRV_ARCH}, seeded random weights) predicts a view budget from views "
        f"{list(PRV_CASE)} of the 5-view coverage set")
    cfg, _, _ = coverage_config(root)  # phase 10's object: size.txt is there, no size test runs
    scene = load_object(cfg, device=dev)
    get_coverage(scene, cfg, 5, device=dev)
    cov_dir = os.path.join(cfg.gt_path, "5")
    torch.manual_seed(PRV_SEED)
    sd = make_pvbnet(PRV_ARCH).state_dict()
    back = prvnet_state_dict_from_flax(prvnet_state_dict_to_flax(sd))
    if set(back) != set(sd) or any(back[k].shape != sd[k].shape or not torch.equal(back[k], sd[k]) for k in sd):
        raise SystemExit("the weights do not come back from the Flax layout key for key")
    log(f"weights through the Flax layout and back: {len(sd)} tensors, "
        f"{sum(v.numel() for v in sd.values())} parameters, keys, shapes and values equal")

    card_pred = BudgetPredictor(params=sd, arch=PRV_ARCH, device=dev)
    cpu_pred = BudgetPredictor(params=sd, arch=PRV_ARCH, device="cpu")
    views = card_pred.coverage_views(cov_dir, PRV_CASE)
    macs = count_macs(cpu_pred.model, torch.as_tensor(views)[None])
    t = time.perf_counter()
    cpu_logit = float(cpu_pred.logits(views)[0])
    cpu_s = time.perf_counter() - t
    cpu_feat = encoder_features(cpu_pred, views)
    card_feat = encoder_features(card_pred, views)
    card_logit = float(card_pred.logits(views)[0])
    feat_err = float((card_feat - cpu_feat).abs().max() / cpu_feat.abs().max())
    card_value = card_pred.predict_value_from_arrays(views)
    cpu_value = cpu_pred.predict_value_from_arrays(views)
    log(f"{len(PRV_CASE)} views {views.shape[1]}x{views.shape[2]}: {macs / 1e9:.2f} GMAC = {2 * macs / 1e9:.1f} GFLOP "
        f"per forward ({macs / len(PRV_CASE) / 1e9:.2f} GMAC a view); the CPU forward {cpu_s:.2f} s")
    log(f"card against CPU, f32 convolutions: features {feat_err:.3e} of their largest (need <= {PRV_FEATURE_RTOL}), "
        f"logit {card_logit:.8f} against {cpu_logit:.8f} (|diff| {abs(card_logit - cpu_logit):.3e}, need <= "
        f"{PRV_LOGIT_ATOL}); continuous budget {card_value:.6f} against {cpu_value:.6f}")
    if not (feat_err <= PRV_FEATURE_RTOL and abs(card_logit - cpu_logit) <= PRV_LOGIT_ATOL):
        raise SystemExit("PRVNet on the card does not agree with the CPU")

    # the predictor's own call is f32; TF32 is timed on its model directly,
    # and both on the same device input, so the two times differ only by it
    x = torch.as_tensor(views, device=dev)[None]
    times = {}
    for tf32 in (False, True):
        name = "tf32" if tf32 else "f32"
        times[name] = time_ms(lambda: forward(card_pred, x, tf32), iters=10)
        logit = float(forward(card_pred, x, tf32)[0])
        feat = encoder_features(card_pred, views, tf32)
        log(f"forward with cuDNN {name} convolutions: {times[name]:.3f} ms (events around 10 calls), logit "
            f"{logit:.8f} (f32 card's {card_logit:.8f}, |diff| {abs(logit - card_logit):.3e}), features "
            f"{float((feat - cpu_feat).abs().max() / cpu_feat.abs().max()):.3e} from the CPU's of their largest")
    log(f"the predictor's logits call (host views copied in): {time_ms(lambda: card_pred.logits(views), iters=10):.3f} ms")
    f32_bound = 2 * macs / F32_OPS_PER_S * 1e3
    tf32_bound = 2 * macs / TF32_OPS_PER_S * 1e3
    log(f"bounds ({card}): {f32_bound:.3f} ms at the f32 peak (67 TFLOP/s outside the tensor cores), "
        f"{tf32_bound:.3f} ms at the TF32 peak (495 TFLOP/s): f32 at {f32_bound / times['f32']:.3f} of its bound, "
        f"TF32 at {tf32_bound / times['tf32']:.3f}")

    t = time.perf_counter()
    budget = card_pred.predict_from_coverage(cov_dir, PRV_CASE)
    sync()
    call_s = time.perf_counter() - t
    gap = abs(card_value - cpu_value)
    frac = card_value - math.floor(card_value)
    log(f"predict_from_coverage: budget {budget} from {card_value:.6f} in {call_s:.3f} s (PNG decode cached by "
        f"the loader after the first read)")
    if not cfg.min_label_value <= budget <= cfg.max_label_value or budget != int(np.round(card_value)):
        raise SystemExit("the budget is not the rounded continuous value in the label range")
    if abs(frac - 0.5) > max(gap, PRV_LOGIT_ATOL * 45 / 4):
        if budget != int(np.round(cpu_value)):
            raise SystemExit("the card's budget is not the CPU's")
        log(f"the budget equals the CPU's ({abs(frac - 0.5):.4f} from a half-integer, the card-CPU gap {gap:.2e})")
    else:
        log(f"the continuous value lies {abs(frac - 0.5):.2e} from a half-integer, inside the card-CPU gap "
            f"{gap:.2e}: the integer budget is not compared")
    profile_device(lambda: card_pred.predict_from_coverage(cov_dir, PRV_CASE),
                   f"one predict_from_coverage ({len(PRV_CASE)} views, f32 convolutions)", call_s, top=12)
    return card_pred, budget


@contextlib.contextmanager
def stage_timers(stages: dict):
    """Host-clock time of mode 21's stages, each ended by a sync: object
    load, each coverage set (its view-space file written first where it is
    missing), predict, TSP, view-space load, train and eval."""
    def wrap(fn, label):
        def timed(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            key = label(*a, **kw) if callable(label) else label
            stages[key] = stages.get(key, 0.0) + time.perf_counter() - t
            return out
        return timed

    # the modes import these two when they run, from their modules
    saved = [(object_setup_mod, "load_object"), (coverage_mod, "get_coverage"), (nbv_mod, "train_nerf"),
             (nbv_mod, "eval_nerf"), (nbv_mod, "_ensure_viewspace"), (GlobalPathPlanner, "solve")]
    old = [getattr(o, n) for o, n in saved]
    object_setup_mod.load_object = wrap(old[0], "object load")
    coverage_mod.get_coverage = wrap(old[1], lambda scene, cfg, n, **kw: f"coverage {n}")
    nbv_mod.train_nerf = wrap(old[2], "train")
    nbv_mod.eval_nerf = wrap(old[3], "eval")
    nbv_mod._ensure_viewspace = wrap(old[4], "budget view space")
    GlobalPathPlanner.solve = wrap(old[5], lambda self: f"TSP over {len(self.view_subset)} views")
    try:
        yield
    finally:
        for (o, n), f in zip(saved, old):
            setattr(o, n, f)


def mode21_config(root: str):
    """Phase 12's pipeline config: phase 10's object, model files and view
    spaces in a workspace of its own, the object's accepted size copied in."""
    import shutil

    cfg10, _, _ = coverage_config(root)
    cfg = cfg10.replace(workspace=os.path.join(root, "prv_ws"), evaluate=True)
    os.makedirs(cfg.gt_path, exist_ok=True)
    shutil.copy(os.path.join(cfg10.gt_path, "size.txt"), cfg.gt_path)
    return cfg


def check_mode21_frames(renders: list, dev, where: str = "mode 21") -> None:
    """K8's frames of every coverage set mode 21 (or ``where``) rendered
    (first, middle and last of each launch, kept from the launch's own
    output) bit-equal to ``splat_plain`` on the same points, colours and
    poses: frames are independent, so these few plain frames hold the
    F = 540 launch."""
    for points, colors, c2w, intr, ps, n, keep, got in renders:
        pts = _points(points, dev)
        want = splat_plain(pts, _colors01(colors, len(pts), dev), _world_to_camera(c2w).to(dev), intr,
                           int(ps) if ps else 5)
        same = torch.equal(got, want)
        log(f"K8 in {where}, the {n}-frame launch: frames {keep} "
            f"{'bit-equal' if same else 'DIFFERENT'} to splat_plain")
        if not same:
            raise SystemExit(f"K8's {n}-frame launch in {where} disagrees with splat_plain: "
                             f"{int((got != want).any(-1).sum())} pixels differ")


def drive_mode21(call, record_frames: bool) -> tuple:
    """Run ``call()`` (one mode-21 run) with every wrapper's launch count set
    to 0 just before, the stages timed (``stage_timers``), each
    ``eval_nerf`` recorded with its gathers and, with ``record_frames``, the
    first, middle and last frame of each K8 coverage launch kept.  Returns
    (call's result, launches, evals, renders, stages, wall)."""
    wrappers = (hash_encode, hash_encode_backward, row_gather, row_scatter_add, splat, voxel_cast)
    evals = []
    real_eval = nbv_mod.eval_nerf

    def recording_eval(params, test_json, ncfg=None):
        before = row_gather.launches
        out = real_eval(params, test_json, ncfg)
        evals.append((params, test_json, ncfg, row_gather.launches - before))
        return out

    renders = []
    real_render = coverage_mod.render_pointcloud_views

    def recording_render(points, colors, c2ws, intr, point_size=None, device="cuda"):
        out = real_render(points, colors, c2ws, intr, point_size=point_size, device=device)
        if record_frames:
            keep = sorted({0, len(c2ws) // 2, len(c2ws) - 1})
            renders.append((points, colors, np.asarray(c2ws)[keep], intr, point_size, len(c2ws), keep, out[keep]))
        return out

    stages = {}
    nbv_mod.eval_nerf = recording_eval
    coverage_mod.render_pointcloud_views = recording_render
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    try:
        with stage_timers(stages):
            out = call()
    finally:
        nbv_mod.eval_nerf = real_eval
        coverage_mod.render_pointcloud_views = real_render
    sync()
    wall = time.perf_counter() - t0
    return out, {w.__name__: w.launches for w in wrappers}, evals, renders, stages, wall


def check_mode21(dev, cfg, path: str, budget: int, launched: dict, evals: list, renders, k8: int,
                 nerf_cfg: NerfConfig) -> float:
    """Mode 21 method 4's artifacts in ``path``: the planned budget as a path
    through every view from the top, the launches the code predicts (K8
    ``k8``, one per coverage set rendered; K9 none, as no ``precept`` runs on
    this path; the training's gathers and scatter-adds from the config; the
    eval's gathers from the render's chunking of this run's level-1
    survivors, ``expected_eval_gathers``), the eval's gathers again on a
    re-run, the kept K8 frames (``renders``, where given) bit-equal to
    ``splat_plain``, and the PSNR's margin over black.  Returns the PSNR."""
    got_budget = int(open(os.path.join(path, "view_budget.txt")).read())
    moves = sorted(int(f[:-4]) for f in os.listdir(os.path.join(path, "movement")) if f[0].isdigit())
    ids = [int(open(os.path.join(path, "movement", f"{i}.txt")).read().split()[0]) for i in moves]
    vs = ViewSpace(load_view_space(cfg.viewspace_path, budget), load_object(cfg, device=dev).points,
                   cfg.view_space_radius)
    top = vs.top_view_id()
    order = [top] + ids
    log(f"{path}: view_budget.txt {got_budget}, {len(moves)} moves, path {order}")
    if got_budget != budget or moves != list(range(budget - 1)) or sorted(order) != list(range(budget)):
        raise SystemExit("mode 21 did not plan the predicted budget as a path through every view from the top")

    (params, test_json, ecfg, eval_g), = evals
    want_e, survivors = expected_eval_gathers(params, test_json, ecfg or NerfConfig(), dev)
    want_g, want_s = expected_train_launches(nerf_cfg)
    want = {"hash_encode": 0, "hash_encode_backward": 0, "row_gather": want_g + want_e,
            "row_scatter_add": want_s, "splat": k8, "voxel_cast": 0}
    log(f"predicted launches: {want} (row_gather: train {want_g} + eval {want_e}, 2 a chunk of "
        f"{render_mod._default_chunk(ecfg or NerfConfig())} level-1 survivors, {sum(survivors)} in "
        f"{len(survivors)} groups of 8 frames: {survivors})")
    if launched != want:
        raise SystemExit("mode 21's launch counts are not the ones the code predicts")
    # a second check: the same eval again launches the same gathers
    before = row_gather.launches
    metrics = nbv_mod.eval_nerf(params, test_json, ecfg)
    again_g = row_gather.launches - before
    log(f"the eval again on the same field: {again_g} gathers (in the run {eval_g})")
    if again_g != want_e or eval_g != want_e:
        raise SystemExit("the eval's gathers are not the ones the code predicts")
    if renders is not None:
        check_mode21_frames(renders, dev)

    saved = dict(line.split() for line in open(os.path.join(path, "metrics", f"{budget - 1}.txt")).read().splitlines())
    base = black_psnr(load_dataset(test_json))
    psnr = float(saved["PSNR"])
    log(f"final eval on the 100-view set: PSNR {psnr:.3f} dB, SSIM {float(saved['SSIM']):.4f} (again: "
        f"{metrics['PSNR']:.3f} dB); an all-black frame scores {base:.3f} dB (need >= {MODE21_PSNR_MARGIN_DB} dB above)")
    if not (math.isfinite(psnr) and psnr >= base + MODE21_PSNR_MARGIN_DB):
        raise SystemExit("mode 21's field does not beat a black frame by the margin")
    return psnr


def phase_mode21(dev, root: str, pred: BudgetPredictor, budget: int, card: str) -> dict:
    cfg = mode21_config(root)
    nerf_cfg = NerfConfig(n_steps=cfg.n_steps)
    log(f"== phase 12b: mode 21, method 4 (PVBCoverage): a {cfg.num_of_views}-view space, 5 init views, case "
        f"{list(PRV_CASE)}, budget {budget}, the default voxel field {nerf_cfg.n_steps} steps, eval on 100 views")
    paths, launched, evals, renders, stages, wall = drive_mode21(
        lambda: modes_mod.mode_view_planning(cfg, [cfg.name_of_pcd], method_ids=(4,), init_view_cases=(PRV_CASE,),
                                             predictor=pred, coverage_sizes=[5, budget, 100], device=dev),
        record_frames=True)
    log(f"mode 21 method 4: {wall:.2f} s; stages (host clock, each ended by a sync): " + ", ".join(
        f"{k} {v:.2f} s" for k, v in stages.items()))
    log("launches: " + ", ".join(f"{k} {v}" for k, v in launched.items()))
    # K8: one launch per coverage set (540, 5, the budget's, 100; the size
    # test does not run, size.txt is there)
    check_mode21(dev, cfg, paths[0], budget, launched, evals, renders, 4, nerf_cfg)
    return launched


def numpy_choices(method: int, first: int, n_views: int, n_iter: int, seed: int, views=None, scene=None) -> list:
    """Methods 0 and 1's choices drawn on the host as the reference draws
    them (method 1's best-of-50 set ordered by the TSP on the CPU)."""
    rng = np.random.default_rng(seed)
    if method == 0:
        chosen, seq = {first}, []
        for _ in range(n_iter):
            nxt = int(rng.integers(n_views))
            while nxt in chosen:
                nxt = int(rng.integers(n_views))
            chosen.add(nxt)
            seq.append(nxt)
        return seq
    best_set, best_dis = None, -np.inf
    for _ in range(50):
        ids = {first}
        while len(ids) < n_iter + 1:
            ids.add(int(rng.integers(n_views)))
        pts = views[sorted(ids)]
        dis = np.triu(np.linalg.norm(pts[:, None] - pts[None, :], axis=-1), 1).sum()
        if dis > best_dis:
            best_dis, best_set = dis, sorted(ids)
    planner = GlobalPathPlanner(views, best_set, scene.view_space.object_center, scene.view_space.predicted_size,
                                first, device="cpu")
    planner.solve()
    return planner.get_path_id_set()[1:]


def phase_nbv_methods(dev, root: str, card: str) -> None:
    cfg = mode21_config(root).replace(num_of_max_iteration=NBV_ITERATIONS, n_steps=NBV_STEPS, evaluate=False)
    log(f"== phase 12c: methods 0-3 on the {cfg.num_of_views}-view space, test id {NBV_TEST_ID}: "
        f"{NBV_ITERATIONS} iterations, {NBV_STEPS}-step NeRFs")
    scene = load_object(cfg, device=dev)
    init_vs = ViewSpace(_ensure_viewspace(cfg.viewspace_path, 5, dev), scene.points, cfg.view_space_radius)
    first = scene.view_space.top_view_id()
    n_views = len(scene.view_space)
    for method in (0, 1, 2, 3):
        mcfg = cfg.replace(method_of_IG=method)
        runner = NBVRunner(mcfg, scene, device=dev)
        runner.init_views = init_vs.views
        row_gather.launches = row_scatter_add.launches = 0
        t = time.perf_counter()
        path = runner.nbv_loop(first, list(PRV_CASE), test_id=NBV_TEST_ID)
        sync()
        dt = time.perf_counter() - t
        moves = sorted(int(f[:-4]) for f in os.listdir(os.path.join(path, "movement")) if f[0].isdigit())
        ids = [int(open(os.path.join(path, "movement", f"{i}.txt")).read().split()[0]) for i in moves]
        jsons = sorted(os.listdir(os.path.join(path, "json")))
        log(f"method {method} ({nbv_mod.METHOD_NAMES[method]}): {dt:.2f} s, chose {ids}; {row_gather.launches} "
            f"gathers, {row_scatter_add.launches} scatter-adds")
        ok = (path.endswith(f"_m{method}_v{len(PRV_CASE)}_t{NBV_TEST_ID}") and moves == list(range(NBV_ITERATIONS))
              and len(set(ids) | {first}) == NBV_ITERATIONS + 1
              and jsons == [f"{i}.json" for i in range(NBV_ITERATIONS + 1)]
              and os.path.exists(os.path.join(path, "run_time.txt")))
        if not ok:
            raise SystemExit(f"method {method}'s artifacts are not the reference's")
        if method in (0, 1):
            want = numpy_choices(method, first, n_views, NBV_ITERATIONS, cfg.seed, scene.view_space.views, scene)
            if ids != list(want):
                raise SystemExit(f"method {method} chose {ids}, the numpy draws {want}")
        else:
            members = cfg.replace(method_of_IG=method).ensemble_num_for_method
            for it in range(NBV_ITERATIONS):
                for e in range(members):
                    shots = os.listdir(os.path.join(path, "render", str(it), f"ensemble_{e}"))
                    if len(shots) != n_views - 1 - it:
                        raise SystemExit(f"method {method}: {len(shots)} screenshots, expected {n_views - 1 - it}")
            steps = expected_train_launches(runner.nerf_cfg)[1]
            if row_scatter_add.launches != NBV_ITERATIONS * members * steps:
                raise SystemExit(f"method {method} trained {row_scatter_add.launches // steps} NeRFs, expected "
                                 f"{NBV_ITERATIONS * members}")


def phase_prv(dev, root: str, kernels: list, card: str) -> None:
    t_phase = time.perf_counter()
    pred, budget = phase_prvnet(dev, root, card)
    launched = phase_mode21(dev, root, pred, budget, card)
    for k in kernels:
        k["launches_mode21"] = launched[k["name"]]
    del pred
    phase_nbv_methods(dev, root, card)
    log(f"phase 12 took {time.perf_counter() - t_phase:.1f} s")


# --- phase 13: PRVNet training at full width: rendered dataset, pretrain, train, checkpoint, mode 21 -----

TRAIN_CELLS = 4  # (category, label) cells of the split; cut from 8 to leave phase 18 room
TRAIN_PER_CELL = 3  # the holdout split sends two of a cell to train and one to val: 8 + 4 objects
TRAIN_VIEWS = 64  # each object's coverage set: the pretrain dataset's view space
TRAIN_SIZE = 720  # the crop PRVNet trains on (TrainConfig.image_size)
PRETRAIN_OBJECTS = 4  # 4 x 64 = 256 single-view samples, 4 applications at the reference's batch of 64
PRETRAIN_BATCH = 64
REG_BATCH = 8  # cut from the reference's 64 (16 until phase 18 came); the micro-batch is the full configuration's
REG_EPOCHS = 2
MICRO_OBJECTS = (2, 4, 8)  # regression micro-batches whose peak memory is measured
MICRO_MEM_LIMIT = 70e9  # bytes: the largest measured micro-batch under this is trained with
# one streaming epoch against one resident epoch from the same weights and rng:
# the epoch's loss (all its micro-steps precede its one application) relative,
# and the val metrics after the application, where Adam's sign for float-noise
# gradients may differ
STREAM_LOSS_RTOL = 1e-4
STREAM_VAL_ATOL = 0.05
# the predictor against the trainer's eval step on the same checkpoint, in
# budget units: other micro-batch compositions, maybe other cuDNN algorithms
SERVE_BUDGET_ATOL = 1e-3
TRAIN_FIELDS = {"epoch", "train_loss", "accuracy", "l1_mean", "l1_std"}
# 13e's coverage sets beside the full space, the 5 init views, the budget's and the 100-view test set: 6 sets
# at most, cut from 5..60 (58 sets took 134 s of K8 and PNG encoding on an H100; 10 until phase 18 came)
PRV_TRAIN_COVERAGE = (20, 44)


def prv_train_labels(dev) -> tuple:
    """Labels for the TRAIN_CELLS x TRAIN_PER_CELL objects from phase 11d's
    synthetic curves (another seed), fit on the card: TRAIN_CELLS labels that
    TRAIN_PER_CELL usable curves share, spread over the range.  Returns (each
    object's LabelResult, in cell order, and the cells' labels)."""
    ys, tops, _ = synthetic_curves(seed=1)
    results = fit_objects(FIT_X, ys, tops, device=dev)
    by_label = {}
    for i, label in select_labels([str(i) for i in range(FIT_B)], results).items():
        by_label.setdefault(label, []).append(int(i))
    shared = sorted(label for label, ids in by_label.items() if len(ids) >= TRAIN_PER_CELL)
    if len(shared) < TRAIN_CELLS:
        raise SystemExit(f"only {len(shared)} labels have {TRAIN_PER_CELL} usable curves")
    picked = [shared[round(i * (len(shared) - 1) / (TRAIN_CELLS - 1))] for i in range(TRAIN_CELLS)]
    return [results[by_label[label][j]] for label in picked for j in range(TRAIN_PER_CELL)], picked


def render_train_objects(dev, ws: str, vs_dir: str, names: list) -> tuple:
    """Each object a seeded variant of phase 10's OBJ, sampled to a PLY (on
    four host threads, ahead of the card), loaded with the size test and
    rendered as its TRAIN_VIEWS-view coverage set, as mode 3 does.  Returns
    (size-test launches, the first object's K8 frames kept, stage walls)."""
    from concurrent.futures import ThreadPoolExecutor

    def cfg_of(i):
        return Config(workspace=ws, model_path=os.path.join(ws, "models"), viewspace_path=vs_dir,
                      name_of_pcd=names[i], is_shape_net=True, camera=CAMERA, seed=i)

    def sample(i):
        obj = os.path.join(ws, "mesh", names[i], "model_normalized.obj")
        write_procedural_obj(obj, seed=i + 1)
        ply = os.path.join(cfg_of(i).model_path, "ShapeNet", names[i] + ".ply")
        t = time.perf_counter()
        if not sample_and_voxelize(obj, ply, n_points=OBJ_POINTS, grid_resolution=OBJ_GRID):
            raise SystemExit(f"sample_and_voxelize wrote nothing for {names[i]}")
        return time.perf_counter() - t

    tries = [0]
    real_rate = object_setup_mod._size_test_rate
    renders = []
    real_render = coverage_mod.render_pointcloud_views

    def counting_rate(*a, **kw):
        tries[0] += 1
        return real_rate(*a, **kw)

    def recording_render(points, colors, c2ws, intr, point_size=None, device="cuda"):
        out = real_render(points, colors, c2ws, intr, point_size=point_size, device=device)
        if not renders:
            keep = sorted({0, len(c2ws) // 2, len(c2ws) - 1})
            renders.append((points, colors, np.asarray(c2ws)[keep], intr, point_size, len(c2ws), keep, out[keep]))
        return out

    walls = {"sample (host threads)": 0.0, "load_object": 0.0, "get_coverage": 0.0}
    object_setup_mod._size_test_rate = counting_rate
    coverage_mod.render_pointcloud_views = recording_render
    try:
        with ThreadPoolExecutor(max_workers=4) as pool:
            futures = [pool.submit(sample, i) for i in range(len(names))]
            for i, fut in enumerate(futures):
                walls["sample (host threads)"] += fut.result()
                t = time.perf_counter()
                scene = load_object(cfg_of(i), device=dev)
                sync()
                walls["load_object"] += time.perf_counter() - t
                if not scene.ok:
                    raise SystemExit(f"{names[i]} failed the size test")
                t = time.perf_counter()
                get_coverage(scene, cfg_of(i), TRAIN_VIEWS, device=dev)
                walls["get_coverage"] += time.perf_counter() - t
    finally:
        object_setup_mod._size_test_rate = real_rate
        coverage_mod.render_pointcloud_views = real_render
    return tries[0], renders, walls


def micro_batch_peak(dev, mesh, objects: int) -> int:
    """torch.cuda.max_memory_allocated over one regression application of
    ``objects`` objects x 5 views at 720x720 (a fresh tiny PVBNet, its AdamW
    state included)."""
    model = prv_train_mod.init_model(TrainConfig(arch=PRV_ARCH), 5).to(dev)
    step = prv_train_mod.make_train_step(model, TrainConfig(arch=PRV_ARCH, batch_size=objects), mesh=mesh)
    views = torch.rand((objects, 5, TRAIN_SIZE, TRAIN_SIZE, 3), device=dev)
    labels = torch.full((objects,), 30.0, device=dev)
    sync()
    torch.cuda.reset_peak_memory_stats()
    step(views, labels)
    sync()
    return torch.cuda.max_memory_allocated()


def time_applications(dev, mesh, model, cfg: TrainConfig, n_views, card: str, label: str, apps: int = 2) -> tuple:
    """Host-clock time of one optimizer application (``accum_steps``
    micro-steps on uint8 views resident on the card, divided there, as the
    resident trainer feeds them), ended by a sync, after one warm-up
    application; images/s; the f32 bound from the model's counted MACs
    (training about 3x the forward); the device's busy share of one
    profiled application."""
    step = prv_train_mod.make_train_step(model, cfg, mesh=mesh)
    shape = (cfg.micro_batch,) + ((n_views,) if n_views else ()) + (cfg.image_size, cfg.image_size, 3)
    views = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev)
    labels = torch.full((cfg.micro_batch,), 30.0, device=dev)

    def application():
        for _ in range(cfg.accum_steps):
            step(views.float() / 255.0, labels)

    application()
    sync()
    t = time.perf_counter()
    for _ in range(apps):
        application()
    sync()
    dt = (time.perf_counter() - t) / apps
    images = cfg.batch_size * (n_views or 1)
    macs = count_macs(model, views[:1].float())
    bound = 3 * 2 * macs * cfg.batch_size / F32_OPS_PER_S
    log(f"{label}: one application ({cfg.accum_steps} micro-steps of {cfg.micro_batch} x {n_views or 1} images, "
        f"{images} images) {dt:.3f} s on the host clock = {images / dt:.1f} images/s ({card}); forward "
        f"{macs / (n_views or 1) / 1e9:.2f} GMAC an image, training ~3x: f32 bound {bound:.3f} s "
        f"({bound / images * 1e3:.2f} ms an image at 67 TFLOP/s), the application at {bound / dt:.3f} of it")
    profile_device(application, f"{label}, one application", dt, top=10)
    return dt, images / dt, bound


def prv_train_mode21_config(root: str) -> tuple:
    """Phase 12's workspace for mode 21 through the CLI (phase 10's object,
    its PLY and view spaces; the coverage sets already rendered there are
    kept, as a user's workspace keeps them, and phase 12b's method-4
    experiment is removed so that the CLI plans anew) and the YAML that
    points the CLI there (``evaluate`` on, so the field is scored)."""
    import shutil

    cfg12 = mode21_config(root)
    yaml_path = os.path.join(root, "prv_train_mode21.yaml")
    camera = "".join(f"color_{k}: {getattr(CAMERA, k)}\n" for k in
                     ("width", "height", "fx", "fy", "ppx", "ppy", "model", "k1", "k2", "k3", "p1", "p2"))
    camera += f"depth_scale: {CAMERA.depth_scale}\n"
    with open(yaml_path, "w") as f:
        f.write(f'%YAML:1.0\npre_path: "{cfg12.workspace}"\nmodel_path: "{cfg12.model_path}"\n'
                f'viewspace_path: "{cfg12.viewspace_path}"\nevaluate: 1\n{camera}')
    cfg = Config.from_yaml(yaml_path).replace(name_of_pcd=OBJ_NAME, method_of_IG=4)
    if cfg.camera != CAMERA or cfg.gt_path != cfg12.gt_path:
        raise SystemExit(f"the YAML's config {cfg} is not phase 12's {cfg12}")
    done = f"{cfg.save_path}_v{len(PRV_CASE)}_t0"
    if os.path.exists(done):
        shutil.rmtree(done)
    return cfg, yaml_path


def read_log(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def phase_prv_train(dev, root: str, kernels: list, card: str) -> None:
    from nerf_prv_tpu_torch.pipeline import cli as pipeline_cli

    t_phase = time.perf_counter()
    n_obj = TRAIN_CELLS * TRAIN_PER_CELL
    log(f"== phase 13: PRVNet training at full width: {n_obj} objects rendered through K8, {PRV_ARCH} pretrained "
        f"and trained at {TRAIN_SIZE}x{TRAIN_SIZE} in float32, its checkpoint served and run through mode 21's CLI")
    mesh = make_mesh(devices=[dev])
    ws = os.path.join(root, "prv_train_ws")
    ds_root = os.path.join(ws, "pvb_dataset")
    walls = {}

    # (a) the dataset: labels, objects, coverage sets, pvb_dataset/
    log(f"-- 13a: {n_obj} objects, {TRAIN_VIEWS}-view coverage sets, labels from synthetic curves fit on the card")
    wrappers = (hash_encode, hash_encode_backward, row_gather, row_scatter_add, splat, voxel_cast)
    for w in wrappers:
        w.launches = 0
    t = time.perf_counter()
    results, picked = prv_train_labels(dev)
    walls["labels"] = time.perf_counter() - t
    names = [f"{CATEGORY_PREFIXES[c]}_{j}" for c in range(TRAIN_CELLS) for j in range(TRAIN_PER_CELL)]
    t = time.perf_counter()
    tries, renders, obj_walls = render_train_objects(dev, ws, coverage_config(root)[0].viewspace_path, names)
    walls["objects"] = time.perf_counter() - t
    t = time.perf_counter()
    split = build_dataset(ws, names, results, n_views=TRAIN_VIEWS, split="holdout")
    walls["build_dataset"] = time.perf_counter() - t
    launched_a = {w.__name__: w.launches for w in wrappers}
    log(f"objects: {walls['objects']:.2f} s (" + ", ".join(f"{k} {v:.2f} s" for k, v in obj_walls.items())
        + f"); labels {walls['labels']:.3f} s, cells' labels {picked}; build_dataset {walls['build_dataset']:.2f} s")
    log(f"launches: " + ", ".join(f"{k} {v}" for k, v in launched_a.items()) + f" ({tries} size tries + {n_obj} "
        f"coverage sets)")
    if launched_a != {"hash_encode": 0, "hash_encode_backward": 0, "row_gather": 0, "row_scatter_add": 0,
                      "splat": tries + n_obj, "voxel_cast": 0}:
        raise SystemExit("the dataset's launches are not one K8 launch a size try and a coverage set")
    check_mode21_frames(renders, dev, where=f"the dataset ({names[0]})")
    del renders
    train, val = split["train"], split["val"]
    log(f"split (holdout): {len(train)} train, {len(val)} val; labels {split['labels']}")
    if len(train) != 2 * TRAIN_CELLS or len(val) != TRAIN_CELLS:
        raise SystemExit("the holdout split is not two train and one val object a cell")
    for name in names:
        d = os.path.join(ds_root, name)
        pngs = [f for f in os.listdir(d) if f.startswith("rgbaClip_")]
        if len(pngs) != TRAIN_VIEWS or int(open(os.path.join(d, "view_budget.txt")).read()) != split["labels"][name]:
            raise SystemExit(f"{d} lacks its {TRAIN_VIEWS} views or its label")
    pre_split = os.path.join(ds_root, "pretrain_split.txt")
    with open(pre_split, "w") as f:
        f.write("\n".join(sorted(train)[:PRETRAIN_OBJECTS]) + "\n")
    train_split, val_split = os.path.join(ds_root, "train_split.txt"), os.path.join(ds_root, "val_split.txt")

    # (b) the micro-batch the card holds, timing, pretrain
    log(f"-- 13b: peak memory of one regression application for micro-batches of {list(MICRO_OBJECTS)} objects "
        f"x 5 views at {TRAIN_SIZE}x{TRAIN_SIZE}, f32 ({card}; {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated before)")
    peaks = {}
    total = torch.cuda.get_device_properties(dev).total_memory
    for m in MICRO_OBJECTS:
        if len(peaks) >= 2:
            a, b = sorted(peaks)[-2:]
            guess = peaks[b] + (peaks[b] - peaks[a]) * (m - b) / (b - a)
            if guess > total:
                log(f"  {m} objects ({5 * m} images): not run, the line through {a} and {b} objects gives "
                    f"{guess / 1e9:.1f} GB, more than the card's {total / 1e9:.1f}")
                continue
        try:
            peaks[m] = micro_batch_peak(dev, mesh, m)
            log(f"  {m} objects ({5 * m} images): peak {peaks[m] / 1e9:.2f} GB "
                f"({peaks[m] / (5 * m) / 1e9:.2f} GB an image)")
        except torch.cuda.OutOfMemoryError:
            log(f"  {m} objects ({5 * m} images): out of memory")
        torch.cuda.empty_cache()
    micro = max(m for m, p in peaks.items() if p <= MICRO_MEM_LIMIT)
    pre_micro = max(d for d in range(1, PRETRAIN_BATCH + 1) if PRETRAIN_BATCH % d == 0 and d <= 5 * micro)
    cfg_reg = TrainConfig(arch=PRV_ARCH, image_size=TRAIN_SIZE, batch_size=REG_BATCH, accum_steps=REG_BATCH // micro,
                          epochs=REG_EPOCHS)
    cfg_pre = TrainConfig(arch=PRV_ARCH, image_size=TRAIN_SIZE, batch_size=PRETRAIN_BATCH,
                          accum_steps=PRETRAIN_BATCH // pre_micro, epochs=1)
    log(f"micro-batch: {micro} objects ({5 * micro} images, peak {peaks[micro] / 1e9:.2f} GB <= "
        f"{MICRO_MEM_LIMIT / 1e9:.0f} GB): regression batch {REG_BATCH} = {cfg_reg.accum_steps} x {micro}; "
        f"pretrain batch {PRETRAIN_BATCH} = {cfg_pre.accum_steps} x {pre_micro} images")
    reg_s, reg_ips, reg_bound = time_applications(dev, mesh, prv_train_mod.init_model(cfg_reg, 5).to(dev), cfg_reg, 5,
                                                  card, "regression (PVBNet, 5 views)")
    pre_model = make_pvbpretrain(PRV_ARCH).to(dev)
    pre_s, pre_ips, pre_bound = time_applications(dev, mesh, pre_model, cfg_pre, None, card,
                                                  "pretrain (PVBPretrain, single views)")
    del pre_model
    torch.cuda.empty_cache()

    log(f"pretrain on {PRETRAIN_OBJECTS} train objects x {TRAIN_VIEWS} views, batch {PRETRAIN_BATCH}, 1 epoch")
    pre_dir = os.path.join(root, "prv_pretrain")
    pre_ds = PVBPretrainDataset(ds_root, pre_split, viewspace_size=TRAIN_VIEWS, crop=TRAIN_SIZE)
    if not prv_train_mod._use_resident(cfg_pre, pre_ds, 1, mesh):
        raise SystemExit("the pretrain split does not take the resident path")
    t = time.perf_counter()
    _, pre_best = pretrain(ds_root, pre_split, None, cfg=cfg_pre, checkpoint_dir=pre_dir, mesh=mesh,
                           viewspace_size=TRAIN_VIEWS)
    sync()
    walls["pretrain"] = time.perf_counter() - t
    pre_path = os.path.join(pre_dir, "best_pretrain_checkpoint.msgpack")
    pre_log = read_log(os.path.join(pre_dir, "pretrain_log.jsonl"))
    log(f"pretrain: {walls['pretrain']:.2f} s for {len(pre_ds)} samples, {len(pre_ds) // PRETRAIN_BATCH} "
        f"applications; log {pre_log}")
    if not (os.path.exists(pre_path) and len(pre_log) == 1 and set(pre_log[0]) == TRAIN_FIELDS
            and math.isfinite(pre_log[0]["train_loss"]) and math.isfinite(pre_best["l1_mean"])):
        raise SystemExit("pretrain wrote no checkpoint or no finite log line")
    torch.cuda.empty_cache()

    # (c) train from the pretrained encoder; one streaming against one resident epoch
    log(f"-- 13c: train_regression, {len(train)} train and {len(val)} val objects x 5 views, batch {REG_BATCH}, "
        f"{REG_EPOCHS} epochs, from {os.path.basename(pre_path)}")
    ckpt = os.path.join(root, "prv_train")
    t = time.perf_counter()
    _, best = train_regression(ds_root, train_split, val_split, cfg=cfg_reg, pattern=IMG_PATTERN[4],
                               checkpoint_dir=ckpt, mesh=mesh, premodel_file=pre_path)
    sync()
    walls["train_regression"] = time.perf_counter() - t
    best_path = os.path.join(ckpt, "best_checkpoint.msgpack")
    reg_log = read_log(os.path.join(ckpt, "log.jsonl"))
    log(f"train_regression: {walls['train_regression']:.2f} s; log {reg_log}; best {best}")
    if not (os.path.exists(best_path) and [l["epoch"] for l in reg_log] == list(range(REG_EPOCHS))
            and all(set(l) == TRAIN_FIELDS and math.isfinite(l["train_loss"]) for l in reg_log)):
        raise SystemExit("train_regression wrote no checkpoint or not both epochs' finite log lines")
    torch.cuda.empty_cache()
    epoch = {}
    for resident in (True, False):
        t = time.perf_counter()
        train_regression(ds_root, train_split, val_split,
                         cfg=dataclasses.replace(cfg_reg, epochs=1, device_data=resident), pattern=IMG_PATTERN[4],
                         checkpoint_dir=os.path.join(root, f"prv_epoch_{resident}"), mesh=mesh, premodel_file=pre_path)
        sync()
        epoch[resident] = read_log(os.path.join(root, f"prv_epoch_{resident}", "log.jsonl"))[0]
        log(f"one {'resident' if resident else 'streaming'} epoch: {time.perf_counter() - t:.2f} s, {epoch[resident]}")
        torch.cuda.empty_cache()
    d_loss = abs(epoch[True]["train_loss"] - epoch[False]["train_loss"]) / abs(epoch[False]["train_loss"])
    d_val = max(abs(epoch[True][k] - epoch[False][k]) for k in ("l1_mean", "l1_std"))
    log(f"resident against streaming: train loss {d_loss:.3e} relative (need <= {STREAM_LOSS_RTOL}), val l1 "
        f"{d_val:.3e} (need <= {STREAM_VAL_ATOL})")
    if d_loss > STREAM_LOSS_RTOL or d_val > STREAM_VAL_ATOL:
        raise SystemExit("the resident and the streaming epoch disagree")

    # (d) serve the checkpoint: the predictor against the trainer's eval step, the card against the CPU
    log(f"-- 13d: BudgetPredictor on {os.path.basename(best_path)}, the {len(val)} val objects x 5 views")
    pred = BudgetPredictor(best_path, arch=PRV_ARCH, crop=TRAIN_SIZE, device=dev)
    val_names = read_split(val_split)
    values = np.array([pred.predict_value_from_arrays(pred.coverage_views(os.path.join(ds_root, n), IMG_PATTERN[4]))
                       for n in val_names])
    params, meta = load_checkpoint(best_path)
    trainer_model = prv_train_mod.init_model(cfg_reg, 5)
    trainer_model.load_state_dict(prvnet_state_dict_from_flax(params))
    predict = prv_train_mod.make_eval_step(trainer_model.to(dev), cfg_reg, mesh)
    val_ds = PVBDataset(ds_root, val_split, IMG_PATTERN[4], crop=TRAIN_SIZE)
    want = torch.cat([predict(v).cpu() for v, _ in val_ds.batches(cfg_reg.micro_batch)]).numpy().astype(np.float64)
    labels = np.array([split["labels"][n] for n in val_names], np.float64)
    gap = float(np.abs(values - want).max())
    l1 = float(np.abs(values - labels).mean())
    log(f"predictor {np.round(values, 4).tolist()} against the trainer's eval step {np.round(want, 4).tolist()}: "
        f"worst {gap:.3e} (need <= {SERVE_BUDGET_ATOL}); l1 {l1:.4f} against the checkpoint's val l1 "
        f"{meta['val']['l1_mean']:.4f} (epoch {meta['epoch']})")
    if gap > SERVE_BUDGET_ATOL or abs(l1 - meta["val"]["l1_mean"]) > SERVE_BUDGET_ATOL:
        raise SystemExit("the predictor does not serve what the trainer evaluated")
    del trainer_model, predict
    cpu_pred = BudgetPredictor(best_path, arch=PRV_ARCH, crop=TRAIN_SIZE, device="cpu")
    views = pred.coverage_views(os.path.join(ds_root, val_names[0]), IMG_PATTERN[4])
    cpu_feat, card_feat = encoder_features(cpu_pred, views), encoder_features(pred, views)
    feat_err = float((card_feat - cpu_feat).abs().max() / cpu_feat.abs().max())
    cpu_logit, card_logit = float(cpu_pred.logits(views)[0]), float(pred.logits(views)[0])
    log(f"card against CPU on {val_names[0]}: features {feat_err:.3e} of their largest (need <= {PRV_FEATURE_RTOL}), "
        f"logit {card_logit:.8f} against {cpu_logit:.8f} (need <= {PRV_LOGIT_ATOL} apart)")
    if feat_err > PRV_FEATURE_RTOL or abs(card_logit - cpu_logit) > PRV_LOGIT_ATOL:
        raise SystemExit("the trained checkpoint on the card does not agree with the CPU")
    del cpu_pred
    del pred
    # phase 12's object, as the pipeline's predictor reads it (its default crop)
    pred = BudgetPredictor(best_path, arch=PRV_ARCH, device=dev)
    cov5 = os.path.join(mode21_config(root).gt_path, "5")
    budget = pred.predict_from_coverage(cov5, PRV_CASE)
    value = pred.predict_value_from_arrays(pred.coverage_views(cov5, PRV_CASE))
    log(f"phase 12's object, views {list(PRV_CASE)} of its 5-view set: budget {budget} from {value:.6f}")
    del pred
    torch.cuda.empty_cache()

    # (e) mode 21 through the CLI with the trained checkpoint
    cfg_e, yaml_path = prv_train_mode21_config(root)
    sizes = list(dict.fromkeys([cfg_e.num_of_views, 5, budget, *PRV_TRAIN_COVERAGE, 100]))
    missing = [n for n in sizes if not os.path.exists(os.path.join(cfg_e.gt_path, f"{n}.json"))]
    argv = ["--config", yaml_path, "--mode", "21", "--method", "4", "--objects", OBJ_NAME, "--checkpoint", best_path,
            "--device", str(dev), "--sizes", *map(str, sizes)]
    log(f"-- 13e: nerf_prv_tpu_torch.pipeline.cli.main({argv[2:]}) in phase 12's workspace: {len(sizes)} coverage "
        f"sets, {len(missing)} of them not rendered yet; the default voxel field, eval on 100 views")
    rc, launched_e, evals, _, stages, wall = drive_mode21(lambda: pipeline_cli.main(argv), record_frames=False)
    walls["mode 21 CLI"] = wall
    log(f"mode 21 through the CLI: exit {rc}, {wall:.2f} s; stages: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in stages.items() if not k.startswith("coverage ")) + f"; {len(sizes)} coverage "
        f"sets {sum(v for k, v in stages.items() if k.startswith('coverage ')):.2f} s ({len(missing)} rendered)")
    log("launches: " + ", ".join(f"{k} {v}" for k, v in launched_e.items()))
    if rc != 0:
        raise SystemExit("the pipeline CLI failed")
    path = f"{cfg_e.save_path}_v{len(PRV_CASE)}_t0"
    # K8: one launch a coverage set not rendered before (get_coverage keeps a set whose json exists)
    check_mode21(dev, cfg_e, path, budget, launched_e, evals, None, len(missing), NerfConfig(n_steps=cfg_e.n_steps))
    for k in kernels:
        k["launches_prv_train"] = launched_a[k["name"]] + launched_e[k["name"]]
    log(f"phase 13 ({card}): micro-batch {micro} objects, peak {peaks[micro] / 1e9:.2f} GB; regression application "
        f"{reg_s:.3f} s ({reg_ips:.1f} images/s, f32 bound {reg_bound:.3f} s), pretrain application {pre_s:.3f} s "
        f"({pre_ips:.1f} images/s, bound {pre_bound:.3f} s); walls: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items()))
    log(f"phase 13 took {time.perf_counter() - t_phase:.1f} s")


# --- phase 14: the multi-device path on one card ---------------------------------------------------------

TP_SAMPLES = (4096, 16)  # one tight step's samples: 4,096 rays x 16
MD_STEPS = 200  # 14c: train_batch over dp = 2, depth cut from 2,500 to fit phase 14's 60 s
TP_DP_RTOL = 1e-6  # 14a: tp x dp forward against the replicated one, relative to the largest output
MD_LOSS_RTOL = 1e-6  # 14b: PRVNet loss on two devices against one, relative
MD_GRAD_RTOL = 1e-5  # 14a MLP leaves, 14b every leaf: worst difference over the leaf's largest entry
# 14c: the run through row_scatter_add against the one with the sums in a fixed order: each object's mean over
# the steps of log(loss / fixed-order loss), the worst object's.  Two correct runs part once the atomics' order
# rounds a sum otherwise (after 28-73 steps) and then wander either way: up to 1.2e-2 on an H100.  A
# scatter-add that drops duplicates drifts 0.21.  A subtler fault can stay under the limit: phases 2b and 6 hold
# the kernel itself to its sums
MD_KERNEL_LOSS_DRIFT = 0.05
TP_BROKEN = {
    "does not mask out-of-shard rows": lambda shard, idx, offset: voxelfield._GatherRows.apply(
        shard, torch.remainder(idx - offset, shard.shape[0]).contiguous(), False),
    "has the shard offset off by one row": lambda shard, idx, offset: _MASKED_GATHER(shard, idx, offset + 1),
}


def ray_points(source: BatchSource, cfg: NerfConfig, n_rays: int, n_samples: int, seed: int):
    """(positions (n_rays * n_samples, 3), unit directions) of stratified
    samples along ``n_rays`` rays drawn from the scene's hit pool, ray by
    ray, clamped into the grid's [0, 1)^3."""
    dev = source.pixels.device
    (o, d, _, _), jitter = source.draw(torch.Generator(device=dev).manual_seed(seed),
                                       dataclasses.replace(cfg, train_rays=n_rays), n_samples)
    tmin, tmax, _ = ray_sphere(o, d)
    base = torch.arange(n_samples, dtype=torch.float32, device=dev)[None, :]
    ts = tmin[:, None] + (base + jitter) * ((tmax - tmin) / n_samples)[:, None]
    pos = torch.clamp(o[:, None, :] + d[:, None, :] * ts[..., None], 0.0, 1.0 - 1e-6)
    return pos.reshape(-1, 3).contiguous(), d.repeat_interleave(n_samples, 0).contiguous()


def tp_loss(sigma, rgb):
    """tests/test_parallel.py's loss: every output matters."""
    return sigma.sum() * 1e-3 + (rgb * rgb).sum()


def tp_forward(mesh, params, x, d, cfg, batch_axis=None) -> tuple:
    """(sigma, rgb, gathers launched) of one tp field forward."""
    g0 = row_gather.launches
    sigma, rgb = parallel_mesh.tp_voxel_field(mesh, params, x, d, cfg, batch_axis=batch_axis)
    return sigma, rgb, row_gather.launches - g0


def leaf_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def tp_grads(mesh, p, x, d, cfg, batch_axis=None) -> tuple:
    """(MLP gradients by name, the grid's gradient as one tensor, gathers
    launched in the forward, scatter-adds in the backward) of ``tp_loss``
    through the tp field."""
    g0 = row_gather.launches
    sig, rgb = parallel_mesh.tp_voxel_field(mesh, p, x, d, cfg, batch_axis=batch_axis)
    fwd = row_gather.launches - g0
    keys = [k for k in p if k != "grid"]
    s0 = row_scatter_add.launches
    grads = torch.autograd.grad(tp_loss(sig, rgb), [p[k] for k in keys] + list(p["grid"]))
    return dict(zip(keys, grads)), torch.cat(grads[len(keys):]), fwd, row_scatter_add.launches - s0


def replicated_grads(leaves, x, d, cfg) -> tuple:
    """(every gradient of ``tp_loss`` through the replicated field, the
    cotangent of the gathered rows, the rows' indices)."""
    ref = torch.autograd.grad(tp_loss(*voxelfield.voxel_field(leaves, x, d, cfg)), list(leaves.values()))
    idx, frac = voxelfield.cell_and_frac(x, cfg.voxel_grid_size)
    rows = leaves["grid"].detach()[idx.long()].requires_grad_(True)
    raw = voxelfield.density_mlp(leaves, voxelfield.blend_rows(rows, frac, cfg.voxel_features), x, cfg)
    sigma, rgb = torch.exp(raw[..., 0]), model_mod.radiance(leaves, raw[..., 1:], d, cfg)
    (upd,) = torch.autograd.grad(tp_loss(sigma, rgb), [rows])
    return dict(zip(leaves, ref)), upd.contiguous(), idx


def phase_md_tp(dev, source: BatchSource, k_gather: dict, k_scatter: dict, card: str) -> dict:
    cfg = dataclasses.replace(VOXEL_CFG, voxel_gather_dtype="f32")
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    g_size, n_rays, n_samples = cfg.voxel_grid_size, *TP_SAMPLES
    n_rows, width = g_size ** 3, 8 * cfg.voxel_features
    log(f"-- 14a: tp_voxel_field at full width ({g_size}^3 grid, rows of {width} f32, "
        f"{n_rows * width * 4 / 1e6:.1f} MB), {n_rays * n_samples} samples of {n_rays} rays, on a mesh of {dev} "
        f"listed 2 (tp) and 4 (tp x dp) times, against the replicated field gathering in f32")
    g = torch.Generator(device=dev).manual_seed(14)
    params = init_params(g, cfg, device=dev)
    params["grid"] = torch.rand((n_rows, width), generator=g, device=dev) * 2.0 - 1.0
    x, d = ray_points(source, cfg, n_rays, n_samples, seed=41)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    tp2 = make_mesh(("tp", "dp"), (2, 1), [dev] * 2)
    tp2dp2 = make_mesh(("tp", "dp"), (2, 2), [dev] * 4)
    sharded = dict(leaves, grid=shard_rows(leaves["grid"].detach().requires_grad_(True), tp2))

    # the forward: bit-equal at tp 2; at tp 2 x dp 2 the products run on half the batch each
    fwd = {}
    with torch.no_grad():
        for c in (cfg, cfg32):
            ref = voxelfield.voxel_field(leaves, x, d, c)
            for name, m, axis in (("tp 2", tp2, None), ("tp 2 x dp 2", tp2dp2, "dp")):
                sig, rgb, n = tp_forward(m, sharded, x, d, c, axis)
                fwd[name, c is cfg32] = (torch.equal(sig, ref[0]) and torch.equal(rgb, ref[1]),
                                         max(leaf_gap(sig, ref[0]), leaf_gap(rgb, ref[1])), n)
    for (name, f32), (equal, gap, n) in fwd.items():
        log(f"forward at {name}, {'f32' if f32 else 'bf16 (the default)'} products: "
            f"{'bit-equal' if equal else f'{gap:.3e} of the largest output'} against the replicated field; {n} "
            f"row_gather launches (need 2: one a shard)")
    if not (fwd["tp 2", False][0] and fwd["tp 2", True][0]) or fwd["tp 2 x dp 2", True][1] > TP_DP_RTOL \
            or any(n != 2 for _, _, n in fwd.values()):
        raise SystemExit(f"the tp field's forward is not bit-equal at tp 2, or not within {TP_DP_RTOL} at tp 2 x "
                         f"dp 2 in f32, or it launches otherwise")
    with torch.no_grad():
        ref = voxelfield.voxel_field(leaves, x, d, cfg)
        for name, broken in TP_BROKEN.items():
            parallel_mesh._masked_gather = broken
            try:
                bsig, brgb, _ = tp_forward(tp2, sharded, x, d, cfg)
            finally:
                parallel_mesh._masked_gather = _MASKED_GATHER
            caught = not (torch.equal(bsig, ref[0]) and torch.equal(brgb, ref[1]))
            log(f"  broken on purpose, a shard gather that {name}: sigma off by {leaf_gap(bsig, ref[0]):.3e} of "
                f"its largest -> {'caught' if caught else 'NOT caught'}")
            if not caught:
                raise SystemExit(f"the tp forward check does not catch a gather that {name}")

    # gradients against the replicated field's: the grid's within twice phase 2b's bound (each scatter-add
    # within k * 2^-24 * sum|upd| of the exact sum for a row of k updates), the MLP leaves within MD_GRAD_RTOL
    upd = idx = None
    for name, m, axis, c in (("tp 2", tp2, None, cfg), ("tp 2 x dp 2", tp2dp2, "dp", cfg32),
                             ("tp 2 x dp 2, bf16 products", tp2dp2, "dp", cfg)):
        ref, c_upd, c_idx = replicated_grads(leaves, x, d, c)
        if upd is None:
            upd, idx = c_upd, c_idx
        i64 = c_idx.long()
        mag = torch.zeros((n_rows, width), dtype=torch.float64, device=dev).index_add_(0, i64, c_upd.double().abs())
        tol = 2 * torch.bincount(i64, minlength=n_rows).double()[:, None] * 2.0 ** -24 * mag
        mlp, grid_grad, n_g, n_s = tp_grads(m, sharded, x, d, c, axis)
        excess = float(((grid_grad.double() - ref["grid"].double()).abs() - tol).max())
        gaps = {k: leaf_gap(v, ref[k]) for k, v in mlp.items()}
        held = "bf16" not in name
        log(f"gradients at {name}: grid {float((grid_grad - ref['grid']).abs().max()):.3e} from the replicated "
            f"one, {excess:.3e} beyond twice the f32 scatter-add bound; MLP leaves " + ", ".join(
                f"{k} {v:.2e}" for k, v in gaps.items()) + (f" of their largest (need <= 0 and <= {MD_GRAD_RTOL})"
                                                              if held else " of their largest (no limit: the "
                                                              "halves' weight gradients are rounded to bf16 apart)")
            + f"; row_gather {n_g}, row_scatter_add {n_s} launches (need 2 and 2)")
        if (n_g, n_s) != (2, 2) or (held and (excess > 0 or max(gaps.values()) > MD_GRAD_RTOL)):
            raise SystemExit(f"the {name} gradients disagree with the replicated field's or launch otherwise")

    # the row kernels at a shard's shapes: every sample's index reaches each shard's gather and scatter-add.
    # A shard (8.2 MB) and the gather's output (16.8 MB) fit in the L2, so back-to-back calls on one copy would
    # beat the HBM bound: timed cold, each call on its own copy of the inputs
    shard_n = n_rows // 2
    local = torch.remainder(idx, shard_n).contiguous()
    k_gather["shapes"].append(check_gather(sharded["grid"][0].detach(), local, f"tp shard of {n_rows}, ray-ordered",
                                           cold=True))
    k_scatter["shapes"].append(check_scatter(local, upd, shard_n, f"N={local.numel()} tp shard of {n_rows}, "
                                                                    "ray-ordered", cold=True))

    flat = [v for k, v in sharded.items() if k != "grid"] + list(sharded["grid"])
    steps = {
        "replicated": lambda: torch.autograd.grad(tp_loss(*voxelfield.voxel_field(leaves, x, d, cfg)),
                                                  list(leaves.values())),
        "tp 2": lambda: torch.autograd.grad(tp_loss(*parallel_mesh.tp_voxel_field(tp2, sharded, x, d, cfg)), flat),
    }
    times = {}
    for name in ("replicated", "tp 2", "tp 2", "replicated"):
        times.setdefault(name, []).append(device_ms(steps[name], iters=20))
    log(f"forward + backward at {n_rays * n_samples} samples, bf16 products, device ms in turns ({card}; no "
        f"limit): replicated field gathering in f32 {times['replicated'][0]:.4f} / {times['replicated'][1]:.4f}, "
        f"tp 2 {times['tp 2'][0]:.4f} / {times['tp 2'][1]:.4f}")
    return {k: min(v) for k, v in times.items()}


def phase_md_prvnet(dev, card: str) -> dict:
    cfg = TrainConfig(arch=PRV_ARCH, image_size=TRAIN_SIZE, batch_size=4)
    log(f"-- 14b: PRVNet ({PRV_ARCH}, {TRAIN_SIZE}x{TRAIN_SIZE}, 5 views, f32) one micro-step of 4 objects split "
        f"2 + 2 over a mesh of {dev} listed twice, against a mesh of one")
    model = prv_train_mod.init_model(cfg, 5)
    g = torch.Generator(device=dev).manual_seed(15)
    views = torch.rand((4, 5, TRAIN_SIZE, TRAIN_SIZE, 3), generator=g, device=dev)
    # labels on one side of the seeded model's first prediction (~35.5, the middle of [13, 58]): with labels on
    # both sides the L1 gradients of the head's bias and of the last norm's cancel to ~1e-10, which leaves them
    # no digits to compare
    labels = torch.tensor([14.0, 20.0, 26.0, 32.0], device=dev)
    out = {}
    for name, mesh in (("one", make_mesh(devices=[dev])), ("two", make_mesh(devices=[dev, dev]))):
        step = prv_train_mod.make_train_step(model, cfg, mesh=mesh)
        parts = step.replicas.shard(views, labels)
        step.loss_and_grads(parts)
        sync()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        loss, grads = step.loss_and_grads(parts)
        sync()
        out[name] = (float(loss), [gr.detach() for gr in grads], time.perf_counter() - t,
                     torch.cuda.max_memory_allocated(), [tuple(v.shape) for v, _ in parts])
        del step, parts, grads
    (l1, g1, t1, m1, s1), (l2, g2, t2, m2, s2) = out["one"], out["two"]
    d_loss = abs(l2 - l1) / abs(l1)
    d_grad, worst = max((leaf_gap(b, a), n) for (n, _), a, b in zip(model.named_parameters(), g1, g2))
    log(f"shares {s1} against {s2}; loss {l2:.8f} against {l1:.8f}: {d_loss:.3e} relative (need <= {MD_LOSS_RTOL}); "
        f"worst gradient leaf {worst} {d_grad:.3e} of its largest (need <= {MD_GRAD_RTOL}); micro-step {t2:.3f} s against "
        f"{t1:.3f} s, peak {m2 / 1e9:.2f} GB against {m1 / 1e9:.2f} GB ({card})")
    if d_loss > MD_LOSS_RTOL or d_grad > MD_GRAD_RTOL or s2 != [(2, 5, TRAIN_SIZE, TRAIN_SIZE, 3)] * 2:
        raise SystemExit("the PRVNet micro-step on two devices disagrees with one device's")
    del model, views
    torch.cuda.empty_cache()
    return dict(one_s=t1, two_s=t2, one_gb=m1 / 1e9, two_gb=m2 / 1e9)


def scatter_in_order(idx, upd, n_rows):
    """The row scatter-add with every row's sum in one fixed order, where
    the kernel's atomics add a row's updates in whatever order the blocks
    run (so two trainings through the kernel differ in the last bits, and
    Adam carries that on): the updates sorted by row (a stable sort),
    summed by a float64 prefix sum along each column, differenced at each
    row's last update."""
    out = torch.zeros((n_rows, upd.shape[1]), dtype=upd.dtype, device=upd.device)
    if idx.numel() == 0:
        return out
    i64 = idx.to(torch.int64)
    order = torch.argsort(i64, stable=True)
    rows = i64[order]
    csum = torch.cumsum(upd[order].double().t().contiguous(), dim=1)  # (W, N): along the contiguous axis
    last = torch.ones_like(rows, dtype=torch.bool)
    last[:-1] = rows[1:] != rows[:-1]
    at = csum[:, last]
    out[rows[last]] = torch.diff(at, dim=1, prepend=torch.zeros_like(at[:, :1])).t().to(upd.dtype)
    return out


def phase_md_batch(dev, root: str, card: str) -> tuple:
    cfg = dataclasses.replace(VOXEL_CFG, n_steps=MD_STEPS)
    k = len(BATCH_FRAMES)
    log(f"-- 14c: train_batch of phase 11's {k} objects over a dp mesh of {dev} listed twice, {MD_STEPS} steps, "
        f"the devices' steps interleaved; then, with the scatter-add's sums in a fixed order, against each "
        f"device's chunk trained in turn")
    paths = [os.path.join(root, f"obj{i}_train.json") for i in range(k)]
    for i, (n_frames, colour) in enumerate(zip(BATCH_FRAMES, BATCH_PATTERNS)):
        if not os.path.exists(paths[i]):
            write_scene(root, dev, f"obj{i}_train", n_frames, turn=0.0, colour=colour)
    datasets = [load_dataset(p) for p in paths]
    mesh = make_mesh(devices=[dev, dev])
    runs, walls = {}, {}
    for name in ("interleaved", "interleaved, sums in order", "in turn, sums in order"):
        ordered = "in order" in name
        with row_ops(voxelfield.row_gather, scatter_in_order) if ordered else contextlib.nullcontext():
            sync()
            t = time.perf_counter()
            row_gather.launches = row_scatter_add.launches = 0
            if name.startswith("interleaved"):
                params, losses = batch_mod.train_batch(datasets, cfg, seed=0, mesh=mesh)
            else:
                chunks = [batch_mod._train_objects(datasets[2 * i:2 * i + 2], cfg, i, dev) for i in range(2)]
                params = {n: torch.cat([p[n] for p, _ in chunks]) for n in chunks[0][0]}
                losses = np.concatenate([ls for _, ls in chunks], axis=1)
            sync()
        walls[name] = time.perf_counter() - t
        runs[name] = (params, losses, (row_gather.launches, row_scatter_add.launches))
    with row_ops(voxelfield.row_gather, scatter_drops_duplicates):
        _, broken = batch_mod.train_batch(datasets, cfg, seed=0, mesh=mesh)
    want = tuple(2 * n for n in expected_train_launches(cfg))
    same = {}
    for a, b in (("interleaved, sums in order", "in turn, sums in order"),
                 ("interleaved", "interleaved, sums in order")):
        (pa, la, _), (pb, lb, _) = runs[a], runs[b]
        same[a] = np.array_equal(la, lb) and all(torch.equal(pa[n], pb[n]) for n in pb)
        first = int(np.argmax((la != lb).any(axis=1))) if not np.array_equal(la, lb) else None
        log(f"{a} against {b}: {'bit-equal' if same[a] else 'NOT bit-equal'} (worst leaf "
            f"{max(leaf_gap(pa[n], pb[n]) for n in pb):.3e} of its largest, losses "
            f"{float(np.abs(la - lb).max()):.3e} apart, first apart at step {first})")
    log(f"walls: " + ", ".join(f"{n} {w:.2f} s" for n, w in walls.items()) + "; launches " + ", ".join(
        f"{n} {r[2]}" for n, r in runs.items()) + f" (predicted {want} through the kernels for two devices' "
        f"{MD_STEPS} steps; the scatter-adds in order are not the kernel's)")
    losses, launched = runs["interleaved"][1], runs["interleaved"][2]
    if losses.shape != (MD_STEPS, k) or not np.isfinite(losses).all() or launched != want \
            or any(r[2][0] != want[0] for r in runs.values()):
        raise SystemExit("train_batch over dp = 2 gave no finite losses or launched otherwise")
    fixed = runs["interleaved, sums in order"][1]

    def drift(run):
        return float(np.abs(np.log(run / fixed).mean(axis=0)).max())

    gap, broken_gap = drift(losses), drift(broken)
    caught = not broken_gap <= MD_KERNEL_LOSS_DRIFT  # a non-finite loss is caught too
    log(f"losses through row_scatter_add against the sums in order: mean log ratio {gap:.3e} for the worst object "
        f"(need <= {MD_KERNEL_LOSS_DRIFT}); broken on purpose, a scatter-add that drops duplicates: "
        f"{broken_gap:.3e} -> {'caught' if caught else 'NOT caught'}")
    if not gap <= MD_KERNEL_LOSS_DRIFT or not caught:
        raise SystemExit("the interleaved train_batch's losses through row_scatter_add stray from the fixed-order "
                         "run's, or the limit does not catch a broken scatter-add")
    if not same["interleaved, sums in order"]:
        raise SystemExit("the interleaved train_batch is not bit-equal to the in-turn order")
    return walls, launched


def phase_multidevice(dev, root: str, source: BatchSource, k_gather: dict, k_scatter: dict, card: str) -> None:
    t_phase = time.perf_counter()
    log(f"== phase 14: the multi-device path on one card (a mesh that lists {dev} several times runs the shard "
        f"split, the masked gathers, the cross-device sums and the gradient reduction of a mesh of cards)")
    parts = [time.perf_counter()]
    tp_times = phase_md_tp(dev, source, k_gather, k_scatter, card)
    parts.append(time.perf_counter())
    prv = phase_md_prvnet(dev, card)
    parts.append(time.perf_counter())
    walls, launched_c = phase_md_batch(dev, root, card)
    parts.append(time.perf_counter())
    log(f"-- 14d: dryrun_multichip(4) on {dev} listed 4 times")
    t = time.perf_counter()
    row_gather.launches = row_scatter_add.launches = 0
    out = dryrun_multichip(4)
    sync()
    launched_d = (row_gather.launches, row_scatter_add.launches)
    log(f"dry run: {time.perf_counter() - t:.2f} s; ensemble losses {np.round(out['ensemble_losses'], 6).tolist()}, "
        f"batched {out['batch_losses'].shape}, tp loss {out['tp_loss']:.6f}, grid shards {out['grid_shards']}; "
        f"row_gather {launched_d[0]}, row_scatter_add {launched_d[1]} launches")
    if min(launched_d) == 0:
        raise SystemExit("the dry run did not go through the row kernels")
    # the multi-device path's launches: 14c's interleaved train_batch and the dry run (not the comparisons)
    k_gather["launches_multidevice"] = launched_c[0] + launched_d[0]
    k_scatter["launches_multidevice"] = launched_c[1] + launched_d[1]
    log(f"phase 14 ({card}): tp step {tp_times['tp 2']:.4f} ms against replicated {tp_times['replicated']:.4f} ms; "
        f"PRVNet micro-step {prv['two_s']:.3f} s on two against {prv['one_s']:.3f} s on one; train_batch "
        f"{walls['interleaved, sums in order']:.2f} s interleaved against {walls['in turn, sums in order']:.2f} s in "
        f"turn; launches of 14c + 14d: row_gather {k_gather['launches_multidevice']}, row_scatter_add "
        f"{k_scatter['launches_multidevice']}")
    parts.append(time.perf_counter())
    log("phase 14 parts: " + ", ".join(f"14{c} {b - a:.1f} s" for c, a, b in zip("abcd", parts, parts[1:])))
    log(f"phase 14 took {time.perf_counter() - t_phase:.1f} s")


CORPUS_OBJECT = "pla0"  # committed label 30, converged
CORPUS_COUNTS_MAX = 7  # 15a's coverage counts: 3, 7 and the 100-view test set
CORPUS_NERF = NerfConfig(n_steps=300)  # 15a's fields: the protocol's, depth cut from 1,200 steps
# 15a's 100-view field over an all-black frame after 300 steps: measured 15.0 dB (27.68 against 12.69)
CORPUS_PSNR_MARGIN_DB = 5.0
CORPUS_DATA = ("blo0", "cup0", "blo1")  # 15b: two committed train objects and one val object
CORPUS_EPOCHS = 2  # 15c: pretrain and regression epochs, cut from 50 and 800


@contextlib.contextmanager
def corpus_recorders(renders: list, evals: list, size_tests: list, fields: list = None):
    """Record, while the PRV corpus runs: each K8 coverage launch's first,
    middle and last frames (``renders``, as 12b keeps them), each
    ``eval_nerf`` with the gathers it launched (``evals``; its field's
    parameters in ``fields`` where given), and each size test
    (``size_tests``: one K8 launch of its 5 probe views)."""
    real_render, real_eval = coverage_mod.render_pointcloud_views, api_mod.eval_nerf
    real_size = object_setup_mod._size_test_rate

    def render(points, colors, c2ws, intr, point_size=None, device="cuda"):
        out = real_render(points, colors, c2ws, intr, point_size=point_size, device=device)
        keep = sorted({0, len(c2ws) // 2, len(c2ws) - 1})
        renders.append((points, colors, np.asarray(c2ws)[keep], intr, point_size, len(c2ws), keep, out[keep]))
        return out

    def evaluate(params, test, ncfg=None):
        before = row_gather.launches
        out = real_eval(params, test, ncfg)
        evals.append((test, ncfg, row_gather.launches - before))
        if fields is not None:
            fields.append(params)
        return out

    def size_test(*a, **kw):
        size_tests.append(a[0].shape[0])
        return real_size(*a, **kw)

    coverage_mod.render_pointcloud_views, api_mod.eval_nerf = render, evaluate
    object_setup_mod._size_test_rate = size_test
    try:
        yield
    finally:
        coverage_mod.render_pointcloud_views, api_mod.eval_nerf = real_render, real_eval
        object_setup_mod._size_test_rate = real_size


def phase_corpus(dev, root: str, k_gather: dict, k_scatter: dict, k_splat: dict, card: str) -> None:
    """(15) The PRV corpus's entry points (``nerf_prv_tpu_torch.experiments``)
    at a cut size: (a) one family object through the label protocol (modes
    0 -> 3 -> 4 -> fit at the 320x180 camera, counts 3, 7 and 100, 300-step
    fields), its launches held to the code's prediction; (b) the corpus
    dataset of three objects from the committed labels and split; (c) two
    epochs of each stage of the tiny@180 recipe on it."""
    from nerf_prv_tpu_torch.experiments import corpus_dataset, label_protocol, prvnet_recipe

    t_phase = time.perf_counter()
    log("== phase 15: the PRV corpus at a cut size (label protocol, corpus dataset, tiny@180 recipe)")
    ws = os.path.join(root, "corpus")
    cfg = label_protocol.pipeline_config(ws).replace(coverage_view_num_max=CORPUS_COUNTS_MAX)
    counts = label_protocol.fit_counts(cfg) + [100]
    label_protocol.install_reference_viewspace(cfg, counts + [64], probe=True)
    object_setup_mod._ensure_viewspace(cfg.viewspace_path, cfg.num_of_views, dev)  # the 540 views, not timed
    sync()
    renders, evals, size_tests = [], [], []
    wrappers = (row_gather, row_scatter_add, splat)
    for w in wrappers:
        w.launches = 0
    t = time.perf_counter()
    with corpus_recorders(renders, evals, size_tests):
        out, _ = label_protocol.run_label_protocol(cfg, [CORPUS_OBJECT], device=dev, nerf_cfg=CORPUS_NERF)
    sync()
    wall_a = time.perf_counter() - t
    launched_a = {w.__name__: w.launches for w in wrappers}
    rec = label_protocol.object_record(cfg, CORPUS_OBJECT)
    log(f"15a: {CORPUS_OBJECT} through modes 0 -> 3 -> 4 -> fit, counts {counts}, {CORPUS_NERF.n_steps}-step "
        f"fields: {wall_a:.2f} s; label {out[CORPUS_OBJECT][0]} converged {out[CORPUS_OBJECT][1]}, PSNR by count "
        f"{ {k: round(v, 3) for k, v in rec['psnr'].items()} }; launches {launched_a}")
    want_g, want_s = expected_train_launches(CORPUS_NERF)
    eval_want = [expected_narrow_eval_gathers(test, ncfg or NerfConfig(), dev) for test, ncfg, _ in evals]
    want = {"row_gather": len(counts) * want_g + sum(e for e, _ in eval_want),
            "row_scatter_add": len(counts) * want_s, "splat": len(size_tests) + len(counts)}
    log(f"15a predicted: {want} (row_gather: {len(counts)} trainings x {want_g} + the evals' 2 a chunk of "
        f"{render_mod._default_chunk(CORPUS_NERF)} sphere hits: {[h for _, h in eval_want]}; splat: "
        f"{len(size_tests)} size tests + {len(counts)} coverage sets); the evals launched {[g for _, _, g in evals]}")
    if launched_a != want or [g for _, _, g in evals] != [e for e, _ in eval_want]:
        raise SystemExit("15a: the label protocol's launches are not the ones the code predicts")
    check_mode21_frames(renders, dev, where="15a")
    test_ds = evals[-1][0]
    base = black_psnr(test_ds)
    psnrs = [float(v) for v in rec["psnr"].values()]
    log(f"15a: PSNR of the 100-view field {rec['psnr']['100']:.3f} dB against an all-black frame's {base:.3f} dB "
        f"(need >= {CORPUS_PSNR_MARGIN_DB} dB above); label.txt parsed, gain {rec.get('gain_at_label')}")
    if not (all(map(math.isfinite, psnrs)) and rec["psnr"]["100"] >= base + CORPUS_PSNR_MARGIN_DB):
        raise SystemExit("15a: the protocol's fields are not finite or do not beat a black frame by the margin")

    renders, size_tests = [], []
    for w in wrappers:
        w.launches = 0
    t = time.perf_counter()
    with corpus_recorders(renders, [], size_tests):
        loaded = corpus_dataset.render_corpus(cfg, CORPUS_DATA, device=dev)
        ds = corpus_dataset.assemble_dataset(cfg, names=CORPUS_DATA)
    sync()
    launched_b = {w.__name__: w.launches for w in wrappers}
    roster = corpus_dataset.corpus_roster()
    log(f"15b: corpus dataset of {list(CORPUS_DATA)}: {time.perf_counter() - t:.2f} s; train {ds['train']}, "
        f"val {ds['val']}, labels {ds['labels']}; launches {launched_b} ({len(size_tests)} size tests)")
    n_png = {n: len([f for f in os.listdir(os.path.join(ds["root"], n)) if f.endswith(".png")]) for n in loaded}
    if (sorted(loaded) != sorted(CORPUS_DATA) or launched_b != {"row_gather": 0, "row_scatter_add": 0,
                                                                 "splat": len(size_tests) + len(CORPUS_DATA)}
            or ds["val"] != [n for n in CORPUS_DATA if n in roster["val"]]
            or any(ds["labels"][n] != roster["labels"][n] for n in CORPUS_DATA)
            or set(n_png.values()) != {corpus_dataset.N_VIEWS}):
        raise SystemExit(f"15b: the corpus dataset is not the committed one or its launches are off ({n_png})")
    check_mode21_frames(renders, dev, where="15b")

    t = time.perf_counter()
    art = prvnet_recipe.run_two_stage(ds["root"], os.path.join(ws, "tiny180"), seed=0, pretrain_epochs=CORPUS_EPOCHS,
                                      epochs=CORPUS_EPOCHS, device=dev, log_every=1,
                                      regression_batch=len(ds["train"]))
    sync()
    log(f"15c: tiny@180 recipe, {CORPUS_EPOCHS} + {CORPUS_EPOCHS} epochs (regression batch {len(ds['train'])}): "
        f"{time.perf_counter() - t:.2f} s; pretrain best L1 {art['pretrain_best_l1']:.3f} ({art['pretrain_seconds']:.2f} "
        f"s), regression best L1 {art['best_val_l1_mean']:.3f} ({art['train_seconds']:.2f} s), val predictions "
        f"{ {n: round(v['pred'], 2) for n, v in art['val_per_object'].items()} }")
    values = [art["pretrain_best_l1"], art["best_val_l1_mean"]] + [v["pred"] for v in art["val_per_object"].values()]
    if (len(art["val_l1_by_epoch"]) != CORPUS_EPOCHS or not all(map(math.isfinite, values))
            or not all(13.0 <= v["pred"] <= 58.0 for v in art["val_per_object"].values())):
        raise SystemExit("15c: the recipe's run is not finite, or its predictions leave [13, 58]")
    k_gather["launches_corpus"] = launched_a["row_gather"] + launched_b["row_gather"]
    k_scatter["launches_corpus"] = launched_a["row_scatter_add"] + launched_b["row_scatter_add"]
    k_splat["launches_corpus"] = launched_a["splat"] + launched_b["splat"]
    log(f"phase 15 ({card}) took {time.perf_counter() - t_phase:.1f} s; launches: row_gather "
        f"{k_gather['launches_corpus']}, row_scatter_add {k_scatter['launches_corpus']}, splat {k_splat['launches_corpus']}")


EVAL_OBJECT = "spi10"  # a test-roster object: committed budget 23 in both tables
EVAL_BUDGET = 23  # its committed PRV budget (mode 7's prv and gt, mode 21's method 4)
EVAL_MODE_BUDGET = 28  # the val split's mode, mode 7's first baseline
EVAL_COVERAGE = [64, 5, 23, 28, 100]  # 16b's coverage sizes, cut from 64 + 5..60 + 100
EVAL_NERF = NerfConfig(n_steps=300)  # the protocol's field, depth cut from 1,200 steps
EVAL_PSNR_MARGIN_DB = CORPUS_PSNR_MARGIN_DB
# what the fields' depth does not change, as the JAX package computes it on
# the CPU from the shipped view-space files and spi10 at the protocol camera
# (tests/test_torch_experiments_eval.py holds the port to it there): mode 7's
# path lengths and mode 21's total movements.  The committed artifacts were
# taken on the reference's own files, which today's generator does not
# reproduce bit for bit: they agree with these to 4 decimals for the path
# lengths and method 4, and differ by 2e-4..8e-4 for methods 0 and 1
EVAL_PATH_LEN = {23: 3.6356963675978995, 28: 4.2085214124093095}
EVAL_MOVEMENT = {4: 3.635696440680221, 0: 8.453503323002835, 1: 3.0592104393440027}
EVAL_RTOL = 1e-9  # float64 local paths over the same files; the object's size and centre from the card's load


@contextlib.contextmanager
def eval_recorders(renders: list, evals: list, size_tests: list, trainings: list):
    """:func:`corpus_recorders` over mode 7's ``run`` and mode 21's NBV loop
    alike (which imported ``eval_nerf`` and ``train_nerf`` by name), with
    every field trained counted in ``trainings``."""
    real = dict(nbv_eval=nbv_mod.eval_nerf, nbv_train=nbv_mod.train_nerf, api_train=api_mod.train_nerf)

    def nbv_evaluate(params, test, ncfg=None):
        before = row_gather.launches
        out = real["nbv_eval"](params, test, ncfg)
        evals.append((test, ncfg, row_gather.launches - before))
        return out

    def counted(fn):
        def train(*a, **kw):
            trainings.append(a[0])
            return fn(*a, **kw)
        return train

    nbv_mod.eval_nerf, nbv_mod.train_nerf = nbv_evaluate, counted(real["nbv_train"])
    api_mod.train_nerf = counted(real["api_train"])
    try:
        with corpus_recorders(renders, evals, size_tests):
            yield
    finally:
        nbv_mod.eval_nerf, nbv_mod.train_nerf, api_mod.train_nerf = (
            real["nbv_eval"], real["nbv_train"], real["api_train"])


def phase_eval(dev, root: str, k_gather: dict, k_scatter: dict, k_splat: dict, card: str) -> None:
    """(16) The held-out evaluation (``nerf_prv_tpu_torch.experiments``) at a
    cut size: (a) mode 7 for one test object at its committed budget and the
    val split's mode, (b) mode 21 methods 4, 0 and 1 at the committed
    budget, 300-step fields, in one workspace; launches, K8 frames, path
    lengths, movements and PSNRs held."""
    from nerf_prv_tpu_torch.experiments import label_protocol, mode7_compare, mode21_table
    from nerf_prv_tpu_torch.experiments.families import make_family_object

    t_phase = time.perf_counter()
    log("== phase 16: the held-out evaluation at a cut size (mode 7, mode 21 methods 4, 0, 1)")
    ws = os.path.join(root, "eval")
    cfg7 = label_protocol.pipeline_config(ws)
    cfg21 = mode21_table.mode21_config(ws)
    mode7_compare.install_eval_viewspace(cfg7)
    make_family_object(EVAL_OBJECT, label_protocol.model_dir(cfg7))
    object_setup_mod._ensure_viewspace(cfg7.viewspace_path, cfg7.num_of_views, dev)  # the 540 views, not timed
    m7_ref = mode7_compare.committed()["rows"][EVAL_OBJECT]
    m21_ref = mode21_table.committed()["rows"]
    sync()
    renders, evals, size_tests, trainings = [], [], [], []
    wrappers = (row_gather, row_scatter_add, splat)
    for w in wrappers:
        w.launches = 0
    t = time.perf_counter()
    pred = mode21_table.PinnedPredictor({EVAL_OBJECT: EVAL_BUDGET})
    with eval_recorders(renders, evals, size_tests, trainings):
        rows7 = mode7_compare.run_mode7(cfg7, [EVAL_OBJECT], {EVAL_OBJECT: EVAL_BUDGET}, {"mode": EVAL_MODE_BUDGET},
                                        predictions={EVAL_OBJECT: EVAL_BUDGET}, device=dev, nerf_cfg=EVAL_NERF)
        sync()
        wall_a = time.perf_counter() - t
        rows21 = mode21_table.run_rows(cfg21, [EVAL_OBJECT], (4, 0, 1), pred, device=dev, nerf_cfg=EVAL_NERF,
                                       coverage_sizes=EVAL_COVERAGE)
    sync()
    wall = time.perf_counter() - t
    launched = {w.__name__: w.launches for w in wrappers}
    entry = rows7[EVAL_OBJECT]
    log(f"16a: mode 7 at {sorted({r['budget'] for r in entry.values()})}: {wall_a:.2f} s; "
        + ", ".join(f"{k} {r['budget']}: {r['PSNR']:.3f} dB path {r['path_len']!r}" for k, r in entry.items()))
    log(f"16b: mode 21 methods 4, 0, 1 at budget {EVAL_BUDGET}: {wall - wall_a:.2f} s; {json.dumps(rows21)}; "
        f"the predictor was asked {pred.calls}")

    # launches from the code: each field trains through train_nerf and is
    # scored once; K8 renders each size test and each coverage set once
    n_fields = len({EVAL_BUDGET, EVAL_MODE_BUDGET}) + 3
    n_sets = len({EVAL_BUDGET, EVAL_MODE_BUDGET, 100} | set(EVAL_COVERAGE))
    want_g, want_s = expected_train_launches(EVAL_NERF)
    eval_want = [expected_narrow_eval_gathers(test if not isinstance(test, str) else
                                              load_dataset(test, with_images=False), ncfg or NerfConfig(), dev)
                 for test, ncfg, _ in evals]
    want = {"row_gather": n_fields * want_g + sum(e for e, _ in eval_want),
            "row_scatter_add": n_fields * want_s, "splat": len(size_tests) + n_sets}
    log(f"16 predicted: {want} (row_gather: {n_fields} trainings x {want_g} + the evals' 2 a chunk of "
        f"{render_mod._default_chunk(EVAL_NERF)} sphere hits: {[sum(h) for _, h in eval_want]}; splat: "
        f"{len(size_tests)} size tests + {n_sets} coverage sets); launched {launched}, the evals "
        f"{[g for _, _, g in evals]}, {len(trainings)} trainings")
    if (launched != want or len(trainings) != n_fields or len(evals) != n_fields
            or [g for _, _, g in evals] != [e for e, _ in eval_want]):
        raise SystemExit("16: the evaluation's launches are not the ones the code predicts")
    check_mode21_frames(renders, dev, where="16")

    # what does not depend on the fields' depth: path lengths and movements
    for key, r in entry.items():
        ref = m7_ref[key]
        want = EVAL_PATH_LEN[r["budget"]]
        log(f"16a {key}: budget {r['budget']} (committed {ref['budget']}), path {r['path_len']!r} against the JAX "
            f"package's {want!r} and the committed {ref['path_len']!r}")
        if (r["budget"] != ref["budget"] or abs(r["path_len"] - want) > EVAL_RTOL * want
                or round(r["path_len"], 4) != round(ref["path_len"], 4)):
            raise SystemExit(f"16a: mode 7's {key} budget or path length is not the committed one")
    for m in (4, 0, 1):
        key = f"{EVAL_OBJECT}/m{m}"
        r, ref = rows21[key], m21_ref[key]
        moved = mode21_table.total_movement(os.path.join(cfg21.replace(name_of_pcd=EVAL_OBJECT, method_of_IG=m)
                                                         .save_path + "_v3_t0"))
        log(f"16b {key}: views {r.get('n_views_trained')} (committed {ref['n_views_trained']}), budget "
            f"{r.get('budget')}, movement {moved!r} against the JAX package's {EVAL_MOVEMENT[m]!r} "
            f"(committed {ref['movement']}, {moved - ref['movement']:+.4f})")
        if (r.get("n_views_trained") != ref["n_views_trained"] or r.get("budget") != ref.get("budget")
                or abs(moved - EVAL_MOVEMENT[m]) > EVAL_RTOL * EVAL_MOVEMENT[m]
                or (m == 4 and r.get("movement") != ref["movement"])):
            raise SystemExit(f"16b: mode 21's {key} views, budget or movement is not the expected one")
    base = black_psnr(load_dataset(os.path.join(cfg7.replace(name_of_pcd=EVAL_OBJECT).gt_path, "100.json")))
    psnrs = [r["PSNR"] for r in entry.values()] + [rows21[f"{EVAL_OBJECT}/m{m}"]["PSNR"] for m in (4, 0, 1)]
    log(f"16: PSNRs {[round(p, 3) for p in psnrs]} dB against an all-black frame's {base:.3f} dB "
        f"(need >= {EVAL_PSNR_MARGIN_DB} dB above)")
    if not all(math.isfinite(p) and p >= base + EVAL_PSNR_MARGIN_DB for p in psnrs):
        raise SystemExit("16: a field is not finite or does not beat a black frame by the margin")
    for k, name in ((k_gather, "row_gather"), (k_scatter, "row_scatter_add"), (k_splat, "splat")):
        k["launches_eval"] = launched[name]
    log(f"phase 16 ({card}) took {time.perf_counter() - t_phase:.1f} s; launches: {launched}")


# --- phase 17: a textured mesh from OBJ to label at full width ---------------------------------------------

REAL_KIND = "torus"  # the committed run: label 20, converged, 24 counts of 2,500-step fields
REAL_SWEEP = (12, 27)  # 17's sweep (step, max): counts 3, 15, 27 and the 100-view anchor, cut from 3..49 step 2
REAL_NERF = NerfConfig(n_steps=300)  # the protocol's field (the default voxel field), depth cut from 2,500 steps
# each field's PSNR on the 100-view set over an all-black frame's after 300 steps: measured 7.13-13.86 dB (18.19
# at 3 views to 24.93 at 100, against 11.06), about half the smallest
REAL_PSNR_MARGIN_DB = 3.5


def phase_real_object(dev, root: str, k_gather: dict, k_scatter: dict, k_splat: dict, card: str) -> None:
    """(17) The production label protocol on the textured torus
    (``experiments.real_object.run_real_object``): OBJ + MTL + PNG through
    L0's 300,000-point sampling, mode 0 from the shipped files, mode 3 at the
    1280x720 model-2 camera, the 100-view anchor, the sweep and the fit, with
    the depth cut (counts 3, 15, 27, 300-step fields); launches held to the
    code, the kept K8 frames bit-equal, each field's PSNR over black."""
    from nerf_prv_tpu_torch.experiments import label_protocol, real_object

    t_phase = time.perf_counter()
    step, cmax = REAL_SWEEP
    log(f"== phase 17: the textured {REAL_KIND} from OBJ to label at 1280x720 (sweep 3..{cmax} step {step} + 100, "
        f"{REAL_NERF.n_steps}-step fields of the default voxel field)")
    ws = os.path.join(root, "real_object")
    cfg = real_object.real_object_config(REAL_KIND, ws, step, cmax)
    counts = label_protocol.fit_counts(cfg)
    object_setup_mod._ensure_viewspace(cfg.viewspace_path, cfg.num_of_views, dev)  # the 540 views, not timed
    sync()
    renders, evals, size_tests, fields = [], [], [], []
    wrappers = (row_gather, row_scatter_add, splat)
    for w in wrappers:
        w.launches = 0
    t = time.perf_counter()
    with corpus_recorders(renders, evals, size_tests, fields):
        art, walls = real_object.run_real_object(REAL_KIND, ws, None, step, cmax, device=dev, nerf_cfg=REAL_NERF)
    sync()
    wall = time.perf_counter() - t
    launched = {w.__name__: w.launches for w in wrappers}
    log(f"17: {wall:.2f} s (" + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items()) + f"); label "
        f"{art['gradient_label_0.02']} converged {art['converged']} on counts {art['view_counts']}, PSNR "
        f"{art['measured_psnr']} and {art['max_psnr_100']} at 100 views; curve monotone {art['curve_monotone']}, "
        f"diminishing {art['curve_diminishing_returns']}; launches {launched}")

    # launches from the code: the anchor, then each count's field, trains through train_nerf and is
    # scored once on the 100-view set; K8 renders each size test and each coverage set once
    n_fields = len(counts) + 1
    want_g, want_s = expected_train_launches(REAL_NERF)
    eval_want = [expected_eval_gathers(p, test, ncfg or NerfConfig(), dev) for p, (test, ncfg, _) in zip(fields, evals)]
    want = {"row_gather": n_fields * want_g + sum(e for e, _ in eval_want), "row_scatter_add": n_fields * want_s,
            "splat": len(size_tests) + n_fields}
    log(f"17 predicted: {want} (row_gather: {n_fields} trainings x {want_g} + the evals' 2 a chunk of "
        f"{render_mod._default_chunk(REAL_NERF)} level-1 survivors: {[sum(h) for _, h in eval_want]}; splat: "
        f"{len(size_tests)} size tests + {n_fields} coverage sets); the evals launched {[g for _, _, g in evals]}")
    if launched != want or len(evals) != n_fields or [g for _, _, g in evals] != [e for e, _ in eval_want]:
        raise SystemExit("17: the real object's launches are not the ones the code predicts")
    check_mode21_frames(renders, dev, where="17")

    ref = real_object.committed(REAL_KIND)
    base = black_psnr(evals[0][0])
    psnrs = [float(p) for p in art["measured_psnr"]] + [float(art["max_psnr_100"])]
    log(f"17: PSNRs {psnrs} dB against an all-black frame's {base:.3f} dB (need >= {REAL_PSNR_MARGIN_DB} dB "
        f"above: the smallest margin {min(psnrs) - base:.3f}); the committed 2,500-step run's at these counts "
        f"{[ref['measured_psnr'][ref['view_counts'].index(v)] for v in counts if v in ref['view_counts']]} and "
        f"{ref['max_psnr_100']}")
    if (sorted(art) != sorted(ref) or len(art["fitted_curve_3_100"]) != len(ref["fitted_curve_3_100"])
            or not all(map(math.isfinite, art["fitted_curve_3_100"]))):
        raise SystemExit("17: the artifact does not have the committed run's keys or its curve is not finite")
    if not all(math.isfinite(p) and p >= base + REAL_PSNR_MARGIN_DB for p in psnrs):
        raise SystemExit("17: a field is not finite or does not beat a black frame by the margin")
    for k, name in ((k_gather, "row_gather"), (k_scatter, "row_scatter_add"), (k_splat, "splat")):
        k["launches_real_object"] = launched[name]
    log(f"phase 17 ({card}) took {time.perf_counter() - t_phase:.1f} s; launches: {launched}")


# --- phase 18: the end-to-end mode 21 at full width ------------------------------------------------------

E2E_NERF = NerfConfig(n_steps=300)  # the default voxel field, depth cut from 2,500 steps
E2E_BUDGET = 4  # pinned, cut from the predictor's 36: methods 0 and 2 replay it as 3 iterations
E2E_MEMBERS = 2  # the script's ensemble_num: method 2 trains two fields an iteration
# each method's final field on the 100-view set over an all-black frame's after 300 steps
E2E_PSNR_MARGIN_DB = 3.0


def phase_e2e(dev, root: str, k_gather: dict, k_scatter: dict, k_splat: dict, card: str) -> None:
    """(18) ``experiments.e2e_mode21.run_e2e``, the end-to-end mode 21 with
    the PRV method, the random baseline and the ensemble-NeRF baseline, at
    the script's width (toy0, the 1280x720 model-2 camera, the 40^3 voxel
    field at 4,096 rays, a 60-view candidate space, ``ensemble_num=2``) with
    the depth cut: 300-step fields, the budget pinned at 4 by a fixed-budget
    predictor, ``evaluate=True``.  Launches held to the code, the kept K8
    frames bit-equal, method 2's choices equal to the plain score's argmax
    on its screenshots, each final field's PSNR over black."""
    from nerf_prv_tpu_torch.experiments import check_e2e_mode21 as e2e_check
    from nerf_prv_tpu_torch.experiments import e2e_mode21, mode7_compare, mode21_table
    from nerf_prv_tpu_torch.experiments.toy import TOY_NAME, write_toy

    t_phase = time.perf_counter()
    ws = os.path.join(root, "e2e")
    cfg = e2e_mode21.e2e_config(ws, evaluate=True).replace(n_steps=E2E_NERF.n_steps)
    log(f"== phase 18: e2e mode 21, methods {e2e_mode21.METHODS} on {TOY_NAME} at {cfg.camera.width}x"
        f"{cfg.camera.height}, {cfg.num_of_views} candidate views, ensemble {cfg.ensemble_num}, budget pinned at "
        f"{E2E_BUDGET}, {E2E_NERF.n_steps}-step fields, evaluate on 100 views")
    write_toy(ws)
    mode7_compare.install_eval_viewspace(cfg)  # the view spaces 5..60 (mode 0 writes none), not timed
    pred = mode21_table.PinnedPredictor({TOY_NAME: E2E_BUDGET})
    # derived before the run: each method's fields, screenshot sets and evals; K8's sets
    plans = {m: e2e_check.planned_work(m, E2E_BUDGET, cfg.replace(method_of_IG=m)) for m in e2e_mode21.METHODS}
    sets = list(dict.fromkeys([cfg.num_of_views, 5, E2E_BUDGET, 100]))
    log(f"18 derived before the run: {json.dumps(plans)}; K8: the size test's tries + sets {sets}")
    sync()
    renders, size_tests, trainings, evals, shots = [], [], [], [], []
    for w in (row_gather, row_scatter_add, splat):
        w.launches = 0
    stages = {}
    t = time.perf_counter()
    with corpus_recorders(renders, [], size_tests), e2e_check.nbv_recorder(trainings, evals, shots), \
            stage_timers(stages):
        out = e2e_mode21.run_e2e(ws, device=dev, cfg=cfg, nerf_cfg=E2E_NERF, predictor=pred,
                                 coverage_sizes=[E2E_BUDGET, 100])
    sync()
    wall = time.perf_counter() - t
    launched = {w.__name__: w.launches for w in (row_gather, row_scatter_add, splat)}
    rows = {m: e2e_check.read_path(r["path"]) for m, r in out["methods"].items()}
    log("18 stages (host clock, each ended by a sync): " + ", ".join(f"{k} {v:.2f} s" for k, v in stages.items()))
    log(f"18: {wall:.2f} s; " + "; ".join(
        f"method {m} budget {r.get('budget', '-')} chose {r['chosen']} moved {r['movement_total']:.4f} run_time "
        f"{r['run_time']:.2f} s PSNR {r['PSNR']:.3f} SSIM {r['SSIM']:.4f}" for m, r in rows.items()))

    want, per_call = e2e_check.expected_launches(trainings, evals, shots, E2E_NERF, dev)
    want["splat"] = len(size_tests) + len(sets)
    n = {k: sum(p[k] for p in plans.values()) for k in ("fields", "screenshots", "evals")}
    log(f"18 predicted: {want} (row_gather: {n['fields']} trainings x {expected_train_launches(E2E_NERF)[0]} + "
        f"{n['evals']} evals' 2 a chunk of level-1 survivors {[sum(d) for d in per_call['eval_data']]} + "
        f"{n['screenshots']} screenshot sets' 2 a chunk of a 16-frame group's sphere hits "
        f"{per_call['screenshot_hits']}; splat: {len(size_tests)} size tests + {len(sets)} sets); launched {launched}")
    if (launched != want or (len(trainings), len(shots), len(evals)) != (n["fields"], n["screenshots"], n["evals"])
            or any(g != e for g, e in per_call["evals"] + per_call["screenshots"])):
        raise SystemExit("18: the e2e run's launches are not the ones the code predicts")
    check_mode21_frames(renders, dev, where="18")

    if rows[4].get("budget") != E2E_BUDGET or any(len(r["chosen"]) != E2E_BUDGET - 1 for r in rows.values()):
        raise SystemExit("18: a method did not plan or replay the pinned budget")
    choices = e2e_check.ensemble_choices(out["methods"][2]["path"], rows[2]["first_view"], rows[2]["chosen"],
                                         cfg.num_of_views, E2E_MEMBERS)
    log(f"18: method 2's choices {[c['card'] for c in choices]} against the plain score's argmax on its screenshots "
        f"{[c['plain'] for c in choices]} (top-2 gaps {[round(c['top2_gap'], 3) for c in choices]})")
    if any(c["card"] != c["plain"] for c in choices):
        raise SystemExit("18: method 2 did not choose the plain score's argmax")
    base = black_psnr(os.path.join(cfg.gt_path, "100.json"))
    psnrs = [rows[m]["PSNR"] for m in e2e_mode21.METHODS]
    log(f"18: final PSNRs {[round(p, 3) for p in psnrs]} dB against an all-black frame's {base:.3f} dB (need >= "
        f"{E2E_PSNR_MARGIN_DB} dB above: the smallest margin {min(psnrs) - base:.3f})")
    if not all(math.isfinite(p) and p >= base + E2E_PSNR_MARGIN_DB for p in psnrs):
        raise SystemExit("18: a final field is not finite or does not beat a black frame by the margin")
    for k, name in ((k_gather, "row_gather"), (k_scatter, "row_scatter_add"), (k_splat, "splat")):
        k["launches_e2e"] = launched[name]
    log(f"phase 18 ({card}) took {time.perf_counter() - t_phase:.1f} s; launches: {launched}")


# --- phase 19: the NeRF quality studies' scenes and fields -----------------------------------------------

QUALITY_NERF = dict(n_steps=300)  # the studies' NerfConfig() field, depth cut from 2,500 steps
QUALITY_EVALS = ({}, dict(render_probe_fine=24))  # the default and exp_thin_geometry.py's rp24 arm, one field
# each evaluation's PSNR on the splat scene's 8 test frames over an all-black frame's after 300 steps: measured
# 19.66 and 19.76 dB (35.39 and 35.50 against 15.74), about twice this
QUALITY_PSNR_MARGIN_DB = 10.0


def phase_quality(dev, root: str, k_gather: dict, k_scatter: dict, k_splat: dict, card: str) -> None:
    """(19) The quality studies' splat scene written on the card and held
    against the JAX writer's digests, then one of their fields
    (``quality_studies.train_and_evaluate``) cut to 300 steps and evaluated
    under two arms that share it; launches held to the code, each
    evaluation's PSNR over black."""
    from nerf_prv_tpu_torch.experiments import quality_scenes as qs
    from nerf_prv_tpu_torch.experiments import quality_studies as qst

    t_phase = time.perf_counter()
    ws = os.path.join(root, "quality")
    evals = {qst.eval_key(kw): qst.eval_options(kw) for kw in QUALITY_EVALS}
    kw = qs.SCENES["splat"][1]
    log(f"== phase 19: the quality studies' splat scene ({kw['n_train']} + {kw['n_test']} views at "
        f"{kw['camera'].width}x{kw['camera'].height}, {kw['n_points']} points, point size {kw['point_size']}) and a "
        f"{QUALITY_NERF['n_steps']}-step NerfConfig() field evaluated as {list(evals)}")
    sync()
    for w in (row_gather, row_scatter_add, splat):
        w.launches = 0
    t = time.perf_counter()
    train_json, test_json = qs.write_named("splat", ws, device=dev)
    sync()
    t_scene = time.perf_counter() - t
    n_sets = splat.launches
    diff = qs.compare_digests(qs.scene_digests(ws), qs.committed_digests()["splat"])
    log(f"19: scene written in {t_scene:.2f} s in {n_sets} K8 launches; against the JAX writer's digests of "
        f"{diff['n_files']} files: bytes differ {diff['bytes']}, frames differ {diff['pixels']}, "
        f"missing {diff['missing']}")
    if diff["bytes"] or diff["pixels"] or diff["missing"]:
        raise SystemExit("19: the splat scene is not the JAX writer's, byte for byte")
    t = time.perf_counter()
    out = qst.train_and_evaluate(train_json, test_json, QUALITY_NERF, evals, 0, dev)
    sync()
    wall = time.perf_counter() - t
    launched = {w.__name__: w.launches for w in (row_gather, row_scatter_add, splat)}
    log(f"19: field trained in {out['train_seconds']:.2f} s, {wall:.2f} s with the evaluations; " + "; ".join(
        f"{k}: PSNR {m['PSNR']:.3f} SSIM {m['SSIM']:.4f} min {m['min_PSNR']:.3f} ({m['eval_seconds']:.2f} s)"
        for k, m in out["evals"].items()))

    # launches from the code: one K8 launch a view set; the training's gathers and scatter-adds; each
    # evaluation's 2 gathers a chunk of each 8-frame group's sphere hits
    want_g, want_s = expected_train_launches(NerfConfig(**QUALITY_NERF))
    eval_want = [expected_narrow_eval_gathers(test_json, NerfConfig(**kw), dev) for kw in evals.values()]
    want = {"row_gather": want_g + sum(e for e, _ in eval_want), "row_scatter_add": want_s, "splat": 2}
    log(f"19 predicted: {want} (row_gather: {want_g} training + the evaluations' 2 a chunk of "
        f"{render_mod._default_chunk(NerfConfig())} sphere hits {[h for _, h in eval_want]}); launched {launched}")
    if launched != want:
        raise SystemExit("19: the quality path's launches are not the ones the code predicts")
    base = black_psnr(test_json)
    psnrs = [m["PSNR"] for m in out["evals"].values()]
    log(f"19: PSNRs {[round(p, 3) for p in psnrs]} dB against an all-black frame's {base:.3f} dB (need >= "
        f"{QUALITY_PSNR_MARGIN_DB} dB above: the smallest margin {min(psnrs) - base:.3f})")
    if not all(math.isfinite(p) and p >= base + QUALITY_PSNR_MARGIN_DB for p in psnrs):
        raise SystemExit("19: an evaluation is not finite or does not beat a black frame by the margin")
    for k, name in ((k_gather, "row_gather"), (k_scatter, "row_scatter_add"), (k_splat, "splat")):
        k["launches_quality"] = launched[name]
    log(f"phase 19 ({card}) took {time.perf_counter() - t_phase:.1f} s; launches: {launched}")


HD_OBJECT = "blo0"  # a committed train object (label 28) of the smallest family: 80,000 points
HD_TIMED_FRAMES = (16, 5)  # K8 timed at the hd dataset's and the live predictor's view sets
HD_BUDGET_ATOL = 1e-4  # 20b: card against CPU continuous budget, in views (phase 12a's f32 forward: logit gap 0)
HD_APPLICATION = (2, 1)  # 20c: one regression application of 2 micro-steps of 1 object (5 views at 720^2)


def phase_hd(dev, root: str, k_splat: dict, card: str) -> None:
    """(20) The hd arm at a cut size: (a) one small family object's hd
    5-view set at 1280x720 through ``corpus_dataset.render_hd_sets`` (its
    size test and one K8 launch, counted against the code; the launch's
    kept frames bit-equal to ``splat_plain``), and K8 timed at the hd sets'
    shapes; (b) ``HDPredictor`` around a fresh tiny@720 predictor, sent to
    the hd set, its budget on the card against the CPU's; (c) one tiny@720
    regression application at one object a micro-step, with accumulation,
    timed."""
    from PIL import Image

    from nerf_prv_tpu_torch.experiments import corpus_dataset, label_protocol, prvnet_recipe
    from nerf_prv_tpu_torch.experiments.families import make_family_object
    from nerf_prv_tpu_torch.experiments.mode7_compare import HDPredictor

    t_phase = time.perf_counter()
    log(f"== phase 20: the hd arm ({HD_OBJECT}'s hd 5-view set at {CAMERA.width}x{CAMERA.height}, HDPredictor, "
        f"one tiny@720 regression application of {HD_APPLICATION[0]} x {HD_APPLICATION[1]} objects)")
    ws = os.path.join(root, "hd")
    cfg = label_protocol.pipeline_config(ws)
    label_protocol.install_reference_viewspace(cfg, [5, corpus_dataset.HD_VIEWS], probe=False)
    object_setup_mod._ensure_viewspace(cfg.viewspace_path, cfg.num_of_views, dev)  # the 540 views, not timed
    obj_cfg = cfg.replace(name_of_pcd=HD_OBJECT)
    sync()
    renders, size_tests = [], []
    splat.launches = 0
    t = time.perf_counter()
    with corpus_recorders(renders, [], size_tests):
        make_family_object(HD_OBJECT, label_protocol.model_dir(cfg))
        scene = load_object(obj_cfg, HD_OBJECT, device=dev)
        if not scene.ok:
            raise SystemExit(f"20a: {HD_OBJECT} did not load")
        corpus_dataset.render_hd_sets(scene, obj_cfg, hd_train=False, device=dev)
    sync()
    launched = splat.launches
    hd5 = os.path.join(corpus_dataset.hd_path(obj_cfg), str(corpus_dataset.HD_INIT_VIEWS))
    sizes = {Image.open(os.path.join(hd5, f"rgbaClip_{i}.png")).size for i in range(corpus_dataset.HD_INIT_VIEWS)}
    log(f"20a: {HD_OBJECT} ({len(scene.points)} points) loaded and its hd 5-view set written in "
        f"{time.perf_counter() - t:.2f} s; K8 launches {launched} (predicted {len(size_tests)} size tests + 1 set); "
        f"PNG sizes {sizes}")
    if launched != len(size_tests) + 1 or sizes != {(CAMERA.width, CAMERA.height)}:
        raise SystemExit("20a: the hd set's launches or its images are not the ones the code predicts")
    check_mode21_frames(renders, dev, where="20a")
    pts = torch.from_numpy(np.asarray(scene.points, np.float32)).to(dev)
    col = _colors01(scene.colors, len(pts), dev)
    hd_rows = []
    for frames in HD_TIMED_FRAMES:
        vs = ViewSpace(_ensure_viewspace(cfg.viewspace_path, frames, dev), scene.points, cfg.view_space_radius)
        w2c = _world_to_camera(camera_to_world(np.asarray(vs.views), scene.object_center)).to(dev)
        hd_rows.append(splat_row(pts, col, w2c, True, cfg.points_size_cloud, card))
    del pts, col

    torch.manual_seed(PRV_SEED)
    sd = make_pvbnet(PRV_ARCH).state_dict()
    asked = []

    class Recorded(BudgetPredictor):
        def predict_from_coverage(self, coverage_dir, view_ids):
            asked.append(coverage_dir)
            return super().predict_from_coverage(coverage_dir, view_ids)

    card_pred = Recorded(params=sd, arch=PRV_ARCH, crop=prvnet_recipe.HD_CROP, device=dev)
    qcam5 = os.path.join(obj_cfg.gt_path, "5")
    t = time.perf_counter()
    budget = HDPredictor(card_pred).predict_from_coverage(qcam5, PRV_CASE)
    sync()
    call_s = time.perf_counter() - t
    views = card_pred.coverage_views(hd5, PRV_CASE)
    card_value = card_pred.predict_value_from_arrays(views)
    cpu_value = BudgetPredictor(params=sd, arch=PRV_ARCH, crop=prvnet_recipe.HD_CROP,
                                device="cpu").predict_value_from_arrays(views)
    log(f"20b: HDPredictor asked for {qcam5} read {asked} (views {views.shape}); budget {budget} from "
        f"{card_value:.6f} on the card against {cpu_value:.6f} on the CPU (|diff| {abs(card_value - cpu_value):.2e} "
        f"views, need <= {HD_BUDGET_ATOL}); the call {call_s:.3f} s")
    if asked != [hd5] or abs(card_value - cpu_value) > HD_BUDGET_ATOL or budget != int(np.round(card_value)):
        raise SystemExit("20b: HDPredictor did not read the hd set, or the card's budget is not the CPU's")
    del card_pred

    micro_steps, objects = HD_APPLICATION
    tcfg = dataclasses.replace(prvnet_recipe.tiny720_regression_config(), batch_size=micro_steps * objects,
                               accum_steps=micro_steps)
    model = prv_train_mod.init_model(tcfg, len(prvnet_recipe.PATTERN)).to(dev)
    step = prv_train_mod.make_train_step(model, tcfg, mesh=make_mesh(devices=[dev]))
    x = torch.as_tensor(np.stack([load_rgb(os.path.join(hd5, f"rgbaClip_{i}.png"), tcfg.image_size)
                                  for i in prvnet_recipe.PATTERN]), device=dev)[None].repeat(objects, 1, 1, 1, 1)
    y = torch.full((objects,), float(corpus_dataset.corpus_roster()["labels"][HD_OBJECT]), device=dev)
    before = [p.detach().clone() for p in model.parameters()]
    times = []
    for _ in range(2):  # the first application warms cuDNN up
        sync()
        t = time.perf_counter()
        losses = [float(step(x, y)) for _ in range(micro_steps)]
        sync()
        times.append(time.perf_counter() - t)
    moved = sum(not torch.equal(a, b) for a, b in zip(before, model.parameters()))
    log(f"20c: tiny@720 regression application ({micro_steps} micro-steps of {objects} object x "
        f"{len(prvnet_recipe.PATTERN)} views at {tcfg.image_size}^2): {times[1]:.3f} s (the first, warming up, "
        f"{times[0]:.3f} s); losses {losses}; {moved} of {len(before)} parameter tensors moved; applications "
        f"{step.count}; peak memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB ({card})")
    if step.count != 2 or not all(map(math.isfinite, losses)) or moved == 0:
        raise SystemExit("20c: the accumulated application did not apply, or its loss is not finite")
    del model, step, before, x
    k_splat["launches_hd"] = launched
    k_splat["hd_shapes"] = hd_rows
    log(f"phase 20 ({card}) took {time.perf_counter() - t_phase:.1f} s; launches: splat {launched}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--k1", action="append", default=[], metavar="NAME=SOURCE.cu",
                        help="only compare these builds of the hash-encode kernel with the tree's")
    parser.add_argument("--k1b", action="append", default=[], metavar="NAME=SOURCE.cu",
                        help="only compare these builds of the table-gradient kernel with the tree's")
    parser.add_argument("--k8", action="append", default=[], metavar="NAME=SOURCE.cu",
                        help="only compare these builds of the point-splat kernel with the tree's")
    parser.add_argument("--k9", action="append", default=[], metavar="NAME=SOURCE.cu",
                        help="only compare these builds of the occupancy ray-cast kernel with the tree's")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    phase_build()
    card = card_line()
    log(card)
    if args.k1:
        compare_k1(dev, args.k1, card)
        return 0
    if args.k1b:
        compare_k1b(dev, args.k1b, card)
        return 0
    if args.k8 or args.k9:
        if args.k8:
            compare_k8(dev, args.k8, card)
        if args.k9:
            compare_k9(dev, args.k9, card)
        return 0
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        train_json = write_scene(root, dev, "train", N_TRAIN_FRAMES, turn=0.0)
        test_json = write_scene(root, dev, "test", N_TEST_FRAMES, turn=0.5)
        source = BatchSource(load_dataset(train_json), dev)
        cfg, params = make_hash_field(dev)
        k_hash = phase_kernel_check(dev, params, load_dataset(test_json), cfg)
        k_bwd = phase_backward_kernel(dev, params, source, k_hash)
        k_gather, k_scatter, tight_us = phase_row_kernels(dev, source)
        k_frames = phase_frames_u8(dev)
        rows = [r for k in (k_hash, k_bwd, k_gather, k_scatter, k_frames) for r in k["shapes"]]
        compared = sum(bool(r.get("call_checked")) for r in rows)
        log(f"device time against call time: compared on {compared} of {len(rows)} shapes")
        if compared == 0:
            raise SystemExit("the host is too slow to hold any device time against its call time")
        params, ds = phase_serve(dev, root, test_json, cfg, params, k_hash, card)
        phase_serve_vs_plain(params, ds, cfg)
        del params
        vparams, vcfg, test_ds, single_ms = phase_train(
            dev, root, train_json, test_json, source, k_gather, k_scatter, k_frames, tight_us, card)
        phase_step_vs_plain(dev, vparams, vcfg, source, test_ds)
        hparams, hcfg = phase_hash_train(dev, root, train_json, test_json, source, k_hash, k_bwd, card)
        phase_hash_step_vs_plain(dev, hparams, hcfg, source)
        del hparams
        phase_options(dev, root, train_json, vparams, vcfg, test_ds, card)
        del vparams
        k_splat, k_cast = phase_coverage(dev, root, card)
        phase_batch(dev, root, source, k_gather, k_scatter, k_frames, k_hash, k_bwd, single_ms, card)
        phase_prv(dev, root, [k_hash, k_bwd, k_gather, k_scatter, k_splat, k_cast], card)
        phase_prv_train(dev, root, [k_hash, k_bwd, k_gather, k_scatter, k_splat, k_cast], card)
        phase_multidevice(dev, root, source, k_gather, k_scatter, card)
        phase_corpus(dev, root, k_gather, k_scatter, k_splat, card)
        phase_eval(dev, root, k_gather, k_scatter, k_splat, card)
        phase_real_object(dev, root, k_gather, k_scatter, k_splat, card)
        phase_e2e(dev, root, k_gather, k_scatter, k_splat, card)
        phase_quality(dev, root, k_gather, k_scatter, k_splat, card)
        phase_hd(dev, root, k_splat, card)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": [k_hash, k_bwd, k_gather, k_scatter, k_splat, k_cast, k_frames]}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
