"""Drive the PyTorch port's training and serving paths on one NVIDIA GPU and
hold every kernel on them against its plain PyTorch version.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases:
(1) build the three kernels from ``nerf_prv_tpu_torch/ops/csrc``, one nvcc
    process each, started together;
(2) each kernel against its plain version at the paths' full shapes, timed
    beside its bound and the library call for the same work:
    ``hash_encode`` against ``hashgrid.encode``; ``row_gather`` (exact) and
    ``row_scatter_add`` (against ``index_add_`` and a float64 sum, on
    uniform and on ray-ordered indices) against theirs;
(3) serve a random full-width hash-field snapshot at 1280x720 through
    ``run(load_snapshot_path=...)`` on 4 frames, count its launches, time
    one ``eval_nerf`` and profile another;
(4) one hash frame through the kernel against the plain encode, and two
    small f32 frames on the card against the CPU;
(5) train the default full-width voxel field through ``run(scene, ...)``
    on 16 frames at 1280x720 for the full 2,500 steps, score it on 4
    held-out frames and write screenshots; check the losses, the PSNR and
    the launch counts; time and profile steps and one eval;
(6) one training step through the kernels against the same step through
    the plain versions (loss and every gradient), the same through two
    deliberately broken kernels (which must fail), and one small f32 voxel
    frame on the card against the CPU.
Any failure exits non-zero.  The line before the last is the kernel table
as JSON, the last line the device.  It imports nothing of JAX or of
``nerf_prv_tpu``.
"""

from __future__ import annotations

import contextlib
import dataclasses
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

from nerf_prv_tpu_torch.core.config import CameraConfig  # noqa: E402
from nerf_prv_tpu_torch.core.pose import camera_to_world  # noqa: E402
from nerf_prv_tpu_torch.core.transforms import (  # noqa: E402
    add_frame, load_transforms, make_root, scaled_camera, write_transforms,
)
from nerf_prv_tpu_torch.nerf import api as api_mod  # noqa: E402
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
from nerf_prv_tpu_torch.ops.hash_encode import hash_encode  # noqa: E402
from nerf_prv_tpu_torch.ops.row_gather import row_gather, row_gather_plain  # noqa: E402
from nerf_prv_tpu_torch.ops.row_scatter_add import row_scatter_add, row_scatter_add_plain  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and f32 rate
# outside the tensor cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

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


def log(*a):
    print(*a, flush=True)


def sync():
    torch.cuda.synchronize()


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def phase_build():
    log("== phase 1: build")
    t0 = time.perf_counter()
    logs = _build.build(["hash_encode", "row_gather", "row_scatter_add"])
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


def phase_kernel_check(dev) -> dict:
    log("== phase 2a: hash_encode kernel against hashgrid.encode")
    cfg = HashGridConfig()
    g = torch.Generator(device=dev).manual_seed(0)
    table = init_table(g, cfg, scale=1.0, device=dev)
    n = MARCH_N + 37  # not a multiple of any block
    x = torch.rand((n, 3), generator=g, device=dev)
    x[:5] = torch.tensor(
        [[0.0, 0.0, 0.0], [1 - 1e-6] * 3, [1.0, 1.0, 1.0], [0.0, 1.0, 1 - 1e-6], [1.0, 0.5, 0.0]],
        device=dev,
    )
    got = hash_encode(table, x, cfg)
    want = encode(table, x, cfg)
    sync()
    err = (got - want).abs().reshape(n, cfg.levels, cfg.features).amax(dim=(0, 2)).cpu()
    log("max |kernel - plain| per level: " + " ".join(f"{e:.2e}" for e in err.tolist()))
    if not (torch.isfinite(got).all() and bool((err <= ENCODE_TOL).all())):
        raise SystemExit(f"hash_encode disagrees with hashgrid.encode beyond {ENCODE_TOL}")
    max_err = float(err.max())

    xm, xp = x[:MARCH_N].contiguous(), x[:PROBE_N].contiguous()
    ms = time_ms(lambda: hash_encode(table, xm, cfg), iters=50)
    ms_probe = time_ms(lambda: hash_encode(table, xp, cfg), iters=50)
    plain_ms = time_ms(lambda: encode(table, xm, cfg), iters=5, warmup=1)
    bound_ms, bound_by = encode_bound_ms(xm, cfg)
    bound_probe, _ = encode_bound_ms(xp, cfg)
    log(
        f"hash_encode march N={MARCH_N}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}); probe N={PROBE_N}: kernel {ms_probe:.4f} ms, "
        f"bound {bound_probe:.4f} ms"
    )
    return dict(
        name="hash_encode", route="cuda",
        source="nerf_prv_tpu_torch/ops/csrc/hash_encode.cu",
        replaces="nerf_prv_tpu/ops/hash_encode.py:31",
        launches=0, max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
    )


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


def ray_ordered_indices(source: BatchSource, cfg: NerfConfig, n_samples: int, seed: int = 3):
    """Grid row indices of one real training batch, ray by ray: cfg.train_rays
    rays drawn from the scene's hit pool, ``n_samples`` stratified samples
    along each ray's chord, through ``cell_and_frac``."""
    dev = source.pixels.device
    (o, d, _, _), jitter = source.draw(torch.Generator(device=dev).manual_seed(seed), cfg, n_samples)
    tmin, tmax, _ = ray_sphere(o, d)
    base = torch.arange(n_samples, dtype=torch.float32, device=dev)[None, :]
    ts = tmin[:, None] + (base + jitter) * ((tmax - tmin) / n_samples)[:, None]
    pos = torch.clamp(o[:, None, :] + d[:, None, :] * ts[..., None], 0.0, 1.0 - 1e-6)
    idx, _ = voxelfield.cell_and_frac(pos.reshape(-1, 3), cfg.voxel_grid_size)
    return idx.contiguous()


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


def check_gather(table, idx, note) -> dict:
    """One row_gather shape: exact equality with the plain version, then
    kernel, plain, library and bound times."""
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
    row = dict(shape=label, max_abs_err=err, bound_ms=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0)
    if idx.numel():
        row.update(
            ms=time_ms(lambda: row_gather(table, idx), iters=50),
            plain_ms=time_ms(lambda: row_gather_plain(table, idx), iters=20),
            library_ms=time_ms(lambda: torch.index_select(table, 0, idx), iters=20),
            bound_ms=gather_bound_ms(table, idx),
        )
    log(f"row_gather {label}: equal; kernel {row['ms']:.4f} ms, table[idx] {row['plain_ms']:.4f} ms, "
        f"index_select {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms (bytes)")
    return row


def check_scatter(idx, upd, n_rows, label) -> dict:
    """One row_scatter_add shape against index_add_ and a float64 sum.

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
    row = dict(shape=label, max_abs_err=vs_plain, ms=0.0, plain_ms=0.0, library_ms=0.0)
    row["bound_ms"], row["bound_by"] = scatter_bound_ms(idx, upd, n_rows)
    if idx.numel():
        zero = torch.zeros((n_rows, upd.shape[1]), dtype=torch.float32, device=upd.device)
        row.update(
            ms=time_ms(lambda: row_scatter_add(idx, upd, n_rows), iters=50),
            plain_ms=time_ms(lambda: row_scatter_add_plain(idx, upd, n_rows), iters=20),
            library_ms=time_ms(lambda: torch.index_add(zero, 0, idx, upd), iters=20),
        )
    log(f"row_scatter_add {label}: max rows' updates {int(count.max())}, |kernel - f64| max "
        f"{float(err.max()):.3e} (bound {float(tol.max()):.3e}), |kernel - index_add_| {vs_plain:.3e}; "
        f"kernel {row['ms']:.4f} ms, zeros+index_add_ {row['plain_ms']:.4f} ms, "
        f"index_add {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
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
    # the wrappers do not clamp: the range is checked here, once, on the
    # indices cell_and_frac gives a real batch
    for name, idx in (("96", ray96), ("tight", ray_tight), ("warmup", ray_warm)):
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi >= n_rows:
            raise SystemExit(f"cell_and_frac gave a row outside [0, {n_rows}): {lo}..{hi}")
    runs = float((ray96[1:] != ray96[:-1]).sum() + 1)
    log(f"ray-ordered indices, {cfg.train_rays} rays x 96: {ray96.numel() / runs:.2f} consecutive "
        f"samples per cell, {int(torch.unique(ray96).numel())} distinct rows, range ok")

    gathers = [
        check_gather(grid_bf, ray_tight, "tight-step march, ray-ordered"),
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
        check_scatter(uniform(0), upd(0), n_rows, "N=0"),
    ]
    gather = dict(
        name="row_gather", route="cuda",
        source="nerf_prv_tpu_torch/ops/csrc/row_gather.cu",
        replaces="experiments/exp_vmem_gather.py:72",
        launches=0, bound_by="bytes", **{k: gathers[0][k] for k in
                                        ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")},
        shape=gathers[0]["shape"], shapes=gathers,
    )
    scatter = dict(
        name="row_scatter_add", route="cuda",
        source="nerf_prv_tpu_torch/ops/csrc/row_scatter_add.cu",
        replaces="experiments/exp_scatter_kernel.py:120",
        also_replaces=["experiments/exp_scatter_banks.py:60", "experiments/exp_vmem_gather.py:124"],
        launches=0, **{k: scatters[0][k] for k in
                       ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        shape=scatters[0]["shape"], shapes=scatters,
    )
    return gather, scatter


def spiral_views(n: int, turn: float) -> np.ndarray:
    """``n`` unit view directions on a Fibonacci spiral over the upper
    hemisphere; another ``turn`` gives another, interleaved set."""
    i = np.arange(n) + 0.5
    z = i / n
    phi = (i + turn) * math.pi * (3.0 - math.sqrt(5.0))
    return np.stack([np.sqrt(1 - z * z) * np.cos(phi), np.sqrt(1 - z * z) * np.sin(phi), z], -1)


def write_scene(root: str, dev, name: str, n_frames: int, turn: float) -> str:
    """Hemisphere views of an analytic coloured sphere at the camera's full
    size, written as ``<name>.json`` with RGBA PNGs."""
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
        rgb = torch.clamp((p - 0.5) / 0.3 * 0.5 + 0.5, 0, 1) * hit[:, None]
        rgba = torch.cat([rgb, hit[:, None].float()], -1).reshape(cam.height, cam.width, 4)
        u8 = torch.round(rgba * 255).to(torch.uint8).cpu().numpy()
        Image.fromarray(u8, "RGBA").save(os.path.join(root, name, f"r_{k}.png"))
    return path


def phase_serve(dev, root: str, test_json: str, kernel: dict, card: str):
    log(f"== phase 3: serve a full-width hash-field snapshot at {CAMERA.width}x{CAMERA.height}")
    cfg = NerfConfig(field_impl="hash", encode_impl="fused")
    params = init_params(torch.Generator(device=dev).manual_seed(1), cfg, device=dev)
    # init_params' table is +-1e-4, which leaves the MLPs blind to the
    # encode; at +-1 the renders below depend on every level of the output
    params["table"] *= 1e4
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
    return params, ds, cfg


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
    ("own kernels", ("hash_encode_kernel", "row_gather_kernel", "row_scatter_add_kernel")),
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


def profile_device(fn, label: str, wall_s: float, top: int = 20, tries: int = 3):
    """Device time by kernel over one call of ``fn``, and the device's busy
    share of ``wall_s``, the same call's wall time without the profiler.

    A trace can lose events (on a loaded host the same work has shown a
    third less device time), so the trace counts the port's own kernels
    and is taken again, up to ``tries`` times, until that count equals the
    launches the wrappers counted; the line printed says which it was.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wrappers = (hash_encode, row_gather, row_scatter_add)
    for attempt in range(1, tries + 1):
        sync()
        before = sum(w.launches for w in wrappers)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        wall_us = (time.perf_counter() - t0) * 1e6
        launched = sum(w.launches for w in wrappers) - before
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
    for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"  {us:12.0f} us  {count:6d}x  {name[:100]}")


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


def expected_train_launches(cfg: NerfConfig) -> tuple:
    """(row_gather, row_scatter_add) launches of one ``train`` from scratch:
    a warmup step gathers once (the march) and a tight step twice (the
    no-grad probe, then the march); every step scatter-adds once."""
    n_warm = min(cfg.train_warmup_steps, cfg.n_steps) if cfg.train_coarse > 0 else 0
    probes = 2 if cfg.train_coarse > 0 else 1
    return n_warm + probes * (cfg.n_steps - n_warm), cfg.n_steps


def time_steps(params, cfg: NerfConfig, source: BatchSource, n: int, seed: int) -> float:
    """Mean wall ms of ``n`` optimizer steps at ``cfg`` on a copy of
    ``params``, sampling as ``train`` does (host clock around a sync)."""
    step = make_stepper(params, cfg, source, seed)
    for _ in range(3):
        step()
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    sync()
    return (time.perf_counter() - t0) / n * 1e3


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


def black_psnr(ds) -> float:
    """Mean per-frame PSNR of an all-black render against the test set."""
    gt = ds.pixels[..., :3] * ds.pixels[..., 3:4]
    return float(np.mean([-10.0 * math.log10(float(np.mean(f ** 2))) for f in gt]))


def phase_train(dev, root: str, train_json: str, test_json: str, source: BatchSource,
                gather: dict, scatter: dict, card: str):
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
    profile_device(step, "one tight training step", tight_ms * 1e-3)
    t_cast = time_ms(lambda: params["grid"].to(torch.bfloat16), iters=50)
    log(f"grid f32 -> bf16 cast (twice per tight step, once per render chunk): {t_cast:.4f} ms")
    return params, cfg, test_ds


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


def main() -> int:
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
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        train_json = write_scene(root, dev, "train", N_TRAIN_FRAMES, turn=0.0)
        test_json = write_scene(root, dev, "test", N_TEST_FRAMES, turn=0.5)
        source = BatchSource(load_dataset(train_json), dev)
        k_hash = phase_kernel_check(dev)
        k_gather, k_scatter = phase_row_kernels(dev, source)
        params, ds, cfg = phase_serve(dev, root, test_json, k_hash, card)
        phase_serve_vs_plain(params, ds, cfg)
        del params
        vparams, vcfg, test_ds = phase_train(
            dev, root, train_json, test_json, source, k_gather, k_scatter, card)
        phase_step_vs_plain(dev, vparams, vcfg, source, test_ds)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": [k_hash, k_gather, k_scatter]}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
