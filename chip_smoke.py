"""Drive the PyTorch port's serving path on one NVIDIA GPU and hold every
kernel on it against its plain PyTorch version.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases: (1) build the kernels from ``nerf_prv_tpu_torch/ops/csrc``;
(2) each kernel against its plain version at the path's full shapes, and
timed; (3) serve a random full-width hash-field snapshot at 1280x720
through ``run(load_snapshot_path=...)``, count the kernel launches it
made, time one ``eval_nerf`` and profile another (device time by kernel);
(4) one frame rendered through the kernel against the same frame
rendered through the plain encode, and two small f32 frames rendered on
the card against the CPU.  Any failure exits non-zero.  The line
before the last is the kernel table as JSON, the last line the device.
It imports nothing of JAX or of ``nerf_prv_tpu``.
"""

from __future__ import annotations

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
from nerf_prv_tpu_torch.nerf.api import eval_nerf, load_snapshot, run, save_snapshot  # noqa: E402
from nerf_prv_tpu_torch.nerf.hashgrid import (  # noqa: E402
    _CORNERS, HashGridConfig, _corner_indices, encode, init_table,
)
from nerf_prv_tpu_torch.nerf.metrics import mse2psnr  # noqa: E402
from nerf_prv_tpu_torch.nerf.model import NerfConfig, init_params  # noqa: E402
from nerf_prv_tpu_torch.nerf.rays import grid_cameras, load_dataset, pixel_dirs_cam, ray_sphere  # noqa: E402
from nerf_prv_tpu_torch.nerf.render import render_views  # noqa: E402
from nerf_prv_tpu_torch.ops import _build  # noqa: E402
from nerf_prv_tpu_torch.ops.hash_encode import hash_encode  # noqa: E402

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
N_FRAMES = 16


def log(*a):
    print(*a, flush=True)


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
    logs = _build.build(["hash_encode"])
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
    log("== phase 2: hash_encode kernel against hashgrid.encode")
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
    torch.cuda.synchronize()
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


def write_scene(root: str, dev) -> str:
    """16 hemisphere views at 1280x720 of an analytic coloured sphere,
    written as a transforms.json test set with RGBA PNGs."""
    from PIL import Image

    cam = CameraConfig()
    center = np.full(3, 1e-4)
    tf_root = make_root(cam, 1, 0.05, center)  # scale 10: the bounding sphere at 3 units
    i = np.arange(N_FRAMES) + 0.5
    z = i / N_FRAMES
    phi = i * math.pi * (3.0 - math.sqrt(5.0))
    dirs = np.stack([np.sqrt(1 - z * z) * np.cos(phi), np.sqrt(1 - z * z) * np.sin(phi), z], -1)
    c2w = camera_to_world(dirs * 0.3 + center, center)
    os.makedirs(os.path.join(root, "test"), exist_ok=True)
    for k in range(N_FRAMES):
        add_frame(tf_root, f"test/r_{k}", c2w[k])  # extensionless, Blender style
    path = os.path.join(root, "test.json")
    write_transforms(path, tf_root)

    origins, rotations = grid_cameras(load_transforms(path))
    u, v = torch.meshgrid(
        torch.arange(cam.width, dtype=torch.float32, device=dev),
        torch.arange(cam.height, dtype=torch.float32, device=dev),
        indexing="xy",
    )
    d_cam = pixel_dirs_cam(cam, u.reshape(-1), v.reshape(-1))
    for k in range(N_FRAMES):
        d = d_cam @ torch.as_tensor(rotations[k], device=dev).T
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        o = torch.as_tensor(origins[k], device=dev).expand_as(d)
        tmin, _, hit = ray_sphere(o, d, center=0.5, radius=0.3)
        p = o + d * tmin[:, None]
        rgb = torch.clamp((p - 0.5) / 0.3 * 0.5 + 0.5, 0, 1) * hit[:, None]
        rgba = torch.cat([rgb, hit[:, None].float()], -1).reshape(cam.height, cam.width, 4)
        u8 = torch.round(rgba * 255).to(torch.uint8).cpu().numpy()
        Image.fromarray(u8, "RGBA").save(os.path.join(root, "test", f"r_{k}.png"))
    return path


def phase_serve(dev, root: str, kernel: dict, card: str):
    log("== phase 3: serve a full-width hash-field snapshot at 1280x720")
    test_json = write_scene(root, dev)
    cfg = NerfConfig(field_impl="hash", encode_impl="fused")
    params = init_params(torch.Generator(device=dev).manual_seed(1), cfg, device=dev)
    # init_params' table is +-1e-4, which leaves the MLPs blind to the
    # encode; at +-1 the renders below depend on every level of K1's output
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
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernel["launches"] = hash_encode.launches
    log(f"run: {wall:.2f} s, metrics {metrics}, hash_encode launches {hash_encode.launches}")
    if not all(math.isfinite(metrics[k]) for k in ("PSNR", "SSIM", "PSNR_avgmse")):
        raise SystemExit(f"non-finite metrics {metrics}")
    if not os.path.exists(metrics_path):
        raise SystemExit("run wrote no metrics file")
    pngs = sorted(os.listdir(shots))
    if len(pngs) != N_FRAMES:
        raise SystemExit(f"expected {N_FRAMES} screenshots, found {pngs}")
    if kernel["launches"] == 0:
        raise SystemExit("the serving path launched no hash_encode kernel")

    params = load_snapshot(snap, cfg, device=dev)
    ds = load_dataset(test_json)
    hash_encode.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eval_nerf(params, ds, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rays = ds.n_frames * ds.camera.height * ds.camera.width
    log(
        f"eval_nerf: {N_FRAMES} frames {ds.camera.width}x{ds.camera.height} in {dt:.4f} s = {rays / dt:.6e} rays/s, "
        f"{hash_encode.launches} hash_encode launches ({card})"
    )
    profile_eval(params, ds, cfg, dt)
    return params, ds, cfg


def profile_eval(params, ds, cfg, eval_s: float):
    """Device time by kernel over one eval, and the device's busy share
    of ``eval_s``, the same eval's wall time without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eval_nerf(params, ds, cfg)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:  # kernels and copies, not host ops
            us, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.device_time_total, count + 1)
    busy = sum(us for us, _ in by_name.values())
    log(f"profile of one eval_nerf: device busy {busy:.0f} us = {busy / (eval_s * 1e6):.4f} "
        f"of the un-profiled eval wall {eval_s * 1e6:.0f} us (profiled wall {wall_us:.0f} us)")
    for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]:
        log(f"  {us:12.0f} us  {count:6d}x  {name[:100]}")


def phase_serve_vs_plain(params, ds, cfg):
    log("== phase 4: renders through the kernel against the plain encode and the CPU")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    phase_build()
    card = card_line()
    log(card)
    kernel = phase_kernel_check(dev)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        params, ds, cfg = phase_serve(dev, root, kernel, card)
        phase_serve_vs_plain(params, ds, cfg)
    log(card)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
