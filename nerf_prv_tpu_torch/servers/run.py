"""CLI-compatible NeRF runner.

Counterpart of ``servers/run.py``: a drop-in for the patched instant-ngp
``run.py`` the reference drives (``Instantngp_scripts/run.py:27-74``), with
the same flags for the subset the pipeline uses (--train, --n_steps, --scene,
--test_transforms, --save_metrics, --screenshot_transforms,
--screenshot_dir), backed by the port's in-process NeRF on ``--device``.

    python -m nerf_prv_tpu_torch.servers.run --scene train.json --test_transforms test.json
"""

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="NeRF runner (run.py-compatible)")
    p.add_argument("files", nargs="*")
    p.add_argument("--scene", "--training_data", default="")
    p.add_argument("--train", action="store_true")
    p.add_argument("--n_steps", type=int, default=2500)
    p.add_argument("--test_transforms", default="")
    p.add_argument("--save_metrics", default="")
    p.add_argument("--screenshot_transforms", default="")
    p.add_argument("--screenshot_dir", default="")
    p.add_argument("--screenshot_spp", type=int, default=16)  # accepted, ignored
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    # snapshot / geometry / video extras (≙ run.py:36-43)
    p.add_argument("--save_snapshot", default="")
    p.add_argument("--load_snapshot", default="")
    p.add_argument("--save_mesh", default="")
    p.add_argument("--marching_cubes_res", type=int, default=128)
    p.add_argument("--video_camera_path", default="")
    p.add_argument("--video_output", default="video.mp4")
    p.add_argument("--video_fps", type=int, default=30)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..nerf.api import run

    metrics = run(
        args.scene,
        n_steps=args.n_steps,
        test_transforms=args.test_transforms or None,
        save_metrics_path=args.save_metrics or None,
        screenshot_transforms=args.screenshot_transforms or None,
        screenshot_dir=args.screenshot_dir or None,
        seed=args.seed,
        load_snapshot_path=args.load_snapshot or None,
        save_snapshot_path=args.save_snapshot or None,
        save_mesh_path=args.save_mesh or None,
        marching_cubes_res=args.marching_cubes_res,
        video_camera_path=args.video_camera_path or None,
        video_output=args.video_output,
        video_fps=args.video_fps,
        device=args.device,
    )
    if metrics:
        print(f"PSNR={metrics['PSNR']} SSIM={metrics['SSIM']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
