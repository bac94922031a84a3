"""Typed configuration: the camera, the pipeline-wide ``Config`` and the
OpenCV-YAML parser both are read with.

A copy of ``nerf_prv_tpu/core/config.py`` (the port imports nothing of the
JAX package): the same fields, defaults, YAML renames and paths.
"""

from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass, field
from typing import Dict


def _parse_opencv_yaml(text: str) -> Dict[str, object]:
    """Parse the flat key:value subset of OpenCV's YAML 1.0 dialect."""
    out: Dict[str, object] = {}
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line or line.startswith("%"):
            continue
        if ":" not in line:
            continue
        key, _, val = line.partition(":")
        key = key.strip()
        val = val.strip()
        if not val:
            continue
        if val.startswith('"') and val.endswith('"') and len(val) >= 2:
            out[key] = val[1:-1]
            continue
        try:
            out[key] = int(val)
            continue
        except ValueError:
            pass
        try:
            out[key] = float(val)
            continue
        except ValueError:
            pass
        out[key] = val
    return out


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole + distortion parameters (≙ ``DefaultConfiguration.yaml:38-49``)."""

    width: int = 1280
    height: int = 720
    fx: float = 915.60668945312500
    fy: float = 913.32666015625000
    ppx: float = 647.14532470703125
    ppy: float = 372.51531982421875
    model: int = 2  # rs2_distortion: 2 = inverse Brown-Conrady
    k1: float = 0.12042199820280075
    k2: float = -0.21373499929904938
    k3: float = 0.0053860000334680080
    p1: float = -0.0021210000850260258
    p2: float = 0.0
    depth_scale: float = 1.0000000474974513e-03

    @property
    def coeffs(self):
        return (self.k1, self.k2, self.k3, self.p1, self.p2)

    @property
    def camera_angle_x(self) -> float:
        return 2.0 * math.atan(0.5 * self.width / self.fx)

    @property
    def camera_angle_y(self) -> float:
        return 2.0 * math.atan(0.5 * self.height / self.fy)


@dataclass(frozen=True)
class Config:
    """Pipeline configuration (≙ ``Share_Data`` members, ``Share_Data.hpp:334-537``).

    Paths are rooted at ``workspace`` instead of the reference's absolute
    Windows paths; everything else keeps the reference's defaults so output
    artifacts (view budgets, labels, metrics) stay comparable.
    """

    # --- paths ------------------------------------------------------------
    workspace: str = "workspace"            # ≙ pre_path
    model_path: str = "3D_models"           # object PLY/PCD inputs
    shape_net: str = "ShapeNetCore.v2"      # raw ShapeNet root
    orginalviews_path: str = "view_space/Tammes_sphere"
    viewspace_path: str = "view_space/Hemisphere"

    # --- object / experiment selection -------------------------------------
    is_shape_net: bool = True
    id_of_batch: int = -1
    name_of_pcd: str = "LM5"
    method_of_IG: int = 0
    test_id: int = 0

    # --- simulation -------------------------------------------------------
    num_of_thread: int = 20
    octomap_resolution: float = 0.00625
    ground_truth_resolution: float = 0.002
    coverage_view_num_max: int = 50
    coverage_view_num_add: int = 2
    points_size_cloud: int = 5
    object_pixel_rate: float = 0.035
    size_min: float = 0.075                 # ShapeNet random-size range (≙ main.cpp:866-870)
    size_max: float = 0.115
    clean_size_min: float = 0.070           # mode 11 filter (≙ main.cpp:3563-3621)
    clean_size_max: float = 0.120

    # --- NeRF training/eval -----------------------------------------------
    n_steps: int = 2500
    evaluate: bool = False
    ensemble_num: int = 5                   # method 3; method 2 uses 2 (≙ Share_Data.hpp:505-510)
    num_of_novel_test_views: int = 100
    ray_casting_aabb_scale: int = 1

    # --- view space ---------------------------------------------------------
    num_of_views: int = 540
    view_space_radius: float = 0.3
    num_of_max_iteration: int = 64
    num_of_choose: int = 64
    num_of_random_test: int = 10

    # --- PRVNet label range (≙ main.cpp:2644-2645, infer_server.py:48-49) ---
    min_label_value: int = 13
    max_label_value: int = 58

    # --- camera -------------------------------------------------------------
    camera: CameraConfig = field(default_factory=CameraConfig)

    # --- misc ---------------------------------------------------------------
    show: bool = False
    seed: int = 0

    # ------------------------------------------------------------------ paths
    def _batch_suffix(self) -> str:
        return f"_{self.id_of_batch}" if self.id_of_batch >= 0 else ""

    @property
    def gt_path(self) -> str:
        """Coverage-image root for the current object (≙ Share_Data gt_path)."""
        if self.is_shape_net:
            return os.path.join(
                self.workspace,
                "Coverage_images",
                f"ShapeNet{self._batch_suffix()}",
                self.name_of_pcd,
            )
        return os.path.join(self.workspace, "Coverage_images", self.name_of_pcd)

    @property
    def save_path(self) -> str:
        """Per-method experiment dir (≙ Share_Data save_path)."""
        sub = "ShapeNet" if self.is_shape_net else "HB"
        return os.path.join(
            self.workspace,
            "Compare",
            sub,
            f"{self.name_of_pcd}_m{self.method_of_IG}",
        )

    @property
    def pvb_dataset_path(self) -> str:
        return os.path.join(self.workspace, "pvb_dataset")

    @property
    def effective_coverage_max(self) -> int:
        """Non-ShapeNet (HB) objects sweep 3..90 step 1 (≙ Share_Data.hpp:
        405-409 overriding the yaml values when !is_shape_net)."""
        return self.coverage_view_num_max if self.is_shape_net else 90

    @property
    def effective_coverage_add(self) -> int:
        return self.coverage_view_num_add if self.is_shape_net else 1

    @property
    def ensemble_num_for_method(self) -> int:
        """EnsembleRGB uses 2 members, EnsembleRGBDensity 5 (≙ Share_Data.hpp:505-510)."""
        if self.method_of_IG == 2:
            return 2
        return self.ensemble_num

    # --------------------------------------------------------------- factory
    @classmethod
    def from_yaml(cls, path: str, **overrides) -> "Config":
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            raw = _parse_opencv_yaml(f.read())
        cam_fields = {f.name for f in dataclasses.fields(CameraConfig)}
        cam_kwargs = {}
        cfg_kwargs = {}
        renames = {
            "color_width": "width",
            "color_height": "height",
            "color_fx": "fx",
            "color_fy": "fy",
            "color_ppx": "ppx",
            "color_ppy": "ppy",
            "color_model": "model",
            "color_k1": "k1",
            "color_k2": "k2",
            "color_k3": "k3",
            "color_p1": "p1",
            "color_p2": "p2",
            "depth_scale": "depth_scale",
        }
        cfg_fields = {f.name for f in dataclasses.fields(cls)}
        for key, val in raw.items():
            if key in renames and renames[key] in cam_fields:
                cam_kwargs[renames[key]] = val
            elif key == "pre_path":
                cfg_kwargs["workspace"] = str(val)
            elif key in ("is_shape_net", "evaluate", "show"):
                cfg_kwargs[key] = bool(val)
            elif key in cfg_fields:
                cfg_kwargs[key] = val
        cfg_kwargs["camera"] = CameraConfig(**cam_kwargs)
        cfg_kwargs.update(overrides)
        return cls(**cfg_kwargs)

    def replace(self, **changes) -> "Config":
        return dataclasses.replace(self, **changes)
