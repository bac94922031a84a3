"""Camera configuration and the OpenCV-YAML parser it is read with.

A copy of the camera half of ``nerf_prv_tpu/core/config.py`` (the port
imports nothing of the JAX package).  The pipeline-wide ``Config`` is not
ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
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
