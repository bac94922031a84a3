"""PLY point-cloud IO (XYZ + RGB), numpy only.

Counterpart of ``nerf_prv_tpu/scene/ply.py`` (the port's own copy: that
package's ``scene`` imports JAX).  Supports ascii and binary_little_endian,
vertices with optional color/normal properties; everything else is
ignored.  The reference's optional native loader has no counterpart yet:
:func:`load_ply` is the Python parser.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

_DTYPES = {
    "char": "i1",
    "int8": "i1",
    "uchar": "u1",
    "uint8": "u1",
    "short": "i2",
    "int16": "i2",
    "ushort": "u2",
    "uint16": "u2",
    "int": "i4",
    "int32": "i4",
    "uint": "u4",
    "uint32": "u4",
    "float": "f4",
    "float32": "f4",
    "double": "f8",
    "float64": "f8",
}


def load_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Returns (points (N,3) float64, colors (N,3) uint8 or None)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = "ascii"
        n_vertex = 0
        props = []
        in_vertex = False
        for line in header:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    n_vertex = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                if parts[1] == "list":
                    raise ValueError("list property in vertex element unsupported")
                props.append((parts[2], _DTYPES[parts[1]]))

        names = [p[0] for p in props]
        if fmt == "ascii":
            rows = np.loadtxt(
                f, dtype=np.float64, max_rows=n_vertex, usecols=range(len(props))
            ).reshape(n_vertex, len(props))
            data = {name: rows[:, i] for i, (name, _) in enumerate(props)}
        elif fmt == "binary_little_endian":
            dtype = np.dtype([(name, "<" + dt) for name, dt in props])
            raw = np.frombuffer(f.read(dtype.itemsize * n_vertex), dtype=dtype)
            data = {name: raw[name] for name in names}
        else:
            raise ValueError(f"unsupported ply format {fmt}")

    pts = np.stack(
        [np.asarray(data["x"], np.float64), np.asarray(data["y"], np.float64), np.asarray(data["z"], np.float64)],
        axis=1,
    )
    colors = None
    if all(c in data for c in ("red", "green", "blue")):
        colors = np.stack(
            [data["red"], data["green"], data["blue"]], axis=1
        ).astype(np.uint8)
    elif all(c in data for c in ("r", "g", "b")):
        colors = np.stack([data["r"], data["g"], data["b"]], axis=1).astype(np.uint8)
    return pts, colors


def save_ply_ascii(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None) -> None:
    """Ascii XYZ+RGB writer (≙ main.cpp:3520-3556)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    points = np.asarray(points)
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        if colors is None:
            for p in points:
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        else:
            for p, c in zip(points, np.asarray(colors, np.int64)):
                f.write(
                    f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}\n"
                )


def save_ply_binary(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    points = np.asarray(points, np.float32)
    n = len(points)
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        hdr += ["property float x", "property float y", "property float z"]
        if colors is not None:
            hdr += [
                "property uchar red",
                "property uchar green",
                "property uchar blue",
            ]
        hdr += ["end_header", ""]
        f.write("\n".join(hdr).encode("ascii"))
        if colors is None:
            f.write(points.astype("<f4").tobytes())
        else:
            dtype = np.dtype(
                [("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"), ("green", "u1"), ("blue", "u1")]
            )
            rec = np.empty(n, dtype=dtype)
            rec["x"], rec["y"], rec["z"] = points.T
            cols = np.asarray(colors, np.uint8)
            rec["red"], rec["green"], rec["blue"] = cols.T
            f.write(rec.tobytes())
