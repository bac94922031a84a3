"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into
``<repo>/build/<name>-<digest>.so``, a shared library with a plain C
interface; the digest covers the source and the flags, so an edited source
never loads a stale build.  Builds run at first use, never on import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every named source not built yet, all at once (one nvcc
    process per source, started together).

    Returns each name's compiler output (ptxas register and spill counts);
    an empty string for a library that was already built.  Raises when a
    compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs = {}
    running = []
    for name in names:
        out = library_path(name)
        if out.exists():
            logs[name] = ""
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in running:
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"kernel build failed: {name}: nvcc exit {proc.returncode}\n{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def edited(name: str, replacements: Sequence[tuple]) -> ctypes.CDLL:
    """Build and load a copy of ``csrc/<name>.cu`` with each (old, new)
    text replaced, with the same flags: an ablation, or a deliberately
    broken variant that a check must catch.  Raises if an ``old`` text does
    not occur exactly once."""
    text = (CSRC / f"{name}.cu").read_text()
    for old, new in replacements:
        if text.count(old) != 1:
            raise ValueError(f"{name}.cu: {old!r} occurs {text.count(old)} times, not once")
        text = text.replace(old, new)
    digest = hashlib.sha256(text.encode() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / f"{name}-edited-{digest}.cu"
    out = src.with_suffix(".so")
    if not out.exists():
        src.write_text(text)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"edited build of {name} failed: nvcc exit {proc.returncode}\n{proc.stdout}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
