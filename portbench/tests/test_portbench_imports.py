"""Nothing the harness imports or runs is JAX or the JAX package (top-level
module names compared whole), and the reference imports nothing of the
program."""

import ast
import subprocess
import sys

from lib import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "nerf_prv_tpu"}


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))"],
                         capture_output=True, text=True, cwd=spec.HERE, timeout=600, check=True)
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """A whole run of a training cell and of an eval cell, cut to the CPU,
    then every harness module and metric reader."""
    code = (
        "import sys; sys.path[:0] = ['.', '..', 'tests']\n"
        "import run, calibrate, torch\n"
        "from conftest import tiny\n"
        "from lib import spec, trace, arith, scene, reference, program\n"
        "for m in spec.benchmark()['per_layer']: spec.reader(m['name'])\n"
        "for name in ('voxel-train-k24', 'hash-eval'):\n"
        "    run.run_cell(tiny(name), 2**33 + 7, 0.0, False, torch.device('cpu'))\n")
    loaded = _loaded_after(code)
    assert "nerf_prv_tpu_torch" in loaded  # the program did run
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_run_guards_on_whole_names(monkeypatch):
    """The port's name begins with the JAX package's: only a whole
    top-level name counts."""
    import types

    import run

    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "nerf_prv_tpu_torch_probe", types.ModuleType("nerf_prv_tpu_torch_probe"))
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "nerf_prv_tpu.core", types.ModuleType("nerf_prv_tpu.core"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert run.loaded_forbidden() == ["jaxlib", "nerf_prv_tpu"]


REFERENCES = sorted((spec.HERE / "lib").glob("reference*.py")) + [spec.HERE / "lib" / "scene.py"]


def test_reference_imports_nothing_of_the_program():
    """Every plain reference (``lib/reference*.py``) and the scenes it is
    handed."""
    modules = ", ".join(f"lib.{p.stem}" for p in REFERENCES)
    loaded = _loaded_after(f"import sys; sys.path[:0] = ['.']\nimport {modules}")
    assert not loaded & (FORBIDDEN | {"nerf_prv_tpu_torch"})
    for path in REFERENCES:
        tree = ast.parse(path.read_text())
        names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        names |= {(n.module or "").split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and not n.level}
        assert names <= {"__future__", "contextlib", "math", "typing", "numpy", "torch"}, names
