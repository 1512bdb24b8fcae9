"""The port runs where the card's machine runs it: without JAX, flax, optax,
orbax, pyyaml, opencv or anything of the JAX package.

The machine that runs the CPU tests has all of them, so a subprocess hides
them (``sys.modules[name] = None`` makes every import of the name fail) and
then imports every module of the port and runs the ``chip_smoke.py``
rehearsal, serving and training, to its last line. An AST scan checks the sources as well: the
port never imports the JAX stack, and imports pyyaml and opencv only inside
the functions that need them.
"""

from __future__ import annotations

import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "centerfusiondetect3d_tpu_torch"
SMOKE = ROOT / "chip_smoke.py"
NEVER = {"jax", "jaxlib", "flax", "optax", "orbax", "centerfusiondetect3d_tpu"}
LAZY_ONLY = {"yaml", "cv2"}
BLOCKED = sorted(NEVER | LAZY_ONLY)

HIDE_AND_RUN = r"""
import importlib, io, json, pkgutil, sys, contextlib
BLOCKED = {blocked!r}
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
for name in BLOCKED:
    sys.modules[name] = None
import torch
torch.set_num_threads(2)
import centerfusiondetect3d_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = chip_smoke.main(["--device", "cpu", "--tiny"])
loaded = sorted(n for n, m in sys.modules.items()
                if n.split(".")[0] in BLOCKED and m is not None)
lines = out.getvalue().strip().splitlines()
print(json.dumps({{"rc": rc, "modules": len(mods), "loaded": loaded,
                   "phases": [l.split(":")[0] for l in lines
                              if l.startswith("phase ")],
                   "last": lines[-1]}}))
"""


def _sources():
    return sorted(PACKAGE.rglob("*.py")) + [SMOKE]


def _imports(tree):
    """(module name, at module top) for every import in the file."""
    top = set(map(id, tree.body))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            yield name.split(".")[0], id(node) in top


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_sources_import_no_jax_stack(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, at_top in _imports(tree):
        assert name not in NEVER, f"{path.name} imports {name}"
        if name in LAZY_ONLY:
            assert not at_top, f"{path.name} imports {name} at module top"


def test_port_and_rehearsal_run_with_the_jax_stack_hidden():
    proc = subprocess.run(
        [sys.executable, "-c", HIDE_AND_RUN.format(blocked=BLOCKED)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-4000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["rc"] == 0
    assert report["modules"] >= 20
    assert report["loaded"] == [], report["loaded"]
    # serving in float32 and in bf16, then the DCN backward check, the
    # Trainer and the kernel-vs-plain train step in float32 and in bf16
    assert report["phases"] == [
        "phase environment", "phase build+warm-up", "phase kernel-vs-plain",
        "phase bf16-kernel-vs-plain", "phase main path", "phase heads",
        "phase bf16 main path", "phase bf16 heads", "phase backward-vs-plain",
        "phase training", "phase step-vs-plain",
        "phase bf16-backward-vs-plain", "phase bf16 training",
        "phase bf16 step-vs-plain"], report["phases"]
    assert json.loads(report["last"]) == {"ok": True, "rehearsal": "cpu"}


def test_kernel_sources_ship_as_package_data():
    """Every CUDA source under csrc/ (the float32 and bf16 forward and the
    backward DCN kernels) is package data, so an installed port can build
    them."""
    import fnmatch
    import tomllib

    data = tomllib.loads((ROOT / "pyproject.toml").read_text())
    globs = data["tool"]["setuptools"]["package-data"][PACKAGE.name]
    sources = sorted(p.relative_to(PACKAGE).as_posix()
                     for p in (PACKAGE / "csrc").iterdir())
    assert {"csrc/dcn_fwd.cu", "csrc/dcn_bwd.cu",
            "csrc/dcn_fwd_bf16.cu"} <= set(sources)
    for src in sources:
        assert any(fnmatch.fnmatch(src, g) for g in globs), src


def test_config_yaml_reader_names_the_missing_package():
    code = ("import sys; sys.modules['yaml'] = None\n"
            "from centerfusiondetect3d_tpu_torch.config import load_config\n"
            "cfg = load_config()\n"
            "try:\n"
            "    load_config('configs/Centerfusion_Middle.yaml')\n"
            "except ImportError as e:\n"
            "    print('pyyaml' in str(e))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.stdout.strip() == "True", proc.stderr[-2000:]


def test_smoke_fails_without_card_or_without_the_repo(tmp_path):
    """No result line and a non-zero exit: with no card and no rehearsal
    flag, and from a directory holding only chip_smoke.py."""
    env = {**os.environ, "PYTHONPATH": ""}
    runs = [([sys.executable, str(SMOKE), "--device", "cpu"], ROOT)]
    if not _has_card():
        runs.append(([sys.executable, str(SMOKE)], ROOT))
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    runs.append(([sys.executable, "chip_smoke.py", "--device", "cpu",
                  "--tiny"], tmp_path))
    for cmd, cwd in runs:
        proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                              timeout=300, env=env)
        assert proc.returncode != 0, (cmd, proc.stdout[-2000:])
        assert '"ok"' not in proc.stdout, (cmd, proc.stdout[-2000:])


def _has_card() -> bool:
    import torch

    return torch.cuda.is_available()
