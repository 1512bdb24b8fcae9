"""The port runs where the card's machine runs it: without JAX, flax, optax,
orbax, pyyaml, opencv, PIL, imageio, matplotlib, wandb or anything of the
JAX package.

The machine that runs the CPU tests has all of them, so a subprocess hides
them (``sys.modules[name] = None`` makes every import of the name fail) and
then imports every module of the port and runs the ``chip_smoke.py``
rehearsal, serving, training, the probes, ``main.py`` and serving image
files (phase 17: the plain warp, ``run``, ``run_stream``, flip and
multi-scale TTA, and the inference CLI's ``main``, serial with
``--save-dir`` and ``--show-attention``, then streamed), the training
run's host side (phase 18: the converter, the native paint, the threaded
Loader and ``tools rehearse``), phase 19 (the demo, the evaluation CLI,
KITTI, the ResNet backbones) and phase 20 (the serving artifact, two gloo
ranks training and validating, ``main.py`` under
``torch.distributed.run``), phase 21 (the overfit across its boundary,
the smoke campaign, the schedule CLI, the select probes) and phase 22 (the
DCN's row origin, four gloo ranks on a (data, spatial, model) layout, the
multi-chip dry run), to its last line;
``--help`` of the demo, the evaluation CLI, the schedule CLI and the
campaign, overfit, DCN-parity, select and dry-run tools runs there too.
opencv is the CPU's image decoder (``data/image_io.py``, as the JAX package
reads its JPEGs): there the subprocess lets only that module import it, and
the rehearsal's ``main.py`` phase decodes through it. An AST scan checks the
sources as well: the port never imports the JAX stack, PIL or imageio,
imports pyyaml, opencv, matplotlib and wandb only inside the functions that
need them, and opencv only in ``data/image_io.py``. The nvJPEG decoder
(``csrc/jpeg_decode.cu``) is built at its first decode, never at import.
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
NEVER = {"jax", "jaxlib", "flax", "optax", "orbax", "centerfusiondetect3d_tpu",
         "PIL", "imageio"}
LAZY_ONLY = {"yaml", "cv2", "matplotlib", "wandb"}
BLOCKED = sorted(NEVER | LAZY_ONLY - {"cv2"})
CV2_ONLY_IN = PACKAGE / "data" / "image_io.py"

HIDE_AND_RUN = r"""
import importlib, io, json, pkgutil, sys, contextlib
BLOCKED = {blocked!r}
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
for name in BLOCKED:
    sys.modules[name] = None
cv2_from = []


class Cv2Gate:  # lets only the CPU decoder's module import cv2
    def find_spec(self, name, path=None, target=None):
        if name != "cv2":
            return None
        f = sys._getframe(1)
        while f is not None and (f.f_code.co_filename.startswith("<frozen")
                                 or "importlib" in f.f_code.co_filename):
            f = f.f_back
        caller = f.f_code.co_filename if f else "?"
        if "/cv2/" in caller:  # cv2 loading itself
            return None
        cv2_from.append(caller)
        if caller != {cv2_only_in!r}:
            raise ImportError("cv2 imported from " + caller)
        return None


sys.modules.pop("cv2", None)
sys.meta_path.insert(0, Cv2Gate())
import torch
torch.set_num_threads(2)
import centerfusiondetect3d_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
import runpy
helps = {{}}
for name in {help_modules!r}:
    sys.argv = [name, "--help"]
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_module(name, run_name="__main__", alter_sys=True)
    except SystemExit as e:
        helps[name] = [e.code, out.getvalue()]
import chip_smoke
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = chip_smoke.main(["--device", "cpu", "--tiny"])
loaded = sorted(n for n, m in sys.modules.items()
                if n.split(".")[0] in BLOCKED and m is not None)
lines = out.getvalue().strip().splitlines()
print(json.dumps({{"rc": rc, "modules": mods, "loaded": loaded,
                   "cv2_from": sorted(set(cv2_from)),
                   "phases": [l.split(":")[0] for l in lines
                              if l.startswith("phase ")], "helps": helps,
                   "last": lines[-1]}}))
"""


# the serving slice's and the training run's modules, among those the
# subprocess imports
NEW_MODULES = ("ops/warp.py", "ops/tta.py", "utils/visualize.py",
               "inference.py", "native/__init__.py", "data/synthetic.py",
               "data/convert_nuscenes.py", "utils/metrics_logger.py",
               "tools/rehearse.py", "tools/__main__.py",
               "tools/profile_train_loader.py", "demo.py",
               "evaluation/cli.py", "evaluation/kitti.py",
               "evaluation/kitti_export.py", "models/resnet.py",
               "runtime/export.py", "parallel/__init__.py",
               "parallel/distributed.py", "parallel/mesh.py",
               "tools/ddp_check.py", "training/schedule.py",
               "tools/train_campaign.py", "tools/overfit.py",
               "tools/dcn_parity.py", "tools/dcn_select.py",
               "parallel/collectives.py", "tools/dryrun_multichip.py")
# entry points whose --help runs with the JAX stack hidden
HELP_MODULES = ("centerfusiondetect3d_tpu_torch.demo",
                "centerfusiondetect3d_tpu_torch.evaluation.cli",
                "centerfusiondetect3d_tpu_torch.training.schedule",
                "centerfusiondetect3d_tpu_torch.tools.train_campaign",
                "centerfusiondetect3d_tpu_torch.tools.overfit",
                "centerfusiondetect3d_tpu_torch.tools.dcn_parity",
                "centerfusiondetect3d_tpu_torch.tools.dcn_select",
                "centerfusiondetect3d_tpu_torch.tools.dryrun_multichip")


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


def test_the_scan_covers_the_artifact_and_the_parallel_modules():
    scanned = {p.relative_to(PACKAGE).as_posix() for p in _sources()
               if p != SMOKE}
    assert {"runtime/export.py", "parallel/__init__.py",
            "parallel/distributed.py", "parallel/mesh.py",
            "tools/ddp_check.py"} <= scanned


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_sources_import_no_jax_stack(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, at_top in _imports(tree):
        assert name not in NEVER, f"{path.name} imports {name}"
        if name in LAZY_ONLY:
            assert not at_top, f"{path.name} imports {name} at module top"


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_only_the_cpu_decoder_imports_cv2(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    if path != CV2_ONLY_IN:
        assert "cv2" not in {name for name, _ in _imports(tree)}, path.name


def test_jpeg_decoder_builds_at_first_decode_only(monkeypatch):
    """Importing the decoder, a CPU read and a refused call build nothing;
    the first nvJPEG decode asks for csrc/jpeg_decode.cu."""
    import numpy as np

    from centerfusiondetect3d_tpu_torch.data import image_io

    built = []
    monkeypatch.setattr(image_io, "load_kernel_library",
                        lambda source: built.append(source) or (_ for _ in
                                                                ()).throw(
                            RuntimeError("no nvcc here")))
    image_io.read_image(str(ROOT / "output" / "campaign_r5" / "data" /
                            "nuscenes" / "samples" / "CAM_FRONT" /
                            "c1img0.jpg"), "cpu")
    with pytest.raises(RuntimeError, match="CUDA device"):
        image_io.decode_jpeg(np.zeros(8, np.uint8), "cpu")
    assert built == []
    with pytest.raises(RuntimeError, match="no nvcc"):
        image_io.decode_jpeg(np.zeros(8, np.uint8), "cuda:0")
    assert built == ["jpeg_decode.cu"]


def test_port_and_rehearsal_run_with_the_jax_stack_hidden():
    proc = subprocess.run(
        [sys.executable, "-c", HIDE_AND_RUN.format(
            blocked=BLOCKED, cv2_only_in=str(CV2_ONLY_IN),
            help_modules=HELP_MODULES)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-4000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["rc"] == 0
    assert len(report["modules"]) >= 20
    assert {f"{PACKAGE.name}.{m[:-3].replace('/', '.')}".removesuffix(
        ".__init__") for m in NEW_MODULES} <= set(report["modules"])
    assert report["loaded"] == [], report["loaded"]
    assert report["cv2_from"] == [str(CV2_ONLY_IN)], report["cv2_from"]
    # serving in float32 and in bf16, then the DCN backward check, the
    # Trainer and the kernel-vs-plain train step in float32 and in bf16,
    # then the DCN probe path and main.py on the repo's data
    assert report["phases"] == [
        "phase environment", "phase build+warm-up", "phase kernel-vs-plain",
        "phase bf16-kernel-vs-plain", "phase main path", "phase heads",
        "phase bf16 main path", "phase bf16 heads", "phase backward-vs-plain",
        "phase training", "phase step-vs-plain",
        "phase bf16-backward-vs-plain", "phase bf16 training",
        "phase bf16 step-vs-plain", "phase probes", "phase main.py",
        "phase serving files", "phase training run",
        "phase demo+eval+kitti+resnet", "phase artifact+ddp",
        "phase campaign+overfit", "phase mesh"
    ], report["phases"]
    for name in HELP_MODULES:
        code, text = report["helps"][name]
        assert code == 0 and "usage:" in text, (name, code, text)
    assert json.loads(report["last"]) == {"ok": True, "rehearsal": "cpu"}


def test_kernel_sources_ship_as_package_data():
    """Every CUDA source under csrc/ (the float32 and bf16 forward and the
    backward DCN kernels, the probe kernels, the nvJPEG decoder) is package
    data, so an installed port can build them."""
    import fnmatch
    import tomllib

    data = tomllib.loads((ROOT / "pyproject.toml").read_text())
    globs = data["tool"]["setuptools"]["package-data"][PACKAGE.name]
    sources = sorted(p.relative_to(PACKAGE).as_posix()
                     for p in (PACKAGE / "csrc").iterdir())
    assert {"csrc/dcn_fwd.cu", "csrc/dcn_bwd.cu", "csrc/dcn_fwd_bf16.cu",
            "csrc/dcn_probes.cu", "csrc/jpeg_decode.cu",
            "csrc/warp_affine.cu"} <= set(sources)
    for src in sources:
        assert any(fnmatch.fnmatch(src, g) for g in globs), src


def test_host_sources_ship_as_package_data():
    """The C++ host paint, the C++ item warp and the converter's scene
    splits are package data of the port (the paint and the splits its own
    copies beside the JAX package's)."""
    import fnmatch
    import tomllib

    data = tomllib.loads((ROOT / "pyproject.toml").read_text())
    globs = data["tool"]["setuptools"]["package-data"][PACKAGE.name]
    for src in ("native/rasterize.cpp", "native/warp.cpp",
                "data/nuscenes_splits.json"):
        assert (PACKAGE / src).is_file(), src
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
