"""Serving artifacts through ``torch.export``.

The port of ``centerfusiondetect3d_tpu/runtime/export.py``. The deployment
unit is the traced program, not the model code: ``export_serving`` captures
the Detector's whole serving computation (``runtime/detector.py:_forward``:
normalisation on the device, the model, on the batch and its mirror under
``TEST.FLIP_TEST``, ``fusion_decode``, ``post_process``) with the weights in
the program, and writes one self-describing artifact. ``load_serving`` reads
it back into a callable without the config system, the model code or the
checkpoint reader.

Artifact layout (one file)::

    b"CFD3SRV1" | u64-le manifest length | manifest JSON
                | torch.export.save bytes

The manifest is the JAX package's, key for key (``serving_manifest``): batch
size, input and output sizes, top K, the radar layout (``radar_pc``,
``pc_dep_channels``: 3 * MAX_PC_DIST under ONE_HOT_PC, else 3), the raw
[0, 255] uint8 pixel contract with the mean and std inside the program,
``flip_test`` and ``platforms``.

Inputs of the program (fixed shapes, the batch fixed at export time):

    image     (B, H, W, 3)   uint8 raw pixels
    pc_dep    (B, oh, ow, C) float32 dense radar depth map; omitted
              altogether when RADAR_PC is false
    calib     (B, 3, 4)      float32 camera intrinsics
    trans_inv (B, 2, 3)      float32 inverse output -> image affines

It returns the post-process dict of fixed-size (B, K, ...) tensors.

The documented difference from the JAX package's StableHLO: the program
holds the DCN nodes as the operators ``cfd3d::dcn_fwd`` and
``cfd3d::dcn_fwd_bf16`` (``ops/dcn.py``), so a process that loads it needs
this package's operator library, which ``load_serving`` imports
(``ops/dcn.py`` alone: nothing of ``models/``, ``config/`` or
``runtime/detector.py``). On the card the operators launch the
hand-written kernels and count their launches, as in ``Detector``; on the
CPU they run the plain versions. A program is traced on one device;
``load_serving`` moves it to the device it is asked for
(``torch.export.passes.move_to_device_pass``). ``platforms`` is recorded in
the manifest only.

CLI::

    python -m centerfusiondetect3d_tpu_torch.runtime.export --cfg X.yaml
        --out model.cfd3 [--load model.pt] [--batch-size 1]
        [--device cuda|cpu] [--platforms cuda,cpu] [KEY VALUE ...]

writes the artifact and ``<out>.manifest.json`` beside it.
"""

from __future__ import annotations

import argparse
import io
import json
from typing import Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import dcn  # noqa: F401  (registers the cfd3d operators)

_MAGIC = b"CFD3SRV1"
FORMAT = "cfd3-serving-v1"
PLATFORMS = ("cpu", "cuda")


def pc_dep_channels(config) -> int:
    """The radar depth map's channels the model was built for: the one-hot
    layout spreads 3 statistics over MAX_PC_DIST depth bins."""
    if config.DATASET.ONE_HOT_PC:
        return 3 * int(config.DATASET.MAX_PC_DIST)
    return 3


def serving_manifest(config, batch_size: int,
                     platforms: Optional[Sequence[str]] = None) -> dict:
    """What a serving host needs to call the program, without the config."""
    from .detector import MEAN, STD

    ih, iw = config.MODEL.INPUT_SIZE
    oh, ow = config.MODEL.OUTPUT_SIZE
    radar = bool(config.DATASET.RADAR_PC)
    return {
        "format": FORMAT,
        "batch_size": int(batch_size),
        "input_size": [int(ih), int(iw)],
        "output_size": [int(oh), int(ow)],
        "k": int(config.MODEL.K),
        "radar_pc": radar,
        "pc_dep_channels": pc_dep_channels(config) if radar else 0,
        "input_pixels": "raw_0_255",
        # the float32 constants the program normalises with
        "mean": [float(v) for v in np.float32(MEAN)],
        "std": [float(v) for v in np.float32(STD)],
        "flip_test": bool(config.TEST.FLIP_TEST),
        "platforms": _platforms(platforms),
    }


class _Serve(torch.nn.Module):
    """``Detector._forward`` on a dense NHWC radar map."""

    def __init__(self, detector):
        super().__init__()
        self.model = detector.model
        self.detector = detector

    def forward(self, image, pc_dep, calib, trans_inv):
        pc_dep = pc_dep.permute(0, 3, 1, 2).contiguous()
        processed, _extras = self.detector._forward(image, pc_dep, calib,
                                                    trans_inv)
        return processed


class _ServeCamera(_Serve):
    """``Detector._forward`` of a camera-only model."""

    def forward(self, image, calib, trans_inv):
        processed, _extras = self.detector._forward(image, None, calib,
                                                    trans_inv)
        return processed


def make_serving_fn(config, state_dict: Optional[Mapping] = None,
                    device=None, model: Optional[torch.nn.Module] = None
                    ) -> torch.nn.Module:
    """The Detector's one-program serving computation as a module in eval
    mode: ``(image, pc_dep, calib, trans_inv)``, or ``(image, calib,
    trans_inv)`` without RADAR_PC. ``state_dict`` (reference names) or
    ``model`` (a built module on ``device``) as ``Detector`` takes them."""
    from .detector import Detector

    det = Detector(config, state_dict, device=device, model=model)
    return (_Serve if config.DATASET.RADAR_PC else _ServeCamera)(det).eval()


def example_inputs(config, batch_size: int, device) -> Tuple:
    """Zero inputs of the program's shapes and dtypes on ``device``."""
    ih, iw = config.MODEL.INPUT_SIZE
    oh, ow = config.MODEL.OUTPUT_SIZE
    b = int(batch_size)
    args = [torch.zeros((b, ih, iw, 3), dtype=torch.uint8, device=device)]
    if config.DATASET.RADAR_PC:
        args.append(torch.zeros((b, oh, ow, pc_dep_channels(config)),
                                device=device))
    args += [torch.zeros((b, 3, 4), device=device),
             torch.zeros((b, 2, 3), device=device)]
    return tuple(args)


def export_program(config, state_dict: Optional[Mapping] = None,
                   batch_size: int = 1, device=None,
                   model: Optional[torch.nn.Module] = None):
    """The ``torch.export.ExportedProgram`` of the serving computation,
    traced on ``device`` (the CUDA card unless given) without autograd, so
    that each DCN node is its forward operator."""
    fn = make_serving_fn(config, state_dict, device, model)
    args = example_inputs(config, batch_size, fn.detector.device)
    with torch.no_grad():
        return torch.export.export(fn, args)


def export_serving(config, state_dict: Optional[Mapping] = None,
                   batch_size: int = 1, device=None,
                   platforms: Optional[Sequence[str]] = None,
                   model: Optional[torch.nn.Module] = None) -> bytes:
    """The serving program and its manifest as artifact bytes."""
    manifest = serving_manifest(config, batch_size, platforms)
    program = export_program(config, state_dict, batch_size, device, model)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    head = json.dumps(manifest, separators=(",", ":")).encode()
    return _MAGIC + len(head).to_bytes(8, "little") + head + buf.getvalue()


def read_artifact(data: bytes) -> Tuple[dict, bytes]:
    """(manifest, program bytes) of an artifact; raises without the magic."""
    if data[:len(_MAGIC)] != _MAGIC:
        raise ValueError("not a cfd3 serving artifact (no CFD3SRV1 magic)")
    off = len(_MAGIC)
    n = int.from_bytes(data[off:off + 8], "little")
    manifest = json.loads(data[off + 8:off + 8 + n].decode())
    return manifest, data[off + 8 + n:]


def load_serving(data: bytes, device=None) -> Tuple[Callable, dict]:
    """(callable, manifest) of artifact bytes, on ``device`` (the CUDA card
    unless given).

    The callable takes ``(image[, pc_dep], calib, trans_inv)`` at the
    exported shapes and dtypes as tensors on that device
    (``manifest["radar_pc"]`` says whether pc_dep is one of them) and
    returns the post-process dict; it runs without autograd.
    """
    manifest, blob = read_artifact(data)
    dev = _device(device)
    program = torch.export.load(io.BytesIO(blob))
    held = [t.device for t in program.state_dict.values()]
    if any(d != dev for d in held):
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, dev)
    module = program.module()

    def serve(*inputs):
        with torch.inference_mode():
            return module(*inputs)

    return serve, manifest


def _device(device) -> torch.device:
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_serving: no CUDA device is available; pass "
                           "device='cpu'")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _platforms(platforms):
    if not platforms:
        return None
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad:
        raise ValueError(f"platforms {bad} are not among {PLATFORMS}")
    return list(platforms)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cfg", default=None, help="yaml config file")
    p.add_argument("--load", default="", help="reference .pt checkpoint")
    p.add_argument("--out", required=True, help="output artifact path")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--device", default=None,
                   help="torch device to trace on (default: the CUDA card)")
    p.add_argument("--platforms", default="",
                   help="comma list recorded in the manifest, e.g. cuda,cpu")
    p.add_argument("opts", nargs="*", help="dotted config overrides")
    args = p.parse_args(argv)

    from ..config import default_config, finalize_config, update_config
    from ..data.dataset import NuScenesDataset
    from .detector import Detector

    config = update_config(default_config(), args.cfg, args.opts)
    config = finalize_config(config, NuScenesDataset.num_categories,
                             NuScenesDataset.default_resolution)
    det = Detector(config, device=args.device)
    if args.load:
        from ..training.checkpoint import load_torch_file, load_weights

        load_weights(det.model, load_torch_file(args.load)["state_dict"])
    platforms = [s for s in args.platforms.split(",") if s] or None
    data = export_serving(config, batch_size=args.batch_size,
                          device=det.device, platforms=platforms,
                          model=det.model)
    with open(args.out, "wb") as f:
        f.write(data)
    with open(args.out + ".manifest.json", "w") as f:
        json.dump(serving_manifest(config, args.batch_size, platforms), f,
                  indent=2)
    print(f"wrote {args.out}: {len(data) / 2 ** 20:.1f} MiB "
          f"(batch {args.batch_size}, device {det.device}, platforms "
          f"{platforms or 'default'})")


if __name__ == "__main__":
    main()
