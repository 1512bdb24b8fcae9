"""Device choice for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The CUDA card unless the caller names another device.

    With no device given and no card present this raises: the entry points
    never fall back to the CPU on their own. Tests pass ``device="cpu"``.
    """
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; centerfusiondetect3d_tpu_torch runs "
            "on the GPU unless device='cpu' is passed")
    return dev
