"""The port's command-line tools. ``python -m centerfusiondetect3d_tpu_torch.tools
rehearse ...`` (``main``) is the JAX package's ``tools.py``
(``tools/rehearse.py``); the other modules run on their own with ``-m``."""

from .rehearse import main, rehearse

__all__ = ["main", "rehearse"]
