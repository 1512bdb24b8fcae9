"""``python -m centerfusiondetect3d_tpu_torch.tools``: ``tools/rehearse.py``."""

from .rehearse import main

if __name__ == "__main__":
    raise SystemExit(main())
