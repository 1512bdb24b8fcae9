"""Benchmark of centerfusiondetect3d_tpu_torch (see run.py)."""
