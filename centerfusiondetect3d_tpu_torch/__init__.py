"""PyTorch/CUDA port of centerfusiondetect3d_tpu (CenterFusion 3D detection).

The JAX package ``centerfusiondetect3d_tpu`` stays the reference; this
package imports none of it, and nothing of JAX. Entry points run on the CUDA
card unless the caller passes ``device="cpu"``. The serving path is
``runtime.detector.Detector``, the training path ``runtime.fit.Trainer``;
their hand-written kernels are the DCNv2 forward (``csrc/dcn_fwd.cu``) and
backward (``csrc/dcn_bwd.cu``), bound in ``ops/dcn.py``.
"""
