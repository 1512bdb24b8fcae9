"""PyTorch/CUDA port of centerfusiondetect3d_tpu (CenterFusion 3D detection).

The JAX package ``centerfusiondetect3d_tpu`` stays the reference; this
package imports none of it, and nothing of JAX. Entry points run on the CUDA
card unless the caller passes ``device="cpu"``. The serving path is
``runtime.detector.Detector``; its one hand-written kernel is the DCNv2
forward (``csrc/dcn_fwd.cu``, bound in ``ops/dcn.py``).
"""
