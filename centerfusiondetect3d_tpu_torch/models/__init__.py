from .detector import CenterFusionDLA, build_model
from .layers import DeformConvNode

__all__ = ["CenterFusionDLA", "DeformConvNode", "build_model"]
