from .generic import SIZE_THRESH, GenericLoss, build_layer_masks

__all__ = ["GenericLoss", "SIZE_THRESH", "build_layer_masks"]
