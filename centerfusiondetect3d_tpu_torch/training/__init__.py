from .schedule import learning_rate
from .state import make_optimizer, set_backbone_frozen, train_step

__all__ = ["learning_rate", "make_optimizer", "set_backbone_frozen",
           "train_step"]
