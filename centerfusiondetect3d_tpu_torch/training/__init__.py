from .schedule import learning_rate
from .state import (make_optimizer, set_backbone_frozen, train_step,
                    wrap_data_parallel)

__all__ = ["learning_rate", "make_optimizer", "set_backbone_frozen",
           "train_step", "wrap_data_parallel"]
