from .node import ConfigNode
from .defaults import default_config
from .derive import (
    update_config,
    finalize_config,
    load_config,
    derive_heads,
    derive_weights,
    derive_head_conv,
)

__all__ = [
    "ConfigNode",
    "default_config",
    "update_config",
    "finalize_config",
    "load_config",
    "derive_heads",
    "derive_weights",
    "derive_head_conv",
]
