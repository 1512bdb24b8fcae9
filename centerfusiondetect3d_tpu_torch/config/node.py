"""Hierarchical configuration node: yaml + dotted-CLI overrides, freezable.

The port's own copy of ``centerfusiondetect3d_tpu/config/node.py``. A
``ConfigNode`` is an attribute-dict tree that can be frozen, merged from YAML
files, and overridden with ``["KEY.SUBKEY", value, ...]`` lists. ``yaml`` is
imported only by the two methods that read or write YAML, so the serving path
runs where ``pyyaml`` is not installed.
"""

from __future__ import annotations

import ast
import copy
from typing import Any, Iterable, Mapping

_FROZEN = "__frozen__"


class ConfigNode(dict):
    """A dict with attribute access, optional immutability, and yaml I/O."""

    def __init__(self, init: Mapping[str, Any] | None = None):
        super().__init__()
        object.__setattr__(self, _FROZEN, False)
        if init:
            for k, v in init.items():
                self[k] = ConfigNode(v) if isinstance(v, Mapping) else v

    # -- attribute protocol ---------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if self.is_frozen():
            raise AttributeError(f"ConfigNode is frozen; cannot set {name!r}")
        self[name] = ConfigNode(value) if isinstance(value, Mapping) and not isinstance(value, ConfigNode) else value

    def __setitem__(self, name: str, value: Any) -> None:
        if self.is_frozen():
            raise AttributeError(f"ConfigNode is frozen; cannot set {name!r}")
        super().__setitem__(name, value)

    # -- freezing -------------------------------------------------------------
    def is_frozen(self) -> bool:
        return object.__getattribute__(self, _FROZEN)

    def freeze(self) -> "ConfigNode":
        object.__setattr__(self, _FROZEN, True)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.freeze()
        return self

    def defrost(self) -> "ConfigNode":
        object.__setattr__(self, _FROZEN, False)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.defrost()
        return self

    def clone(self) -> "ConfigNode":
        out = ConfigNode()
        for k, v in self.items():
            out[k] = v.clone() if isinstance(v, ConfigNode) else copy.deepcopy(v)
        return out

    # -- merging --------------------------------------------------------------
    def merge_from_dict(self, other: Mapping[str, Any]) -> "ConfigNode":
        for k, v in other.items():
            if isinstance(v, Mapping) and isinstance(self.get(k), ConfigNode):
                self[k].merge_from_dict(v)
            elif isinstance(v, Mapping):
                self[k] = ConfigNode(v)
            else:
                self[k] = _coerce(v, self.get(k))
        return self

    def merge_from_file(self, path: str) -> "ConfigNode":
        with open(path) as f:
            data = _yaml().safe_load(f) or {}
        return self.merge_from_dict(data)

    def merge_from_list(self, opts: Iterable[Any]) -> "ConfigNode":
        opts = list(opts)
        if len(opts) % 2 != 0:
            raise ValueError(f"override list must have even length, got {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = str(key).split(".")
            for p in parts[:-1]:
                node = node[p]
            if parts[-1] not in node:
                raise KeyError(f"unknown config key in override: {key!r}")
            old = node.get(parts[-1])
            node[parts[-1]] = _coerce(value, old)
        return self

    # -- serialization --------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            k: (v.to_dict() if isinstance(v, ConfigNode) else v) for k, v in self.items()
        }

    def dump(self) -> str:
        return _yaml().safe_dump(self.to_dict(), sort_keys=False)


def _yaml():
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            "reading or writing a YAML config needs the 'pyyaml' package; "
            "build the config in Python (default_config + merge_from_list) "
            "where it is not installed") from e
    return yaml


def _coerce(value: Any, old: Any) -> Any:
    """Parse string CLI values into python literals and match existing types."""
    if isinstance(value, str):
        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass
    if old is not None and value is not None:
        if isinstance(old, tuple) and isinstance(value, list):
            value = tuple(value)
        elif isinstance(old, list) and isinstance(value, tuple):
            value = list(value)
        elif isinstance(old, float) and isinstance(value, int):
            value = float(value)
    return value
