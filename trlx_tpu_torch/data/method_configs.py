"""Method (algorithm) config registry.

Parity: trlx/data/method_configs.py in the reference (register_method /
_METHODS / get_method). Method configs carry algorithm hyperparameters; the
actual loss math lives in the ops modules, which the method configs
dispatch to.
"""

import sys
from dataclasses import dataclass, field
from typing import Any, Dict

# Registry of method configs, keyed by lowercased class name.
_METHODS: Dict[str, Any] = {}


def register_method(name):
    """Decorator to register a method config class under `name` (or its own
    class name). Mirrors reference trlx/data/method_configs.py:9-28."""

    def register_class(cls, name):
        _METHODS[name] = cls
        setattr(sys.modules[__name__], name, cls)
        return cls

    if isinstance(name, str):
        name = name.lower()
        return lambda c: register_class(c, name)

    cls = name
    register_class(cls, cls.__name__.lower())
    return cls


@dataclass
@register_method
class MethodConfig:
    """Base config for an RL method.

    :param name: registry name of the method
    """

    name: str

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        return cls(**config)

    def to_dict(self):
        return dict(self.__dict__)


def get_method(name: str) -> MethodConfig:
    """Return the constructor for a registered method config."""
    name = name.lower()
    if name in _METHODS:
        return _METHODS[name]
    raise ValueError(
        f"Method '{name}' is not registered. Available: {sorted(_METHODS)}"
    )
