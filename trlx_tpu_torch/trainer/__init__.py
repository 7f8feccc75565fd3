"""Trainer registry (port of the JAX package's `trainer/__init__.py`)."""

import sys
from typing import Any, Dict

# Trainer registry, keyed by lowercased class name.
_TRAINERS: Dict[str, Any] = {}


def register_trainer(name):
    """Decorator to register a trainer class under `name` (or its own
    class name)."""

    def register_class(cls, name):
        _TRAINERS[name] = cls
        setattr(sys.modules[__name__], name, cls)
        return cls

    if isinstance(name, str):
        name = name.lower()
        return lambda c: register_class(c, name)

    cls = name
    register_class(cls, cls.__name__.lower())
    return cls
