"""Model registry and parameter count (``grl_tpu/models/base.py:16-61``).

Networks register under their class name and are built by name from the
YAML ``model: {type, args}`` block. Unlike flax, a torch module owns its
parameters: construction initialises them from an explicit
``torch.Generator`` and places them on the resolved device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

MODEL_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register_model(cls: Any) -> Any:
    """Class decorator registering a network under its class name."""
    MODEL_REGISTRY[cls.__name__] = cls
    return cls


def create_model(type_name: str, **kwargs: Any) -> Any:
    """Build a registered network; ``device``/``generator`` pass through."""
    if type_name not in MODEL_REGISTRY:
        raise KeyError(
            f"Unknown model {type_name!r}; available: {sorted(MODEL_REGISTRY)}"
        )
    return MODEL_REGISTRY[type_name](**kwargs)


def count_parameters(model: Any) -> int:
    """Number of trainable parameters (``base.py:55-61``); buffers such as
    the frozen RanPAC kernel are not counted, as flax's ``constants`` are
    not."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)
