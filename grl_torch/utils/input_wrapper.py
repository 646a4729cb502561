"""Input casting helpers for the inference API.

The part of ``grl_tpu/utils/input_wrapper.py`` that serving uses:
``handle_single_input`` lets ``predict`` accept a single sample or a
list, and ``cast_label_to_list`` accepts a page as a list or a JSON path.
"""
from __future__ import annotations

import inspect
import types
from functools import wraps
from pathlib import Path
from typing import Any, Callable

from grl_torch.utils.json_handler import read_json


def _is_single_input(value: Any) -> bool:
    return type(value) not in (list, tuple, types.GeneratorType)


def handle_single_input(preprocess_hook: Callable[[Any], Any] = lambda x: x):
    """Wrap f(list)->list so it accepts and returns single items too."""

    def decorator(func: Callable) -> Callable:
        @wraps(func)
        def decorated(*args: Any, **kwargs: Any) -> Any:
            input_index = 1 if inspect.getfullargspec(func).args[0] == "self" else 0
            value = args[input_index]
            single = _is_single_input(value)
            items = [value] if single else value
            args = list(args)
            args[input_index] = [preprocess_hook(item) for item in items]
            result = func(*args, **kwargs)
            if single:
                [result] = result
            return result

        return decorated

    return decorator


def cast_label_to_list(value: Any) -> Any:
    """str/Path -> load JSON; list/dict pass through
    (reference: input_wrapper.py:104-116)."""
    if isinstance(value, (str, Path)):
        return read_json(str(value))
    if isinstance(value, (list, dict)):
        return value
    raise TypeError(f"Unsupported input type {type(value)}")

