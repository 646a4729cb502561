"""Input casting helpers for the inference API.

Counterpart of ``grl_tpu/utils/input_wrapper.py``: ``handle_single_input``
lets ``predict`` accept a single sample or a list; the ``cast_*`` handlers
accept dicts, lists and JSON paths, and for images paths, raw bytes, numpy
arrays and PIL images (decoded by Pillow; without it an image other than
an array raises ``TypeError``, as in ``grl_tpu``).
"""
from __future__ import annotations

import inspect
import io
import types
from functools import wraps
from pathlib import Path
from typing import Any, Callable, Dict, Tuple

import numpy as np

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



def cast_label_to_dict(value: Any) -> Dict[str, Any]:
    """str/Path -> load JSON; dict passes through
    (reference: input_wrapper.py:91-102)."""
    if isinstance(value, (str, Path)):
        return read_json(str(value))
    if isinstance(value, dict):
        return value
    raise TypeError(f"Unsupported input type {type(value)}")


def cast_image_to_array(value: Any) -> np.ndarray:
    """path / raw bytes / ndarray / PIL image -> numpy array
    (reference: input_wrapper.py:76-89, Pillow instead of cv2)."""
    if isinstance(value, np.ndarray):
        return np.array(value)
    try:
        from PIL import Image
    except ImportError as err:
        raise TypeError(f"Image inputs need Pillow: {err}")
    if isinstance(value, Image.Image):
        return np.array(value)
    if isinstance(value, bytes):
        return np.array(Image.open(io.BytesIO(value)))
    if isinstance(value, (str, Path)):
        return np.array(Image.open(str(value)))
    raise TypeError(f"Unsupported image type {type(value)}")


def cast_pair_sample(value: Any) -> Tuple[np.ndarray, Dict[str, Any]]:
    """(image-like, label-like) pair; a bare label gets a dummy image
    (reference: input_wrapper.py:119-124)."""
    if _is_single_input(value):
        return (np.zeros((1, 1, 3)), cast_label_to_dict(value))
    image, label = value
    return (cast_image_to_array(image), cast_label_to_dict(label))
