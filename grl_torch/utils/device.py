"""Device selection for the port's entry points.

The port runs on CUDA. The CPU is used only when the caller asks for it
(``device="cpu"``, as the tests do); with no device argument and no GPU
the entry points raise instead of carrying on quietly on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None, flag: str = "device='cpu'") -> torch.device:
    """``None`` -> ``cuda``, raising when no GPU is visible; else as given.
    ``flag`` is what the error tells the caller to pass for the CPU (a
    command line names its own option)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"grl_torch runs on CUDA and no GPU is available; pass "
                f"{flag} explicitly to run on the CPU."
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device} requested but CUDA is not available.")
    return device


def optional_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """``"bfloat16"`` -> ``torch.bfloat16``; ``None`` stays ``None``."""
    if name is None:
        return None
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"Unknown compute_dtype {name!r}")
    return dtype
