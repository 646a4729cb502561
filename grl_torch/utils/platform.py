"""Which device a process runs on.

Counterpart of ``grl_tpu/utils/platform.py`` (:15-33). ``grl_tpu`` flips
the live JAX platform and asks for a number of virtual CPU devices, all in
one process. The port runs one process per device: a rank's device is
``cuda:{local_rank % device_count}``, or the CPU when the caller asks for
it, and a world of N CPU processes (the tests' gloo worlds) stands in for
``grl_tpu``'s ``num_cpu_devices``.
"""
from __future__ import annotations

from typing import Optional

import torch


def ensure_platform(platform: Optional[str] = None, local_rank: int = 0) -> torch.device:
    """The device of the process at ``local_rank`` on its host, made the
    current CUDA device: ``platform`` ``"cpu"`` gives the CPU, ``None`` or
    ``"cuda"`` the card ``local_rank % torch.cuda.device_count()``, raising
    when no GPU is visible (ranks share the cards round-robin when there
    are fewer cards than ranks)."""
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in (None, "cuda", "gpu"):
        raise ValueError(f"platform {platform!r}: the port runs on 'cuda' or 'cpu'")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError(
            "grl_torch runs on CUDA and no GPU is available; pass device='cpu' "
            "explicitly to run on the CPU."
        )
    device = torch.device("cuda", int(local_rank) % count)
    torch.cuda.set_device(device)
    return device


def device_summary() -> str:
    """``"<count>x <name>"`` of the visible cards, e.g. ``"1x NVIDIA H100 80GB
    HBM3"``; the CPU when none is visible."""
    if torch.cuda.is_available() and torch.cuda.device_count():
        return f"{torch.cuda.device_count()}x {torch.cuda.get_device_name(0)}"
    return "1x cpu"
