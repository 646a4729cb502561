"""The card: the refusal to run without one, its name, power limit and
clocks, and the environment that keeps every cache inside the checkout."""
from __future__ import annotations

import os
import subprocess
import sys
from typing import Dict

from portbench.harness.registry import ROOT

# Modules that may not be loaded in a run's process, by top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "grl_tpu")


def prepare_environment() -> None:
    """Before torch is imported: compiler caches at fixed paths inside the
    checkout (the program's own CUDA builds already go to
    ``build/grl_torch``), and no JAX behind any library."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def require_cards(torch, count: int) -> None:
    """Exit 2, with no result, unless ``count`` CUDA cards are there."""
    if not torch.cuda.is_available():
        sys.stderr.write("portbench: no CUDA device (torch.cuda.is_available() is false); nothing measured\n")
        sys.exit(2)
    if torch.cuda.device_count() < count:
        sys.stderr.write(f"portbench: the cell needs {count} CUDA devices, "
                         f"{torch.cuda.device_count()} found; nothing measured\n")
        sys.exit(2)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def card_report() -> Dict[str, str]:
    """``nvidia-smi``'s name, power limit, clocks and temperature of the
    first card ({} where it cannot be read)."""
    fields = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    if not out:
        return {}
    return dict(zip(fields.split(","), (v.strip() for v in out[0].split(","))))
