"""What the families share: the phases of set-up, the taps that read the
first step of the check's chunks back for the output check, and the
counters of a window."""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List

from portbench.harness.registry import kernels, reference

BF16_PEAK_FLOPS = 989e12  # NVIDIA H100 SXM data sheet, dense bf16
HBM_BYTES_PER_S = 3.35e12  # the same, HBM3
PEAK_FLOPS = {"bfloat16": BF16_PEAK_FLOPS, "float32": 67e12}


class Phases:
    """Seconds of each phase of set-up, in order."""

    def __init__(self, start: float):
        self.last = start
        self.seconds: Dict[str, float] = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self.last
        self.last = now


class TrainingFamily:
    """What every family keeps: the run's torch, cell, seed, device and
    working directory, the set-up's phases, and the window's counters."""

    def __init__(self, torch, cell, seed: int, device, workdir: str):
        self.torch = torch
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = seed
        self.device = torch.device(device)
        self.workdir = workdir
        self.K = int(self.config["scan_steps"])
        # The configuration's plain reference (its ``reference`` file).
        self.ref = reference(self.config)
        self.counts: Dict[str, float] = {"steps": 0, "failed": 0}
        self.phases = None

    def mark(self, phase: str) -> None:
        if self.phases is not None:
            self.phases.mark(phase)

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def counters(self) -> Dict[str, float]:
        """The run's counters and the program's launch counts, as they stand."""
        from grl_torch.ops import launches

        return {**self.counts, **{f"launches.{k}": v for k, v in launches.device_counts().items()}}

    def build_model(self):
        """The configuration's model (its ``model.type`` in the program's
        registry) on the device, holding the benchmark's weights."""
        from grl_torch.models import create_model

        args = dict(self.config["model"])
        model = create_model(args.pop("type"), **args, device=self.device)
        model.load_state_dict(self.weights, strict=True)
        return model

    def draws_state(self):
        """The state of the program's generator of masks, as it stands."""
        self.sync()
        return self.proc.rngs.device.get_state()

    def release(self) -> None:
        """The program's state freed before the reference runs."""
        del self.proc
        free(self.torch)


def bound_seconds(launches, dtype: str) -> float:
    """The least time of ``launches`` ((flops, bytes) each) on the card:
    each at the larger of its operations at the peak and its bytes at
    HBM's rate."""
    return sum(max(f / PEAK_FLOPS[dtype], b / HBM_BYTES_PER_S) for f, b in launches)


@contextlib.contextmanager
def first_step_taps(model, optimizer, into: Dict):
    """Around the check's first chunk, which runs eagerly: ``into`` gets
    ``first_logits``, the output of the model's first forward, and
    ``first_grad``, the gradients as the optimizer's first step gets them
    (after the clip), by leaf name; both copied to the host. The taps are
    removed as the block ends, before any chunk is captured."""
    names = {id(p): name for name, p in model.named_parameters()}

    def forward_hook(module, inputs, out):
        if "first_logits" not in into:
            into["first_logits"] = out.detach().float().cpu()

    def step_hook(opt, args, kwargs):
        if "first_grad" not in into:
            into["first_grad"] = {names[id(p)]: p.grad.detach().float().clone()
                                  for group in opt.param_groups for p in group["params"] if p.grad is not None}

    handles = [model.register_forward_hook(forward_hook), optimizer.register_step_pre_hook(step_hook)]
    try:
        yield
    finally:
        for handle in handles:
            handle.remove()
    into["first_grad"] = {k: g.cpu() for k, g in into.get("first_grad", {}).items()}


def parameters(model) -> Dict[str, "torch.Tensor"]:
    return {name: p.detach().float().cpu().clone() for name, p in model.named_parameters()}


def launch_names(operations: List[str]) -> List[str]:
    return [n for op in operations for k in kernels(op) for n in k["launch_names"]]


def free(torch) -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
