"""Optimizers: the ``BuiltinOptimizer`` registry on ``torch.optim``.

Counterpart of ``grl_tpu/trainer/optimizers.py`` (:16-81), with optax's
semantics kept where they differ from torch's defaults:

* ``Adam`` with a ``weight_decay`` is optax's decoupled ``adamw``
  (``optimizers.py:17-21``), so it builds ``torch.optim.AdamW``, never
  ``Adam(weight_decay=...)`` (which adds the decay to the gradient);
* ``max_grad_norm`` is optax's ``clip_by_global_norm``:
  ``g * max_norm / max(norm, max_norm)`` over all gradients together, with
  no ``+1e-6`` in the denominator as ``torch.nn.utils.clip_grad_norm_``
  has (:func:`clip_by_global_norm_`);
* the learning rate is each parameter group's ``lr``, written once per
  epoch by :func:`set_learning_rate` (optax injects it as a hyperparameter).

On a CUDA device the optimizer is built ``capturable=True`` with the
learning rate a float32 tensor on the device, which :func:`set_learning_rate`
fills in place: a train step captured in a CUDA graph
(:mod:`grl_torch.trainer.captured`) then reads the step count and the
current rate from device memory at every replay, where a float would be
baked into the graph. Eager steps on the card run the same optimizer, so
an eager chunk and a replayed one compute the same bits. On the CPU it is
the plain optimizer with a float rate.

Only ``Adam`` and ``AdamW`` are ported; the other names ``grl_tpu``
accepts raise ``KeyError``.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List

import torch

_TORCH_OPTIMIZERS = {
    "Adam": lambda params, lr, capturable, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0, **_: (
        torch.optim.AdamW(params, lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay,
                          capturable=capturable)
        if weight_decay
        else torch.optim.Adam(params, lr, betas=tuple(betas), eps=eps, capturable=capturable)
    ),
    "AdamW": lambda params, lr, capturable, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01, **_: (
        torch.optim.AdamW(params, lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay,
                          capturable=capturable)
    ),
}
# Accepted by grl_tpu, not ported yet.
_NOT_PORTED = ("SGD", "RMSprop", "Adagrad", "Adadelta", "Lamb", "Lion")


class BaseOptimizer:
    @classmethod
    def _from_config(cls, config: Dict[str, Any]) -> "BaseOptimizer":
        return cls(**dict(config or {}))

    def make(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
        raise NotImplementedError


class BuiltinOptimizer(BaseOptimizer):
    """``type_optimizer`` + kwargs, like the reference's BuitlinOptimizer [sic]."""

    def __init__(self, type_optimizer: str = "Adam", lr: float = 1e-3, **kwargs: Any):
        if type_optimizer not in _TORCH_OPTIMIZERS:
            later = (
                f" {type_optimizer} is not ported yet (ROADMAP.md Queue 1, item 3: "
                "the optimizers other than Adam/AdamW)."
                if type_optimizer in _NOT_PORTED else ""
            )
            raise KeyError(
                f"Unknown optimizer {type_optimizer!r}; available: "
                f"{sorted(_TORCH_OPTIMIZERS)}.{later}"
            )
        self.type_optimizer = type_optimizer
        self.learning_rate = lr
        self.kwargs = kwargs

    def make(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
        """The torch optimizer over ``params`` at the configured lr:
        capturable, with a tensor lr, where the parameters lie on a CUDA
        device."""
        params = list(params)
        cuda = bool(params) and params[0].device.type == "cuda"
        lr = (torch.tensor(self.learning_rate, dtype=torch.float32, device=params[0].device)
              if cuda else self.learning_rate)
        return _TORCH_OPTIMIZERS[self.type_optimizer](params, lr, cuda, **self.kwargs)


# Reference-compatible alias (the reference class name carries a typo —
# gnn/trainer/optimizers/builtin_optimizer.py:10).
BuitlinOptimizer = BuiltinOptimizer


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[torch.nn.Parameter], max_norm: float) -> torch.Tensor:
    """Scale every gradient in place by ``max_norm / max(norm, max_norm)``,
    ``norm`` being the global L2 norm of all of them (optax
    ``clip_by_global_norm``). Returns ``norm`` as a device scalar; nothing
    waits on the device."""
    grads: List[torch.Tensor] = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads])
    )
    scale = max_norm / torch.clamp(norm, min=max_norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Write ``lr`` into every parameter group: into its tensor, in place,
    where the group holds one (a capturable optimizer)."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr
    return optimizer


def match_device(optimizer: torch.optim.Optimizer) -> torch.optim.Optimizer:
    """Make an optimizer whose state was loaded from a checkpoint written on
    another kind of device capturable, with a tensor lr and step counts on
    the parameters' device, where its parameters lie on a CUDA device, and
    plain, with a float lr, elsewhere (``load_state_dict`` takes these from
    the checkpoint)."""
    for group in optimizer.param_groups:
        device = group["params"][0].device
        cuda = device.type == "cuda"
        lr = float(group["lr"])
        group["capturable"] = cuda
        group["lr"] = torch.tensor(lr, dtype=torch.float32, device=device) if cuda else lr
        for param in group["params"]:
            state = optimizer.state.get(param, {})
            if isinstance(state.get("step"), torch.Tensor):
                state["step"] = state["step"].to(device if cuda else "cpu", torch.float32)
    return optimizer
