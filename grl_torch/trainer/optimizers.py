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

Only ``Adam`` and ``AdamW`` are ported; the other names ``grl_tpu``
accepts raise ``KeyError``.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List

import torch

_TORCH_OPTIMIZERS = {
    "Adam": lambda params, lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0, **_: (
        torch.optim.AdamW(params, lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay)
        if weight_decay
        else torch.optim.Adam(params, lr, betas=tuple(betas), eps=eps)
    ),
    "AdamW": lambda params, lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01, **_: (
        torch.optim.AdamW(params, lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay)
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
                f" {type_optimizer} is not ported yet (ROADMAP.md Queue 1, item 5: "
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
        """The torch optimizer over ``params`` at the configured lr."""
        return _TORCH_OPTIMIZERS[self.type_optimizer](list(params), self.learning_rate, **self.kwargs)


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
    """Write ``lr`` into every parameter group."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer
