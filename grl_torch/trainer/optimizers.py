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

The other names ``grl_tpu`` accepts (``optimizers.py:22-35``) take its
keyword mapping and optax's update rules, which differ from
``torch.optim``'s (``SGD`` aside, whose ``weight_decay`` grl_tpu drops):
``RMSprop`` adds eps inside the square root and starts its accumulator at
0, with momentum as a trace of the lr-scaled update; ``Adagrad`` starts
its sum at 0.1; ``Adadelta`` is optax's; ``Lamb`` (Adam's moments, the
decay, then the per-parameter trust ratio, 1 where either norm is 0) and
``Lion`` (default ``b2`` 0.99, ``weight_decay`` 0.001) have no
``torch.optim`` class. Each is an :class:`OptaxRule`: plain tensor ops, no
host read, so on CUDA it is capturable as it is (the lr a device tensor,
the step count a float32 tensor on the parameter's device).
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


class OptaxRule(torch.optim.Optimizer):
    """An optimizer whose update is one optax transformation's, written as
    plain tensor ops: :meth:`_update` returns what optax's chain adds to
    the parameter (``apply_updates``), its ``scale_by_learning_rate`` being
    a product with ``neg_lr`` (``-lr``: a float, or a device tensor that
    :func:`set_learning_rate` fills). Parameters without a gradient are
    left as they are, as ``torch.optim`` leaves them."""

    def __init__(self, params, lr, **defaults: Any):
        super().__init__(params, dict(lr=lr, **defaults))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr = group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                    self._init_state(p, state, group)
                state["step"] += 1
                p.add_(self._update(p, p.grad, state, group, -lr))

    def _init_state(self, p: torch.Tensor, state: Dict[str, Any], group: Dict[str, Any]) -> None:
        pass

    def _update(self, p, g, state, group, neg_lr):
        raise NotImplementedError


class OptaxSGD(OptaxRule):
    """``optax.sgd`` (``alias.py:sgd``): a trace ``t = g + momentum * t``
    (Nesterov: ``g + momentum * t`` of the new trace) where momentum is
    set, then ``-lr``."""

    def __init__(self, params, lr, momentum: float = 0.0, nesterov: bool = False):
        super().__init__(params, lr, momentum=momentum, nesterov=nesterov)

    def _init_state(self, p, state, group):
        if group["momentum"]:
            state["trace"] = torch.zeros_like(p)

    def _update(self, p, g, state, group, neg_lr):
        mu = group["momentum"]
        if not mu:
            return neg_lr * g
        trace = g + mu * state["trace"]
        state["trace"].copy_(trace)
        return neg_lr * (g + mu * trace if group["nesterov"] else trace)


class OptaxRMSprop(OptaxRule):
    """``optax.rmsprop`` at its defaults (not centred, ``initial_scale`` 0,
    eps inside the square root, no bias correction): ``nu = (1 - decay) g^2
    + decay nu``, ``u = -lr g / sqrt(nu + eps)``, then, where momentum is
    set, a trace of ``u`` (after the rate, as optax chains it)."""

    def __init__(self, params, lr, decay: float = 0.9, eps: float = 1e-8, momentum: float = 0.0):
        super().__init__(params, lr, decay=decay, eps=eps, momentum=momentum)

    def _init_state(self, p, state, group):
        state["nu"] = torch.zeros_like(p)
        if group["momentum"]:
            state["trace"] = torch.zeros_like(p)

    def _update(self, p, g, state, group, neg_lr):
        decay = group["decay"]
        nu = (1 - decay) * (g * g) + decay * state["nu"]
        state["nu"].copy_(nu)
        u = neg_lr * (torch.rsqrt(nu + group["eps"]) * g)
        if group["momentum"]:
            u = u + group["momentum"] * state["trace"]
            state["trace"].copy_(u)
        return u


class OptaxAdagrad(OptaxRule):
    """``optax.adagrad``: ``sum = g^2 + sum`` from 0.1, ``u = g /
    sqrt(sum + eps)`` where ``sum > 0`` (else 0), then ``-lr``."""

    def __init__(self, params, lr, eps: float = 1e-7, initial_accumulator_value: float = 0.1):
        super().__init__(params, lr, eps=eps, initial_accumulator_value=initial_accumulator_value)

    def _init_state(self, p, state, group):
        state["sum_of_squares"] = torch.full_like(p, group["initial_accumulator_value"])

    def _update(self, p, g, state, group, neg_lr):
        total = g * g + state["sum_of_squares"]
        state["sum_of_squares"].copy_(total)
        scale = torch.where(total > 0, torch.rsqrt(total + group["eps"]), torch.zeros_like(total))
        return neg_lr * (scale * g)


class OptaxAdadelta(OptaxRule):
    """``optax.adadelta`` (no weight decay, as grl_tpu builds it):
    ``e_g = (1 - rho) g^2 + rho e_g``, ``u = sqrt(e_x + eps) / sqrt(e_g +
    eps) g``, ``e_x = (1 - rho) u^2 + rho e_x``, then ``-lr``."""

    def __init__(self, params, lr, rho: float = 0.9, eps: float = 1e-6):
        super().__init__(params, lr, rho=rho, eps=eps)

    def _init_state(self, p, state, group):
        state["e_g"] = torch.zeros_like(p)
        state["e_x"] = torch.zeros_like(p)

    def _update(self, p, g, state, group, neg_lr):
        rho, eps = group["rho"], group["eps"]
        e_g = (1 - rho) * (g * g) + rho * state["e_g"]
        u = torch.sqrt(state["e_x"] + eps) / torch.sqrt(e_g + eps) * g
        state["e_x"].copy_((1 - rho) * (u * u) + rho * state["e_x"])
        state["e_g"].copy_(e_g)
        return neg_lr * u


class OptaxLamb(OptaxRule):
    """``optax.lamb``: Adam's bias-corrected moments, ``u = mu_hat /
    (sqrt(nu_hat + eps_root) + eps) + weight_decay * p``, scaled by the
    parameter's trust ratio ``||p|| / ||u||`` (1 where either norm is 0),
    then ``-lr``."""

    def __init__(self, params, lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6, eps_root: float = 0.0,
                 weight_decay: float = 0.0):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root, weight_decay=weight_decay)

    def _init_state(self, p, state, group):
        state["mu"] = torch.zeros_like(p)
        state["nu"] = torch.zeros_like(p)

    def _update(self, p, g, state, group, neg_lr):
        b1, b2, count = group["b1"], group["b2"], state["step"]
        mu = (1 - b1) * g + b1 * state["mu"]
        nu = (1 - b2) * (g * g) + b2 * state["nu"]
        state["mu"].copy_(mu)
        state["nu"].copy_(nu)
        mu_hat = mu / (1 - b1 ** count)
        nu_hat = nu / (1 - b2 ** count)
        u = mu_hat / (torch.sqrt(nu_hat + group["eps_root"]) + group["eps"])
        u = u + group["weight_decay"] * p
        p_norm = torch.linalg.vector_norm(p)
        u_norm = torch.linalg.vector_norm(u)
        ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm), p_norm / u_norm)
        return neg_lr * (u * ratio)


class OptaxLion(OptaxRule):
    """``optax.lion``: ``u = sign((1 - b1) g + b1 mu) + weight_decay * p``,
    ``mu = (1 - b2) g + b2 mu``, then ``-lr``."""

    def __init__(self, params, lr, b1: float = 0.9, b2: float = 0.99, weight_decay: float = 1e-3):
        super().__init__(params, lr, b1=b1, b2=b2, weight_decay=weight_decay)

    def _init_state(self, p, state, group):
        state["mu"] = torch.zeros_like(p)

    def _update(self, p, g, state, group, neg_lr):
        b1, b2 = group["b1"], group["b2"]
        u = torch.sign((1.0 - b1) * g + b1 * state["mu"])
        state["mu"].copy_((1 - b2) * g + b2 * state["mu"])
        return neg_lr * (u + group["weight_decay"] * p)


# grl_tpu's keyword mapping of the other names (optimizers.py:22-35);
# ``capturable`` has no effect on these rules, which are capturable as
# they are.
_TORCH_OPTIMIZERS.update({
    "SGD": lambda params, lr, capturable, momentum=0.0, weight_decay=0.0, nesterov=False, **_: OptaxSGD(
        params, lr, momentum=momentum, nesterov=nesterov),
    "RMSprop": lambda params, lr, capturable, alpha=0.99, eps=1e-8, momentum=0.0, **_: OptaxRMSprop(
        params, lr, decay=alpha, eps=eps, momentum=momentum),
    "Adagrad": lambda params, lr, capturable, eps=1e-10, **_: OptaxAdagrad(params, lr, eps=eps),
    "Adadelta": lambda params, lr, capturable, rho=0.9, eps=1e-6, **_: OptaxAdadelta(params, lr, rho=rho, eps=eps),
    "Lamb": lambda params, lr, capturable, **kw: OptaxLamb(params, lr, **kw),
    "Lion": lambda params, lr, capturable, **kw: OptaxLion(params, lr, **kw),
})


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
            raise KeyError(f"Unknown optimizer {type_optimizer!r}; available: {sorted(_TORCH_OPTIMIZERS)}")
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
