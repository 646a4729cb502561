"""Carry ``grl_tpu`` (flax) weights across to the port's state dicts.

:func:`state_dict_from_flax` takes a flax variables tree — nested
mappings of numpy arrays (or anything ``np.asarray`` accepts) — and
returns the matching ``state_dict`` of the port's module::

    params.trunk.emb1.linear.kernel (in, out)  -> trunk.emb1.linear.weight (out, in)
    params.trunk.emb1.linear.bias              -> trunk.emb1.linear.bias
    params.trunk.gcn1.h_weights ((L+1)F, C)    -> trunk.gcn1.h_weights (kept whole)
    params.trunk.self_atten.gamma              -> trunk.self_atten.gamma
    constants.w_rand.kernel (in, out)          -> w_rand.kernel (RanPAC buffer)
    params.emb1.norm.bn.scale                  -> emb1.norm.bn.scale
    batch_stats.emb1.norm.bn.mean              -> emb1.norm.bn.mean (BatchNorm buffer)

The module names are the same in both packages, so the rule is generic:
a 2-D ``kernel`` under ``params`` (a flax ``Dense``) is transposed into
``weight``; every other leaf keeps its path, and a ``constants`` or
``batch_stats`` leaf lands on the buffer of that name (RanPAC's frozen
kernel, BatchNorm's running ``mean`` / ``var``).

:func:`optimizer_state_from_optax` carries the optimizer state across the
same way, so a ``grl_tpu`` run can be resumed in the port: optax's Adam
moments ``mu``/``nu`` (trees shaped like ``params``) become
``torch.optim.Adam``'s ``exp_avg``/``exp_avg_sq`` under the same key
mapping, ``count`` becomes ``step`` and the injected ``learning_rate``
becomes the group's ``lr``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, value


def state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a flax ``{"params", "constants", ...}`` tree."""
    unknown = set(variables) - {"params", "constants", "batch_stats"}
    if unknown:
        raise KeyError(f"Unexpected flax collections: {sorted(unknown)}")
    state: Dict[str, torch.Tensor] = OrderedDict()
    for collection in ("params", "constants", "batch_stats"):
        for path, leaf in _leaves(variables.get(collection) or {}):
            array = np.asarray(leaf)
            if collection == "params" and path[-1] == "kernel" and array.ndim == 2:
                path, array = path[:-1] + ("weight",), array.T
            # np.array copies: restored arrays may be read-only views.
            state[".".join(path)] = torch.from_numpy(np.array(array, order="C"))
    return state


def _adam_state(state: Any) -> Optional[Any]:
    """The first node of an optax state tree with Adam's ``mu``, ``nu`` and
    ``count`` (``ScaleByAdamState``), found through the tuples that
    ``chain`` and ``inject_hyperparams`` nest it in."""
    if all(hasattr(state, name) for name in ("mu", "nu", "count")):
        return state
    if isinstance(state, (tuple, list)):
        for item in state:
            found = _adam_state(item)
            if found is not None:
                return found
    return None


def optimizer_state_from_optax(
    opt_state: Any, model: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer] = None
) -> Dict[str, Any]:
    """A ``torch.optim.Adam``/``AdamW`` ``state_dict`` for ``model`` from the
    state of ``grl_tpu``'s ``inject_hyperparams(chain(clip, adam))``.

    The hyperparameters other than ``lr`` (betas, eps, weight decay) are
    not in optax's state: they come from ``optimizer`` when given, else
    from ``torch.optim.Adam``'s defaults.
    """
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("no Adam state (mu, nu, count) in this optax state")
    mu = state_dict_from_flax({"params": adam.mu})
    nu = state_dict_from_flax({"params": adam.nu})
    names = [name for name, p in model.named_parameters() if p.requires_grad]
    missing = sorted(set(names) - set(mu))
    if missing:
        raise KeyError(f"optax state has no moments for {missing}")
    step = float(np.asarray(adam.count))
    state = {
        index: {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": mu[name],
            "exp_avg_sq": nu[name],
        }
        for index, name in enumerate(names)
    }
    base = optimizer if optimizer is not None else torch.optim.Adam([torch.zeros(1)])
    groups = base.state_dict()["param_groups"]
    if len(groups) != 1:
        raise ValueError(f"expected one parameter group, found {len(groups)}")
    group = {**groups[0], "params": list(range(len(names)))}
    hyperparams = getattr(opt_state, "hyperparams", None) or {}
    if "learning_rate" in hyperparams:
        group["lr"] = float(np.asarray(hyperparams["learning_rate"]))
    return {"state": state, "param_groups": [group]}
