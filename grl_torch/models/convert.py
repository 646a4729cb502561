"""Carry ``grl_tpu`` (flax) weights across to the port's state dicts.

:func:`state_dict_from_flax` takes a flax variables tree — nested
mappings of numpy arrays (or anything ``np.asarray`` accepts) — and
returns the matching ``state_dict`` of the port's module::

    params.trunk.emb1.linear.kernel (in, out)  -> trunk.emb1.linear.weight (out, in)
    params.trunk.emb1.linear.bias              -> trunk.emb1.linear.bias
    params.trunk.gcn1.h_weights ((L+1)F, C)    -> trunk.gcn1.h_weights (kept whole)
    params.trunk.self_atten.gamma              -> trunk.self_atten.gamma
    constants.w_rand.kernel (in, out)          -> w_rand.kernel (RanPAC buffer)

The module names are the same in both packages, so the rule is generic:
a 2-D ``kernel`` under ``params`` (a flax ``Dense``) is transposed into
``weight``; every other leaf keeps its path. ``batch_stats`` is accepted
and must be empty: the flagship has no BatchNorm.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Iterator, Mapping, Tuple

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
    if any(True for _ in _leaves(variables.get("batch_stats") or {})):
        raise NotImplementedError(
            "batch_stats (BatchNorm models) are not in the port yet; they "
            "arrive with the dense-zoo slice (ROADMAP.md Queue 1, slice 2)."
        )
    state: Dict[str, torch.Tensor] = OrderedDict()
    for collection in ("params", "constants"):
        for path, leaf in _leaves(variables.get(collection) or {}):
            array = np.asarray(leaf)
            if collection == "params" and path[-1] == "kernel" and array.ndim == 2:
                path, array = path[:-1] + ("weight",), array.T
            # np.array copies: restored arrays may be read-only views.
            state[".".join(path)] = torch.from_numpy(np.array(array, order="C"))
    return state
