"""Cosine-normalized classifier heads for class-incremental learning.

Counterparts of ``grl_tpu/models/cosine_linear.py``, with its
normalisation axes, including the quirk that inputs are L2-normalised over
axis 1, which is the node axis of ``(B, N, F)`` activations. Weights are
``(features, in)`` as there (a flax param named ``weight``, which
``state_dict_from_flax`` keeps as it is), drawn ``U(-1/sqrt(in),
1/sqrt(in))``; ``sigma`` starts at 1. The width ``grl_tpu`` infers from the
first input is a constructor argument here: ``in_features``, the input's
last axis (for ``CosineLinearBiFeat`` its axis 1, which it slices).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def _l2_normalize(x: torch.Tensor, axis: int = 1, eps: float = 1e-12) -> torch.Tensor:
    """``torch.nn.functional.normalize(p=2)``: x over its clamped L2 norm.

    The norm is ``torch.linalg.vector_norm``, whose gradient at a zero
    slice is 0, as the reference's ``F.normalize`` has it.
    ``grl_tpu``'s ``sqrt(sum(x * x))`` gives NaN there (0 times the
    infinite slope of sqrt at 0): a feature that is 0 on every node of a
    page, as a dead ReLU column is, turned ModGCN's parameters to NaN at
    the sumi width (ROADMAP Queue 3). Elsewhere the two agree."""
    norm = torch.linalg.vector_norm(x, dim=axis, keepdim=True)
    return x / torch.clamp(norm, min=eps)


def _uniform_stdv(shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    """``U(-1/sqrt(in), 1/sqrt(in))`` on ``(out, in)`` (``cosine_linear.py:22-25``)."""
    stdv = 1.0 / (shape[1] ** 0.5)
    return torch.rand(shape, generator=generator) * (2 * stdv) - stdv


class _Sigma(nn.Module):
    """The optional learned ``sigma (1,)`` every head multiplies by."""

    def __init__(self, use_sigma: bool):
        super().__init__()
        self.sigma = nn.Parameter(torch.ones(1)) if use_sigma else None

    def _scaled(self, out: torch.Tensor) -> torch.Tensor:
        return out if self.sigma is None else self.sigma * out


class CosineLinear(_Sigma):
    """(``cosine_linear.py:28-50``). With ``num_head > 1`` the input's axis
    1 and the weight's input axis are cut into ``num_head`` slices of
    ``x.shape[1] // num_head``, each normalised on its own, and the heads'
    products summed."""

    def __init__(self, in_features: int, features: int, use_sigma: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__(use_sigma)
        self.weight = nn.Parameter(_uniform_stdv((features, in_features), generator))

    def forward(self, x: torch.Tensor, num_head: int = 1) -> torch.Tensor:
        weight = self.weight
        if num_head > 1:
            head_dim = x.shape[1] // num_head
            out = 0
            for h in range(num_head):
                xi = _l2_normalize(x[:, h * head_dim:(h + 1) * head_dim], axis=1)
                wi = _l2_normalize(weight[:, h * head_dim:(h + 1) * head_dim], axis=1)
                out = out + xi @ wi.T
        else:
            out = _l2_normalize(x, axis=1) @ _l2_normalize(weight, axis=1).T
        return self._scaled(out)


class SplitCosineLinear(_Sigma):
    """Old-classes / new-classes split head (``cosine_linear.py:53-68``):
    ``fc1`` and ``fc2`` without sigma, concatenated."""

    def __init__(self, in_features: int, features1: int, features2: int, use_sigma: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__(use_sigma)
        self.fc1 = CosineLinear(in_features, features1, use_sigma=False, generator=generator)
        self.fc2 = CosineLinear(in_features, features2, use_sigma=False, generator=generator)

    def forward(self, x: torch.Tensor, num_head: int = 1) -> torch.Tensor:
        return self._scaled(torch.cat([self.fc1(x, num_head), self.fc2(x, num_head)], dim=-1))


class CosineLinearBiFeat(_Sigma):
    """Two-slice input cosine head (``cosine_linear.py:71-104``): axis 1 of
    ``x`` (``in_features`` wide) is cut at ``in_features1``. ``mask_feat2``
    detaches the second slice's term (``stop_gradient``), ``mean_feat2``
    stands in for the second slice (with ``mask_feat2``), and
    ``eval_mode`` leaves the second term out."""

    def __init__(self, in_features: int, in_features1: int, features: int, use_sigma: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__(use_sigma)
        self.in_features1 = in_features1
        self.weight1 = nn.Parameter(_uniform_stdv((features, in_features1), generator))
        self.weight2 = nn.Parameter(_uniform_stdv((features, in_features - in_features1), generator))

    def forward(self, x: torch.Tensor, mask_feat2: bool = False, mean_feat2: Optional[torch.Tensor] = None,
                eval_mode: bool = False) -> torch.Tensor:
        input1 = _l2_normalize(x[:, :self.in_features1], axis=1)
        if mean_feat2 is not None:
            assert mask_feat2
            input2 = _l2_normalize(mean_feat2, axis=1)
        else:
            input2 = _l2_normalize(x[:, self.in_features1:], axis=1)
        out2 = input2 @ _l2_normalize(self.weight2, axis=1).T
        if mask_feat2:
            out2 = out2.detach()
        out = input1 @ _l2_normalize(self.weight1, axis=1).T
        if not eval_mode:
            out = out + out2
        return self._scaled(out)


class SplitCosineLinearBiFeat(_Sigma):
    """(``cosine_linear.py:107-123``): ``fc1`` / ``fc2`` two-slice heads,
    concatenated; keyword arguments pass to both."""

    def __init__(self, in_features: int, in_features1: int, features1: int, features2: int,
                 use_sigma: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__(use_sigma)
        self.fc1 = CosineLinearBiFeat(in_features, in_features1, features1, use_sigma=False, generator=generator)
        self.fc2 = CosineLinearBiFeat(in_features, in_features1, features2, use_sigma=False, generator=generator)

    def forward(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        return self._scaled(torch.cat([self.fc1(x, **kwargs), self.fc2(x, **kwargs)], dim=-1))


class GroupCosineLinear(_Sigma):
    """Group-normalised cosine head (``cosine_linear.py:126-141``): the
    weight over the root mean of its rows' squared norms, that scale
    detached (``stop_gradient``)."""

    def __init__(self, in_features: int, features: int, use_sigma: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__(use_sigma)
        self.weight = nn.Parameter(_uniform_stdv((features, in_features), generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = self.weight
        norm_sq = torch.sum(weight * weight, dim=1).detach()
        scale = torch.sqrt(torch.mean(norm_sq))
        return self._scaled(_l2_normalize(x, axis=1) @ (weight / scale).T)


class SplitGroupCosineLinear(_Sigma):
    """(``cosine_linear.py:144-159``): ``fc1`` / ``fc2`` group heads, concatenated."""

    def __init__(self, in_features: int, features1: int, features2: int, use_sigma: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__(use_sigma)
        self.fc1 = GroupCosineLinear(in_features, features1, use_sigma=False, generator=generator)
        self.fc2 = GroupCosineLinear(in_features, features2, use_sigma=False, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._scaled(torch.cat([self.fc1(x), self.fc2(x)], dim=-1))
