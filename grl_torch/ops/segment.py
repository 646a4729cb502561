"""Segment reductions for sparse message passing.

Counterpart of ``grl_tpu/ops/segment.py`` on ``index_add_`` and
``scatter_reduce_``. Empty segments sum to 0 and have a maximum of
``-inf`` (the identity, as ``jax.ops.segment_max`` gives); a softmax
segment with no unmasked entry yields zeros.
"""
from __future__ import annotations

from typing import Optional

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``out[k] = sum of data[i] over segment_ids[i] == k``, in data's dtype."""
    out = torch.zeros((num_segments, *data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids.long(), data)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``out[k] = max of data[i] over segment_ids[i] == k``; the dtype's
    lowest value (``-inf`` for floats) where a segment is empty."""
    lowest = -torch.inf if data.dtype.is_floating_point else torch.iinfo(data.dtype).min
    out = torch.full((num_segments, *data.shape[1:]), lowest, dtype=data.dtype, device=data.device)
    index = segment_ids.long().reshape(-1, *([1] * (data.dim() - 1))).expand_as(data)
    return out.scatter_reduce_(0, index, data, reduce="amax", include_self=True)


def segment_softmax(
    logits: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Numerically stable softmax over the entries of each segment
    (``segment.py:32-54``); masked entries get 0."""
    if mask is not None:
        logits = torch.where(mask, logits, -torch.inf)
    seg_max = segment_max(logits, segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    exp = torch.exp(logits - seg_max[segment_ids.long()])
    if mask is not None:
        exp = torch.where(mask, exp, 0.0)
    denom = segment_sum(exp, segment_ids, num_segments)
    denom = torch.where(denom == 0.0, 1.0, denom)
    return exp / denom[segment_ids.long()]
