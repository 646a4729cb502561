"""Dynamic-graph CNN on KNN feature graphs.

Counterpart of ``grl_tpu/models/dgcnn.py``: in each block a KNN graph is
rebuilt in feature space, the edge features ``[x_j - x_i, x_i]`` pass a
bias-free Dense over the channel axis (the reference's 1x1 conv), a
BatchNorm over ``(B, V, k)`` and a leaky ReLU, then a max over the
neighbours. The adjacency of the inputs is not read. float32, no dropout:
the network launches none of the port's kernels.

``torch.topk`` promises no order among equal distances where
``jax.lax.top_k`` returns the lowest index first. Ties are exact between
identical rows (padded nodes are zero rows), whose edge features are
equal, and the max over neighbours does not see their order: the outputs
agree, the neighbour index lists may not.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import nn

from grl_torch.models.base import register_model
from grl_torch.models.gcn_family import _default_generator
from grl_torch.models.layers import Dense, FlaxBatchNorm, Rngs, leaky_relu
from grl_torch.utils.device import DeviceLike, resolve_device

# Widths of the four edge-conv blocks (dgcnn.py:75).
BLOCK_WIDTHS = (64, 64, 128, 256)


def knn_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices ``(B, V, k)`` of the ``k`` nearest neighbours of each row of
    ``x (B, V, F)`` in feature space, by the largest
    ``-||x_i||^2 + 2 x_i.x_j - ||x_j||^2`` (``dgcnn.py:21-31``)."""
    inner = -2.0 * torch.einsum("bvf,bwf->bvw", x, x)
    sq = torch.sum(x * x, dim=-1)
    neg_dist = -sq[:, :, None] - inner - sq[:, None, :]
    return torch.topk(neg_dist, k, dim=-1).indices


def knn_edge_features(x: torch.Tensor, k: int, idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Edge features ``[x_j - x_i, x_i]`` ``(B, V, k, 2F)`` over the
    ``min(k, V)`` nearest neighbours (``dgcnn.py:34-43``)."""
    B, V, F_ = x.shape
    k = min(k, V)
    if idx is None:
        idx = knn_indices(x, k)
    neighbors = x[torch.arange(B, device=x.device)[:, None, None], idx]  # (B, V, k, F)
    center = x[:, :, None, :].expand(B, V, k, F_)
    return torch.cat([neighbors - center, center], dim=-1)


class _ConvBlock(nn.Module):
    """Bias-free Dense ``conv`` + flax BatchNorm ``bn`` + leaky ReLU at 0.2
    (``dgcnn.py:46-56``)."""

    def __init__(self, in_features: int, features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = Dense(in_features, features, generator=generator, use_bias=False)
        self.bn = FlaxBatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(self.bn(self.conv(x)), 0.2)


@register_model
class DGCNN(nn.Module):
    """(``dgcnn.py:59-82``): four edge-conv blocks ``conv1``..``conv4`` on
    KNN graphs of ``kk`` neighbours, their outputs concatenated (512 wide)
    into ``conv5``, whose output is the logits ``(B, V, out_channels)``."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kk: int = 20,
        *,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        target = resolve_device(device)
        gen = _default_generator(generator)
        self.out_channels = out_channels
        self.kk = kk
        width = in_channels
        for i, features in enumerate(BLOCK_WIDTHS):
            setattr(self, f"conv{i + 1}", _ConvBlock(2 * width, features, gen))
            width = features
        self.conv5 = _ConvBlock(sum(BLOCK_WIDTHS), out_channels, gen)
        self.to(target)

    @property
    def output_dim(self) -> int:
        """The class count the procedures read (``dgcnn.py:80-82``)."""
        return self.out_channels

    def forward(self, inputs: Tuple[torch.Tensor, Any], rngs: Optional[Rngs] = None,
                lambda_value: Any = None) -> torch.Tensor:
        del rngs, lambda_value  # no random layer; the procedure passes both to every network
        x = inputs[0]
        feats = []
        for i in range(len(BLOCK_WIDTHS)):
            edge = knn_edge_features(x, self.kk)
            x = torch.amax(getattr(self, f"conv{i + 1}")(edge), dim=2)
            feats.append(x)
        return self.conv5(torch.cat(feats, dim=-1))
