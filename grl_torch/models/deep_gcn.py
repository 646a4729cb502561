"""Deep GCN stacks with BatchNorm blocks and interleaved RanPAC.

Counterparts of ``grl_tpu/models/deep_gcn.py``: ``DeepRPGCN`` (a 29-layer
stack, the skip buffer refreshed every 3 layers) and ``DeepRPRobustGCN``
(9 GCN blocks with skip-concats, RanPAC scaled by the schedulable
``lambda_value``, self-attention). Every block is a :class:`GCNBlock` whose
BatchNorm keeps running statistics (``*.norm.bn.mean`` / ``.var``) that a
train-mode forward updates in place. Both are float32 on the plain
aggregation path, as ``grl_tpu`` builds them: their kernel is D, in every
dropout layer.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from grl_torch.models.base import register_model
from grl_torch.models.gcn_family import Inputs, _default_generator
from grl_torch.models.layers import (
    Dense,
    Dropout,
    EdgeDropout,
    EmbeddingBlock,
    GCNBlock,
    NodeSelfAtten,
    RanPAC,
    Rngs,
    leaky_relu,
)
from grl_torch.utils.device import DeviceLike, resolve_device

# Reference constants (deep_gcn.py:26-29).
NUM_GCN_LAYERS = 29
RP_LAYER_RELATIVE_POSITION: Optional[int] = None
SKIP_CONNECTION_POS = 3
# Leaky ReLU slope after a RanPAC of either network (deep_gcn.py:72, 136).
RP_SLOPE = 0.2


@register_model
class DeepRPGCN(nn.Module):
    """29-layer GCN stack, skip-concat every 3 layers (``deep_gcn.py:32-77``).

    At each skip position (``idx % skip_connection_pos == 0``, index 0
    included) the skip buffer is refreshed to the current features and the
    block reads ``[buffer, features]``, which is the features twice (the
    reference's order of operations), so those blocks are
    ``2 * net_size`` wide. ``rp_relative_position`` interleaves a frozen
    RanPAC (``rp<idx>``) after every such block; ``rp_size`` is
    ``grl_tpu``'s field and unused, as there."""

    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        num_edges: int,
        net_size: int = 256,
        rp_size: Optional[int] = 10000,
        lambda_value: float = 0.01,
        num_layers: int = NUM_GCN_LAYERS,
        skip_connection_pos: Optional[int] = SKIP_CONNECTION_POS,
        rp_relative_position: Optional[int] = RP_LAYER_RELATIVE_POSITION,
        dropout_rate: float = 0.3,
        *,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        target = resolve_device(device)
        gen = _default_generator(generator)
        del rp_size
        self.output_dim = output_dim
        self.num_edges = num_edges
        self.num_layers = num_layers
        self.skip_connection_pos = skip_connection_pos
        self.rp_relative_position = rp_relative_position
        self.emb1 = EmbeddingBlock(input_dim, net_size, gen)
        for idx in range(num_layers):
            skip = bool(skip_connection_pos) and idx % skip_connection_pos == 0
            setattr(self, f"gcn{idx}", GCNBlock((2 if skip else 1) * net_size, net_size, num_edges, gen))
            if rp_relative_position and idx % rp_relative_position == 0:
                setattr(self, f"rp{idx}", RanPAC(net_size, net_size, init_scale=(net_size ** 0.5) * lambda_value,
                                                 generator=gen))
        self.emb2 = EmbeddingBlock(net_size, net_size, gen)
        self.dropout = Dropout(dropout_rate)
        self.classifier = Dense(net_size, output_dim, generator=gen)
        self.to(target)

    def forward(self, inputs: Inputs, rngs: Optional[Rngs] = None, lambda_value: Any = None) -> torch.Tensor:
        del lambda_value  # passed to every network by the procedure; not read here
        V, A = inputs
        feats = self.emb1(V)
        skip = self.skip_connection_pos
        for idx in range(self.num_layers):
            if skip and idx % skip == 0:
                prev_feats = feats
                feats = torch.cat([prev_feats, feats], dim=-1)
            feats = getattr(self, f"gcn{idx}")(feats, A)
            if self.rp_relative_position and idx % self.rp_relative_position == 0:
                feats = leaky_relu(getattr(self, f"rp{idx}")(feats), RP_SLOPE)
        feats = self.dropout(self.emb2(feats), rngs)
        return self.classifier(feats)


@register_model
class DeepRPRobustGCN(nn.Module):
    """9 GCN blocks with skip-concats + RanPAC (init scale ``sqrt(net_size)``)
    + self-attention (``deep_gcn.py:79-140``).

    ``lambda_value`` is read at call time as RanPAC's ``scale``: the
    procedure's per-step cosine lambda, a float in eager steps and a
    one-element device tensor in a captured chunk, either multiplying on
    the device; ``None`` (serving) is the constructor's value. ``gcn3``,
    ``gcn6``, ``gcn8`` and ``gcn9`` run on a DropEdge'd adjacency, each
    with a fresh mask. Dropout after ``gcn3``, ``gcn6``, ``gcn9`` and on the
    attended features: four D launches a train-mode forward."""

    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        num_edges: int,
        net_size: int = 256,
        use_attention: bool = True,
        rp_size: Optional[int] = 10000,
        lambda_value: float = 0.01,
        dropout_rate: float = 0.3,
        edge_dropout_rate: float = 0.2,
        *,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        target = resolve_device(device)
        gen = _default_generator(generator)
        del rp_size
        self.output_dim = output_dim
        self.num_edges = num_edges
        self.lambda_value = lambda_value
        self.emb1 = EmbeddingBlock(input_dim, net_size, gen)
        for idx in range(1, 10):
            width = 2 * net_size if idx in (3, 6) else net_size
            setattr(self, f"gcn{idx}", GCNBlock(width, net_size, num_edges, gen))
        self.emb2 = EmbeddingBlock(2 * net_size, net_size, gen)
        self.rp_embed2 = RanPAC(net_size, net_size, init_scale=(net_size ** 0.5) * 1.0, generator=gen)
        self.self_atten = NodeSelfAtten(net_size, generator=gen) if use_attention else None
        self.classifier = Dense(net_size, output_dim, generator=gen)
        self.dropout = Dropout(dropout_rate)
        self.edge_dropout = EdgeDropout(edge_dropout_rate)
        self.to(target)

    def _block(self, idx: int, feats: torch.Tensor, A: Any, drop_edges: bool, rngs: Optional[Rngs]) -> torch.Tensor:
        gcn = getattr(self, f"gcn{idx}")
        if drop_edges:
            A_used, self_scale = self.edge_dropout(A, not self.training, rngs)
            return gcn(feats, A_used, self_scale)
        return gcn(feats, A)

    def forward(self, inputs: Inputs, rngs: Optional[Rngs] = None, lambda_value: Any = None) -> torch.Tensor:
        V, A = inputs
        lam = self.lambda_value if lambda_value is None else lambda_value
        embedding = self.emb1(V)
        g1 = self._block(1, embedding, A, False, rngs)
        g2 = self._block(2, g1, A, False, rngs)
        g3 = self.dropout(self._block(3, torch.cat([g1, g2], dim=-1), A, True, rngs), rngs)
        g4 = self._block(4, g3, A, False, rngs)
        g5 = self._block(5, g4, A, False, rngs)
        g6 = self.dropout(self._block(6, torch.cat([g4, g5], dim=-1), A, True, rngs), rngs)
        g7 = self._block(7, g6, A, False, rngs)
        g8 = self._block(8, g7, A, True, rngs)
        g9 = self.dropout(self._block(9, g8, A, True, rngs), rngs)
        feats = self.emb2(torch.cat([g8, g9], dim=-1))
        feats = leaky_relu(self.rp_embed2(feats, scale=lam), RP_SLOPE)
        if self.self_atten is not None:
            feats = self.self_atten(feats)
        return self.classifier(self.dropout(feats, rngs))
