"""Self-supervised GCN: the trunk with task-switched SSL heads, and DGI.

Counterparts of ``grl_tpu/models/ssl_gcn.py`` (:48-216). Module names are
flax's, so ``state_dict_from_flax`` carries either tree across as it is:
``SSLGCN``'s ``trunk``, ``head_<task>``, ``w_rand`` (the frozen RanPAC
buffer) and ``classifier``; ``DGI``'s ``encoder.*`` and
``discriminator.bilinear`` / ``.bias`` (``bilinear`` is not a flax
``Dense`` kernel, so it keeps its ``(d, d)`` layout).

``SSLGCN``'s trunk is ``GCNTrunk(edge_dropout_rate=0.0, g1_first=True)``
at the default ``kernel_impl="xla"`` and no compute dtype, as ``grl_tpu``
builds it: float32, plain aggregation, so this model launches no K1, K2 or
K3, and D in every dropout layer of a train-mode forward.

``grl_tpu``'s two deliberate departures from the reference stand: the
node-classification branch runs the trunk, RanPAC and the classifier as
the flagship does, and the SSL pair heads gather endpoints with batch
offsets (local indices ``+ b * N``), right for any batch size.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from grl_torch.models.base import register_model
from grl_torch.models.gcn_family import GCNTrunk, _default_generator
from grl_torch.models.layers import Dense, Dropout, RanPAC, Rngs
from grl_torch.utils.device import DeviceLike, resolve_device

SSL_TASKS = (
    "node_property",
    "edge_mask",
    "pairwise_distance",
    "pairwise_similarity",
    "graph_edit_distance",
    "graph_classification",
)
# The tasks whose head scores pairs of nodes given as (B, E, 2) endpoints.
PAIR_TASKS = ("edge_mask", "pairwise_distance", "pairwise_similarity")


def _graph_embedding(node_emb: torch.Tensor) -> torch.Tensor:
    """``[max ; mean]`` pooled over the nodes, ``(B, 1, 2d)``
    (reference: sll_gcn.py:96-120)."""
    return torch.cat(
        [node_emb.amax(dim=1, keepdim=True), node_emb.mean(dim=1, keepdim=True)], dim=-1
    )


@register_model
class SSLGCN(nn.Module):
    """``forward(inputs, rngs=None, task=None, edges=None, lambda_value=None)``:

    * ``task=None``: node-classification logits ``(B, N, output_dim)``;
    * ``"node_property"``: ``(B, N, 1)``;
    * a pair task: ``(B, E, out)`` for ``edges (B, E, 2)`` of per-sample
      node indices;
    * ``"graph_edit_distance"``: ``inputs = (V, A, V_aug, A_aug)``, ``(B, 1, 1)``;
    * ``"graph_classification"``: ``(B, 1, n_graph_classes)``;
    * ``"dgi"``: ``inputs = (V, A, V_neg, A_neg)``, the two node embeddings
      ``(pos, neg)``.

    Every task runs the trunk anew, with its own dropout draws from
    ``rngs`` in train mode.
    """

    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        num_edges: int,
        n_pairwise_distance: int = 4,
        n_graph_classes: int = 204,
        net_size: int = 256,
        use_attention: bool = True,
        rp_factor: int = 10,
        dropout_rate: float = 0.5,
        edge_dropout_rate: float = 0.3,
        *,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        target = resolve_device(device)
        gen = _default_generator(generator)
        self.output_dim = output_dim
        self.num_edges = num_edges
        self.n_graph_classes = n_graph_classes
        self.net_size = net_size
        # edge_dropout_rate is grl_tpu's field, read by nothing: SSLGCN's
        # trunk applies no DropEdge (sll_gcn.py:53-62 passes A straight to
        # each gcn).
        del edge_dropout_rate
        half = net_size // 2
        self.trunk = GCNTrunk(
            input_dim,
            net_size=net_size,
            num_edges=num_edges,
            dropout_rate=dropout_rate,
            edge_dropout_rate=0.0,
            g1_first=True,
            use_attention=use_attention,
            generator=gen,
        )
        self.head_node_property = Dense(half, 1, generator=gen)
        self.head_edge_mask = Dense(half, 1, generator=gen)
        self.head_pairwise_distance = Dense(half, n_pairwise_distance, generator=gen)
        self.head_pairwise_similarity = Dense(half, 1, generator=gen)
        self.head_graph_edit_distance = Dense(net_size, 1, generator=gen)
        self.head_graph_classification = Dense(net_size, n_graph_classes, generator=gen)
        rp_size = half * rp_factor
        self.w_rand = RanPAC(half, rp_size, generator=gen)
        self.dropout = Dropout(dropout_rate)
        self.classifier = Dense(rp_size, output_dim, generator=gen)
        self.to(target)

    def _node_emb(self, inputs: Tuple[torch.Tensor, Any], rngs: Optional[Rngs]) -> torch.Tensor:
        return self.dropout(self.trunk(inputs, rngs), rngs)

    def forward(
        self,
        inputs: Tuple[torch.Tensor, ...],
        rngs: Optional[Rngs] = None,
        task: Optional[str] = None,
        edges: Optional[torch.Tensor] = None,
        lambda_value: Optional[float] = None,
    ) -> Any:
        # The procedure passes lambda_value to every network; this one does
        # not read it.
        del lambda_value
        if task == "node_property":
            return self.head_node_property(self._node_emb(inputs, rngs))
        if task in PAIR_TASKS:
            node_emb = self._node_emb(inputs, rngs)
            B, N, d = node_emb.shape
            flat = node_emb.reshape(-1, d)
            edges = edges.long()
            offsets = (torch.arange(B, device=flat.device) * N)[:, None]
            src = flat[(edges[:, :, 0] + offsets).reshape(-1)]
            dst = flat[(edges[:, :, 1] + offsets).reshape(-1)]
            out = getattr(self, f"head_{task}")(torch.abs(src - dst))
            return out.reshape(B, edges.shape[1], -1)
        if task == "graph_edit_distance":
            src_emb = _graph_embedding(self._node_emb(inputs[:2], rngs))
            dst_emb = _graph_embedding(self._node_emb(inputs[2:], rngs))
            return self.head_graph_edit_distance(torch.abs(src_emb - dst_emb))
        if task == "graph_classification":
            return self.head_graph_classification(_graph_embedding(self._node_emb(inputs, rngs)))
        if task == "dgi":
            return self._node_emb(inputs[:2], rngs), self._node_emb(inputs[2:], rngs)
        if task is not None:
            raise ValueError(f"SSLGCN has no task {task!r}; tasks: {SSL_TASKS + ('dgi',)}")
        node_emb = self._node_emb(inputs, rngs)
        node_emb = self.dropout(F.relu(self.w_rand(node_emb)), rngs)
        return self.classifier(node_emb)


class ReadOut(nn.Module):
    """Mean-pool + sigmoid graph summary (reference: dgi.py:31-38)."""

    def forward(self, V: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(V.mean(dim=1))


class Discriminator(nn.Module):
    """Bilinear pos/neg scorer (reference: dgi.py:40-58): ``H W s + bias``
    for each node's row of H against the graph summary s."""

    def __init__(self, input_dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        # flax xavier_uniform on (d, d): U(-sqrt(6 / 2d), sqrt(6 / 2d)).
        limit = (6.0 / (2 * input_dim)) ** 0.5
        bilinear = torch.empty(input_dim, input_dim).uniform_(-limit, limit, generator=generator)
        self.bilinear = nn.Parameter(bilinear)
        self.bias = nn.Parameter(torch.zeros(1))

    def forward(self, S: torch.Tensor, H_pos: torch.Tensor, H_neg: torch.Tensor):
        S = S[:, None, :]  # (B, 1, d)

        def score(H: torch.Tensor) -> torch.Tensor:
            return torch.einsum("bnd,de,bme->bn", H, self.bilinear, S) + self.bias

        return score(H_pos), score(H_neg)


@register_model
class DGI(nn.Module):
    """Deep Graph Infomax contrastive wrapper (reference: dgi.py:5-28).

    ``encoder`` is a module returning node embeddings of width
    ``output_dim`` (``SSLGCN`` in ``dgi`` task mode), held as
    ``self.encoder`` so that the state dict has ``grl_tpu``'s ``encoder.*``
    paths. ``forward`` is the encoder's node classification;
    :meth:`forward_contrastive` scores the embeddings. The discriminator's
    parameters are drawn from ``generator`` and placed on ``device``: with
    the encoder's, which exist already, they are what ``grl_tpu``'s
    ``init_dgi_variables`` merges from its two init passes.
    """

    def __init__(
        self,
        encoder: nn.Module,
        output_dim: int,
        *,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        target = resolve_device(device)
        self.encoder = encoder
        self.output_dim = output_dim
        self.readout = ReadOut()
        self.discriminator = Discriminator(output_dim, _default_generator(generator))
        self.to(target)

    def forward(self, V: torch.Tensor, A: torch.Tensor, rngs: Optional[Rngs] = None) -> torch.Tensor:
        return self.encoder((V, A), rngs=rngs)

    def forward_contrastive(self, H_pos: torch.Tensor, H_neg: torch.Tensor) -> torch.Tensor:
        """``(B, 2N)`` scores: the positive nodes', then the negatives'."""
        pos, neg = self.discriminator(self.readout(H_pos), H_pos, H_neg)
        return torch.cat([pos, neg], dim=1)
