"""The DropEdge GCN trunk, the flagship ``GraphCNNDropEdge`` and its
family: ``RobustGCN``, ``RPGraphCNNDropEdge`` and ``ModGCN``.

Counterparts of ``grl_tpu/models/gcn_family.py``. Call convention:
``model((V, A), head_rows=None, rngs=None)`` with ``V (B, N, F_in)`` and
``A (B, N, L, N)`` in the dataset layout, or flat ``V (num_nodes, F_in)``
and a :class:`grl_torch.ops.sparse.RelationalGraph` (or a sampled
:class:`grl_torch.ops.tree.TreeGraph`) for the sparse path;
train or eval mode is the module's own (``model.train()`` /
``model.eval()``), and a train-mode forward with dropout or DropEdge draws
its masks from ``rngs`` (:class:`grl_torch.models.layers.Rngs`), as flax
draws them from ``rngs={"dropout": key}``.

``kernel_impl`` reads the same YAML values as ``grl_tpu``. On the dense
path ``"pallas"`` runs the neighbor aggregation through the hand-written
CUDA kernels — K3 in eval (:func:`grl_torch.ops.relagg.neighbor_aggregate`),
K1 with K2 as its backward in training
(:func:`grl_torch.ops.relagg.dropedge_aggregate`); any other value runs the
plain ``torch.matmul`` path with :func:`grl_torch.ops.relconv.drop_edge`,
as ``grl_tpu`` runs XLA. On the sparse path the graph carries its planned
kernel (:func:`grl_torch.ops.kernels.attach_kernel`: K6 for ``"ell"`` and
``"pallas"``, K5 for ``"pallas_csr"``), and ``"xla"`` runs the COO
segment sum.
``attention_impl: sparse`` runs the edge-restricted attention on a sparse
graph (K4 when the graph carries a planned ``atten_kernel``).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from grl_torch.models.base import register_model
from grl_torch.models.cosine_linear import CosineLinear, SplitCosineLinear
from grl_torch.models.layers import (
    Dense,
    Dropout,
    EdgeDropout,
    GraphConv,
    LinearReLU,
    NodeSelfAtten,
    RanPAC,
    Rngs,
    SparseNodeSelfAtten,
    is_sparse_adjacency,
    leaky_relu,
    maybe_cast,
    require_rngs,
)
from grl_torch.ops.relagg import dropedge_aggregate, neighbor_aggregate
from grl_torch.ops.sparse import RelationalGraph
from grl_torch.utils.device import DeviceLike, optional_dtype, resolve_device

Inputs = Tuple[torch.Tensor, Any]

# Leaky ReLU slope after each RanPAC of RPGraphCNNDropEdge (gcn_family.py:313-322).
RP_SLOPE = 0.01


def _default_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


class GCNTrunk(nn.Module):
    """emb1 -> 3x GraphConv with skip-concats -> emb2 (-> self-attention)."""

    def __init__(
        self,
        input_dim: int,
        net_size: int = 256,
        num_edges: int = 6,
        dropout_rate: float = 0.5,
        edge_dropout_rate: float = 0.3,
        g1_first: bool = True,
        use_attention: bool = True,
        attention_impl: str = "dense",
        kernel_impl: str = "xla",
        compute_dtype: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        gen = _default_generator(generator)
        dtype = optional_dtype(compute_dtype)
        self.dtype = dtype
        self.g1_first = g1_first
        self.attention_impl = attention_impl
        self.kernel_impl = kernel_impl
        self.edge_dropout_rate = edge_dropout_rate
        # One generator draws every parameter, in construction order.
        self.emb1 = LinearReLU(input_dim, net_size, dtype, gen)
        self.gcn1 = GraphConv(net_size, net_size, num_edges, dtype=dtype, generator=gen)
        self.gcn2 = GraphConv(net_size, net_size, num_edges, dtype=dtype, generator=gen)
        self.gcn3 = GraphConv(2 * net_size, net_size, num_edges, dtype=dtype, generator=gen)
        self.emb2 = LinearReLU(2 * net_size, net_size // 2, dtype, gen)
        # One parameter set (f, g, h, gamma) whichever attention runs.
        atten = SparseNodeSelfAtten if attention_impl == "sparse" else NodeSelfAtten
        self.self_atten = atten(net_size // 2, dtype, gen) if use_attention else None
        self.edge_dropout = EdgeDropout(edge_dropout_rate)
        self.dropout = Dropout(dropout_rate)

    def _kernel_agg(
        self, feats: torch.Tensor, A: torch.Tensor, det: bool, rngs: Optional[Rngs]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Kernel aggregation (``_pallas_agg``, ``gcn_family.py:74-99``):
        ``(self_term, neigh (B,N,L,F))``.

        In training, K1 draws the neighbor mask from a fresh seed drawn on
        the device (K2 regenerates it in the backward from the same tensor), and the self term takes a
        ``(B, N)`` keep mask from the device generator: the diagonal of
        relation 0 of the preprocessed operand, which the kernel never sees.
        """
        if det or self.edge_dropout_rate <= 0.0:
            return feats, neighbor_aggregate(feats, A)
        rngs = require_rngs(rngs)
        neigh = dropedge_aggregate(feats, A, rngs.kernel_seed(), self.edge_dropout_rate)
        keep = 1.0 - self.edge_dropout_rate
        B, N, _ = feats.shape
        self_mask = torch.rand((B, N), generator=rngs.device, device=feats.device) < keep
        self_term = feats * (self_mask.to(feats.dtype) / keep)[..., None]
        return self_term, neigh

    def _gcn(self, conv: GraphConv, feats: torch.Tensor, A: Any, sparse: bool, det: bool,
             rngs: Optional[Rngs]) -> torch.Tensor:
        if sparse:
            # Only a RelationalGraph can carry a kernel (gcn_family.py:128-131):
            # a TreeGraph aggregates by its einsums whatever kernel_impl says.
            if (self.kernel_impl != "xla" and isinstance(A, RelationalGraph)
                    and getattr(A, "kernel", None) is None):
                raise ValueError(
                    f"kernel_impl={self.kernel_impl!r} on a sparse RelationalGraph with no "
                    "planned kernel: attach one with grl_torch.ops.kernels.attach_kernel "
                    "(static graphs / FullGraphProcedure do this automatically) or set "
                    "kernel_impl='xla' for per-batch COO graphs."
                )
            edge_keep, self_scale = self.edge_dropout(A, det, rngs)
            out = conv(feats, A, self_scale, edge_keep)
        elif self.kernel_impl == "pallas":
            out = conv(feats, precomputed_neigh=self._kernel_agg(feats, A, det, rngs))
        else:
            A_used, self_scale = self.edge_dropout(A, det, rngs)
            out = conv(feats, A_used, self_scale)
        return self.dropout(F.relu(out), rngs)

    def forward(self, inputs: Inputs, rngs: Optional[Rngs] = None, first_only: bool = False) -> torch.Tensor:
        V, A = inputs
        sparse = is_sparse_adjacency(A)
        det = not self.training
        V = maybe_cast(V, self.dtype)
        if not sparse:
            A = maybe_cast(A, self.dtype)
        if first_only:
            # emb1 -> gcn1 -> relu, no dropout of any kind (gcn_family.py:117-123).
            return F.relu(self.gcn1(self.emb1(V), A))
        embedding = self.dropout(self.emb1(V), rngs)
        g1 = self._gcn(self.gcn1, embedding, A, sparse, det, rngs)
        g2 = self._gcn(self.gcn2, g1, A, sparse, det, rngs)
        cat12 = [g1, g2] if self.g1_first else [g2, g1]
        g3 = self._gcn(self.gcn3, torch.cat(cat12, dim=-1), A, sparse, det, rngs)
        cat13 = [g1, g3] if self.g1_first else [g3, g1]
        new_v = self.emb2(torch.cat(cat13, dim=-1))
        if self.self_atten is None:
            return new_v
        if sparse and not isinstance(A, RelationalGraph):
            raise ValueError(
                "NodeSelfAtten runs on a dense adjacency or a RelationalGraph, not on a "
                f"{type(A).__name__} (gcn_family.py:160-166); build sampled and partitioned "
                "models with use_attention=False."
            )
        if sparse and self.attention_impl == "sparse":
            return self.self_atten(new_v, A)
        if sparse:
            # Dense attention per document of a flat batch graph.
            if A.batch_shape is None:
                raise ValueError(
                    "Dense NodeSelfAtten on a flat sparse graph needs batch_shape to "
                    "unflatten; set attention_impl='sparse' or use_attention=False for "
                    "single large graphs."
                )
            B_, N_ = A.batch_shape
            return self.self_atten(new_v.reshape(B_, N_, -1)).reshape(B_ * N_, -1)
        return self.self_atten(new_v)


@register_model
class GraphCNNDropEdge(nn.Module):
    """The flagship KV-extraction model (``gcn_family.py:188-248``).

    Trunk + frozen RanPAC expansion (``half_net * rp_factor``) + linear
    classifier; logits are returned in float32. Parameters are drawn from
    ``generator`` (a fresh one seeded 0 if omitted) and placed on
    ``device`` (CUDA unless ``device="cpu"`` is passed).

    Under tensor parallelism (``grl_torch.parallel.mesh.shard_params``)
    ``w_rand``'s columns stay sharded into the row-sharded classifier, and
    the dropout between them sees one rank's columns.
    """

    TP_SHARDED_OUTPUTS = ("w_rand", "dropout")

    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        num_edges: int,
        net_size: int = 256,
        use_attention: bool = True,
        attention_impl: str = "dense",
        rp_factor: int = 10,
        dropout_rate: float = 0.5,
        edge_dropout_rate: float = 0.3,
        kernel_impl: str = "xla",
        compute_dtype: Optional[str] = None,
        *,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        target = resolve_device(device)
        gen = _default_generator(generator)
        dtype = optional_dtype(compute_dtype)
        # Read by the procedures, as grl_tpu reads the flax module's fields.
        self.output_dim = output_dim
        self.num_edges = num_edges
        self.compute_dtype = compute_dtype
        self.net_size = net_size
        self.use_attention = use_attention
        self.attention_impl = attention_impl
        self.kernel_impl = kernel_impl
        self.trunk = GCNTrunk(
            input_dim,
            net_size=net_size,
            num_edges=num_edges,
            dropout_rate=dropout_rate,
            edge_dropout_rate=edge_dropout_rate,
            g1_first=True,
            use_attention=use_attention,
            attention_impl=attention_impl,
            kernel_impl=kernel_impl,
            compute_dtype=compute_dtype,
            generator=gen,
        )
        half = net_size // 2
        rp_size = half * rp_factor
        self.w_rand = RanPAC(half, rp_size, dtype=dtype, generator=gen)
        self.dropout = Dropout(dropout_rate)
        self.classifier = Dense(rp_size, output_dim, dtype, gen)
        self.to(target)

    def forward(
        self,
        inputs: Inputs,
        head_rows: Optional[Tuple[int, int, int]] = None,
        rngs: Optional[Rngs] = None,
        lambda_value: Optional[float] = None,
    ) -> torch.Tensor:
        # The procedure passes lambda_value to every network; this one does
        # not read it.
        del lambda_value
        new_v = self.trunk(inputs, rngs)
        if head_rows is not None:
            # (groups, rows_per_group, keep): the head runs only on the
            # first `keep` rows of each group (sampled-minibatch path).
            G, rows, keep = head_rows
            new_v = new_v.reshape(G, rows, new_v.shape[-1])[:, :keep]
            new_v = new_v.reshape(G * keep, new_v.shape[-1])
        new_v = self.dropout(F.relu(self.w_rand(new_v)), rngs)
        # Loss/softmax always in float32.
        return self.classifier(new_v).float()


@register_model
class RobustGCN(nn.Module):
    """No-DropEdge trunk + gcn4/gcn5 tail at ``net_size // 2``
    (``gcn_family.py:251-280``): the trunk with ``g1_first=False``, then
    dropout, ``gcn4`` -> relu -> dropout, ``gcn5`` -> relu, and the
    classifier. float32 and the plain aggregation, as ``grl_tpu`` builds it
    (no ``kernel_impl`` or ``compute_dtype``): D is its only kernel, in six
    dropout layers a train-mode forward."""

    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        num_edges: int,
        net_size: int = 256,
        use_attention: bool = True,
        dropout_rate: float = 0.5,
        *,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        target = resolve_device(device)
        gen = _default_generator(generator)
        self.output_dim = output_dim
        self.num_edges = num_edges
        half = net_size // 2
        self.trunk = GCNTrunk(input_dim, net_size=net_size, num_edges=num_edges, dropout_rate=dropout_rate,
                              edge_dropout_rate=0.0, g1_first=False, use_attention=use_attention, generator=gen)
        self.gcn4 = GraphConv(half, half, num_edges, generator=gen)
        self.gcn5 = GraphConv(half, half, num_edges, generator=gen)
        self.classifier = Dense(half, output_dim, generator=gen)
        self.dropout = Dropout(dropout_rate)
        self.to(target)

    def forward(self, inputs: Inputs, rngs: Optional[Rngs] = None, lambda_value: Any = None) -> torch.Tensor:
        del lambda_value  # passed to every network by the procedure; not read here
        A = inputs[1]
        new_v = self.dropout(self.trunk(inputs, rngs), rngs)
        g4 = self.dropout(F.relu(self.gcn4(new_v, A)), rngs)
        g5 = F.relu(self.gcn5(g4, A))
        return self.classifier(g5)


@register_model
class RPGraphCNNDropEdge(nn.Module):
    """DropEdge trunk + two scaled RanPAC layers (``gcn_family.py:283-324``).

    Both frozen RanPAC kernels (``rp_emb``, ``rp_final``) are drawn at
    ``init_scale = sqrt(rp_size) * lambda_value``, each followed by a leaky
    ReLU at 0.01; ``NodeSelfAtten`` runs at ``rp_size`` width between them.
    float32 and the plain aggregation, as in ``grl_tpu``: D is its only
    kernel (five dropout layers a train-mode forward). Under tensor
    parallelism ``rp_emb``'s columns are gathered for the attention and
    ``rp_final``'s stay sharded into the row-sharded classifier."""

    TP_SHARDED_OUTPUTS = ("rp_final", "dropout")

    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        num_edges: int,
        net_size: int = 256,
        use_attention: bool = True,
        rp_size: int = 10000,
        lambda_value: float = 0.05,
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
        self.trunk = GCNTrunk(input_dim, net_size=net_size, num_edges=num_edges, dropout_rate=dropout_rate,
                              edge_dropout_rate=edge_dropout_rate, g1_first=True, use_attention=False,
                              generator=gen)
        init_scale = (rp_size ** 0.5) * lambda_value
        self.rp_emb = RanPAC(net_size // 2, rp_size, init_scale=init_scale, generator=gen)
        self.self_atten = NodeSelfAtten(rp_size, generator=gen) if use_attention else None
        self.rp_final = RanPAC(rp_size, rp_size, init_scale=init_scale, generator=gen)
        self.dropout = Dropout(dropout_rate)
        self.classifier = Dense(rp_size, output_dim, generator=gen)
        self.to(target)

    def forward(self, inputs: Inputs, rngs: Optional[Rngs] = None, lambda_value: Any = None) -> torch.Tensor:
        del lambda_value  # the RanPAC scale is fixed at init here
        new_v = leaky_relu(self.rp_emb(self.trunk(inputs, rngs)), RP_SLOPE)
        if self.self_atten is not None:
            new_v = self.self_atten(new_v)
        new_v = leaky_relu(self.rp_final(new_v), RP_SLOPE)
        return self.classifier(self.dropout(new_v, rngs))


@register_model
class ModGCN(nn.Module):
    """DropEdge trunk + cosine classifier for class-incremental learning
    (``gcn_family.py:327-377``).

    ``forward(inputs, rngs=None, mode=None, return_feats=False)``:
    ``mode="first_node_emb"`` is the trunk's emb1 -> gcn1 -> relu with no
    dropout; ``"node_emb"`` the trunk's features after dropout; otherwise
    the cosine logits (``SplitCosineLinear(prev_output_dim, output_dim)``
    when ``prev_output_dim`` is set, else ``CosineLinear``), with the
    features too under ``return_feats``. float32 and the plain aggregation,
    as in ``grl_tpu``."""

    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        num_edges: int,
        prev_output_dim: Optional[int] = None,
        net_size: int = 256,
        use_attention: bool = True,
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
        self.trunk = GCNTrunk(input_dim, net_size=net_size, num_edges=num_edges, dropout_rate=dropout_rate,
                              edge_dropout_rate=edge_dropout_rate, g1_first=True, use_attention=use_attention,
                              generator=gen)
        half = net_size // 2
        self.classifier = (SplitCosineLinear(half, prev_output_dim, output_dim, generator=gen) if prev_output_dim
                           else CosineLinear(half, output_dim, generator=gen))
        self.dropout = Dropout(dropout_rate)
        self.to(target)

    def forward(self, inputs: Inputs, rngs: Optional[Rngs] = None, mode: Optional[str] = None,
                return_feats: bool = False, lambda_value: Any = None):
        del lambda_value  # passed to every network by the procedure; not read here
        if mode == "first_node_emb":
            return self.trunk(inputs, rngs, first_only=True)
        feats = self.dropout(self.trunk(inputs, rngs), rngs)
        if mode == "node_emb":
            return feats
        logits = self.classifier(feats)
        return (logits, feats) if return_feats else logits
