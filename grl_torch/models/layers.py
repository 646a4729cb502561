"""Core layers of the model family, as ``nn.Module``s.

Counterparts of ``grl_tpu/models/layers.py``. Parameter names, shapes and
init distributions follow the flax modules, so a flax variables tree maps
onto these state dicts one to one (:mod:`grl_torch.models.convert`):
a flax ``Dense`` kernel ``(in, out)`` is a ``weight (out, in)`` here, and
``GraphConv.h_weights`` keeps the JAX layout ``((L+1)F, C)``.

Mixed precision follows ``maybe_cast``: parameters stay float32 master
copies and are cast with the activations to the compute dtype at use.

Randomness is explicit, as ``rngs={"dropout": key}`` is in flax: a
train-mode forward takes an :class:`Rngs` whose generators draw every
dropout and DropEdge mask; nothing reads PyTorch's global generator.

The adjacency is a dense ``(B, N, L, N)`` tensor, or a sparse
:class:`~grl_torch.ops.sparse.RelationalGraph`, sampled
:class:`~grl_torch.ops.tree.TreeGraph` or node-partitioned
:class:`~grl_torch.parallel.graph_partition.LocalShardGraph` (one rank's
block of a graph, aggregated by a ring halo exchange) with flat
``(num_nodes, F)`` features; a graph with a planned K5, K6 or K7 kernel
(:class:`~grl_torch.ops.kernels.KernelAdjacency`) aggregates through it.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from grl_torch.ops.dropout import dropout
from grl_torch.parallel.graph_partition import LocalShardGraph, ring_aggregate
from grl_torch.parallel.mesh import copy_to_model, gather_from_model, reduce_from_model, scatter_to_model
from grl_torch.ops.relconv import drop_edge, relational_neighbor_aggregate
from grl_torch.ops.segment import segment_softmax, segment_sum
from grl_torch.ops.sparse import RelationalGraph, drop_edge_coo, relational_neighbor_coo
from grl_torch.ops.tree import TreeGraph, tree_neighbor_aggregate


# How far a Dropout layer's ``stream`` moves its seed (Dropout.stream).
STREAM_STRIDE = 1_000_003


def maybe_cast(x: Optional[torch.Tensor], dtype: Optional[torch.dtype]) -> Optional[torch.Tensor]:
    """Cast ``x`` to the compute dtype when mixed precision is enabled."""
    if x is None or dtype is None:
        return x
    return x.to(dtype)


class Rngs:
    """The random streams of a train-mode forward.

    ``device`` is a generator on the tensors' device and draws every mask
    (DropEdge on the plain path, the self-loop mask of the kernel path) and
    every seed of the DropEdge kernels K1/K2, K5 and K6 and of dropout's D
    (:meth:`kernel_seed`): a one-element tensor on the device that the
    kernels read there, so that drawing a seed never waits on the device
    and a captured CUDA graph that registers this generator draws new
    seeds, and new masks, at every replay. It advances with every draw: one
    ``Rngs`` serves a run.
    """

    def __init__(self, device: torch.Generator):
        self.device = device

    @classmethod
    def from_seed(cls, seed: int, device: torch.device) -> "Rngs":
        return cls(torch.Generator(device=device).manual_seed(seed))

    def kernel_seed(self) -> torch.Tensor:
        """A fresh seed for one K1/K2, K5, K6 or D mask (``gcn_family.py:92``,
        ``layers.py:218-220``): an int32 tensor of one element on the
        generator's device."""
        return torch.randint(0, 2**31 - 1, (1,), generator=self.device, device=self.device.device,
                             dtype=torch.int32)


def require_rngs(rngs: Optional[Rngs]) -> Rngs:
    """``rngs``, or a ``ValueError`` naming what a random forward needs."""
    if rngs is None:
        raise ValueError(
            "a train-mode forward with dropout or DropEdge needs rngs=Rngs(...), "
            "as grl_tpu needs rngs={'dropout': key}"
        )
    return rngs


def _normal(shape, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator)


def is_sparse_adjacency(A: Any) -> bool:
    """True for a :class:`RelationalGraph`, a :class:`TreeGraph` or a
    node-partitioned :class:`LocalShardGraph`, False for a dense strided
    tensor; any other adjacency raises."""
    if isinstance(A, (RelationalGraph, TreeGraph, LocalShardGraph)):
        return True
    if isinstance(A, torch.Tensor) and A.layout == torch.strided:
        return False
    raise NotImplementedError(
        f"grl_torch takes a dense (B, N, L, N) tensor, a RelationalGraph, a TreeGraph or a "
        f"LocalShardGraph, not {type(A).__name__} (layout {getattr(A, 'layout', None)}); torch "
        "sparse layouts are not an adjacency of the model family."
    )


def has_kernel(A: Any) -> bool:
    """A sparse graph with a planned aggregation kernel (K5)."""
    return isinstance(A, RelationalGraph) and getattr(A, "kernel", None) is not None


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` with ``weight = kernel.T``.

    Init matches flax's defaults: truncated (+-2 std) lecun-normal kernel,
    zero bias. With ``dtype`` set, input and parameters are cast to it.
    """

    def __init__(self, in_features: int, features: int,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        # variance_scaling(1.0, "fan_in", "truncated_normal"): the std of a
        # standard normal truncated to [-2, 2] is 0.87962566103423978.
        weight = torch.empty(features, in_features)
        if weight.numel():  # a 0-wide input (DiffPooling's 0-wide relations) has nothing to draw
            std = (1.0 / in_features) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dtype)
        tp = getattr(self, "tensor_parallel", None)
        if tp is None:
            return F.linear(x.to(dtype), self.weight.to(dtype), bias)
        # Row-sharded (grl_torch.parallel.mesh.shard_params): this rank's
        # input columns (taken here from a whole input) times its weight
        # rows, the partial outputs summed over the model axis, the bias
        # added once after the sum.
        if x.shape[-1] != self.weight.shape[1]:
            x = scatter_to_model(x, tp)
        out = reduce_from_model(F.linear(x.to(dtype), self.weight.to(dtype)), tp)
        return out if bias is None else out + bias


class LinearReLU(nn.Module):
    """``Linear -> ReLU`` (``layers.py:50-58``)."""

    def __init__(self, in_features: int, features: int,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear = Dense(in_features, features, dtype, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.linear(x))


class GraphConv(nn.Module):
    """Multi-relational graph convolution (``layers.py:61-193``).

    Projects ``[self | rel_0 | ... | rel_{L-1}]`` with one weight
    ``h_weights ((L+1)F, C)`` split as ``w_self = h[:F]`` and
    ``w_neigh = h[F:]``; the relation-major neighbor term ``(B, N, L*F)``
    meets ``w_neigh``'s rows in that order. Dense, ``precomputed_neigh``
    (K3/K1) and sparse branches; on a graph whose kernel planned projected
    tables (ELL's ``plan_projected``), a width-reducing conv projects first.
    """

    def __init__(self, in_features: int, features: int, num_relations: int,
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.features = features
        self.num_relations = num_relations
        fan_in, fan_out = in_features * (num_relations + 1), features
        std = (2.0 / (fan_in + fan_out)) ** 0.5  # xavier-normal (layers.py:43-47)
        self.h_weights = nn.Parameter(_normal((fan_in, fan_out), generator) * std)
        self.bias = (
            nn.Parameter(1e-4 + 5e-5 * _normal((features,), generator))
            if use_bias else None
        )

    def forward(
        self,
        V: torch.Tensor,
        A: Any = None,
        self_scale: Optional[torch.Tensor] = None,
        edge_keep: Any = None,
        precomputed_neigh: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> torch.Tensor:
        F_in = V.shape[-1]
        h_weights = maybe_cast(self.h_weights, self.dtype)
        w_self, w_neigh = h_weights[:F_in], h_weights[F_in:]
        if precomputed_neigh is not None:
            # From the kernel path (K3, or K1 in training): (self_term, neigh (B, N, L, F)).
            self_term, neigh = precomputed_neigh
            neigh = neigh.reshape(*neigh.shape[:-2], -1)
        else:
            if has_kernel(A):
                # K5/K6: DropEdge is fused in the kernel by the per-edge
                # hash, so EdgeDropout hands over (seed, rate).
                seed, rate = (0, 0.0) if edge_keep is None else edge_keep
                if getattr(getattr(A.kernel, "tables", None), "proj", None) is not None \
                        and F_in > self.features:
                    # Project first (layers.py:126-158): sum_r A_r (V W_r)
                    # gathers at the output width C instead of L*F_in.
                    self_term = V if self_scale is None else V * self_scale[..., None]
                    L = self.num_relations
                    Wr = w_neigh.reshape(L, F_in, self.features)
                    Vr = torch.einsum("nf,lfc->nlc", maybe_cast(V, self.dtype), Wr)
                    neigh_term = A.kernel.neighbor_aggregate_projected(
                        Vr.reshape(L * V.shape[0], self.features), seed, rate)
                    out = (torch.matmul(maybe_cast(self_term, self.dtype), w_self)
                           + maybe_cast(neigh_term, self.dtype))
                    return self._add_bias(out)
                neigh = A.kernel.neighbor_aggregate(V, seed, rate)
            elif isinstance(A, LocalShardGraph):
                # Node-partitioned (layers.py:104-111): the ring halo
                # exchange, overlapped with the local gather and sum.
                w = A.weights if edge_keep is None else A.weights * edge_keep
                neigh = ring_aggregate(V, A, w)
            elif isinstance(A, TreeGraph):
                # The sampled minibatch: its endpoints are positional, so
                # the aggregation is a reshape and an einsum a level.
                neigh = tree_neighbor_aggregate(V, A, edge_keep)
            elif is_sparse_adjacency(A):
                neigh = relational_neighbor_coo(V, A, edge_keep)
            else:
                neigh = relational_neighbor_aggregate(V, A)
            self_term = V if self_scale is None else V * self_scale[..., None]
        self_term = maybe_cast(self_term, self.dtype)
        neigh = maybe_cast(neigh, self.dtype)
        out = torch.matmul(self_term, w_self) + torch.matmul(neigh, w_neigh)
        return self._add_bias(out)

    def _add_bias(self, out: torch.Tensor) -> torch.Tensor:
        if self.bias is not None:
            out = out + maybe_cast(self.bias, self.dtype)
        return out


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in train mode, ``where(mask, x / keep, 0)``
    with an iid keep mask; the identity in eval mode or at rate 0, zeros
    at rate 1. The mask is D's (:mod:`grl_torch.ops.dropout`): K0's hash
    of each element's index under a seed drawn from ``rngs.device``
    (``Rngs.kernel_seed``), regenerated in the backward."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate
        # Set on a layer that sees one rank's columns of a tensor-parallel
        # activation (grl_torch.parallel.mesh.shard_params): its seed is
        # moved by the rank's index, so the ranks' columns get masks of
        # their own while the generators stay in step.
        self.stream = 0

    def forward(self, x: torch.Tensor, rngs: Optional[Rngs] = None) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        seed = require_rngs(rngs).kernel_seed()
        if self.stream:
            seed = ((seed.long() + self.stream * STREAM_STRIDE) % (2**31 - 1)).to(torch.int32)
        return dropout(x, seed, self.rate)


class EdgeDropout(nn.Module):
    """DropEdge on the (logically) preprocessed adjacency (``layers.py:196-232``).

    ``nn.Dropout(p)`` on the reference's ``(B,(L+1)N,N)`` operand: iid
    keep, ``1/(1-p)`` rescale, self-loops included. Returns, for
    :class:`GraphConv`:

    * dense A: ``(A_dropped, self_scale (B, N))`` (:func:`drop_edge`), or
      ``(A, None)`` when deterministic or at rate 0;
    * a graph with a planned kernel: ``((seed, rate), self_scale (num_nodes,))``
      — K5 or K6 regenerates the edge mask from the seed, a device tensor
      drawn as K1's is; only the self-loop mask is drawn here;
    * a plain RelationalGraph: ``(edge_keep (E,), self_scale (num_nodes,))``
      (:func:`drop_edge_coo`); a TreeGraph the same, with ``edge_keep``
      shaped as its ``(G, E)`` weights;
    * a sparse graph when deterministic or at rate 0: ``(None, None)``.
    """

    def __init__(self, rate: float = 0.3):
        super().__init__()
        self.rate = rate

    def forward(self, A: Any, deterministic: bool, rngs: Optional[Rngs] = None):
        sparse = is_sparse_adjacency(A)
        if deterministic or self.rate <= 0.0:
            return (None, None) if sparse else (A, None)
        rngs = require_rngs(rngs)
        if has_kernel(A):
            seed = rngs.kernel_seed()
            keep = 1.0 - self.rate
            self_mask = torch.rand((A.num_nodes,), generator=rngs.device, device=A.device) < keep
            return (seed, self.rate), self_mask.to(torch.float32) / keep
        if sparse:
            return drop_edge_coo(A, self.rate, rngs.device)
        return drop_edge(A, self.rate, rngs.device)


class NodeSelfAtten(nn.Module):
    """SAGAN-style global node self-attention (``layers.py:235-258``).

    ``gamma * softmax(f(V) g(V)^T) h(V) + V``, softmax in float32.
    """

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.f = LinearReLU(features, features // 8, dtype, generator)
        self.g = LinearReLU(features, features // 8, dtype, generator)
        self.h = LinearReLU(features, features, dtype, generator)
        self.gamma = nn.Parameter(_normal((features,), generator))

    def forward(self, V: torch.Tensor) -> torch.Tensor:
        f_out, g_out, h_out = self.f(V), self.g(V), self.h(V)
        scores = torch.matmul(f_out, g_out.transpose(-1, -2))
        s = maybe_cast(torch.softmax(scores.float(), dim=-1), self.dtype)
        o = torch.matmul(s, h_out)
        return maybe_cast(self.gamma, self.dtype) * o + V


class SparseNodeSelfAtten(NodeSelfAtten):
    """Edge-restricted node self-attention over a :class:`RelationalGraph`
    (``layers.py:261-303``), with :class:`NodeSelfAtten`'s parameters.

    Scores only on edges (receiver attends to sender), a softmax per
    receiver, and the weighted sum of sender values: through K4 when the
    graph carries a planned ``atten_kernel``, else the segment path in the
    compute dtype. ``graph=None`` is the dense layer, which ``grl_tpu``
    runs on a dense adjacency whatever ``attention_impl`` says.
    """

    def forward(self, V: torch.Tensor, graph: Optional[RelationalGraph] = None) -> torch.Tensor:
        if graph is None:
            return super().forward(V)
        f_out, g_out, h_out = self.f(V), self.g(V), self.h(V)
        atten_kernel = getattr(graph, "atten_kernel", None)
        if atten_kernel is not None:
            o = atten_kernel.attend(f_out, g_out, h_out)
        else:
            send, recv = graph.senders.long(), graph.receivers.long()
            scores = torch.sum(f_out[recv] * g_out[send], dim=-1)
            alpha = segment_softmax(scores.float(), recv, graph.num_nodes, mask=graph.mask)
            alpha = alpha.to(self.dtype or V.dtype)
            o = segment_sum(h_out[send] * alpha[:, None], recv, graph.num_nodes)
        return maybe_cast(self.gamma, self.dtype) * o.to(V.dtype) + V


class RanPAC(nn.Module):
    """Frozen random projection (``layers.py:306-332``).

    The ``(in, features)`` kernel is a buffer, not a parameter: it is saved
    in the state dict but never optimised (flax keeps it in ``constants``).
    """

    def __init__(self, in_features: int, features: int, init_scale: float = 1.0,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("kernel", _normal((in_features, features), generator) * init_scale)

    def forward(self, x: torch.Tensor, scale: Any = 1.0) -> torch.Tensor:
        """``(x @ kernel) * scale``: ``scale`` is a float, or a one-element
        tensor on the device (a captured chunk's per-step lambda), which
        multiplies on the device with no host read."""
        tp = getattr(self, "tensor_parallel", None)
        if tp is None:
            return torch.matmul(x, maybe_cast(self.kernel, self.dtype)) * scale
        # Column-sharded (grl_torch.parallel.mesh.shard_params): this rank's
        # output columns, gathered unless the consumer is row-sharded.
        out = torch.matmul(copy_to_model(x, tp), maybe_cast(self.kernel, self.dtype)) * scale
        return gather_from_model(out, tp) if tp.gather else out


def leaky_relu(x: torch.Tensor, negative_slope: float) -> torch.Tensor:
    """flax's ``nn.leaky_relu``, ``where(x >= 0, x, slope * x)``: its
    gradient at exactly 0 is 1, where ``F.leaky_relu``'s is the slope (a
    BatchNorm or LayerNorm output on a padded row is its bias, 0 at init)."""
    return torch.where(x >= 0, x, negative_slope * x)


def _moments(x: torch.Tensor, axes: Tuple[int, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
    """flax's statistics (``normalization._compute_stats``): the mean over
    ``axes`` and the biased variance as ``E[x^2] - E[x]^2``, clipped at 0,
    in at least float32 (``torch.maximum`` splits the gradient at a tie
    with 0 as ``jnp.maximum`` does)."""
    wide = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = wide.mean(dim=axes)
    mean2 = (wide * wide).mean(dim=axes)
    var = mean2 - mean * mean
    return mean, torch.maximum(var, torch.zeros_like(var))


def _normalize(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, epsilon: float,
               scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """flax's ``_normalize``: ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""
    y = (x - mean) * (torch.rsqrt(var + epsilon) * scale) + bias
    return y.to(torch.promote_types(x.dtype, scale.dtype))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: ``scale`` (ones) and
    ``bias`` (zeros), flax's statistics (:func:`_moments`)."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = _moments(x, (-1,))
        return _normalize(x, mean[..., None], var[..., None], self.epsilon, self.scale, self.bias)


class FlaxBatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over every axis but the last (padded nodes
    included): parameters ``scale`` / ``bias``, running statistics in the
    buffers ``mean`` (from 0) and ``var`` (from 1), as flax keeps them in
    ``batch_stats``.

    In train mode it normalises with the batch's mean and biased variance
    (:func:`_moments`) and updates the buffers in place, ``mean <- m * mean
    + (1 - m) * batch_mean`` and the same for ``var`` with the biased batch
    variance (``torch.nn.BatchNorm1d`` and ``F.batch_norm`` keep the
    unbiased one, so neither is used). In place, never rebound: a chunk of
    steps captured as a CUDA graph updates the very buffers that eval and
    the checkpoint read. In eval mode it normalises with the buffers.
    """

    def __init__(self, features: int, momentum: float = 0.9, epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return _normalize(x, self.mean, self.var, self.epsilon, self.scale, self.bias)
        mean, var = _moments(x, tuple(range(x.dim() - 1)))
        with torch.no_grad():
            self.mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
            self.var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        return _normalize(x, mean, var, self.epsilon, self.scale, self.bias)


class BatchNorm(nn.Module):
    """BatchNorm over the (batch, node) axes per channel (``layers.py:335-369``):
    flax's ``nn.BatchNorm`` as the submodule ``bn``.

    With ``masked=True`` it also holds ``mask_scale`` / ``mask_bias``, and a
    train-mode call with ``mask (B, N)`` normalises with the statistics of
    the valid nodes alone and those parameters, leaving ``bn``'s running
    statistics as they are (grl_tpu creates the two parameters at the first
    such call). Eval mode, or no mask, is ``bn``.
    """

    def __init__(self, features: int, momentum: float = 0.9, epsilon: float = 1e-5, masked: bool = False):
        super().__init__()
        self.epsilon = epsilon
        self.bn = FlaxBatchNorm(features, momentum, epsilon)
        if masked:
            self.mask_scale = nn.Parameter(torch.ones(features))
            self.mask_bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if mask is None or not self.training:
            return self.bn(x)
        if not hasattr(self, "mask_scale"):
            raise ValueError("a masked BatchNorm call needs BatchNorm(..., masked=True)")
        w = mask[..., None].to(x.dtype)
        count = torch.clamp(w.sum(), min=1.0)
        mean = (x * w).sum(dim=(0, 1)) / count
        var = ((x - mean) ** 2 * w).sum(dim=(0, 1)) / count
        return (x - mean) * torch.rsqrt(var + self.epsilon) * self.mask_scale + self.mask_bias


class GCNBlock(nn.Module):
    """GraphConv + BatchNorm + LeakyReLU(0.2) (``layers.py:372-391``), as
    ``gcn`` and ``norm``."""

    def __init__(self, in_features: int, features: int, num_relations: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.gcn = GraphConv(in_features, features, num_relations, generator=generator)
        self.norm = BatchNorm(features)

    def forward(self, V: torch.Tensor, A: Any, self_scale: Optional[torch.Tensor] = None,
                edge_keep: Any = None) -> torch.Tensor:
        return leaky_relu(self.norm(self.gcn(V, A, self_scale, edge_keep)), 0.2)


class EmbeddingBlock(nn.Module):
    """Linear + BatchNorm + LeakyReLU(0.2) (``layers.py:394-403``), as
    ``emb`` and ``norm``."""

    def __init__(self, in_features: int, features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.emb = Dense(in_features, features, generator=generator)
        self.norm = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(self.norm(self.emb(x)), 0.2)
