"""GAT family: per-relation masked attention layers (V1 and GATv2),
dense-connectivity stacks, DiffPool and the GATV2 network.

Counterparts of ``grl_tpu/models/gatv2.py``, op for op: the per-relation
loop over the ``L`` relations and the identity relation ``eye(N)``, the
dense ``N x N`` scores, the masks at ``-9e15`` (V1, V2) and ``-1e10``
(``RelGraphAttention``). Parameter names are flax's (``W_<l>``, ``a_<l>``,
``W_src_<l>``, ``W_dst_<l>``, ``norm_<l>``, ``squeeze``, ``map``; ``w``,
``a_src``, ``a_dst``), none of them a Dense kernel, so
``state_dict_from_flax`` carries them across in their flax shapes. The
input widths flax infers from the first call are constructor arguments
(``in_features``), and ``MakeDenseGAT`` computes its growing concat widths.

Every dropout is the port's :class:`~grl_torch.models.layers.Dropout`, so
it runs D on the card; a V2 layer drops its input features and its
attention weights in each relation, a V1 layer the attention weights.
float32 throughout, with no other kernel, as ``grl_tpu`` runs XLA here.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from grl_torch.models.base import register_model
from grl_torch.models.gcn_family import _default_generator
from grl_torch.models.layers import Dense, Dropout, FlaxBatchNorm, LayerNorm, Rngs, leaky_relu
from grl_torch.utils.device import DeviceLike, resolve_device

# Masked scores (gatv2.py:81, 131, 172).
MASKED = -9e15
REL_MASKED = -1e10


def _xavier_uniform(shape: Sequence[int], generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``xavier_uniform`` (``variance_scaling(1, "fan_avg",
    "uniform")``): fans from the last two axes, times the product of the
    others."""
    receptive = math.prod(shape[:-2])
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    limit = math.sqrt(6.0 / max(fan_in + fan_out, 1))
    return torch.rand(tuple(shape), generator=generator) * (2 * limit) - limit


def _param(shape: Sequence[int], generator: Optional[torch.Generator]) -> nn.Parameter:
    return nn.Parameter(_xavier_uniform(shape, generator))


def _eye_or(adj: torch.Tensor, l: int, no_A: int) -> torch.Tensor:
    """Relation ``l``'s mask ``(B, N, N)``, or ``eye(N)`` for the identity
    relation ``l == no_A``."""
    if l < no_A:
        return adj[:, :, l, :]
    N = adj.shape[1]
    return torch.eye(N, dtype=adj.dtype, device=adj.device)[None]


class Norm(nn.Module):
    """LayerNorm (default) or BatchNorm as ``norm``, then leaky ReLU at 0.01
    (``gatv2.py:26-40``)."""

    def __init__(self, features: int, bn: bool = False):
        super().__init__()
        self.norm = FlaxBatchNorm(features) if bn else LayerNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(self.norm(x), 0.01)


class _RelationalLayer(nn.Module):
    """What V1 and V2 share: the ``squeeze`` Dense over the relations'
    concatenated outputs and the residual (``map`` Dense where the input
    width differs from ``features``, else the input itself)."""

    def _finish(self, V: torch.Tensor, outputs) -> torch.Tensor:
        output = self.squeeze(torch.cat(outputs, dim=-1))
        return output + (self.map(V) if self.map is not None else V)

    def _residual(self, in_features: int, features: int, width: int, generator) -> None:
        self.squeeze = Dense(width, features, generator=generator)
        self.map = Dense(in_features, features, generator=generator) if in_features != features else None


class GraphAttentionLayer(_RelationalLayer):
    """GAT V1 per-relation attention (``gatv2.py:43-94``): in each relation
    ``l`` (the ``no_A`` relations and the identity), scores
    ``leaky_relu(e @ a_l, 0.01)`` on the reference's interleaved pair
    tensor ``e`` (``[repeat(h, N) ; tile(h, N)]`` viewed as ``(B, N, N,
    2 sq)``), masked, softmax over neighbours, dropout, the weighted sum of
    ``h = V W_l`` and ``norm_l``; then squeeze and residual. ``multi_head``
    is unused, as there."""

    def __init__(self, in_features: int, no_A: int, features: int, dropout: float = 0.3, multi_head: int = 4,
                 ratio: int = 8, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.no_A = no_A
        sq = features // ratio
        for l in range(no_A + 1):
            setattr(self, f"W_{l}", _param((in_features, sq), generator))
            setattr(self, f"a_{l}", _param((2 * sq, 1), generator))
            setattr(self, f"norm_{l}", Norm(sq))
        self._residual(in_features, features, (no_A + 1) * sq, generator)
        self.dropout = Dropout(dropout)

    def forward(self, V: torch.Tensor, adj: torch.Tensor, rngs: Optional[Rngs] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B, N, _ = V.shape
        outputs = []
        for l in range(self.no_A + 1):
            h = V @ getattr(self, f"W_{l}")  # (B, N, sq)
            sq = h.shape[-1]
            hi = torch.repeat_interleave(h, N, dim=1)  # row i*N+t = h_i
            hj = h.repeat(1, N, 1)  # row i*N+t = h_t
            e = torch.cat([hi, hj], dim=1).reshape(B, N, N, 2 * sq)
            e = leaky_relu((e @ getattr(self, f"a_{l}"))[..., 0], 0.01)
            att = torch.where(_eye_or(adj, l, self.no_A) > 0, e, MASKED)
            att = self.dropout(torch.softmax(att, dim=2), rngs)
            out = torch.einsum("bnm,bmf->bnf", att, h)
            outputs.append(getattr(self, f"norm_{l}")(out))
        return self._finish(V, outputs), adj


class GraphAttentionLayerV2(_RelationalLayer):
    """GATv2 per-relation multi-head attention (``gatv2.py:97-144``): in each
    relation, input dropout, ``src = V W_src_l`` and ``dst = V W_dst_l`` as
    ``(B, N, H, sq)``, scores ``sum(leaky_relu(src_i + dst_j, 0.01) * a_l)``
    per head, masked, softmax over neighbours, dropout, the heads' weighted
    sums of ``src`` added into ``(B, N, sq)`` and ``norm_l``; then squeeze
    and residual."""

    def __init__(self, in_features: int, no_A: int, features: int, dropout: float = 0.3, multi_head: int = 4,
                 ratio: int = 16, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.no_A = no_A
        self.multi_head = multi_head
        self.sq = sq = features // ratio
        for l in range(no_A + 1):
            setattr(self, f"W_src_{l}", _param((in_features, sq * multi_head), generator))
            setattr(self, f"W_dst_{l}", _param((in_features, sq * multi_head), generator))
            setattr(self, f"a_{l}", _param((1, 1, 1, multi_head, sq), generator))
            setattr(self, f"norm_{l}", Norm(sq))
        self._residual(in_features, features, (no_A + 1) * sq, generator)
        self.dropout = Dropout(dropout)

    def forward(self, V: torch.Tensor, adj: torch.Tensor, rngs: Optional[Rngs] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B, N, _ = V.shape
        H = self.multi_head
        outputs = []
        for l in range(self.no_A + 1):
            feats = self.dropout(V, rngs)
            src = (feats @ getattr(self, f"W_src_{l}")).reshape(B, N, H, self.sq)
            dst = (feats @ getattr(self, f"W_dst_{l}")).reshape(B, N, H, self.sq)
            e = leaky_relu(src[:, :, None, :, :] + dst[:, None, :, :, :], 0.01)  # (B, N_i, N_j, H, sq)
            scores = torch.sum(e * getattr(self, f"a_{l}")[0, 0, 0], dim=-1)  # (B, N, N, H)
            mask = _eye_or(adj, l, self.no_A)[..., None]
            att = torch.where(mask > 0, scores, MASKED)
            att = self.dropout(torch.softmax(att, dim=2), rngs)
            out = torch.einsum("bnjh,bjhs->bns", att, src)
            outputs.append(getattr(self, f"norm_{l}")(out))
        return self._finish(V, outputs), adj


class RelGraphAttention(nn.Module):
    """Per-relation masked multi-head GAT of IJCAI19 HGAT (``gatv2.py:147-181``):
    heads are relations (``n_head == L``), tanh-gated source and target
    scores, leaky ReLU at ``slope``, non-edges at ``-1e10``, softmax,
    dropout, the heads' outputs concatenated ``(B, N, features * n_head)``."""

    def __init__(self, in_features: int, features: int, n_head: int, attn_dropout: float = 0.2,
                 use_bias: bool = True, slope: float = 0.2, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = features
        self.n_head = n_head
        self.slope = slope
        self.w = _param((n_head, in_features, features), generator)
        self.a_src = _param((n_head, features, 1), generator)
        self.a_dst = _param((n_head, features, 1), generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.dropout = Dropout(attn_dropout)

    def forward(self, h: torch.Tensor, adj: torch.Tensor, rngs: Optional[Rngs] = None) -> torch.Tensor:
        B, N, _ = h.shape
        h_prime = torch.einsum("bnf,kfc->bknc", h, self.w)  # (B, heads, N, C)
        attn_src = torch.einsum("bknc,kco->bkno", torch.tanh(h_prime), self.a_src)[..., 0]
        attn_dst = torch.einsum("bknc,kco->bkno", torch.tanh(h_prime), self.a_dst)[..., 0]
        attn = leaky_relu(attn_src[:, :, :, None] + attn_dst[:, :, None, :], self.slope)
        mask = 1.0 - adj.permute(0, 2, 1, 3)  # (B, L, N, N)
        attn = torch.where(mask > 0, REL_MASKED, attn)
        attn = self.dropout(torch.softmax(attn, dim=-1), rngs)
        output = torch.einsum("bknm,bkmc->bknc", attn, h_prime)
        if self.bias is not None:
            output = output + self.bias
        return output.permute(0, 2, 1, 3).reshape(B, N, self.features * self.n_head)


class MakeDenseGAT(nn.Module):
    """Dense-connectivity GAT stack (``gatv2.py:184-206``): ``layer_<r>``
    reads the input and every earlier output concatenated
    (``in_features + r * input_feature`` wide), ``squeeze_block`` all of
    them."""

    def __init__(self, in_features: int, input_feature: int, no_A: int, repeat_time: int,
                 layer_cls: Any = GraphAttentionLayer, drop: float = 0.3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.repeat_time = repeat_time
        for r in range(repeat_time):
            setattr(self, f"layer_{r}", layer_cls(in_features + r * input_feature, no_A, input_feature, drop,
                                                  generator=generator))
        self.squeeze_block = layer_cls(in_features + repeat_time * input_feature, no_A, input_feature, drop,
                                       generator=generator)

    def forward(self, V: torch.Tensor, A: torch.Tensor, rngs: Optional[Rngs] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        stacked = V
        for r in range(self.repeat_time):
            update, _ = getattr(self, f"layer_{r}")(stacked, A, rngs)
            stacked = torch.cat([stacked, update], dim=-1)
        out, _ = self.squeeze_block(stacked, A, rngs)
        return out, A


class DiffPooling(nn.Module):
    """Soft cluster pooling (``gatv2.py:209-237``): a ``feature_layer`` and
    an ``adjacent_layer`` (4 heads, ratio 16, or 1 for one output node), the
    assignment ``S = softmax(adjacent_layer)``. One output node: ``relu(S^T
    relu(X_feat))`` reshaped to ``(-1, X.shape[2])``. More: ``leaky_relu(S^T
    relu(X_feat), 0.01)`` and the pooled ``A_out = S^T A S`` per relation,
    with dropout."""

    def __init__(self, in_features: int, out_feature: int, output_node: int, no_A: int = 4,
                 layer_cls: Any = GraphAttentionLayer, drop: float = 0.3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.output_node = output_node
        ratio = 16 if output_node != 1 else 1
        self.feature_layer = layer_cls(in_features, no_A, out_feature, drop, 4, ratio, generator=generator)
        self.adjacent_layer = layer_cls(in_features, no_A, output_node, drop, 4, ratio, generator=generator)
        self.dropout = Dropout(drop)

    def forward(self, X: torch.Tensor, A: torch.Tensor, rngs: Optional[Rngs] = None):
        feat, _ = self.feature_layer(X, A, rngs)
        assign, _ = self.adjacent_layer(X, A, rngs)
        X_feat = F.relu(feat)
        S = torch.softmax(assign, dim=-1)  # (B, N, output_node)
        S_T = S.transpose(1, 2)
        if self.output_node == 1:
            out = F.relu(torch.einsum("bkn,bnf->bkf", S_T, X_feat))
            return out.reshape(-1, X.shape[2]), A
        X_out = leaky_relu(torch.einsum("bkn,bnf->bkf", S_T, X_feat), 0.01)
        A_out = torch.einsum("bkn,bnlm,bmj->bklj", S_T, A, S)
        return X_out, self.dropout(A_out, rngs)


class TuneSequential(nn.Module):
    """Tuple-threading sequential (``gatv2.py:240-254``): a stage's tuple
    output is splatted into the next stage; every stage gets ``rngs``. The
    stages are ``layers_<i>``, as flax names a tuple field's modules."""

    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        self.depth = len(layers)
        for i, layer in enumerate(layers):
            setattr(self, f"layers_{i}", layer)

    def forward(self, *inputs: Any, rngs: Optional[Rngs] = None) -> Any:
        out: Any = inputs
        for i in range(self.depth):
            layer = getattr(self, f"layers_{i}")
            out = layer(*out, rngs=rngs) if isinstance(out, tuple) else layer(out, rngs=rngs)
        return out


class MakeParameterScale(nn.Module):
    """One learnable scalar ``parameter``, ``U[0, 1)`` at init (``gatv2.py:257-264``)."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.parameter = nn.Parameter(torch.rand(1, generator=generator))

    def forward(self) -> torch.Tensor:
        return self.parameter


@register_model
class GATV2(nn.Module):
    """The exported GAT network (``gatv2.py:267-301``): ``gat_in`` (256
    wide), ``dense_gat`` (two dense layers and a squeeze block), ``gat_out``,
    then ``mlp`` and ``class_output``. The reference's activation between
    the two Dense layers is ``LeakyReLU(True)``, slope 1.0: the identity,
    so none runs. ``use_v2`` picks GATv2 layers, else V1."""

    def __init__(
        self,
        input_feature: int,
        no_A: int = 6,
        output_feature: int = 128,
        num_classes: int = 36,
        use_v2: bool = True,
        *,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        target = resolve_device(device)
        gen = _default_generator(generator)
        self.num_classes = num_classes
        layer_cls = GraphAttentionLayerV2 if use_v2 else GraphAttentionLayer
        self.gat_in = layer_cls(input_feature, no_A, 256, 0.3, generator=gen)
        self.dense_gat = MakeDenseGAT(256, 256, no_A, 2, layer_cls, 0.3, generator=gen)
        self.gat_out = layer_cls(256, no_A, 256, 0.3, generator=gen)
        self.mlp = Dense(256, output_feature, generator=gen)
        self.class_output = Dense(output_feature, num_classes, generator=gen)
        self.to(target)

    @property
    def output_dim(self) -> int:
        """The class count the procedures read (``gatv2.py:293-295``)."""
        return self.num_classes

    @staticmethod
    def l2_norm(x: torch.Tensor) -> torch.Tensor:
        """(``gatv2.py:297-301``)."""
        norm = torch.sqrt(torch.sum(x * x, dim=2) + 1e-10)
        return x / norm[..., None]

    def forward(self, inputs: Tuple[torch.Tensor, torch.Tensor], rngs: Optional[Rngs] = None,
                lambda_value: Any = None) -> torch.Tensor:
        del lambda_value  # passed to every network by the procedure; not read here
        V, A = inputs
        x, A = self.gat_in(V, A, rngs)
        x, A = self.dense_gat(x, A, rngs)
        x, A = self.gat_out(x, A, rngs)
        return self.class_output(self.mlp(x))
