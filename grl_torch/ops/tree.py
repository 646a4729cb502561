"""Positional-tree aggregation: the sampled minibatch's adjacency.

Counterpart of ``grl_tpu/ops/tree.py``. The neighbor sampler's minibatches
are positional sampling trees (:mod:`grl_torch.data.neighbor_sampler`):
level k+1 holds exactly ``fanouts[k]`` child slots per level-k parent, in
contiguous positions. The edge endpoints are therefore the same for every
batch and only the per-edge weights and relations change, so the
relational aggregation needs neither gathers nor scatters: each level is a
reshape of the child span to ``(parents, fanout, F)`` and a weighted
(one-hot relation) reduction, ``torch.einsum``.

:class:`TreeGraph` takes the sparse branch of ``GraphConv`` and
``EdgeDropout`` (:func:`grl_torch.models.layers.is_sparse_adjacency`), and
DropEdge reaches it through :func:`grl_torch.ops.sparse.drop_edge_coo`
with the same iid keep and rescale as on a COO graph.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class TreeGraph:
    """Group-stacked positional sampling-tree adjacency.

    ``weights (G, E)`` float32 and ``relations (G, E)`` int32 hold the edges
    in the sampler's level-major order (level k's edges contiguous, in
    child-slot order); masked and padding edges carry weight 0. The
    endpoints are implied by the static tree geometry."""

    weights: torch.Tensor  # (G, E) float32
    relations: torch.Tensor  # (G, E) int32
    level_sizes: Tuple[int, ...]
    fanouts: Tuple[int, ...]
    num_relations: int

    @property
    def groups(self) -> int:
        return self.weights.shape[0]

    @property
    def nodes_per_group(self) -> int:
        return int(sum(self.level_sizes))

    @property
    def num_nodes(self) -> int:
        return self.groups * self.nodes_per_group

    @property
    def batch_shape(self) -> Tuple[int, int]:
        return (self.groups, self.nodes_per_group)

    @property
    def device(self) -> torch.device:
        return self.weights.device


def tree_neighbor_aggregate(V: torch.Tensor, tree: TreeGraph,
                            edge_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Neighbor-only aggregation ``(G*maxN, L*F)`` in V's dtype: the
    scatter-free equivalent of
    :func:`grl_torch.ops.sparse.relational_neighbor_coo` on the tree's
    implied COO edges (the same relation-major layout, so the same
    ``GraphConv`` weights apply). ``edge_keep (G, E)`` scales the weights
    before their cast to V's dtype."""
    G, maxN, L = tree.groups, tree.nodes_per_group, tree.num_relations
    Fdim = V.shape[-1]
    Vg = V.reshape(G, maxN, Fdim)
    w_all = tree.weights
    if edge_keep is not None:
        w_all = w_all * edge_keep.reshape(w_all.shape)
    w_all = w_all.to(V.dtype)

    outs = []
    lo_child = tree.level_sizes[0]
    e_off = 0
    for k, f in enumerate(tree.fanouts):
        n_k = tree.level_sizes[k]
        child = Vg[:, lo_child:lo_child + n_k * f, :].reshape(G, n_k, f, Fdim)
        w = w_all[:, e_off:e_off + n_k * f].reshape(G, n_k, f)
        if L == 1:
            out_k = torch.einsum("gnf,gnfd->gnd", w, child)[:, :, None, :]
        else:
            rel = tree.relations[:, e_off:e_off + n_k * f].reshape(G, n_k, f)
            onehot = F.one_hot(rel.long(), L).to(V.dtype)
            out_k = torch.einsum("gnf,gnfl,gnfd->gnld", w, onehot, child)
        outs.append(out_k.reshape(G, n_k, L * Fdim))
        lo_child += n_k * f
        e_off += n_k * f
    # The leaf level has no sampled children: a zero neighbor term, as on
    # the COO path, whose leaf slots receive no edges.
    outs.append(V.new_zeros((G, tree.level_sizes[-1], L * Fdim)))
    return torch.cat(outs, dim=1).reshape(G * maxN, L * Fdim)
