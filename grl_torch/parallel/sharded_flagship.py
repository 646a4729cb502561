"""Node-partitioned training of the model family (the sequence-parallel
analog).

Counterpart of ``grl_tpu/parallel/sharded_flagship.py`` (:32-165).
``grl_tpu`` runs the flax network under ``shard_map``; here every rank
runs the same module on its block of nodes with its
:class:`~grl_torch.parallel.graph_partition.LocalShardGraph`, every
``GraphConv`` aggregating through the ring halo exchange. The loss is the
global masked mean: each rank's summed NLL over its labelled nodes, the
gradients, the sum and the count summed over the axis in one
``all_reduce``, then the gradients divided by the global count, so every
rank applies the gradient of the single-device loss. Dropout (D) and
DropEdge draw from the rank's own generator, seeded with the rank folded
in (``fold_in(rng, axis_index)`` at :100).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from grl_torch.parallel import distributed
from grl_torch.parallel.graph_partition import PartitionedGraph, local_shard_graph


def pad_node_arrays(features: Optional[np.ndarray], labels: np.ndarray, num_nodes_padded: int,
                    label_pad: int = -100) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """Pad node arrays to the partitioned (device-divisible) count, labels
    with the ignore value so the masked loss is unchanged.
    ``features=None`` pads labels only."""
    labels = np.concatenate(
        [labels, np.full(num_nodes_padded - len(labels), label_pad, labels.dtype)]
    ) if num_nodes_padded > len(labels) else labels
    if features is not None and num_nodes_padded > features.shape[0]:
        pad = num_nodes_padded - features.shape[0]
        features = np.concatenate([features, np.zeros((pad, features.shape[1]), features.dtype)])
    return features, labels


def scatter_node_arrays(node_perm: np.ndarray, features: Optional[np.ndarray], labels: np.ndarray,
                        num_nodes_padded: int, label_pad: int = -100
                        ) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """Node arrays in partition order for a degree-balanced plan (or a
    kernel's reordering): row ``node_perm[i]`` holds original node ``i``;
    unassigned rows get zero features and ignored labels.
    ``features=None`` places the labels only."""
    out_l = np.full(num_nodes_padded, label_pad, labels.dtype)
    out_l[node_perm] = labels
    if features is None:
        return None, out_l
    out_f = np.zeros((num_nodes_padded, features.shape[1]), features.dtype)
    out_f[node_perm] = features
    return out_f, out_l


def masked_nll_sum(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sum of the NLL over labelled nodes, their count)``, -100 ignored,
    softmax in float32."""
    valid = labels != -100
    safe = torch.where(valid, labels, 0).long()
    nll = -torch.gather(F.log_softmax(logits.float(), dim=-1), -1, safe[:, None])[:, 0]
    return (nll * valid).sum(), valid.sum().to(torch.float32)


def reduce_gradients(params, extra: torch.Tensor, group) -> torch.Tensor:
    """Sum every parameter's gradient and ``extra`` (a flat float32 tensor)
    over ``group`` in one ``all_reduce`` of one flat buffer, written back in
    place; returns the summed ``extra``."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads] + [extra.reshape(-1).float()])
    if group is not None:
        distributed.all_reduce_(flat, group, "gradient all_reduce")
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat[offset:]


def make_partitioned_model_step(model: torch.nn.Module, mesh: Any, graph: PartitionedGraph,
                                optimizer: torch.optim.Optimizer, axis: str = "data",
                                max_grad_norm: Optional[float] = None, device: Any = None,
                                sharded=(), model_group=None) -> Tuple[Callable, Callable]:
    """``(train_step, forward)`` for a network in sparse mode, node-
    partitioned over ``axis``: ``train_step(V_block, labels_block, rngs)``
    runs one optimizer step on this rank's block of node features ``(shard_n,
    F)`` and labels ``(shard_n,)`` (partition order) and returns the global
    loss as a device scalar; ``forward(V_block)`` returns this rank's
    eval-mode logits block. ``model`` and ``optimizer`` are this rank's
    replicas; ``rngs`` this rank's :class:`~grl_torch.models.layers.Rngs`.
    ``max_grad_norm``, ``sharded`` and ``model_group`` are
    :func:`~grl_torch.trainer.procedures.base_procedure.apply_gradients`'
    (the clip of ``grl_tpu``'s optax chain)."""
    from grl_torch.trainer.procedures.base_procedure import apply_gradients

    D = mesh.axis_size(axis)
    d = mesh.index(axis)
    shard_n = graph.num_nodes // D
    device = device if device is not None else next(model.parameters()).device
    local = local_shard_graph(graph.senders[d], graph.receivers[d], graph.relations[d], graph.weights[d],
                              graph.mask[d], shard_n, graph.num_relations, mesh, axis, device)
    group = mesh.group(axis)
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def train_step(V_block: torch.Tensor, labels_block: torch.Tensor, rngs: Any) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = model((V_block, local), rngs=rngs)
        total, count = masked_nll_sum(logits, labels_block)
        total.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        summed = reduce_gradients(params, torch.stack([total.detach(), count]), group)
        denominator = summed[1].clamp(min=1.0)
        for p in params:
            p.grad.div_(denominator)
        apply_gradients(optimizer, params, max_grad_norm, sharded, model_group)
        return summed[0] / denominator

    def forward(V_block: torch.Tensor) -> torch.Tensor:
        model.eval()
        with torch.no_grad():
            return model((V_block, local))

    train_step.local_graph = local
    return train_step, forward
