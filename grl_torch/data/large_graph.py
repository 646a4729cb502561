"""Synthetic large relational graphs (OGB-style, no download).

Counterpart of ``grl_tpu/data/large_graph.py``: the same numpy generator
on the same ``RandomState`` stream, so both packages build identical
arrays from one seed. Stochastic block model graphs with
community-correlated features: a GCN that aggregates correctly reaches
high accuracy, a broken sparse path cannot.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

from grl_torch.ops.sparse import RelationalGraph, graph_from_numpy


class LargeGraphData(NamedTuple):
    features: np.ndarray  # (N, F) float32
    labels: np.ndarray  # (N,) int32
    senders: np.ndarray  # (E,)
    receivers: np.ndarray  # (E,)
    relations: np.ndarray  # (E,)
    weights: np.ndarray  # (E,)
    train_mask: np.ndarray  # (N,) bool
    val_mask: np.ndarray  # (N,) bool
    num_classes: int
    num_relations: int


def sbm_relational_graph(
    num_nodes: int = 10_000,
    num_classes: int = 8,
    num_relations: int = 3,
    avg_degree: float = 10.0,
    feature_dim: int = 64,
    homophily: float = 0.8,
    noise: float = 2.0,
    train_fraction: float = 0.6,
    seed: int = 0,
    communities: Optional[int] = None,
    degree_zipf: float = 0.0,
) -> LargeGraphData:
    """Directed SBM (``large_graph.py:30-126``): edges prefer same-community
    endpoints; features are a noisy community one-hot embedding.
    ``communities`` decouples the edge communities from the labels (each
    maps to class ``community % num_classes``); ``degree_zipf > 0`` draws
    Zipf degree propensities for both endpoints (a degree-corrected SBM).
    """
    rng = np.random.RandomState(seed)
    if communities is None:
        labels = rng.randint(0, num_classes, num_nodes).astype(np.int32)
        com, n_com = labels, num_classes
    else:
        com = rng.randint(0, communities, num_nodes).astype(np.int32)
        labels = (com % num_classes).astype(np.int32)
        n_com = communities
    E = int(num_nodes * avg_degree)
    if degree_zipf > 0.0:
        prop = (1.0 + np.arange(num_nodes)) ** (-degree_zipf)
        rng.shuffle(prop)
        p_node = prop / prop.sum()
        senders = rng.choice(num_nodes, 2 * E, p=p_node).astype(np.int32)
    else:
        senders = rng.randint(0, num_nodes, 2 * E).astype(np.int32)
    receivers = np.empty_like(senders)
    same = rng.rand(2 * E) < homophily
    # Same-community edges pick the receiver from the sender's community.
    order = np.argsort(com, kind="stable")
    class_starts = np.searchsorted(com[order], np.arange(n_com))
    class_counts = np.bincount(com, minlength=n_com)
    if degree_zipf > 0.0:
        u = rng.rand(2 * E) ** (1.0 / (1.0 + degree_zipf))
        pick = (u * np.maximum(class_counts[com[senders]], 1)).astype(np.int64)
    else:
        pick = rng.randint(0, np.maximum(class_counts[com[senders]], 1))
    receivers[same] = order[class_starts[com[senders[same]]] + pick[same]]
    if degree_zipf > 0.0:
        receivers[~same] = rng.choice(num_nodes, int((~same).sum()), p=p_node).astype(np.int32)
    else:
        receivers[~same] = rng.randint(0, num_nodes, (~same).sum())
    keep = senders != receivers
    senders, receivers = senders[keep][:E], receivers[keep][:E]
    relations = rng.randint(0, num_relations, len(senders)).astype(np.int32)
    # Deduplicate (sender, relation, receiver) triples so COO multiplicity
    # matches a binary dense adjacency.
    triples = np.unique(np.stack([senders, relations, receivers], axis=1), axis=0)
    senders, relations, receivers = (
        triples[:, 0].astype(np.int32),
        triples[:, 1].astype(np.int32),
        triples[:, 2].astype(np.int32),
    )

    basis = rng.randn(num_classes, feature_dim).astype(np.float32)
    features = basis[labels] + noise * rng.randn(num_nodes, feature_dim).astype(np.float32)

    train_mask = rng.rand(num_nodes) < train_fraction
    val_mask = ~train_mask
    return LargeGraphData(
        features=features,
        labels=labels,
        senders=senders,
        receivers=receivers,
        relations=relations,
        weights=np.ones(len(senders), np.float32),
        train_mask=train_mask,
        val_mask=val_mask,
        num_classes=num_classes,
        num_relations=num_relations,
    )


def to_relational_graph(
    data: LargeGraphData, edge_bucket: Optional[int] = None, device=None
) -> Tuple[RelationalGraph, np.ndarray]:
    """The graph of ``data`` as a :class:`RelationalGraph` on ``device``,
    padded to ``edge_bucket`` edges, and its features (numpy)."""
    E = len(data.senders)
    cap = edge_bucket or E
    pad = cap - E
    if pad < 0:
        raise ValueError(f"edge bucket {cap} < {E}")

    def pad_arr(arr, value=0):
        return np.concatenate([arr, np.full(pad, value, arr.dtype)])

    graph = graph_from_numpy(
        pad_arr(data.senders), pad_arr(data.receivers), pad_arr(data.relations),
        pad_arr(data.weights), np.concatenate([np.ones(E, bool), np.zeros(pad, bool)]),
        num_nodes=len(data.features), num_relations=data.num_relations, device=device,
    )
    return graph, data.features
