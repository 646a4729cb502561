"""The ogbn-arxiv-sized stochastic block model graph, frozen.

A copy of the directed SBM generator the repository ships (numpy only, on
one ``RandomState`` stream): edges prefer same-community endpoints,
features are a noisy community one-hot embedding, (sender, relation,
receiver) triples are deduplicated, and a random share of the nodes is
labelled for training, the rest for validation. The benchmark makes every
graph with this copy and hands the same arrays to the program and to the
reference.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def sbm_graph(num_nodes: int, num_classes: int, num_relations: int, avg_degree: float, feature_dim: int,
              seed: int, homophily: float = 0.8, noise: float = 2.0,
              train_fraction: float = 0.6) -> Dict[str, np.ndarray]:
    """The graph as numpy arrays: ``features (N, F)`` float32, ``labels
    (N,)`` int32, ``senders``, ``receivers``, ``relations`` (E,) int32,
    ``weights (E,)`` float32 ones, ``train_mask`` and ``val_mask`` (N,)."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, num_nodes).astype(np.int32)
    E = int(num_nodes * avg_degree)
    senders = rng.randint(0, num_nodes, 2 * E).astype(np.int32)
    receivers = np.empty_like(senders)
    same = rng.rand(2 * E) < homophily
    order = np.argsort(labels, kind="stable")
    class_starts = np.searchsorted(labels[order], np.arange(num_classes))
    class_counts = np.bincount(labels, minlength=num_classes)
    pick = rng.randint(0, np.maximum(class_counts[labels[senders]], 1))
    receivers[same] = order[class_starts[labels[senders[same]]] + pick[same]]
    receivers[~same] = rng.randint(0, num_nodes, (~same).sum())
    keep = senders != receivers
    senders, receivers = senders[keep][:E], receivers[keep][:E]
    relations = rng.randint(0, num_relations, len(senders)).astype(np.int32)
    triples = np.unique(np.stack([senders, relations, receivers], axis=1), axis=0)
    senders, relations, receivers = (triples[:, 0].astype(np.int32), triples[:, 1].astype(np.int32),
                                     triples[:, 2].astype(np.int32))
    basis = rng.randn(num_classes, feature_dim).astype(np.float32)
    features = basis[labels] + noise * rng.randn(num_nodes, feature_dim).astype(np.float32)
    train_mask = rng.rand(num_nodes) < train_fraction
    return {
        "features": features, "labels": labels, "senders": senders, "receivers": receivers,
        "relations": relations, "weights": np.ones(len(senders), np.float32),
        "train_mask": train_mask, "val_mask": ~train_mask,
    }
