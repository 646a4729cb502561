"""Augmentors: graph copies for the self-supervised tasks.

Copies of ``grl_tpu/data/augmentor.py`` (:18-74). Each augmentor owns a
``np.random.RandomState(seed)``, so both packages draw the same bits from
the same seed. An augmentor runs in the processor chain after
``HeuristicGraphBuilder`` (a dataset resolves ``data_process`` names from
the processors, then from here) or, before it, from ``augmentations``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np


class BaseAugmentor:
    @classmethod
    def _from_config(cls, config: Dict[str, Any]) -> "BaseAugmentor":
        return cls(**dict(config or {}))

    def __call__(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError


class NodeDropAugmentor(BaseAugmentor):
    """Randomly delete nodes to create an augmented graph copy.

    Populates ``aug_adjacency_matrix``, ``aug_textline_encoding`` and
    ``graph_edit_history`` (list of ``(node_idx, "delete")``) for the
    graph-edit-distance targets; at least one node is deleted.
    """

    def __init__(self, drop_rate: float = 0.1, seed: int | None = None):
        self.drop_rate = drop_rate
        self.rng = np.random.RandomState(seed)

    def __call__(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        adj = sample.get("adjacency_matrix")
        if adj is None:
            return sample
        n = adj.shape[0]
        keep = self.rng.rand(n) >= self.drop_rate
        if keep.all() and n > 1:  # always edit at least one node
            keep[self.rng.randint(n)] = False
        dropped = np.nonzero(~keep)[0]
        sample["aug_adjacency_matrix"] = adj[keep][:, :, keep]
        if "textline_encoding" in sample:
            sample["aug_textline_encoding"] = sample["textline_encoding"][keep]
        sample["graph_edit_history"] = [(int(i), "delete") for i in dropped]
        return sample


class DGINegativeSampling(BaseAugmentor):
    """DGI's corruption: row-shuffled node features on the same topology
    (``negative_textline_encoding`` / ``negative_adjacency_matrix``)."""

    def __init__(self, seed: int | None = None):
        self.rng = np.random.RandomState(seed)

    def __call__(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        feats = sample.get("textline_encoding")
        if feats is None:
            return sample
        perm = self.rng.permutation(feats.shape[0])
        sample["negative_textline_encoding"] = feats[perm]
        sample["negative_adjacency_matrix"] = sample["adjacency_matrix"]
        return sample
