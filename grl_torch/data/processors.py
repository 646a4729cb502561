"""Sample processors: feature encoding, graph building, label targets.

Copies of ``grl_tpu/data/processors.py`` (``TextlineEncoding``,
``HeuristicGraphBuilder``, ``NodeLabeling``, ``CLNodeLabeling``,
``EdgeLabeling``, ``GraphLabeling``, ``SSLLabeling``). The processor chain
transforms one raw sample dict in place; each processor is a plain
callable built from config kwargs.

``SSLLabeling`` samples its pairs from numpy's global generator
(``np.random.permutation``), as ``grl_tpu`` does, so one ``np.random.seed``
gives both packages the same targets.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from grl_torch.data import native
from grl_torch.data.features import encode_textlines
from grl_torch.data.graph_builder import build_heuristic_adjacency


class BaseDataProcess:
    """Processor interface (reference: data_process/base_data_process.py)."""

    @classmethod
    def _from_config(cls, config: Dict[str, Any]) -> "BaseDataProcess":
        return cls(**dict(config or {}))

    def __call__(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError


def _sorted_textlines(sample: Dict[str, Any]) -> Optional[List[Dict[str, Any]]]:
    """Textlines ordered by their integer key, or None when unlabeled."""
    label = sample.get("label")
    if label is None:
        return None
    return [line for _, line in sorted(label.items(), key=lambda kv: kv[0])]


class TextlineEncoding(BaseDataProcess):
    """Char-BOW + bbox features -> ``sample["textline_encoding"]``
    (reference: data_process/textline_encoding.py:86-113)."""

    def __init__(self, is_normalized_text: bool = True):
        self.is_normalized_text = is_normalized_text

    def __call__(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        lines = _sorted_textlines(sample)
        if lines is None:
            return sample
        sample["textline_encoding"] = encode_textlines(
            lines, sample["char_to_id"], self.is_normalized_text
        )
        return sample


class HeuristicGraphBuilder(BaseDataProcess):
    """Spatial-relation adjacency -> ``sample["adjacency_matrix"]``
    ``(N, num_edges, N)`` float16 (reference:
    data_process/heuristic_graph_builder.py:56-83).

    ``use_native`` (the default, as in ``grl_tpu``) builds through the C++
    builder (:func:`grl_torch.data.native.build_heuristic_adjacency_fast`,
    which keeps ``grl_tpu``'s scope rules); ``use_native: false`` builds in
    Python. Both give the same arrays; ``native.pages`` counts the pages
    each built.
    """

    def __init__(self, num_edges: int = 6, edge_type: str = "normal_binary",
                 use_native: bool = True):
        self.num_edges = num_edges
        self.edge_type = edge_type
        self.use_native = use_native

    def __call__(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        lines = _sorted_textlines(sample)
        if lines is None:
            return sample
        # The reference feeds the *label* into the builder's type field
        # (heuristic_graph_builder.py:44-49), so only lines labeled
        # literally "cell"/"table" become table cells.
        items = [
            {
                "location": line["polygon"],
                "text": line["text"],
                "key_type": line.get("key_type", "other"),
                "type": line.get("label", "other"),
            }
            for line in lines
        ]
        if self.use_native:
            adjacency = native.build_heuristic_adjacency_fast(items, self.edge_type, self.num_edges)
        else:
            adjacency = build_heuristic_adjacency(items, self.edge_type, self.num_edges)
            native.pages["python"] += 1
        sample["adjacency_matrix"] = adjacency
        return sample


class NodeLabeling(BaseDataProcess):
    """Per-node class ids; 0 = background/other
    (reference: data_process/node_labeling.py:16-51)."""

    def _targets(self, lines: List[Dict[str, Any]], class_to_id: Dict[str, Any],
                 ignored: Optional[List[str]] = None) -> np.ndarray:
        out = []
        for line in lines:
            if ignored and line.get("label") in ignored:
                out.append(0)
            else:
                out.append(
                    class_to_id.get(line.get("label"), {}).get(line.get("key_type"), 0)
                )
        return np.array(out, dtype=np.int32)

    def __call__(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        lines = _sorted_textlines(sample)
        if lines is None:
            return sample
        sample["node_label"] = self._targets(lines, sample["class_to_id"])
        return sample


class CLNodeLabeling(NodeLabeling):
    """NodeLabeling that zeroes the configured ignored classes
    (reference: data_process/cl_node_labeling.py:13-51)."""

    def __call__(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        lines = _sorted_textlines(sample)
        if lines is None:
            return sample
        sample["node_label"] = self._targets(
            lines, sample["class_to_id"], sample.get("ignored_classes", [])
        )
        return sample


class EdgeLabeling(BaseDataProcess):
    """Class-pair link matrix from ``linking`` annotations
    (reference: data_process/edge_labeling.py:22-69)."""

    def __init__(self, is_directed: bool = False):
        self.is_directed = is_directed

    def __call__(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        lines = _sorted_textlines(sample)
        if lines is None:
            return sample
        class_to_id = sample["class_to_id"]
        n = len(lines)
        link = np.zeros((n, n), dtype=np.float32)
        for line in lines:
            for pair in line.get("linking", []):
                src = class_to_id[pair[0][0]][pair[0][1]]
                dst = class_to_id[pair[1][0]][pair[1][1]]
                link[src, dst] = 1.0
                if not self.is_directed:
                    link[dst, src] = 1.0
        sample["link_label"] = link
        return sample


class GraphLabeling(BaseDataProcess):
    """Graph-level class id (reference: data_process/graph_labeling.py:14-34)."""

    def __call__(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        if sample.get("label") is None:
            return sample
        sample["graph_label"] = sample["class_to_id"][sample["graph_label"]]["value"]
        return sample


def _all_pairs_bfs_distance(adj_bool: np.ndarray, cutoff: int) -> np.ndarray:
    """All-pairs directed shortest path lengths up to ``cutoff`` hops, -1
    beyond: a frontier expansion by boolean matrix products."""
    n = adj_bool.shape[0]
    dist = np.full((n, n), -1, dtype=np.int64)
    np.fill_diagonal(dist, 0)
    reach = np.eye(n, dtype=bool)
    frontier = np.eye(n, dtype=bool)
    for step in range(1, cutoff + 1):
        frontier = (frontier @ adj_bool) & ~reach
        if not frontier.any():
            break
        dist[frontier] = step
        reach |= frontier
    return dist


class SSLLabeling(BaseDataProcess):
    """Self-supervision targets (reference: data_process/ssl_labeling.py:10-196).

    Tasks: node_property (degree), edge_mask (pos/neg edge sampling),
    pairwise_distance (shortest-path classes), pairwise_similarity
    (top/bottom-k cosine pairs), graph_edit_distance, dgi.

    ``_edge_mask`` keeps ``grl_tpu``'s pairing (``processors.py:235-242``):
    it stacks the sampled endpoints as ``(2, 2k)`` and reads them with
    ``reshape(-1, 2)``, which pairs sources with sources and destinations
    with destinations, so the targets ``[1]*k + [0]*k`` do not describe
    the pairs they stand beside.
    """

    def __init__(self, tasks: List[str], is_directed: bool = False):
        self.tasks = tasks
        self.is_directed = is_directed

    def __call__(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        vertex = sample["textline_encoding"]
        adj = np.asarray(sample["adjacency_matrix"], dtype=np.float32)
        flat = adj.sum(axis=1)  # (N, N) any-relation adjacency
        for task in self.tasks:
            if task == "node_property":
                sample["node_property"] = (flat > 0).sum(axis=1)
            elif task == "edge_mask":
                k = max(1, vertex.shape[0] // 10)
                sample["edge_mask_indices"], sample["edge_mask_targets"] = self._edge_mask(flat, k)
            elif task == "pairwise_distance":
                k = max(1, vertex.shape[0] // 5)
                (
                    sample["pairwise_distance_indices"],
                    sample["pairwise_distance_targets"],
                ) = self._pairwise_distance(flat, max_distance=4, k=k)
            elif task == "pairwise_similarity":
                (
                    sample["pairwise_similarity_indices"],
                    sample["pairwise_similarity_targets"],
                ) = self._pairwise_similarity(vertex, k=3)
            elif task == "graph_edit_distance":
                sample["graph_edit_distance"] = self._graph_edit_distance(
                    adj, sample["aug_adjacency_matrix"], sample["graph_edit_history"]
                )
            elif task == "dgi":
                neg = sample["negative_textline_encoding"]
                sample["dgi"] = np.concatenate([np.ones(vertex.shape[0]), np.zeros(neg.shape[0])])
        return sample

    @staticmethod
    def _edge_mask(flat: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        pos = np.vstack(np.nonzero(flat > 0))
        neg = np.vstack(np.nonzero(flat == 0))
        pos = pos[:, np.random.permutation(pos.shape[1])[:k]]
        neg = neg[:, np.random.permutation(neg.shape[1])[:k]]
        edges = np.concatenate([pos, neg], axis=1).reshape(-1, 2)
        targets = np.concatenate([np.ones(k), np.zeros(k)])
        return edges, targets

    def _pairwise_distance(
        self, flat: np.ndarray, max_distance: int, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        dist = _all_pairs_bfs_distance(flat > 0, cutoff=max_distance - 1)
        dist[dist == -1] = max_distance
        dist = np.triu(dist) - 1  # lower triangle -> -1 (ignored)
        edges = np.vstack(np.nonzero(dist > -1))
        perm = np.random.permutation(edges.shape[1])[:k]
        edges = edges[:, perm].T
        targets = dist[edges[:, 0], edges[:, 1]]
        return edges, np.asarray(targets)

    @staticmethod
    def _pairwise_similarity(vertex: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        norm = vertex / np.maximum(np.linalg.norm(vertex, axis=1, keepdims=True), 1e-12)
        sim = norm @ norm.T
        edges, targets = [], []
        top = np.argpartition(sim, -k, axis=1)[:, -k:]
        bottom = np.argpartition(sim, k, axis=1)[:, :k]
        for block in (top, bottom):
            for src in range(block.shape[0]):
                for dst in block[src]:
                    edges.append([src, int(dst)])
                    targets.append(sim[src, dst])
        return np.array(edges), np.array(targets)

    @staticmethod
    def _graph_edit_distance(
        src_adj: np.ndarray, dst_adj: np.ndarray, history: List[Tuple[int, str]]
    ) -> float:
        """(reference: ssl_labeling.py:122-146)."""
        n, rel, _ = src_adj.shape
        rebuilt = np.asarray(dst_adj).copy()
        for node, op in sorted(history, key=lambda it: it[0]):
            if op == "delete":
                rebuilt = np.insert(rebuilt, node, np.zeros(rel), axis=2)
                rebuilt = np.insert(rebuilt, node, np.zeros((1, rel, 1)), axis=0)
        node_cost = len(history)
        edit_cost = np.sum(np.abs(rebuilt[:n, :, :n] - src_adj))
        add_cost = (
            np.sum(rebuilt[n:, :, :])
            + np.sum(rebuilt[:, :, n:])
            - np.sum(rebuilt[n:, :, n:])
        )
        return float(node_cost + edit_cost + add_cost)
