"""Sample processors: feature encoding, graph building, label targets.

Copies of ``grl_tpu/data/processors.py`` (``TextlineEncoding``,
``HeuristicGraphBuilder``, ``NodeLabeling``). The processor chain
transforms one raw sample dict in place; each processor is a plain
callable built from config kwargs.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

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
