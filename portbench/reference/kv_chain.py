"""A page's model inputs, worked out again from its raw boxes: the
char-presence and box features (``features``), the six-relation spatial
adjacency (``graph_builder``, the Python builder), the node targets, and a
batch padded to its bucket, as the configuration's chain states them
(``TextlineEncoding`` normalised, ``HeuristicGraphBuilder``
``normal_binary``, ``NodeLabeling``, ``BucketPadding``)."""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from portbench.reference.features import encode_textlines
from portbench.reference.graph_builder import build_heuristic_adjacency


def class_ids(classes: Sequence[str], key_types: Sequence[str]) -> Dict[str, Dict[str, int]]:
    """``class * len(key_types) + key_type + 1``; 0 is the background."""
    return {c: {k: i * len(key_types) + j + 1 for j, k in enumerate(key_types)} for i, c in enumerate(classes)}


def encode_page(page: List[Dict[str, Any]], char_to_id: Dict[str, int], class_to_id, num_edges: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(V (n, F), A (n, L, n), labels (n,))`` of one page."""
    lines = [dict(box, polygon=box["location"]) for box in page]
    V = encode_textlines(lines, char_to_id, True)
    items = [{"location": line["polygon"], "text": line["text"], "key_type": line.get("key_type", "other"),
              "type": line.get("label", "other")} for line in lines]
    A = np.asarray(build_heuristic_adjacency(items, "normal_binary", num_edges), np.float32)
    labels = np.array([class_to_id.get(line.get("label"), {}).get(line.get("key_type"), 0) for line in lines],
                      np.int64)
    return V, A, labels


def bucket(n: int, quantum: int) -> int:
    return -(-n // quantum) * quantum


def collate(encoded: List[Tuple[np.ndarray, np.ndarray, np.ndarray]], quantum: int
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The pages right-padded to the bucket of the largest (labels -100)."""
    N = bucket(max(len(labels) for _, _, labels in encoded), quantum)
    V = np.stack([np.pad(v, ((0, N - len(v)), (0, 0))) for v, _, _ in encoded])
    A = np.stack([np.pad(a, ((0, N - len(a)), (0, 0), (0, N - len(a)))) for _, a, _ in encoded])
    labels = np.stack([np.pad(y, (0, N - len(y)), constant_values=-100) for _, _, y in encoded])
    return V, A, labels
