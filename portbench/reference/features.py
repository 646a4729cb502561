"""A frozen copy of the repository's ``features`` data module, for the
benchmark's reference; it imports nothing of the program.

Node feature encoding: char bag-of-words + normalized bbox geometry.

Same feature definition as the reference TextlineEncoding (reference:
gnn/data_generator/data_process/textline_encoding.py:23-113): a binary
char-presence vector over the master charset (4365 chars) concatenated
with 4 page-normalized bbox features -> F = len(charset) + 4 (= 4369).

Implemented with plain numpy (no sklearn CountVectorizer): one pass over
the text setting vocabulary indices — identical output, no fit/transform
machinery, and trivially portable to the C++ pipeline.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from portbench.reference.normalize_text import normalize_text


def char_bow_matrix(
    texts: Sequence[str],
    char_to_id: Dict[str, int],
    normalized: bool = True,
    dtype=np.float32,
) -> np.ndarray:
    """Binary char-presence matrix ``(N, len(vocab))``."""
    out = np.zeros((len(texts), len(char_to_id)), dtype=dtype)
    for row, text in enumerate(texts):
        # sklearn's CountVectorizer lowercases by default, so the reference
        # lowercases even without normalize_text (textline_encoding.py:33-40).
        text = normalize_text(str(text)) if normalized else str(text).lower()
        for ch in set(text):
            idx = char_to_id.get(ch)
            if idx is not None:
                out[row, idx] = 1.0
    return out


def polygon_bbox(polygon: Sequence[Sequence[float]]) -> Tuple[float, float, float, float]:
    """(x, y, w, h) from an arbitrary polygon point list."""
    xs = [p[0] for p in polygon]
    ys = [p[1] for p in polygon]
    x, y = min(xs), min(ys)
    return x, y, max(xs) - x, max(ys) - y


def spatial_feature_matrix(textlines: List[Dict[str, Any]]) -> np.ndarray:
    """Page-normalized (x, y, w, h) per textline, shifted off zero.

    Matches the reference's ``scale_non_zero(v, 0.1) = (v + 0.1) / 1.1``
    scaling (reference: textline_encoding.py:44-84).
    """
    xs: List[float] = []
    ys: List[float] = []
    for line in textlines:
        xs.extend(p[0] for p in line["polygon"])
        ys.extend(p[1] for p in line["polygon"])
    min_x, max_x = min(xs), max(xs)
    min_y, max_y = min(ys), max(ys)
    span_x = max_x - min_x
    span_y = max_y - min_y

    def scale(value: float) -> float:
        return (value + 0.1) / 1.1

    feats = np.zeros((len(textlines), 4), dtype=np.float32)
    for row, line in enumerate(textlines):
        x, y, w, h = polygon_bbox(line["polygon"])
        feats[row, 0] = scale((x - min_x) / span_x)
        feats[row, 1] = scale((y - min_y) / span_y)
        feats[row, 2] = scale(w / span_x)
        feats[row, 3] = scale(h / span_y)
    return feats


def encode_textlines(
    textlines: List[Dict[str, Any]],
    char_to_id: Dict[str, int],
    normalized: bool = True,
) -> np.ndarray:
    """Full node-feature matrix ``(N, len(vocab) + 4)``."""
    bow = char_bow_matrix([t["text"] for t in textlines], char_to_id, normalized)
    spatial = spatial_feature_matrix(textlines)
    return np.concatenate([bow, spatial], axis=1)
