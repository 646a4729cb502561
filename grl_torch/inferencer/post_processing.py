"""Post-processing of predicted pages.

The reference ships only the abstract base with no concrete processors
(reference: gnn/inferencer/post_processing/postprocess_base.py:4-12).
We provide the same extension point plus two useful concrete processors.
"""
from __future__ import annotations

from typing import Any, Dict, List


class PostProcessBase:
    @classmethod
    def _from_config(cls, config: Dict[str, Any]) -> "PostProcessBase":
        return cls(**dict(config or {}))

    def __call__(self, page: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        raise NotImplementedError


class ConfidenceThreshold(PostProcessBase):
    """Demote predictions below a confidence threshold to 'other'."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold

    def __call__(self, page: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        for box in page:
            if box.get("confidence", 1.0) < self.threshold:
                box["formal_key"] = "other"
                box["key_type"] = "other"
        return page


class SingletonKeyFilter(PostProcessBase):
    """Keep only the highest-confidence box per formal_key (for fields
    expected to appear at most once per page)."""

    def __init__(self, unique_keys: List[str] | None = None):
        self.unique_keys = set(unique_keys or [])

    def __call__(self, page: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        best: Dict[str, int] = {}
        for idx, box in enumerate(page):
            key = box.get("formal_key")
            if key in self.unique_keys:
                if key not in best or box["confidence"] > page[best[key]]["confidence"]:
                    best[key] = idx
        for idx, box in enumerate(page):
            key = box.get("formal_key")
            if key in self.unique_keys and best.get(key) != idx:
                box["formal_key"] = "other"
                box["key_type"] = "other"
        return page
