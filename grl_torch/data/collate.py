"""Batch collation: padding strategies + array stacking.

Copies of ``grl_tpu/data/collate.py`` (``NumpyPadding``, ``next_bucket``,
``BucketPadding``, ``SparseBucketPadding``, ``stack_batch``).
:class:`BucketPadding` right-pads the node axis to a fixed bucket (a
multiple of a quantum, or the next listed size), so batches fall into few
shapes, and emits a ``node_mask`` so downstream losses and metrics ignore
padding; :class:`SparseBucketPadding` then turns each page's dense
adjacency into padded COO edge lists. :class:`NumpyPadding` pads named
per-sample arrays (the self-supervised targets' index and target lists,
say) symmetrically to one shape per batch.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np


class BaseCollate:
    @classmethod
    def _from_config(cls, config: Dict[str, Any]) -> "BaseCollate":
        return cls(**dict(config or {}))

    def __call__(self, batch: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        raise NotImplementedError


class NumpyPadding(BaseCollate):
    """Reference-compatible max-shape symmetric padding
    (``grl_tpu/data/collate.py:31-59``): each array named in
    ``name_value_pairs`` is padded with its value, ``(d // 2, d - d // 2)``
    on each axis, to the shape with the largest product in the batch (not
    the per-axis maximum: the reference's quirk, kept). A name some item
    lacks as an array is left alone."""

    def __init__(self, name_value_pairs: Dict[str, float], only_selected_items: bool = False):
        self.name_value_pairs = dict(name_value_pairs)
        self.only_selected_items = only_selected_items

    def __call__(self, batch: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        for name, value in self.name_value_pairs.items():
            arrays = [item.get(name) for item in batch]
            present = [a for a in arrays if isinstance(a, np.ndarray)]
            if len(present) != len(arrays) or not present:
                continue
            max_shape = max((list(a.shape) for a in present), key=lambda s: np.prod(s))
            for item in batch:
                arr = item[name]
                pads = [(d // 2, d - d // 2) for d in np.subtract(max_shape, arr.shape)]
                item[name] = np.pad(arr, pads, constant_values=value)
        if self.only_selected_items:
            batch = [{k: v for k, v in item.items() if k in self.name_value_pairs} for item in batch]
        return batch


def next_bucket(n: int, quantum: int = 64, buckets: Sequence[int] = ()) -> int:
    """Smallest allowed padded size >= n."""
    for b in buckets:
        if n <= b:
            return b
    return ((n + quantum - 1) // quantum) * quantum


class BucketPadding(BaseCollate):
    """Static-shape right padding of the node axis + explicit mask.

    Pads ``textline_encoding (N,F) -> (Nb,F)``, ``adjacency_matrix
    (N,L,N) -> (Nb,L,Nb)`` and ``node_label (N,) -> (Nb,)`` (with the
    ignore value) to the same bucketed node count, and adds
    ``node_mask (Nb,)``.
    """

    def __init__(
        self,
        quantum: int = 64,
        buckets: Sequence[int] = (),
        label_pad_value: float = -100,
        only_selected_items: bool = False,
        extra_keys: Dict[str, float] | None = None,
        keep_keys: Sequence[str] = (),
    ):
        self.quantum = quantum
        self.buckets = tuple(buckets)
        self.label_pad_value = label_pad_value
        self.only_selected_items = only_selected_items
        self.extra_keys = dict(extra_keys or {})
        self.keep_keys = tuple(keep_keys)

    def __call__(self, batch: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        sizes = [item["textline_encoding"].shape[0] for item in batch]
        target = next_bucket(max(sizes), self.quantum, self.buckets)
        for item in batch:
            n = item["textline_encoding"].shape[0]
            pad = target - n
            item["textline_encoding"] = np.pad(
                item["textline_encoding"], ((0, pad), (0, 0))
            )
            if "adjacency_matrix" in item:
                item["adjacency_matrix"] = np.pad(
                    np.asarray(item["adjacency_matrix"], dtype=np.float32),
                    ((0, pad), (0, 0), (0, pad)),
                )
            if "node_label" in item:
                item["node_label"] = np.pad(
                    item["node_label"], (0, pad),
                    constant_values=int(self.label_pad_value),
                )
            for key, value in self.extra_keys.items():
                if key in item:
                    # Extra node-axis arrays may have their own (smaller)
                    # node count (e.g. aug_* after node dropping); pad each
                    # to the bucket independently, incl. square axis 2.
                    arr = np.asarray(item[key])
                    if arr.dtype == np.float16:
                        arr = arr.astype(np.float32)
                    pads = [(0, max(0, target - arr.shape[0]))] + [
                        (0, 0)
                    ] * (arr.ndim - 1)
                    if arr.ndim == 3 and arr.shape[2] == arr.shape[0]:
                        pads[2] = (0, max(0, target - arr.shape[2]))
                    item[key] = np.pad(arr, pads, constant_values=value)
            item["node_mask"] = np.concatenate(
                [np.ones(n, dtype=np.float32), np.zeros(pad, dtype=np.float32)]
            )
        if self.only_selected_items:
            keep = {
                "textline_encoding",
                "adjacency_matrix",
                "node_label",
                "node_mask",
            } | set(self.extra_keys) | set(self.keep_keys)
            batch = [{k: v for k, v in item.items() if k in keep} for item in batch]
        return batch


class SparseBucketPadding(BucketPadding):
    """BucketPadding, then COO conversion: the config's entry to the sparse
    path (``grl_tpu/data/collate.py:142-172``).

    After node bucketing, each page's dense ``(Nb, L, Nb)`` adjacency
    becomes padded COO edge lists (``coo_senders``, ``coo_receivers``,
    ``coo_relations``, ``coo_weights``, ``coo_mask``) that share one edge
    bucket per batch, a multiple of ``edge_quantum``, and the dense tensor
    is dropped: the batch is O(N·F + E), not O(N²·L). ``KVProcedure`` sees
    the ``coo_*`` keys and feeds the model one flat batched
    :class:`grl_torch.ops.sparse.RelationalGraph`.
    """

    def __init__(self, edge_quantum: int = 256, **kwargs: Any):
        super().__init__(**kwargs)
        self.edge_quantum = int(edge_quantum)

    def __call__(self, batch: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        from grl_torch.ops.sparse import dense_to_relational_coo

        batch = super().__call__(batch)
        adjs = [np.asarray(item["adjacency_matrix"], np.float32) for item in batch]
        counts = [int(np.count_nonzero(a)) for a in adjs]
        bucket = next_bucket(max(max(counts), 1), self.edge_quantum)
        for item, adj in zip(batch, adjs):
            s, r, rel, w, m = dense_to_relational_coo(adj, edge_bucket=bucket)
            item["coo_senders"] = s
            item["coo_receivers"] = r
            item["coo_relations"] = rel
            item["coo_weights"] = w
            item["coo_mask"] = m
            del item["adjacency_matrix"]
        return batch


def stack_batch(batch: List[Dict[str, Any]]) -> Dict[str, Any]:
    """default_collate equivalent: stack same-shaped numpy arrays along a
    new batch axis; pass through everything else as lists."""
    out: Dict[str, Any] = {}
    for key in batch[0]:
        values = [item[key] for item in batch]
        if isinstance(values[0], np.ndarray) and all(
            isinstance(v, np.ndarray) and v.shape == values[0].shape for v in values
        ):
            out[key] = np.stack(values)
        elif isinstance(values[0], (int, float, np.integer, np.floating)):
            out[key] = np.asarray(values)
        else:
            out[key] = values
    return out
