"""Static-shape neighbor-sampled minibatches over one large graph.

Counterpart of ``grl_tpu/data/neighbor_sampler.py``, numpy only, drawing
from the ``RandomState`` in the same calls and order, so that one seed gives
both packages the same batches bit for bit.

A minibatch is a **positional sampling tree** (GraphSAGE with
replacement, arXiv:1706.02216):

* level 0 = the ``batch_size`` target nodes;
* level k+1 = exactly ``fanouts[k]`` sampled in-neighbors per level-k
  slot, drawn with replacement from the receiver-major CSR built once at
  init (slots of degree-0 or padding nodes are masked, their weights 0);
* local node ids are the tree positions themselves, so
  ``num_nodes = batch_size * (1 + f1 + f1*f2 + ...)`` and
  ``num_edges = batch_size * (f1 + f1*f2 + ...)`` are the same for every
  batch of every epoch: one set of shapes serves a whole run, which is what
  lets the port replay one captured CUDA graph for every chunk of steps.

A node sampled twice takes two tree slots with independent sub-trees
(GraphSAGE's estimator). ``groups`` independent trees stack on a leading
axis; merged into one flat graph (``batch_relational_coo``) they stay
disconnected.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple, Sequence

import numpy as np

from grl_torch.data.large_graph import LargeGraphData


class SampledBatch(NamedTuple):
    """One group-stacked minibatch; every array leads with the group axis G.

    features  (G, maxN, F) host-gathered rows, or (G, maxN, 0) when the
              sampler runs with ``with_features=False`` (the procedure
              gathers rows on the device from ``nodes``)
    nodes     (G, maxN) global node ids per tree slot, -1 = padding
    labels    (G, maxN) target labels at level-0 slots, ``label_pad`` elsewhere
    senders   (G, maxE) local (tree-position) ids
    receivers (G, maxE)
    relations (G, maxE)
    weights   (G, maxE) 0 where masked
    mask      (G, maxE)
    """

    features: np.ndarray
    nodes: np.ndarray
    labels: np.ndarray
    senders: np.ndarray
    receivers: np.ndarray
    relations: np.ndarray
    weights: np.ndarray
    mask: np.ndarray


class NeighborSampler:
    def __init__(
        self,
        data: LargeGraphData,
        fanouts: Sequence[int] = (10, 10),
        batch_size: int = 256,
        groups: int = 1,
        label_pad: int = -100,
        with_features: bool = True,
    ):
        self.data = data
        self.fanouts = tuple(int(f) for f in fanouts)
        self.batch_size = int(batch_size)
        self.groups = int(groups)
        self.label_pad = int(label_pad)
        self.with_features = bool(with_features)

        # Receiver-major CSR over in-edges, built once.
        N = len(data.features)
        order = np.argsort(data.receivers, kind="stable")
        self._in_senders = np.asarray(data.senders)[order].astype(np.int64)
        self._in_relations = np.asarray(data.relations)[order].astype(np.int32)
        self._in_weights = np.asarray(data.weights)[order].astype(np.float32)
        self._deg = np.bincount(data.receivers, minlength=N).astype(np.int64)
        self._starts = np.concatenate([[0], np.cumsum(self._deg)])[:-1]

        # Static tree geometry.
        sizes = [self.batch_size]
        for f in self.fanouts:
            sizes.append(sizes[-1] * f)
        self.level_sizes = sizes
        self.level_offsets = np.concatenate([[0], np.cumsum(sizes)])
        self.num_nodes = int(self.level_offsets[-1])  # maxN per group
        self.num_edges = int(sum(sizes[1:]))  # maxE per group

    def _sample_one(self, rng: np.random.RandomState, targets: np.ndarray):
        """``targets (batch_size,)`` node ids, -1 = padding; the flat
        per-group arrays of :class:`SampledBatch` (no group axis)."""
        nodes = np.full(self.num_nodes, -1, np.int64)
        nodes[: self.batch_size] = targets
        e_send = np.zeros(self.num_edges, np.int32)
        e_recv = np.zeros(self.num_edges, np.int32)
        e_rel = np.zeros(self.num_edges, np.int32)
        e_w = np.zeros(self.num_edges, np.float32)
        e_mask = np.zeros(self.num_edges, bool)

        e_off = 0
        for k, f in enumerate(self.fanouts):
            lo, hi = self.level_offsets[k], self.level_offsets[k + 1]
            frontier = nodes[lo:hi]
            n_k = hi - lo
            safe = np.maximum(frontier, 0)
            deg = np.where(frontier >= 0, self._deg[safe], 0)
            slot = (rng.rand(n_k, f) * np.maximum(deg, 1)[:, None]).astype(np.int64)
            idx = self._starts[safe][:, None] + slot
            valid = (deg > 0)[:, None] & np.ones((1, f), bool)
            idx = np.where(valid, idx, 0)
            samp = np.where(valid, self._in_senders[idx], -1)
            # Tree positions: child (lo_next + j*f + i) -> parent (lo + j).
            lo_next = self.level_offsets[k + 1]
            nodes[lo_next: lo_next + n_k * f] = samp.ravel()
            n_e = n_k * f
            e_send[e_off: e_off + n_e] = lo_next + np.arange(n_e)
            e_recv[e_off: e_off + n_e] = lo + np.repeat(np.arange(n_k), f)
            e_rel[e_off: e_off + n_e] = np.where(valid, self._in_relations[idx], 0).ravel()
            # Each of the f samples stands for deg/f in-edges of its parent
            # (GraphSAGE's importance weight), times the edge's own weight.
            w = self._in_weights[idx] * (deg[:, None] / float(f))
            e_w[e_off: e_off + n_e] = np.where(valid, w, 0.0).ravel()
            e_mask[e_off: e_off + n_e] = valid.ravel()
            e_off += n_e

        if self.with_features:
            feats = self.data.features[np.maximum(nodes, 0)].astype(np.float32)
            feats[nodes < 0] = 0.0
        else:
            feats = np.zeros((self.num_nodes, 0), np.float32)
        labels = np.full(self.num_nodes, self.label_pad, np.int32)
        tmask = targets >= 0
        labels[: self.batch_size][tmask] = self.data.labels[targets[tmask]]
        return feats, nodes.astype(np.int32), labels, e_send, e_recv, e_rel, e_w, e_mask

    def sample(self, rng: np.random.RandomState, targets: np.ndarray) -> SampledBatch:
        """``targets (G, batch_size)`` -> a group-stacked :class:`SampledBatch`."""
        parts = [self._sample_one(rng, t) for t in targets]
        return SampledBatch(*(np.stack(cols) for cols in zip(*parts)))

    def epoch_batches(self, rng: np.random.RandomState, node_mask: np.ndarray) -> Iterator[SampledBatch]:
        """Shuffled minibatches covering the ``node_mask`` nodes once; the
        last batch pads with -1 targets (masked labels)."""
        pool = np.flatnonzero(node_mask)
        pool = pool[rng.permutation(len(pool))]
        step = self.groups * self.batch_size
        for i in range(0, len(pool), step):
            chunk = pool[i: i + step]
            padded = np.full(step, -1, np.int64)
            padded[: len(chunk)] = chunk
            yield self.sample(rng, padded.reshape(self.groups, self.batch_size))
