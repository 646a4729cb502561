"""Plan-time node orders that pack communities into contiguous rows.

Counterpart of ``grl_tpu/ops/reorder.py``, numpy only (grl_tpu's module
is numpy too, but importing any ``grl_tpu`` module pulls in JAX, so the
port keeps its own copy). The permutations equal grl_tpu's bit for bit.

``kernel_impl: tile`` plans the LPA order inside
:class:`grl_torch.ops.tile.TileGraphKernel`: the edges are relabeled at
plan time, ``node_perm`` is exposed, and ``FullGraphProcedure`` places
features and labels through it once at setup, so a step pays nothing for
the order and its outputs stay in the reordered space, consistent with
the placed labels. Without the order a community graph scattered over
random ids has uniformly sparse blocks and no dense tile clears the
planner's threshold.

Every function returns ``perm``, mapping an ORIGINAL node id to its new
id: row ``perm[i]`` of the reordered arrays holds original node ``i``.
"""
from __future__ import annotations

import numpy as np


def rcm_order(senders: np.ndarray, receivers: np.ndarray, num_nodes: int) -> np.ndarray:
    """Reverse Cuthill-McKee on the symmetrized adjacency (``reorder.py:29``)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    ones = np.ones(len(senders), np.int8)
    adj = coo_matrix((ones, (senders, receivers)), shape=(num_nodes, num_nodes)).tocsr()
    sym = adj + adj.T
    order = np.asarray(reverse_cuthill_mckee(sym, symmetric_mode=True))
    perm = np.empty(num_nodes, np.int64)
    perm[order] = np.arange(num_nodes)
    return perm


def lpa_order(senders: np.ndarray, receivers: np.ndarray, num_nodes: int, rounds: int = 30,
              seed: int = 0) -> np.ndarray:
    """Label-propagation community order (``reorder.py:51``): ``rounds``
    synchronous rounds in which every node adopts the plurality label of
    its symmetrized neighbours, ties broken by ``RandomState(seed)``
    jitter; nodes are then grouped by label (a stable sort)."""
    s = np.concatenate([senders, receivers]).astype(np.int64)
    r = np.concatenate([receivers, senders]).astype(np.int64)
    labels = np.arange(num_nodes, dtype=np.int64)
    rng = np.random.RandomState(seed)
    for _ in range(rounds):
        lab_n = labels[s]
        # Plurality label per receiver: sort (receiver, label) pairs,
        # run-length count, keep each receiver's max-count pair.
        order = np.lexsort((lab_n, r))
        rr, ll = r[order], lab_n[order]
        new_pair = np.ones(len(rr), bool)
        new_pair[1:] = (rr[1:] != rr[:-1]) | (ll[1:] != ll[:-1])
        pair_ids = np.cumsum(new_pair) - 1
        counts = np.bincount(pair_ids).astype(np.float64)
        pr, pl = rr[new_pair], ll[new_pair]
        score = counts + rng.rand(len(counts))
        best_score = np.full(num_nodes, -1.0)
        np.maximum.at(best_score, pr, score)
        best = np.full(num_nodes, -1, np.int64)
        sel = score == best_score[pr]
        best[pr[sel]] = pl[sel]
        labels = np.where(best >= 0, best, labels)
    order = np.argsort(labels, kind="stable")
    perm = np.empty(num_nodes, np.int64)
    perm[order] = np.arange(num_nodes)
    return perm


def window_locality(senders: np.ndarray, receivers: np.ndarray, window: int) -> float:
    """Share of edges whose endpoints lie within ``window`` rows (a
    diagnostic)."""
    if len(senders) == 0:
        return 1.0
    gap = np.abs(np.asarray(senders, np.int64) - np.asarray(receivers, np.int64))
    return float((gap < window).mean())


def bandwidth(senders: np.ndarray, receivers: np.ndarray) -> int:
    """Largest ``|sender - receiver|`` (a diagnostic)."""
    if len(senders) == 0:
        return 0
    return int(np.max(np.abs(np.asarray(senders) - np.asarray(receivers))))
