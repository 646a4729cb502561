"""grl_torch's node orders (grl_torch/ops/reorder.py) against grl_tpu's,
bit for bit: the LPA and RCM permutations on community graphs, with
duplicate edges and isolated nodes, and the locality diagnostics."""
from __future__ import annotations

import numpy as np
import pytest

from grl_tpu.ops import reorder as jax_reorder
from grl_torch.data import large_graph
from grl_torch.ops import reorder


def graph(seed, num_nodes=3000, communities=30):
    data = large_graph.sbm_relational_graph(num_nodes=num_nodes, num_classes=6, num_relations=2, avg_degree=6,
                                            feature_dim=4, communities=communities, seed=seed)
    senders, receivers = data.senders.copy(), data.receivers.copy()
    senders[:50] = senders[50:100]  # duplicate edges
    receivers[:50] = receivers[50:100]
    return senders, receivers, num_nodes + 7  # seven isolated nodes at the end


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("rounds, lpa_seed", [(30, 0), (5, 3)])
def test_lpa_order_matches_grl_tpu(seed, rounds, lpa_seed):
    senders, receivers, N = graph(seed)
    ours = reorder.lpa_order(senders, receivers, N, rounds=rounds, seed=lpa_seed)
    theirs = jax_reorder.lpa_order(senders, receivers, N, rounds=rounds, seed=lpa_seed)
    np.testing.assert_array_equal(ours, theirs)
    assert ours.dtype == np.int64 and np.array_equal(np.sort(ours), np.arange(N))


@pytest.mark.parametrize("seed", [0, 1])
def test_rcm_order_matches_grl_tpu(seed):
    senders, receivers, N = graph(seed)
    ours = reorder.rcm_order(senders, receivers, N)
    np.testing.assert_array_equal(ours, jax_reorder.rcm_order(senders, receivers, N))
    assert np.array_equal(np.sort(ours), np.arange(N))


def test_diagnostics_match_grl_tpu():
    senders, receivers, N = graph(2)
    perm = reorder.lpa_order(senders, receivers, N)
    for s, r in ((senders, receivers), (perm[senders], perm[receivers])):
        for window in (64, 256, 4096):
            assert reorder.window_locality(s, r, window) == jax_reorder.window_locality(s, r, window)
        assert reorder.bandwidth(s, r) == jax_reorder.bandwidth(s, r)
    # The order packs communities: more edges within 256 rows than before.
    assert reorder.window_locality(perm[senders], perm[receivers], 256) > 2 * reorder.window_locality(
        senders, receivers, 256)
    assert reorder.window_locality([], [], 8) == 1.0 and reorder.bandwidth([], []) == 0
