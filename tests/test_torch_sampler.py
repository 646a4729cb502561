"""The port's NeighborSampler against grl_tpu's: the same seed gives the
same batches, bit for bit.

Each package builds tests/test_neighbor_sampling.py's SBM (1024 nodes, 5
classes, 2 relations, features 24) with its own ``sbm_relational_graph``;
both samplers then draw a whole epoch from ``RandomState(seed)``, and
every field of every ``SampledBatch`` must be equal, dtype and shape
included, the padded last batch too.
"""
from __future__ import annotations

import numpy as np
import pytest

from grl_tpu.data import large_graph as jax_large_graph
from grl_tpu.data.neighbor_sampler import NeighborSampler as JaxNeighborSampler
from grl_torch.data import large_graph
from grl_torch.data.neighbor_sampler import NeighborSampler, SampledBatch

SBM = dict(num_nodes=1024, num_classes=5, num_relations=2, avg_degree=8, feature_dim=24, seed=11)


@pytest.fixture(scope="module")
def graphs():
    return large_graph.sbm_relational_graph(**SBM), jax_large_graph.sbm_relational_graph(**SBM)


@pytest.mark.parametrize("fanouts", [(3, 2), (2, 2, 2)])
@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("with_features", [True, False])
def test_epoch_batches_match_grl_tpu_bit_for_bit(graphs, fanouts, groups, with_features):
    """A whole training epoch and a validation pass from one RandomState,
    in grl_tpu's order; static shapes in every batch; the last batch
    padded with -1 targets and label_pad labels."""
    data, jax_data = graphs
    batch_size = 48
    ours = NeighborSampler(data, fanouts, batch_size, groups, with_features=with_features)
    theirs = JaxNeighborSampler(jax_data, fanouts, batch_size, groups, with_features=with_features)
    assert ours.level_sizes == theirs.level_sizes and ours.num_nodes == theirs.num_nodes
    assert ours.num_edges == theirs.num_edges
    rng, jax_rng = np.random.RandomState(3), np.random.RandomState(3)
    shapes = set()
    for mask in (data.train_mask, data.val_mask):
        pairs = list(zip(ours.epoch_batches(rng, mask), theirs.epoch_batches(jax_rng, mask)))
        step = groups * batch_size
        assert len(pairs) == -(-int(mask.sum()) // step)
        for a, b in pairs:
            assert isinstance(a, SampledBatch)
            for name in SampledBatch._fields:
                x, y = getattr(a, name), getattr(b, name)
                assert x.dtype == y.dtype and x.shape == y.shape, name
                np.testing.assert_array_equal(x, y, err_msg=name)
            shapes.add(tuple(x.shape for x in a))
        last = pairs[-1][0]
        pad = step - int(mask.sum()) % step
        if pad < step:
            targets = last.nodes[:, :batch_size].reshape(-1)
            assert (targets[-pad:] == -1).all() and (targets[:-pad] >= 0).all()
            assert (last.labels[:, :batch_size].reshape(-1)[-pad:] == -100).all()
    assert len(shapes) == 1
    G, maxN, maxE = groups, ours.num_nodes, ours.num_edges
    F = SBM["feature_dim"] if with_features else 0
    assert shapes.pop() == ((G, maxN, F), (G, maxN), (G, maxN), (G, maxE), (G, maxE), (G, maxE), (G, maxE),
                            (G, maxE))
    # The rng streams end at the same point.
    assert rng.randint(1 << 30) == jax_rng.randint(1 << 30)


def test_sample_matches_grl_tpu_on_given_targets(graphs):
    """``sample`` on targets with padding, and the tree's invariants:
    receivers are parents, senders children, masked edges weigh 0."""
    data, jax_data = graphs
    targets = np.arange(32).reshape(2, 16)
    targets[1, -5:] = -1
    a = NeighborSampler(data, (4, 2), 16, 2).sample(np.random.RandomState(1), targets)
    b = JaxNeighborSampler(jax_data, (4, 2), 16, 2).sample(np.random.RandomState(1), targets)
    for name in SampledBatch._fields:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    assert (a.receivers < a.senders).all() and (a.weights[~a.mask] == 0).all()
    assert (a.features[a.nodes < 0] == 0).all()
