"""The sparse path's host data and plain ops: grl_torch against grl_tpu.

``sbm_relational_graph`` is a numpy generator on one ``RandomState``
stream in both packages, so its arrays must be identical, dtype included.
The segment ops and the COO aggregation compute in float32 on both sides
and differ in summation order only (1e-6).
"""
from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from grl_tpu.data import large_graph as jax_large_graph
from grl_tpu.ops import segment as jax_segment
from grl_tpu.ops import sparse as jax_sparse
from grl_torch.data import large_graph
from grl_torch.ops import segment, sparse


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite spreads files over worker processes on shared cores: one
    intra-op thread per worker keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("kwargs", [
    dict(num_nodes=600, num_classes=5, num_relations=3, avg_degree=6, feature_dim=16, seed=3),
    dict(num_nodes=700, num_classes=4, num_relations=1, avg_degree=7, feature_dim=8, seed=1,
         communities=32),
    dict(num_nodes=500, num_classes=3, num_relations=2, avg_degree=5, feature_dim=8, seed=2,
         degree_zipf=1.1),
])
def test_sbm_arrays_equal_grl_tpus(kwargs):
    ours = large_graph.sbm_relational_graph(**kwargs)
    theirs = jax_large_graph.sbm_relational_graph(**kwargs)
    for name in large_graph.LargeGraphData._fields:
        a, b = getattr(ours, name), getattr(theirs, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


def test_to_relational_graph_pads_like_grl_tpu():
    data = large_graph.sbm_relational_graph(num_nodes=64, num_classes=3, avg_degree=3, feature_dim=4)
    graph, feats = large_graph.to_relational_graph(data, edge_bucket=len(data.senders) + 7, device="cpu")
    jgraph, jfeats = jax_large_graph.to_relational_graph(
        jax_large_graph.sbm_relational_graph(num_nodes=64, num_classes=3, avg_degree=3, feature_dim=4),
        edge_bucket=len(data.senders) + 7,
    )
    np.testing.assert_array_equal(feats, jfeats)
    for name in ("senders", "receivers", "relations", "weights", "mask"):
        np.testing.assert_array_equal(getattr(graph, name).numpy(), np.asarray(getattr(jgraph, name)), err_msg=name)
    assert (graph.num_nodes, graph.num_relations) == (jgraph.num_nodes, jgraph.num_relations)
    assert graph.num_edges() == len(data.senders)
    with pytest.raises(ValueError):
        large_graph.to_relational_graph(data, edge_bucket=3)


def random_coo(seed=0, N=50, E=400, L=3, F=12, pad=30):
    rng = np.random.RandomState(seed)
    senders = rng.randint(0, N, E + pad).astype(np.int32)
    receivers = rng.randint(0, N - 4, E + pad).astype(np.int32)  # 4 isolated receivers
    relations = rng.randint(0, L, E + pad).astype(np.int32)
    weights = (rng.rand(E + pad) + 0.1).astype(np.float32)
    mask = np.concatenate([np.ones(E, bool), np.zeros(pad, bool)])
    V = rng.randn(N, F).astype(np.float32)
    keep = (rng.rand(E + pad) < 0.7).astype(np.float32) / 0.7
    ours = sparse.graph_from_numpy(senders, receivers, relations, weights, mask, N, L)
    theirs = jax_sparse.RelationalGraph(
        senders=jnp.asarray(senders), receivers=jnp.asarray(receivers),
        relations=jnp.asarray(relations), weights=jnp.asarray(weights),
        mask=jnp.asarray(mask), num_nodes=N, num_relations=L,
    )
    return ours, theirs, V, keep


@pytest.mark.parametrize("with_keep", [False, True])
def test_relational_neighbor_coo_matches_grl_tpu(with_keep):
    ours, theirs, V, keep = random_coo()
    out = sparse.relational_neighbor_coo(
        torch.from_numpy(V), ours, torch.from_numpy(keep) if with_keep else None
    ).numpy()
    expected = np.asarray(jax_sparse.relational_neighbor_coo(
        jnp.asarray(V), theirs, jnp.asarray(keep) if with_keep else None
    ))
    assert out.shape == expected.shape == (50, 3 * 12)
    np.testing.assert_allclose(out, expected, rtol=1e-6, atol=1e-6)
    scale = np.linspace(0, 2, 50).astype(np.float32)
    full = sparse.relational_aggregate_coo(torch.from_numpy(V), ours, torch.from_numpy(scale)).numpy()
    full_expected = np.asarray(jax_sparse.relational_aggregate_coo(jnp.asarray(V), theirs, jnp.asarray(scale)))
    np.testing.assert_allclose(full, full_expected, rtol=1e-6, atol=1e-6)


def test_coo_builders_match_grl_tpu():
    rng = np.random.RandomState(4)
    A = (rng.rand(20, 3, 20) < 0.1).astype(np.float32) * 2.0
    ours = sparse.dense_to_relational_coo(A, edge_bucket=200)
    theirs = jax_sparse.dense_to_relational_coo(A, edge_bucket=200)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        sparse.dense_to_relational_coo(A, edge_bucket=2)
    stacked = [np.stack([x, x]) for x in ours]
    batch = sparse.batch_relational_coo(*[torch.from_numpy(x) for x in stacked], 20, 3)
    jbatch = jax_sparse.batch_relational_coo(*[jnp.asarray(x) for x in stacked], 20, 3)
    for name in ("senders", "receivers", "relations", "weights", "mask"):
        np.testing.assert_array_equal(getattr(batch, name).numpy(), np.asarray(getattr(jbatch, name)))
    assert batch.num_nodes == 40 and batch.batch_shape == jbatch.batch_shape == (2, 20)


def test_drop_edge_coo_law():
    """iid keep with a 1/keep rescale on edges and self-loops (the draws
    differ from jax.random's by construction; the law is held)."""
    ours, _, _, _ = random_coo(E=20000, N=4000, pad=0)
    gen = torch.Generator().manual_seed(0)
    edge_keep, self_scale = sparse.drop_edge_coo(ours, 0.3, gen)
    assert edge_keep.shape == (20000,) and self_scale.shape == (4000,)
    for values, n in ((edge_keep, 20000), (self_scale, 4000)):
        assert set(torch.unique(values).tolist()) <= {0.0, float(np.float32(1 / 0.7))}
        # Kept share within 5 standard deviations of a binomial share.
        assert abs(float((values > 0).float().mean()) - 0.7) < 5 * (0.21 / n) ** 0.5
    assert sparse.drop_edge_coo(ours, 0.0, gen) == (None, None)
    assert sparse.drop_edge_coo(ours, 0.3, gen, deterministic=True) == (None, None)


@pytest.mark.parametrize("use_mask", [False, True])
def test_segment_ops_match_grl_tpu(use_mask):
    rng = np.random.RandomState(5)
    data = rng.randn(300, 4).astype(np.float32)
    logits = rng.randn(300).astype(np.float32)
    ids = rng.randint(0, 37, 300).astype(np.int32)  # segments 37..39 empty
    mask = rng.rand(300) < 0.6 if use_mask else None
    np.testing.assert_allclose(
        segment.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 40).numpy(),
        np.asarray(jax_segment.segment_sum(jnp.asarray(data), jnp.asarray(ids), 40)), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        segment.segment_max(torch.from_numpy(data), torch.from_numpy(ids), 40).numpy(),
        np.asarray(jax_segment.segment_max(jnp.asarray(data), jnp.asarray(ids), 40)))
    out = segment.segment_softmax(
        torch.from_numpy(logits), torch.from_numpy(ids), 40,
        mask=None if mask is None else torch.from_numpy(mask)).numpy()
    expected = np.asarray(jax_segment.segment_softmax(
        jnp.asarray(logits), jnp.asarray(ids), 40, mask=None if mask is None else jnp.asarray(mask)))
    np.testing.assert_allclose(out, expected, rtol=1e-6, atol=1e-6)
    # Each non-empty segment sums to 1 over its kept entries.
    sums = np.bincount(ids, weights=out, minlength=40)
    kept = np.bincount(ids, weights=np.ones(300) if mask is None else mask, minlength=40)
    np.testing.assert_allclose(sums[kept > 0], 1.0, rtol=1e-5)
    assert np.all(sums[kept == 0] == 0.0)
