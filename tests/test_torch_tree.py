"""The tree aggregation and the model on a TreeGraph, grl_torch against
grl_tpu.

``tree_neighbor_aggregate`` is held to grl_tpu's at L = 1 and 2, with and
without a DropEdge keep mask, in float32 within 1e-6 of the scale, and to
the port's own COO aggregation on the tree's implied edges. The model's
guards on a TreeGraph (``kernel_impl``, attention) behave as grl_tpu's,
and ``head_rows`` gives the full logits' level-0 rows.
"""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from grl_tpu import models as jax_models
from grl_tpu.ops import sparse as jax_sparse
from grl_tpu.ops import tree as jax_tree
from grl_torch import models
from grl_torch.data import large_graph
from grl_torch.data.neighbor_sampler import NeighborSampler
from grl_torch.models.layers import Rngs
from grl_torch.ops import sparse
from grl_torch.ops.tree import TreeGraph, tree_neighbor_aggregate

SBM = dict(num_nodes=1024, num_classes=5, num_relations=2, avg_degree=8, feature_dim=24, seed=11)
FANOUTS, BATCH, GROUPS = (3, 2), 16, 2


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def sampled(num_relations: int, seed: int = 0):
    """A group-stacked sampled batch of the SBM at ``num_relations``."""
    data = large_graph.sbm_relational_graph(**{**SBM, "num_relations": num_relations})
    sampler = NeighborSampler(data, FANOUTS, BATCH, GROUPS)
    rng = np.random.RandomState(seed)
    targets = rng.permutation(np.flatnonzero(data.train_mask))[:GROUPS * BATCH].reshape(GROUPS, BATCH)
    return sampler, sampler.sample(rng, targets)


def trees(sampler, batch, num_relations: int):
    kwargs = dict(level_sizes=tuple(sampler.level_sizes), fanouts=sampler.fanouts, num_relations=num_relations)
    ours = TreeGraph(weights=torch.from_numpy(batch.weights), relations=torch.from_numpy(batch.relations), **kwargs)
    theirs = jax_tree.TreeGraph(weights=jnp.asarray(batch.weights), relations=jnp.asarray(batch.relations), **kwargs)
    return ours, theirs


@pytest.mark.parametrize("num_relations", [1, 2])
@pytest.mark.parametrize("keep", [False, True])
def test_tree_aggregate_matches_grl_tpu_and_coo(num_relations, keep):
    sampler, batch = sampled(num_relations)
    tree, jax_tree_graph = trees(sampler, batch, num_relations)
    G, maxN, F = GROUPS, sampler.num_nodes, 20
    rng = np.random.RandomState(4)
    V = rng.randn(G * maxN, F).astype(np.float32)
    edge_keep = (rng.rand(G, sampler.num_edges) < 0.7).astype(np.float32) / 0.7 if keep else None
    out = tree_neighbor_aggregate(torch.from_numpy(V), tree,
                                  None if edge_keep is None else torch.from_numpy(edge_keep)).numpy()
    expected = np.asarray(jax_tree.tree_neighbor_aggregate(
        jnp.asarray(V), jax_tree_graph, None if edge_keep is None else jnp.asarray(edge_keep)))
    assert out.shape == (G * maxN, num_relations * F) and out.dtype == np.float32
    scale = np.abs(expected).max()
    np.testing.assert_allclose(out, expected, rtol=0, atol=1e-6 * scale)
    # The same sum through the COO route on the tree's implied edges.
    coo = sparse.batch_relational_coo(
        *(torch.from_numpy(a) for a in (batch.senders, batch.receivers, batch.relations, batch.weights,
                                         batch.mask)),
        nodes_per_sample=maxN, num_relations=num_relations)
    flat_keep = None if edge_keep is None else torch.from_numpy(edge_keep.reshape(-1))
    np.testing.assert_allclose(sparse.relational_neighbor_coo(torch.from_numpy(V), coo, flat_keep).numpy(), out,
                               rtol=0, atol=1e-6 * scale)
    # The leaf level has no children.
    assert not out.reshape(G, maxN, -1)[:, -sampler.level_sizes[-1]:].any()


def test_drop_edge_on_a_tree_graph():
    """drop_edge_coo takes the tree's (G, E) weights shape; the keep share
    is 0.7 within 5 binomial standard deviations."""
    sampler, batch = sampled(2)
    tree, _ = trees(sampler, batch, 2)
    edge_keep, self_scale = sparse.drop_edge_coo(tree, 0.3, torch.Generator().manual_seed(0))
    assert edge_keep.shape == tree.weights.shape and self_scale.shape == (tree.num_nodes,)
    for mask in (edge_keep, self_scale):
        values = set(np.unique(mask.numpy()).tolist())
        assert values <= {0.0, np.float32(1 / 0.7)}
        n = mask.numel()
        share = float((mask > 0).float().mean())
        assert abs(share - 0.7) < 5 * np.sqrt(0.7 * 0.3 / n), share
    assert sparse.drop_edge_coo(tree, 0.3, torch.Generator(), deterministic=True) == (None, None)


def flagship(jax_graph, F_in, **kwargs):
    """The flagship of both packages with the same weights (L = 2)."""
    args = dict(input_dim=F_in, output_dim=5, num_edges=2, net_size=16, use_attention=False, **kwargs)
    jax_model = jax_models.create_model("GraphCNNDropEdge", **args)
    V = jnp.zeros((jax_graph.num_nodes, F_in), jnp.float32)
    variables = jax_models.init_model(jax_model.clone(kernel_impl="xla"),
                                      jax.random.PRNGKey(0), (V, jax_graph))
    model = models.create_model("GraphCNNDropEdge", **args, device="cpu")
    model.load_state_dict(models.state_dict_from_flax(numpy_tree(variables)))
    return jax_model, variables, model


def test_kernel_impl_guard_matches_grl_tpu():
    """kernel_impl: ell runs on a TreeGraph (its einsums need no kernel)
    in both packages, and a train step moves the weights; on a kernel-less
    RelationalGraph both raise ValueError."""
    sampler, batch = sampled(2)
    tree, jax_tree_graph = trees(sampler, batch, 2)
    V = np.random.RandomState(0).randn(tree.num_nodes, 24).astype(np.float32)
    jax_model, variables, model = flagship(jax_tree_graph, 24, kernel_impl="ell")
    jax_out = jax_model.apply(variables, (jnp.asarray(V), jax_tree_graph), train=True,
                              rngs={"dropout": jax.random.PRNGKey(1)})
    assert np.isfinite(np.asarray(jax_out)).all()
    before = [p.detach().clone() for p in model.parameters()]
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-2)
    logits = model.train()((torch.from_numpy(V), tree), rngs=Rngs.from_seed(0, torch.device("cpu")))
    labels = torch.from_numpy(batch.labels.reshape(-1).astype(np.int64))
    torch.nn.functional.cross_entropy(logits, labels, ignore_index=-100).backward()
    optimizer.step()
    assert all(not torch.equal(a, p) for a, p in zip(before, model.parameters()))

    coo = sparse.batch_relational_coo(
        *(torch.from_numpy(a) for a in (batch.senders, batch.receivers, batch.relations, batch.weights,
                                         batch.mask)), nodes_per_sample=sampler.num_nodes, num_relations=2)
    jax_coo = jax_sparse.batch_relational_coo(
        *(jnp.asarray(a) for a in (batch.senders, batch.receivers, batch.relations, batch.weights, batch.mask)),
        nodes_per_sample=sampler.num_nodes, num_relations=2)
    with pytest.raises(ValueError, match="kernel_impl"):
        jax_model.apply(variables, (jnp.asarray(V), jax_coo), train=False)
    with pytest.raises(ValueError, match="kernel_impl"):
        model.eval()((torch.from_numpy(V), coo))


def test_attention_on_a_tree_graph_raises_in_both_packages():
    sampler, batch = sampled(2)
    tree, jax_tree_graph = trees(sampler, batch, 2)
    args = dict(input_dim=24, output_dim=5, num_edges=2, net_size=16, use_attention=True)
    V = np.zeros((tree.num_nodes, 24), np.float32)
    with pytest.raises(ValueError, match="NodeSelfAtten"):
        jax_models.init_model(jax_models.create_model("GraphCNNDropEdge", **args), jax.random.PRNGKey(0),
                              (jnp.asarray(V), jax_tree_graph))
    model = models.create_model("GraphCNNDropEdge", **args, device="cpu")
    with pytest.raises(ValueError, match="NodeSelfAtten"):
        model.eval()((torch.from_numpy(V), tree))


def test_head_rows_logits_are_the_level0_rows():
    """Eval logits with head_rows = the full logits' level-0 rows, and
    both equal grl_tpu's within 1e-5 of the scale."""
    sampler, batch = sampled(2)
    tree, jax_tree_graph = trees(sampler, batch, 2)
    V = np.random.RandomState(1).randn(tree.num_nodes, 24).astype(np.float32)
    jax_model, variables, model = flagship(jax_tree_graph, 24)
    head = (GROUPS, sampler.num_nodes, BATCH)
    with torch.no_grad():
        full = model.eval()((torch.from_numpy(V), tree)).numpy()
        sliced = model((torch.from_numpy(V), tree), head_rows=head).numpy()
    level0 = full.reshape(GROUPS, sampler.num_nodes, -1)[:, :BATCH].reshape(GROUPS * BATCH, -1)
    scale = np.abs(level0).max()
    np.testing.assert_allclose(sliced, level0, rtol=0, atol=1e-6 * scale)
    expected = np.asarray(jax_model.apply(variables, (jnp.asarray(V), jax_tree_graph), train=False, head_rows=head))
    np.testing.assert_allclose(sliced, expected, rtol=0, atol=1e-5 * scale)
