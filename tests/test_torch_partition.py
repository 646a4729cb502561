"""The node-partitioned graph and its ring halo exchange
(``grl_torch.parallel.graph_partition``), grl_torch against grl_tpu.

* ``partition_graph``'s plans, the range and the degree-balanced one, at
  D = 2, 4 and 8: every array of the plan, ``Ec`` and ``node_perm`` equal
  to ``grl_tpu``'s bit for bit; ``pad_node_arrays`` and
  ``scatter_node_arrays`` equal;
* in a gloo world of 4 on the CPU: each rank's block of the ring
  aggregate (``partitioned_relational_aggregate``) and of the all-gather
  one against ``grl_tpu``'s ``partitioned_relational_aggregate`` on a
  4-device mesh, and their gradients to V against ``jax.grad`` of the same
  weighted sum, float32, within 1e-6 of the scale, on the range plan and
  on a balanced plan of a hub-first power-law graph.
"""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.test_torch_distributed import results, run_world

D_WORLD = 4


def random_graph(seed=0, N=64, L=6, F=16, E=600):
    rng = np.random.RandomState(seed)
    senders = rng.randint(0, N, E).astype(np.int32)
    receivers = rng.randint(0, N, E).astype(np.int32)
    relations = rng.randint(0, L, E).astype(np.int32)
    weights = rng.rand(E).astype(np.float32)
    V = rng.randn(N, F).astype(np.float32)
    return V, senders, receivers, relations, weights


def hub_graph(N=256, L=2, F=16, seed=7):
    """tests/test_parallel.py's hub-first power-law graph."""
    rng = np.random.RandomState(seed)
    deg = np.clip(rng.zipf(1.6, N), 1, N // 4)
    deg = -np.sort(-deg)
    receivers = np.repeat(np.arange(N), deg).astype(np.int32)
    senders = rng.randint(0, N, len(receivers)).astype(np.int32)
    relations = (np.arange(len(senders)) % L).astype(np.int32)
    weights = np.ones(len(senders), np.float32)
    V = np.random.RandomState(0).randn(N, F).astype(np.float32)
    return V, senders, receivers, relations, weights


CASES = {"range": (random_graph(N=61), 6, False, 64), "balanced": (hub_graph(), 2, True, 64)}


@pytest.mark.parametrize("balance", [False, True], ids=["range", "balanced"])
@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("quantum", [64, 256])
def test_plans_equal_grl_tpu_bit_for_bit(D, balance, quantum):
    from grl_tpu.parallel.graph_partition import partition_graph as jax_partition
    from grl_torch.parallel.graph_partition import partition_graph

    for _, senders, receivers, relations, weights in (random_graph(N=61), hub_graph()):
        N = int(max(senders.max(), receivers.max())) + 1
        L = int(relations.max()) + 1
        ours = partition_graph(senders, receivers, relations, weights, N, L, D, quantum, balance)
        theirs = jax_partition(senders, receivers, relations, weights, N, L, D, quantum, balance)
        for field in ("senders", "receivers", "relations", "weights", "mask"):
            a, b = getattr(ours, field), np.asarray(getattr(theirs, field))
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        assert (ours.num_nodes, ours.num_relations) == (theirs.num_nodes, theirs.num_relations)
        if balance:
            np.testing.assert_array_equal(ours.node_perm, theirs.node_perm)
        else:
            assert ours.node_perm is None and theirs.node_perm is None


def test_node_array_placement_equals_grl_tpu():
    from grl_tpu.parallel.sharded_flagship import pad_node_arrays as jax_pad
    from grl_tpu.parallel.sharded_flagship import scatter_node_arrays as jax_scatter
    from grl_torch.parallel.sharded_flagship import pad_node_arrays, scatter_node_arrays

    rng = np.random.RandomState(1)
    feats, labels = rng.randn(10, 3).astype(np.float32), rng.randint(0, 4, 10).astype(np.int32)
    perm = rng.permutation(12)[:10]
    for a, b in zip(pad_node_arrays(feats, labels, 12) + pad_node_arrays(None, labels, 12),
                    jax_pad(feats, labels, 12) + jax_pad(None, labels, 12)):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)
    for a, b in zip(scatter_node_arrays(perm, feats, labels, 12) + scatter_node_arrays(perm, None, labels, 12),
                    jax_scatter(perm, feats, labels, 12) + jax_scatter(perm, None, labels, 12)):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)


WORKER = """
from grl_torch.config import ConfigDict
from grl_torch.parallel import (all_gather_relational_aggregate, initialize_distributed, make_mesh,
                                partitioned_relational_aggregate)
from grl_torch.parallel.graph_partition import PartitionedGraph

initialize_distributed(ConfigDict({"parallel": {"distributed": {"timeout": 120}}}), "cpu")
mesh = make_mesh({"data": WORLD})
out = {}
for case in ("range", "balanced"):
    arrays = dict(np.load(os.path.join(OUT, f"{case}.npz")))
    V, G = arrays.pop("V"), arrays.pop("G")
    num_nodes, num_relations = int(arrays.pop("num_nodes")), int(arrays.pop("num_relations"))
    part = PartitionedGraph(**{k: arrays[k] for k in ("senders", "receivers", "relations", "weights", "mask")},
                            num_nodes=num_nodes, num_relations=num_relations)
    shard_n = num_nodes // WORLD
    rows = slice(RANK * shard_n, (RANK + 1) * shard_n)
    for name, fn in (("ring", partitioned_relational_aggregate), ("all_gather", all_gather_relational_aggregate)):
        block = torch.tensor(V[rows], requires_grad=True)
        agg = fn(block, part, mesh)
        (agg * torch.from_numpy(G[rows])).sum().backward()
        out[(case, name)] = (agg.detach(), block.grad)
no_jax()
torch.save(out, os.path.join(OUT, f"rank{RANK}.pt"))
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """grl_tpu's aggregates and gradients on its 4-device mesh, and each
    rank's blocks of the port's."""
    from grl_tpu.parallel import make_mesh, partition_graph, partitioned_relational_aggregate

    tmp = tmp_path_factory.mktemp("torch_partition")
    out = tmp / "world_out"
    out.mkdir()
    mesh = make_mesh({"data": D_WORLD}, devices=jax.devices()[:D_WORLD])
    expected = {}
    for case, ((V, senders, receivers, relations, weights), L, balance, quantum) in CASES.items():
        N = len(V)
        part = partition_graph(senders, receivers, relations, weights, N, L, D_WORLD, quantum, balance)
        V_part = np.zeros((part.num_nodes, V.shape[1]), np.float32)
        if part.node_perm is not None:
            V_part[part.node_perm] = V
        else:
            V_part[:N] = V
        G = np.random.RandomState(5).randn(part.num_nodes, (L + 1) * V.shape[1]).astype(np.float32)

        def weighted(v):
            return jnp.sum(partitioned_relational_aggregate(v, part, mesh) * G)

        agg = np.asarray(partitioned_relational_aggregate(jnp.asarray(V_part), part, mesh))
        grad = np.asarray(jax.grad(weighted)(jnp.asarray(V_part)))
        expected[case] = (agg, grad, part.num_nodes)
        np.savez(out / f"{case}.npz", V=V_part, G=G, num_nodes=part.num_nodes, num_relations=L,
                 **{k: np.asarray(getattr(part, k)) for k in ("senders", "receivers", "relations", "weights",
                                                              "mask")})
    run_world(tmp, WORKER, D_WORLD, "world", timeout=180)
    return results(tmp, "world", D_WORLD), expected


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("impl", ["ring", "all_gather"])
def test_aggregate_and_gradient_match_grl_tpu(world, case, impl):
    ranks, expected = world
    agg, grad, num_nodes = expected[case]
    shard_n = num_nodes // D_WORLD
    ours = np.concatenate([r[(case, impl)][0].numpy() for r in ranks])
    ours_grad = np.concatenate([r[(case, impl)][1].numpy() for r in ranks])
    assert ours.shape == agg.shape and all(r[(case, impl)][0].shape[0] == shard_n for r in ranks)
    np.testing.assert_allclose(ours, agg, rtol=0, atol=1e-6 * float(np.abs(agg).max()))
    np.testing.assert_allclose(ours_grad, grad, rtol=0, atol=1e-6 * float(np.abs(grad).max()))
