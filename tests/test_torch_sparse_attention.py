"""K4 (fused sparse attention) and SparseNodeSelfAtten: grl_torch against
grl_tpu.

The port's ``SparseAttentionKernel.attend`` (its plain version, on the
CPU) and its three gradients are held against grl_tpu's
``SparseAttentionKernel`` with the Pallas bucket kernel in interpret mode,
as tests/test_sparse_attention.py runs it, on graphs with a hub receiver
wider than MAX_PALLAS_WIDTH (grl_tpu's XLA bucket) and with zero-degree
receivers. float32 on both sides, summation order only: 1e-5. The CUDA
kernel is held to the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from grl_tpu.models import layers as jax_layers
from grl_tpu.ops import kernels as jax_kernels
from grl_tpu.ops.pallas import sparse_attention as jax_attention
from grl_torch import models
from grl_torch.models import layers
from grl_torch.ops import kernels, sparse
from grl_torch.ops import sparse_attention as attention


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite spreads files over worker processes on shared cores: one
    intra-op thread per worker keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def interpret_mode():
    prev = jax_attention.INTERPRET
    jax_attention.INTERPRET = True
    yield
    jax_attention.INTERPRET = prev


def random_problem(seed=0, N=64, E=400, K=8, F=32, hub=False):
    """Receivers N-3..N-1 have no edge; with ``hub``, receiver 0 has more
    than MAX_PALLAS_WIDTH edges."""
    rng = np.random.RandomState(seed)
    senders = rng.randint(0, N, E).astype(np.int32)
    receivers = rng.randint(0, N - 3, E).astype(np.int32)
    if hub:
        receivers[: jax_attention.MAX_PALLAS_WIDTH + 20] = 0
    f, g, h = (rng.randn(N, d).astype(np.float32) for d in (K, K, F))
    return senders, receivers, f, g, h, N


@pytest.mark.parametrize("hub", [False, True])
def test_attend_and_its_gradients_match_grl_tpu(hub):
    senders, receivers, f, g, h, N = random_problem(seed=2, hub=hub)
    ours = attention.SparseAttentionKernel(senders, receivers, N, device="cpu")
    theirs = jax_attention.SparseAttentionKernel(senders, receivers, num_nodes=N)
    w = np.random.RandomState(3).randn(N, h.shape[1]).astype(np.float32)

    args = [torch.from_numpy(a).requires_grad_() for a in (f, g, h)]
    out = ours.attend(*args)
    (out * torch.from_numpy(w)).sum().backward()
    expected, vjp = jax.vjp(theirs.attend, *map(jnp.asarray, (f, g, h)))
    grads = vjp(jnp.asarray(w))

    assert out.shape == (N, h.shape[1]) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(expected), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out.detach().numpy()[N - 3:], 0.0)
    for arg, grad, name in zip(args, grads, "fgh"):
        np.testing.assert_allclose(arg.grad.numpy(), np.asarray(grad), rtol=1e-5, atol=1e-5,
                                   err_msg=f"d{name}")


def test_bf16_attend_is_computed_in_f32_and_cast_once():
    """bfloat16 inputs: both sides compute in float32 from the same bf16
    values and cast the result once, so they agree within one bf16 rounding
    (2^-8 relative) of each other."""
    senders, receivers, f, g, h, N = random_problem(seed=4, hub=True)
    ours = attention.SparseAttentionKernel(senders, receivers, N, device="cpu")
    theirs = jax_attention.SparseAttentionKernel(senders, receivers, num_nodes=N)
    out = ours.attend(*[torch.from_numpy(a).to(torch.bfloat16) for a in (f, g, h)])
    expected = theirs.attend(*[jnp.asarray(a, jnp.bfloat16) for a in (f, g, h)])
    assert out.dtype == torch.bfloat16 and expected.dtype == jnp.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(expected, np.float32),
                               rtol=2**-7, atol=1e-6)


def test_duplicate_edges_are_separate_softmax_entries():
    senders = np.array([1, 1, 2], np.int32)
    receivers = np.array([0, 0, 0], np.int32)
    f, g, h = (np.random.RandomState(1).randn(3, 4).astype(np.float32) for _ in range(3))
    ours = attention.SparseAttentionKernel(senders, receivers, 3, device="cpu")
    theirs = jax_attention.SparseAttentionKernel(senders, receivers, num_nodes=3)
    np.testing.assert_allclose(
        ours.attend(*map(torch.from_numpy, (f, g, h))).numpy(),
        np.asarray(theirs.attend(*map(jnp.asarray, (f, g, h)))), rtol=1e-5, atol=1e-6,
    )


def test_plan_is_receiver_major_and_stable():
    senders, receivers, *_ , N = random_problem(seed=5, hub=True)
    plan = attention.SparseAttentionKernel(senders, receivers, N, device="cpu").plan
    order = np.argsort(receivers, kind="stable")
    np.testing.assert_array_equal(plan.senders.numpy(), senders[order])
    np.testing.assert_array_equal(plan.receivers.numpy(), receivers[order])
    np.testing.assert_array_equal(np.diff(plan.rowptr.numpy()), np.bincount(receivers, minlength=N))
    with pytest.raises(ValueError, match="num_nodes"):
        attention.SparseAttentionKernel(senders, receivers, N, device="cpu").attend(
            *[torch.zeros(N - 1, 8)] * 2, torch.zeros(N - 1, 32))


def layer_graphs(seed=5, N=96):
    """grl_tpu's SBM graph with and without the planned attention kernel,
    in both packages."""
    from grl_tpu.data.large_graph import sbm_relational_graph, to_relational_graph

    data = sbm_relational_graph(num_nodes=N, num_classes=4, num_relations=2, avg_degree=6,
                                feature_dim=16, seed=seed)
    jgraph, feats = to_relational_graph(data, edge_bucket=len(data.senders) + 10)
    graph = sparse.graph_from_numpy(*(np.asarray(getattr(jgraph, k)) for k in
                                      ("senders", "receivers", "relations", "weights", "mask")),
                                    N, 2)
    return (graph, kernels.attach_kernel(graph, impl="xla", attention=True),
            jgraph, jax_kernels.attach_kernel(jgraph, impl="xla", attention=True), feats)


@pytest.mark.parametrize("fused", [False, True])
def test_sparse_node_self_atten_matches_grl_tpu(fused):
    """The layer through K4 (fused) and through the segment path, forward
    and the gradient of a squared loss in V, against grl_tpu's layer on
    the same weights. float32 on both sides (1e-5; the gradient through
    the squared loss 1e-4)."""
    graph, fused_graph, jgraph, jfused, feats = layer_graphs()
    assert fused_graph.atten_kernel is not None and fused_graph.kernel is None
    jax_layer = jax_layers.SparseNodeSelfAtten(16)
    variables = jax_layer.init(jax.random.PRNGKey(0), jnp.asarray(feats), jgraph)
    layer = layers.SparseNodeSelfAtten(16)
    layer.load_state_dict(models.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    ours_graph, their_graph = (fused_graph, jfused) if fused else (graph, jgraph)

    V = torch.from_numpy(feats).requires_grad_()
    out = layer(V, ours_graph)
    (out**2).sum().backward()
    expected = jax_layer.apply(variables, jnp.asarray(feats), their_graph)
    grad = jax.grad(lambda v: jnp.sum(jax_layer.apply(variables, v, their_graph) ** 2))(jnp.asarray(feats))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(expected), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(V.grad.numpy(), np.asarray(grad), rtol=1e-4, atol=1e-4)
    # Without a graph the layer is the dense NodeSelfAtten.
    dense = torch.from_numpy(feats[None, :40])
    with torch.no_grad():
        assert torch.equal(layer(dense), layers.NodeSelfAtten.forward(layer, dense))


def test_wrapper_refuses_other_devices():
    senders, receivers, f, g, h, N = random_problem()
    plan = attention.SparseAttentionKernel(senders, receivers, N, device="cpu").plan
    meta = [torch.zeros(N, d, device="meta") for d in (8, 8, 32)]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        attention.attend_forward(*meta, plan)
