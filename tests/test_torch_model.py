"""The flagship GraphCNNDropEdge and its layers: grl_torch against grl_tpu.

Both packages get the same flax variables (made by grl_tpu's init and
carried across by ``state_dict_from_flax``) and the same numpy-seeded
inputs, and are compared in eval mode. The JAX side pins float32 matmuls
(tests/conftest.py), and its Pallas kernel runs in interpret mode.
"""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from grl_tpu import models as jax_models
from grl_tpu.models import layers as jax_layers
from grl_tpu.ops.pallas import relagg as jax_relagg
from grl_torch import models
from grl_torch.models import layers


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite spreads files over worker processes on shared cores: one
    intra-op thread per worker keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


B, N, L, F_IN, NET, OUT = 2, 128, 6, 64, 32, 7


@pytest.fixture(autouse=True)
def interpret_mode():
    jax_relagg.INTERPRET = True
    with pltpu.force_tpu_interpret_mode():
        yield
    jax_relagg.INTERPRET = False


def inputs(seed=0, n=N, density=0.05):
    rng = np.random.RandomState(seed)
    V = rng.rand(B, n, F_IN).astype(np.float32)
    A = (rng.rand(B, n, L, n) < density).astype(np.float32)
    return V, A


def numpy_tree(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def flagship_pair(kernel_impl="xla", compute_dtype=None, n=N, seed=0):
    """(jax model, variables, torch model) sharing one set of weights."""
    kwargs = dict(input_dim=F_IN, output_dim=OUT, num_edges=L, net_size=NET,
                  kernel_impl=kernel_impl, compute_dtype=compute_dtype)
    jax_model = jax_models.create_model("GraphCNNDropEdge", **kwargs)
    V, A = inputs(n=n)
    variables = jax_models.init_model(jax_model, jax.random.PRNGKey(seed), (jnp.asarray(V), jnp.asarray(A)))
    model = models.create_model("GraphCNNDropEdge", **kwargs, device="cpu")
    model.load_state_dict(models.state_dict_from_flax(numpy_tree(variables)), strict=True)
    return jax_model, variables, model.eval()


def run_both(jax_model, variables, model, V, A, **kwargs):
    expected = np.asarray(jax_model.apply(variables, (jnp.asarray(V), jnp.asarray(A)), train=False, **kwargs))
    with torch.no_grad():
        out = model((torch.from_numpy(V), torch.from_numpy(A)), **kwargs).numpy()
    return out, expected


@pytest.mark.parametrize("kernel_impl", ["xla", "pallas"])
def test_flagship_logits_f32(kernel_impl):
    """Float32 eval logits. Both sides compute in float32 and differ only
    in summation order, relative ~1e-6 of the logits' scale: 1e-4."""
    jax_model, variables, model = flagship_pair(kernel_impl)
    V, A = inputs(seed=1)
    out, expected = run_both(jax_model, variables, model, V, A)
    assert out.shape == (B, N, OUT) and out.dtype == np.float32
    np.testing.assert_allclose(out, expected, rtol=1e-4, atol=1e-4 * np.abs(expected).max())


@pytest.mark.parametrize("kernel_impl", ["xla", "pallas"])
def test_flagship_logits_bf16(kernel_impl):
    """bfloat16 compute_dtype: activations, adjacency and weights are cast
    to bf16 at the same points on both sides, and both accumulate matmuls
    in float32. The two libraries may sum in another order, so a matmul's
    bf16 output can differ by one ulp (2**-8 relative); the logits are held
    to 1% of their scale and the argmax must agree on 99% of the nodes."""
    jax_model, variables, model = flagship_pair(kernel_impl, "bfloat16")
    V, A = inputs(seed=1)
    out, expected = run_both(jax_model, variables, model, V, A)
    assert out.dtype == np.float32
    scale = np.abs(expected).max()
    np.testing.assert_allclose(out, expected, rtol=0, atol=1e-2 * scale)
    assert (out.argmax(-1) == expected.argmax(-1)).mean() >= 0.99


def test_flagship_head_rows():
    """head_rows: the RanPAC head and classifier on the first rows of each group."""
    jax_model, variables, model = flagship_pair()
    V, A = inputs(seed=2)
    out, expected = run_both(jax_model, variables, model, V, A, head_rows=(B * 4, N // 4, 5))
    assert out.shape == (B * 4 * 5, OUT)
    np.testing.assert_allclose(out, expected, rtol=1e-4, atol=1e-4 * np.abs(expected).max())


def test_flagship_ragged_bucket_kernel_path():
    """N=64 (a serving bucket the TPU kernel refuses): the port's kernel
    path equals grl_tpu's XLA path on the same weights."""
    jax_model, variables, _ = flagship_pair("xla", n=64)
    model = models.create_model("GraphCNNDropEdge", input_dim=F_IN, output_dim=OUT, num_edges=L,
                                net_size=NET, kernel_impl="pallas", device="cpu")
    model.load_state_dict(models.state_dict_from_flax(numpy_tree(variables)))
    V, A = inputs(seed=3, n=64)
    out, expected = run_both(jax_model, variables, model.eval(), V, A)
    np.testing.assert_allclose(out, expected, rtol=1e-4, atol=1e-4 * np.abs(expected).max())


def test_state_dict_layout():
    """Dense kernels transpose into weights, h_weights stays whole in the
    JAX layout, and the RanPAC kernel is a buffer, never a parameter."""
    _, variables, model = flagship_pair()
    params = variables["params"]
    state = model.state_dict()
    np.testing.assert_array_equal(
        state["trunk.emb1.linear.weight"].numpy(), np.asarray(params["trunk"]["emb1"]["linear"]["kernel"]).T
    )
    np.testing.assert_array_equal(state["trunk.gcn3.h_weights"].numpy(), np.asarray(params["trunk"]["gcn3"]["h_weights"]))
    assert state["trunk.gcn3.h_weights"].shape == ((L + 1) * 2 * NET, NET)
    np.testing.assert_array_equal(state["w_rand.kernel"].numpy(), np.asarray(variables["constants"]["w_rand"]["kernel"]))
    names = {name for name, _ in model.named_parameters()}
    assert "w_rand.kernel" not in names and "w_rand.kernel" in dict(model.named_buffers())
    assert len(state) == len(jax.tree_util.tree_leaves(variables))


def test_converter_rejects_batch_stats_and_unknown_collections():
    """batch_stats (BatchNorm's running statistics) carry across as leaves
    of their own path, an empty collection adds nothing; an unknown
    collection is refused."""
    _, variables, _ = flagship_pair()
    tree = dict(numpy_tree(variables))
    assert set(models.state_dict_from_flax({**tree, "batch_stats": {}})) == set(models.state_dict_from_flax(tree))
    state = models.state_dict_from_flax({**tree, "batch_stats": {"bn": {"mean": np.arange(3.0, dtype=np.float32)}}})
    np.testing.assert_array_equal(state["bn.mean"].numpy(), np.arange(3.0, dtype=np.float32))
    with pytest.raises(KeyError):
        models.state_dict_from_flax({**tree, "cache": {}})


def test_init_distributions():
    """Parameters drawn from a torch.Generator follow flax's init laws."""
    gen = torch.Generator().manual_seed(0)
    model = models.create_model("GraphCNNDropEdge", input_dim=512, output_dim=OUT, num_edges=L,
                                net_size=256, device="cpu", generator=gen)
    emb1 = model.trunk.emb1.linear.weight.detach()  # truncated lecun normal, fan_in 512
    assert float(emb1.abs().max()) <= 2 * (1 / 512) ** 0.5 / 0.8796256610342398 + 1e-6
    assert abs(float(emb1.std()) - (1 / 512) ** 0.5) < 0.02 * (1 / 512) ** 0.5
    assert float(model.trunk.emb1.linear.bias.detach().abs().max()) == 0.0
    h = model.trunk.gcn1.h_weights.detach()  # xavier normal over ((L+1)F, C)
    assert abs(float(h.std()) - (2 / (7 * 256 + 256)) ** 0.5) < 0.02 * (2 / (7 * 256 + 256)) ** 0.5
    bias = model.trunk.gcn1.bias.detach()  # 1e-4 + 5e-5 N(0, 1)
    assert abs(float(bias.mean()) - 1e-4) < 2e-5 and abs(float(bias.std()) - 5e-5) < 2e-5
    assert abs(float(model.w_rand.kernel.std()) - 1.0) < 0.02
    # Same seed, same weights; another seed, other weights.
    again = models.create_model("GraphCNNDropEdge", input_dim=512, output_dim=OUT, num_edges=L, net_size=256,
                                device="cpu", generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.trunk.gcn1.h_weights.detach(), h)
    other = models.create_model("GraphCNNDropEdge", input_dim=512, output_dim=OUT, num_edges=L, net_size=256,
                                device="cpu", generator=torch.Generator().manual_seed(1))
    assert not torch.equal(other.trunk.gcn1.h_weights.detach(), h)


def test_entry_points_need_a_device():
    """No device argument and no GPU: model construction raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible, so the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        models.create_model("GraphCNNDropEdge", input_dim=8, output_dim=3, num_edges=L, net_size=16)


def test_sparse_adjacency_is_refused():
    _, _, model = flagship_pair()
    V, A = inputs()
    with pytest.raises(NotImplementedError, match="LocalShardGraph, not Tensor"):
        model((torch.from_numpy(V), torch.from_numpy(A).to_sparse()))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------
def layer_pair(jax_layer, torch_layer, *args, rngs=None):
    variables = jax_layer.init(rngs or {"params": jax.random.PRNGKey(0)}, *[jnp.asarray(a) for a in args])
    torch_layer.load_state_dict(models.state_dict_from_flax(numpy_tree(variables)), strict=True)
    expected = np.asarray(jax_layer.apply(variables, *[jnp.asarray(a) for a in args]))
    with torch.no_grad():
        out = torch_layer(*[torch.from_numpy(a) for a in args]).numpy()
    return out, expected


def test_graph_conv_dense_branch():
    V, A = inputs(seed=4)
    V = V[..., :16]
    out, expected = layer_pair(jax_layers.GraphConv(24, L), layers.GraphConv(16, 24, L), V, A)
    np.testing.assert_allclose(out, expected, rtol=1e-5, atol=1e-5)


def test_graph_conv_precomputed_branch():
    """The kernel branch: (self_term, neigh (B,N,L,F)) meets w_neigh's rows
    relation-major, as in grl_tpu."""
    V, A = inputs(seed=5)
    V = V[..., :16]
    conv = layers.GraphConv(16, 24, L)
    out, expected = layer_pair(jax_layers.GraphConv(24, L), conv, V, A)
    tV, tA = torch.from_numpy(V), torch.from_numpy(A)
    neigh = torch.matmul(tA.reshape(B, N * L, N), tV).reshape(B, N, L, 16)
    with torch.no_grad():
        pre = conv(tV, precomputed_neigh=(tV, neigh)).numpy()
    np.testing.assert_allclose(pre, expected, rtol=1e-5, atol=1e-5)


def test_node_self_atten():
    V = np.random.RandomState(6).randn(B, 40, 32).astype(np.float32)
    out, expected = layer_pair(jax_layers.NodeSelfAtten(32), layers.NodeSelfAtten(32), V)
    np.testing.assert_allclose(out, expected, rtol=1e-5, atol=1e-5)


def test_ranpac():
    x = np.random.RandomState(7).randn(B, 40, 16).astype(np.float32)
    rngs = {"params": jax.random.PRNGKey(0), "constants": jax.random.PRNGKey(1)}
    out, expected = layer_pair(jax_layers.RanPAC(80), layers.RanPAC(16, 80), x, rngs=rngs)
    np.testing.assert_allclose(out, expected, rtol=1e-5, atol=1e-4)


def test_linear_relu_and_edge_dropout():
    x = np.random.RandomState(8).randn(B, 40, 16).astype(np.float32)
    out, expected = layer_pair(jax_layers.LinearReLU(12), layers.LinearReLU(16, 12), x)
    np.testing.assert_allclose(out, expected, rtol=1e-5, atol=1e-5)
    A = torch.ones(1, 4, L, 4)
    A_out, scale = layers.EdgeDropout(0.3)(A, deterministic=True)
    assert A_out is A and scale is None
    # The random branch is drop_edge with the generator of rngs.device:
    # survivors 1/keep, a (B, N) self scale, and the same draw per seed.
    rngs = lambda: layers.Rngs.from_seed(5, "cpu")  # noqa: E731
    A_out, scale = layers.EdgeDropout(0.3)(A, deterministic=False, rngs=rngs())
    assert set(torch.unique(A_out).tolist()) <= {0.0, float(torch.tensor(1 / 0.7))}
    assert scale.shape == (1, 4)
    again, _ = layers.EdgeDropout(0.3)(A, deterministic=False, rngs=rngs())
    assert torch.equal(A_out, again)
    with pytest.raises(ValueError, match="rngs"):
        layers.EdgeDropout(0.3)(A, deterministic=False)
