"""The dense zoo's layers in grl_torch against grl_tpu's, on the CPU in float32.

Each layer gets the flax variables of its grl_tpu counterpart, carried
across by ``state_dict_from_flax`` (``batch_stats`` included), and the
same numpy inputs (``tests/test_model_zoo.py``'s small shapes: B 2, N 21,
L 6, F_in 48). Outputs, BatchNorm's running statistics and gradients agree
within 1e-5 of their scale: both sides compute in float32 and differ in
summation order only. Dropout is at rate 0 where a layer runs in train
mode, so both forwards are deterministic. KNN neighbours are compared as
sets, since ``torch.topk`` promises no order among ties.
"""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from grl_tpu.models import cosine_linear as jax_cos
from grl_tpu.models import dgcnn as jax_dgcnn
from grl_tpu.models import gatv2 as jax_gat
from grl_tpu.models import layers as jax_layers
from grl_torch import models
from grl_torch.models import cosine_linear, dgcnn, gatv2, layers

B, N, L, FIN = 2, 21, 6, 48


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rand(*shape, seed=0, loc=0.0):
    return (np.random.RandomState(seed).randn(*shape) + loc).astype(np.float32)


def adjacency(seed=1, density=0.1):
    return (np.random.RandomState(seed).rand(B, N, L, N) < density).astype(np.float32)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_close(got, expected, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    expected = np.asarray(expected, np.float32)
    assert got.shape == expected.shape, (what, got.shape, expected.shape)
    scale = max(float(np.abs(expected).max()), 1e-30)
    np.testing.assert_allclose(got, expected, rtol=0, atol=1e-5 * scale, err_msg=what)


def carried(module, variables):
    """``module`` holding the flax ``variables`` (every name matched)."""
    module.load_state_dict(models.state_dict_from_flax(numpy_tree(variables)), strict=True)
    return module


def t(array):
    return torch.from_numpy(np.asarray(array))


def assert_same_stats(module, batch_stats, what):
    expected = models.state_dict_from_flax({"batch_stats": numpy_tree(batch_stats)})
    got = dict(module.named_buffers())
    assert set(expected) <= set(got), what
    for name, value in expected.items():
        assert_close(got[name], value.numpy(), f"{what}: {name}")


# ---------------------------------------------------------------------------
# BatchNorm, GCNBlock, EmbeddingBlock
# ---------------------------------------------------------------------------
def test_batchnorm_train_stats_and_eval_match_grl_tpu():
    """Train output with the batch's biased variance; mean / var after one
    and two train forwards (momentum 0.9, the biased variance, from 0 and
    1); eval output from those statistics."""
    x1, x2 = rand(B, N, 16, seed=2, loc=3.0), rand(B, N, 16, seed=3, loc=-1.0)
    jbn = jax_layers.BatchNorm()
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x1), train=False)
    params = {"params": jax.tree_util.tree_map(lambda a: a + 0.5, variables["params"])}
    bn = carried(layers.BatchNorm(16), {**params, "batch_stats": variables["batch_stats"]})
    stats = variables["batch_stats"]
    assert set(dict(bn.named_buffers())) == {"bn.mean", "bn.var"}
    bn.train()
    for k, x in enumerate((x1, x2)):
        expected, mutated = jbn.apply({**params, "batch_stats": stats}, jnp.asarray(x), train=True,
                                      mutable=["batch_stats"])
        stats = mutated["batch_stats"]
        assert_close(bn(t(x)), expected, f"train output {k + 1}")
        assert_same_stats(bn, stats, f"after {k + 1} train forwards")
    # The biased variance: the unbiased one would put var off by N/(N-1).
    var = np.asarray(stats["bn"]["var"])
    biased = 0.9 * (0.9 * 1 + 0.1 * x1.reshape(-1, 16).var(0)) + 0.1 * x2.reshape(-1, 16).var(0)
    np.testing.assert_allclose(var, biased, rtol=1e-5)
    bn.eval()
    before = [b.clone() for b in bn.buffers()]
    assert_close(bn(t(x2)), jbn.apply({**params, "batch_stats": stats}, jnp.asarray(x2), train=False), "eval")
    assert all(torch.equal(a, b) for a, b in zip(before, bn.buffers())), "eval moved the statistics"


def test_batchnorm_buffers_update_in_place():
    """The running statistics are updated in place: the tensors a captured
    graph, eval and the checkpoint read are the ones the update writes."""
    bn = layers.BatchNorm(4).train()
    mean, var = bn.bn.mean, bn.bn.var
    bn(torch.randn(2, 5, 4, generator=torch.Generator().manual_seed(0)))
    assert bn.bn.mean is mean and bn.bn.var is var
    assert bn.state_dict()["bn.mean"].data_ptr() == mean.data_ptr()
    assert not torch.equal(mean, torch.zeros(4)) and not torch.equal(var, torch.ones(4))


def test_batchnorm_mask_branch_matches_grl_tpu():
    """Train mode with a node mask: the valid nodes' statistics and
    mask_scale / mask_bias, bn's running statistics untouched; eval with a
    mask is bn."""
    x = rand(B, N, 8, seed=4, loc=2.0)
    mask = np.random.RandomState(5).rand(B, N) < 0.7
    jbn = jax_layers.BatchNorm()
    key = jax.random.PRNGKey(0)
    plain = jbn.init(key, jnp.asarray(x), train=False)
    masked = jbn.init(key, jnp.asarray(x), train=True, mask=jnp.asarray(mask))
    params = {**plain["params"], **jax.tree_util.tree_map(lambda a: a * 1.5 + 0.25, masked["params"])}
    variables = {"params": params, "batch_stats": plain["batch_stats"]}
    bn = carried(layers.BatchNorm(8, masked=True), variables).train()
    expected, mutated = jbn.apply(variables, jnp.asarray(x), train=True, mask=jnp.asarray(mask),
                                  mutable=["batch_stats"])
    assert_close(bn(t(x), mask=t(mask)), expected, "masked train")
    assert_same_stats(bn, mutated["batch_stats"], "masked train")
    assert torch.equal(bn.bn.mean, torch.zeros(8)) and torch.equal(bn.bn.var, torch.ones(8))
    bn.eval()
    assert_close(bn(t(x), mask=t(mask)), jbn.apply(variables, jnp.asarray(x), train=False, mask=jnp.asarray(mask)),
                 "masked eval")
    with pytest.raises(ValueError, match="masked=True"):
        layers.BatchNorm(8).train()(t(x), mask=t(mask))


@pytest.mark.parametrize("block", ["GCNBlock", "EmbeddingBlock"])
def test_blocks_match_grl_tpu(block):
    """Train output and statistics after two forwards, the gradient of the
    parameters, and eval output."""
    V, A = rand(B, N, FIN, seed=6), adjacency()
    self_scale = (np.random.RandomState(7).rand(B, N) < 0.8).astype(np.float32) / 0.8
    if block == "GCNBlock":
        jmod = jax_layers.GCNBlock(24, L)
        args, kwargs = (jnp.asarray(V), jnp.asarray(A)), {"self_scale": jnp.asarray(self_scale)}
        port = layers.GCNBlock(FIN, 24, L)
        targs, tkwargs = (t(V), t(A)), {"self_scale": t(self_scale)}
    else:
        jmod = jax_layers.EmbeddingBlock(24)
        args, kwargs, targs, tkwargs = (jnp.asarray(V),), {}, (t(V),), {}
        port = layers.EmbeddingBlock(FIN, 24)
    variables = numpy_tree(jmod.init(jax.random.PRNGKey(0), *args, train=False, **kwargs))
    carried(port, variables).train()
    stats = variables["batch_stats"]
    cot = rand(B, N, 24, seed=8)
    for k in range(2):
        def loss(params, stats=stats):
            out, mutated = jmod.apply({"params": params, "batch_stats": stats}, *args, train=True,
                                      mutable=["batch_stats"], **kwargs)
            return jnp.sum(out * cot), (out, mutated["batch_stats"])

        (_, (expected, stats)), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
        port.zero_grad()
        out = port(*targs, **tkwargs)
        (out * t(cot)).sum().backward()
        assert_close(out, expected, f"{block} train {k + 1}")
        assert_same_stats(port, stats, f"{block} after {k + 1}")
        expected_grads = models.state_dict_from_flax({"params": numpy_tree(grads)})
        scale = max(float(g.abs().max()) for g in expected_grads.values())
        for name, p in port.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), expected_grads[name].numpy(), rtol=0, atol=1e-5 * scale,
                                       err_msg=name)
    port.eval()
    with torch.no_grad():
        assert_close(port(*targs, **tkwargs),
                     jmod.apply({"params": variables["params"], "batch_stats": stats}, *args, train=False, **kwargs),
                     f"{block} eval")


# ---------------------------------------------------------------------------
# Cosine heads
# ---------------------------------------------------------------------------
def head_grads(jmod, variables, port, x, cot, **kwargs):
    """Output and parameter gradients of ``sum(out * cot)`` in both packages."""
    def loss(params):
        out = jmod.apply({"params": params}, jnp.asarray(x), **kwargs)
        return jnp.sum(out * cot), out

    (_, expected), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    port.zero_grad()
    out = port(t(x), **kwargs)
    (out * t(cot)).sum().backward()
    return out, expected, models.state_dict_from_flax({"params": numpy_tree(grads)})


COSINE_CASES = [
    ("CosineLinear", 1, 3), ("CosineLinear", 2, 2), ("CosineLinear", 1, 2),
    ("SplitCosineLinear", 1, 3), ("SplitCosineLinear", 2, 2),
    ("GroupCosineLinear", 1, 3), ("SplitGroupCosineLinear", 1, 3),
]


@pytest.mark.parametrize("name, num_head, ndim", COSINE_CASES)
def test_cosine_heads_match_grl_tpu(name, num_head, ndim):
    """Normalised over axis 1 (the node axis of (B, N, F) inputs), as
    grl_tpu; num_head > 1 cuts axis 1 of a 2-D input into heads."""
    x = rand(*((B, N, 32) if ndim == 3 else (7, 32)), seed=9)
    split = name.startswith("Split")
    jmod = getattr(jax_cos, name)(*((5, 4) if split else (5,)))
    port = getattr(cosine_linear, name)(32, *((5, 4) if split else (5,)))
    kwargs = {"num_head": num_head} if "Group" not in name else {}
    variables = numpy_tree(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), **kwargs))
    # sigma away from 1, so that a head that drops it fails.
    variables = {"params": jax.tree_util.tree_map(lambda a: a * 1.3, variables["params"])}
    carried(port, variables)
    cot = rand(*x.shape[:-1], 9 if split else 5, seed=10)
    out, expected, grads = head_grads(jmod, variables, port, x, cot, **kwargs)
    assert_close(out, expected, name)
    for pname, p in port.named_parameters():
        assert_close(p.grad, grads[pname].numpy(), f"{name} grad {pname}")


def test_cosine_head_gradient_at_a_zero_column():
    """A feature that is 0 on every node (axis 1): the port's gradient is
    finite and equals F.normalize's; grl_tpu's sqrt(sum(x * x)) gives NaN
    there (a deliberate divergence), and the outputs agree."""
    x = rand(B, N, 32, seed=23)
    x[:, :, 5] = 0.0
    jmod, port = jax_cos.CosineLinear(5), cosine_linear.CosineLinear(32, 5)
    variables = numpy_tree(jmod.init(jax.random.PRNGKey(9), jnp.asarray(x)))
    carried(port, variables)
    jax_grad = jax.grad(lambda v: jnp.sum(jmod.apply(variables, v)))(jnp.asarray(x))
    assert np.isnan(np.asarray(jax_grad)).any()
    tx = t(x).requires_grad_()
    out = port(tx)
    out.sum().backward()
    assert torch.isfinite(tx.grad).all()
    assert_close(out, jmod.apply(variables, jnp.asarray(x)), "output")
    tref = t(x).requires_grad_()
    (torch.nn.functional.normalize(tref, dim=1) @ torch.nn.functional.normalize(port.weight, dim=1).T
     * port.sigma).sum().backward()
    assert_close(tx.grad, tref.grad.numpy(), "F.normalize's gradient")


BIFEAT_FLAGS = [
    {}, {"mask_feat2": True}, {"eval_mode": True}, {"mask_feat2": True, "eval_mode": True}, {"mean_feat2": True},
]


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("flags", BIFEAT_FLAGS, ids=lambda f: "-".join(f) or "plain")
def test_bifeat_heads_match_grl_tpu(split, flags):
    """Every CosineLinearBiFeat flag, in the head and in its split form;
    ``mask_feat2`` stops the second slice's gradient, as stop_gradient."""
    x = rand(7, 20, seed=11)
    kwargs = dict(flags)
    if kwargs.pop("mean_feat2", False):
        kwargs.update(mask_feat2=True, mean_feat2=rand(7, 8, seed=12))
    jmod = jax_cos.SplitCosineLinearBiFeat(12, 5, 4) if split else jax_cos.CosineLinearBiFeat(12, 5)
    port = (cosine_linear.SplitCosineLinearBiFeat(20, 12, 5, 4) if split
            else cosine_linear.CosineLinearBiFeat(20, 12, 5))
    variables = numpy_tree(jmod.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    carried(port, variables)
    jax_kwargs = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kwargs.items()}
    port_kwargs = {k: (t(v) if isinstance(v, np.ndarray) else v) for k, v in kwargs.items()}

    def loss(params):
        out = jmod.apply({"params": params}, jnp.asarray(x), **jax_kwargs)
        return jnp.sum(out * cot), out

    cot = rand(7, 9 if split else 5, seed=13)
    (_, expected), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    grads = models.state_dict_from_flax({"params": numpy_tree(grads)})
    out = port(t(x), **port_kwargs)
    (out * t(cot)).sum().backward()
    assert_close(out, expected, "output")
    for name, p in port.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        if not np.abs(grads[name].numpy()).max():
            assert not got.abs().max(), name  # a stopped or unused slice: zero in both
        else:
            assert_close(got, grads[name].numpy(), f"grad {name}")
    if kwargs.get("mask_feat2") or kwargs.get("eval_mode"):
        weight2 = [p for n, p in port.named_parameters() if n.endswith("weight2")]
        assert all(p.grad is None or not p.grad.abs().max() for p in weight2)


# ---------------------------------------------------------------------------
# GAT layers
# ---------------------------------------------------------------------------
def jax_layer(cls_name, *args, **kwargs):
    return getattr(jax_gat, cls_name)(*args, **kwargs)


def port_layer(cls_name, in_features, *args, **kwargs):
    return getattr(gatv2, cls_name)(in_features, *args, **kwargs)


@pytest.fixture(scope="module")
def gat_inputs():
    return rand(B, N, FIN, seed=14), adjacency(seed=15, density=0.15)


def eval_and_train(jmod, port, inputs, what, first_only_output=False):
    """Eval output, and train output at dropout 0, in both packages."""
    jin = tuple(jnp.asarray(x) for x in inputs)
    variables = numpy_tree(jmod.init(jax.random.PRNGKey(3), *jin, train=False))
    carried(port, variables)
    for train in (False, True):
        expected = jmod.apply(variables, *jin, train=train, rngs={"dropout": jax.random.PRNGKey(4)})
        port.train(train)
        with torch.no_grad():
            got = port(*(t(x) for x in inputs))
        if isinstance(expected, tuple):
            for k, (g, e) in enumerate(zip(got, expected)):
                assert_close(g, e, f"{what} train={train} output {k}")
        else:
            assert_close(got, expected, f"{what} train={train}")


# Layer widths: a V2 layer's relations are features // 16 wide, and its
# LayerNorm over 2 or 3 values (features 32 or 48) is ill-conditioned in
# float32: there both packages lie 1e-5 to 2.4e-5 of scale from the float64
# result. From 4 values (features 64) both are within 4e-7 of it.
WIDTHS = (64, 128)


@pytest.mark.parametrize("cls_name", ["GraphAttentionLayer", "GraphAttentionLayerV2"])
@pytest.mark.parametrize("features", WIDTHS + ("identity",))
def test_attention_layers_match_grl_tpu(gat_inputs, cls_name, features):
    """V1 (the interleaved pair tensor) and V2, with the residual map
    (features != F_in) and without it (a 64-wide input)."""
    V, A = gat_inputs
    if features == "identity":
        features, V = 64, rand(B, N, 64, seed=19)
    eval_and_train(jax_layer(cls_name, L, features, 0.0), port_layer(cls_name, V.shape[-1], L, features, 0.0),
                   (V, A), cls_name)


@pytest.mark.parametrize("cls_name", ["GraphAttentionLayer", "GraphAttentionLayerV2"])
def test_attention_layer_gradients_on_padded_rows(cls_name):
    """Padded (zero) rows with no edges: there the identity relation's
    output is 0 and its LayerNorm gives the bias, 0 at init, where flax's
    leaky ReLU passes the gradient whole (``F.leaky_relu`` would pass the
    slope). Every parameter's gradient agrees."""
    V, A = rand(B, N, FIN, seed=20), adjacency(seed=21, density=0.15)
    V[:, 15:], A[:, 15:], A[:, :, :, 15:] = 0.0, 0.0, 0.0
    jmod, port = jax_layer(cls_name, L, 64, 0.0), port_layer(cls_name, FIN, L, 64, 0.0)
    variables = numpy_tree(jmod.init(jax.random.PRNGKey(8), jnp.asarray(V), jnp.asarray(A)))
    carried(port, variables)
    cot = rand(B, N, 64, seed=22)
    grads = jax.grad(lambda p: jnp.sum(jmod.apply({"params": p}, jnp.asarray(V), jnp.asarray(A))[0] * cot))(
        variables["params"])
    grads = models.state_dict_from_flax({"params": numpy_tree(grads)})
    (port(t(V), t(A))[0] * t(cot)).sum().backward()
    for name, p in port.named_parameters():
        assert_close(p.grad, grads[name].numpy(), f"{cls_name} grad {name}")


def test_rel_graph_attention_matches_grl_tpu(gat_inputs):
    V, A = gat_inputs
    eval_and_train(jax_gat.RelGraphAttention(8, L, attn_dropout=0.0),
                   gatv2.RelGraphAttention(FIN, 8, L, attn_dropout=0.0), (V, A), "RelGraphAttention")


@pytest.mark.parametrize("cls_name", ["GraphAttentionLayer", "GraphAttentionLayerV2"])
def test_make_dense_gat_matches_grl_tpu(gat_inputs, cls_name):
    """Two dense layers (FIN, then FIN + 64 wide) and the squeeze block."""
    jmod = jax_gat.MakeDenseGAT(64, L, 2, getattr(jax_gat, cls_name), 0.0)
    port = gatv2.MakeDenseGAT(FIN, 64, L, 2, getattr(gatv2, cls_name), 0.0)
    eval_and_train(jmod, port, gat_inputs, f"MakeDenseGAT {cls_name}")


@pytest.mark.parametrize("output_node", [1, 16])
def test_diff_pooling_matches_grl_tpu(gat_inputs, output_node):
    """One output node (ratio 1, reshaped to (-1, F_in)) and more (ratio
    16, the pooled A_out). At 2-15 output nodes grl_tpu's assignment layer
    has 0-wide relations, whose flax xavier init divides by zero, so more
    than one is held at 16 (relations 1 wide)."""
    V, A = gat_inputs
    out_feature = FIN if output_node == 1 else 64
    jmod = jax_gat.DiffPooling(out_feature, output_node, no_A=L, drop=0.0)
    port = gatv2.DiffPooling(FIN, out_feature, output_node, no_A=L, drop=0.0)
    eval_and_train(jmod, port, (V, A), f"DiffPooling {output_node}")


def test_tune_sequential_matches_grl_tpu(gat_inputs):
    jmod = jax_gat.TuneSequential(layers=(jax_gat.GraphAttentionLayer(L, 64, 0.0),
                                          jax_gat.GraphAttentionLayerV2(L, 64, 0.0)))
    port = gatv2.TuneSequential([gatv2.GraphAttentionLayer(FIN, L, 64, 0.0),
                                 gatv2.GraphAttentionLayerV2(64, L, 64, 0.0)])
    V, A = gat_inputs
    variables = numpy_tree(jmod.init(jax.random.PRNGKey(5), jnp.asarray(V), jnp.asarray(A)))
    carried(port, variables)
    port.eval()
    expected = jmod.apply(variables, jnp.asarray(V), jnp.asarray(A))
    with torch.no_grad():
        got = port(t(V), t(A))
    assert_close(got[0], expected[0], "TuneSequential")
    assert torch.equal(got[1], t(A))


def test_parameter_scale_and_norm_bn_carry_across(gat_inputs):
    """MakeParameterScale's scalar, and Norm(bn=True)'s BatchNorm named
    ``norm`` with its statistics."""
    jscale = jax_gat.MakeParameterScale()
    variables = numpy_tree(jscale.init(jax.random.PRNGKey(6)))
    scale = carried(gatv2.MakeParameterScale(), variables)
    assert_close(scale(), jscale.apply(variables), "MakeParameterScale")
    x = rand(B, N, 8, seed=16, loc=1.0)
    jnorm = jax_gat.Norm(bn=True)
    variables = numpy_tree(jnorm.init(jax.random.PRNGKey(7), jnp.asarray(x)))
    norm = carried(gatv2.Norm(8, bn=True), variables).train()
    expected, mutated = jnorm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    assert_close(norm(t(x)), expected, "Norm(bn=True)")
    assert_same_stats(norm, mutated["batch_stats"], "Norm(bn=True)")


# ---------------------------------------------------------------------------
# DGCNN's KNN
# ---------------------------------------------------------------------------
def test_knn_indices_match_grl_tpu_as_sets():
    x = rand(B, N, 12, seed=17)
    expected = np.asarray(jax_dgcnn.knn_indices(jnp.asarray(x), 5))
    got = dgcnn.knn_indices(t(x), 5).numpy()
    assert got.shape == expected.shape == (B, N, 5)
    for b in range(B):
        for i in range(N):
            assert set(got[b, i]) == set(expected[b, i]), (b, i)


@pytest.mark.parametrize("padded", [False, True])
def test_knn_edge_features_match_grl_tpu(padded):
    """[x_j - x_i, x_i] over min(k, V) neighbours. With zero (padded) rows
    the distances tie exactly; the neighbour rows gathered are compared as
    multisets, which no tie order changes."""
    x = rand(B, N, 12, seed=18)
    if padded:
        x[:, 15:] = 0.0
    for k in (5, N + 3):
        expected = np.asarray(jax_dgcnn.knn_edge_features(jnp.asarray(x), k))
        got = dgcnn.knn_edge_features(t(x), k).numpy()
        assert got.shape == expected.shape == (B, N, min(k, N), 24)
        for b in range(B):
            for i in range(N):
                ours = sorted(map(tuple, got[b, i]))
                theirs = sorted(map(tuple, expected[b, i]))
                np.testing.assert_allclose(np.array(ours), np.array(theirs), rtol=0, atol=1e-5 * np.abs(x).max())
