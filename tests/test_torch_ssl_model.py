"""SSLGCN and DGI of grl_torch against grl_tpu's, on the CPU in float32.

Both packages get the same flax variables (carried across by
``state_dict_from_flax``, the merged DGI tree too) and the same batch of
the self-supervised data chain (equal in both packages:
``tests/test_torch_ssl_data.py``). Every task branch's output, DGI's
scores, the summed loss of every SSL criterion, each parameter's gradient
and the parameters after one and two Adam steps agree within 1e-5 of their
scale (gradients and parameters against the largest of all of them): both
sides compute in float32 and differ in summation order only. Dropout is
off (rate 0), so both forwards are deterministic.
"""
from __future__ import annotations

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from grl_tpu.models import DGI as JaxDGI
from grl_tpu.models import SSLGCN as JaxSSLGCN
from grl_tpu.models.ssl_gcn import init_dgi_variables
from grl_tpu.trainer.procedures.ssl_pretrain_procedure import SSL_CRITERIONS as JAX_CRITERIONS
from grl_torch import models
from grl_torch.data.dataloader import BaseDataLoader
from grl_torch.trainer.procedures.ssl_pretrain_procedure import SSL_CRITERIONS
from test_torch_ssl_data import files, jax_native_builder, ssl_split  # noqa: F401 (fixtures)

NET, C, L, LR = 32, 15, 6, 1e-3
# Adam's eps. Some gradient entries are summation noise around an exact
# zero: softmax is invariant to the attention key projection's bias wherever
# its ReLU passes, so trunk.self_atten.g's bias gradient is ~1e-7 with
# either sign. At eps 1e-8 Adam moves such an entry by about lr * sign(g),
# so the two packages would land 2 lr apart on it; at 1e-3 it moves by
# lr * g / eps, continuous in g, and the step's arithmetic is compared.
EPS = 1e-3
TASKS = ["node_property", "edge_mask", "pairwise_distance", "pairwise_similarity", "graph_edit_distance", "dgi"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def batch(files):
    """The first batch of the SSL chain (4 pages), float16/64 as float32."""
    split = ssl_split(files)
    maker = BaseDataLoader({"seed": 0})
    np.random.seed(0)
    raw = next(iter(maker._get_dataloader(maker._load_dataset("CassiaDataset", split), split)))
    out = {}
    for key, value in raw.items():
        value = np.asarray(value)
        out[key] = value.astype(np.float32) if value.dtype in (np.float16, np.float64) else value
    return out


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair(batch):
    """grl_tpu's DGI over SSLGCN (dropout 0) initialised by
    ``init_dgi_variables``, and the port's DGI holding the same tree."""
    input_dim = batch["textline_encoding"].shape[-1]
    args = dict(input_dim=input_dim, output_dim=C, num_edges=L, net_size=NET, dropout_rate=0.0)
    jax_dgi = JaxDGI(encoder=JaxSSLGCN(**args), output_dim=NET // 2)
    V, A = jnp.asarray(batch["textline_encoding"]), jnp.asarray(batch["adjacency_matrix"])
    variables = numpy_tree(init_dgi_variables(jax_dgi, jax.random.PRNGKey(0), V, A, emb_dim=NET // 2))
    encoder = models.create_model("SSLGCN", **args, device="cpu")
    dgi = models.DGI(encoder, NET // 2, device="cpu")
    dgi.load_state_dict(models.state_dict_from_flax(variables), strict=True)
    return jax_dgi, variables, dgi


def tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items() if isinstance(v, np.ndarray) and v.dtype != object}


def task_inputs(task, data):
    """The inputs and keyword arguments of ``task``'s forward, and its target."""
    inputs = (data["textline_encoding"], data["adjacency_matrix"])
    if task in (None, "graph_classification"):
        return inputs, {}, None
    if task == "node_property":
        return inputs, {}, data["node_property"]
    if task in ("edge_mask", "pairwise_distance", "pairwise_similarity"):
        return inputs, {"edges": data[f"{task}_indices"]}, data[f"{task}_targets"]
    if task == "graph_edit_distance":
        return inputs + (data["aug_textline_encoding"], data["aug_adjacency_matrix"]), {}, data[task]
    return inputs + (data["negative_textline_encoding"], data["negative_adjacency_matrix"]), {}, None


def assert_close(got, expected, what=""):
    expected = np.asarray(expected, np.float32)
    scale = max(float(np.abs(expected).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), expected, rtol=0, atol=1e-5 * scale, err_msg=what)


@pytest.mark.parametrize("task", [None, "node_property", "edge_mask", "pairwise_distance", "pairwise_similarity",
                                  "graph_edit_distance", "graph_classification", "dgi"])
def test_sslgcn_branches_match_grl_tpu(pair, batch, task):
    jax_dgi, variables, dgi = pair
    encoder_vars = {"params": variables["params"]["encoder"], "constants": variables["constants"]["encoder"]}
    data = tensors(batch)
    inputs, kwargs, _ = task_inputs(task, data)
    kwargs = dict(kwargs, task=task)
    expected = jax_dgi.encoder.apply(encoder_vars, tuple(jnp.asarray(x.numpy()) for x in inputs), train=False,
                                     **{k: (jnp.asarray(v.numpy()) if k == "edges" else v) for k, v in kwargs.items()})
    dgi.eval()
    with torch.no_grad():
        got = dgi.encoder(inputs, **kwargs)
    if task == "dgi":
        for g, e in zip(got, expected):
            assert_close(g.numpy(), e, "dgi")
        scores = dgi.forward_contrastive(*got)
        jax_scores = jax_dgi.apply({"params": variables["params"]}, *expected, method=jax_dgi.forward_contrastive)
        assert scores.shape == (data["node_mask"].shape[0], 2 * data["node_mask"].shape[1])
        assert_close(scores.detach().numpy(), jax_scores, "forward_contrastive")
    else:
        assert tuple(got.shape) == tuple(expected.shape)
        assert_close(got.numpy(), expected, str(task))


def test_dgi_tree_carries_across(pair, batch):
    """The merged DGI tree: encoder.* with the nested constants
    (encoder.w_rand.kernel) and discriminator.bilinear in its (d, d)
    layout; DGI's own forward is the encoder's node classification."""
    jax_dgi, variables, dgi = pair
    state = models.state_dict_from_flax(variables)
    assert set(state) == set(dgi.state_dict())
    assert "encoder.w_rand.kernel" in state and "discriminator.bilinear" in state
    np.testing.assert_array_equal(state["discriminator.bilinear"].numpy(),
                                  variables["params"]["discriminator"]["bilinear"])
    V, A = batch["textline_encoding"], batch["adjacency_matrix"]
    expected = jax_dgi.apply(variables, jnp.asarray(V), jnp.asarray(A))
    dgi.eval()
    with torch.no_grad():
        assert_close(dgi(torch.from_numpy(V), torch.from_numpy(A)).numpy(), expected)


def jax_summed_loss(jax_dgi, constants, data):
    """Every SSL criterion's loss summed, grl_tpu's step's loss_fn
    (ssl_pretrain_procedure.py:120-177) with dropout off."""
    def loss_fn(params):
        variables = {"params": params["encoder"], "constants": constants["encoder"]}
        total = 0.0
        for task in TASKS:
            inputs, kwargs, target = task_inputs(task, data)
            out = jax_dgi.encoder.apply(variables, inputs, train=True, task=task, **kwargs)
            if task == "dgi":
                scores = jax_dgi.apply({"params": params}, *out, method=jax_dgi.forward_contrastive)
                mask = data["node_mask"] > 0
                target = jnp.concatenate([jnp.where(mask, 1.0, -100.0), jnp.where(mask, 0.0, -100.0)], axis=1)
                total += JAX_CRITERIONS[task](scores, target)
            else:
                target = target.astype(jnp.int32 if task == "pairwise_distance" else jnp.float32)
                total += JAX_CRITERIONS[task](out, target)
        return total

    return loss_fn


def port_summed_loss(dgi, data):
    total = 0.0
    for task in TASKS:
        inputs, kwargs, target = task_inputs(task, data)
        out = dgi.encoder(inputs, task=task, **kwargs)
        if task == "dgi":
            scores = dgi.forward_contrastive(*out)
            mask = data["node_mask"] > 0
            target = torch.cat([torch.where(mask, 1.0, -100.0), torch.where(mask, 0.0, -100.0)], dim=1)
            total = total + SSL_CRITERIONS[task](scores, target)
        else:
            target = target.long() if task == "pairwise_distance" else target.float()
            total = total + SSL_CRITERIONS[task](out, target)
    return total


def test_summed_loss_gradients_and_adam_steps_match(pair, batch):
    jax_dgi, variables, dgi = pair
    data = tensors(batch)
    jax_data = {k: jnp.asarray(v.numpy()) for k, v in data.items()}
    loss_fn = jax.jit(jax.value_and_grad(jax_summed_loss(jax_dgi, variables["constants"], jax_data)))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = optax.adam(LR, eps=EPS)
    opt_state = tx.init(params)
    optimizer = torch.optim.Adam(list(dgi.parameters()), lr=LR, eps=EPS)
    dgi.train()
    for step in range(2):
        loss, grads = loss_fn(params)
        optimizer.zero_grad()
        port_loss = port_summed_loss(dgi, data)
        port_loss.backward()
        np.testing.assert_allclose(float(port_loss.detach()), float(loss), rtol=1e-5, err_msg=f"step {step}")
        if step == 0:
            expected_grads = models.state_dict_from_flax({"params": numpy_tree(grads)})
            # The loss reaches neither the classifier nor the graph
            # classification head: no gradient here, zeros in jax.
            assert {name for name, p in dgi.named_parameters() if p.grad is None} == {
                name for name, g in expected_grads.items() if not g.abs().max()}
            got_grads = {name: torch.zeros_like(p) if p.grad is None else p.grad
                         for name, p in dgi.named_parameters()}
            assert set(got_grads) == set(expected_grads)
            scale = max(float(g.abs().max()) for g in expected_grads.values())
            for name, grad in expected_grads.items():
                np.testing.assert_allclose(got_grads[name].numpy(), grad.numpy(), rtol=0, atol=1e-5 * scale,
                                           err_msg=f"grad {name}")
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        optimizer.step()
        expected = models.state_dict_from_flax({"params": numpy_tree(params)})
        got = {name: p.detach() for name, p in dgi.named_parameters()}
        scale = max(float(v.abs().max()) for v in expected.values())
        for name, value in expected.items():
            np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=0, atol=1e-5 * scale,
                                       err_msg=f"step {step + 1}: {name}")
