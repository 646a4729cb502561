"""The sparse KV path: SparseBucketPadding's COO batches through
KVProcedure, grl_torch against grl_tpu.

On tests/test_sparse_path.py's recipe (8 synthetic pages, batches of 8,
``SparseBucketPadding`` at quantum 64 and edge quantum 256, the flagship at
net_size 32 with ``kernel_impl: xla``): the collate's arrays equal
grl_tpu's bit for bit; ``_prepare_batch`` gives flat features and a
``RelationalGraph`` with ``batch_shape``; two Adam steps at dropout and
DropEdge 0, from grl_tpu's initial variables, within 1e-5 of the scale with
dense and with sparse attention; and chunks of steps equal one step a batch.
"""
from __future__ import annotations

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from grl_tpu.data.dataloader import BaseDataLoader as JaxBaseDataLoader
from grl_tpu.data.synthetic import synthetic_dataset_files
from grl_tpu.models import GraphCNNDropEdge as JaxGraphCNNDropEdge
from grl_tpu.trainer.procedures import KVProcedure as JaxKVProcedure
from grl_torch import models
from grl_torch.data.dataloader import BaseDataLoader
from grl_torch.ops.sparse import RelationalGraph
from grl_torch.trainer.procedures import KVProcedure

from tests.test_procedures import base_config, make_split

COLLATE = {"SparseBucketPadding": {"quantum": 64, "edge_quantum": 256, "only_selected_items": True}}
COO_KEYS = ("coo_senders", "coo_receivers", "coo_relations", "coo_weights", "coo_mask")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per worker: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("sparsekv")
    data_dir, classes_path, charset_path = synthetic_dataset_files(str(root), num_pages=8, seed=5)
    charset = json.load(open(charset_path))["charset"]
    return root, data_dir, classes_path, charset_path, len(charset) + 4


def split_of(synth, batch_size=8, shuffle=False):
    root, data_dir, classes_path, charset_path, _ = synth
    split = make_split(data_dir, classes_path, charset_path)
    split.update(batch_size=batch_size, shuffle=shuffle, data_collate=COLLATE)
    return split


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("batch_size, shuffle", [(8, False), (3, True)])
def test_sparse_bucket_padding_matches_grl_tpu(synth, batch_size, shuffle):
    """The loaders' batches, every key, bit for bit (dtype too): node
    bucket, edge bucket a multiple of 256, the dense adjacency dropped."""
    split = split_of(synth, batch_size, shuffle)
    loaders = []
    for factory in (BaseDataLoader, JaxBaseDataLoader):
        maker = factory({"seed": 2})
        loaders.append(maker._get_dataloader(maker._load_dataset("CassiaDataset", split), split))
    pairs = list(zip(*loaders))
    assert len(pairs) == len(loaders[1]) == -(-8 // batch_size)
    for a, b in pairs:
        assert sorted(a) == sorted(b) and "adjacency_matrix" not in a and set(COO_KEYS) <= set(a)
        for key in a:
            x, y = np.asarray(a[key]), np.asarray(b[key])
            assert x.dtype == y.dtype and x.shape == y.shape, key
            np.testing.assert_array_equal(x, y, err_msg=key)
        assert a["coo_senders"].shape[1] % 256 == 0 and a["coo_mask"].any(axis=1).all()


def procedures(synth, tmp_path, attention_impl, **extra):
    """grl_tpu's KVProcedure and the port's on the same split and recipe;
    the port's model starts from grl_tpu's variables."""
    root, *_, input_dim = synth
    args = dict(input_dim=input_dim, output_dim=15, num_edges=6, net_size=32, attention_impl=attention_impl,
                dropout_rate=0.0, edge_dropout_rate=0.0)
    split = split_of(synth)
    jax_cfg = base_config(tmp_path / "jax", split, "jax")
    port_cfg = {**base_config(tmp_path / "port", split, "port").to_dict(), **extra}
    for cfg in (jax_cfg, port_cfg):
        cfg["optimizer"]["args"]["lr"] = 0.01
    jax_proc = JaxKVProcedure(JaxGraphCNNDropEdge(**args), jax_cfg)
    batch = next(iter(jax_proc.train_loader))
    jax_proc._ensure_initialized(batch)
    model = models.create_model("GraphCNNDropEdge", **args, device="cpu")
    model.load_state_dict(models.state_dict_from_flax(
        numpy_tree({"params": jax_proc.state.params, "constants": jax_proc.state.constants})))
    return jax_proc, KVProcedure(model, port_cfg, device="cpu"), batch


def test_prepare_batch_gives_a_batched_relational_graph(synth, tmp_path):
    jax_proc, proc, batch = procedures(synth, tmp_path, "dense")
    V, A, labels = proc._prepare_batch(batch)
    jV, jA, jlabels = jax_proc._prepare_batch(batch)
    assert isinstance(A, RelationalGraph) and A.batch_shape == tuple(labels.shape) == tuple(jA.batch_shape)
    assert tuple(V.shape) == (labels.shape[0] * labels.shape[1], V.shape[1]) == tuple(jV.shape)
    assert A.senders.dtype == torch.int32 and A.weights.dtype == torch.float32 and A.mask.dtype == torch.bool
    for name in ("senders", "receivers", "relations", "weights", "mask"):
        np.testing.assert_array_equal(getattr(A, name).numpy(), np.asarray(getattr(jA, name)), err_msg=name)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    assert A.num_nodes == jA.num_nodes and A.num_relations == jA.num_relations == 6


@pytest.mark.parametrize("attention_impl", ["dense", "sparse"])
def test_two_steps_match_grl_tpu(synth, tmp_path, attention_impl):
    jax_proc, proc, batch = procedures(synth, tmp_path, attention_impl)
    proc._ensure_initialized()
    state = jax_proc.state
    V, A, labels = jax_proc._prepare_batch(batch)
    pV, pA, plabels = proc._prepare_batch(batch)
    lam = jnp.float32(1.0)
    for k in range(2):
        state, loss, cm = jax_proc._train_fn(state, V, A, labels, jax.random.PRNGKey(k), lam)
        port_loss, port_cm = proc._train_fn(pV, pA, plabels, proc.rngs, 1.0)
        np.testing.assert_allclose(float(port_loss), float(loss), rtol=1e-5)
        np.testing.assert_array_equal(port_cm.numpy(), np.asarray(cm))
        expected = models.state_dict_from_flax({"params": numpy_tree(state.params)})
        got = proc.model.state_dict()
        scale = max(float(v.abs().max()) for v in expected.values())
        for name, value in expected.items():
            np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=0, atol=1e-5 * scale,
                                       err_msg=f"step {k + 1}: {name}")
    # The eval step on the COO batch: the same loss and confusion counts.
    jloss, jcm, _ = jax_proc._eval_fn(state, V, A, labels, lam)
    ploss, pcm, _ = proc._eval_fn(pV, pA, plabels, 1.0)
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)
    np.testing.assert_array_equal(pcm.numpy(), np.asarray(jcm))


def test_scanned_equals_stepwise_bit_for_bit(synth, tmp_path):
    """Batches of 2 (four of one edge bucket), dropout and DropEdge on,
    scan_steps 3: one chunk of three steps and one leftover step give the
    stepwise run's losses and parameters bit for bit."""
    root, *_, input_dim = synth
    args = dict(input_dim=input_dim, output_dim=15, num_edges=6, net_size=32, attention_impl="sparse")

    def run(name, scan_steps):
        split = split_of(synth, batch_size=2)
        cfg = {**base_config(tmp_path / name, split, name, epochs=1).to_dict(), "scan_steps": scan_steps}
        model = models.create_model("GraphCNNDropEdge", **args, device="cpu",
                                    generator=torch.Generator().manual_seed(0))
        proc = KVProcedure(model, cfg, device="cpu")
        losses = []
        log = proc._log_train_step
        proc._log_train_step = lambda scores, metrics, gstep: (losses.append((gstep, scores["loss"])),
                                                               log(scores, metrics, gstep))
        proc()
        return proc, losses

    (stepwise, a), (scanned, b) = run("stepwise", 1), run("scanned", 3)
    keys = {scanned.shape_key(*scanned._host_batch(batch)) for batch in scanned.train_loader}
    assert len(keys) == 1 and scanned._use_scan() and len(scanned._slots) == 1
    assert scanned.state.step == stepwise.state.step == 4 and a == b
    for (name, x), y in zip(stepwise.model.state_dict().items(), scanned.model.state_dict().values()):
        assert torch.equal(x, y), name
