"""The self-supervised procedures of grl_torch against grl_tpu's, on the CPU.

* SSL pretraining, the slice as a whole: two steps of every task (DGI
  included) in both packages from the same weights at dropout 0, on the
  same batches of the data chain; losses, step scores and parameters.
* The fine-tune merge from an SSLGCN and from a DGI checkpoint: the same
  loaded names and counts as ``grl_tpu``'s, the trunk equal to the
  checkpoint's, and a shape mismatch keeping the fresh init.
* Joint training's step count; graph classification end to end.
* The ``_use_scan`` guard: a ``KVProcedure`` subclass that overrides
  ``_run_train_batch`` runs step by step at ``scan_steps > 1``.

As in ``tests/test_torch_ssl_model.py``, Adam's eps is 1e-3 so that the
attention key bias, whose gradient is summation noise around zero, moves
by lr * g / eps in both packages rather than by lr * sign(g).
"""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from grl_tpu.data import processors as jax_processors
from grl_tpu.models import GraphCNNDropEdge as JaxGraphCNNDropEdge
from grl_tpu.models import SSLGCN as JaxSSLGCN
from grl_tpu.models.base import init_model
from grl_tpu.trainer.procedures import FinetuneKVProcedure as JaxFinetuneKVProcedure
from grl_tpu.trainer.procedures import GraphClassificationProcedure as JaxGraphClassificationProcedure
from grl_tpu.trainer.procedures import JointTrainingProcedure as JaxJointTrainingProcedure
from grl_tpu.trainer.procedures import KVProcedure as JaxKVProcedure
from grl_tpu.trainer.procedures import SSLPretrainProcedure as JaxSSLPretrainProcedure
from grl_tpu.trainer.procedures import merge_matching_leaves as jax_merge_matching_leaves
from grl_tpu.utils.checkpoint import CheckpointHandler as JaxCheckpointHandler
from grl_torch import models
from grl_torch.data import processors
from grl_torch.trainer.procedures import (
    FinetuneKVProcedure,
    GraphClassificationProcedure,
    JointTrainingProcedure,
    KVProcedure,
    SSLPretrainProcedure,
    merge_matching_leaves,
)
from grl_torch.utils.checkpoint import CheckpointHandler
from test_procedures import base_config, make_split
from test_torch_ssl_data import files, jax_native_builder, ssl_split  # noqa: F401 (fixtures)

NET, C, L, EPS = 32, 15, 6, 1e-3
TASKS = ["node_property", "edge_mask", "pairwise_distance", "pairwise_similarity", "graph_edit_distance", "dgi"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("ssl_procedures")


def config(root, split, name, epochs=1, **extra):
    cfg = base_config(root, split, name, epochs=epochs)
    cfg["optimizer"]["args"]["eps"] = EPS
    cfg["logging"]["experiment_tracking"] = False
    cfg.update(extra)
    return cfg


def input_dim(files):
    import json

    return len(json.load(open(files[2]))["charset"]) + 4


def model_args(files, **extra):
    return dict(input_dim=input_dim(files), output_dim=C, num_edges=L, net_size=NET, dropout_rate=0.0, **extra)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_state(variables):
    return models.state_dict_from_flax({"params": numpy_tree(variables["params"]),
                                        "constants": numpy_tree(variables.get("constants") or {})})


def assert_same_params(jax_params, module, what):
    expected = models.state_dict_from_flax({"params": numpy_tree(jax_params)})
    got = dict(module.named_parameters())
    assert set(got) == set(expected), what
    scale = max(float(v.abs().max()) for v in expected.values())
    for name, value in expected.items():
        np.testing.assert_allclose(got[name].detach().numpy(), value.numpy(), rtol=0, atol=1e-5 * scale,
                                   err_msg=f"{what}: {name}")


def same_batches(jax_proc, port_proc, seed=0):
    """One epoch of each procedure's training loader, after the same seed."""
    np.random.seed(seed)
    theirs = list(jax_proc.train_loader)
    np.random.seed(seed)
    ours = list(port_proc.train_loader)
    return theirs, ours


def assert_same_scores(ours, theirs, what):
    assert set(ours) == set(theirs), what
    np.testing.assert_allclose(ours["loss"], theirs["loss"], rtol=1e-5, err_msg=what)
    for key in theirs:
        if key != "loss":
            assert ours[key] == pytest.approx(theirs[key], abs=1e-12), f"{what}: {key}"


def test_ssl_pretraining_two_steps_match_grl_tpu(root, files):
    """Every task with DGI: the state is the DGI tree in both packages."""
    split = ssl_split(files)
    jax_proc = JaxSSLPretrainProcedure(JaxSSLGCN(**model_args(files)), config(root, split, "jax-ssl"), tasks=TASKS)
    port_proc = SSLPretrainProcedure(models.create_model("SSLGCN", **model_args(files), device="cpu"),
                                     config(root, split, "port-ssl"), tasks=TASKS, device="cpu")
    theirs, ours = same_batches(jax_proc, port_proc)
    assert len(theirs) == len(ours) == 2
    jax_proc._ensure_initialized(theirs[0])
    assert set(jax_proc.state.params) == {"encoder", "discriminator"}
    port_proc.dgi.load_state_dict(port_state({"params": jax_proc.state.params,
                                              "constants": jax_proc.state.constants}), strict=True)
    port_proc._ensure_initialized()
    assert port_proc.state.model is port_proc.dgi
    for step, (a, b) in enumerate(zip(ours, theirs)):
        assert_same_scores(port_proc._run_train_batch(a, 0), jax_proc._run_train_batch(b, 0), f"step {step}")
        assert_same_params(jax_proc.state.params, port_proc.dgi, f"after step {step + 1}")
    assert port_proc.state.step == int(jax_proc.state.step) == 2
    scores, cm = port_proc._run_val_batch(ours[0])
    jax_scores, jax_cm = jax_proc._run_val_batch(theirs[0])
    assert_same_scores(scores, jax_scores, "validation")
    np.testing.assert_array_equal(cm, jax_cm)


# Parameter tensors the flagship loads from each kind of SSL checkpoint of
# the same widths (chip_smoke.py holds its fine-tune leg to these).
def expected_loaded():
    import chip_smoke

    return chip_smoke.FINETUNE_LOADED


@pytest.fixture(scope="module")
def checkpoints(root, files):
    """An SSLGCN and a DGI checkpoint in each package's format, of the same
    weights: {kind: (grl_tpu path, port path, flax variables)}."""
    from grl_tpu.models import DGI as JaxDGI
    from grl_tpu.models.ssl_gcn import init_dgi_variables

    V = jnp.zeros((1, 8, input_dim(files)))
    A = jnp.zeros((1, 8, L, 8))
    encoder = JaxSSLGCN(**model_args(files))
    trees = {
        "SSLGCN": numpy_tree(init_model(encoder, jax.random.PRNGKey(3), (V, A))),
        "DGI": numpy_tree(init_dgi_variables(JaxDGI(encoder=encoder, output_dim=NET // 2), jax.random.PRNGKey(4),
                                             V, A, emb_dim=NET // 2)),
    }
    out = {}
    for kind, variables in trees.items():
        jax_path = JaxCheckpointHandler().save_checkpoint(dict(variables), str(root / f"jax-{kind}"))
        port_path = CheckpointHandler().save_checkpoint({"model": port_state(variables)}, str(root / f"port-{kind}"))
        out[kind] = (jax_path, port_path, variables)
    return out


def jax_loaded_names(target, source, collection):
    """The port's names of the leaves grl_tpu's merge takes from ``source``."""
    merged, count = jax_merge_matching_leaves(target, source)
    names = []
    for (path, leaf), (_, src) in zip(jax.tree_util.tree_leaves_with_path(merged),
                                      jax.tree_util.tree_leaves_with_path(target)):
        if leaf is not src:
            keys = [str(k.key) for k in path]
            if collection == "params" and keys[-1] == "kernel" and np.ndim(leaf) == 2:
                keys[-1] = "weight"
            names.append(".".join(keys))
    assert len(names) == count
    return sorted(names)


@pytest.mark.parametrize("kind, output_dim", [("SSLGCN", C), ("DGI", C), ("SSLGCN", 7)])
def test_finetune_merge_matches_grl_tpu(root, files, checkpoints, kind, output_dim):
    jax_path, port_path, variables = checkpoints[kind]
    split = make_split(*files)
    args = dict(model_args(files), output_dim=output_dim)
    name = f"ft-{kind}-{output_dim}"
    jax_proc = JaxFinetuneKVProcedure(
        JaxGraphCNNDropEdge(**args), config(root, split, f"jax-{name}", optimize_settings={"ssl_pretrain_path": jax_path}))
    fresh = JaxFinetuneKVProcedure(JaxGraphCNNDropEdge(**args), config(root, split, f"jax-fresh-{name}"))
    batch = next(iter(jax_proc.train_loader))
    jax_proc._ensure_initialized(batch)
    fresh._ensure_initialized(batch)
    source = JaxCheckpointHandler().restore_checkpoint(jax_path)
    jax_params = jax_loaded_names(numpy_tree(fresh.state.params), source["params"], "params")
    jax_buffers = jax_loaded_names(numpy_tree(fresh.state.constants), source["constants"], "constants")

    model = models.create_model("GraphCNNDropEdge", **args, device="cpu",
                                generator=torch.Generator().manual_seed(1))
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    port_proc = FinetuneKVProcedure(model, config(root, split, f"port-{name}",
                                                  optimize_settings={"ssl_pretrain_path": port_path}), device="cpu")
    port_proc._ensure_initialized()
    checkpoint = CheckpointHandler().restore_checkpoint(port_path)["model"]
    params = dict(model.named_parameters())
    port_params = sorted(k for k, v in merge_matching_leaves(params, checkpoint)[0].items() if v is not params[k])
    buffers = dict(model.named_buffers())
    port_buffers = sorted(k for k, v in merge_matching_leaves(buffers, checkpoint)[0].items() if v is not buffers[k])

    assert port_params == jax_params and port_buffers == jax_buffers
    assert port_proc.loaded == (len(jax_params), len(jax_buffers))
    if output_dim == C:
        assert port_proc.loaded[0] == expected_loaded()[kind]
    state = model.state_dict()
    for key, value in state.items():
        expected = checkpoint[key] if key in port_params + port_buffers else initial[key]
        np.testing.assert_array_equal(value.numpy(), expected.numpy(), err_msg=key)
    if kind == "SSLGCN":
        assert all(k in port_params for k in state if k.startswith("trunk."))
        np.testing.assert_array_equal(np.asarray(jax_proc.state.params["trunk"]["gcn1"]["h_weights"]),
                                      variables["params"]["trunk"]["gcn1"]["h_weights"])
    if output_dim != C:
        assert not any(k.startswith("classifier.") for k in port_params)
    # The optimizer and the model hold the same tensors after the merge.
    assert {id(p) for g in port_proc.state.optimizer.param_groups for p in g["params"]} == {
        id(p) for p in model.parameters()}


def test_joint_training_step_count(root, files):
    """One epoch: as many steps as the KV loader has batches, in both
    packages, the SSL loader wrapping around; and a step without SSL data."""
    split = make_split(*files)
    extra = {"data_config": {**base_config(root, split, "x")["data_config"],
                             "ssl_training": ssl_split(files), "ssl_validation": ssl_split(files)}}
    tasks = ["node_property", "edge_mask", "pairwise_distance"]
    jax_proc = JaxJointTrainingProcedure(JaxSSLGCN(**model_args(files)), config(root, split, "jax-joint", **extra),
                                         tasks=tasks)
    port_proc = JointTrainingProcedure(models.create_model("SSLGCN", **model_args(files), device="cpu"),
                                       config(root, split, "port-joint", **extra), tasks=tasks, device="cpu")
    for proc in (jax_proc, port_proc):
        assert np.isfinite(proc())
    assert port_proc.state.step == int(jax_proc.state.step) == len(port_proc.train_loader) == 2
    assert port_proc.global_step == 2 and port_proc.ssl_val_loader is not None
    alone = JointTrainingProcedure(models.create_model("SSLGCN", **model_args(files), device="cpu"),
                                   config(root, split, "port-joint-alone"), tasks=tasks, device="cpu")
    assert alone.ssl_train_loader is None and np.isfinite(alone())
    assert alone.state.step == 2


def graph_label(sample):
    """A graph label of 3 classes: the page's characters mod 3
    (tests/test_procedures.py's box count mod 3 is 0 on every page here)."""
    return sum(len(line["text"]) for line in sample["label"].values()) % 3


class SyntheticGraphLabel(processors.BaseDataProcess):
    def __call__(self, sample):
        sample["graph_label"] = graph_label(sample)
        return sample


class JaxSyntheticGraphLabel(jax_processors.BaseDataProcess):
    def __call__(self, sample):
        sample["graph_label"] = graph_label(sample)
        return sample


def test_graph_classification_matches_grl_tpu(root, files, monkeypatch):
    """Task mode on SSLGCN(n_graph_classes=3) with n_graph_classes from
    procedure.args: two steps and a validation batch from the same weights
    at dropout 0."""
    monkeypatch.setattr(processors, "SyntheticGraphLabel", SyntheticGraphLabel, raising=False)
    monkeypatch.setattr(jax_processors, "SyntheticGraphLabel", JaxSyntheticGraphLabel, raising=False)
    split = make_split(*files)
    split["shuffle"] = False
    split["data_process"]["SyntheticGraphLabel"] = {}
    split["data_collate"]["BucketPadding"]["only_selected_items"] = False
    procedure = {"type": "GraphClassificationProcedure", "args": {"n_graph_classes": 3}}
    args = model_args(files, n_graph_classes=3)
    jax_proc = JaxGraphClassificationProcedure(JaxSSLGCN(**args), config(root, split, "jax-gc", procedure=procedure),
                                               n_graph_classes=3)
    model = models.create_model("SSLGCN", **args, device="cpu")
    port_proc = GraphClassificationProcedure(model, config(root, split, "port-gc", procedure=procedure),
                                             n_graph_classes=3, device="cpu")
    assert port_proc.num_classes == jax_proc.num_classes == 3
    theirs, ours = same_batches(jax_proc, port_proc)
    labels = np.concatenate([b["graph_label"] for b in ours])
    assert len(set(labels.tolist())) > 1
    jax_proc._ensure_initialized(theirs[0])
    model.load_state_dict(port_state({"params": jax_proc.state.params, "constants": jax_proc.state.constants}))
    port_proc._ensure_initialized()
    for step, (a, b) in enumerate(zip(ours, theirs)):
        assert_same_scores(port_proc._run_train_batch(a, 0), jax_proc._run_train_batch(b, 0), f"step {step}")
        assert_same_params(jax_proc.state.params, model, f"after step {step + 1}")
    scores, cm = port_proc._run_val_batch(ours[1])
    jax_scores, jax_cm = jax_proc._run_val_batch(theirs[1])
    assert cm.shape == (3, 3) and cm.sum() == len(ours[1]["graph_label"])
    assert_same_scores(scores, jax_scores, "validation")
    np.testing.assert_array_equal(cm, jax_cm)
    assert np.isfinite(port_proc())


class OwnStep(KVProcedure):
    """A subclass with its own per-batch step (here the base one)."""

    def _run_train_batch(self, batch, epoch):
        return super()._run_train_batch(batch, epoch)


class JaxOwnStep(JaxKVProcedure):
    def _run_train_batch(self, batch, epoch):
        return super()._run_train_batch(batch, epoch)


def test_use_scan_guard(root, files, monkeypatch):
    """At scan_steps 4 only KVProcedure's own step is chunked, as in
    grl_tpu: a subclass overriding _run_train_batch, and the SSL procedure
    (whose chunks would drop every SSL loss), run one step a batch."""
    split = make_split(*files)
    cfg = config(root, split, "scan", scan_steps=4)
    flagship = dict(model_args(files), edge_dropout_rate=0.0)
    assert KVProcedure(models.create_model("GraphCNNDropEdge", **flagship, device="cpu"), cfg,
                       device="cpu")._use_scan()
    assert JaxKVProcedure(JaxGraphCNNDropEdge(**flagship), cfg)._use_scan()
    assert not JaxOwnStep(JaxGraphCNNDropEdge(**flagship), cfg)._use_scan()

    def no_chunks(self, epoch, metrics):
        raise AssertionError("chunked an overridden step")

    monkeypatch.setattr(KVProcedure, "_train_epoch_scanned", no_chunks)
    own = OwnStep(models.create_model("GraphCNNDropEdge", **flagship, device="cpu"), cfg, device="cpu")
    assert not own._use_scan() and np.isfinite(own())
    assert own.state.step == own.global_step == len(own.train_loader)

    ssl = SSLPretrainProcedure(models.create_model("SSLGCN", **model_args(files), device="cpu"),
                               config(root, ssl_split(files), "scan-ssl", scan_steps=4),
                               tasks=["node_property", "edge_mask"], device="cpu")
    calls = []
    ssl._ensure_initialized()
    step = ssl._ssl_fn
    ssl._ssl_fn = lambda data: calls.append(sorted(data)) or step(data)
    assert not ssl._use_scan() and np.isfinite(ssl())
    assert len(calls) == ssl.state.step == len(ssl.train_loader)
    assert all({"node_property", "edge_mask_indices", "edge_mask_targets"} <= set(keys) for keys in calls)
