"""``scan_steps = K``: chunks of K train steps, grl_torch against grl_tpu.

On the CPU a chunk runs its K steps eagerly (on the card it is one replay
of a captured CUDA graph; tests/test_torch_cuda.py holds a replay to the
same steps run eagerly). These tests hold the schedule and the arithmetic:

* ``KVProcedure`` at K = 2 and 3 against grl_tpu's ``_train_epoch_scanned``
  on pages that fall into two buckets, so that both the grouping by shape
  and the drain of the leftovers happen: the same weights, float32,
  dropout and DropEdge off; the logged step order, the losses, the step
  count, the checkpoints' steps, and the parameters after 2 epochs within
  1e-5 of their scale;
* ``FullGraphProcedure`` with DropEdge 0.3 and dropout on: chunks of 3
  steps give the bits of single steps (one generator draws every seed and
  mask, in the same order), and each step's K5 masks differ from the
  last step's.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest

import jax
import torch

from grl_tpu import models as jax_models
from grl_tpu.data.synthetic import synthetic_page
from grl_tpu.trainer.procedures import KVProcedure as JaxKVProcedure
from grl_torch import GNNLearningWarper, models
from grl_torch.ops import csr_spmm, hashing
from grl_torch.trainer.procedures import KVProcedure


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite spreads files over worker processes on shared cores: one
    intra-op thread per worker keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# Page sizes (rows, noise lines -> 2 * rows + noise boxes) of the 14
# training pages, in file order; batches of 2 in that order (no shuffle),
# padded at quantum 32: a "small" batch has N = 32, one with a 38-box page
# N = 64. Batch buckets: S S B S B S S.
SMALL, BIG = (6, 4), (16, 6)
TRAIN_SIZES = [SMALL] * 4 + [BIG, SMALL] + [SMALL] * 2 + [SMALL, BIG] + [SMALL] * 4
VAL_SIZES = [SMALL, BIG]


def write_pages(root, sizes, seed0):
    os.makedirs(root)
    chars = set("0()-.,")
    for i, (rows, noise) in enumerate(sizes):
        page = synthetic_page(seed0 + i, rows, noise)
        for box in page:
            chars.update(box["text"].lower())
        with open(os.path.join(root, f"page_{i:04d}.json"), "w") as handle:
            json.dump(page, handle)
    return chars


@pytest.fixture(scope="module")
def pages(tmp_path_factory):
    from grl_torch.data.synthetic import DEFAULT_CLASSES

    root = tmp_path_factory.mktemp("scan_pages")
    chars = write_pages(str(root / "train"), TRAIN_SIZES, 100) | write_pages(str(root / "val"), VAL_SIZES, 900)
    classes_path, charset_path = str(root / "classes.json"), str(root / "charset.json")
    with open(classes_path, "w") as handle:
        json.dump({"classes": list(DEFAULT_CLASSES)}, handle)
    with open(charset_path, "w") as handle:
        json.dump({"charset": sorted(chars)}, handle)
    return {"train": str(root / "train"), "val": str(root / "val"), "classes": classes_path,
            "charset": charset_path, "input_dim": len(chars) + 4, "output_dim": 2 * len(DEFAULT_CLASSES) + 1}


def kv_config(pages, out_dir, K):
    def split(kind):
        return {
            "data_path": [pages[kind]], "class_path": pages["classes"], "charset_path": pages["charset"],
            "key_types": ["key", "value"], "batch_size": 2, "shuffle": False, "drop_last": False,
            "data_collate": {"BucketPadding": {"quantum": 32, "only_selected_items": True}},
            "data_process": {
                "TextlineEncoding": {"is_normalized_text": True},
                "HeuristicGraphBuilder": {"num_edges": 6, "edge_type": "normal_binary"},
                "NodeLabeling": {},
            },
        }

    return {
        "experiment_name": "scan", "seed": 0, "is_train": True, "output_dir": str(out_dir),
        "num_epochs": 2, "max_grad_norm": 1.0, "save_interval": 2, "scan_steps": K,
        "model": {"type": "GraphCNNDropEdge", "args": {
            "input_dim": pages["input_dim"], "output_dim": pages["output_dim"], "num_edges": 6,
            "net_size": 32, "dropout_rate": 0.0, "edge_dropout_rate": 0.0, "kernel_impl": "xla"}},
        "data_config": {
            "dataset": {"type": "CassiaDataset", "args": {"node_label_padding_value": -100}},
            "training": split("train"), "validation": split("val"),
        },
        "procedure": {"type": "KVProcedure", "args": {}},
        "loss": {"type": "CrossEntropyLoss", "args": {}},
        "optimizer": {"type": "BuiltinOptimizer", "args": {"type_optimizer": "Adam", "lr": 1e-3}},
        "lr_scheduler": {"type": "DecayLearningRate", "args": {"lr": 1e-3, "factor": 0.5, "num_epochs": 10}},
        "logging": {"use_tensorboard": False},
    }


def record(proc):
    """Wraps ``proc``'s step log and checkpointer: (global step, loss) of
    every logged step, and the step (or epoch) of every checkpoint."""
    steps, saves = [], []
    log = proc._log_train_step

    def logged(scores, metrics, gstep):
        steps.append((int(gstep), float(scores["loss"])))
        return log(scores, metrics, gstep)

    save = proc.checkpointer.save_checkpoint

    def saved(state, path, meta=None, **kwargs):
        meta = meta or {}
        saves.append(("step", int(meta["global_step"])) if "global_step" in meta else ("epoch", meta["epoch"]))
        return save(state, path, meta=meta, **kwargs)

    proc._log_train_step = logged
    proc.checkpointer.save_checkpoint = saved
    return steps, saves


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("K", [2, 3])
def test_kv_procedure_scan_steps_matches_grl_tpu(pages, tmp_path, K):
    config = kv_config(pages, tmp_path / "jax", K)
    jax_proc = JaxKVProcedure(jax_models.create_model("GraphCNNDropEdge", **config["model"]["args"]), config)
    jax_proc._ensure_initialized(next(iter(jax_proc.train_loader)))
    model = models.create_model("GraphCNNDropEdge", **config["model"]["args"], device="cpu")
    variables = {"params": numpy_tree(jax_proc.state.params), "constants": numpy_tree(jax_proc.state.constants)}
    model.load_state_dict(models.state_dict_from_flax(variables))
    port = KVProcedure(model, kv_config(pages, tmp_path / "port", K), device="cpu")

    jax_steps, jax_saves = record(jax_proc)
    port_steps, port_saves = record(port)
    jax_proc()
    port()

    # Two epochs of batches S S B S B S S: grouped by bucket, leftovers
    # drained in buffer order.
    order = {2: [0, 1, 2, 4, 3, 5, 6], 3: [0, 1, 3, 2, 4, 5, 6]}[K]
    assert [s for s, _ in jax_steps] == order + [7 + s for s in order]
    assert [s for s, _ in port_steps] == [s for s, _ in jax_steps]
    np.testing.assert_allclose([v for _, v in port_steps], [v for _, v in jax_steps], rtol=1e-5)
    assert port.state.step == int(jax_proc.state.step) == jax_proc._applied_step == 14
    assert port_saves == jax_saves and len([s for s in port_saves if s[0] == "step"]) >= 4, port_saves
    expected = models.state_dict_from_flax({"params": numpy_tree(jax_proc.state.params)})
    got = port.model.state_dict()
    scale = max(float(v.abs().max()) for v in expected.values())
    for name, value in expected.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=0, atol=1e-5 * scale, err_msg=name)


def full_graph_config(tmp_path, scan_steps):
    """tests/test_torch_full_graph.py's SBM run at 512 nodes and 7 steps, on
    K5 and K4, with DropEdge 0.3 and dropout 0.5."""
    return {
        "experiment_name": "sbm", "seed": 0, "is_train": True, "output_dir": str(tmp_path),
        "checkpoint_path": None, "num_epochs": 7, "scan_steps": scan_steps, "max_grad_norm": 5.0,
        "model": {"type": "GraphCNNDropEdge", "args": {
            "input_dim": 32, "output_dim": 5, "num_edges": 3, "net_size": 32, "kernel_impl": "pallas_csr",
            "use_attention": True, "attention_impl": "sparse", "edge_dropout_rate": 0.3,
            "dropout_rate": 0.5}},
        "data_config": {"large_graph": {"type": "sbm", "args": {
            "num_nodes": 512, "num_classes": 5, "num_relations": 3, "avg_degree": 8,
            "feature_dim": 32, "noise": 2.0, "seed": 0}}},
        "procedure": {"type": "FullGraphProcedure", "args": {}},
        "optimizer": {"type": "BuiltinOptimizer", "args": {"type_optimizer": "Adam", "lr": 0.01}},
        "logging": {"use_tensorboard": False, "experiment_tracking": False},
    }


def full_graph_run(tmp_path, scan_steps, seeds):
    """A 7-step full-graph run; ``seeds`` collects the seed and layout of
    every K5 forward that hashes (the train steps': evals run at rate 0)."""
    warper = GNNLearningWarper(config=full_graph_config(tmp_path, scan_steps), device="cpu")
    launch = csr_spmm.csr_accumulate

    def recorded(X, layout, seed=0, rate=0.0):
        if layout.direction == "forward" and rate > 0:
            seeds.append((int(seed), layout))
        return launch(X, layout, seed, rate)

    csr_spmm.csr_accumulate = recorded
    try:
        warper.train()
    finally:
        csr_spmm.csr_accumulate = launch
    trainer = warper.trainer
    return trainer, [float(loss) for loss in trainer.losses]


def test_full_graph_chunks_equal_single_steps_bit_for_bit(tmp_path):
    single_seeds, chunk_seeds = [], []
    single, single_losses = full_graph_run(tmp_path / "k1", 1, single_seeds)
    chunked, chunk_losses = full_graph_run(tmp_path / "k3", 3, chunk_seeds)
    assert single.state.step == chunked.state.step == 7
    assert len(single_losses) == len(chunk_losses) == 7
    assert single_losses == chunk_losses
    for (name, a), b in zip(single.model.state_dict().items(), chunked.model.state_dict().values()):
        assert torch.equal(a, b), name
    # Three K5 forwards a train step, one a conv, each with a seed of its own.
    train_seeds = [s for s, _ in single_seeds]
    assert len(train_seeds) == 3 * 7
    assert [s for s, _ in chunk_seeds] == [s for s, _ in single_seeds]
    assert len(set(train_seeds)) == len(train_seeds)
    layout = single_seeds[0][1]
    masks = [hashing.keep_bits(layout.gids, seed, 0.3) for seed in train_seeds[::3]]
    for before, after in zip(masks, masks[1:]):
        assert not torch.equal(before, after)
        assert abs(float(after.float().mean()) - 0.7) < 0.05
