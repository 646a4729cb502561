"""End-to-end serving: grl_torch's KVInference against grl_tpu's.

One set of flax variables is saved as an orbax checkpoint for grl_tpu's
warper (``kernel_impl: xla``: the TPU kernel cannot take the 64-quantum
buckets that KVInference pads to) and carried across, as numpy arrays
through ``state_dict_from_flax``, into a torch checkpoint for the port's
warper on ``device="cpu"``. Every box must get the same class, and a
confidence within 1e-4: both sides run in float32 and differ only in
summation order (~1e-6 on the softmax).
"""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grl_tpu.data.synthetic import synthetic_dataset_files, synthetic_page
from grl_tpu.models import create_model as jax_create_model
from grl_tpu.models import init_model
from grl_tpu.utils.checkpoint import CheckpointHandler as JaxCheckpointHandler
from grl_tpu.warper import GNNLearningWarper as JaxWarper
from grl_torch import GNNLearningWarper
from grl_torch.models import state_dict_from_flax
from grl_torch.utils.checkpoint import CheckpointHandler

jsonschema = pytest.importorskip("jsonschema")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite spreads files over worker processes on shared cores: one
    intra-op thread per worker keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SCHEMAS = os.path.join(os.path.dirname(__file__), "assets", "schemas")
MODEL_ARGS = {"output_dim": 15, "num_edges": 6, "net_size": 32}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Data files, and one set of weights in both checkpoint formats."""
    tmp = tmp_path_factory.mktemp("serving")
    data_dir, classes_path, charset_path = synthetic_dataset_files(str(tmp), num_pages=2, seed=5)
    with open(charset_path) as handle:
        input_dim = len(json.load(handle)["charset"]) + 4
    jax_model = jax_create_model("GraphCNNDropEdge", input_dim=input_dim, **MODEL_ARGS)
    example = (jnp.zeros((1, 64, input_dim)), jnp.zeros((1, 64, 6, 64)))
    variables = init_model(jax_model, jax.random.PRNGKey(3), example)
    jax_ckpt = JaxCheckpointHandler().save_checkpoint(dict(variables), str(tmp / "jax"))
    restored = JaxCheckpointHandler().restore_checkpoint(jax_ckpt)
    numpy_vars = jax.tree_util.tree_map(np.asarray, dict(restored))
    torch_ckpt = CheckpointHandler().save_checkpoint(
        {"model": state_dict_from_flax(numpy_vars)}, str(tmp / "torch"), meta={"source": "flax"}
    )
    return {
        "tmp": tmp, "classes": classes_path, "charset": charset_path, "input_dim": input_dim,
        "jax_model": jax_model, "jax_ckpt": jax_ckpt, "torch_ckpt": torch_ckpt,
    }


def config(served, checkpoint, kernel_impl="xla", post_processing=()):
    return {
        "experiment_name": f"serve-{kernel_impl}",
        "seed": 0,
        "is_train": False,
        "output_dir": str(served["tmp"] / "out"),
        "checkpoint_path": checkpoint,
        "model": {
            "type": "GraphCNNDropEdge",
            "args": {"input_dim": served["input_dim"], "kernel_impl": kernel_impl, **MODEL_ARGS},
        },
        "procedure": {"type": "KVInference", "args": {"batch_size": 2}},
        "inference_settings": {
            "datasets": {
                "type": "CassiaDataset",
                "args": {
                    "charset_path": served["charset"],
                    "class_path": served["classes"],
                    "key_types": ["key", "value"],
                    "data_process": {
                        "TextlineEncoding": {"is_normalized_text": True},
                        "HeuristicGraphBuilder": {"num_edges": 6, "edge_type": "normal_binary"},
                    },
                },
            },
            "post_processing": list(post_processing),
        },
    }


def port_warper(served, kernel_impl="xla", post_processing=()):
    cfg = config(served, served["torch_ckpt"], kernel_impl, post_processing)
    return GNNLearningWarper(config=cfg, device="cpu")


def jax_warper(served, post_processing=()):
    cfg = config(served, served["jax_ckpt"], "xla", post_processing)
    return JaxWarper(served["jax_model"], config=cfg)


def pages(sizes):
    """Cassia pages of (rows, noise) each: 2*rows+noise boxes."""
    return [
        [{"location": box["location"], "text": box["text"]} for box in synthetic_page(700 + i, rows, noise)]
        for i, (rows, noise) in enumerate(sizes)
    ]


def assert_same_predictions(ours, theirs):
    assert len(ours) == len(theirs)
    for page_a, page_b in zip(ours, theirs):
        assert len(page_a) == len(page_b)
        for a, b in zip(page_a, page_b):
            assert a["text"] == b["text"] and a["location"] == b["location"]
            assert (a["formal_key"], a["key_type"]) == (b["formal_key"], b["key_type"])
            assert abs(a["confidence"] - b["confidence"]) <= 1e-4


# Box counts 30, 90, 150, 18, 86: buckets 64, 128, 192 and 64, sorted into
# batches of two by node count as KVInference does.
SIZES = [(12, 6), (40, 10), (70, 10), (6, 6), (38, 10)]


@pytest.mark.parametrize("kernel_impl", ["xla", "pallas"])
def test_predictions_match_grl_tpu(served, kernel_impl):
    samples = pages(SIZES)
    ours = port_warper(served, kernel_impl).predict(samples)
    theirs = jax_warper(served).predict(samples)
    assert_same_predictions(ours, theirs)


def test_single_page_and_json_path_inputs(served, tmp_path):
    """A single page (a list of boxes) returns the annotated page itself;
    a path to a JSON page is read, as in grl_tpu."""
    warper = port_warper(served)
    [page] = pages([(9, 4)])
    single = warper.predict(page)
    assert isinstance(single, list) and isinstance(single[0], dict) and len(single) == len(page)
    path = tmp_path / "page.json"
    path.write_text(json.dumps(page))
    from_path = warper.predict(str(path))
    assert_same_predictions([single], [from_path])
    assert_same_predictions([single], [jax_warper(served).predict(page)])


def test_output_validates_against_schema(served):
    with open(os.path.join(SCHEMAS, "output_schema.json")) as handle:
        schema = json.load(handle)
    for page in port_warper(served).predict(pages([(12, 6), (30, 5)])):
        jsonschema.validate(page, schema)


def test_post_processing_matches(served):
    chain = [
        {"type": "ConfidenceThreshold", "args": {"threshold": 0.07}},
        {"type": "SingletonKeyFilter", "args": {"unique_keys": ["total_amount", "issue_date"]}},
    ]
    samples = pages([(12, 6), (20, 4)])
    ours = port_warper(served, post_processing=chain).predict(samples)
    theirs = jax_warper(served, post_processing=chain).predict(samples)
    assert_same_predictions(ours, theirs)


def test_checkpoint_round_trip(served):
    handler = CheckpointHandler()
    assert os.path.basename(served["torch_ckpt"]) == handler.LATEST
    assert handler.read_meta(served["torch_ckpt"]) == {"source": "flax"}
    state = handler.restore_checkpoint(served["torch_ckpt"])
    assert set(state) == {"model"} and "trunk.gcn1.h_weights" in state["model"]
    assert handler.make_checkpoint_name("model", 2, 30) == "model_epoch_2_minibatch_30"


def test_training_and_missing_checkpoint_raise(served):
    """A serving warper refuses train(), a training warper refuses
    predict(), and serving with no checkpoint raises."""
    cfg = config(served, served["torch_ckpt"])
    with pytest.raises(RuntimeError, match="is_train=False"):
        port_warper(served).train()
    split = {
        "data_path": [os.path.join(str(served["tmp"]), "pages")], "class_path": served["classes"],
        "charset_path": served["charset"], "key_types": ["key", "value"], "batch_size": 2,
        "data_process": {"TextlineEncoding": {}, "HeuristicGraphBuilder": {}, "NodeLabeling": {}},
    }
    training = {
        **cfg, "is_train": True, "procedure": {"type": "KVProcedure", "args": {}},
        "logging": {"use_tensorboard": False, "experiment_tracking": False},
        "data_config": {"dataset": {"type": "CassiaDataset", "args": {}}, "training": split, "validation": split},
    }
    trainer = GNNLearningWarper(config=training, device="cpu")
    assert trainer.inferencer is None and trainer.trainer is not None
    with pytest.raises(RuntimeError, match="is_train=True"):
        trainer.predict(pages([(3, 2)]))
    warper = GNNLearningWarper(config={**cfg, "checkpoint_path": None}, device="cpu")
    with pytest.raises(RuntimeError, match="checkpoint_path"):
        warper.predict(pages([(3, 2)]))
