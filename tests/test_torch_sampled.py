"""SampledGraphProcedure, grl_torch against grl_tpu.

Both procedures sample tests/test_neighbor_sampling.py's SBM (1024 nodes,
5 classes, 2 relations, so the tree's one-hot route runs) from
``RandomState(config.seed)``, so they see the same batches; the port's
model gets grl_tpu's initial variables through ``state_dict_from_flax``.
float32, dropout and DropEdge 0, a clip that binds: losses and parameters
after one and two Adam steps within 1e-5 of their scale, and the same
validation counts, on the tree and the COO routes, with the head slice on
and off. Chunks of ``scan_steps`` steps are eager on the CPU and must give
the stepwise run's bits; the learning case holds the port to a limit set
from grl_tpu's run of the same recipe.
"""
from __future__ import annotations

import numpy as np
import pytest

import jax
import torch

from grl_tpu import models as jax_models
from grl_tpu.config import ConfigDict as JaxConfigDict
from grl_tpu.data import large_graph as jax_large_graph
from grl_tpu.trainer.procedures import SampledGraphProcedure as JaxSampledGraphProcedure
from grl_torch import GNNLearningWarper, models
from grl_torch.data import large_graph
from grl_torch.trainer.procedures import SampledGraphProcedure

SBM = dict(num_nodes=1024, num_classes=5, num_relations=2, avg_degree=8, feature_dim=24, seed=11)
MODEL = dict(input_dim=24, output_dim=5, num_edges=2, net_size=32, use_attention=False)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per worker: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# Adam's eps in the step comparison, as in tests/test_torch_zoo_models.py:
# some weights of a tree's deeper relations get a gradient of rounding noise
# around 0, which Adam at eps 1e-8 moves by lr * sign(g) either way (one
# entry of gcn3 by 6.7e-6 at step 2); at 1e-3 by lr * g / eps.
EPS = 1e-3


def config(tmp_path, tree=True, head_slice=True, eps=EPS, **extra):
    return {
        "experiment_name": "sampled", "seed": 0, "output_dir": str(tmp_path), "num_epochs": 1,
        "max_grad_norm": 0.5,
        "sampler": {"fanouts": [3, 2], "batch_size": 32, "tree_aggregation": tree, "head_slice": head_slice},
        "optimizer": {"type": "BuiltinOptimizer", "args": {"type_optimizer": "Adam", "lr": 1e-3, "eps": eps}},
        "logging": {"use_tensorboard": False, "summary_dir_name": "s"}, **extra,
    }


@pytest.mark.parametrize("tree", [True, False], ids=["tree", "coo"])
@pytest.mark.parametrize("head_slice", [True, False], ids=["head", "full"])
def test_two_steps_match_grl_tpu(tmp_path, tree, head_slice):
    rates = dict(dropout_rate=0.0, edge_dropout_rate=0.0)
    jax_proc = JaxSampledGraphProcedure(jax_models.create_model("GraphCNNDropEdge", **MODEL, **rates),
                                        JaxConfigDict(config(tmp_path / "jax", tree, head_slice)),
                                        jax_large_graph.sbm_relational_graph(**SBM))
    model = models.create_model("GraphCNNDropEdge", **MODEL, **rates, device="cpu")
    proc = SampledGraphProcedure(model, config(tmp_path / "port", tree, head_slice),
                                 large_graph.sbm_relational_graph(**SBM), device="cpu")
    assert proc._head_slice == jax_proc._head_slice == head_slice
    batches = jax_proc.sampler.epoch_batches(jax_proc._np_rng, jax_proc.data.train_mask)
    ours = proc._batches(proc.data.train_mask)
    first = next(batches)
    jax_proc._ensure_initialized(first)
    state = jax_proc.state
    model.load_state_dict(models.state_dict_from_flax(
        numpy_tree({"params": state.params, "constants": state.constants})))
    rng = jax.random.PRNGKey(3)
    for k, batch in enumerate([first, next(batches)]):
        mine = next(ours)
        for name in ("nodes", "labels", "weights", "relations"):
            np.testing.assert_array_equal(getattr(mine, name), getattr(batch, name))
        nodes, graph, labels = jax_proc._place(batch)
        state, loss = jax_proc._train_fn(state, jax_proc._features_dev, nodes, graph, labels, rng)
        port_loss = float(proc.train_step(mine))
        np.testing.assert_allclose(port_loss, float(loss), rtol=1e-5)
        expected = models.state_dict_from_flax({"params": numpy_tree(state.params)})
        got = model.state_dict()
        scale = max(float(v.abs().max()) for v in expected.values())
        for name, value in expected.items():
            np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=0, atol=1e-5 * scale,
                                       err_msg=f"step {k + 1}: {name}")
    assert proc.state.step == 2 and int(state.step) == 2
    # The validation counts on the same batches: grl_tpu's eval step.
    val = jax_proc.sampler.epoch_batches(np.random.RandomState(5), jax_proc.data.val_mask)
    for _, batch in zip(range(3), val):
        nodes, graph, labels = jax_proc._place(batch)
        c, t = jax_proc._eval_fn(state, jax_proc._features_dev, nodes, graph, labels)
        correct, total = proc.eval_step(batch)
        assert (int(correct), int(total)) == (int(c), int(t))


@pytest.mark.parametrize("tree", [True, False], ids=["tree", "coo"])
def test_chunks_equal_stepwise_bit_for_bit(tmp_path, tree):
    """scan_steps 3 over an epoch of 10 batches (three chunks and one
    leftover step), DropEdge and dropout on: the same losses, parameters
    and Adam state as one step a batch."""
    def run(name, scan_steps):
        model = models.create_model("GraphCNNDropEdge", **MODEL, device="cpu",
                                    generator=torch.Generator().manual_seed(0))
        cfg = config(tmp_path / name, tree, eps=1e-8, scan_steps=scan_steps, max_grad_norm=5.0)
        cfg["sampler"]["batch_size"] = 64
        proc = SampledGraphProcedure(model, cfg, large_graph.sbm_relational_graph(**SBM), device="cpu")
        proc()
        return proc

    stepwise, chunked = run("stepwise", 1), run("chunked", 3)
    steps = -(-int(stepwise.data.train_mask.sum()) // 64)
    assert steps % 3 and chunked.state.step == stepwise.state.step == steps
    assert list(chunked._slots) == [3] and chunked.losses == stepwise.losses
    for (name, a), b in zip(stepwise.model.state_dict().items(), chunked.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert str(stepwise.state.optimizer.state_dict()) == str(chunked.state.optimizer.state_dict())


def test_a_first_chunk_keeps_its_runner(tmp_path):
    """run_chunk on a fresh procedure makes the train state before it takes
    the chunk runner, so the runner that ran the first chunk (the warm-up
    on the card) runs the next: the second chunk is the capture."""
    model = models.create_model("GraphCNNDropEdge", **MODEL, device="cpu")
    proc = SampledGraphProcedure(model, config(tmp_path, scan_steps=2), large_graph.sbm_relational_graph(**SBM),
                                 device="cpu")
    items = list(zip(*[iter(proc.sampler.epoch_batches(np.random.RandomState(0), proc.data.train_mask))] * 1))
    items = [batch for (batch,) in items[:2]]
    assert torch.isfinite(proc.run_chunk(items)).all()
    runner = proc._steps
    assert runner is not None and proc.state.step == 2
    proc.run_chunk(items)
    assert proc._steps is runner and proc.state.step == 4


# Measured on grl_tpu with this recipe on the CPU (tests/test_neighbor_sampling.py's
# with 6 epochs for 15): validation accuracy 0.7275 after 6 epochs at seed 0
# (chance 0.2; 0.6256 after 4). The port's weights and masks come from other
# generators, so the limit leaves room below it.
LEARN_EPOCHS, LEARN_ACC = 6, 0.6


def test_learns_through_the_warper(tmp_path):
    cfg = {
        "experiment_name": "sampled-learn", "seed": 0, "output_dir": str(tmp_path), "num_epochs": LEARN_EPOCHS,
        "max_grad_norm": 5.0, "scan_steps": 3,
        "sampler": {"fanouts": [6, 4], "batch_size": 64},
        "optimizer": {"type": "BuiltinOptimizer", "args": {"type_optimizer": "Adam", "lr": 0.01}},
        "model": {"type": "GraphCNNDropEdge", "args": {**MODEL, "dropout_rate": 0.1, "edge_dropout_rate": 0.1}},
        "data_config": {"large_graph": {"type": "sbm", "args": SBM}},
        "procedure": {"type": "SampledGraphProcedure", "args": {}},
        "logging": {"use_tensorboard": False, "experiment_tracking": False},
    }
    warper = GNNLearningWarper(config=cfg, device="cpu")
    acc = warper.train()
    assert isinstance(warper.trainer, SampledGraphProcedure)
    assert all(np.isfinite(warper.trainer.losses)) and acc > LEARN_ACC, acc


def test_multi_device_mesh_raises(tmp_path):
    """A mesh over more devices than the world's processes (one here)
    raises, naming the launch contract; tests/test_torch_mesh.py trains
    {data: 2} in a world of two."""
    model = models.create_model("GraphCNNDropEdge", **MODEL, device="cpu")
    with pytest.raises(ValueError, match="GRL_NUM_PROCESSES=2"):
        SampledGraphProcedure(model, config(tmp_path, parallel={"mesh": {"data": 2}}),
                              large_graph.sbm_relational_graph(**SBM), device="cpu")
