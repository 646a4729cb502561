"""The learning check of ``chip_smoke.py``'s ``zoo`` phase, run in both
packages on the CPU at a small width.

The recipe is the ``train`` phase's: 20 Adam steps (clip 5.0) on one
batch with each network's own dropout and DropEdge, at the network's
``chip_smoke.ZOO_LEARN_LR`` (the train recipe's 5e-3; 1e-3 for the GAT
networks), the mean loss of steps 16-20 over the first loss. The phase holds each network to 0.75, or,
where grl_tpu's own run of the recipe does not get under 0.75, to
grl_tpu's ratio plus 0.1 (``chip_smoke.ZOO_LEARN_SHARE``). This test runs
grl_tpu's recipe on the first batch of the synthetic pages at the widths
below and holds that table to it; the port's run of the same recipe must
meet the same limit. The ratios are printed (``-s``). The GAT networks
run in ``tests/test_torch_zoo_learning_gat.py``, so that each file stays
near 90 s.
"""
from __future__ import annotations

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from grl_tpu import models as jax_models
from grl_tpu.data.synthetic import synthetic_dataset_files
from grl_tpu.trainer.procedures.base_procedure import BaseProcedure as JaxProcedure
from grl_torch import models
from grl_torch.data.dataloader import BaseDataLoader
from grl_torch.trainer.procedures import BaseProcedure
from test_procedures import make_split

C, L = 15, 6
STEPS, TAIL = 20, 5


def zoo_args(dim):
    """Each network at a small width, its dropout and DropEdge as it
    defaults them (GATV2's layers at their fixed 256 and 0.3)."""
    gcn = {"input_dim": dim, "output_dim": C, "num_edges": L}
    return {
        "RobustGCN": ("RobustGCN", dict(gcn, net_size=32)),
        "RPGraphCNNDropEdge": ("RPGraphCNNDropEdge", dict(gcn, net_size=32, rp_size=64)),
        "ModGCN": ("ModGCN", dict(gcn, net_size=32)),
        "DeepRPGCN": ("DeepRPGCN", dict(gcn, net_size=16)),
        "DeepRPRobustGCN": ("DeepRPRobustGCN", dict(gcn, net_size=16)),
        "GATV2": ("GATV2", {"input_feature": dim, "no_A": L, "output_feature": 16, "num_classes": C}),
        "GATV2 v1": ("GATV2", {"input_feature": dim, "no_A": L, "output_feature": 16, "num_classes": C,
                               "use_v2": False}),
        "DGCNN": ("DGCNN", {"in_channels": dim, "out_channels": C}),
    }


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def first_batch(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo_learning")
    files = synthetic_dataset_files(str(root), num_pages=8, seed=1)
    with open(files[2]) as handle:
        dim = len(json.load(handle)["charset"]) + 4
    split = make_split(*files)
    split["shuffle"] = False
    maker = BaseDataLoader({"seed": 0})
    batch = next(iter(maker._get_dataloader(maker._load_dataset("CassiaDataset", split), split)))
    V = np.asarray(batch["textline_encoding"], np.float32)
    A = np.asarray(batch["adjacency_matrix"], np.float32)
    return dim, V, A, np.asarray(batch["node_label"]), str(root)


def recipe_config(root, lr):
    return {"output_dir": root, "seed": 0, "max_grad_norm": 5.0,
            "optimizer": {"type": "BuiltinOptimizer", "args": {"type_optimizer": "Adam", "lr": lr}},
            "loss": {"type": "CrossEntropyLoss", "args": {}}, "logging": {"use_tensorboard": False}}


def share(losses):
    return float(np.mean(losses[-TAIL:]) / losses[0])


def jax_ratio(kind, args, V, A, labels, root, lr, classes=C):
    proc = JaxProcedure(jax_models.create_model(kind, **args), recipe_config(root, lr))
    state = proc.init_state((jnp.asarray(V), jnp.asarray(A)))
    step = jax.jit(proc._train_step_body(classes, (-100,)))
    rng, losses = jax.random.PRNGKey(3), []
    for _ in range(STEPS):
        rng, key = jax.random.split(rng)
        state, loss, _ = step(state, jnp.asarray(V), jnp.asarray(A), jnp.asarray(labels, jnp.int32), key,
                              jnp.float32(1.0))
        losses.append(float(loss))
    return share(losses)


def port_ratio(kind, args, V, A, labels, root, lr, classes=C):
    model = models.create_model(kind, **args, device="cpu", generator=torch.Generator().manual_seed(1))
    proc = BaseProcedure(model, recipe_config(root, lr), device="cpu")
    proc.init_state()
    step = proc.build_train_step(classes, (-100,))
    inputs = (torch.from_numpy(V), torch.from_numpy(A), torch.from_numpy(labels).long())
    losses = [float(step(*inputs, proc.rngs, 1.0)[0]) for _ in range(STEPS)]
    return share(losses)


def check_learning_limit(first_batch, name):
    import chip_smoke

    dim, V, A, labels, root = first_batch
    kind, args = zoo_args(dim)[name]
    lr = chip_smoke.ZOO_LEARN_LR[name]
    theirs = jax_ratio(kind, args, V, A, labels, root, lr)
    ours = port_ratio(kind, args, V, A, labels, root, lr)
    limit = chip_smoke.ZOO_LEARN_SHARE[name]
    print(f"{name} at lr {lr}: grl_tpu {theirs:.4f}, grl_torch {ours:.4f}, the zoo phase's limit {limit}")
    if theirs < chip_smoke.LEARN_SHARE:
        assert limit == chip_smoke.LEARN_SHARE
    else:
        assert limit == pytest.approx(theirs + 0.1, abs=0.05)
    assert ours < limit


@pytest.mark.parametrize("name", ["DGCNN", "DeepRPGCN", "DeepRPRobustGCN", "ModGCN", "RPGraphCNNDropEdge", "RobustGCN"])
def test_zoo_learning_limits_follow_grl_tpu(first_batch, name):
    check_learning_limit(first_batch, name)
