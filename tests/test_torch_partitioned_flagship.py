"""The flagship on the node-partitioned path
(``grl_torch.parallel.sharded_flagship``) in gloo worlds on the CPU,
against grl_tpu's ``make_partitioned_model_step``.

* worlds of 2 and 4, dropout and DropEdge 0, float32: the loss and the
  parameters after one and two Adam steps against grl_tpu's partitioned
  step on a 2- and 4-device mesh (``tests/test_partitioned_flagship.py``'s
  SBM and model, Adam at eps 1e-3 in both, ``rtol=1e-4, atol=1e-6``),
  then the eval-mode logits within 1e-4 of their scale;
  replicated parameters equal across the world bit for bit;
* DropEdge (0.3) and dropout (0.5) on each rank of the world of 4: the
  keep shares of both masks, and masks that differ from rank to rank
  (each rank's generator has the rank folded into its seed);
* ``FullGraphProcedure`` built from the config at ``{data: 4}`` with
  ``scan_steps: 2`` learns, as grl_tpu's config-driven test does, and a
  degree-balanced plan trains too.
"""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from grl_torch import models
from tests.test_torch_distributed import results, run_world

SBM = dict(num_nodes=512, num_classes=6, num_relations=3, avg_degree=8, feature_dim=32, seed=9)
MODEL = dict(input_dim=32, output_dim=6, num_edges=3, net_size=32, use_attention=False,
             dropout_rate=0.0, edge_dropout_rate=0.0)
# Adam's eps in the two-step comparison, as in tests/test_torch_sampled.py:
# a few weights get a gradient of rounding noise around 0 (the ranks sum in
# another order than one device), which Adam at eps 1e-8 moves by
# lr * sign(g) either way (2 of gcn2's 4096 weights 4e-6 apart at step 2);
# at 1e-3 by lr * g / eps.
EPS = 1e-3


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


WORKER = """
import json
from grl_torch import models
from grl_torch.config import ConfigDict
from grl_torch.data.large_graph import sbm_relational_graph
from grl_torch.models.layers import Rngs
from grl_torch.parallel import initialize_distributed, make_mesh, make_partitioned_model_step, partition_graph
from grl_torch.parallel import pad_node_arrays
from grl_torch.parallel.distributed import all_gather, equal_across
from grl_torch.parallel.mesh import fold_seed

initialize_distributed(ConfigDict({"parallel": {"distributed": {"timeout": 120}}}), "cpu")
spec = json.load(open(os.path.join(OUT, "spec.json")))
sbm = sbm_relational_graph(**spec["sbm"])
mesh = make_mesh({"data": WORLD})
part = partition_graph(sbm.senders, sbm.receivers, sbm.relations, sbm.weights, num_nodes=len(sbm.features),
                       num_relations=sbm.num_relations, num_shards=WORLD, edge_quantum=128)
labels = np.where(sbm.train_mask, sbm.labels, -100).astype(np.int64)
feats, labels = pad_node_arrays(np.asarray(sbm.features, np.float32), labels, part.num_nodes)
shard_n = part.num_nodes // WORLD
rows = slice(RANK * shard_n, (RANK + 1) * shard_n)
V, y = torch.from_numpy(feats[rows]), torch.from_numpy(labels[rows])
out = {}

model = models.create_model("GraphCNNDropEdge", **spec["model"], device="cpu")
model.load_state_dict(torch.load(os.path.join(OUT, "initial.pt")))
optimizer = torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=1e-2, eps=spec["eps"])
step, forward = make_partitioned_model_step(model, mesh, part, optimizer)
rngs = Rngs.from_seed(fold_seed(0, RANK), torch.device("cpu"))
out["steps"] = []
for _ in range(2):
    loss = step(V, y, rngs)
    out["steps"].append((float(loss), {k: v.clone() for k, v in model.state_dict().items()}))
out["logits"] = forward(V)
out["equal"] = equal_across(list(model.parameters()))

# Masks of DropEdge 0.3 and dropout 0.5 on this rank's block.
noisy = models.create_model("GraphCNNDropEdge", **{**spec["model"], "dropout_rate": 0.5,
                                                   "edge_dropout_rate": 0.3}, device="cpu")
noisy.train()
edge_keep, self_scale = noisy.trunk.edge_dropout(step.local_graph, False, rngs)
kept = noisy.trunk.dropout(torch.ones(shard_n, 64), rngs) > 0
out["masks"] = (float((edge_keep > 0).float().mean()), float((self_scale > 0).float().mean()),
                float(kept.float().mean()))
masks = torch.cat([(edge_keep > 0).reshape(-1), kept.reshape(-1)]).to(torch.float32)
out["mask_sets"] = all_gather(masks[None], mesh.group("data"))

# FullGraphProcedure from the config at {data: WORLD}, as grl_tpu's test.
if WORLD == 4:
    from grl_torch.trainer.procedures import FullGraphProcedure
    for balance in (False, True):
        cfg = dict(spec["procedure"], output_dir=os.path.join(OUT, f"proc{balance}"))
        cfg["parallel"] = {"mesh": {"data": WORLD}, "balance_partition": balance}
        learner = models.create_model("GraphCNNDropEdge", **spec["learner"], device="cpu")
        proc = FullGraphProcedure(learner, cfg, device="cpu")
        acc = proc()
        out[f"procedure{balance}"] = (proc._partitioned, acc, [float(l) for l in proc.losses], proc.state.step,
                                      proc.part.node_perm is not None, equal_across(list(learner.parameters())))
no_jax()
torch.save(out, os.path.join(OUT, f"rank{RANK}.pt"))
"""

PROCEDURE = {
    "experiment_name": "fullgraph-config", "seed": 0, "num_epochs": 8, "scan_steps": 2,
    "data_config": {"large_graph": {"type": "sbm", "args": {
        "num_nodes": 256, "num_classes": 5, "num_relations": 2, "avg_degree": 8, "feature_dim": 16, "seed": 3}}},
    "optimizer": {"type": "BuiltinOptimizer", "args": {"type_optimizer": "Adam", "lr": 0.01}},
    "logging": {"use_tensorboard": False, "summary_dir_name": "s"},
}
LEARNER = dict(input_dim=16, output_dim=5, num_edges=2, net_size=32, use_attention=False, dropout_rate=0.1,
               edge_dropout_rate=0.1)


def grl_tpu_steps(D):
    """grl_tpu's two partitioned Adam steps on a D-device mesh: the initial
    weights, each step's loss and weights, and the eval logits."""
    from grl_tpu.data.large_graph import sbm_relational_graph, to_relational_graph
    from grl_tpu.models import GraphCNNDropEdge, init_model
    from grl_tpu.parallel import make_mesh, make_partitioned_model_step, pad_node_arrays
    from grl_tpu.parallel.graph_partition import partition_graph

    sbm = sbm_relational_graph(**SBM)
    model = GraphCNNDropEdge(**MODEL)
    graph, feats = to_relational_graph(sbm)
    variables = init_model(model, jax.random.PRNGKey(0), (jnp.asarray(feats), graph))
    params, constants = variables["params"], variables.get("constants")
    tx = optax.adam(1e-2, eps=EPS)
    opt_state = tx.init(params)
    mesh = make_mesh({"data": D}, devices=jax.devices()[:D])
    part = partition_graph(sbm.senders, sbm.receivers, sbm.relations, sbm.weights, num_nodes=len(sbm.features),
                           num_relations=sbm.num_relations, num_shards=D, edge_quantum=128)
    labels = np.where(sbm.train_mask, sbm.labels, -100).astype(np.int32)
    feats_p, labels_p = pad_node_arrays(np.asarray(feats, np.float32), labels, part.num_nodes)
    step, forward = make_partitioned_model_step(model, mesh, part, tx)
    initial = models.state_dict_from_flax(numpy_tree({"params": params, "constants": constants}))
    steps = []
    for _ in range(2):
        params, opt_state, loss = step(params, constants, opt_state, jnp.asarray(feats_p), jnp.asarray(labels_p),
                                       jax.random.PRNGKey(1))
        steps.append((float(loss), models.state_dict_from_flax(numpy_tree({"params": params}))))
    logits = np.asarray(forward(params, constants, jnp.asarray(feats_p)))
    return initial, steps, logits


def run(tmp_path_factory, D):
    import json

    tmp = tmp_path_factory.mktemp(f"torch_partitioned{D}")
    out = tmp / "world_out"
    out.mkdir()
    initial, steps, logits = grl_tpu_steps(D)
    torch.save(initial, out / "initial.pt")
    (out / "spec.json").write_text(json.dumps({"sbm": SBM, "model": MODEL, "procedure": PROCEDURE, "eps": EPS,
                                               "learner": LEARNER}))
    run_world(tmp, WORKER, D, "world", timeout=300)
    return results(tmp, "world", D), steps, logits


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return run(tmp_path_factory, 4)


@pytest.mark.parametrize("world", ["world2", "world4"])
def test_partitioned_steps_match_grl_tpu(world, request):
    ranks, steps, logits = request.getfixturevalue(world)
    for r in ranks:
        assert r["equal"]
        for k, ((loss, state), (want_loss, want)) in enumerate(zip(r["steps"], steps)):
            np.testing.assert_allclose(loss, want_loss, rtol=1e-5, err_msg=f"step {k + 1}")
            for name, value in want.items():
                np.testing.assert_allclose(state[name].numpy(), value.numpy(), rtol=1e-4, atol=1e-6,
                                           err_msg=f"step {k + 1}: {name}")
    # The logits of parameters that agree within rtol 1e-4: within 1e-4 of
    # their scale (some reach 25).
    ours = np.concatenate([r["logits"].numpy() for r in ranks])
    np.testing.assert_allclose(ours, logits, rtol=0, atol=1e-4 * float(np.abs(logits).max()))


def test_rank_masks_keep_their_shares_and_differ(world4):
    ranks, _, _ = world4
    for r in ranks:
        edge_share, self_share, dropout_share = r["masks"]
        assert abs(edge_share - 0.7) < 0.03 and abs(self_share - 0.7) < 0.1
        assert abs(dropout_share - 0.5) < 0.03
    sets = ranks[0]["mask_sets"]
    assert all(not torch.equal(sets[0], sets[i]) for i in range(1, len(ranks)))


@pytest.mark.parametrize("balance", [False, True], ids=["range", "balanced"])
def test_config_driven_partitioned_procedure_learns(world4, balance):
    ranks, _, _ = world4
    accs = set()
    for r in ranks:
        partitioned, acc, losses, step, balanced, equal = r[f"procedure{balance}"]
        assert partitioned and step == 8 and len(losses) == 8 and balanced == balance and equal
        assert np.isfinite(acc) and acc > 0.0
        assert losses[-1] < losses[0]
        accs.add(acc)
    # Every rank sees the world's accuracy.
    assert len(accs) == 1
