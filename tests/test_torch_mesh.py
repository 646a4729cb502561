"""The ``data`` x ``model`` mesh of the port (``grl_torch.parallel.mesh``):
data-parallel KV and sampled training and tensor-parallel RanPAC and
classifier, in gloo worlds on the CPU, held to ``grl_tpu``'s mesh runs on
its 8-device CPU mesh.

* ``make_mesh``'s sizes (-1 absorbs the world) and its refusal;
* the placement table of :data:`DEFAULT_TP_RULES` against ``grl_tpu``'s
  ``shard_params`` specs on the same models (flax names and layouts
  carried over by ``state_dict_from_flax``'s rule);
* at ``{data: 2, model: 2}`` (a world of 4): tensor-parallel logits
  against the unsharded model, one Adam step of the world on its rows
  against one unsharded step on the whole batch; ``KVProcedure`` for one
  epoch against ``grl_tpu``'s ``tests/test_mesh_procedure.py`` setup at the
  same mesh (``rtol=2e-3, atol=2e-5``, F1 within 1e-3; dropout and
  DropEdge 0: the port's ranks draw masks of their own); ``scan_steps: 2``
  equal to stepwise; replicated parameters equal across the world bit for
  bit, shards across ``data``; the first rank's checkpoint holds the whole
  model;
* at ``{data: 2}`` (a world of 2): the same ``KVProcedure`` epoch, and two
  ``SampledGraphProcedure`` steps on ``tests/test_neighbor_sampling.py``'s
  ``test_dp_mesh_groups`` setup (groups become 2) against ``grl_tpu``'s.

Adam runs at eps 1e-3 in both packages (:data:`EPS`).

Every rank reads the whole global batch and keeps its rows, so the port's
batches pad as ``grl_tpu``'s global batch does.
"""
from __future__ import annotations

import json

import numpy as np
import pytest

import jax
import torch

from grl_torch import models
from tests.test_procedures import base_config, make_split
from tests.test_torch_distributed import results, run_world

KV_MODEL = dict(output_dim=15, num_edges=6, net_size=32, dropout_rate=0.0, edge_dropout_rate=0.0)
SBM = dict(num_nodes=1024, num_classes=5, num_relations=2, avg_degree=8, feature_dim=24, seed=11)
SAMPLED_MODEL = dict(input_dim=24, output_dim=5, num_edges=2, net_size=32, use_attention=False,
                     dropout_rate=0.0, edge_dropout_rate=0.0)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    from grl_tpu.data.synthetic import synthetic_dataset_files

    root = tmp_path_factory.mktemp("torch_meshproc")
    data_dir, classes_path, charset_path = synthetic_dataset_files(str(root), num_pages=8, seed=3)
    charset = json.load(open(charset_path))["charset"]
    return root, data_dir, classes_path, charset_path, len(charset) + 4


# Adam's eps in the comparisons with grl_tpu, as in tests/test_torch_sampled.py:
# a few weights get a gradient of rounding noise around 0, which Adam at eps
# 1e-8 moves by lr * sign(g) either way, and the ranks sum the gradients in
# another order than one device does (at {data: 2}, 4 of the classifier's
# 2400 weights moved 2.4e-4 apart in one epoch); at 1e-3 by lr * g / eps.
EPS = 1e-3


def kv_config(synth, name, mesh, **extra):
    root, data_dir, classes_path, charset_path, _ = synth
    split = make_split(data_dir, classes_path, charset_path)
    split["batch_size"] = 3
    cfg = base_config(root, split, name, epochs=1)
    cfg["parallel"] = {"mesh": mesh, "distributed": {"timeout": 120}}
    cfg["optimizer"]["args"]["eps"] = EPS
    cfg.update(extra)
    return cfg


def grl_tpu_kv(synth, name, mesh):
    """grl_tpu's KVProcedure at ``mesh`` for one epoch: its initial and
    final weights as the port's state dicts, and its F1."""
    from grl_tpu.models import GraphCNNDropEdge
    from grl_tpu.trainer.procedures import KVProcedure

    # The initial weights from a procedure of their own: drawing a batch
    # starts a loader epoch, which would move the shuffle of the run.
    probe = KVProcedure(GraphCNNDropEdge(input_dim=synth[4], **KV_MODEL), kv_config(synth, name, mesh))
    probe._ensure_initialized(next(iter(probe.train_loader)))
    initial = models.state_dict_from_flax(numpy_tree({"params": probe.state.params,
                                                      "constants": probe.state.constants}))
    proc = KVProcedure(GraphCNNDropEdge(input_dim=synth[4], **KV_MODEL), kv_config(synth, name, mesh))
    f1 = proc()
    final = models.state_dict_from_flax(numpy_tree({"params": proc.state.params}))
    return initial, final, f1


def assert_close(got, expected, rtol, atol, what):
    for name, value in expected.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {name}")


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind, args", [
    ("GraphCNNDropEdge", dict(input_dim=24, output_dim=16, num_edges=6, net_size=32)),
    ("GraphCNNDropEdge", dict(input_dim=24, output_dim=15, num_edges=6, net_size=32, rp_factor=3)),
    ("RPGraphCNNDropEdge", dict(input_dim=24, output_dim=5, num_edges=2, net_size=32, rp_size=64)),
    ("ModGCN", dict(input_dim=24, output_dim=5, num_edges=2, net_size=32)),
    ("SSLGCN", dict(input_dim=24, output_dim=5, num_edges=2, net_size=32)),
], ids=["flagship", "flagship-odd", "rp", "mod", "ssl"])
def test_placement_table_matches_grl_tpu(kind, args):
    """Which leaves shard, on which dimension, and which stay whole
    because a dimension does not divide: the port's table in its names
    and layouts, grl_tpu's specs on a {data: 4, model: 2} mesh."""
    from grl_tpu.models import create_model as jax_create, init_model
    from grl_tpu.parallel import make_mesh as jax_make_mesh, shard_params as jax_shard_params
    from grl_torch.parallel.mesh import module_placement

    jax_model = jax_create(kind, **args)
    V = jax.numpy.zeros((1, 16, args["input_dim"]))
    A = jax.numpy.zeros((1, 16, args["num_edges"], 16))
    variables = init_model(jax_model, jax.random.PRNGKey(0), (V, A))
    mesh = jax_make_mesh({"data": 4, "model": 2})
    expected = {}
    for collection in ("params", "constants"):
        placed = jax_shard_params(variables.get(collection) or {}, mesh)
        for path, leaf in jax.tree_util.tree_leaves_with_path(placed):
            keys = [str(getattr(k, "key", k)) for k in path]
            spec = tuple(leaf.sharding.spec) + (None,) * (leaf.ndim - len(leaf.sharding.spec))
            if collection == "params" and keys[-1] == "kernel" and leaf.ndim == 2:
                keys, spec = keys[:-1] + ["weight"], spec[::-1]
            expected[".".join(keys)] = spec.index("model") if "model" in spec else None
    port = models.create_model(kind, **args, device="cpu")
    got = {name: spec.index("model") if "model" in spec else None
           for name, (spec, _) in module_placement(port, 2).items()}
    assert {k: v for k, v in got.items() if k in expected} == expected
    assert any(v is not None for v in expected.values()) or kind == "ModGCN"


def test_make_mesh_sizes_in_one_process():
    from grl_torch.parallel.mesh import make_mesh, mesh_sizes

    assert mesh_sizes({"data": -1}, 4) == {"data": 4}
    assert mesh_sizes({"data": 2, "model": -1}, 4) == {"data": 2, "model": 2}
    assert make_mesh({"data": 1}).size == 1
    with pytest.raises(ValueError, match="GRL_NUM_PROCESSES=4"):
        make_mesh({"data": 2, "model": 2})


# ---------------------------------------------------------------------------
# A world of 4: {data: 2, model: 2}
# ---------------------------------------------------------------------------
WORLD4 = """
import json
from grl_torch import models
from grl_torch.config import ConfigDict
from grl_torch.parallel import initialize_distributed, make_mesh
from grl_torch.parallel.distributed import equal_across
from grl_torch.parallel.mesh import sharded_parameters
from grl_torch.trainer.procedures import BaseProcedure, KVProcedure

assert initialize_distributed(ConfigDict({"parallel": {"distributed": {"timeout": 120}}}), "cpu")[2] == "gloo"
out = {}
# make_mesh's sizes over the world.
out["sizes"] = [make_mesh({"data": -1}).shape, make_mesh({"data": 2, "model": -1}).shape]
try:
    make_mesh({"data": 8})
except ValueError as err:
    out["refusal"] = str(err)

# Tensor-parallel logits and one DP x TP Adam step against the unsharded model.
args = dict(input_dim=24, output_dim=7, num_edges=6, net_size=32, dropout_rate=0.0, edge_dropout_rate=0.0,
            use_attention=True)
gen = torch.Generator().manual_seed(1)
V = torch.randn(4, 16, 24, generator=gen)
A = (torch.rand(4, 16, 6, 16, generator=gen) < 0.2).float()
labels = torch.randint(0, 7, (4, 16), generator=gen)
labels[3, 5:] = -100
base = {"output_dir": OUT, "max_grad_norm": 0.05, "logging": {"use_tensorboard": False},
        "optimizer": {"type": "BuiltinOptimizer", "args": {"type_optimizer": "Adam", "lr": 1e-2}}}
whole = BaseProcedure(models.create_model("GraphCNNDropEdge", **args, device="cpu"), base, device="cpu")
whole.init_state()
tp = BaseProcedure(models.create_model("GraphCNNDropEdge", **args, device="cpu"),
                   {**base, "parallel": {"mesh": {"data": 2, "model": 2}}}, device="cpu")
tp.init_state()
assert tp.placement["w_rand.kernel"] == (None, "model") and tp.model.w_rand.kernel.shape == (16, 80)
assert tp.placement["classifier.weight"] == (None, "model") and tp.model.classifier.weight.shape == (7, 80)
whole.model.eval(); tp.model.eval()
with torch.no_grad():
    out["logits"] = (whole.model((V, A)), tp.model((V, A)))
rows = tp.place_batch({"V": V.numpy(), "A": A.numpy(), "labels": labels.numpy()}, {"labels": -100})
loss_w, cm_w = whole.build_train_step(7, (-100,))(V, A, labels, whole.rngs, 1.0)
loss_t, cm_t = tp.build_train_step(7, (-100,))(*(torch.from_numpy(rows[k]) for k in ("V", "A", "labels")),
                                                tp.rngs, 1.0)
out["step"] = (float(loss_w), float(loss_t), cm_w, cm_t, whole.model.state_dict(), tp.state.state_dict())
replicated = [p for p in tp.model.parameters() if all(p is not s for s in sharded_parameters(tp.model))]
out["replicated_equal"] = equal_across(replicated)
out["shards_equal"] = equal_across(sharded_parameters(tp.model) + [tp.model.w_rand.kernel],
                                   tp.mesh.group("data"))
out["shards_differ"] = not equal_across(sharded_parameters(tp.model), tp.mesh.group("model"))

# KVProcedure, one epoch at {data: 2, model: 2}, stepwise and scan_steps 2.
for name in ("kv", "kv_stepwise", "kv_scan"):
    cfg = json.load(open(os.path.join(OUT, f"{name}.json")))
    model = models.create_model("GraphCNNDropEdge", **cfg.pop("model_args"), device="cpu")
    model.load_state_dict(torch.load(os.path.join(OUT, "initial_kv.pt")))
    proc = KVProcedure(model, cfg, device="cpu")
    f1 = proc()
    state = proc.state.state_dict()
    replicated = [p for p in proc.model.parameters() if all(p is not s for s in sharded_parameters(proc.model))]
    out[name] = (f1, state["model"], proc.state.step, equal_across(replicated),
                 equal_across(sharded_parameters(proc.model), proc.mesh.group("data")), proc._scan_k)
    if name == "kv" and RANK == 0:
        saved = proc.checkpointer.restore_checkpoint(os.path.join(proc.model_dir, "model_latest"))
        out["checkpoint"] = saved["model"]
no_jax()
torch.save(out, os.path.join(OUT, f"rank{RANK}.pt"))
"""


@pytest.fixture(scope="module")
def world4(synth, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_mesh4")
    mesh = {"data": 2, "model": 2}
    initial, final, f1 = grl_tpu_kv(synth, "mesh4", mesh)
    out = tmp / "world4_out"
    out.mkdir()
    torch.save(initial, out / "initial_kv.pt")
    args = dict(input_dim=synth[4], **KV_MODEL)
    bucket = {"BucketPadding": {"quantum": 1024, "only_selected_items": False}}
    for name, extra in (("kv", {}), ("kv_stepwise", {"batch": 4, "collate": bucket}),
                        ("kv_scan", {"batch": 4, "collate": bucket, "scan_steps": 2})):
        cfg = kv_config(synth, name, mesh).to_dict()
        cfg["output_dir"] = str(tmp / name)
        if "batch" in extra:
            for split in ("training", "validation"):
                cfg["data_config"][split]["batch_size"] = extra["batch"]
                cfg["data_config"][split]["data_collate"] = extra["collate"]
        cfg["scan_steps"] = extra.get("scan_steps", 1)
        cfg["model_args"] = args
        (out / f"{name}.json").write_text(json.dumps(cfg))
    run_world(tmp, WORLD4, 4, "world4", timeout=300)
    return results(tmp, "world4", 4), (final, f1)


def test_mesh_sizes_and_refusal_in_a_world(world4):
    ranks, _ = world4
    for r in ranks:
        assert r["sizes"] == [{"data": 4}, {"data": 2, "model": 2}]
        assert "GRL_NUM_PROCESSES=8" in r["refusal"]


def test_tensor_parallel_logits(world4):
    ranks, _ = world4
    for r in ranks:
        whole, tp = r["logits"]
        torch.testing.assert_close(tp, whole, rtol=1e-5, atol=1e-5 * float(whole.abs().max()))


def test_dp_tp_adam_step_matches_one_unsharded_step(world4):
    ranks, _ = world4
    for r in ranks:
        loss_w, loss_t, cm_w, cm_t, whole, tp = r["step"]
        np.testing.assert_allclose(loss_t, loss_w, rtol=1e-5)
        assert torch.equal(cm_t, cm_w)
        assert tp["model"]["classifier.weight"].shape == whole["classifier.weight"].shape
        scale = max(float(v.abs().max()) for v in whole.values())
        for name, value in whole.items():
            torch.testing.assert_close(tp["model"][name], value, rtol=0, atol=1e-5 * scale, msg=name)


def test_replicated_parameters_equal_bit_for_bit(world4):
    ranks, _ = world4
    for r in ranks:
        assert r["replicated_equal"] and r["shards_equal"] and r["shards_differ"]
        for name in ("kv", "kv_stepwise", "kv_scan"):
            assert r[name][3] and r[name][4], name


def test_kv_epoch_matches_grl_tpu_mesh(world4):
    """One epoch at {data: 2, model: 2} against grl_tpu's run of
    tests/test_mesh_procedure.py's setup at the same mesh."""
    ranks, (final, f1) = world4
    for r in ranks:
        port_f1, state, step, *_ = r["kv"]
        assert step == 3
        assert_close(state, final, 2e-3, 2e-5, "kv {data: 2, model: 2}")
        assert abs(port_f1 - f1) < 1e-3
    # The first rank's checkpoint holds the whole model.
    for name, value in ranks[0]["checkpoint"].items():
        assert torch.equal(value, ranks[0]["kv"][1][name]), name


def test_scanned_matches_stepwise_under_the_mesh(world4):
    ranks, _ = world4
    for r in ranks:
        stepwise, scanned = r["kv_stepwise"], r["kv_scan"]
        assert scanned[5] == 2 and stepwise[5] == 1 and scanned[2] == stepwise[2] == 2
        for name, value in stepwise[1].items():
            assert torch.equal(scanned[1][name], value), name


# ---------------------------------------------------------------------------
# A world of 2: {data: 2}
# ---------------------------------------------------------------------------
WORLD2 = """
import json
from grl_torch import models
from grl_torch.config import ConfigDict
from grl_torch.data import large_graph
from grl_torch.parallel.distributed import equal_across
from grl_torch.parallel import initialize_distributed
from grl_torch.trainer.procedures import KVProcedure, SampledGraphProcedure

initialize_distributed(ConfigDict({"parallel": {"distributed": {"timeout": 120}}}), "cpu")
out = {}
cfg = json.load(open(os.path.join(OUT, "kv.json")))
model = models.create_model("GraphCNNDropEdge", **cfg.pop("model_args"), device="cpu")
model.load_state_dict(torch.load(os.path.join(OUT, "initial_kv.pt")))
proc = KVProcedure(model, cfg, device="cpu")
out["kv"] = (proc(), proc.state.state_dict()["model"], equal_across(list(proc.model.parameters())))

cfg = json.load(open(os.path.join(OUT, "sampled.json")))
sbm = cfg.pop("sbm")
model = models.create_model("GraphCNNDropEdge", **cfg.pop("model_args"), device="cpu")
model.load_state_dict(torch.load(os.path.join(OUT, "initial_sampled.pt")))
proc = SampledGraphProcedure(model, cfg, large_graph.sbm_relational_graph(**sbm), device="cpu")
assert proc.sampler.groups == 2
batches = proc._batches(proc.data.train_mask)
losses = [float(proc.train_step(next(batches))) for _ in range(2)]
counts = [tuple(int(x) for x in proc.eval_step(b))
          for _, b in zip(range(2), proc.sampler.epoch_batches(np.random.RandomState(5), proc.data.val_mask))]
out["sampled"] = (losses, proc.model.state_dict(), counts, equal_across(list(proc.model.parameters())))
no_jax()
torch.save(out, os.path.join(OUT, f"rank{RANK}.pt"))
"""


@pytest.fixture(scope="module")
def world2(synth, tmp_path_factory):
    from grl_tpu import models as jax_models
    from grl_tpu.config import ConfigDict as JaxConfigDict
    from grl_tpu.data import large_graph as jax_large_graph
    from grl_tpu.trainer.procedures import SampledGraphProcedure as JaxSampledGraphProcedure

    tmp = tmp_path_factory.mktemp("torch_mesh2")
    out = tmp / "world2_out"
    out.mkdir()
    initial, final, f1 = grl_tpu_kv(synth, "mesh2", {"data": 2})
    torch.save(initial, out / "initial_kv.pt")
    cfg = kv_config(synth, "kv", {"data": 2}).to_dict()
    cfg["output_dir"] = str(tmp / "kv")
    cfg["model_args"] = dict(input_dim=synth[4], **KV_MODEL)
    (out / "kv.json").write_text(json.dumps(cfg))

    # tests/test_neighbor_sampling.py's test_dp_mesh_groups config, rates 0.
    sampled = {"experiment_name": "sampled", "seed": 0, "output_dir": str(tmp / "sampled"), "num_epochs": 1,
               "max_grad_norm": 5.0, "sampler": {"fanouts": [6, 4], "batch_size": 64},
               "optimizer": {"type": "BuiltinOptimizer", "args": {"type_optimizer": "Adam", "lr": 0.01,
                                                                   "eps": EPS}},
               "logging": {"use_tensorboard": False, "summary_dir_name": "s"},
               "parallel": {"mesh": {"data": 2}, "distributed": {"timeout": 120}}}
    jax_proc = JaxSampledGraphProcedure(jax_models.create_model("GraphCNNDropEdge", **SAMPLED_MODEL),
                                        JaxConfigDict(sampled), jax_large_graph.sbm_relational_graph(**SBM))
    assert jax_proc.sampler.groups == 2
    batches = jax_proc.sampler.epoch_batches(jax_proc._np_rng, jax_proc.data.train_mask)
    first = next(batches)
    jax_proc._ensure_initialized(first)
    state = jax_proc.state
    torch.save(models.state_dict_from_flax(numpy_tree({"params": state.params, "constants": state.constants})),
               out / "initial_sampled.pt")
    losses = []
    for batch in (first, next(batches)):
        nodes, graph, labels = jax_proc._place(batch)
        state, loss = jax_proc._train_fn(state, jax_proc._features_dev, nodes, graph, labels,
                                         jax.random.PRNGKey(3))
        losses.append(float(loss))
    counts = []
    for _, batch in zip(range(2), jax_proc.sampler.epoch_batches(np.random.RandomState(5), jax_proc.data.val_mask)):
        c, t = jax_proc._eval_fn(state, jax_proc._features_dev, *jax_proc._place(batch))
        counts.append((int(c), int(t)))
    sampled_final = models.state_dict_from_flax(numpy_tree({"params": state.params}))
    (out / "sampled.json").write_text(json.dumps({**sampled, "sbm": SBM, "model_args": SAMPLED_MODEL}))
    run_world(tmp, WORLD2, 2, "world2", timeout=300)
    return results(tmp, "world2", 2), (final, f1), (losses, sampled_final, counts)


def test_kv_epoch_at_data_2_matches_grl_tpu_mesh(world2):
    ranks, (final, f1), _ = world2
    for r in ranks:
        port_f1, state, equal = r["kv"]
        assert equal
        assert_close(state, final, 2e-3, 2e-5, "kv {data: 2}")
        assert abs(port_f1 - f1) < 1e-3


def test_sampled_dp_steps_match_grl_tpu_mesh(world2):
    """Two steps at {data: 2} (groups max(0, 2) = 2, one a rank) against
    grl_tpu's at the same mesh, and the validation counts summed over the
    world."""
    ranks, _, (losses, final, counts) = world2
    scale = max(float(v.abs().max()) for v in final.values())
    for r in ranks:
        port_losses, state, port_counts, equal = r["sampled"]
        assert equal
        np.testing.assert_allclose(port_losses, losses, rtol=1e-5)
        assert_close(state, final, 0, 1e-5 * scale, "sampled {data: 2}")
        assert port_counts == counts
