"""The self-supervised, joint and graph-classification procedures of the
port under a mesh, in gloo worlds on the CPU, held to ``grl_tpu``'s runs at
the same mesh on its 8-device CPU mesh.

* One process: the multi-term ``BaseProcedure.update`` in two ranks faked
  by threads (their ``all_reduce`` a barrier that sums), with unequal
  denominators a term and a rank whose rows are all padding, against the
  one-process gradient, loss and counts.
* A world of 2 at ``{data: 2}``: two SSL pretraining steps with all six
  tasks (DGI included) and a validation batch; one such step on a global
  batch of 3 pages, which ``data`` does not divide (a rank's padded row
  and its -100 targets); one joint-training epoch (three tasks); two
  graph-classification steps and a validation batch, and one step and a
  validation batch on 3 pages (held to ``grl_tpu`` on one device, whose
  result under a mesh is the one-device step: its mesh run does not pad
  the graph labels).
* A world of 4 at ``{data: 2, model: 2}``: two SSL steps without ``dgi``,
  the classifier row-sharded and the RanPAC column-sharded, the whole
  state gathered between them (a checkpoint's gather leaves the live Adam
  moments as they were); one with ``dgi``, the DGI tree whole on every
  rank, as ``grl_tpu`` keeps it; graph classification's merge of a whole
  ``SSLGCN`` checkpoint, cut to each rank's share, against one process.
* numpy's global generator, which the SSL labels draw from, equal across
  the ranks of a world.

Compared: losses and scores (loss within 1e-5 relative, the scores of the
confusion counts exactly), parameters after each step within 1e-5 of
scale, at Adam eps 1e-3 and dropout 0 (``tests/test_torch_ssl_procedures.py``);
replicated parameters equal across the world bit for bit, shards across
``data``. Every batch is drawn once here, in ``grl_tpu``'s data chain
(equal to the port's: ``tests/test_torch_ssl_data.py``), and handed to
both packages, so that no process depends on numpy's global generator.
"""
from __future__ import annotations

import json
import threading

import numpy as np
import pytest
import torch

from grl_tpu.data import processors as jax_processors
from grl_tpu.models import SSLGCN as JaxSSLGCN
from grl_tpu.trainer.procedures import GraphClassificationProcedure as JaxGraphClassificationProcedure
from grl_tpu.trainer.procedures import JointTrainingProcedure as JaxJointTrainingProcedure
from grl_tpu.trainer.procedures import SSLPretrainProcedure as JaxSSLPretrainProcedure
from grl_torch import models
from test_procedures import base_config, make_split
from test_torch_distributed import results, run_world
from test_torch_ssl_data import files, jax_native_builder, ssl_split  # noqa: F401 (fixtures)
from test_torch_ssl_procedures import TASKS, JaxSyntheticGraphLabel, config, model_args, numpy_tree, port_state

JOINT_TASKS = ["node_property", "edge_mask", "pairwise_distance"]
NO_DGI = TASKS[:-1]
GRAPH_CLASSES = 3
TIMEOUT = {"timeout": 120}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# The multi-term update in one process
# ---------------------------------------------------------------------------
class ThreadMesh:
    """A ``data`` axis of ``size`` ranks, each a thread of this process."""

    def __init__(self, size):
        self.shape = {"data": size}

    def axis_size(self, axis):
        return self.shape.get(axis, 1)

    def group(self, axis):
        return "data"


def thread_all_reduce(size):
    """An ``all_reduce_`` over ``size`` threads: each adds its tensor to a
    shared sum at a barrier and reads the sum back; the kinds it ran, by
    thread."""
    barrier, lock = threading.Barrier(size), threading.Lock()
    shared, kinds = {}, {}

    def all_reduce_(t, group, kind="all_reduce"):
        kinds.setdefault(threading.get_ident(), []).append(kind)
        with lock:
            shared["sum"] = t.clone() if "sum" not in shared else shared["sum"] + t
        barrier.wait()
        t.copy_(shared["sum"])
        barrier.wait()
        shared.pop("sum", None)
        barrier.wait()
        return t

    return all_reduce_, kinds


def test_multi_term_update_gives_the_one_process_gradient(monkeypatch, tmp_path):
    """Two terms (a cross-entropy and a masked MSE) with unequal rank
    denominators, rank 1's MSE rows all padding, and confusion-like counts
    in ``extra``: each rank's gradient, loss and counts equal the
    one-process step's on the whole batch; the denominators take an
    all_reduce of their own before the gradients' one."""
    from grl_torch.parallel import distributed
    from grl_torch.trainer import losses
    from grl_torch.trainer.procedures import BaseProcedure

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 5, 6, generator=gen)
    labels = torch.randint(0, 3, (4, 5), generator=gen)
    labels[0, 1:] = -100  # rank 0 keeps 6 labels, rank 1 ten
    targets = torch.randn(4, 5, generator=gen)
    targets[0, :2] = -100
    targets[2:] = -100  # rank 1's rows: all padding for the MSE
    base = {"output_dir": str(tmp_path), "max_grad_norm": None, "logging": {"use_tensorboard": False},
            "optimizer": {"type": "BuiltinOptimizer", "args": {"type_optimizer": "SGD", "lr": 0.1}}}

    def step(proc, rows):
        model = proc.model
        out = model(x[rows])
        terms = [(losses.cross_entropy(out[..., :3], labels[rows]), losses.cross_entropy, labels[rows]),
                 (losses.masked_mse(out[..., 3], targets[rows]), losses.masked_mse, targets[rows])]
        extra = torch.tensor([float((labels[rows] != -100).sum()), float(rows.stop - rows.start)])
        loss, summed = proc.update(terms, [p for p in model.parameters()], extra)
        return float(loss), summed.clone(), {n: p.grad.clone() for n, p in model.named_parameters()}

    initial = torch.nn.Linear(6, 4).state_dict()

    def procedure():
        model = torch.nn.Linear(6, 4)
        model.load_state_dict(initial)
        proc = BaseProcedure(model, base, device="cpu")
        proc.init_state()
        return proc

    whole = step(procedure(), slice(0, 4))
    all_reduce_, kinds = thread_all_reduce(2)
    monkeypatch.setattr(distributed, "all_reduce_", all_reduce_)
    ranks, errors = [None, None], []

    def run(r):
        try:
            proc = procedure()
            proc.mesh = ThreadMesh(2)
            ranks[r] = step(proc, slice(2 * r, 2 * r + 2))
        except Exception as err:  # pragma: no cover - reported below
            errors.append(err)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    loss, summed, grads = whole
    for r_loss, r_summed, r_grads in ranks:
        np.testing.assert_allclose(r_loss, loss, rtol=1e-6)
        assert torch.equal(r_summed, summed)
        for name, g in grads.items():
            torch.testing.assert_close(r_grads[name], g, rtol=1e-6, atol=1e-7, msg=name)
    assert all(k == ["denominator all_reduce", "gradient all_reduce"] for k in kinds.values()), kinds


# ---------------------------------------------------------------------------
# grl_tpu's runs and the batches
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("ssl_mesh")


def jax_params(proc):
    """A grl_tpu procedure's parameters as the port's state dict."""
    return models.state_dict_from_flax({"params": numpy_tree(proc.state.params)})


def jax_state(proc):
    return port_state({"params": proc.state.params, "constants": proc.state.constants})


def first_batches(loader, count):
    """The first ``count`` batches of ``loader`` after numpy's seed 0 (the
    SSL labels sample their pairs from its global generator)."""
    np.random.seed(0)
    out = []
    for batch in loader:
        out.append({k: np.asarray(v) for k, v in batch.items()})
        if len(out) == count:
            break
    return out


def jax_steps(proc, batches, val_batch=None):
    """grl_tpu's steps on ``batches`` (the state made on the first): the
    initial state, each step's scores and parameters, and the validation
    scores and counts of ``val_batch``."""
    proc._ensure_initialized(batches[0])
    initial = jax_state(proc)
    steps = []
    for batch in batches:
        scores = proc._run_train_batch(batch, 0)
        steps.append((scores, jax_params(proc)))
    val = None if val_batch is None else proc._run_val_batch(val_batch)
    return {"initial": initial, "steps": steps, "val": val}


def graph_split(files, batch_size=4):
    split = make_split(*files)
    split["shuffle"] = False
    split["batch_size"] = batch_size
    split["data_process"]["SyntheticGraphLabel"] = {}
    split["data_collate"]["BucketPadding"]["only_selected_items"] = False
    return split


def port_config(cfg, mesh, root, name):
    """A config for the port's ranks: ``mesh``, its own output directory,
    and no processor the port's ranks lack (their batches come made)."""
    cfg = cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg)
    cfg = json.loads(json.dumps(cfg))
    cfg["parallel"] = {"mesh": mesh, "distributed": TIMEOUT}
    cfg["output_dir"] = str(root / "port" / name)
    for split in cfg["data_config"].values():
        if isinstance(split, dict):
            split.get("data_process", {}).pop("SyntheticGraphLabel", None)
    return cfg


def jax_config(root, split, name, mesh, **extra):
    return config(root, split, name, **({"parallel": {"mesh": mesh}} if mesh else {}), **extra)


@pytest.fixture(scope="module")
def references(root, files, jax_native_builder):  # noqa: F811
    """grl_tpu's runs and the inputs of the port's: {name: (record, inputs)}."""
    jax_processors.SyntheticGraphLabel = JaxSyntheticGraphLabel
    out = {}
    try:
        ssl4, ssl3 = ssl_split(files), dict(ssl_split(files), batch_size=3)
        args, gc_args = model_args(files), model_args(files, n_graph_classes=GRAPH_CLASSES)
        for name, mesh, tasks, split, count in (
                ("ssl", {"data": 2}, TASKS, ssl4, 2), ("ssl_ragged", {"data": 2}, TASKS, ssl3, 1),
                ("ssl_tp", {"data": 2, "model": 2}, NO_DGI, ssl4, 2),
                ("ssl_tp_dgi", {"data": 2, "model": 2}, TASKS, ssl4, 1)):
            cfg = jax_config(root, split, f"jax-{name}", mesh)
            proc = JaxSSLPretrainProcedure(JaxSSLGCN(**args), cfg, tasks=tasks)
            batches = first_batches(proc.train_loader, count)
            record = jax_steps(proc, batches, batches[0] if name == "ssl" else None)
            out[name] = (record, {"config": port_config(cfg, mesh, root, name), "tasks": tasks, "args": args,
                                  "batches": batches})

        kv = make_split(*files)
        kv["shuffle"] = False
        extra = {"data_config": {**base_config(root, kv, "x")["data_config"], "ssl_training": ssl4}}
        cfg = jax_config(root, kv, "jax-joint", {"data": 2}, **extra)
        proc = JaxJointTrainingProcedure(JaxSSLGCN(**args), cfg, tasks=JOINT_TASKS)
        kv_batches = first_batches(proc.train_loader, 2)
        ssl_batches = first_batches(proc.ssl_train_loader, 2)
        proc.train_loader, proc.val_loader, proc.ssl_train_loader = kv_batches, kv_batches[:1], ssl_batches
        proc._ensure_initialized(kv_batches[0])
        initial = jax_state(proc)
        seen = []
        run_batch = proc._run_train_batch
        proc._run_train_batch = lambda batch, epoch: seen.append(run_batch(batch, epoch)) or seen[-1]
        f1 = proc()
        out["joint"] = ({"initial": initial, "scores": seen, "f1": f1, "final": jax_params(proc)},
                        {"config": port_config(cfg, {"data": 2}, root, "joint"), "tasks": JOINT_TASKS, "args": args,
                         "batches": kv_batches, "ssl_batches": ssl_batches})

        procedure = {"type": "GraphClassificationProcedure", "args": {"n_graph_classes": GRAPH_CLASSES}}
        for name, mesh, split, count in (("gc", {"data": 2}, graph_split(files), 2),
                                         ("gc_ragged", None, graph_split(files, 3), 1)):
            cfg = jax_config(root, split, f"jax-{name}", mesh, procedure=procedure)
            proc = JaxGraphClassificationProcedure(JaxSSLGCN(**gc_args), cfg, n_graph_classes=GRAPH_CLASSES)
            batches = first_batches(proc.train_loader, count)
            assert len(set(np.concatenate([b["graph_label"] for b in batches]).tolist())) > 1
            record = jax_steps(proc, batches, batches[-1])
            out[name] = (record, {"config": port_config(cfg, {"data": 2}, root, name), "args": gc_args,
                                  "batches": batches})
    finally:
        del jax_processors.SyntheticGraphLabel
    assert out["ssl_ragged"][1]["batches"][0]["textline_encoding"].shape[0] == 3
    assert out["gc_ragged"][1]["batches"][0]["textline_encoding"].shape[0] == 3
    return out


# ---------------------------------------------------------------------------
# The worlds
# ---------------------------------------------------------------------------
WORLD = """
from grl_torch import models
from grl_torch.config import ConfigDict
from grl_torch.parallel import initialize_distributed
from grl_torch.parallel.distributed import equal_across
from grl_torch.parallel.mesh import sharded_parameters
from grl_torch.trainer.procedures import GraphClassificationProcedure, JointTrainingProcedure, SSLPretrainProcedure

initialize_distributed(ConfigDict({"parallel": {"distributed": {"timeout": 120}}}), "cpu")
inputs = torch.load(os.path.join(OUT, "inputs.pt"), weights_only=False)
out = {}


def replicas_equal(proc):
    # Replicated parameters across the world, shards across data.
    module = proc.state.model
    shards = sharded_parameters(module)
    whole = [p for p in module.parameters() if all(p is not s for s in shards)]
    return equal_across(whole) and (not shards or equal_across(shards, proc.mesh.group("data")))


def whole_params(proc):
    state = proc.state.state_dict()["model"]
    return {name: state[name].clone() for name, _ in proc.state.model.named_parameters()}


for name, (record, spec) in inputs.items():
    cfg = spec["config"]
    if name == "backbone":
        # Graph classification's merge of a whole SSLGCN checkpoint under TP.
        proc = GraphClassificationProcedure(
            models.create_model("SSLGCN", **spec["args"], device="cpu", generator=torch.Generator().manual_seed(6)),
            cfg, n_graph_classes=spec["args"]["n_graph_classes"], device="cpu")
        proc._ensure_initialized()
        out[name] = {"loaded": proc.loaded, "state": proc.state.state_dict()["model"], "sharded": len(proc.sharded)}
        continue
    if name.startswith("ssl"):
        proc = SSLPretrainProcedure(models.create_model("SSLGCN", **spec["args"], device="cpu"), cfg,
                                    tasks=spec["tasks"], device="cpu")
        (proc.dgi if "dgi" in spec["tasks"] else proc.model).load_state_dict(record["initial"])
    elif name.startswith("gc"):
        proc = GraphClassificationProcedure(models.create_model("SSLGCN", **spec["args"], device="cpu"), cfg,
                                            n_graph_classes=spec["args"]["n_graph_classes"], device="cpu")
        proc.model.load_state_dict(record["initial"])
    else:
        proc = JointTrainingProcedure(models.create_model("SSLGCN", **spec["args"], device="cpu"), cfg,
                                      tasks=spec["tasks"], device="cpu")
        proc.model.load_state_dict(record["initial"])
        proc.train_loader, proc.val_loader = spec["batches"], spec["batches"][:1]
        proc.ssl_train_loader = spec["ssl_batches"]
        seen = []
        run_batch = proc._run_train_batch
        proc._run_train_batch = lambda batch, epoch: seen.append(run_batch(batch, epoch)) or seen[-1]
        f1 = proc()
        out[name] = {"scores": seen, "f1": f1, "final": whole_params(proc), "equal": replicas_equal(proc),
                     "steps": proc.state.step}
        continue
    proc._ensure_initialized()
    steps = []
    for batch in spec["batches"]:
        scores = proc._run_train_batch(batch, 0)
        steps.append((scores, whole_params(proc), replicas_equal(proc)))
    val = proc._run_val_batch(spec["batches"][-1] if name.startswith("gc") else spec["batches"][0])
    shapes = {n: tuple(p.shape) for n, p in proc.state.model.named_parameters()}
    shapes.update({n: tuple(b.shape) for n, b in proc.state.model.named_buffers()})
    out[name] = {"steps": steps, "val": val, "shapes": shapes, "sharded": len(proc.sharded)}
# numpy's global generator (the SSL labels') is the first rank's on every rank.
out["numpy_equal"] = equal_across([torch.from_numpy(np.random.get_state()[1].astype(np.int64))])
no_jax()
torch.save(out, os.path.join(OUT, f"rank{RANK}.pt"))
"""


def run(root, references, names, world, tag):
    tmp = root / tag
    tmp.mkdir()
    out = tmp / f"{tag}_out"
    out.mkdir()
    torch.save({name: references[name] for name in names}, out / "inputs.pt")
    run_world(tmp, WORLD, world, tag, timeout=300)
    return results(tmp, tag, world)


@pytest.fixture(scope="module")
def world2(root, references):
    return run(root, references, ["ssl", "ssl_ragged", "joint", "gc", "gc_ragged"], 2, "world2")


@pytest.fixture(scope="module")
def backbone(root, references):
    """An SSLGCN checkpoint of the port, graph classification's merge of it
    in one process, and the inputs of the same merge at {data: 2, model:
    2}: (one-process loaded counts and state, world inputs)."""
    from grl_torch.trainer.procedures import GraphClassificationProcedure
    from grl_torch.utils.checkpoint import CheckpointHandler

    spec = references["gc"][1]
    source = models.create_model("SSLGCN", **spec["args"], device="cpu", generator=torch.Generator().manual_seed(5))
    path = CheckpointHandler().save_checkpoint({"model": source.state_dict()}, str(root / "backbone"))
    cfg = dict(spec["config"], optimize_settings={"ssl_pretrain_path": path}, output_dir=str(root / "port" / "one"))
    del cfg["parallel"]
    proc = GraphClassificationProcedure(models.create_model("SSLGCN", **spec["args"], device="cpu",
                                                            generator=torch.Generator().manual_seed(6)),
                                        cfg, n_graph_classes=GRAPH_CLASSES, device="cpu")
    proc._ensure_initialized()
    expected = (proc.loaded, {k: v.clone() for k, v in proc.state.state_dict()["model"].items()})
    world = dict(cfg, parallel={"mesh": {"data": 2, "model": 2}, "distributed": TIMEOUT},
                 output_dir=str(root / "port" / "backbone"))
    return expected, ({}, {"config": world, "args": spec["args"]})


@pytest.fixture(scope="module")
def world4(root, references, backbone):
    return run(root, {**references, "backbone": backbone[1]}, ["ssl_tp", "ssl_tp_dgi", "backbone"], 4, "world4")


def assert_same_scores(ours, theirs, what):
    assert set(ours) == set(theirs), what
    np.testing.assert_allclose(ours["loss"], theirs["loss"], rtol=1e-5, err_msg=what)
    for key in theirs:
        if key != "loss":
            assert ours[key] == pytest.approx(theirs[key], abs=1e-12), f"{what}: {key}"


def assert_same_params(ours, theirs, what):
    assert set(ours) == set(theirs), what
    scale = max(float(v.abs().max()) for v in theirs.values())
    for name, value in theirs.items():
        np.testing.assert_allclose(ours[name].numpy(), value.numpy(), rtol=0, atol=1e-5 * scale,
                                   err_msg=f"{what}: {name}")


def assert_steps_match(ranks, references, name):
    record = references[name][0]
    for rank, r in enumerate(ranks):
        ours = r[name]
        assert len(ours["steps"]) == len(record["steps"])
        for k, ((scores, params, equal), (jax_scores, jax_params_k)) in enumerate(zip(ours["steps"],
                                                                                     record["steps"])):
            what = f"{name} rank {rank} step {k + 1}"
            assert equal, f"{what}: replicas differ"
            assert_same_scores(scores, jax_scores, what)
            assert_same_params(params, jax_params_k, what)
        if record["val"] is not None:
            (scores, cm), (jax_scores, jax_cm) = ours["val"], record["val"]
            assert_same_scores(scores, jax_scores, f"{name} rank {rank} validation")
            np.testing.assert_array_equal(cm, jax_cm)


@pytest.mark.parametrize("name", ["ssl", "ssl_ragged"])
def test_ssl_pretraining_at_data_2_matches_grl_tpu(world2, references, name):
    """All six tasks with DGI; the ragged run's global batch of 3 pages
    pads a row on rank 1, whose targets (and DGI's, from its node mask)
    are -100."""
    assert_steps_match(world2, references, name)
    assert all(r[name]["sharded"] == 0 and r["numpy_equal"] for r in world2)


def test_joint_training_epoch_at_data_2_matches_grl_tpu(world2, references):
    record = references["joint"][0]
    for rank, r in enumerate(world2):
        ours = r["joint"]
        assert ours["equal"] and ours["steps"] == len(record["scores"]) == 2
        for k, (scores, jax_scores) in enumerate(zip(ours["scores"], record["scores"])):
            assert_same_scores(scores, jax_scores, f"joint rank {rank} step {k + 1}")
        assert ours["f1"] == pytest.approx(record["f1"], abs=1e-12)
        assert_same_params(ours["final"], record["final"], f"joint rank {rank}")


@pytest.mark.parametrize("name", ["gc", "gc_ragged"])
def test_graph_classification_at_data_2_matches_grl_tpu(world2, references, name):
    assert_steps_match(world2, references, name)
    for r in world2:
        scores, cm = r[name]["val"]
        assert cm.shape == (GRAPH_CLASSES, GRAPH_CLASSES)
        assert cm.sum() == len(references[name][1]["batches"][-1]["graph_label"])


def test_ssl_pretraining_tensor_parallel_matches_grl_tpu(world4, references):
    """{data: 2, model: 2} without dgi: SSLGCN's classifier row-sharded and
    its RanPAC column-sharded on every rank, the checkpoint's model whole."""
    assert_steps_match(world4, references, "ssl_tp")
    whole = references["ssl_tp"][0]["initial"]
    for r in world4:
        shapes = r["ssl_tp"]["shapes"]
        assert r["ssl_tp"]["sharded"] == 1
        assert shapes["classifier.weight"] == (whole["classifier.weight"].shape[0],
                                               whole["classifier.weight"].shape[1] // 2)
        assert shapes["w_rand.kernel"] == (whole["w_rand.kernel"].shape[0], whole["w_rand.kernel"].shape[1] // 2)


def test_ssl_pretraining_with_dgi_keeps_the_tree_whole(world4, references):
    """{data: 2, model: 2} with dgi: nothing sharded, as grl_tpu builds its
    DGI state without shard_params."""
    assert_steps_match(world4, references, "ssl_tp_dgi")
    whole = references["ssl_tp_dgi"][0]["initial"]
    for r in world4:
        assert r["ssl_tp_dgi"]["sharded"] == 0
        assert r["ssl_tp_dgi"]["shapes"]["encoder.w_rand.kernel"] == tuple(whole["encoder.w_rand.kernel"].shape)


def test_graph_classification_loads_a_whole_backbone_under_tensor_parallelism(world4, backbone):
    """{data: 2, model: 2}: the fine-tune merge cuts the checkpoint's
    sharded leaves (RanPAC and classifier) to each rank's share, so it
    loads what one process loads, and the gathered model equals that
    process's bit for bit."""
    (loaded, state), _ = backbone
    for r in world4:
        ours = r["backbone"]
        assert ours["sharded"] == 1 and ours["loaded"] == loaded
        assert set(ours["state"]) == set(state)
        for name, value in state.items():
            assert torch.equal(ours["state"][name], value), name
