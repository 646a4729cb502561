"""grl_torch stands alone: no JAX, no grl_tpu, and no quiet CPU fallback.

Subprocesses block ``jax`` and ``grl_tpu`` (``sys.modules[name] = None``
makes any import of them fail), then import grl_torch and serve one page,
take one train step, or train the sparse flagship through
FullGraphProcedure (K5, K4 and the sparse modules; K6 with the arxiv
config's plan, and the gather probe's checks; K7 with its ELL residual,
under one of optax's rules, with the demo entry points imported), or
pretrain SSLGCN self-supervised and fine-tune the flagship from its
checkpoint, on ``device="cpu"``.
A scan of the sources finds no import of either package in grl_torch/ or
chip_smoke.py, the multi-device modules (``grl_torch.parallel.*``,
``grl_torch.utils.platform``) named one by one; two gloo ranks on the CPU
import them all and take a data-parallel step with neither package in
``sys.modules``.
"""
from __future__ import annotations

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "grl_tpu")

SERVE_ONE_PAGE = textwrap.dedent(
    """
    import sys
    for name in {blocked!r}:
        sys.modules[name] = None
    import json, os, tempfile
    import torch
    import grl_torch
    from grl_torch.data.synthetic import synthetic_dataset_files, synthetic_page
    from grl_torch.models import create_model
    from grl_torch.utils.checkpoint import CheckpointHandler

    tmp = tempfile.mkdtemp(dir={tmp!r})
    data_dir, classes, charset = synthetic_dataset_files(tmp, num_pages=1, seed=0)
    input_dim = len(json.load(open(charset))["charset"]) + 4
    args = dict(input_dim=input_dim, output_dim=15, num_edges=6, net_size=16, kernel_impl="pallas")
    model = create_model("GraphCNNDropEdge", **args, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    ckpt = CheckpointHandler().save_checkpoint({{"model": model.state_dict()}}, tmp)
    config = {{
        "is_train": False, "output_dir": tmp, "checkpoint_path": ckpt,
        "model": {{"type": "GraphCNNDropEdge", "args": args}},
        "procedure": {{"type": "KVInference", "args": {{"batch_size": 1}}}},
        "inference_settings": {{"datasets": {{"type": "CassiaDataset", "args": {{
            "charset_path": charset, "class_path": classes, "key_types": ["key", "value"],
            "data_process": {{"TextlineEncoding": {{}}, "HeuristicGraphBuilder": {{}}}}}}}}}},
    }}
    page = [{{"location": b["location"], "text": b["text"]}} for b in synthetic_page(1)]
    out = grl_torch.GNNLearningWarper(config=config, device="cpu").predict(page)
    assert len(out) == len(page) and all("formal_key" in box for box in out)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r} and sys.modules[m] is not None)
    assert not leaked, leaked
    print("SERVED", len(out))
    """
)


TRAIN_ONE_STEP = textwrap.dedent(
    """
    import sys
    for name in {blocked!r}:
        sys.modules[name] = None
    import torch
    from grl_torch.models import create_model
    from grl_torch.trainer.procedures import BaseProcedure

    args = dict(input_dim=24, output_dim=5, num_edges=6, net_size=16, kernel_impl="pallas",
                dropout_rate=0.5, edge_dropout_rate=0.3)
    model = create_model("GraphCNNDropEdge", **args, device="cpu")
    proc = BaseProcedure(model, {{"output_dir": {tmp!r}, "max_grad_norm": 1.0,
                                  "logging": {{"use_tensorboard": False}}}}, device="cpu")
    proc.init_state()
    before = [p.detach().clone() for p in model.parameters()]
    gen = torch.Generator().manual_seed(0)
    V = torch.rand(2, 64, 24, generator=gen)
    A = (torch.rand(2, 64, 6, 64, generator=gen) < 0.1).float()
    labels = torch.randint(0, 5, (2, 64), generator=gen)
    loss, cm = proc.build_train_step(5, (-100,))(V, A, labels, proc.rngs, 1.0)
    assert torch.isfinite(loss) and float(cm.sum()) == 128
    assert any(not torch.equal(a, p) for a, p in zip(before, model.parameters()))
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r} and sys.modules[m] is not None)
    assert not leaked, leaked
    print("TRAINED", float(loss))
    """
)


TRAIN_FULL_GRAPH = textwrap.dedent(
    """
    import sys
    for name in {blocked!r}:
        sys.modules[name] = None
    import grl_torch
    from grl_torch.ops import csr_spmm, hashing, kernels, segment, sparse, sparse_attention

    config = {{
        "seed": 0, "output_dir": {tmp!r}, "num_epochs": 3, "scan_steps": 2, "max_grad_norm": 5.0,
        "model": {{"type": "GraphCNNDropEdge", "args": {{
            "input_dim": 8, "output_dim": 3, "num_edges": 2, "net_size": 32,
            "kernel_impl": "pallas_csr", "use_attention": True, "attention_impl": "sparse"}}}},
        "data_config": {{"large_graph": {{"type": "sbm", "args": {{
            "num_nodes": 120, "num_classes": 3, "num_relations": 2, "avg_degree": 4,
            "feature_dim": 8}}}}}},
        "procedure": {{"type": "FullGraphProcedure", "args": {{}}}},
        "logging": {{"use_tensorboard": False, "experiment_tracking": False}},
    }}
    warper = grl_torch.GNNLearningWarper(config=config, device="cpu")
    acc = warper.train()
    trainer = warper.trainer
    assert trainer.state.step == 3 and trainer.graph.kernel is not None
    assert trainer.graph.atten_kernel is not None and 0.0 <= acc <= 1.0
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r} and sys.modules[m] is not None)
    assert not leaked, leaked
    print("FULL GRAPH", acc)
    """
)


TRAIN_ELL_AND_PROBE = textwrap.dedent(
    """
    import sys
    for name in {blocked!r}:
        sys.modules[name] = None
    import grl_torch
    from grl_torch.ops import ell
    from grl_torch.probes import gather

    config = {{
        "seed": 0, "output_dir": {tmp!r}, "num_epochs": 3, "scan_steps": 2, "max_grad_norm": 5.0,
        "model": {{"type": "GraphCNNDropEdge", "args": {{
            "input_dim": 8, "output_dim": 3, "num_edges": 1, "net_size": 32, "kernel_impl": "ell",
            "use_attention": False}}}},
        "kernel_plan": {{"plan_projected": True, "width_quantum": 2, "bucket_growth": 1,
                         "reorder": "degree"}},
        "data_config": {{"large_graph": {{"type": "sbm", "args": {{
            "num_nodes": 120, "num_classes": 3, "num_relations": 1, "avg_degree": 4,
            "feature_dim": 8}}}}}},
        "procedure": {{"type": "FullGraphProcedure", "args": {{}}}},
        "logging": {{"use_tensorboard": False, "experiment_tracking": False}},
    }}
    warper = grl_torch.GNNLearningWarper(config=config, device="cpu")
    acc = warper.train()
    kernel = warper.trainer.graph.kernel
    assert isinstance(kernel, ell.ELLGraphKernel) and kernel.node_perm is not None
    assert kernel.tables.proj is not None and warper.trainer.state.step == 3
    inputs = gather.make_inputs("cpu", quick=True)
    assert all(err == 0 for err in gather.check_kernels(inputs).values())
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r} and sys.modules[m] is not None)
    assert not leaked, leaked
    print("ELL", acc)
    """
)


TRAIN_TILE = textwrap.dedent(
    """
    import sys
    for name in {blocked!r}:
        sys.modules[name] = None
    import grl_torch
    from grl_torch import demo_inference, demo_training
    from grl_torch.ops import reorder, tile

    config = {{
        "seed": 0, "output_dir": {tmp!r}, "num_epochs": 3, "scan_steps": 2, "max_grad_norm": 5.0,
        "model": {{"type": "GraphCNNDropEdge", "args": {{
            "input_dim": 8, "output_dim": 3, "num_edges": 2, "net_size": 32, "kernel_impl": "tile",
            "use_attention": False}}}},
        "kernel_plan": {{"tile_size": 64, "tile_min_edges": 20, "tile_dtype": "bfloat16", "plan_projected": True}},
        "data_config": {{"large_graph": {{"type": "sbm", "args": {{
            "num_nodes": 600, "num_classes": 3, "num_relations": 2, "avg_degree": 8, "feature_dim": 8,
            "communities": 8}}}}}},
        "procedure": {{"type": "FullGraphProcedure", "args": {{}}}},
        "optimizer": {{"type": "BuiltinOptimizer", "args": {{"type_optimizer": "Lion", "lr": 1e-3}}}},
        "logging": {{"use_tensorboard": False, "experiment_tracking": False}},
    }}
    warper = grl_torch.GNNLearningWarper(config=config, device="cpu")
    acc = warper.train()
    kernel = warper.trainer.graph.kernel
    assert isinstance(kernel, tile.TileGraphKernel) and kernel.tiles_total > 0 and kernel.node_perm is not None
    assert kernel.tables.proj is not None and warper.trainer.state.step == 3
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r} and sys.modules[m] is not None)
    assert not leaked, leaked
    print("TILE", acc)
    """
)


SSL_THEN_FINETUNE = textwrap.dedent(
    """
    import sys
    for name in {blocked!r}:
        sys.modules[name] = None
    import json
    import numpy as np
    import torch
    import grl_torch
    from grl_torch.data.synthetic import synthetic_dataset_files
    from grl_torch.utils.checkpoint import CheckpointHandler

    data_dir, classes, charset = synthetic_dataset_files({tmp!r}, num_pages=2, seed=0)
    input_dim = len(json.load(open(charset))["charset"]) + 4
    tasks = ["node_property", "edge_mask", "pairwise_distance", "pairwise_similarity", "graph_edit_distance", "dgi"]
    pairs = ["edge_mask", "pairwise_distance", "pairwise_similarity"]
    process = {{"TextlineEncoding": {{}}, "HeuristicGraphBuilder": {{}}, "NodeLabeling": {{}}}}
    ssl_process = {{**process, "NodeDropAugmentor": {{"drop_rate": 0.15, "seed": 0}},
                    "DGINegativeSampling": {{"seed": 0}}, "SSLLabeling": {{"tasks": tasks}}}}
    extra = {{"node_property": -100, "aug_textline_encoding": 0, "aug_adjacency_matrix": 0,
              "negative_textline_encoding": 0, "negative_adjacency_matrix": 0}}
    keep = [f"{{t}}_{{k}}" for t in pairs for k in ("indices", "targets")] + ["graph_edit_distance", "dgi"]
    padded = {{**{{f"{{t}}_indices": 0 for t in pairs}}, **{{f"{{t}}_targets": -100 for t in pairs}}}}
    ssl_collate = {{"BucketPadding": {{"quantum": 64, "only_selected_items": True, "extra_keys": extra,
                                       "keep_keys": keep}},
                    "NumpyPadding": {{"name_value_pairs": padded}}}}

    def split(process, collate):
        return {{"data_path": [data_dir], "class_path": classes, "charset_path": charset,
                 "key_types": ["key", "value"], "batch_size": 2, "data_process": process,
                 "data_collate": collate}}

    def config(name, model, procedure, process, collate, **extra):
        return {{"seed": 0, "output_dir": {tmp!r}, "experiment_name": name, "num_epochs": 1,
                 "max_grad_norm": 5.0, "model": model, "procedure": procedure,
                 "data_config": {{"dataset": {{"type": "CassiaDataset"}},
                                  "training": split(process, collate), "validation": split(process, collate)}},
                 "logging": {{"use_tensorboard": False, "experiment_tracking": False}}, **extra}}

    args = {{"input_dim": input_dim, "output_dim": 15, "num_edges": 6, "net_size": 16}}
    np.random.seed(0)
    pre = grl_torch.GNNLearningWarper(config=config(
        "ssl", {{"type": "SSLGCN", "args": args}}, {{"type": "SSLPretrainProcedure", "args": {{"tasks": tasks}}}},
        ssl_process, ssl_collate), device="cpu")
    pre.train()
    assert pre.trainer.state.step == 1
    checkpoint = pre.trainer.model_dir + "/" + CheckpointHandler.LATEST
    assert all(k.startswith(("encoder.", "discriminator.")) for k in torch.load(checkpoint)["model"])
    collate = {{"BucketPadding": {{"quantum": 64, "only_selected_items": True}}}}
    fine = grl_torch.GNNLearningWarper(config=config(
        "finetune", {{"type": "GraphCNNDropEdge", "args": {{**args, "kernel_impl": "pallas"}}}},
        {{"type": "FinetuneKVProcedure", "args": {{}}}}, process, collate,
        optimize_settings={{"ssl_pretrain_path": checkpoint}}), device="cpu")
    fine.train()
    assert fine.trainer.state.step == 1 and fine.trainer.loaded == (0, 0)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r} and sys.modules[m] is not None)
    assert not leaked, leaked
    print("SSL", fine.trainer.loaded)
    """
)


TRAIN_ZOO = textwrap.dedent(
    """
    import sys
    for name in {blocked!r}:
        sys.modules[name] = None
    import torch
    from grl_torch import bayes_training
    from grl_torch.models import create_model
    from grl_torch.trainer.procedures import BaseProcedure
    from grl_torch.utils import bayes_opt, input_wrapper, profiling

    gcn = dict(input_dim=24, output_dim=5, num_edges=6)
    zoo = {{
        "RobustGCN": dict(gcn, net_size=16), "RPGraphCNNDropEdge": dict(gcn, net_size=16, rp_size=32),
        "ModGCN": dict(gcn, net_size=16), "DeepRPGCN": dict(gcn, net_size=8, num_layers=4),
        "DeepRPRobustGCN": dict(gcn, net_size=8),
        "GATV2": dict(input_feature=24, no_A=6, output_feature=8, num_classes=5),
        "DGCNN": dict(in_channels=24, out_channels=5, kk=4),
    }}
    gen = torch.Generator().manual_seed(0)
    V = torch.rand(2, 16, 24, generator=gen)
    A = (torch.rand(2, 16, 6, 16, generator=gen) < 0.2).float()
    labels = torch.randint(0, 5, (2, 16), generator=gen)
    for kind, args in zoo.items():
        model = create_model(kind, **args, device="cpu")
        proc = BaseProcedure(model, {{"output_dir": {tmp!r}, "max_grad_norm": 1.0,
                                      "logging": {{"use_tensorboard": False}}}}, device="cpu")
        proc.init_state()
        before = {{k: v.clone() for k, v in model.state_dict().items()}}
        loss, cm = proc.build_train_step(5, (-100,))(V, A, labels, proc.rngs, 0.5)
        assert torch.isfinite(loss), kind
        assert any(not torch.equal(before[k], v) for k, v in model.state_dict().items()), kind
        model.eval()
        with torch.no_grad():
            logits = model((V, A))
        assert tuple(logits.shape) == (2, 16, 5), (kind, logits.shape)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r} and sys.modules[m] is not None)
    assert not leaked, leaked
    print("ZOO", len(zoo))
    """
)


TRAIN_SAMPLED_AND_COO = textwrap.dedent(
    """
    import sys
    for name in {blocked!r}:
        sys.modules[name] = None
    import json
    import grl_torch
    from grl_torch.data.synthetic import synthetic_dataset_files
    from grl_torch.ops import tree

    graph = {{"large_graph": {{"type": "sbm", "args": {{
        "num_nodes": 200, "num_classes": 3, "num_relations": 2, "avg_degree": 4, "feature_dim": 8}}}}}}
    for route in (True, False):
        config = {{
            "seed": 0, "output_dir": {tmp!r}, "num_epochs": 1, "scan_steps": 2, "max_grad_norm": 5.0,
            "sampler": {{"fanouts": [3, 2], "batch_size": 32, "tree_aggregation": route}},
            "model": {{"type": "GraphCNNDropEdge", "args": {{
                "input_dim": 8, "output_dim": 3, "num_edges": 2, "net_size": 16, "use_attention": False}}}},
            "data_config": graph, "procedure": {{"type": "SampledGraphProcedure", "args": {{}}}},
            "logging": {{"use_tensorboard": False, "experiment_tracking": False}},
        }}
        warper = grl_torch.GNNLearningWarper(config=config, device="cpu")
        acc = warper.train()
        assert warper.trainer.state.step == len(warper.trainer.losses) > 2 and 0.0 <= acc <= 1.0

    data_dir, classes, charset = synthetic_dataset_files({tmp!r}, num_pages=2, seed=0)
    split = {{"data_path": [data_dir], "class_path": classes, "charset_path": charset,
              "key_types": ["key", "value"], "batch_size": 2,
              "data_process": {{"TextlineEncoding": {{}}, "HeuristicGraphBuilder": {{}}, "NodeLabeling": {{}}}},
              "data_collate": {{"SparseBucketPadding": {{"quantum": 64, "edge_quantum": 256,
                                                       "only_selected_items": True}}}}}}
    args = {{"input_dim": len(json.load(open(charset))["charset"]) + 4, "output_dim": 15, "num_edges": 6,
             "net_size": 16, "attention_impl": "sparse"}}
    config = {{"seed": 0, "output_dir": {tmp!r}, "experiment_name": "coo", "num_epochs": 1, "max_grad_norm": 5.0,
               "model": {{"type": "GraphCNNDropEdge", "args": args}},
               "procedure": {{"type": "KVProcedure", "args": {{}}}},
               "data_config": {{"dataset": {{"type": "CassiaDataset"}}, "training": split, "validation": split}},
               "logging": {{"use_tensorboard": False, "experiment_tracking": False}}}}
    warper = grl_torch.GNNLearningWarper(config=config, device="cpu")
    warper.train()
    assert warper.trainer.state.step == 1
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r} and sys.modules[m] is not None)
    assert not leaked, leaked
    print("SAMPLED AND COO", warper.trainer.state.step)
    """
)


def run_blocked(script: str, tmp_path) -> str:
    # One OpenMP thread: the suite's worker processes share the cores.
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    result = subprocess.run(
        [sys.executable, "-c", script.format(blocked=BLOCKED, tmp=str(tmp_path))],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert result.returncode == 0, result.stderr[-4000:]
    return result.stdout


def test_serves_with_jax_and_grl_tpu_blocked(tmp_path):
    assert "SERVED" in run_blocked(SERVE_ONE_PAGE, tmp_path)


def test_trains_with_jax_and_grl_tpu_blocked(tmp_path):
    """One CPU train step on the kernel path with dropout and DropEdge on."""
    assert "TRAINED" in run_blocked(TRAIN_ONE_STEP, tmp_path)


def test_full_graph_trains_with_jax_and_grl_tpu_blocked(tmp_path):
    """Three full-graph steps on the K5 + K4 path, DropEdge and dropout on."""
    assert "FULL GRAPH" in run_blocked(TRAIN_FULL_GRAPH, tmp_path)


def test_ell_path_and_probe_run_with_jax_and_grl_tpu_blocked(tmp_path):
    """Three full-graph steps on K6 with the arxiv config's kernel_plan
    (project-first gcn3, the degree reorder), and the probe's checks."""
    assert "ELL" in run_blocked(TRAIN_ELL_AND_PROBE, tmp_path)


def test_tile_path_and_entry_points_run_with_jax_and_grl_tpu_blocked(tmp_path):
    """Three full-graph steps on K7 and its ELL residual (the LPA order,
    bfloat16 tiles, project-first gcn3) under Lion, and the demo modules
    and the reorder imported."""
    assert "TILE" in run_blocked(TRAIN_TILE, tmp_path)


def test_ssl_pretraining_then_finetuning_with_jax_and_grl_tpu_blocked(tmp_path):
    """One SSL pretraining step of every task (DGI too) through the warper,
    then one fine-tuning step of the flagship on the kernel path from its
    checkpoint (a DGI tree: nothing loads, as in grl_tpu)."""
    assert "SSL" in run_blocked(SSL_THEN_FINETUNE, tmp_path)


def test_zoo_trains_with_jax_and_grl_tpu_blocked(tmp_path):
    """One CPU train step and an eval forward of every network of the dense
    zoo, dropout and DropEdge at their defaults, with the Bayesian search,
    profiling and input-cast modules imported."""
    assert "ZOO 7" in run_blocked(TRAIN_ZOO, tmp_path)


def test_sampled_and_coo_paths_train_with_jax_and_grl_tpu_blocked(tmp_path):
    """A SampledGraphProcedure epoch on the tree and the COO routes in
    chunks of 2 (DropEdge and dropout on), and one KVProcedure step on a
    SparseBucketPadding COO batch with sparse attention, all through the
    warper."""
    assert "SAMPLED AND COO" in run_blocked(TRAIN_SAMPLED_AND_COO, tmp_path)


PARALLEL_WORLD = """
import importlib
for name in ("grl_torch.parallel", "grl_torch.parallel.distributed", "grl_torch.parallel.mesh",
             "grl_torch.parallel.graph_partition", "grl_torch.parallel.sharded_flagship",
             "grl_torch.utils.platform"):
    importlib.import_module(name)
from grl_torch import models
from grl_torch.config import ConfigDict
from grl_torch.parallel import initialize_distributed
from grl_torch.trainer.procedures import BaseProcedure

initialize_distributed(ConfigDict({"parallel": {"distributed": {"timeout": 120}}}), "cpu")
model = models.create_model("GraphCNNDropEdge", input_dim=24, output_dim=5, num_edges=6, net_size=16,
                            device="cpu")
proc = BaseProcedure(model, {"output_dir": OUT, "logging": {"use_tensorboard": False},
                             "parallel": {"mesh": {"data": 2}}}, device="cpu")
proc.init_state()
gen = torch.Generator().manual_seed(RANK)
V = torch.rand(1, 64, 24, generator=gen)
A = (torch.rand(1, 64, 6, 64, generator=gen) < 0.1).float()
loss, cm = proc.build_train_step(5, (-100,))(V, A, torch.randint(0, 5, (1, 64), generator=gen), proc.rngs, 1.0)
assert torch.isfinite(loss) and float(cm.sum()) == 128
no_jax()
print("RANK TRAINED", RANK)
"""


def test_parallel_world_runs_with_jax_and_grl_tpu_blocked(tmp_path):
    """Two gloo ranks import every module of grl_torch.parallel and
    grl_torch.utils.platform and take one data-parallel step with dropout
    and DropEdge on; neither rank has JAX or grl_tpu in sys.modules."""
    from tests.test_torch_distributed import run_world

    outputs = run_world(tmp_path, PARALLEL_WORLD, 2, "parallel")
    assert all("RANK TRAINED" in out for out in outputs)


@pytest.mark.parametrize("module", ["parallel/__init__.py", "parallel/mesh.py", "parallel/distributed.py",
                                    "parallel/graph_partition.py", "parallel/sharded_flagship.py",
                                    "utils/platform.py"])
def test_multi_device_modules_import_neither_jax_nor_grl_tpu(module):
    path = REPO / "grl_torch" / module
    assert path.exists()
    assert not set(imported_roots(path)) & set(BLOCKED)


def imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("root", ["grl_torch", "chip_smoke.py"])
def test_sources_import_neither_jax_nor_grl_tpu(root):
    target = REPO / root
    files = sorted(target.rglob("*.py")) if target.is_dir() else [target]
    assert files
    for path in files:
        bad = set(imported_roots(path)) & set(BLOCKED)
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_entry_points_raise_without_a_gpu(monkeypatch, tmp_path):
    """With no device argument and no GPU, every entry point raises
    RuntimeError instead of carrying on quietly on the CPU."""
    from grl_torch import GNNLearningWarper
    from grl_torch.inferencer import KVInference
    from grl_torch.models import create_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = dict(input_dim=8, output_dim=3, num_edges=6, net_size=16)
    with pytest.raises(RuntimeError, match="no GPU"):
        create_model("GraphCNNDropEdge", **args)
    model = create_model("GraphCNNDropEdge", **args, device="cpu")
    with pytest.raises(RuntimeError, match="no GPU"):
        KVInference(model, {"checkpoint_path": None})
    with pytest.raises(RuntimeError, match="no GPU"):
        GNNLearningWarper(config={"is_train": False, "output_dir": str(tmp_path)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_model("GraphCNNDropEdge", **args, device="cuda")


def test_wrapper_refuses_other_devices():
    """CPU tensors take the plain version; any other device either launches
    the kernel (CUDA) or raises, never falling back."""
    from grl_torch.ops import csr_spmm, ell, sparse_attention, tile
    from grl_torch.ops.relagg import neighbor_aggregate
    from grl_torch.probes import gather

    V = torch.zeros(1, 4, 8, device="meta")
    A = torch.zeros(1, 4, 6, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        neighbor_aggregate(V, A)
    kernel = csr_spmm.CSRGraphKernel([0, 1], [1, 2], [0, 0], [1.0, 1.0], 4, 1, device="cpu")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernel.neighbor_aggregate(torch.zeros(4, 8, device="meta"))
    atten = sparse_attention.SparseAttentionKernel([0, 1], [1, 2], 4, device="cpu")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        atten.attend(*[torch.zeros(4, d, device="meta") for d in (2, 2, 8)])
    table = ell.ELLGraphKernel([0, 1], [1, 2], [0, 0], [1.0, 1.0], 4, 1, plan_projected=True, device="cpu")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        table.neighbor_aggregate(torch.zeros(4, 8, device="meta"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        table.neighbor_aggregate_projected(torch.zeros(4, 8, device="meta"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gather.row_dma_sum(torch.zeros(4, 8, device="meta"), torch.zeros(1, 2, dtype=torch.int32, device="meta"))
    tiles = tile.TileGraphKernel([0, 1, 1], [1, 2, 2], [0, 0, 0], [1.0, 1.0, 1.0], 4, 1, tile_size=64,
                                 tile_min_edges=1, reorder="none", plan_projected=True, device="cpu")
    assert tiles.tiles_total == 1
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tiles.neighbor_aggregate(torch.zeros(4, 8, device="meta"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tiles.neighbor_aggregate_projected(torch.zeros(4, 8, device="meta"))
