"""The dense zoo through the port's procedures and entry points, against
grl_tpu's, on the CPU.

* ``GNNLearningWarper.train`` for 2 epochs of ``DeepRPRobustGCN`` (its
  BatchNorm statistics, the schedule's lambda read at call time) and
  ``GATV2`` in both packages from the same weights at dropout 0, on the
  same batches (``tests/test_procedures.py``'s ``make_split`` /
  ``base_config``, unshuffled): step losses, parameters and BatchNorm
  buffers within 1e-5 of scale.
* The checkpoint: resumed, it restores the buffers; served, it gives every
  box the class grl_tpu's serving of its own checkpoint gives.
* ``scan_steps: 2`` equal to step by step, bit for bit, buffers included.
* ``BayesianOptimization`` probing grl_tpu's points; ``python -m
  grl_torch.bayes_training --device cpu`` in a subprocess.
* ``StepTimer``, ``trace_window``, the three input casts and the t-SNE
  plot of the trunk's embeddings.

Adam's eps is 1e-3 and its learning rate 1e-3, as in
``tests/test_torch_zoo_models.py``: an entry whose gradient is near eps
moves by about ``lr * g / eps``, so a last-bit difference of its gradient
reaches the parameter ``lr / eps`` times larger, four steps over (at
base_config's 5e-3, 2.7e-5 of scale on DeepRPRobustGCN's gcn1).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

import jax
import torch

from grl_tpu.data.synthetic import synthetic_dataset_files, synthetic_page
from grl_tpu.utils import bayes_opt as jax_bayes_opt
from grl_tpu.utils import input_wrapper as jax_input_wrapper
from grl_tpu.warper import GNNLearningWarper as JaxWarper
from grl_torch import GNNLearningWarper, models
from grl_torch.utils import bayes_opt, input_wrapper, profiling
from grl_torch.utils.checkpoint import CheckpointHandler
from test_procedures import base_config, make_split
from test_torch_zoo_models import no_dropout

REPO = Path(__file__).resolve().parent.parent
C, L, EPS, LR = 15, 6, 1e-3, 1e-3
ZOO = {
    "DeepRPRobustGCN": lambda dim: {"input_dim": dim, "output_dim": C, "num_edges": L, "net_size": 16,
                                    "dropout_rate": 0.0, "edge_dropout_rate": 0.0},
    "GATV2": lambda dim: {"input_feature": dim, "no_A": L, "output_feature": 16, "num_classes": C},
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo_procedures")
    files = synthetic_dataset_files(str(root), num_pages=8, seed=1)
    with open(files[2]) as handle:
        input_dim = len(json.load(handle)["charset"]) + 4
    return root, files, input_dim


def config(root, files, name, kind, args, epochs=2, **extra):
    split = make_split(*files)
    split["shuffle"] = False
    cfg = base_config(root, split, name, epochs=epochs)
    cfg["optimizer"]["args"].update(eps=EPS, lr=LR)
    cfg["lr_scheduler"]["args"]["lr"] = LR
    cfg["logging"]["experiment_tracking"] = True
    cfg["model"] = {"type": kind, "args": args}
    cfg.update(extra)
    return cfg


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def series(output_dir, path):
    with open(os.path.join(output_dir, "experiment_series.jsonl")) as handle:
        return [r["value"] for r in map(json.loads, handle) if r["path"] == path]


def assert_tree(module, tree, collection, what):
    expected = models.state_dict_from_flax({collection: numpy_tree(tree)})
    got = dict(module.named_parameters() if collection == "params" else module.named_buffers())
    assert set(expected) <= set(got), what
    scale = max(float(v.abs().max()) for v in expected.values())
    for name, value in expected.items():
        np.testing.assert_allclose(got[name].detach().numpy(), value.numpy(), rtol=0, atol=1e-5 * scale,
                                   err_msg=f"{what}: {name}")


@pytest.fixture(scope="module", params=sorted(ZOO))
def trained(request, data):
    """Both packages' warpers after 2 epochs of the same batches from
    grl_tpu's initial weights at dropout 0."""
    root, files, input_dim = data
    kind = request.param
    args = ZOO[kind](input_dim)
    # A step checkpoint after the last step: model_latest is the final state.
    jax_warper = JaxWarper(config=config(root, files, f"jax-{kind}", kind, args, save_interval=4))
    jax_proc = jax_warper.trainer
    first = next(iter(jax_proc.train_loader))
    jax_proc._ensure_initialized(first)
    initial = jax_proc.state.variables()
    model = models.create_model(kind, **args, device="cpu")
    model.load_state_dict(models.state_dict_from_flax(numpy_tree(initial)), strict=True)
    port_warper = GNNLearningWarper(model, config=config(root, files, f"port-{kind}", kind, args, save_interval=4),
                                    device="cpu")
    with no_dropout(model):
        jax_warper.train()
        port_warper.train()
    return kind, args, jax_warper, port_warper


def test_training_matches_grl_tpu(trained):
    kind, _, jax_warper, port_warper = trained
    theirs = series(jax_warper.config["output_dir"], "Train/step_loss")
    ours = series(port_warper.config["output_dir"], "Train/step_loss")
    assert len(ours) == len(theirs) == 4
    np.testing.assert_allclose(ours, theirs, rtol=1e-5)
    np.testing.assert_allclose(series(port_warper.config["output_dir"], "Validation/loss"),
                               series(jax_warper.config["output_dir"], "Validation/loss"), rtol=1e-5)
    state = jax_warper.trainer.state
    assert port_warper.trainer.state.step == int(state.step) == 4
    assert_tree(port_warper.model, state.params, "params", kind)
    if state.batch_stats is not None:
        assert_tree(port_warper.model, state.batch_stats, "batch_stats", kind)
        moved = dict(port_warper.model.named_buffers())
        assert not torch.equal(moved["gcn1.norm.bn.var"], torch.ones_like(moved["gcn1.norm.bn.var"]))


def serve_config(root, files, name, kind, args, checkpoint):
    return {
        "experiment_name": name, "seed": 0, "is_train": False, "output_dir": str(root / "serve"),
        "checkpoint_path": checkpoint, "model": {"type": kind, "args": args},
        "procedure": {"type": "KVInference", "args": {"batch_size": 4}},
        "inference_settings": {"datasets": {"type": "CassiaDataset", "args": {
            "charset_path": files[2], "class_path": files[1], "key_types": ["key", "value"],
            "data_process": {"TextlineEncoding": {"is_normalized_text": True},
                             "HeuristicGraphBuilder": {"num_edges": 6, "edge_type": "normal_binary"}}}}},
    }


def test_checkpoint_resumes_and_serves_as_grl_tpu(trained, data):
    """The run's checkpoint: a resumed procedure restores parameters,
    BatchNorm buffers, optimizer and step; served in eval mode from its
    running statistics, every box gets grl_tpu's class for the same pages
    from grl_tpu's checkpoint of the same run."""
    root, files, _ = data
    kind, args, jax_warper, port_warper = trained
    trained_state = {k: v.clone() for k, v in port_warper.model.state_dict().items()}
    resumed = GNNLearningWarper(config=config(root, files, f"port-{kind}", kind, args, resume=True), device="cpu")
    resumed.trainer._ensure_initialized()
    assert resumed.trainer.state.step == 4 and resumed.trainer.global_step == 4
    restored = resumed.model.state_dict()
    assert set(restored) == set(trained_state)
    assert all(torch.equal(restored[k], v) for k, v in trained_state.items())
    checkpoint = os.path.join(port_warper.trainer.model_dir, CheckpointHandler.LATEST)
    jax_checkpoint = os.path.join(jax_warper.trainer.model_dir, "model_latest")
    pages = [[{"location": b["location"], "text": b["text"]} for b in synthetic_page(900 + i)] for i in range(3)]
    ours = GNNLearningWarper(config=serve_config(root, files, f"serve-{kind}", kind, args, checkpoint),
                             device="cpu").predict(pages)
    theirs = JaxWarper(config=serve_config(root, files, f"jax-serve-{kind}", kind, args, jax_checkpoint)).predict(pages)
    for page_a, page_b in zip(ours, theirs):
        assert [(a["formal_key"], a["key_type"]) for a in page_a] == [(b["formal_key"], b["key_type"]) for b in page_b]
        np.testing.assert_allclose([a["confidence"] for a in page_a], [b["confidence"] for b in page_b], atol=1e-4)


def test_scan_steps_equal_stepwise_with_buffers(data):
    """DeepRPRobustGCN with dropout and DropEdge on, one epoch at
    scan_steps 2 (chunks run in order on the CPU) and step by step from the
    same weights and seeds: the same parameters, Adam state and BatchNorm
    buffers, bit for bit."""
    root, files, input_dim = data
    args = dict(ZOO["DeepRPRobustGCN"](input_dim), dropout_rate=0.3, edge_dropout_rate=0.2)
    runs = []
    for scan in (1, 2):
        model = models.create_model("DeepRPRobustGCN", **args, device="cpu", generator=torch.Generator().manual_seed(3))
        warper = GNNLearningWarper(model, config=config(root, files, f"scan-{scan}", "DeepRPRobustGCN", args,
                                                        epochs=1, scan_steps=scan), device="cpu")
        assert warper.trainer._use_scan() == (scan > 1)
        warper.train()
        optimizer = warper.trainer.state.optimizer.state_dict()["state"]
        runs.append((dict(model.state_dict()), optimizer, warper.trainer.state.step))
    (state_a, opt_a, steps_a), (state_b, opt_b, steps_b) = runs
    assert steps_a == steps_b == 2
    assert all(torch.equal(state_a[k], state_b[k]) for k in state_a)
    assert any("norm.bn.var" in k and not torch.equal(v, torch.ones_like(v)) for k, v in state_a.items())
    assert all(torch.equal(opt_a[i][k], opt_b[i][k]) for i in opt_a for k in opt_a[i])


def test_bayesian_optimization_probes_grl_tpu_points():
    """The same candidates from RandomState(random_state), the same GP and
    expected improvement: the same probes and the same best point."""
    def objective(lambda_value, width):
        return -((lambda_value - 0.37) ** 2) - 0.5 * (width - 0.2) ** 2 + 0.1 * np.sin(9 * lambda_value)

    bounds = {"lambda_value": (0.0, 1.0), "width": (-1.0, 1.0)}
    ours = bayes_opt.BayesianOptimization(objective, bounds, random_state=1234)
    theirs = jax_bayes_opt.BayesianOptimization(objective, bounds, random_state=1234)
    ours.maximize(init_points=3, n_iter=4)
    theirs.maximize(init_points=3, n_iter=4)
    np.testing.assert_array_equal(np.array(ours.X), np.array(theirs.X))
    assert ours.y == theirs.y and ours.max == theirs.max


def test_bayes_training_entry_point_on_the_cpu(tmp_path):
    """python -m grl_torch.bayes_training on a copy of synthetic_kv.yaml at
    one epoch and net_size 16: two probes of RPGraphCNNDropEdge, the best
    printed."""
    with open(REPO / "configs" / "synthetic_kv.yaml") as handle:
        cfg = yaml.safe_load(handle)
    cfg["num_epochs"] = 1
    cfg["model"]["args"]["net_size"] = 16
    cfg["synthetic_data"]["num_pages"] = 16
    path = tmp_path / "synthetic_kv.yaml"
    path.write_text(yaml.safe_dump(cfg))
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    done = subprocess.run([sys.executable, "-m", "grl_torch.bayes_training", "--config", str(path),
                           "--init-points", "1", "--n-iter", "1", "--rp-size", "16", "--device", "cpu"],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    best = [line for line in done.stdout.splitlines() if line.startswith("Best parameters: lambda=")]
    assert len(best) == 1, done.stdout[-2000:]
    lam, f1 = (float(part.split("=")[1]) for part in best[0].split(": ")[1].split())
    assert 0.0 <= lam <= 1.0 and 0.0 <= f1 <= 1.0
    runs = sorted(p.name for p in (tmp_path / "outputs").iterdir() if "bayes-lambda" in p.name)
    assert len(runs) == 2, runs


def test_step_timer_and_trace_window(tmp_path):
    timer = profiling.StepTimer()
    timer.step(nodes=10)
    timer.step(nodes=6, edges=3)
    rates = timer.rates()
    assert set(rates) == {"steps_per_sec", "nodes_per_sec", "edges_per_sec"}
    assert rates["nodes_per_sec"] == pytest.approx(8 * rates["steps_per_sec"])
    with profiling.trace_window(str(tmp_path / "traces"), enabled=False) as path:
        assert path is None
    for index in range(2):
        with profiling.trace_window(str(tmp_path / "traces")) as path:
            torch.ones(64, 64) @ torch.ones(64, 64)
        assert path.endswith(f"trace_{index}.json")
        with open(path) as handle:
            assert json.load(handle)["traceEvents"]


def test_input_casts_match_grl_tpu(tmp_path):
    from PIL import Image

    label = {"text": "a", "box": [1, 2]}
    label_path = tmp_path / "label.json"
    label_path.write_text(json.dumps(label))
    image = (np.arange(24, dtype=np.uint8).reshape(2, 4, 3))
    image_path = tmp_path / "image.png"
    Image.fromarray(image).save(image_path)
    for value in (label, str(label_path), label_path):
        assert input_wrapper.cast_label_to_dict(value) == jax_input_wrapper.cast_label_to_dict(value) == label
    for bad in ([label], 3):
        with pytest.raises(TypeError):
            input_wrapper.cast_label_to_dict(bad)
    for value in (image, Image.fromarray(image), image_path.read_bytes(), str(image_path), image_path):
        np.testing.assert_array_equal(input_wrapper.cast_image_to_array(value), image)
        np.testing.assert_array_equal(input_wrapper.cast_image_to_array(value),
                                      jax_input_wrapper.cast_image_to_array(value))
    with pytest.raises(TypeError):
        input_wrapper.cast_image_to_array(3.5)
    for value in (label, (image, label)):
        ours, theirs = input_wrapper.cast_pair_sample(value), jax_input_wrapper.cast_pair_sample(value)
        np.testing.assert_array_equal(ours[0], theirs[0])
        assert ours[1] == theirs[1] == label


def test_image_cast_without_pillow_raises_type_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(TypeError, match="Pillow"):
        input_wrapper.cast_image_to_array(b"bytes")
    np.testing.assert_array_equal(input_wrapper.cast_image_to_array(np.ones(3)), np.ones(3))


def test_representation_space_plot(data, tmp_path, monkeypatch):
    """The t-SNE plot of the trunk's node embeddings, read through a
    forward hook (the hook removed after); without sklearn a warning and
    None, as grl_tpu."""
    root, files, input_dim = data
    args = {"input_dim": input_dim, "output_dim": C, "num_edges": L, "net_size": 16}
    warper = GNNLearningWarper(config=config(root, files, "tsne", "ModGCN", args, epochs=1), device="cpu")
    proc = warper.trainer
    loader = [next(iter(proc.val_loader))]
    out = proc.visualize_representation_space(loader, str(tmp_path / "space.jpg"))
    assert out == str(tmp_path / "space.jpg") and os.path.getsize(out) > 0
    assert not proc.model.trunk._forward_hooks
    monkeypatch.setitem(sys.modules, "sklearn.manifold", None)
    assert proc.visualize_representation_space(loader) is None
