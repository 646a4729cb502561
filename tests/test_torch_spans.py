"""The training loop's spans (``grl_torch.utils.profiling.span``).

With no ``torch.profiler`` session active a span is one shared null
context, and no profiler range is entered anywhere in a chunk, an
eager step, the per-step lambda, scores and log, or a step checkpoint.
Under the profiler the spans land in the exported Chrome trace as
``cpu_op`` events named ``grl.*``, nested and in call order; the losses and
parameters are the same bits either way. On the card, a replayed chunk's
launch is ``grl.chunk.replay`` inside ``grl.chunk``, and a replayed single
step's graph launch lies inside ``grl.step.replay``.

This file imports neither JAX nor grl_tpu; its ``cuda`` case runs on a
card with::

    python -m pytest --noconftest -q -m cuda tests/test_torch_spans.py
"""
from __future__ import annotations

import json
import os

import pytest
import torch

from grl_torch import models
from grl_torch.data.large_graph import sbm_relational_graph
from grl_torch.data.synthetic import DEFAULT_CLASSES, synthetic_page
from grl_torch.trainer.procedures import FullGraphProcedure, KVProcedure
from grl_torch.utils import profiling
from grl_torch.utils.metric_tracker import Dictlist


@pytest.fixture(scope="module")
def pages(tmp_path_factory):
    """Eight pages of one size: batches of 2, all padded to one shape."""
    root = tmp_path_factory.mktemp("span_pages")
    os.makedirs(root / "train")
    chars = set("0()-.,")
    for i in range(8):
        page = synthetic_page(300 + i, 5, 3)
        chars.update(c for box in page for c in box["text"].lower())
        with open(root / "train" / f"page_{i:04d}.json", "w") as handle:
            json.dump(page, handle)
    with open(root / "classes.json", "w") as handle:
        json.dump({"classes": list(DEFAULT_CLASSES)}, handle)
    with open(root / "charset.json", "w") as handle:
        json.dump({"charset": sorted(chars)}, handle)
    return {"root": str(root), "input_dim": len(chars) + 4, "output_dim": 2 * len(DEFAULT_CLASSES) + 1}


def kv_procedure(pages, out_dir, device="cpu", rates=(0.5, 0.3)):
    split = {
        "data_path": [os.path.join(pages["root"], "train")],
        "class_path": os.path.join(pages["root"], "classes.json"),
        "charset_path": os.path.join(pages["root"], "charset.json"),
        "key_types": ["key", "value"], "batch_size": 2, "shuffle": False, "drop_last": False,
        "data_collate": {"BucketPadding": {"quantum": 32, "only_selected_items": True}},
        "data_process": {"TextlineEncoding": {"is_normalized_text": True},
                         "HeuristicGraphBuilder": {"num_edges": 6, "edge_type": "normal_binary"},
                         "NodeLabeling": {}},
    }
    config = {
        "seed": 5, "output_dir": str(out_dir), "num_epochs": 1, "max_grad_norm": 1.0, "save_interval": 1,
        "scan_steps": 2,
        "data_config": {"dataset": {"type": "CassiaDataset", "args": {"node_label_padding_value": -100}},
                        "training": split, "validation": split},
        "loss": {"type": "CrossEntropyLoss", "args": {}},
        "optimizer": {"type": "BuiltinOptimizer", "args": {"type_optimizer": "Adam", "lr": 1e-2}},
        "logging": {"use_tensorboard": False},
    }
    model = models.create_model("GraphCNNDropEdge", input_dim=pages["input_dim"], output_dim=pages["output_dim"],
                                num_edges=6, net_size=16, dropout_rate=rates[0], edge_dropout_rate=rates[1],
                                kernel_impl="xla", device=device, generator=torch.Generator().manual_seed(1))
    proc = KVProcedure(model, config, device=device)
    proc._ensure_initialized()
    return proc


def kv_round(proc, chunks=1):
    """The KV loop's host work as ``_train_epoch_scanned`` does it: for
    each chunk, each step's lambda, the chunk through ``run_chunk``, each
    step's scores logged and a checkpoint opportunity (``save_interval``
    1: it saves); then one eager leftover step, scored and logged. Returns
    every step's loss."""
    batches = [proc._prepare_batch(batch) for batch in proc.train_loader]
    metrics, losses = Dictlist(), []
    for c in range(chunks):
        items = [(*batches[(2 * c + k) % len(batches)], proc._lambda_value(0)) for k in range(2)]
        chunk_losses, cms = proc.run_chunk(items)
        for loss, cm in zip(chunk_losses, cms):
            proc._log_train_step(proc._scores_from_cm(cm, float(loss)), metrics, proc.global_step)
            losses.append(float(loss))
        proc._maybe_step_checkpoint(0)
    proc._lam.fill_(proc._lambda_value(0))
    loss, cm = proc._train_fn(*batches[-1], proc.rngs, proc._lam)
    proc._log_train_step(proc._scores_from_cm(cm.cpu().numpy(), float(loss)), metrics, proc.global_step)
    return losses + [float(loss)]


def traced(tmp_path, work, prefixes=("grl.",)):
    """``work()`` under ``torch.profiler``; its result and the ``grl.*``
    spans (host events whose names start with one of ``prefixes``) of the
    exported trace as ``(name, start, end)`` in start order (a parent
    before the child that starts with it)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        out = work()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as handle:
        events = json.load(handle)["traceEvents"]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "cuda_runtime")
             and e["name"].startswith(tuple(prefixes))]
    return out, sorted(spans, key=lambda s: (s[1], -s[2]))


def inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


def test_span_without_a_profiler_is_one_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    first, second = profiling.span("grl.a"), profiling.span("grl.b")
    assert first is second
    with first as entered:
        with second:
            assert entered is None


def test_no_record_function_without_a_profiler(pages, tmp_path, monkeypatch):
    proc = kv_procedure(pages, tmp_path)

    def refuse(name, *args):
        raise AssertionError(f"a profiler range {name!r} entered with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    losses = kv_round(proc)
    assert len(losses) == 3 and all(torch.isfinite(torch.tensor(losses)))
    assert os.listdir(proc.model_dir), "the step checkpoint's branch did not run"


def test_spans_nest_and_order_as_the_loop_calls_them(pages, tmp_path):
    proc = kv_procedure(pages, tmp_path)
    _, spans = traced(tmp_path, lambda: kv_round(proc))
    names = [name for name, *_ in spans]
    step = ["grl.step.scores", "grl.step.log"]
    assert names == (["grl.step.lambda"] * 2 + ["grl.chunk", "grl.chunk.load", "grl.chunk.readback"] + step * 2
                     + ["grl.checkpoint", "grl.step.lambda", "grl.step.eager"] + step)
    chunk, load, readback = spans[2:5]
    assert inside(load, chunk) and inside(readback, chunk) and load[2] <= readback[1]
    assert all(not inside(s, chunk) for s in spans if not s[0].startswith("grl.chunk"))


def test_full_graph_eval_is_a_span(tmp_path):
    data = sbm_relational_graph(num_nodes=60, num_classes=3, num_relations=1, avg_degree=3, feature_dim=8)
    model = models.create_model("GraphCNNDropEdge", input_dim=8, output_dim=3, num_edges=1, net_size=16,
                                use_attention=False, kernel_impl="xla", device="cpu",
                                generator=torch.Generator().manual_seed(0))
    proc = FullGraphProcedure(model, {"seed": 0, "output_dir": str(tmp_path), "scan_steps": 2,
                                      "logging": {"use_tensorboard": False}}, data=data, device="cpu")
    proc._ensure_initialized()

    def work():
        proc.train_steps(2)
        return float(proc.eval_step(proc.val_labels))

    accuracy, spans = traced(tmp_path, work)
    assert [name for name, *_ in spans] == ["grl.eval"] and 0.0 <= accuracy <= 1.0


def test_the_profiler_changes_no_bit(pages, tmp_path):
    """Dropout and DropEdge on, so every mask's draw is compared too."""
    plain, profiled = kv_procedure(pages, tmp_path / "plain"), kv_procedure(pages, tmp_path / "profiled")
    want = kv_round(plain, chunks=2)
    got, spans = traced(tmp_path, lambda: kv_round(profiled, chunks=2))
    assert spans and got == want
    for (name, a), b in zip(plain.model.state_dict().items(), profiled.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_single_steps_off_the_card_run_the_eager_step(pages, tmp_path):
    """Where chunks are not captured (the CPU), ``_train_fn`` is the eager
    step: the losses and parameters of the step body run by hand, bit for
    bit, every step counted as eager, no one-step graph and no static
    inputs."""
    proc, plain = kv_procedure(pages, tmp_path / "a"), kv_procedure(pages, tmp_path / "b")
    assert not proc.captures
    batches = [proc._prepare_batch(batch) for batch in proc.train_loader]
    body = plain.build_train_body(plain.num_classes, plain._ignore)
    for V, A, labels in batches[:3]:
        proc._lam.fill_(0.25)
        loss, cm = proc._train_fn(V, A, labels, proc.rngs, proc._lam)
        plain._lam.fill_(0.25)
        want_loss, want_cm = body(V, A, labels, plain.rngs, plain._lam)
        assert torch.equal(loss, want_loss) and torch.equal(cm, want_cm)
    for (name, a), b in zip(proc.model.state_dict().items(), plain.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert dict(proc.single_steps) == {"eager": 3} and proc.state.step == 3
    assert not proc.step_runner().graphs and not proc.step_runner().setup and not proc._slots


@pytest.mark.cuda
def test_a_replayed_single_step_launches_inside_its_replay_span(pages, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a single step is a CUDA-graph replay only there")
    proc = kv_procedure(pages, tmp_path, device="cuda", rates=(0.0, 0.0))
    kv_round(proc, chunks=2)  # the chunk's warm-up, capture and replay; the step's warm-up and recording
    assert dict(proc.single_steps) == {"eager": 1, "recorded": 1}
    _, spans = traced(tmp_path, lambda: kv_round(proc), prefixes=("grl.", "cudaGraphLaunch"))
    assert dict(proc.single_steps) == {"eager": 1, "recorded": 1, "replayed": 1}
    names = [name for name, *_ in spans]
    assert "grl.step.eager" not in names and names.count("grl.step.replay") == 1
    replay = next(s for s in spans if s[0] == "grl.step.replay")
    launched = [s for s in spans if s[0] == "cudaGraphLaunch" and inside(s, replay)]
    assert len(launched) == 1 and proc.step_runner().replays == 1


@pytest.mark.cuda
def test_a_replayed_chunk_launches_inside_its_replay_span(pages, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a chunk is a CUDA-graph replay only there")
    proc = kv_procedure(pages, tmp_path, device="cuda", rates=(0.0, 0.0))
    kv_round(proc, chunks=2)  # the warm-up chunk, then the capture and its replay
    replays = proc.chunk_runner().replays
    _, spans = traced(tmp_path, lambda: kv_round(proc, chunks=2))
    assert proc.chunk_runner().replays == replays + 2
    chunks = [s for s in spans if s[0] == "grl.chunk"]
    launched = [s for s in spans if s[0] == "grl.chunk.replay"]
    assert len(chunks) == len(launched) == 2
    assert all(inside(r, c) for r, c in zip(launched, chunks))
    loads = [s for s in spans if s[0] == "grl.chunk.load"]
    assert all(load[2] <= r[1] for load, r in zip(loads, launched))
