"""grl_torch stands alone: no JAX, no grl_tpu, and no quiet CPU fallback.

Subprocesses block ``jax`` and ``grl_tpu`` (``sys.modules[name] = None``
makes any import of them fail), then import grl_torch and serve one page,
or take one train step, on ``device="cpu"``. A scan of the sources finds
no import of either package in grl_torch/ or chip_smoke.py.
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
    from grl_torch.ops.relagg import neighbor_aggregate

    V = torch.zeros(1, 4, 8, device="meta")
    A = torch.zeros(1, 4, 6, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        neighbor_aggregate(V, A)
