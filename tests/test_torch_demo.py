"""The port's entry points, ``python -m grl_torch.demo_training`` and
``python -m grl_torch.demo_inference``, on the CPU: the demo pair on
configs/synthetic_kv.yaml and configs/synthetic_kv_infer.yaml run in a
subprocess from a scratch working directory (the configs' outputs are
relative to it); the synthetic-data patch equals scripts/demo_training.py's;
with no GPU and no ``--device`` the entry points stop naming the flag."""
from __future__ import annotations

import filecmp
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from grl_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parent.parent


def run(module: str, *args: str, cwd: Path) -> subprocess.CompletedProcess:
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    return subprocess.run([sys.executable, "-m", module, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=600)


def test_demo_training_then_inference_on_the_cpu(tmp_path):
    """One epoch on the generated synthetic pages writes the checkpoint the
    inference config reads; inference annotates every box of a page."""
    trained = run("grl_torch.demo_training", "--config", str(REPO / "configs" / "synthetic_kv.yaml"),
                  "--epochs", "1", "--device", "cpu", cwd=tmp_path)
    assert trained.returncode == 0, trained.stderr[-4000:]
    assert "final macro F1:" in trained.stdout
    assert (tmp_path / "outputs" / "synthetic-kv" / "models" / "model_latest").exists()

    from grl_torch.data.synthetic import synthetic_page

    page = [{"location": box["location"], "text": box["text"]} for box in synthetic_page(2)]
    (tmp_path / "page.json").write_text(json.dumps(page))
    inferred = run("grl_torch.demo_inference", "--config", str(REPO / "configs" / "synthetic_kv_infer.yaml"),
                   "--input", "page.json", "--output", "out.json", "--device", "cpu", cwd=tmp_path)
    assert inferred.returncode == 0, inferred.stderr[-4000:]
    assert "wrote out.json" in inferred.stdout
    boxes = json.loads((tmp_path / "out.json").read_text())
    assert len(boxes) == len(page)
    for box, raw in zip(boxes, page):
        assert box["text"] == raw["text"] and {"key_type", "formal_key", "confidence"} <= set(box)
        assert 0.0 <= box["confidence"] <= 1.0


def test_synthetic_patch_equals_scripts_demo_training(tmp_path):
    """maybe_generate_synthetic writes the same files and patches the same
    keys (paths, input_dim) as scripts/demo_training.py's."""
    from grl_torch.config import load_config
    from grl_torch.demo_training import maybe_generate_synthetic
    from grl_tpu.config import load_config as jax_load_config

    spec = importlib.util.spec_from_file_location("jax_demo_training", REPO / "scripts" / "demo_training.py")
    jax_demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_demo)
    yaml = REPO / "configs" / "synthetic_kv.yaml"
    ours, theirs = load_config(str(yaml)), jax_load_config(str(yaml))
    ours["output_dir"], theirs["output_dir"] = str(tmp_path / "port"), str(tmp_path / "jax")
    ours, theirs = maybe_generate_synthetic(ours), jax_demo.maybe_generate_synthetic(theirs)
    assert ours.model.args["input_dim"] == theirs.model.args["input_dim"] > 4
    for split in ("training", "validation"):
        mine, want = ours.data_config[split], theirs.data_config[split]
        for key in ("data_path", "class_path", "charset_path"):
            expected = want[key]
            expected = [p.replace("jax", "port") for p in expected] if isinstance(expected, list) \
                else expected.replace("jax", "port")
            assert mine[key] == expected
    port_dir, jax_dir = tmp_path / "port" / "synthetic_data", tmp_path / "jax" / "synthetic_data"
    compared = filecmp.dircmp(port_dir, jax_dir)
    assert not compared.left_only and not compared.right_only and not compared.diff_files
    for sub in compared.common_dirs:
        inner = filecmp.dircmp(port_dir / sub, jax_dir / sub)
        assert not inner.diff_files and not inner.left_only and not inner.right_only and inner.same_files
    # A config with data paths, or no synthetic_data block, is left as it is.
    again = maybe_generate_synthetic(ours)
    assert again.data_config.training.data_path == ours.data_config.training.data_path
    plain = load_config(str(REPO / "configs" / "arxiv_full_graph.yaml"))
    assert maybe_generate_synthetic(plain).to_dict() == load_config(str(REPO / "configs" / "arxiv_full_graph.yaml")).to_dict()


def test_entry_points_need_a_gpu_or_the_device_flag(monkeypatch, tmp_path):
    from grl_torch import demo_inference, demo_training

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        demo_training.main(["--config", str(REPO / "configs" / "synthetic_kv.yaml")])
    with pytest.raises(RuntimeError, match="--device cpu"):
        demo_inference.main(["--config", str(REPO / "configs" / "synthetic_kv_infer.yaml"), "--input", "x.json"])
    assert resolve_device("cpu", flag="--device cpu") == torch.device("cpu")
