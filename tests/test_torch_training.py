"""End to end on the CPU: the port trains, checkpoints, resumes and serves.

``GNNLearningWarper(config).train()`` runs ``KVProcedure`` on 16
synthetic pages at ``net_size=32`` for two epochs, with
``kernel_impl: pallas`` and DropEdge and dropout on (on the CPU the
kernels' wrappers take their plain versions, with the same hash mask).
The run is checked as tests/test_trainer.py checks grl_tpu's: the loss
falls, the experiment series holds the reference's channels, and the
checkpoint it writes restores model, optimizer and step exactly and is
served by the port's KVInference.
"""
from __future__ import annotations

import json
import os
import re

import pytest
import torch

from grl_tpu.data.synthetic import synthetic_dataset_files, synthetic_page
from grl_torch import GNNLearningWarper
from grl_torch.ops import launches, relagg
from grl_torch.trainer import lr_schedulers
from grl_torch.utils.checkpoint import CheckpointHandler


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite spreads files over worker processes on shared cores: one
    intra-op thread per worker keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


EPOCHS, BATCH = 2, 4


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    data_dir, classes_path, charset_path = synthetic_dataset_files(str(root), num_pages=16, seed=0)
    with open(charset_path) as handle:
        input_dim = len(json.load(handle)["charset"]) + 4
    split = {
        "data_path": [data_dir], "class_path": classes_path, "charset_path": charset_path,
        "key_types": ["key", "value"], "batch_size": BATCH, "shuffle": True, "drop_last": False,
        "data_collate": {"BucketPadding": {"quantum": 64, "only_selected_items": True}},
        "data_process": {
            "TextlineEncoding": {"is_normalized_text": True},
            "HeuristicGraphBuilder": {"num_edges": 6, "edge_type": "normal_binary"},
            "NodeLabeling": {},
        },
    }
    steps = EPOCHS * 16 // BATCH
    config = {
        "experiment_name": "train", "seed": 0, "is_train": True, "output_dir": str(root / "out"),
        "num_epochs": EPOCHS, "max_grad_norm": 5.0, "save_interval": steps,
        "model": {"type": "GraphCNNDropEdge", "args": {
            "input_dim": input_dim, "output_dim": 15, "num_edges": 6, "net_size": 32,
            "kernel_impl": "pallas", "dropout_rate": 0.5, "edge_dropout_rate": 0.3,
        }},
        "data_config": {
            "dataset": {"type": "CassiaDataset", "args": {"node_label_padding_value": -100}},
            "training": split, "validation": dict(split, shuffle=False),
        },
        "procedure": {"type": "KVProcedure", "args": {}},
        "loss": {"type": "CrossEntropyLoss", "args": {}},
        "optimizer": {"type": "BuiltinOptimizer", "args": {"type_optimizer": "Adam", "lr": 0.01}},
        "lr_scheduler": {"type": "DecayLearningRate", "args": {"lr": 0.01, "factor": 0.9, "num_epochs": 60}},
        "logging": {"use_tensorboard": False, "profile": {"start_step": 1, "num_steps": 1}},
    }
    warper = GNNLearningWarper(config=config, device="cpu")
    f1 = warper.train()
    return {"warper": warper, "config": config, "f1": f1, "steps": steps, "classes": classes_path,
            "charset": charset_path, "input_dim": input_dim}


def series(trained):
    path = os.path.join(trained["warper"].config["output_dir"], "experiment_series.jsonl")
    with open(path) as handle:
        return [json.loads(line) for line in handle]


def test_training_learns_and_logs(trained):
    records = series(trained)
    losses = [r["value"] for r in records if r["path"] == "Train/step_loss"]
    assert len(losses) == trained["steps"]
    assert all(loss == loss for loss in losses)
    per_epoch = len(losses) // EPOCHS
    assert sum(losses[-per_epoch:]) / per_epoch < 0.9 * losses[0], losses
    paths = {r["path"] for r in records}
    assert {"Train/step_loss", "RP/Lambda", "Train/nodes_per_sec"} <= paths
    assert any(p.startswith("Validation/") for p in paths)
    assert any(p.startswith("Macro Validation/") for p in paths)
    assert 0.0 <= trained["f1"] <= 1.0
    # The schedule wrote the last epoch's rate into the optimizer.
    lr = trained["warper"].trainer.state.optimizer.param_groups[0]["lr"]
    assert lr == lr_schedulers.DecayLearningRate(0.01, 0.9, 60)(EPOCHS - 1)
    # The configured profile window wrote a torch.profiler trace.
    traces = os.path.join(trained["warper"].config["output_dir"], "traces")
    assert os.listdir(traces) == ["steps_1_2.json"]


def test_resume_restores_model_optimizer_and_step(trained):
    trainer = trained["warper"].trainer
    path = os.path.join(trainer.model_dir, CheckpointHandler.LATEST)
    raw = CheckpointHandler().restore_checkpoint(path)
    assert set(raw) == {"model", "optimizer", "step"} and raw["step"] == trained["steps"]
    resumed = GNNLearningWarper(
        config={**trained["config"], "resume": True},
        device="cpu",
    ).trainer
    resumed._ensure_initialized()
    assert resumed.state.step == trained["steps"] and resumed.global_step == trained["steps"]
    for name, value in trainer.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], value), name
    before, after = trainer.state.optimizer.state_dict(), resumed.state.optimizer.state_dict()
    assert before["param_groups"] == after["param_groups"]
    for index, entry in before["state"].items():
        for key, value in entry.items():
            assert torch.equal(after["state"][index][key], value), (index, key)


# (BucketPadding, model args, the refusal expected or None)
PADDING_CASES = {
    "bf16 quantum 64": ({"quantum": 64}, {"compute_dtype": "bfloat16"}, None),
    "bf16 quantum 60": ({"quantum": 60}, {"compute_dtype": "bfloat16"}, "N % 8 == 0 (got N=60)"),
    "bf16 bucket 100": ({"quantum": 64, "buckets": [100, 192]}, {"compute_dtype": "bfloat16"}, "N % 8 == 0 (got N=100)"),
    "bf16 width 36": ({"quantum": 64}, {"compute_dtype": "bfloat16", "net_size": 36}, "F % 8 == 0 (got F=36)"),
    "f32 quantum 60": ({"quantum": 60}, {}, None),
    "bf16 quantum 60 without DropEdge": ({"quantum": 60}, {"compute_dtype": "bfloat16", "edge_dropout_rate": 0.0}, None),
    # No BucketPadding: N is whatever a batch's pages give, so nothing can
    # be checked at set-up.
    "bf16 no BucketPadding": (None, {"compute_dtype": "bfloat16"}, "needs BucketPadding in the training data_collate"),
    "f32 no BucketPadding": (None, {}, None),
}


@pytest.mark.parametrize("case", sorted(PADDING_CASES))
def test_procedure_refuses_padding_bf16_dropedge_cannot_take(trained, tmp_path, case):
    """bf16 K1/K2 (kernel_impl: pallas with DropEdge) read through TMA and
    need N % 8 == 0 and F % 8 == 0: a config whose BucketPadding or widths
    break that fails when the procedure is set up, not at its first step on
    the card. So does one with no BucketPadding to check."""
    padding, model_args, refusal = PADDING_CASES[case]
    config = dict(trained["config"], output_dir=str(tmp_path))
    config["model"] = dict(config["model"], args={**config["model"]["args"], **model_args})
    collate = {} if padding is None else {"BucketPadding": {**padding, "only_selected_items": True}}
    split = dict(config["data_config"]["training"], data_collate=collate)
    config["data_config"] = dict(config["data_config"], training=split, validation=dict(split, shuffle=False))
    if refusal is None:
        GNNLearningWarper(config=config, device="cpu")
        return
    with pytest.raises(ValueError, match=re.escape(refusal)):
        GNNLearningWarper(config=config, device="cpu")


def test_checkpoint_serves_through_kv_inference(trained):
    trainer = trained["warper"].trainer
    args = dict(trained["config"]["model"]["args"])
    config = {
        "experiment_name": "serve", "is_train": False, "output_dir": trained["config"]["output_dir"],
        "checkpoint_path": os.path.join(trainer.model_dir, CheckpointHandler.LATEST),
        "model": {"type": "GraphCNNDropEdge", "args": args},
        "procedure": {"type": "KVInference", "args": {"batch_size": 2}},
        "inference_settings": {"datasets": {"type": "CassiaDataset", "args": {
            "charset_path": trained["charset"], "class_path": trained["classes"],
            "key_types": ["key", "value"],
            "data_process": {"TextlineEncoding": {"is_normalized_text": True},
                             "HeuristicGraphBuilder": {"num_edges": 6, "edge_type": "normal_binary"}},
        }}},
    }
    served = GNNLearningWarper(config=config, device="cpu")
    for name, value in trainer.model.state_dict().items():
        assert torch.equal(served.model.state_dict()[name], value), name
    pages = [[{"location": b["location"], "text": b["text"]} for b in synthetic_page(90 + i)] for i in range(3)]
    before = launches.device_counts()
    out = served.predict(pages)
    assert launches.device_counts() == before  # CPU tensors: plain version, never a launch
    assert [len(p) for p in out] == [len(p) for p in pages]
    assert all(0.0 < box["confidence"] <= 1.0 for page in out for box in page)


# ---------------------------------------------------------------------------
# chip_smoke.py's kernel-versus-plain step limits, on a small model: on the
# CPU both runs take the plain versions, and one of them has a fault or a
# last-bit rounding difference put into K1's or K2's plain version.
def _flip_last_bits(fn, share, ulp=2.0 ** -8):
    def flipped(X, A, seed, rate):
        out = fn(X, A, seed, rate)
        flip = torch.rand(out.shape, generator=torch.Generator().manual_seed(int(seed))) < share
        return torch.where(flip, out.float() * (1 + ulp), out.float()).to(out.dtype)
    return flipped


def _other_seed(fn):
    return lambda X, A, seed, rate: fn(X, A, seed + 1, rate)


def _other_rate(fn):
    return lambda X, A, seed, rate: fn(X, A, seed, 0.25)


STEP_CASES = {
    # name: (which plain version, its change, whether the limits hold it)
    "k1_last_bits": ("_dropedge_forward", lambda fn: _flip_last_bits(fn, 0.005), True),
    "k2_last_bits": ("dropedge_aggregate_grad", lambda fn: _flip_last_bits(fn, 0.05), True),
    "k1_other_seed": ("_dropedge_forward", _other_seed, False),
    "k2_other_seed": ("dropedge_aggregate_grad", _other_seed, False),
    "k2_other_rate": ("dropedge_aggregate_grad", _other_rate, False),
}


def _two_small_steps(chip_smoke, dtype, swap=None):
    from grl_torch.models import Rngs, create_model
    from grl_torch.trainer.procedures import BaseProcedure

    B, N, L, D, C = 4, 64, 6, 300, 53
    g = torch.Generator().manual_seed(0)
    V = (torch.rand(B, N, D, generator=g) < 0.02).to(dtype)
    A = (torch.rand(B, N, L, N, generator=g) < 0.05).to(dtype)
    labels = torch.randint(0, C, (B, N), generator=g)
    model = create_model(
        "GraphCNNDropEdge", input_dim=D, output_dim=C, num_edges=L, net_size=64,
        kernel_impl="pallas", compute_dtype=str(dtype).split(".")[-1], dropout_rate=0.0,
        edge_dropout_rate=chip_smoke.RATE, device="cpu", generator=torch.Generator().manual_seed(0),
    )
    config = {"max_grad_norm": 5.0, "logging": {"use_tensorboard": False}, "optimizer": {
        "type": "BuiltinOptimizer", "args": {"type_optimizer": "Adam", "lr": chip_smoke.STEP_LR}}}
    procedure = BaseProcedure(model, config, device="cpu")
    procedure.init_state()
    step = procedure.build_train_step(C, (-100,))
    rngs = Rngs.from_seed(7, torch.device("cpu"))
    losses, snapshots, grads = [], [chip_smoke.params_of(model)], []
    saved = {name: getattr(relagg, name) for name in ("_dropedge_forward", "dropedge_aggregate_grad")}
    if swap is not None:
        name, change = swap
        plain = {"_dropedge_forward": relagg.dropedge_aggregate_reference,
                 "dropedge_aggregate_grad": relagg.dropedge_aggregate_grad_reference}[name]
        setattr(relagg, name, change(plain))
    try:
        for v, a, l in ((V, A, labels), (V.flip(0), A.flip(0), labels.flip(0))):
            losses.append(float(step(v, a, l, rngs, 1.0)[0]))
            snapshots.append(chip_smoke.params_of(model))
            grads.append({n: p.grad.float().clone() for n, p in model.named_parameters()})
    finally:
        for name, fn in saved.items():
            setattr(relagg, name, fn)
    return losses, snapshots, grads


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_limits(tmp_path, monkeypatch, case):
    """The bfloat16 limits pass last-bit rounding differences in either
    kernel (at rates far above what a different summation order gives) and
    fail a kernel whose mask or rate is wrong."""
    import chip_smoke

    monkeypatch.chdir(tmp_path)
    name, change, holds = STEP_CASES[case]
    plain = _two_small_steps(chip_smoke, torch.bfloat16)
    rows = chip_smoke.compare_steps(_two_small_steps(chip_smoke, torch.bfloat16, (name, change)), plain)
    failed = chip_smoke.step_failures(rows, chip_smoke.STEP_LIMITS["bfloat16"])
    assert (not failed) == holds, rows


F32_STEP_CASES = {
    # name: (which plain version, its change, whether the limits hold it)
    "k1_last_bits": ("_dropedge_forward", lambda fn: _flip_last_bits(fn, 0.5, 2.0 ** -23), True),
    "k2_last_bits": ("dropedge_aggregate_grad", lambda fn: _flip_last_bits(fn, 0.5, 2.0 ** -23), True),
    "k1_other_seed": ("_dropedge_forward", _other_seed, False),
    "k2_other_seed": ("dropedge_aggregate_grad", _other_seed, False),
    "k2_other_rate": ("dropedge_aggregate_grad", _other_rate, False),
}


@pytest.mark.parametrize("case", sorted(F32_STEP_CASES))
def test_float32_step_limits(tmp_path, monkeypatch, case):
    """The float32 limits (the full-graph float32 limits) pass a float32
    last-bit difference in half of either kernel's outputs and fail a
    kernel whose mask or rate is wrong."""
    import chip_smoke

    monkeypatch.chdir(tmp_path)
    name, change, holds = F32_STEP_CASES[case]
    plain = _two_small_steps(chip_smoke, torch.float32)
    rows = chip_smoke.compare_steps(_two_small_steps(chip_smoke, torch.float32, (name, change)), plain)
    failed = chip_smoke.step_failures(rows, chip_smoke.STEP_LIMITS["float32"])
    assert (not failed) == holds, rows


@pytest.mark.parametrize("grads, apart, holds", [
    # One entry whose gradients sit under Adam's eps (as an H100 run found:
    # 3.0e-9 and 7.5e-9) ends 0.635 lr apart: the share alone holds it.
    ((3.0e-9, 7.5e-9), 0.635, True),
    # The same gap where both gradients are well above eps fails.
    ((1e-3, 1e-3), 0.635, False),
    ((1e-3, 1e-3), 0.2, False),
    # A held entry a hundredth of lr apart passes.
    ((1e-3, 1e-3), 0.01, True),
])
def test_float32_limits_hold_entries_by_their_gradients(grads, apart, holds):
    """compare_steps' held entries: the float32 limits hold the largest
    difference and the entries lr/10 apart only where the gradient is at
    least HELD_GRAD in both paths at every step."""
    import chip_smoke

    lr, n = chip_smoke.STEP_LR, 20000
    initial = {"w": torch.zeros(n)}
    initial["w"][0] = 1.0  # the largest parameter, the scale
    moved = {"w": initial["w"] - 2 * lr}
    shifted = {"w": moved["w"].clone()}
    shifted["w"][7] += apart * lr
    grad = {"w": torch.full((n,), 1e-2)}

    def with_entry(value):
        out = {"w": grad["w"].clone()}
        out["w"][7] = value
        return out

    plain = ([1.0, 0.9], [initial, {"w": (initial["w"] + moved["w"]) / 2}, moved], [with_entry(grads[0])] * 2)
    kernel = ([1.0, 0.9], [initial, {"w": (initial["w"] + shifted["w"]) / 2}, shifted], [with_entry(grads[1])] * 2)
    rows = chip_smoke.compare_steps(kernel, plain)
    assert (not chip_smoke.step_failures(rows, chip_smoke.STEP_LIMITS["float32"])) == holds, rows
