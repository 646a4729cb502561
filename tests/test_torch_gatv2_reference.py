"""The port's ``GATV2`` (GATv2 layers) against the benchmark's plain
reference, ``portbench/reference/gatv2.py``, on seeded random weights at a
small size (B 2, N 16, input 40, 6 relations; every width inside the
network as published): the eval logits, the train-mode loss and every
gradient with dropout on (the reference redraws the program's masks from
its seed), and two clipped Adam steps through the KV procedure's train
step (``BaseProcedure.build_train_step``, which ``KVProcedure`` runs).
Held within 1e-5 of scale: both sides compute in float32 and differ in the
order of their sums (LayerNorm's statistics, the clip's norm). Adam's eps
is 1e-3 on both sides in the step test, as in
``tests/test_torch_zoo_models.py``: many gradient entries are of the order
of 1e-8, where Adam at eps 1e-8 turns a rounding of the gradient into a
sizeable share of ``lr``.

The ``cuda`` case holds a chunk replayed from its CUDA graph to the same
chunk run eagerly, bit for bit, and D's launch counts of the replay to
what it ran.

This file imports neither JAX nor grl_tpu.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from grl_torch.models import Rngs, create_model
from grl_torch.ops import launches
from grl_torch.trainer.procedures import BaseProcedure
from portbench.harness.weights import make_weights
from portbench.reference import gatv2 as reference

B, N, L, FIN, C = 2, 16, 6, 40, 7
MODEL = {"input_feature": FIN, "no_A": L, "output_feature": 128, "num_classes": C, "use_v2": True}
LR, EPS, MAX_GRAD_NORM, SEED = 1e-3, 1e-3, 5.0, 0
BRANCHES = 5 * (L + 1)  # five GAT layers of L relations and the identity


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def batch(seed, device="cpu"):
    rng = np.random.RandomState(seed)
    V = rng.randn(B, N, FIN).astype(np.float32)
    A = (rng.rand(B, N, L, N) < 0.15).astype(np.float32)
    labels = rng.randint(0, C, (B, N))
    labels[rng.rand(B, N) < 0.3] = -100
    labels[:, -3:] = -100  # padded rows
    V[:, -3:] = 0.0
    A[:, -3:] = 0.0
    A[:, :, :, -3:] = 0.0
    return tuple(torch.as_tensor(a, device=device) for a in (V, A, labels))


def port_and_weights(device="cpu", **model):
    args = {**MODEL, **model}
    weights = make_weights(torch, reference.leaves(args), 2**31 + 5, device)
    net = create_model("GATV2", **args, device=device)
    net.load_state_dict(weights, strict=True)
    return net, weights


def assert_close(got, expected, what, scale=None):
    got, expected = got.detach().double().cpu(), expected.detach().double().cpu()
    assert got.shape == expected.shape, what
    scale = scale if scale is not None else max(float(expected.abs().max()), 1e-30)
    err = float((got - expected).abs().max())
    assert err <= 1e-5 * scale, (what, err, scale)


def test_leaves_are_the_state_dict():
    net, weights = port_and_weights()
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == {
        name: shape for name, shape, _ in reference.leaves(MODEL)}


def test_leaves_at_the_benchmarks_published_widths():
    """The benchmark's configuration (4369 in, 6 relations, 53 classes):
    the port builds exactly the reference's leaves."""
    import json
    from pathlib import Path

    config = json.loads((Path(__file__).resolve().parents[1] / "portbench/configs/gatv2_sumi_kv.json").read_text())
    model = {k: v for k, v in config["model"].items() if k != "type"}
    net = create_model(config["model"]["type"], **model, device="cpu")
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == {
        name: shape for name, shape, _ in reference.leaves(model)}


def test_eval_logits_match_the_reference():
    net, weights = port_and_weights()
    V, A, _ = batch(1)
    net.eval()
    with torch.no_grad():
        got = net((V, A))
    want = reference.network(MODEL).forward(weights, V, A, None)
    assert_close(got, want, "eval logits")


def test_loss_and_every_gradient_with_dropout_on():
    net, weights = port_and_weights()
    V, A, labels = batch(2)
    net.train()
    logits = net((V, A), rngs=Rngs.from_seed(SEED, torch.device("cpu")))
    loss = reference.masked_cross_entropy(logits, labels)
    loss.backward()
    params = {k: v.clone().requires_grad_() for k, v in weights.items()}
    draws = reference.Draws(SEED, "cpu")
    want_logits = reference.network(MODEL).forward(params, V, A, draws)
    want = reference.masked_cross_entropy(want_logits, labels)
    want.backward()
    assert_close(logits, want_logits, "train logits")
    assert abs(float(loss.detach()) - float(want.detach())) <= 1e-5 * abs(float(want.detach()))
    grads = dict(net.named_parameters())
    scale = max(float(p.grad.abs().max()) for p in params.values())
    for name, p in params.items():
        assert grads[name].grad is not None, name
        assert_close(grads[name].grad, p.grad, f"gradient of {name}", scale)
    # The reference drew the seeds the program drew: two a branch.
    fresh = Rngs.from_seed(SEED, torch.device("cpu"))
    for _ in range(2 * BRANCHES):
        fresh.kernel_seed()
    assert torch.equal(draws.generator.get_state(), fresh.device.get_state())


def test_two_clipped_adam_steps_through_the_kv_step(tmp_path, monkeypatch):
    from portbench.reference import flagship

    monkeypatch.setattr(flagship, "ADAM_EPS", EPS)
    net, weights = port_and_weights()
    config = {"output_dir": str(tmp_path), "seed": SEED, "max_grad_norm": MAX_GRAD_NORM,
              "optimizer": {"type": "BuiltinOptimizer", "args": {"type_optimizer": "Adam", "lr": LR, "eps": EPS}},
              "loss": {"type": "CrossEntropyLoss", "args": {}}, "logging": {"use_tensorboard": False}}
    proc = BaseProcedure(net, config, device="cpu")
    proc.init_state()
    step = proc.build_train_step(C, (-100,))
    batches = [batch(3), batch(4)]
    losses = [float(step(V, A, labels, proc.rngs, 1.0)[0]) for V, A, labels in batches]
    want = reference.train_steps(reference.network(MODEL), weights, batches, reference.Draws(SEED, "cpu"),
                                 lr=LR, max_grad_norm=MAX_GRAD_NORM)
    np.testing.assert_allclose(losses, want.losses, rtol=1e-5)
    scale = max(float(v.abs().max()) for v in want.params.values())
    for name, p in net.named_parameters():
        assert_close(p, want.params[name], f"{name} after two steps", scale)
    assert torch.equal(proc.rngs.device.get_state(), want.draws_state)


def test_reference_refuses_gat_v1_layers():
    with pytest.raises(ValueError, match="use_v2"):
        reference.network({**MODEL, "use_v2": False})


@pytest.mark.cuda
@pytest.mark.parametrize("batch_size, nodes, width, scan", [(2, 64, 40, 2), (8, 256, 4369, 4)],
                         ids=["small", "sumi"])
def test_replayed_chunk_equals_the_eager_chunk(tmp_path, batch_size, nodes, width, scan):
    """KVProcedure's chunks of ``scan`` steps on the card (small, and at the
    sumi widths: 8 pages at N = 256, input 4369, chunks of 4): the warm-up
    eager, the second captured and replayed; a replayed chunk and the same
    chunk run eagerly from the same state (parameters, gradients, Adam's
    state, generator) agree bit for bit: losses, confusion matrices,
    parameters, gradients, Adam's state and the generator. Each replay
    counts D's launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs and the D kernel run only there")
    from grl_torch.data.synthetic import synthetic_dataset_files
    from grl_torch.trainer.procedures import KVProcedure

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data_dir, classes_path, charset_path = synthetic_dataset_files(str(tmp_path), num_pages=8, seed=4)
    split = {"data_path": [data_dir], "class_path": classes_path, "charset_path": charset_path,
             "key_types": ["key", "value"], "batch_size": batch_size, "shuffle": False, "drop_last": False,
             "data_collate": {"BucketPadding": {"quantum": 64, "only_selected_items": True}},
             "data_process": {"TextlineEncoding": {}, "HeuristicGraphBuilder": {}, "NodeLabeling": {}}}
    config = {"seed": 0, "output_dir": str(tmp_path / "out"), "num_epochs": 1, "max_grad_norm": MAX_GRAD_NORM,
              "scan_steps": scan, "optimizer": {"type": "BuiltinOptimizer",
                                                "args": {"type_optimizer": "Adam", "lr": LR}},
              "data_config": {"dataset": {"type": "CassiaDataset", "args": {}}, "training": split,
                              "validation": split},
              "logging": {"use_tensorboard": False}}
    classes = 53
    net = create_model("GATV2", **{**MODEL, "input_feature": width, "num_classes": classes}, device="cuda")
    proc = KVProcedure(net, config, device="cuda")
    rng = np.random.RandomState(7)
    items = []
    for k in range(scan):
        V = torch.as_tensor(rng.randn(batch_size, nodes, width).astype(np.float32))
        A = torch.as_tensor((rng.rand(batch_size, nodes, L, nodes) < 0.02).astype(np.float32))
        labels = torch.as_tensor(rng.randint(0, classes, (batch_size, nodes)))
        labels[:, nodes - nodes // 8:] = -100
        items.append((V, A, labels, 0.5))
    proc.run_chunk(items)  # the warm-up, eager
    proc.run_chunk(items)  # the capture and its first replay
    runner = proc.chunk_runner()
    assert runner.replays == 1 and len(runner.graphs) == 1
    params, optimizer = list(net.parameters()), proc.state.optimizer
    graph_grads = [p.grad for p in params]  # the graph's outputs, which every replay rewrites

    def state(grads):
        tensors = list(net.state_dict().values()) + list(grads)
        return tensors + [v for s in optimizer.state.values() for v in s.values() if isinstance(v, torch.Tensor)]

    held = [t.clone() for t in state(graph_grads)]
    generator, step = proc.rngs.device.get_state(), proc.state.step
    eager_losses, eager_cms = (t.clone() for t in runner.eager(proc.load_chunk(items)[1]))
    eager = [t.clone() for t in state([p.grad for p in params])]
    eager_draws = proc.rngs.device.get_state()
    with torch.no_grad():
        for tensor, copy in zip(state(graph_grads), held):
            tensor.copy_(copy)
    proc.rngs.device.set_state(generator)
    proc.state.step = step
    before = launches.device_counts()
    losses, cms = proc.run_chunk(items)
    counted = launches.device_counts() - before
    assert runner.replays == 2
    assert np.all(np.isfinite(losses)) and int(cms.sum()) > 0
    assert np.array_equal(losses, eager_losses.cpu().numpy()) and np.array_equal(cms, eager_cms.cpu().numpy())
    assert all(torch.equal(a, b) for a, b in zip(state(graph_grads), eager))
    assert torch.equal(proc.rngs.device.get_state(), eager_draws)
    assert counted["D forward"] == scan * 2 * BRANCHES and counted["D backward"] == scan * (2 * BRANCHES - (L + 1))
