"""The port's trainer against grl_tpu's: losses, metrics, schedules,
optimizer semantics, and whole train steps.

The train-step tests give both packages the same flax variables (carried
across by ``state_dict_from_flax``) and the same numpy batches, with
dropout and DropEdge off, in float32, and a ``max_grad_norm`` small enough
that clipping binds. The second step starts from grl_tpu's state after the
first, optimizer state included, carried across by
``optimizer_state_from_optax``. Both sides compute in float32 and differ
in summation order only, so loss and parameters agree to 1e-5 of their
scale and the confusion counts exactly.
"""
from __future__ import annotations

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from grl_tpu import models as jax_models
from grl_tpu.models.base import count_parameters
from grl_tpu.trainer import losses as jax_losses
from grl_tpu.trainer import lr_schedulers as jax_lr
from grl_tpu.trainer import metrics as jax_metrics
from grl_tpu.trainer.procedures.base_procedure import BaseProcedure as JaxProcedure
from grl_torch import models
from grl_torch.trainer import losses, lr_schedulers, metrics, optimizers
from grl_torch.trainer.procedures import BaseProcedure


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite spreads files over worker processes on shared cores: one
    intra-op thread per worker keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def logits_targets(seed=0, B=4, N=17, C=9):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, N, C).astype(np.float32)
    targets = rng.randint(0, C, size=(B, N))
    targets[rng.rand(B, N) < 0.3] = -100
    return logits, targets


# ---------------------------------------------------------------------------
# Losses, metrics, schedules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", ["CrossEntropyLoss", "FocalLoss"])
def test_class_losses_match_grl_tpu(name, weighted):
    """-100 targets dropped, weighted means divided by the kept weights;
    float32 on both sides (1e-6 relative)."""
    logits, targets = logits_targets(seed=1)
    args = {"weight": list(np.linspace(0.5, 2.0, 9))} if weighted else {}
    ours = getattr(losses, name)._from_config(args)(torch.from_numpy(logits), torch.from_numpy(targets))
    theirs = getattr(jax_losses, name)._from_config(args)(jnp.asarray(logits), jnp.asarray(targets))
    np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6)


@pytest.mark.parametrize("name, args", [
    ("BinaryCrossEntropyLoss", {}),
    ("BinaryCrossEntropyLoss", {"pos_weight": [2.0]}),
    ("MSELoss", {}),
])
def test_masked_losses_match_grl_tpu(name, args):
    rng = np.random.RandomState(3)
    logits = rng.randn(4, 10).astype(np.float32)
    targets = (rng.rand(4, 10) > 0.5).astype(np.float32)
    targets[rng.rand(4, 10) < 0.2] = -100.0
    ours = getattr(losses, name)._from_config(args)(torch.from_numpy(logits), torch.from_numpy(targets))
    theirs = getattr(jax_losses, name)._from_config(args)(jnp.asarray(logits), jnp.asarray(targets))
    np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6)


@pytest.mark.parametrize("ignore", [(-100,), (-100, 0)])
def test_confusion_matrix_and_reports_match_grl_tpu(ignore):
    rng = np.random.RandomState(0)
    C = 11
    targets = rng.randint(0, C, size=(4, 125))
    preds = rng.randint(0, C, size=(4, 125))
    targets[rng.rand(4, 125) < 0.2] = -100
    ours = metrics.confusion_matrix(torch.from_numpy(preds), torch.from_numpy(targets), C, ignore)
    theirs = np.asarray(jax_metrics.confusion_matrix(jnp.asarray(preds), jnp.asarray(targets), C, ignore))
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), theirs)
    assert metrics.macro_scores(ours.numpy()) == jax_metrics.macro_scores(theirs)
    names = tuple(f"class_{i}" for i in range(C))
    assert metrics.per_class_report(ours.numpy(), names) == jax_metrics.per_class_report(theirs, names)
    assert metrics.macro_scores(np.zeros((3, 3)))["f1-score"] == 0.0


@pytest.mark.parametrize("name, args", [
    ("ConstantLearningRate", {"lr": 0.003}),
    ("DecayLearningRate", {"lr": 0.01, "factor": 0.9, "num_epochs": 60}),
    ("MultiStepLearningRate", {"lr": 0.01, "gamma": 0.5, "milestones": [2, 4]}),
    ("WarmupLearningRate", {"lr": 0.01, "warmup_lr": 1e-5, "steps": 3}),
])
def test_lr_schedules_match_grl_tpu(name, args):
    ours = getattr(lr_schedulers, name)._from_config(args)
    theirs = getattr(jax_lr, name)._from_config(args)
    for epoch in range(6):
        for step in (0, 2, 5):
            assert ours(epoch, step) == theirs(epoch, step)


def test_lambda_schedules_match_grl_tpu():
    for step in range(0, 40, 3):
        for warmup in (0, 10):
            assert lr_schedulers.cosine_schedule_lambda(step, 30, 1e-4, 1.0, warmup) == \
                jax_lr.cosine_schedule_lambda(step, 30, 1e-4, 1.0, warmup)
        assert lr_schedulers.poly_schedule_lambda(0.1, step, 40) == jax_lr.poly_schedule_lambda(0.1, step, 40)


# ---------------------------------------------------------------------------
# Optimizer semantics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_matches_optax_clip_by_global_norm(max_norm):
    """Binding and not binding; float32 norms in another order (1e-6)."""
    rng = np.random.RandomState(4)
    arrays = [rng.randn(*shape).astype(np.float32) for shape in ((3, 4), (7,), (2, 2, 5))]
    params = [torch.nn.Parameter(torch.zeros(a.shape)) for a in arrays]
    for p, a in zip(params, arrays):
        p.grad = torch.from_numpy(a.copy())
    norm = optimizers.clip_by_global_norm_(params, max_norm)
    clipped, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(a) for a in arrays], None)
    np.testing.assert_allclose(float(norm), float(optax.global_norm([jnp.asarray(a) for a in arrays])), rtol=1e-6)
    for p, expected in zip(params, clipped):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(expected), rtol=1e-6, atol=1e-7)


def test_optimizer_registry():
    params = [torch.nn.Parameter(torch.zeros(3))]
    assert type(optimizers.BuiltinOptimizer("Adam", 0.1).make(params)) is torch.optim.Adam
    # Adam with weight decay is optax's decoupled adamw.
    decayed = optimizers.BuiltinOptimizer("Adam", 0.1, weight_decay=0.1).make(params)
    assert type(decayed) is torch.optim.AdamW and decayed.param_groups[0]["weight_decay"] == 0.1
    adamw = optimizers.BuiltinOptimizer("AdamW", 0.1).make(params)
    assert type(adamw) is torch.optim.AdamW and adamw.param_groups[0]["weight_decay"] == 0.01
    optimizers.set_learning_rate(adamw, 0.5)
    assert adamw.param_groups[0]["lr"] == 0.5
    # The other names grl_tpu accepts build optax's rules.
    for name, cls in (("SGD", optimizers.OptaxSGD), ("RMSprop", optimizers.OptaxRMSprop),
                      ("Adagrad", optimizers.OptaxAdagrad), ("Adadelta", optimizers.OptaxAdadelta),
                      ("Lamb", optimizers.OptaxLamb), ("Lion", optimizers.OptaxLion)):
        assert type(optimizers.BuiltinOptimizer(name, 0.1).make(params)) is cls
    with pytest.raises(KeyError, match="available"):
        optimizers.BuiltinOptimizer("Nope")


# grl_tpu's keyword mapping, each optimizer's defaults and its options.
OPTAX_RULES = [
    ("SGD", {}), ("SGD", {"momentum": 0.9, "weight_decay": 0.1}), ("SGD", {"momentum": 0.9, "nesterov": True}),
    ("RMSprop", {}), ("RMSprop", {"alpha": 0.9, "eps": 1e-6, "momentum": 0.5}),
    ("Adagrad", {}), ("Adagrad", {"eps": 1e-6}),
    ("Adadelta", {}), ("Adadelta", {"rho": 0.8, "eps": 1e-5}),
    ("Lamb", {}), ("Lamb", {"b1": 0.8, "b2": 0.99, "eps": 1e-4, "weight_decay": 0.01}),
    ("Lion", {}), ("Lion", {"b1": 0.8, "b2": 0.9, "weight_decay": 0.1}),
]


@pytest.mark.parametrize("name, kwargs", OPTAX_RULES)
def test_optimizers_match_optax(name, kwargs):
    """Five steps against grl_tpu's optax transformation, the lr changed
    between them (set_learning_rate on both sides), from float32
    parameters, one of them all zero (Lamb's trust ratio is then 1):
    within 1e-6 of each parameter's scale (float32 in another order; the
    reciprocal square roots may differ in their last bit)."""
    from grl_tpu.trainer import optimizers as jax_optimizers

    rng = np.random.RandomState(len(name) + len(kwargs))
    shapes = ((3, 4), (7,), (2, 2, 5))
    start = [rng.randn(*shape).astype(np.float32) for shape in shapes]
    start[1][:] = 0.0
    params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in start]
    opt = optimizers.BuiltinOptimizer(name, 0.01, **kwargs).make(params)
    tx = jax_optimizers.BuiltinOptimizer(name, 0.01, **kwargs).make()
    jparams = [jnp.asarray(a) for a in start]
    state = tx.init(jparams)
    for step, lr in enumerate((0.01, 0.01, 0.003, 0.003, 0.02)):
        optimizers.set_learning_rate(opt, lr)
        state = jax_optimizers.set_learning_rate(state, lr)
        grads = [rng.randn(*shape).astype(np.float32) for shape in shapes]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        updates, state = tx.update([jnp.asarray(g) for g in grads], state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, (p, want) in enumerate(zip(params, jparams)):
            want = np.asarray(want)
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max(),
                                       err_msg=f"{name} {kwargs} step {step + 1} parameter {k}")


def test_optax_rule_state_round_trips_a_checkpoint():
    """An optax rule's state_dict loads into a fresh optimizer (match_device
    keeps it plain on the CPU) and the next step equals the original's."""
    start = [torch.randn(4, 3, generator=torch.Generator().manual_seed(1))]
    runs = []
    for reload in (False, True):
        params = [torch.nn.Parameter(p.clone()) for p in start]
        opt = optimizers.BuiltinOptimizer("Lamb", 0.01, weight_decay=0.01).make(params)
        for step in range(3):
            params[0].grad = torch.full((4, 3), 0.1 * (step + 1))
            if reload and step == 2:
                fresh = optimizers.BuiltinOptimizer("Lamb", 0.01, weight_decay=0.01).make(params)
                fresh.load_state_dict(opt.state_dict())
                opt = optimizers.match_device(fresh)
                assert not isinstance(opt.param_groups[0]["lr"], torch.Tensor)
            opt.step()
        runs.append(params[0].detach().clone())
    assert torch.equal(*runs)


def test_one_device_mesh_is_a_no_op_and_the_rest_is_refused(tmp_path):
    """parallel.mesh over one device is a no-op, as in grl_tpu; a mesh over
    more devices than the world's processes (one here) raises, naming the
    launch contract (tests/test_torch_mesh.py trains the mesh in gloo
    worlds). (scan_steps > 1 runs: tests/test_torch_scan.py holds it to
    grl_tpu.)"""
    model = models.create_model("GraphCNNDropEdge", input_dim=8, output_dim=3, num_edges=6,
                                net_size=16, device="cpu")
    base = {"output_dir": str(tmp_path), "logging": {"use_tensorboard": False}}
    for mesh in ({"data": -1}, {"data": 1, "model": 1}):
        assert BaseProcedure(model, {**base, "parallel": {"mesh": mesh}}, device="cpu").mesh is None
    with pytest.raises(ValueError, match="GRL_NUM_PROCESSES=2"):
        BaseProcedure(model, {**base, "parallel": {"mesh": {"data": 2}}}, device="cpu")


# ---------------------------------------------------------------------------
# Train steps against grl_tpu's _train_step_body
# ---------------------------------------------------------------------------
B, N, L, F_IN, NET, C = 2, 64, 6, 48, 32, 7
MAX_GRAD_NORM = 0.05
MODEL = dict(input_dim=F_IN, output_dim=C, num_edges=L, net_size=NET, dropout_rate=0.0,
             edge_dropout_rate=0.0, kernel_impl="xla")


def step_config(tmp_path, weight_decay):
    args = {"type_optimizer": "Adam", "lr": 1e-3}
    if weight_decay:
        args["weight_decay"] = weight_decay
    return {
        "output_dir": str(tmp_path), "seed": 0, "max_grad_norm": MAX_GRAD_NORM,
        "optimizer": {"type": "BuiltinOptimizer", "args": args},
        "loss": {"type": "CrossEntropyLoss", "args": {}},
        "logging": {"use_tensorboard": False},
    }


def step_batch(seed):
    rng = np.random.RandomState(seed)
    V = rng.rand(B, N, F_IN).astype(np.float32)
    A = (rng.rand(B, N, L, N) < 0.05).astype(np.float32)
    labels = rng.randint(0, C, (B, N))
    labels[rng.rand(B, N) < 0.3] = -100
    return V, A, labels


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_procedure(tmp_path, weight_decay, jax_state):
    """A port procedure on the CPU holding grl_tpu's params and, after the
    first step, its optimizer state."""
    model = models.create_model("GraphCNNDropEdge", **MODEL, device="cpu")
    variables = {"params": numpy_tree(jax_state.params), "constants": numpy_tree(jax_state.constants)}
    model.load_state_dict(models.state_dict_from_flax(variables))
    proc = BaseProcedure(model, step_config(tmp_path, weight_decay), device="cpu")
    proc.init_state()
    if int(jax_state.step):
        proc.state.optimizer.load_state_dict(
            models.optimizer_state_from_optax(jax_state.opt_state, model, proc.state.optimizer)
        )
    return proc


def assert_same_step(jax_out, port_out, model):
    state, loss, cm = jax_out
    port_loss, port_cm = port_out
    np.testing.assert_allclose(float(port_loss), float(loss), rtol=1e-5)
    np.testing.assert_array_equal(port_cm.numpy(), np.asarray(cm))
    expected = models.state_dict_from_flax({"params": numpy_tree(state.params)})
    got = model.state_dict()
    scale = max(float(v.abs().max()) for v in expected.values())
    for name, value in expected.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=0, atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize("weight_decay", [None, 0.1])
def test_one_and_two_train_steps_match_grl_tpu(tmp_path, weight_decay):
    """weight_decay=None is optax adam -> torch Adam; 0.1 is optax adamw
    -> torch AdamW (decoupled decay)."""
    jax_proc = JaxProcedure(
        jax_models.create_model("GraphCNNDropEdge", **MODEL), step_config(tmp_path / "jax", weight_decay)
    )
    V, A, labels = step_batch(0)
    state = jax_proc.init_state((jnp.asarray(V), jnp.asarray(A)))
    jax_step = jax.jit(jax_proc._train_step_body(C, (-100,)))
    port = port_procedure(tmp_path / "port", weight_decay, state)
    assert models.count_parameters(port.model) == count_parameters(state.params)

    # Clipping binds: the first gradient's global norm exceeds the bound.
    probe = port_procedure(tmp_path / "probe", weight_decay, state)
    probe.criterion(probe.model((torch.from_numpy(V), torch.from_numpy(A))),
                    torch.from_numpy(labels)).backward()
    grads = [p.grad for p in probe.model.parameters()]
    assert float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))) > 10 * MAX_GRAD_NORM

    rng, lam = jax.random.PRNGKey(1), jnp.float32(1.0)
    for k in range(2):
        V, A, labels = step_batch(k)
        if k == 1:
            # The second step starts from grl_tpu's state after the first.
            carried = port_procedure(tmp_path / "carried", weight_decay, state)
            assert carried.state.optimizer.state_dict()["state"][0]["step"] == 1
        jax_out = jax_step(state, jnp.asarray(V), jnp.asarray(A), jnp.asarray(labels, jnp.int32), rng, lam)
        inputs = (torch.from_numpy(V), torch.from_numpy(A), torch.from_numpy(labels))
        port_out = port.build_train_step(C, (-100,))(*inputs, port.rngs, 1.0)
        assert_same_step(jax_out, port_out, port.model)
        if k == 1:
            carried_out = carried.build_train_step(C, (-100,))(*inputs, carried.rngs, 1.0)
            assert_same_step(jax_out, carried_out, carried.model)
        state = jax_out[0]
    assert port.state.step == 2 and int(state.step) == 2
