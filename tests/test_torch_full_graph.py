"""The sparse large-graph path: the sparse GraphCNNDropEdge, FullGraphProcedure
and the warper, grl_torch against grl_tpu.

Both packages get the same flax variables (carried across by
``state_dict_from_flax``) and the same numpy SBM graph. grl_tpu's Pallas
kernels run in interpret mode (K5 with the small TPU tiling of
tests/test_csr_spmm.py). float32 on both sides, summation order only:
logits within 1e-4 of their scale, losses within 1e-5, parameters after
one and two steps within 1e-5 of their scale. Dropout and DropEdge are
off in the step comparison: the two packages draw their masks from
different generators (the kernel masks are held bit for bit at the kernel
level, tests/test_torch_csr_spmm.py).
"""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from grl_tpu import models as jax_models
from grl_tpu.config import ConfigDict as JaxConfigDict
from grl_tpu.data import large_graph as jax_large_graph
from grl_tpu.ops import kernels as jax_kernels
from grl_tpu.ops import sparse as jax_sparse
from grl_tpu.ops.pallas import csr_spmm as jax_csr
from grl_tpu.ops.pallas import sparse_attention as jax_attention
from grl_tpu.trainer.procedures.full_graph_procedure import FullGraphProcedure as JaxFullGraph
from grl_tpu.trainer.procedures.full_graph_procedure import (
    large_graph_from_config as jax_large_graph_from_config,
)
from grl_torch import GNNLearningWarper, models
from grl_torch.config import ConfigDict
from grl_torch.data import large_graph
from grl_torch.ops import kernels, sparse
from grl_torch.trainer import procedures
from grl_torch.trainer.procedures.full_graph_procedure import (
    FullGraphProcedure,
    large_graph_from_config,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite spreads files over worker processes on shared cores: one
    intra-op thread per worker keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def interpret_mode():
    jax_csr.INTERPRET = True
    jax_attention.INTERPRET = True
    with pltpu.force_tpu_interpret_mode():
        yield
    jax_csr.INTERPRET = False
    jax_attention.INTERPRET = False


SBM = dict(num_nodes=192, num_classes=4, num_relations=3, avg_degree=5, feature_dim=16, seed=1)
TPU_PLAN = dict(block_rows=128, chunk_cols=128, edge_quantum=64)
MODEL = dict(input_dim=16, output_dim=4, num_edges=3, net_size=32, use_attention=True,
             attention_impl="sparse")


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def graphs(impl, attention=True):
    """The SBM graph planned for ``impl`` in both packages, and its features."""
    data = large_graph.sbm_relational_graph(**SBM)
    graph, feats = large_graph.to_relational_graph(data, device="cpu")
    jgraph, _ = jax_large_graph.to_relational_graph(jax_large_graph.sbm_relational_graph(**SBM))
    plan = TPU_PLAN if impl == "pallas_csr" else {}
    return (kernels.attach_kernel(graph, impl, attention=attention, **plan),
            jax_kernels.attach_kernel(jgraph, impl, attention=attention, **plan), feats)


@pytest.mark.parametrize("impl, compute_dtype", [
    ("pallas_csr", None), ("xla", None), ("pallas_csr", "bfloat16"),
])
def test_sparse_flagship_eval_logits_match_grl_tpu(impl, compute_dtype):
    """K5 + K4 (pallas_csr) and the COO segment sum + K4 (xla), eval mode.
    float32: 1e-4 of the logits' scale. bfloat16: both sides cast at the
    same points and accumulate the kernels in float32, so a bf16 output may
    round the other way in its last bit; as tests/test_torch_model.py's
    dense bf16 case, 1e-2 of the scale and argmax agreement on 99% of the
    nodes."""
    graph, jgraph, feats = graphs(impl)
    kwargs = dict(MODEL, kernel_impl=impl, compute_dtype=compute_dtype)
    jax_model = jax_models.create_model("GraphCNNDropEdge", **kwargs)
    # The variables do not depend on the kernels: initialise on the
    # segment path, and run grl_tpu's interpreted kernels once.
    variables = jax_models.init_model(jax_model.clone(kernel_impl="xla"), jax.random.PRNGKey(0),
                                      (jnp.asarray(feats), graphs("xla", attention=False)[1]))
    model = models.create_model("GraphCNNDropEdge", **kwargs, device="cpu")
    model.load_state_dict(models.state_dict_from_flax(numpy_tree(variables)), strict=True)
    expected = np.asarray(jax_model.apply(variables, (jnp.asarray(feats), jgraph), train=False))
    with torch.no_grad():
        out = model.eval()((torch.from_numpy(feats), graph)).numpy()
    assert out.shape == (SBM["num_nodes"], 4) and out.dtype == np.float32
    scale = np.abs(expected).max()
    if compute_dtype is None:
        np.testing.assert_allclose(out, expected, rtol=1e-4, atol=1e-4 * scale)
    else:
        np.testing.assert_allclose(out, expected, rtol=0, atol=1e-2 * scale)
        assert (out.argmax(-1) == expected.argmax(-1)).mean() >= 0.99


def test_dense_attention_on_a_batched_sparse_graph():
    """attention_impl dense on a flat batch graph: NodeSelfAtten per
    document, unflattened by batch_shape, as grl_tpu; without batch_shape
    both packages raise."""
    rng = np.random.RandomState(2)
    A = (rng.rand(2, 24, 3, 24) < 0.15).astype(np.float32)
    coo = [np.stack(x) for x in zip(*(sparse.dense_to_relational_coo(a, edge_bucket=400) for a in A))]
    graph = sparse.batch_relational_coo(*map(torch.from_numpy, coo), 24, 3)
    jgraph = jax_sparse.batch_relational_coo(*map(jnp.asarray, coo), 24, 3)
    V = rng.randn(48, 16).astype(np.float32)
    kwargs = dict(MODEL, attention_impl="dense", kernel_impl="xla")
    jax_model = jax_models.create_model("GraphCNNDropEdge", **kwargs)
    variables = jax_models.init_model(jax_model, jax.random.PRNGKey(1), (jnp.asarray(V), jgraph))
    model = models.create_model("GraphCNNDropEdge", **kwargs, device="cpu")
    model.load_state_dict(models.state_dict_from_flax(numpy_tree(variables)))
    expected = np.asarray(jax_model.apply(variables, (jnp.asarray(V), jgraph), train=False))
    with torch.no_grad():
        out = model.eval()((torch.from_numpy(V), graph)).numpy()
    np.testing.assert_allclose(out, expected, rtol=1e-4, atol=1e-4 * np.abs(expected).max())
    flat = sparse.RelationalGraph(graph.senders, graph.receivers, graph.relations, graph.weights,
                                  graph.mask, 48, 3)
    with pytest.raises(ValueError, match="batch_shape"):
        model((torch.from_numpy(V), flat))


# The step comparison walks grl_tpu's interpreted kernels 14 times: one
# block, one chunk.
STEP_SBM = dict(SBM, num_nodes=128, avg_degree=4)


def step_config(tmp_path):
    return {
        "output_dir": str(tmp_path), "seed": 0, "max_grad_norm": 0.5, "num_epochs": 2,
        "optimizer": {"type": "BuiltinOptimizer", "args": {"type_optimizer": "Adam", "lr": 1e-3}},
        "kernel_plan": TPU_PLAN, "logging": {"use_tensorboard": False},
    }


def test_one_and_two_full_graph_steps_match_grl_tpu(tmp_path):
    """pallas_csr + sparse attention, dropout and DropEdge 0, a clip that
    binds: the port's FullGraphProcedure.train_step against grl_tpu's
    step_body, from the same variables."""
    kwargs = dict(MODEL, kernel_impl="pallas_csr", dropout_rate=0.0, edge_dropout_rate=0.0)
    jax_proc = JaxFullGraph(jax_models.create_model("GraphCNNDropEdge", **kwargs),
                            step_config(tmp_path / "jax"), jax_large_graph.sbm_relational_graph(**STEP_SBM))
    jax_proc._ensure_initialized()
    assert jax_proc.graph.kernel is not None and jax_proc.graph.atten_kernel is not None
    state = jax_proc.state
    model = models.create_model("GraphCNNDropEdge", **kwargs, device="cpu")
    model.load_state_dict(models.state_dict_from_flax(
        numpy_tree({"params": state.params, "constants": state.constants})))
    proc = FullGraphProcedure(model, step_config(tmp_path / "port"),
                              data=large_graph.sbm_relational_graph(**STEP_SBM), device="cpu")
    proc._ensure_initialized()
    assert isinstance(proc.graph.kernel, type(kernels.attach_kernel(proc.graph, "pallas_csr").kernel))
    np.testing.assert_array_equal(proc.train_labels.numpy(), np.asarray(jax_proc.train_labels))

    step = jax.jit(jax_proc._step_body)
    rng = jax.random.PRNGKey(3)
    for k in range(2):
        state, loss = step(state, jax_proc.graph, jax_proc.features, jax_proc.train_labels, rng)
        port_loss = proc.train_step()
        np.testing.assert_allclose(float(port_loss), float(loss), rtol=1e-5)
        expected = models.state_dict_from_flax({"params": numpy_tree(state.params)})
        got = model.state_dict()
        scale = max(float(v.abs().max()) for v in expected.values())
        for name, value in expected.items():
            np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=0, atol=1e-5 * scale,
                                       err_msg=f"step {k + 1}: {name}")
    assert proc.state.step == 2 and int(state.step) == 2
    # The eval step is grl_tpu's masked accuracy.
    acc = float(proc.eval_step(proc.val_labels))
    logits = jax_proc.model.apply(state.variables(), (jax_proc.features, jax_proc.graph), train=False)
    labels = np.asarray(jax_proc.val_labels)
    mask = labels != -100
    assert acc == pytest.approx(((np.asarray(logits).argmax(-1) == labels) & mask).sum() / mask.sum())


def warper_config(tmp_path, seed, num_epochs, scan_steps=1, **model_args):
    return {
        "experiment_name": f"sbm-{seed}", "seed": seed, "is_train": True,
        "output_dir": str(tmp_path), "checkpoint_path": None,
        "num_epochs": num_epochs, "scan_steps": scan_steps, "max_grad_norm": 5.0,
        "model": {"type": "GraphCNNDropEdge", "args": {
            "input_dim": 32, "output_dim": 5, "num_edges": 3, "net_size": 32,
            "kernel_impl": "pallas_csr", **model_args}},
        "data_config": {"large_graph": {"type": "sbm", "args": {
            "num_nodes": 2048, "num_classes": 5, "num_relations": 3, "avg_degree": 8,
            "feature_dim": 32, "noise": 2.0, "seed": 0}}},
        "procedure": {"type": "FullGraphProcedure", "args": {}},
        "optimizer": {"type": "BuiltinOptimizer", "args": {"type_optimizer": "Adam", "lr": 0.01}},
        "logging": {"use_tensorboard": False, "experiment_tracking": False},
    }


def test_warper_trains_the_sparse_flagship_and_it_learns(tmp_path):
    """tests/test_full_graph.py's run (2048-node SBM, 150 epochs, Adam
    0.01, dropout and DropEdge on) through GNNLearningWarper on the kernel
    path. Features alone are weak, so a broken aggregation stays near
    chance (0.2). The run's accuracy depends on its seed in both packages:
    grl_tpu's own run reaches 0.81, 0.41 and 0.61 at seeds 0, 1 and 2, the
    port 0.60, 0.80 and 0.60. The best of the three must pass 0.6, the
    bound of grl_tpu's test."""
    accs = []
    for seed in (0, 1, 2):
        warper = GNNLearningWarper(config=warper_config(tmp_path / str(seed), seed, 150,
                                                        use_attention=False), device="cpu")
        assert isinstance(warper.trainer, FullGraphProcedure)
        assert warper.trainer.graph.kernel is not None
        accs.append(warper.train())
        assert warper.trainer.state.step == 150
    assert max(accs) > 0.6, accs


def test_scan_steps_with_a_remainder_runs_exactly_num_epochs(tmp_path):
    """scan_steps 3 over 7 steps: chunks of 3, 3 and 1, eval after the
    first and the last chunk (no multiple of 10 is crossed), as grl_tpu."""
    warper = GNNLearningWarper(config=warper_config(tmp_path, 0, 7, scan_steps=3,
                                                    use_attention=True, attention_impl="sparse"),
                               device="cpu")
    trainer = warper.trainer
    assert trainer.graph.atten_kernel is not None
    evals = []
    eval_step = trainer.eval_step
    trainer.eval_step = lambda labels: evals.append(trainer.state.step) or eval_step(labels)
    acc = warper.train()
    assert trainer.state.step == 7 and len(trainer.losses) == 7
    assert evals == [3, 7]
    assert np.isfinite(acc) and all(np.isfinite(float(loss)) for loss in trainer.losses)


def test_attach_kernel_refusals_and_the_missing_kernel_error():
    graph, jgraph, feats = graphs("xla", attention=False)
    assert kernels.attach_kernel(graph, "xla") is graph
    only_atten = kernels.attach_kernel(graph, "xla", attention=True)
    assert only_atten.kernel is None and only_atten.atten_kernel is not None
    # ell and pallas plan K6, as grl_tpu plans its ELL tables; tile is K7.
    for impl in ("ell", "pallas"):
        assert type(kernels.attach_kernel(graph, impl).kernel).__name__ == "ELLGraphKernel"
        assert type(jax_kernels.attach_kernel(jgraph, impl).kernel).__name__ == "ELLGraphKernel"
    with pytest.raises(NotImplementedError, match="K7.*ROADMAP"):
        kernels.attach_kernel(graph, "tile")
    with pytest.raises(ValueError, match="Unknown sparse kernel_impl"):
        kernels.attach_kernel(graph, "nope")
    with pytest.raises(TypeError):
        kernels.attach_kernel(graph, "pallas_csr", width_quantum=2)
    # A kernel_impl with no planned kernel: the same ValueError in both.
    kwargs = dict(MODEL, kernel_impl="pallas_csr")
    model = models.create_model("GraphCNNDropEdge", **kwargs, device="cpu")
    with pytest.raises(ValueError, match="no planned kernel") as ours:
        model.eval()((torch.from_numpy(feats), graph))
    jax_model = jax_models.create_model("GraphCNNDropEdge", **kwargs)
    with pytest.raises(ValueError, match="no planned kernel") as theirs:
        jax_models.init_model(jax_model, jax.random.PRNGKey(0), (jnp.asarray(feats), jgraph))
    assert str(ours.value) == str(theirs.value).replace("grl_tpu", "grl_torch")


def test_converter_maps_the_sparse_attention_parameters():
    """trunk/self_atten/{f,g,h,gamma} of a sparse-attention model land on
    the port's SparseNodeSelfAtten, which has NodeSelfAtten's names."""
    graph, jgraph, feats = graphs("xla")
    jax_model = jax_models.create_model("GraphCNNDropEdge", **MODEL)
    variables = jax_models.init_model(jax_model, jax.random.PRNGKey(4), (jnp.asarray(feats), jgraph))
    state = models.state_dict_from_flax(numpy_tree(variables))
    atten = variables["params"]["trunk"]["self_atten"]
    assert sorted(atten) == ["f", "g", "gamma", "h"]
    model = models.create_model("GraphCNNDropEdge", **MODEL, device="cpu")
    assert isinstance(model.trunk.self_atten, models.layers.SparseNodeSelfAtten)
    model.load_state_dict(state, strict=True)
    np.testing.assert_array_equal(model.trunk.self_atten.gamma.detach().numpy(), atten["gamma"])
    np.testing.assert_array_equal(model.trunk.self_atten.f.linear.weight.detach().numpy(),
                                  np.asarray(atten["f"]["linear"]["kernel"]).T)


def test_procedure_surface(tmp_path):
    """The registry reaches FullGraphProcedure; npz graphs load as in
    grl_tpu; no graph is an error; a multi-device mesh raises naming slice 4."""
    assert procedures.FullGraphProcedure is FullGraphProcedure
    data = large_graph.sbm_relational_graph(num_nodes=50, num_classes=3, avg_degree=3, feature_dim=4)
    path = tmp_path / "graph.npz"
    np.savez(path, **data._asdict())
    config = {"data_config": {"large_graph": {"type": "npz", "path": str(path)}}}
    ours = large_graph_from_config(ConfigDict(config))
    theirs = jax_large_graph_from_config(JaxConfigDict(config))
    for name in large_graph.LargeGraphData._fields:
        np.testing.assert_array_equal(getattr(ours, name), getattr(theirs, name))
    with pytest.raises(ValueError, match="large_graph"):
        large_graph_from_config(ConfigDict({}))
    model = models.create_model("GraphCNNDropEdge", **dict(MODEL, input_dim=4, output_dim=3),
                                device="cpu")
    with pytest.raises(NotImplementedError, match="slice 4"):
        FullGraphProcedure(model, {"output_dir": str(tmp_path), "parallel": {"mesh": {"data": 2}},
                                   "logging": {"use_tensorboard": False}}, data=data, device="cpu")


# ---------------------------------------------------------------------------
# chip_smoke.py's full-graph kernel-versus-plain comparison, on a small
# graph: on the CPU every run takes the plain versions, so the kernel run
# and a second plain run agree with the plain run to the bit, and the runs
# with a fault planted in K5 (another seed, another rate) must fail
# FULL_GRAPH_STEP_LIMITS.
@pytest.fixture(scope="module")
def comparison_starts(tmp_path_factory):
    """A small sparse flagship on the kernel path with sparse attention
    (2048 nodes), and the comparison's two starts: its initial weights at
    lr 0.01 and the weights of 150 steps at lr 1e-3."""
    import chip_smoke

    config = warper_config(tmp_path_factory.mktemp("limits"), 0, 1, use_attention=True,
                           attention_impl="sparse")
    trainer = GNNLearningWarper(config=config, device="cpu").trainer
    trainer._ensure_initialized()
    init = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    learner = chip_smoke.procedure_copy(torch, trainer, 0, 1e-3)
    for _ in range(150):
        learner.train_step()
    learned = {k: v.clone() for k, v in learner.model.state_dict().items()}
    return trainer, {"init": (init, 0.01), "learned": (learned, 1e-3)}


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_full_graph_step_limits_fail_a_wrong_k5_mask(comparison_starts, dtype_name):
    import chip_smoke

    trainer, starts = comparison_starts
    results, failures = chip_smoke.full_graph_comparisons(torch, trainer, starts, (dtype_name,))
    assert not failures, failures
    assert {(r["run"], r["verdict"]) for r in results if r["must"] == "fail"} == {
        ("K5 seed+1", "fail"), ("K5 rate 0.25", "fail"), ("K4b pairs one edge off", "fail"),
        ("K4b without sum alpha dalpha", "fail")}
    for r in results:
        if r["run"] in ("kernel", "plain again", "kernel, dropout 0.5", "plain step, then kernel step, dropout 0.5"):
            assert all(row["loss_rel_diff"] == row["grad_rel_diff"] == row["param_max_diff"] == 0
                       for row in r["rows"]), r


def _last_bits(share, ulp):
    """K5's plain version with a share of its outputs moved up by about one
    unit in their last place: what another summation order does."""
    from grl_torch.ops import csr_spmm

    launch = csr_spmm.csr_accumulate

    def flipped(X, layout, seed=0, rate=0.0):
        out = launch(X, layout, seed, rate)
        flip = torch.rand(out.shape, generator=torch.Generator().manual_seed(int(seed) + 1)) < share
        return torch.where(flip, out.float() * (1 + ulp), out.float()).to(out.dtype)

    return chip_smoke_swapped((csr_spmm, "csr_accumulate", flipped))


def chip_smoke_swapped(*changes):
    import chip_smoke

    return chip_smoke.swapped(*changes)


@pytest.mark.parametrize("dtype_name, share, ulp", [("float32", 0.5, 2.0 ** -23),
                                                     ("bfloat16", 1e-4, 2.0 ** -7)])
def test_full_graph_step_limits_pass_last_bit_differences(comparison_starts, dtype_name, share, ulp):
    """Last-bit differences in K5's outputs, forward and backward, stay
    within FULL_GRAPH_STEP_LIMITS from the learned weights: in float32 in
    half the outputs; in bfloat16, where a full-batch gradient of this
    small model is dominated by rounding (a share of 1e-3 already moves it
    by 2%), in 1e-4 of them."""
    import chip_smoke

    trainer, starts = comparison_starts
    weights, lr = starts["learned"]
    with chip_smoke.deterministic(torch, True):
        plain = chip_smoke.two_full_graph_steps(torch, trainer, weights, dtype_name, lr)
        flipped = chip_smoke.two_full_graph_steps(torch, trainer, weights, dtype_name, lr,
                                                  _last_bits(share, ulp))
    rows = chip_smoke.compare_steps(flipped, plain, lr)
    assert rows[0]["grad_rel_diff"] > 0, rows
    assert not chip_smoke.step_failures(rows, chip_smoke.FULL_GRAPH_STEP_LIMITS[dtype_name]), rows
