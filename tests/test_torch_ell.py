"""K6 and the ELL path in grl_torch against grl_tpu.

grl_tpu's ELL kernel is plain XLA and runs on the CPU as it is. The port's
planner must give grl_tpu's tables, permutations and ``node_perm`` exactly;
its aggregation (the plain version of K6, on the CPU) is held against
grl_tpu's forward and VJP in both modes, with one hash mask at rate 0.3
(float32, summation order only: within 1e-5 of the output's scale). The
flagship's eval logits and one and two FullGraphProcedure steps run with
``kernel_impl: ell`` and configs/arxiv_full_graph.yaml's ``kernel_plan``.
The CUDA kernel is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
from __future__ import annotations

import contextlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from grl_tpu import models as jax_models
from grl_tpu.data import large_graph as jax_large_graph
from grl_tpu.ops import ell as jax_ell
from grl_tpu.ops import kernels as jax_kernels
from grl_tpu.ops.pallas import sparse_attention as jax_attention
from grl_tpu.trainer.procedures.full_graph_procedure import FullGraphProcedure as JaxFullGraph
from grl_torch import models
from grl_torch.data import large_graph
from grl_torch.ops import csr_spmm, ell, hashing, kernels, launches
from grl_torch.trainer.procedures.full_graph_procedure import FullGraphProcedure


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite spreads files over worker processes on shared cores: one
    intra-op thread per worker keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# configs/arxiv_full_graph.yaml's kernel_plan, and a geometric plan without
# the reorder.
CONFIG_PLAN = dict(plan_projected=True, width_quantum=2, bucket_growth=1, reorder="degree")
GEOMETRIC_PLAN = dict(plan_projected=True, width_quantum=4, bucket_growth=2, reorder="none")


def sbm(L, num_nodes=2048, **kw):
    return large_graph.sbm_relational_graph(num_nodes=num_nodes, num_classes=4, num_relations=L,
                                            avg_degree=5, feature_dim=16, seed=1, **kw)


def edges_of(data, zero_every=0):
    """The SBM's edge arrays; ``zero_every`` zeroes every k-th weight (masked
    edges, dropped at plan time)."""
    weights = data.weights.copy()
    if zero_every:
        weights[::zero_every] = 0.0
    return data.senders, data.receivers, data.relations, weights


def both_kernels(data, plan, zero_every=0):
    edges = edges_of(data, zero_every)
    N, L = len(data.features), data.num_relations
    return (ell.ELLGraphKernel(*edges, N, L, device="cpu", **plan),
            jax_ell.ELLGraphKernel(*edges, N, L, **plan))


def directions(ours, theirs):
    """(our GatherTables, grl_tpu's buckets, grl_tpu's stitch or None) of
    each planned direction."""
    t = theirs.tables
    return [(ours.tables.fwd, t.fwd, t.fwd_inv), (ours.tables.bwd, t.bwd, t.bwd_inv),
            (ours.tables.proj.fwd, t.proj.fwd, t.proj.fwd_inv),
            (ours.tables.proj.bwd, t.proj.bwd, t.proj.bwd_inv)]


@pytest.mark.parametrize("plan", [CONFIG_PLAN, GEOMETRIC_PLAN], ids=["config", "geometric"])
@pytest.mark.parametrize("L", [1, 3])
def test_planner_matches_grl_tpu(L, plan):
    """Every table, stitch permutation and node_perm equals grl_tpu's; the
    degree reorder applies at L = 1 only, as in grl_tpu (a no-op at L > 1)."""
    ours, theirs = both_kernels(sbm(L), plan, zero_every=9)
    if theirs.node_perm is None:
        assert ours.node_perm is None
    else:
        np.testing.assert_array_equal(ours.node_perm, theirs.node_perm)
    assert (ours.node_perm is not None) == (L == 1 and plan["reorder"] == "degree")
    for tables, buckets, inv in directions(ours, theirs):
        views = tables.bucket_views()
        assert len(views) == len(buckets)
        for view, bucket in zip(views, buckets):
            for got, want in zip(view, bucket):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if inv is None:
            assert tables.inv_perm is None
            np.testing.assert_array_equal(tables.perm.numpy(), np.arange(tables.num_rows))
        else:
            np.testing.assert_array_equal(tables.inv_perm.numpy(), np.asarray(inv))
            np.testing.assert_array_equal(tables.perm.numpy(), np.argsort(np.asarray(inv)))
        rows = np.array([r for r, _ in tables.shapes])
        widths = np.array([w for _, w in tables.shapes])
        np.testing.assert_array_equal(tables.buckets.numpy(), np.stack(
            [np.cumsum(rows) - rows, widths, np.cumsum(rows * widths) - rows * widths], 1))
    if ours.node_perm is not None:  # the forward stitch is the identity (ell.py:358-366)
        assert ours.tables.fwd.inv_perm is None
    live = int((edges_of(sbm(L), 9)[3] != 0).sum())
    assert all(int((tables.weight != 0).sum()) == live for tables, _, _ in directions(ours, theirs))


@pytest.mark.parametrize("width_quantum, bucket_growth", [(4, 2), (2, 1), (1, 3)])
def test_build_tables_matches_grl_tpu(width_quantum, bucket_growth):
    """Buckets, both permutations and each edge's table cell, on a graph with
    a hub of degree 300 and zero-degree rows."""
    rng = np.random.RandomState(width_quantum)
    out_row = np.concatenate([np.zeros(300, np.int64), rng.randint(1, 180, 700)])
    src_row = rng.randint(0, 500, 1000).astype(np.int64)
    weights = (rng.rand(1000) + 0.1).astype(np.float32)
    gids = rng.permutation(1000).astype(np.int64)
    args = (out_row, src_row, weights, gids, 200, width_quantum, bucket_growth)
    ours, theirs = ell._build_tables(*args), jax_ell._build_tables(*args)
    assert len(ours.buckets) == len(theirs.buckets) > 2
    for mine, want in zip(ours.buckets, theirs.buckets):
        for got, exp in zip(mine, want):
            np.testing.assert_array_equal(got, np.asarray(exp))
            assert got.dtype == np.asarray(exp).dtype
    for name in ("inv_perm", "perm", "edge_flat"):
        np.testing.assert_array_equal(getattr(ours, name), np.asarray(getattr(theirs, name)))
    flat_idx = np.concatenate([b.idx.ravel() for b in ours.buckets])
    np.testing.assert_array_equal(flat_idx[ours.edge_flat], src_row)
    assert ell._trivial_inv(ours) == jax_ell._trivial_inv(theirs)


def assert_close_to_scale(got, want, share=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=share * np.abs(want).max())


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("L", [1, 3])
def test_aggregation_and_vjp_match_grl_tpu(L, rate):
    """ell_aggregate and ell_aggregate_projected, forward and VJP, on one
    seed: one mask on both sides, float32 in another order."""
    data = sbm(L)
    ours, theirs = both_kernels(data, CONFIG_PLAN, zero_every=11)
    N = len(data.features)
    rng = np.random.RandomState(L)
    seed = 1234
    for projected, rows, width in ((False, N, 16), (True, N * L, 8)):
        X = rng.randn(rows, width).astype(np.float32)
        tX = torch.from_numpy(X).requires_grad_()
        if projected:
            out = ours.neighbor_aggregate_projected(tX, seed, rate)
            fn = lambda x: theirs.neighbor_aggregate_projected(x, seed, rate)  # noqa: E731
        else:
            out = ours.neighbor_aggregate(tX, seed, rate)
            fn = lambda x: theirs.neighbor_aggregate(x, seed, rate)  # noqa: E731
        g = rng.randn(*out.shape).astype(np.float32)
        (out * torch.from_numpy(g)).sum().backward()
        expected, vjp = jax.vjp(jax.jit(fn), jnp.asarray(X))
        (dX,) = vjp(jnp.asarray(g))
        assert out.shape == expected.shape and out.dtype == torch.float32
        assert_close_to_scale(out.detach().numpy(), expected)
        assert_close_to_scale(tX.grad.numpy(), dX)


@pytest.mark.parametrize("L", [1, 2])
def test_keep_set_is_the_hash_and_k5s(L):
    """V = I reads the kept edges back exactly: equal to the hash of the edge
    positions, to grl_tpu's ELL, and to K5's on the graph before the degree
    reorder, row-permuted by node_perm (one mask for both walks)."""
    N = 64
    rng = np.random.RandomState(L)
    cells = rng.choice(N * L * N, 700, replace=False)
    receivers, rest = np.divmod(cells, L * N)
    relations, senders = np.divmod(rest, N)
    weights = np.ones(700, np.float32)
    ours = ell.ELLGraphKernel(senders, receivers, relations, weights, N, L, device="cpu", **CONFIG_PLAN)
    theirs = jax_ell.ELLGraphKernel(senders, receivers, relations, weights, N, L, **CONFIG_PLAN)
    perm = ours.node_perm if ours.node_perm is not None else np.arange(N)
    eye = np.eye(N, dtype=np.float32)
    out = ours.neighbor_aggregate(torch.from_numpy(eye), 5, 0.3).numpy().reshape(N, L, N)
    np.testing.assert_array_equal(
        out, np.asarray(jax.jit(lambda v: theirs.neighbor_aggregate(v, 5, 0.3))(jnp.asarray(eye))).reshape(N, L, N))
    kept = hashing.keep_bits(torch.arange(700), 5, 0.3).numpy()
    expected = np.zeros((N, L, N), bool)
    expected[perm[receivers[kept]], relations[kept], perm[senders[kept]]] = True
    np.testing.assert_array_equal(out != 0, expected)
    np.testing.assert_array_equal(out[expected], np.float32(1) / np.float32(0.7))
    csr = csr_spmm.CSRGraphKernel(senders, receivers, relations, weights, N, L, device="cpu")
    k5 = csr.neighbor_aggregate(torch.from_numpy(eye), 5, 0.3).numpy().reshape(N, L, N)
    np.testing.assert_array_equal(out[perm][:, :, perm], k5)
    # The transposed walk and both projected walks see the same set.
    dV = ell.ell_accumulate(torch.eye(N * L), ours.tables.bwd, 5, 0.3).numpy()
    np.testing.assert_array_equal(dV.reshape(N, N, L).transpose(1, 2, 0) != 0, expected)
    pf = ell.ell_accumulate(torch.eye(N * L), ours.tables.proj.fwd, 5, 0.3).numpy()  # (N, N*L)
    np.testing.assert_array_equal(pf.reshape(N, N, L).transpose(0, 2, 1) != 0, expected)
    pb = ell.ell_accumulate(torch.eye(N), ours.tables.proj.bwd, 5, 0.3).numpy()  # (N*L, N)
    np.testing.assert_array_equal(pb.reshape(N, L, N).transpose(2, 1, 0) != 0, expected)


def test_refusals_and_surface():
    data = sbm(2, num_nodes=300)
    edges = edges_of(data)
    for cls in (ell.ELLGraphKernel, jax_ell.ELLGraphKernel):
        with pytest.raises(ValueError, match="unknown reorder"):
            cls(*edges, 300, 2, reorder="lpa")
        # Planner knobs of other kernels are ignored, as in grl_tpu.
        assert cls(*edges, 300, 2, tile_size=128, feature_dim=64).node_perm is None
    plain = ell.ELLGraphKernel(*edges, 300, 2, device="cpu")
    before = launches.device_counts()
    V = torch.randn(300, 8)
    assert plain.pad_features(V) is V and plain.tables.proj is None
    with pytest.raises(ValueError, match="plan_projected"):
        plain.neighbor_aggregate_projected(torch.randn(600, 8))
    with pytest.raises(ValueError, match="rows"):
        plain.neighbor_aggregate(torch.randn(299, 8))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ell.ell_accumulate(torch.zeros(300, 8, device="meta"), plain.tables.fwd)
    with pytest.raises(ValueError):
        plain.neighbor_aggregate(V, 1, 1.0)
    # V may carry rows past num_nodes: never gathered, zero gradient.
    padded = torch.cat([V, torch.ones(4, 8)]).requires_grad_()
    out = plain.neighbor_aggregate(padded, 3, 0.3)
    out.sum().backward()
    assert torch.equal(out, plain.neighbor_aggregate(V, 3, 0.3))
    assert padded.grad.shape == (304, 8) and torch.all(padded.grad[300:] == 0)
    assert {plain.tables.fwd.direction, plain.tables.bwd.direction} <= set(ell.DIRECTIONS)
    assert launches.device_counts() == before  # CPU tensors: plain version, never a launch


# ---------------------------------------------------------------------------
# The flagship and FullGraphProcedure on kernel_impl: ell
# ---------------------------------------------------------------------------
MODEL = dict(input_dim=16, output_dim=4, net_size=32, kernel_impl="ell", use_attention=False)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@contextlib.contextmanager
def interpret_mode(on):
    """grl_tpu's K4 (a Pallas kernel) in interpret mode, as
    tests/test_torch_full_graph.py runs it."""
    if not on:
        yield
        return
    jax_attention.INTERPRET = True
    try:
        with pltpu.force_tpu_interpret_mode():
            yield
    finally:
        jax_attention.INTERPRET = False


def place(node_perm, features):
    if node_perm is None:
        return features
    out = np.zeros_like(features)
    out[node_perm] = features
    return out


@pytest.mark.parametrize("L, compute_dtype, attention", [
    (1, None, False), (3, None, False), (1, "bfloat16", False), (1, None, True),
])
def test_sparse_flagship_eval_logits_match_grl_tpu(L, compute_dtype, attention):
    """Eval logits with kernel_impl ell and the config's plan, features
    placed through node_perm in both. float32: 1e-5 of the logits' scale.
    bfloat16: the two packages round the same products at the same points,
    but a bf16 output may round the other way in its last bit: 1e-2 of the
    scale and argmax agreement on 99% of the nodes. With sparse attention,
    K4 is planned in the reordered node space in both."""
    data = sbm(L, num_nodes=2048 if not attention else 256)
    graph, feats = large_graph.to_relational_graph(data, device="cpu")
    jgraph, _ = jax_large_graph.to_relational_graph(data)
    graph = kernels.attach_kernel(graph, "ell", attention=attention, **CONFIG_PLAN)
    jgraph = jax_kernels.attach_kernel(jgraph, "ell", attention=attention, **CONFIG_PLAN)
    np.testing.assert_array_equal(graph.senders.numpy(), np.asarray(jgraph.senders))
    np.testing.assert_array_equal(graph.receivers.numpy(), np.asarray(jgraph.receivers))
    feats = place(graph.kernel.node_perm, feats)
    kwargs = dict(MODEL, num_edges=L, compute_dtype=compute_dtype, use_attention=attention,
                  attention_impl="sparse")
    jax_model = jax_models.create_model("GraphCNNDropEdge", **kwargs)
    with interpret_mode(attention):
        variables = jax_models.init_model(jax_model, jax.random.PRNGKey(L), (jnp.asarray(feats), jgraph))
        expected = np.asarray(jax.jit(lambda v: jax_model.apply(variables, (v, jgraph), train=False))(
            jnp.asarray(feats)))
    model = models.create_model("GraphCNNDropEdge", **kwargs, device="cpu")
    model.load_state_dict(models.state_dict_from_flax(numpy_tree(variables)), strict=True)
    with torch.no_grad():
        out = model.eval()((torch.from_numpy(feats), graph)).numpy()
    scale = np.abs(expected).max()
    if compute_dtype is None:
        np.testing.assert_allclose(out, expected, rtol=0, atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(out, expected, rtol=0, atol=1e-2 * scale)
        assert (out.argmax(-1) == expected.argmax(-1)).mean() >= 0.99


def step_config(tmp_path):
    return {
        "output_dir": str(tmp_path), "seed": 0, "max_grad_norm": 0.5, "num_epochs": 2,
        "optimizer": {"type": "BuiltinOptimizer", "args": {"type_optimizer": "Adam", "lr": 1e-3}},
        "kernel_plan": CONFIG_PLAN, "logging": {"use_tensorboard": False},
    }


@pytest.mark.parametrize("L", [1, 3])
def test_one_and_two_full_graph_steps_match_grl_tpu(tmp_path, L):
    """kernel_impl ell with the config's plan (project-first gcn3, the degree
    reorder at L = 1), dropout and DropEdge 0, a clip that binds: the port's
    FullGraphProcedure.train_step against grl_tpu's step_body, from the same
    variables, with features and labels placed through node_perm in both."""
    kwargs = dict(MODEL, num_edges=L, dropout_rate=0.0, edge_dropout_rate=0.0)
    data = sbm(L)
    jax_proc = JaxFullGraph(jax_models.create_model("GraphCNNDropEdge", **kwargs),
                            step_config(tmp_path / "jax"), data)
    jax_proc._ensure_initialized()
    state = jax_proc.state
    model = models.create_model("GraphCNNDropEdge", **kwargs, device="cpu")
    model.load_state_dict(models.state_dict_from_flax(
        numpy_tree({"params": state.params, "constants": state.constants})))
    proc = FullGraphProcedure(model, step_config(tmp_path / "port"), data=data, device="cpu")
    proc._ensure_initialized()
    assert isinstance(proc.graph.kernel, ell.ELLGraphKernel)
    assert (proc.graph.kernel.node_perm is not None) == (L == 1)
    assert proc.graph.kernel.tables.proj is not None
    np.testing.assert_array_equal(proc.features.numpy(), np.asarray(jax_proc.features))
    np.testing.assert_array_equal(proc.train_labels.numpy(), np.asarray(jax_proc.train_labels))
    np.testing.assert_array_equal(proc.val_labels.numpy(), np.asarray(jax_proc.val_labels))

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
    acc = float(proc.eval_step(proc.val_labels))
    logits = jax_proc.model.apply(state.variables(), (jax_proc.features, jax_proc.graph), train=False)
    labels = np.asarray(jax_proc.val_labels)
    mask = labels != -100
    assert acc == pytest.approx(((np.asarray(logits).argmax(-1) == labels) & mask).sum() / mask.sum())


# ---------------------------------------------------------------------------
# chip_smoke.py's ell-phase comparison on a small graph: on the CPU every run
# takes K6's plain version, so the kernel run and a second plain run agree
# with the plain run to the bit, and K6 with another seed or rate must fail
# FULL_GRAPH_STEP_LIMITS.
@pytest.fixture(scope="module")
def ell_comparison(tmp_path_factory):
    """The arxiv config's model and plan on a 2048-node single-relation SBM,
    through the warper, and its weights after 150 steps at lr 1e-3."""
    import chip_smoke
    from grl_torch import GNNLearningWarper

    config = {
        "experiment_name": "ell", "seed": 0, "is_train": True, "checkpoint_path": None,
        "output_dir": str(tmp_path_factory.mktemp("ell")), "num_epochs": 1, "max_grad_norm": 5.0,
        "model": {"type": "GraphCNNDropEdge", "args": dict(MODEL, input_dim=32, output_dim=5, num_edges=1)},
        "kernel_plan": CONFIG_PLAN,
        "data_config": {"large_graph": {"type": "sbm", "args": {
            "num_nodes": 2048, "num_classes": 5, "num_relations": 1, "avg_degree": 8, "feature_dim": 32,
            "seed": 0}}},
        "procedure": {"type": "FullGraphProcedure", "args": {}},
        "optimizer": {"type": "BuiltinOptimizer", "args": {"type_optimizer": "Adam", "lr": 0.01}},
        "logging": {"use_tensorboard": False, "experiment_tracking": False},
    }
    trainer = GNNLearningWarper(config=config, device="cpu").trainer
    trainer._ensure_initialized()
    learner = chip_smoke.procedure_copy(torch, trainer, 0, 1e-3)
    for _ in range(150):
        learner.train_step()
    learned = {k: v.clone() for k, v in learner.model.state_dict().items()}
    return trainer, {"learned": (learned, 1e-3)}


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_full_graph_step_limits_fail_a_wrong_k6_mask(ell_comparison, dtype_name):
    import chip_smoke

    trainer, starts = ell_comparison
    assert trainer.graph.kernel.node_perm is not None and trainer.graph.kernel.tables.proj is not None
    results, failures = chip_smoke.full_graph_comparisons(torch, trainer, starts, (dtype_name,),
                                                          pairs=chip_smoke.ELL_PAIRS, tag="ell")
    assert not failures, failures
    assert {(r["run"], r["verdict"]) for r in results if r["must"] == "fail"} == {
        ("K6 seed+1", "fail"), ("K6 rate 0.25", "fail")}
    for r in results:
        if r["run"] in ("kernel", "plain again"):
            assert all(row["loss_rel_diff"] == row["grad_rel_diff"] == row["param_max_diff"] == 0
                       for row in r["rows"]), r
    expected = chip_smoke.expected_launches(trainer, 2, 0)
    assert expected["K6 forward"] == expected["K6 backward"] == 4
    assert expected["K6 projected forward"] == expected["K6 projected backward"] == 2
    assert expected["K5 forward"] == expected["K4"] == 0


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 5, 2**32 - 1])
def test_tensor_seed_gives_the_int_seeds_mask_bit_for_bit(seed):
    """K6 takes its seed as an int or as the one-element int32 tensor the
    kernel reads from device memory: the plain version gives the same bits
    in all four directions either way."""
    data = sbm(2, num_nodes=256)
    N = len(data.features)
    kernel = ell.ELLGraphKernel(*edges_of(data), N, 2, device="cpu", **CONFIG_PLAN)
    rng = np.random.RandomState(2)
    V = torch.from_numpy(rng.rand(N, 8).astype(np.float32))
    Vr = torch.from_numpy(rng.rand(2 * N, 8).astype(np.float32))
    tensor = hashing.seed_tensor(seed)
    outs = []
    for s in (seed, tensor):
        Vg, Vrg = V.clone().requires_grad_(), Vr.clone().requires_grad_()
        out = kernel.neighbor_aggregate(Vg, s, 0.3)
        out_p = kernel.neighbor_aggregate_projected(Vrg, s, 0.3)
        grads = torch.autograd.grad((out.sum() + out_p.sum()), (Vg, Vrg))
        outs.append((out, out_p, *grads))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert torch.equal(hashing.keep_bits(kernel.tables.fwd.gid, tensor, 0.3),
                       hashing.keep_bits(kernel.tables.fwd.gid, seed, 0.3))
