"""K7 and the tile-dense hybrid in grl_torch against grl_tpu.

grl_tpu's tile kernel is plain XLA and runs on the CPU as it is. The
port's planner must give grl_tpu's tables exactly (tiles, ``col``,
``out_block``, ``inv_perm`` per relation and direction), the same
``node_perm``, tile and covered-edge counts and residual ELL tables; its
aggregation (the plain version of K7 plus K6's, on the CPU) is held
against grl_tpu's forward and VJP in both modes at rates 0 and 0.3 on one
seed (float32 in another summation order: within 1e-5 of the output's
scale), with the pair-hash masks equal bit for bit. FullGraphProcedure
with ``kernel_impl: tile`` runs tests/test_tile.py's recipe. The CUDA
kernel is held to the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from grl_tpu import models as jax_models
from grl_tpu.data import large_graph as jax_large_graph
from grl_tpu.ops import kernels as jax_kernels
from grl_tpu.ops import tile as jax_tile
from grl_tpu.trainer.procedures.full_graph_procedure import FullGraphProcedure as JaxFullGraph
from grl_torch import models
from grl_torch.data import large_graph
from grl_torch.ops import ell, hashing, kernels, launches, tile
from grl_torch.trainer.procedures.full_graph_procedure import FullGraphProcedure


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite spreads files over worker processes on shared cores: one
    intra-op thread per worker keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def clustered_graph(seed=0, N=700, L=2, E=9000, n_com=5, intra=0.8):
    """A community-clustered random graph over scattered node ids, with
    duplicate edges (tests/test_tile.py's generator) and every 17th edge
    masked out (weight 0, dropped at plan time)."""
    rng = np.random.RandomState(seed)
    com = rng.randint(0, n_com, N)
    send = rng.randint(0, N, E)
    order = np.argsort(com, kind="stable")
    starts = np.searchsorted(com[order], np.arange(n_com))
    counts = np.bincount(com, minlength=n_com)
    same = rng.rand(E) < intra
    pick = rng.randint(0, np.maximum(counts[com[send]], 1))
    recv = np.where(same, order[starts[com[send]] + pick], rng.randint(0, N, E))
    rel = rng.randint(0, L, E)
    w = rng.rand(E).astype(np.float32) + 0.5
    w[::17] = 0.0
    return (send, recv, rel, w), N, L


PLAN = dict(tile_size=64, tile_min_edges=40, plan_projected=True)


def both_kernels(edges, N, L, **plan):
    plan = {**PLAN, **plan}
    return tile.TileGraphKernel(*edges, N, L, device="cpu", **plan), jax_tile.TileGraphKernel(*edges, N, L, **plan)


def assert_plans_equal(ours, theirs):
    """Every relation's buckets (tiles, col, out_block) and inv_perm."""
    views = ours.relation_views()
    assert len(views) == len(theirs)
    for view, plan in zip(views, theirs):
        if plan is None:
            assert view is None
            continue
        buckets, inv_perm = view
        assert len(buckets) == len(plan.buckets)
        for (tiles, col, out_block), bucket in zip(buckets, plan.buckets):
            np.testing.assert_array_equal(tiles.float().numpy(), np.asarray(bucket.tiles).astype(np.float32))
            assert tiles.dtype == getattr(torch, str(np.asarray(bucket.tiles).dtype))
            np.testing.assert_array_equal(col.numpy(), np.asarray(bucket.col))
            np.testing.assert_array_equal(out_block.numpy(), np.asarray(bucket.out_block))
        np.testing.assert_array_equal(inv_perm.numpy(), np.asarray(plan.inv_perm))


def assert_ell_equal(ours, theirs):
    """The residual's four planned directions, as tests/test_torch_ell.py holds them."""
    t = theirs.tables
    pairs = [(ours.tables.fwd, t.fwd, t.fwd_inv), (ours.tables.bwd, t.bwd, t.bwd_inv)]
    if t.proj is not None:
        pairs += [(ours.tables.proj.fwd, t.proj.fwd, t.proj.fwd_inv), (ours.tables.proj.bwd, t.proj.bwd, t.proj.bwd_inv)]
    for tables, buckets, inv in pairs:
        for view, bucket in zip(tables.bucket_views(), buckets):
            for got, want in zip(view, bucket):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if inv is None:
            assert tables.inv_perm is None
        else:
            np.testing.assert_array_equal(tables.inv_perm.numpy(), np.asarray(inv))


@pytest.mark.parametrize("tile_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reorder", ["none", "lpa", "rcm"])
@pytest.mark.parametrize("L", [1, 3])
def test_planner_matches_grl_tpu(L, reorder, tile_dtype):
    """Tables of both directions, node_perm, the tile and covered-edge
    counts and the residual ELL tables equal grl_tpu's; the per-row tile
    counts cover every tile and the padding slots hold zero tiles."""
    edges, N, L = clustered_graph(seed=L, L=L, E=6000 * L)
    ours, theirs = both_kernels(edges, N, L, reorder=reorder, tile_dtype=tile_dtype)
    assert ours.tiles_total == theirs.tiles_total > 0
    assert ours.covered_edges == theirs.covered_edges > 0
    assert ours.tile_min_edges == theirs.tile_min_edges and ours.nb == theirs.nb
    if reorder == "none":
        assert ours.node_perm is None and theirs.node_perm is None
    else:
        np.testing.assert_array_equal(ours.node_perm, theirs.node_perm)
    assert_plans_equal(ours.tables.fwd, theirs.tables.fwd)
    assert_plans_equal(ours.tables.bwd, theirs.tables.bwd)
    assert ours.tables.proj == () and theirs.tables.proj == ()
    assert_ell_equal(ours._ell, theirs._ell)
    for plan in (ours.tables.fwd, ours.tables.bwd):
        assert plan.num_tiles == ours.tiles_total and plan.rows.shape[0] == plan.out_block.numel()
        B = plan.B
        for first, width, count in plan.rows.tolist():
            row = plan.tiles[first * B * B:(first + width) * B * B].view(B, width * B)
            assert count <= width and not bool(row[:, count * B:].any())


def test_build_tile_tables_matches_grl_tpu():
    """One direction straight from the builder, with duplicate edges in one
    tile cell (their weights add: one cell, so one keep decision) and
    block-rows with no tile."""
    rng = np.random.RandomState(4)
    nb, B = 6, 16
    keys = np.array([0 * nb + 1, 0 * nb + 4, 2 * nb + 2, 2 * nb + 3, 2 * nb + 5, 5 * nb + 0])
    pick = rng.randint(0, len(keys), 400)
    out_blk, src_blk = keys[pick] // nb, keys[pick] % nb
    out_loc, src_loc = rng.randint(0, B, 400), rng.randint(0, B, 400)
    out_loc[:5], src_loc[:5], out_blk[:5], src_blk[:5] = 3, 7, 2, 3  # five edges, one cell
    weights = (rng.rand(400) + 0.5).astype(np.float32)
    ours = tile._build_tile_tables(out_blk, src_blk, out_loc, src_loc, weights, nb, B, keys)
    theirs = jax_tile._build_tile_tables(out_blk, src_blk, out_loc, src_loc, weights, nb, B, keys)
    assert len(ours.buckets) == len(theirs.buckets) == 3
    for mine, want, count in zip(ours.buckets, theirs.buckets, ours.counts):
        for got, exp in zip(mine, want):
            np.testing.assert_array_equal(got, np.asarray(exp))
        assert count.dtype == np.int32 and len(count) == len(mine.col)
    np.testing.assert_array_equal(ours.inv_perm, np.asarray(theirs.inv_perm))
    assert np.concatenate(ours.counts).sum() == len(keys)


def test_uniform_graph_plans_no_tile_and_runs_pure_ell():
    """No block of a uniform sparse graph clears the threshold: no tile in
    either package, and the aggregation is the ELL kernel's, forward and
    projected, equal to grl_tpu's."""
    rng = np.random.RandomState(0)
    N, L, E = 3000, 2, 9000
    edges = (rng.randint(0, N, E), rng.randint(0, N, E), rng.randint(0, L, E), np.ones(E, np.float32))
    ours, theirs = both_kernels(edges, N, L, tile_min_edges=None, reorder="lpa")
    assert ours.tiles_total == theirs.tiles_total == 0 and ours.covered_edges == 0
    assert ours.tables.fwd is None and ours.tables.bwd is None and ours._ell is not None
    np.testing.assert_array_equal(ours.node_perm, theirs.node_perm)
    assert_ell_equal(ours._ell, theirs._ell)
    V = rng.randn(N, 8).astype(np.float32)
    out = ours.neighbor_aggregate(torch.from_numpy(V), 3, 0.3)
    assert torch.equal(out, ours._ell.neighbor_aggregate(torch.from_numpy(V), 3, 0.3))
    expected = np.asarray(jax.jit(lambda v: theirs.neighbor_aggregate(v, 3, 0.3))(jnp.asarray(V)))
    np.testing.assert_allclose(out.numpy(), expected, rtol=0, atol=1e-5 * np.abs(expected).max())
    Vr = rng.randn(N * L, 8).astype(np.float32)
    out = ours.neighbor_aggregate_projected(torch.from_numpy(Vr), 3, 0.3)
    expected = np.asarray(jax.jit(lambda v: theirs.neighbor_aggregate_projected(v, 3, 0.3))(jnp.asarray(Vr)))
    np.testing.assert_allclose(out.numpy(), expected, rtol=0, atol=1e-5 * np.abs(expected).max())


@pytest.mark.parametrize("B", [16, 32, 64, 128, 192, 256, 384, 512])
def test_default_min_edges_matches_grl_tpu(B):
    assert tile.default_min_edges(B) == jax_tile.default_min_edges(B)
    assert tile.default_min_edges(B, 512) == jax_tile.default_min_edges(B, 512)


def test_degree_reorder_is_refused_in_both():
    edges, N, L = clustered_graph()
    for cls in (tile.TileGraphKernel, jax_tile.TileGraphKernel):
        with pytest.raises(ValueError, match="unknown reorder"):
            cls(*edges, N, L, reorder="degree")


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**32 - 1])
def test_pair_hash_matches_grl_tpu_bit_for_bit(seed):
    """The keep bits and scales of the pair hash, under each relation's mix,
    from an int and from a tensor seed."""
    rng = np.random.RandomState(seed % 1000)
    recv = rng.randint(0, 2**31 - 1, 20000)
    send = rng.randint(0, 2**31 - 1, 20000)
    for r in range(3):
        mix = tile._rel_seed_mix(r)
        assert mix == jax_tile._rel_seed_mix(r)
        want = np.asarray(jax_tile._hash_keep_pair(
            jnp.asarray(recv.astype(np.int32)), jnp.asarray(send.astype(np.int32)),
            jnp.asarray(np.uint32(seed)) ^ jnp.uint32(mix), 0.3))
        for s in (seed, hashing.seed_tensor(seed)):
            got = hashing.hash_keep_pair(torch.from_numpy(recv), torch.from_numpy(send), s, 0.3, mix)
            np.testing.assert_array_equal(got.numpy(), want)
    assert 0.65 < float((want != 0).mean()) < 0.75


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("L", [1, 3])
def test_aggregation_and_vjp_match_grl_tpu(L, rate):
    """neighbor_aggregate and neighbor_aggregate_projected, forward and VJP
    (the tile part plus the ELL residual), on one seed."""
    edges, N, L = clustered_graph(seed=10 + L, L=L, E=6000 * L)
    ours, theirs = both_kernels(edges, N, L, reorder="lpa")
    assert ours.tiles_total > 0 and ours._ell is not None
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
        np.testing.assert_allclose(out.detach().numpy(), expected, rtol=0, atol=1e-5 * np.abs(expected).max())
        np.testing.assert_allclose(tX.grad.numpy(), dX, rtol=0, atol=1e-5 * np.abs(dX).max())


def test_keep_set_is_grl_tpus_bit_for_bit():
    """V = I reads every kept edge back (each output a single term): equal
    to grl_tpu's, bit for bit, in both modes; the transposed tables keep the
    same tile edges as the forward ones."""
    edges, N, L = clustered_graph(seed=5, N=320, L=2, E=9000)
    ours, theirs = both_kernels(edges, N, L, reorder="lpa")
    assert ours.tiles_total > 0
    for width, method in ((N, "neighbor_aggregate"), (N * L, "neighbor_aggregate_projected")):
        eye = np.eye(width, dtype=np.float32)
        got = getattr(ours, method)(torch.from_numpy(eye), 77, 0.3).numpy()
        want = np.asarray(jax.jit(lambda v: getattr(theirs, method)(v, 77, 0.3))(jnp.asarray(eye)))
        np.testing.assert_array_equal(got, want)
    fwd, bwd = ours.tables.fwd, ours.tables.bwd
    ahead = tile.tile_accumulate(torch.eye(N), fwd, 77, 0.3, "forward").view(N, L, N)
    back = tile.tile_accumulate(torch.eye(N), bwd, 77, 0.3, "projected backward").view(N, L, N)
    np.testing.assert_array_equal((ahead != 0).numpy(), (back != 0).permute(2, 1, 0).numpy())
    kept = ahead[ahead != 0]
    assert 0 < kept.numel() < int((tile.tile_accumulate(torch.eye(N), fwd, 77, 0.0, "forward") != 0).sum())


def test_tensor_seed_gives_the_int_seeds_bits():
    edges, N, L = clustered_graph(seed=2)
    kernel = tile.TileGraphKernel(*edges, N, L, device="cpu", **PLAN)
    V = torch.randn(N, 8, generator=torch.Generator().manual_seed(0))
    for seed in (5, 2**32 - 1):
        assert torch.equal(kernel.neighbor_aggregate(V, seed, 0.3),
                           kernel.neighbor_aggregate(V, hashing.seed_tensor(seed), 0.3))


def test_refusals_and_surface():
    edges, N, L = clustered_graph(seed=3)
    plain = tile.TileGraphKernel(*edges, N, L, device="cpu", tile_size=64, tile_min_edges=40)
    assert plain.tiles_total > 0 and plain.tables.proj is None and plain.node_perm is not None
    assert set(plain.plan_seconds) == {"reorder", "tile tables", "ell residual"}
    before = launches.device_counts()
    V = torch.randn(N, 8)
    assert plain.pad_features(V) is V
    with pytest.raises(ValueError, match="plan_projected"):
        plain.neighbor_aggregate_projected(torch.randn(N * L, 8))
    with pytest.raises(ValueError, match="rows"):
        plain.neighbor_aggregate(torch.randn(N - 1, 8))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tile.tile_accumulate(torch.zeros(N, 8, device="meta"), plain.tables.fwd)
    with pytest.raises(ValueError, match="direction"):
        tile.tile_accumulate(V, plain.tables.fwd, direction="sideways")
    with pytest.raises(ValueError):
        plain.neighbor_aggregate(V, 1, 1.0)
    # V may carry rows past num_nodes: never read, zero gradient.
    padded = torch.cat([V, torch.ones(4, 8)]).requires_grad_()
    out = plain.neighbor_aggregate(padded, 3, 0.3)
    out.sum().backward()
    assert torch.equal(out, plain.neighbor_aggregate(V, 3, 0.3))
    assert padded.grad.shape == (N + 4, 8) and torch.all(padded.grad[N:] == 0)
    assert launches.device_counts() == before  # CPU tensors: plain version, never a launch


def test_attach_kernel_plans_tile_in_the_reordered_space_like_grl_tpu():
    """kernel_impl tile through attach_kernel: the carried edges are
    relabeled through node_perm in both packages."""
    data = large_graph.sbm_relational_graph(num_nodes=800, num_classes=4, num_relations=2, avg_degree=8,
                                            feature_dim=8, communities=10, seed=3)
    graph, _ = large_graph.to_relational_graph(data, device="cpu")
    jgraph, _ = jax_large_graph.to_relational_graph(data)
    adj = kernels.attach_kernel(graph, "tile", tile_size=64, tile_min_edges=40)
    jadj = jax_kernels.attach_kernel(jgraph, "tile", tile_size=64, tile_min_edges=40)
    assert isinstance(adj.kernel, tile.TileGraphKernel) and adj.kernel.tiles_total == jadj.kernel.tiles_total > 0
    np.testing.assert_array_equal(adj.kernel.node_perm, jadj.kernel.node_perm)
    np.testing.assert_array_equal(adj.senders.numpy(), np.asarray(jadj.senders))
    np.testing.assert_array_equal(adj.receivers.numpy(), np.asarray(jadj.receivers))


# ---------------------------------------------------------------------------
# FullGraphProcedure on kernel_impl: tile (tests/test_tile.py:200-247's recipe)
# ---------------------------------------------------------------------------
MODEL = dict(input_dim=16, output_dim=5, num_edges=1, net_size=32, use_attention=False, kernel_impl="tile",
             dropout_rate=0.0, edge_dropout_rate=0.0)
TILE_PLAN = {"tile_size": 64, "tile_min_edges": 40, "plan_projected": True}


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def step_config(tmp_path):
    return {
        "output_dir": str(tmp_path), "seed": 0, "max_grad_norm": 0.5, "num_epochs": 2,
        "optimizer": {"type": "BuiltinOptimizer", "args": {"type_optimizer": "Adam", "lr": 1e-3}},
        "kernel_plan": TILE_PLAN, "logging": {"use_tensorboard": False},
    }


def test_one_and_two_full_graph_steps_match_grl_tpu(tmp_path):
    """The clustered SBM of tests/test_tile.py with the LPA order, dropouts
    off, project-first gcn3, a clip that binds: eval logits, then the
    port's FullGraphProcedure.train_step against grl_tpu's step_body from
    the same variables, with features and labels placed through node_perm
    in both."""
    data = large_graph.sbm_relational_graph(num_nodes=1500, num_classes=5, num_relations=1, avg_degree=8,
                                            feature_dim=16, communities=12, noise=4.0, seed=0)
    jax_proc = JaxFullGraph(jax_models.create_model("GraphCNNDropEdge", **MODEL), step_config(tmp_path / "jax"), data)
    jax_proc._ensure_initialized()
    state = jax_proc.state
    model = models.create_model("GraphCNNDropEdge", **MODEL, device="cpu")
    model.load_state_dict(models.state_dict_from_flax(
        numpy_tree({"params": state.params, "constants": state.constants})))
    proc = FullGraphProcedure(model, step_config(tmp_path / "port"), data=data, device="cpu")
    proc._ensure_initialized()
    kernel = proc.graph.kernel
    assert isinstance(kernel, tile.TileGraphKernel) and kernel.tiles_total == jax_proc.graph.kernel.tiles_total > 0
    assert kernel.node_perm is not None and kernel.tables.proj is not None and kernel._ell is not None
    np.testing.assert_array_equal(kernel.node_perm, jax_proc.graph.kernel.node_perm)
    np.testing.assert_array_equal(proc.features.numpy(), np.asarray(jax_proc.features))
    np.testing.assert_array_equal(proc.train_labels.numpy(), np.asarray(jax_proc.train_labels))
    np.testing.assert_array_equal(proc.val_labels.numpy(), np.asarray(jax_proc.val_labels))

    logits = np.asarray(jax_proc.model.apply(state.variables(), (jax_proc.features, jax_proc.graph), train=False))
    with torch.no_grad():
        ours = model.eval()((proc.features, proc.graph)).numpy()
    np.testing.assert_allclose(ours, logits, rtol=0, atol=1e-5 * np.abs(logits).max())

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


# ---------------------------------------------------------------------------
# chip_smoke.py's tile-phase comparison on a small clustered graph: on the
# CPU every run takes K7's and K6's plain versions, so the kernel run and a
# second plain run agree with the plain run to the bit, and K7 with a wrong
# relation mix, or with its backward mask keyed on swapped endpoints, must
# fail FULL_GRAPH_STEP_LIMITS.
@pytest.fixture(scope="module")
def tile_comparison(tmp_path_factory):
    """The arxiv config's model on a 1024-node clustered SBM planned as
    tiles (B = 64, the LPA order, project-first), through the warper, and
    its weights after 60 steps at lr 1e-3."""
    import chip_smoke
    from grl_torch import GNNLearningWarper

    config = {
        "experiment_name": "tile", "seed": 0, "is_train": True, "checkpoint_path": None,
        "output_dir": str(tmp_path_factory.mktemp("tile")), "num_epochs": 1, "max_grad_norm": 5.0,
        "model": {"type": "GraphCNNDropEdge", "args": dict(MODEL, input_dim=32, output_dim=5, dropout_rate=0.5,
                                                            edge_dropout_rate=0.3)},
        "kernel_plan": {"tile_size": 64, "tile_min_edges": 30, "plan_projected": True},
        "data_config": {"large_graph": {"type": "sbm", "args": {
            "num_nodes": 1024, "num_classes": 5, "num_relations": 1, "avg_degree": 8, "feature_dim": 32,
            "communities": 12, "seed": 0}}},
        "procedure": {"type": "FullGraphProcedure", "args": {}},
        "optimizer": {"type": "BuiltinOptimizer", "args": {"type_optimizer": "Adam", "lr": 0.01}},
        "logging": {"use_tensorboard": False, "experiment_tracking": False},
    }
    trainer = GNNLearningWarper(config=config, device="cpu").trainer
    trainer._ensure_initialized()
    learner = chip_smoke.procedure_copy(torch, trainer, 0, 1e-3)
    for _ in range(60):
        learner.train_step()
    learned = {k: v.clone() for k, v in learner.model.state_dict().items()}
    return trainer, {"learned": (learned, 1e-3)}


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_full_graph_step_limits_fail_the_planted_k7_faults(tile_comparison, dtype_name):
    import chip_smoke

    trainer, starts = tile_comparison
    kernel = trainer.graph.kernel
    assert kernel.tiles_total > 0 and kernel._ell is not None and kernel.tables.proj is not None
    results, failures = chip_smoke.full_graph_comparisons(torch, trainer, starts, (dtype_name,),
                                                          pairs=chip_smoke.TILE_PAIRS, tag="tile")
    assert not failures, failures
    assert {(r["run"], r["verdict"]) for r in results if r["must"] == "fail"} == {
        ("K7 wrong relation mix", "fail"), ("K7 backward mask on swapped endpoints", "fail")}
    for r in results:
        if r["run"] in ("kernel", "plain again"):
            assert all(row["loss_rel_diff"] == row["grad_rel_diff"] == row["param_max_diff"] == 0
                       for row in r["rows"]), r
    expected = chip_smoke.expected_launches(trainer, 2, 0)
    assert expected["K7 forward"] == expected["K7 backward"] == expected["K6 forward"] == 4
    assert expected["K7 projected forward"] == expected["K7 projected backward"] == 2 and expected["K7"] == 12
    assert expected["D forward"] == 10 and expected["K5 forward"] == 0
