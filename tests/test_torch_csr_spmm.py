"""K0 and K5 in grl_torch against grl_tpu.

The hash (:mod:`grl_torch.ops.hashing`) must equal grl_tpu's
``_hash_keep`` bit for bit. The port's ``CSRGraphKernel`` (its plain
version, on the CPU) is held against grl_tpu's Pallas CSR kernel run in
interpret mode, as tests/test_csr_spmm.py runs it, forward and dV by VJP:
with the same edge ids both draw the same DropEdge mask, so at rate 0.3
the outputs agree like the unmasked ones. Both accumulate in float32 in
another order: within 1e-5 of the output's scale. The CUDA kernel is held
to the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from grl_tpu.ops.pallas import csr_spmm as jax_csr
from grl_torch.ops import csr_spmm, hashing


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
    with pltpu.force_tpu_interpret_mode():
        yield
    jax_csr.INTERPRET = False


# The TPU tiling of tests/test_csr_spmm.py: several blocks and chunks.
TPU_PLAN = dict(block_rows=128, chunk_cols=128, edge_quantum=64, unroll=4)


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
def test_hash_keep_is_grl_tpus_bit_for_bit(rate):
    gid = np.arange(2**20, dtype=np.int32)
    for seed in (0, 1, 12345, 2**31 - 1, -1, -(2**31)):
        ours = hashing.hash_keep(torch.from_numpy(gid), seed, rate).numpy()
        theirs = np.asarray(jax_csr._hash_keep(jnp.asarray(gid), jnp.int32(seed), rate))
        assert ours.dtype == theirs.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs, err_msg=f"seed {seed}")
        assert abs(float((ours > 0).mean()) - (1 - rate)) < 0.005
    # Negative int32 ids wrap to uint32 as in grl_tpu.
    neg = np.array([-1, -5, -(2**31)], np.int32)
    np.testing.assert_array_equal(
        hashing.hash_keep(torch.from_numpy(neg), 7, rate).numpy(),
        np.asarray(jax_csr._hash_keep(jnp.asarray(neg), jnp.int32(7), rate)),
    )
    with pytest.raises(ValueError):
        hashing.hash_keep(torch.from_numpy(gid[:4]), 0, 1.0)


def random_graph(seed, N, L, E, F):
    """Weights in [0.1, 1.1) with a tenth of them 0 (masked-out edges)."""
    rng = np.random.RandomState(seed)
    senders = rng.randint(0, N, E).astype(np.int32)
    receivers = rng.randint(0, N, E).astype(np.int32)
    relations = rng.randint(0, L, E).astype(np.int32)
    weights = (rng.rand(E) + 0.1).astype(np.float32)
    weights[rng.rand(E) < 0.1] = 0.0
    V = rng.randn(N, F).astype(np.float32)
    g = rng.randn(N, L * F).astype(np.float32)
    return (senders, receivers, relations, weights), V, g


def both_kernels(edges, N, L):
    ours = csr_spmm.CSRGraphKernel(*edges, N, L, **TPU_PLAN, device="cpu")
    theirs = jax_csr.CSRGraphKernel(*edges, N, L, **TPU_PLAN)
    return ours, theirs


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("L", [1, 3])
def test_forward_and_vjp_match_grl_tpu(L, rate):
    N, F = 256, 32 if L == 1 else 16
    edges, V, g = random_graph(seed=L, N=N, L=L, E=1200, F=F)
    ours, theirs = both_kernels(edges, N, L)
    seed = 11

    tV = torch.from_numpy(V).requires_grad_()
    out = ours.neighbor_aggregate(tV, seed, rate)
    (out * torch.from_numpy(g)).sum().backward()
    expected, vjp = jax.vjp(lambda v: theirs.neighbor_aggregate(v, seed, rate), jnp.asarray(V))
    (dV,) = vjp(jnp.asarray(g))

    assert out.shape == (N, L * F) and out.dtype == torch.float32
    scale = np.abs(np.asarray(expected)).max()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(expected), rtol=0, atol=1e-5 * scale)
    dscale = np.abs(np.asarray(dV)).max()
    np.testing.assert_allclose(tV.grad.numpy(), np.asarray(dV), rtol=0, atol=1e-5 * dscale)


def test_mask_is_keyed_on_the_edge_position():
    """At rate 0.3 each edge's contribution is w/keep or 0 by
    hash_keep(edge index): V = I reads the kept set back exactly, equal to
    the hash of the edge positions (unique edges, L = 2)."""
    N, L = 40, 2
    rng = np.random.RandomState(9)
    cells = rng.choice(N * L * N, 300, replace=False)
    receivers, rest = np.divmod(cells, L * N)
    relations, senders = np.divmod(rest, N)
    weights = np.ones(300, np.float32)
    kernel = csr_spmm.CSRGraphKernel(senders, receivers, relations, weights, N, L, device="cpu")
    out = kernel.neighbor_aggregate(torch.eye(N), seed=5, rate=0.3).reshape(N, L, N)
    kept = hashing.keep_bits(torch.arange(300), 5, 0.3).numpy()
    expected = np.zeros((N, L, N), bool)
    expected[receivers[kept], relations[kept], senders[kept]] = True
    np.testing.assert_array_equal(out.numpy() != 0, expected)
    np.testing.assert_array_equal(out.numpy()[expected], np.float32(1) / np.float32(0.7))
    # The transposed walk reads the same set: g = I over the N*L rows.
    dV = csr_spmm.csr_accumulate(torch.eye(N * L), kernel.backward_layout, 5, 0.3)
    np.testing.assert_array_equal(dV.numpy().reshape(N, N, L).transpose(1, 2, 0) != 0, expected)


def test_layouts_carry_gids_and_drop_zero_weights():
    edges, _, _ = random_graph(seed=4, N=50, L=3, E=400, F=8)
    senders, receivers, relations, weights = edges
    kernel = csr_spmm.CSRGraphKernel(*edges, 50, 3, device="cpu")
    fwd, bwd = kernel.forward_layout, kernel.backward_layout
    live = np.flatnonzero(weights != 0)
    assert kernel.num_edges == len(live)
    for layout, rows, cols in ((fwd, receivers * 3 + relations, senders),
                               (bwd, senders, receivers * 3 + relations)):
        gid = layout.gids.numpy()
        np.testing.assert_array_equal(np.sort(gid), live)
        np.testing.assert_array_equal(layout.row_ids().numpy(), rows[gid])
        np.testing.assert_array_equal(layout.cols.numpy(), cols[gid])
        np.testing.assert_array_equal(layout.weights.numpy(), weights[gid])
        assert np.all(np.diff(layout.rowptr.numpy()) >= 0)
    assert (fwd.num_rows, fwd.num_src_rows, bwd.num_rows, bwd.num_src_rows) == (150, 50, 50, 150)


def test_tpu_knobs_have_no_effect_and_unknown_ones_raise():
    edges, V, _ = random_graph(seed=6, N=80, L=2, E=500, F=8)
    a = csr_spmm.CSRGraphKernel(*edges, 80, 2, device="cpu")
    b = csr_spmm.CSRGraphKernel(*edges, 80, 2, block_rows=16, chunk_cols=8, edge_quantum=1,
                                unroll=2, feature_dim=4, vmem_budget=1, device="cpu")
    tV = torch.from_numpy(V)
    assert torch.equal(a.neighbor_aggregate(tV, 3, 0.3), b.neighbor_aggregate(tV, 3, 0.3))
    assert a.pad_features(tV) is tV
    for cls in (csr_spmm.CSRGraphKernel, jax_csr.CSRGraphKernel):
        with pytest.raises(TypeError):
            cls(*edges, 80, 2, width_quantum=2)
    with pytest.raises(ValueError):
        a.neighbor_aggregate(tV, 3, 1.0)


def test_padded_rows_get_zero_gradient():
    """V may carry rows past num_nodes (grl_tpu pads to whole chunks): they
    are never gathered, and their gradient is 0."""
    edges, V, g = random_graph(seed=7, N=60, L=1, E=300, F=8)
    kernel = csr_spmm.CSRGraphKernel(*edges, 60, 1, device="cpu")
    padded = torch.cat([torch.from_numpy(V), torch.ones(4, 8)]).requires_grad_()
    out = kernel.neighbor_aggregate(padded, 1, 0.3)
    (out * torch.from_numpy(g)).sum().backward()
    assert torch.equal(out, kernel.neighbor_aggregate(torch.from_numpy(V), 1, 0.3))
    assert padded.grad.shape == (64, 8) and torch.all(padded.grad[60:] == 0)


def test_wrapper_refuses_other_devices():
    edges, _, _ = random_graph(seed=8, N=10, L=1, E=20, F=8)
    kernel = csr_spmm.CSRGraphKernel(*edges, 10, 1, device="cpu")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        csr_spmm.csr_accumulate(torch.zeros(10, 8, device="meta"), kernel.forward_layout)
    with pytest.raises(ValueError, match="rows"):
        csr_spmm.csr_accumulate(torch.zeros(9, 8), kernel.forward_layout)


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 5, 2**32 - 1])
def test_tensor_seed_gives_the_int_seeds_mask_bit_for_bit(seed):
    """K5 takes its seed as an int or as the one-element int32 tensor the
    kernel reads from device memory: the plain version's forward and
    backward give the same bits either way."""
    N, L = 40, 2
    rng = np.random.RandomState(9)
    cells = rng.choice(N * L * N, 300, replace=False)
    receivers, rest = np.divmod(cells, L * N)
    relations, senders = np.divmod(rest, N)
    kernel = csr_spmm.CSRGraphKernel(senders, receivers, relations, np.ones(300, np.float32), N, L, device="cpu")
    tensor = hashing.seed_tensor(seed)
    assert torch.equal(hashing.keep_bits(torch.arange(300), tensor, 0.3), hashing.keep_bits(torch.arange(300), seed, 0.3))
    V = torch.from_numpy(rng.rand(N, 8).astype(np.float32))
    outs = []
    for s in (seed, tensor):
        Vg = V.clone().requires_grad_()
        out = kernel.neighbor_aggregate(Vg, s, 0.3)
        (dV,) = torch.autograd.grad(out, Vg, torch.ones_like(out))
        outs.append((out, dV))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
