"""K4b (K4's backward) on the CPU: the transposed plan against grl_tpu's
sender-major tables, the plain walks that the kernels follow against the
segment form and against grl_tpu's custom VJP, and the wrapper's routing
and refusals.

``attend_backward_walks`` computes what K4b's two launches compute, in the
same two steps (a receiver-major walk writing df and one (dscore, alpha)
pair per edge, a sender-major walk gathering the pairs through ``t_edge``),
so these tests prove the indexing the kernels depend on; the kernels
themselves are held to it on the card (tests/test_torch_cuda.py,
chip_smoke.py). float32 on both sides: the segment form within 1e-6 of
the output's scale (summation order, and ``u / l`` for ``sum alpha
dalpha``), grl_tpu's VJP within 1e-5, as
tests/test_torch_sparse_attention.py holds K4's gradients.
"""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from grl_tpu.ops.pallas import sparse_attention as jax_attention
from grl_torch.ops import sparse_attention as attention


@pytest.fixture(autouse=True)
def interpret_mode():
    prev = jax_attention.INTERPRET
    jax_attention.INTERPRET = True
    yield
    jax_attention.INTERPRET = prev


def graph(kind: str, N: int = 64, E: int = 400, seed: int = 0):
    """Random edges into all but the last 3 receivers (isolated), with a
    hub wider than MAX_PALLAS_WIDTH at receiver 0 (``hub``) or every edge
    listed twice (``duplicates``)."""
    rng = np.random.RandomState(seed)
    senders = rng.randint(0, N, E).astype(np.int32)
    receivers = rng.randint(0, N - 3, E).astype(np.int32)
    if kind == "hub":
        receivers[: jax_attention.MAX_PALLAS_WIDTH + 20] = 0
    if kind == "duplicates":
        senders, receivers = np.concatenate([senders, senders]), np.concatenate([receivers, receivers])
    return senders, receivers, N


def operands(N, K=8, F=32, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randn(N, d).astype(np.float32) for d in (K, K, F, F)]


KINDS = ["plain", "hub", "duplicates"]


def flat_cells(plan):
    """grl_tpu's raveled bucket tables: per cell its (row, idx, gid, valid)."""
    rows = np.concatenate([np.repeat(np.asarray(r), b.idx.shape[1]) for b, r in
                           zip(plan.buckets, jax_attention._split_rows(plan))])
    cat = [np.concatenate([np.asarray(getattr(b, k)).ravel() for b in plan.buckets]) for k in ("idx", "gid", "weight")]
    return rows, cat[0], cat[1], cat[2] > 0


@pytest.mark.parametrize("kind", KINDS)
def test_transposed_plan_lists_grl_tpus_sender_major_edges(kind):
    """Each sender's edges in the transposed CSR are the edges of its row
    in grl_tpu's ``bwd`` tables, and ``t_edge`` points at each edge's
    receiver-major slot: the slot holds the same edge as the forward cell
    grl_tpu's ``gid`` addresses."""
    senders, receivers, N = graph(kind)
    plan = attention.plan_attention(senders, receivers, N)
    theirs = jax_attention.SparseAttentionKernel(senders, receivers, num_nodes=N)
    # The original edge id of each receiver-major slot, and of each grl_tpu forward cell.
    order = np.argsort(receivers, kind="stable")
    _, _, fwd_gid, _ = flat_cells(theirs._fwd)
    bwd_rows, bwd_idx, bwd_gid, bwd_valid = flat_cells(theirs._bwd)
    colptr, t_receivers, t_edge = (t.numpy() for t in (plan.colptr, plan.t_receivers, plan.t_edge))
    np.testing.assert_array_equal(np.diff(colptr), np.bincount(senders, minlength=N))
    np.testing.assert_array_equal(plan.senders.numpy()[t_edge], np.repeat(np.arange(N), np.diff(colptr)))
    np.testing.assert_array_equal(plan.receivers.numpy()[t_edge], t_receivers)
    for s in range(N):
        ours = order[t_edge[colptr[s]:colptr[s + 1]]]
        cells = (bwd_rows == s) & bwd_valid
        np.testing.assert_array_equal(np.sort(ours), np.sort(fwd_gid[bwd_gid[cells]]), err_msg=f"sender {s}")
        np.testing.assert_array_equal(np.sort(t_receivers[colptr[s]:colptr[s + 1]]), np.sort(bwd_idx[cells]))
    # Within a sender, edges keep their receiver-major order (a stable sort).
    assert all(np.all(np.diff(t_edge[colptr[s]:colptr[s + 1]]) > 0) for s in range(N))


@pytest.mark.parametrize("kind", KINDS)
def test_walks_equal_the_segment_form(kind):
    senders, receivers, N = graph(kind, seed=3)
    plan = attention.plan_attention(senders, receivers, N)
    args = [torch.from_numpy(a) for a in operands(N, seed=4)]
    walks = attention.attend_backward_walks(*args, plan)
    segment = attention.attend_backward(*args, plan)
    for ours, ref, name in zip(walks, segment, "fgh"):
        assert ours.dtype == torch.float32
        scale = float(ref.abs().max())
        torch.testing.assert_close(ours, ref, rtol=1e-6, atol=1e-6 * scale, msg=f"d{name}")
    # Nodes with no edge in a direction get zero rows.
    assert torch.all(walks[0][N - 3:] == 0)
    no_out = plan.colptr[1:] == plan.colptr[:-1]
    assert torch.all(walks[1][no_out] == 0) and torch.all(walks[2][no_out] == 0)


@pytest.mark.parametrize("kind", KINDS)
def test_walks_match_grl_tpus_vjp(kind):
    senders, receivers, N = graph(kind, seed=5)
    f, g, h, dout = operands(N, seed=6)
    plan = attention.plan_attention(senders, receivers, N)
    theirs = jax_attention.SparseAttentionKernel(senders, receivers, num_nodes=N)
    _, vjp = jax.vjp(theirs.attend, *map(jnp.asarray, (f, g, h)))
    expected = vjp(jnp.asarray(dout))
    walks = attention.attend_backward_walks(*map(torch.from_numpy, (f, g, h, dout)), plan)
    for ours, ref, name in zip(walks, expected, "fgh"):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5, err_msg=f"d{name}")


def test_pairs_are_dscore_and_alpha_in_receiver_major_order():
    """The receiver walk's pairs: alpha is the forward's softmax per
    receiver (summing to 1), dscore sums to 0 per receiver."""
    senders, receivers, N = graph("hub", seed=7)
    plan = attention.plan_attention(senders, receivers, N)
    f, g, h, dout = (torch.from_numpy(a) for a in operands(N, seed=8))
    _, pairs = attention.receiver_walk(f, g, h, dout, plan)
    assert pairs.shape == (len(senders), 2) and pairs.dtype == torch.float32
    r = plan.receivers.long()
    torch.testing.assert_close(pairs[:, 1], attention._alpha(f, g, plan), rtol=1e-6, atol=1e-7)
    alive = plan.rowptr[1:] > plan.rowptr[:-1]
    sums = torch.zeros(N).index_add_(0, r, pairs[:, 1])
    torch.testing.assert_close(sums[alive], torch.ones(int(alive.sum())), rtol=0, atol=1e-6)
    dsums = torch.zeros(N).index_add_(0, r, pairs[:, 0])
    assert float(dsums.abs().max()) <= 1e-6 * float(pairs[:, 0].abs().max()) * 64


def test_bf16_walks_compute_in_f32_and_cast_once():
    senders, receivers, N = graph("hub", seed=9)
    plan = attention.plan_attention(senders, receivers, N)
    bf16 = [torch.from_numpy(a).to(torch.bfloat16) for a in operands(N, seed=10)]
    ours = attention.attend_backward_walks(*bf16, plan)
    wide = attention.attend_backward_walks(*(t.float() for t in bf16), plan)
    for out, ref in zip(ours, wide):
        assert out.dtype == torch.bfloat16
        assert torch.equal(out, ref.to(torch.bfloat16))


def test_attend_grad_takes_the_walks_on_the_cpu_and_refuses_other_devices():
    senders, receivers, N = graph("hub", seed=11)
    plan = attention.plan_attention(senders, receivers, N)
    args = [torch.from_numpy(a) for a in operands(N, seed=12)]
    for ours, ref in zip(attention.attend_grad(*args, plan), attention.attend_backward_walks(*args, plan)):
        assert torch.equal(ours, ref)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        attention.attend_grad(*(torch.zeros(N, d, device="meta") for d in (8, 8, 32, 32)), plan)
    # The autograd function's backward is attend_grad.
    leaves = [a.clone().requires_grad_() for a in args[:3]]
    kernel = attention.SparseAttentionKernel(senders, receivers, N, device="cpu")
    (kernel.attend(*leaves) * args[3]).sum().backward()
    for leaf, ref in zip(leaves, attention.attend_backward_walks(*args, kernel.plan)):
        assert torch.equal(leaf.grad, ref)


@pytest.mark.parametrize("N, K, F, itemsize, group, blocks", [
    (169343, 16, 128, 2, 16, 528),  # the arxiv shape, bf16: 16 vectors of an h row
    (169343, 16, 128, 4, 32, 528),  # float32: 32 vectors
    (169343, 16, 264, 4, 32, 528),  # wider rows take several passes of 32 lanes
    (100, 16, 16, 4, 4, 2),  # 4 vectors; 64 groups a block
    (100, 64, 16, 2, 2, 1),  # lanes own whole f and g rows: K no longer sets the group
    (0, 16, 128, 2, 16, 1),
])
def test_backward_launch(N, K, F, itemsize, group, blocks):
    launch = attention.backward_launch(N, K, F, itemsize, 132)
    assert launch == attention.BackwardLaunch(group, blocks, attention.BACKWARD_STAGES)
    assert launch.smem == attention.BACKWARD_STAGES * attention.THREADS * 16 + attention.THREADS * (group + 1) * 4


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("F", [128, 512])
def test_backward_ring_fits_shared_memory(F, itemsize):
    """Each lane's ring holds one 16-byte slot a row in flight (the
    per-lane cp.async feed), whatever F, beside a row of G + 1 dalpha parts
    a lane: at every depth the kernel takes, a block fits the 227 KB a
    block may use, and at the planned depth the blocks of one wave
    (BLOCKS_PER_SM an SM, 1 KB each reserved) fit the SM's 228 KB."""
    planned = attention.backward_launch(169343, 16, F, itemsize, 132)
    assert planned.stages == attention.BACKWARD_STAGES and planned.stages in (2, 4, 8)
    assert planned.group == min(32, F * itemsize // 16)
    assert attention.BLOCKS_PER_SM * (planned.smem + 1024) <= 233_472
    for stages in (2, 4, 8):
        launch = planned._replace(stages=stages)
        assert launch.smem == stages * 4096 + 256 * (planned.group + 1) * 4 <= 232_448


@pytest.mark.parametrize("K, itemsize, padded", [(16, 2, 16), (12, 2, 16), (4, 2, 8), (12, 4, 12), (3, 4, 4),
                                                 (64, 2, 64)])
def test_odd_k_is_padded_to_whole_vectors_without_changing_the_walks(K, itemsize, padded):
    """K4b loads f and g rows as 16-byte vectors, so the wrapper pads K to
    whole vectors with zero columns: every score stays as it is, and the
    padded walks' df and dg cut back to K are the unpadded walks' exactly
    (the extra columns are zero)."""
    assert attention._padded(K, itemsize) == padded
    dtype = {2: torch.bfloat16, 4: torch.float32}[itemsize]
    senders, receivers, N = graph("hub", seed=13)
    plan = attention.plan_attention(senders, receivers, N)
    f, g, h, dout = (torch.from_numpy(a).to(dtype) for a in operands(N, K=K, seed=14))
    fp, gp = attention._pad_rows(f), attention._pad_rows(g)
    assert fp.shape == gp.shape == (N, padded) and (fp.data_ptr() == f.data_ptr()) == (padded == K)
    df, pairs = attention.receiver_walk(f, g, h, dout, plan)
    dfp, pairs_p = attention.receiver_walk(fp, gp, h, dout, plan)
    dg, dh = attention.sender_walk(f, dout, pairs, plan)
    dgp, dhp = attention.sender_walk(fp, dout, pairs_p, plan)
    assert torch.equal(pairs_p, pairs) and torch.equal(dhp, dh)
    assert torch.equal(dfp[:, :K], df) and torch.equal(dgp[:, :K], dg)
    assert not dfp[:, K:].any() and not dgp[:, K:].any()


@pytest.mark.parametrize("change", [
    dict(dtype=torch.float64),
    dict(misaligned=True),
    dict(K=132),
    dict(F=12),
    dict(launch=attention.BackwardLaunch(3, 4, 4)),
    dict(launch=attention.BackwardLaunch(64, 4, 4)),
    dict(launch=attention.BackwardLaunch(16, 4, 3)),  # a ring of 3 rows: not a power of two
    dict(launch=attention.BackwardLaunch(16, 0, 4)),
    dict(launch=attention.BackwardLaunch(16, 4, 16)),  # deeper than the kernel's 8
    dict(K=40),  # 160-byte float32 f and g rows: a lane holds at most 128 bytes
    dict(K=72, dtype=torch.bfloat16),  # 144 bytes
])
def test_launch_refuses_what_it_cannot_take(change):
    """Checked before anything is built or launched."""
    K, F = change.get("K", 16), change.get("F", 128)
    senders, receivers, N = graph("plain")
    plan = attention.plan_attention(senders, receivers, N)
    f, g, h, dout = (torch.randn(N, d, dtype=change.get("dtype", torch.float32)) for d in (K, K, F, F))
    if change.get("misaligned"):
        dout = torch.randn(N * F + 1)[1:].view(N, F)
    with pytest.raises((TypeError, ValueError)):
        attention._launch_receivers(f, g, h, dout, plan, change.get("launch"))
    with pytest.raises((TypeError, ValueError)):
        attention._launch_senders(f, dout, torch.zeros(len(senders), 2), plan, change.get("launch"))
