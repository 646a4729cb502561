"""K1-K6 and P on the card: the CUDA kernels against their plain versions.

Needs an NVIDIA GPU and nvcc; elsewhere every test skips. This file
imports neither JAX nor grl_tpu, so it runs on a machine without them,
from the root of a checkout::

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
from __future__ import annotations

import pytest
import torch

import numpy as np

from grl_torch.ops import csr_spmm, ell, hashing, relagg, sparse_attention
from grl_torch.probes import gather

pytestmark = pytest.mark.cuda

B, L = 8, 6
# float32: both sides accumulate in float32, in another order. bfloat16:
# both accumulate in float32 and round once, so one bf16 rounding apart.
# K1/K2 and their plain versions draw the identical mask (one hash of the
# element index), so the same tolerances hold.
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
RATE = 0.3


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (chip_smoke.py runs these checks on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def operands(N, F, dtype, density=0.05, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    V = torch.randn(B, N, F, generator=gen, device="cuda").to(dtype)
    A = (torch.rand(B, N, L, N, generator=gen, device="cuda") < density).to(dtype)
    return V, A


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N, F", [(64, 256), (192, 512), (256, 256), (100, 40)])
def test_kernel_matches_plain_version(N, F, dtype):
    V, A = operands(N, F, dtype)
    before = relagg.neighbor_aggregate.launches
    out = relagg.neighbor_aggregate(V, A)
    torch.cuda.synchronize()
    assert relagg.neighbor_aggregate.launches == before + 1
    assert out.shape == (B, N, L, F) and out.dtype == dtype
    ref = relagg.neighbor_aggregate_reference(V, A)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])


def test_backward_on_the_card():
    V, A = operands(128, 64, torch.float32, density=0.1)
    V.requires_grad_()
    W = torch.randn(B, 128, L, 64, device="cuda")
    (relagg.neighbor_aggregate(V, A) * W).sum().backward()
    V_ref = V.detach().clone().requires_grad_()
    (relagg.neighbor_aggregate_reference(V_ref, A) * W).sum().backward()
    torch.testing.assert_close(V.grad, V_ref.grad, rtol=1e-4, atol=1e-4)


def test_kernel_refuses_what_it_cannot_take():
    V, A = operands(64, 32, torch.float16)
    with pytest.raises(TypeError):
        relagg.neighbor_aggregate(V, A)
    V, A = operands(64, 32, torch.float32)
    with pytest.raises(ValueError):
        relagg.neighbor_aggregate(V.transpose(1, 2).contiguous().transpose(1, 2), A)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N, F", [(64, 256), (192, 512), (256, 256), (100, 40)])
def test_dropedge_kernels_match_plain_versions(N, F, dtype):
    V, A = operands(N, F, dtype, density=0.2, seed=N + F)
    g = torch.randn(B, N, L, F, device="cuda").to(dtype)
    k1, k2 = relagg.dropedge_aggregate.launches, relagg.dropedge_aggregate_grad.launches
    out = relagg.dropedge_aggregate(V, A, 11, RATE)
    dV = relagg.dropedge_aggregate_grad(g, A, 11, RATE)
    torch.cuda.synchronize()
    assert relagg.dropedge_aggregate.launches == k1 + 1
    assert relagg.dropedge_aggregate_grad.launches == k2 + 1
    assert out.shape == (B, N, L, F) and out.dtype == dtype
    assert dV.shape == (B, N, F) and dV.dtype == dtype
    ref = relagg.dropedge_aggregate_reference(V, A, 11, RATE)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])
    ref_dV = relagg.dropedge_aggregate_grad_reference(g, A, 11, RATE)
    torch.testing.assert_close(dV.float(), ref_dV.float(), rtol=TOL[dtype], atol=TOL[dtype])


def test_dropedge_forward_and_backward_see_one_mask():
    """The map V -> K1(V) is linear, so <K2(ones), V> = sum K1(V) exactly
    in real arithmetic; float32 sums in another order agree to ~1e-6."""
    V, A = operands(256, 256, torch.float32, density=0.2, seed=3)
    y = relagg.dropedge_aggregate(V, A, 5, RATE)
    dV = relagg.dropedge_aggregate_grad(torch.ones_like(y), A, 5, RATE)
    torch.testing.assert_close(
        (dV.double() * V.double()).sum(), y.double().sum(), rtol=1e-5, atol=1e-3
    )


def test_dropedge_autograd_runs_k2_and_rate_zero_is_k3():
    V, A = operands(128, 64, torch.float32, density=0.1)
    V.requires_grad_()
    W = torch.randn(B, 128, L, 64, device="cuda")
    k2 = relagg.dropedge_aggregate_grad.launches
    (relagg.dropedge_aggregate(V, A, 9, RATE) * W).sum().backward()
    assert relagg.dropedge_aggregate_grad.launches == k2 + 1
    V_ref = V.detach().clone().requires_grad_()
    (relagg.dropedge_aggregate_reference(V_ref, A, 9, RATE) * W).sum().backward()
    torch.testing.assert_close(V.grad, V_ref.grad, rtol=1e-4, atol=1e-4)
    k1, k3 = relagg.dropedge_aggregate.launches, relagg.neighbor_aggregate.launches
    plain = relagg.dropedge_aggregate(V.detach(), A, 9, 0.0)
    assert relagg.dropedge_aggregate.launches == k1 and relagg.neighbor_aggregate.launches == k3 + 1
    torch.testing.assert_close(plain, relagg.neighbor_aggregate_reference(V.detach(), A), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        relagg.dropedge_aggregate(V.detach(), A, 9, 1.0)


# ---------------------------------------------------------------------------
# K5 and K4. float32: both sides accumulate in float32 in another order,
# within 1e-5 of the output's scale. bfloat16: both accumulate in float32
# and round once, so one bf16 rounding apart (1e-2 relative).
# ---------------------------------------------------------------------------
def assert_close_to_plain(out, ref):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    scale = float(ref.float().abs().max())
    rtol = 1e-2 if ref.dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=1e-5 * scale)


def csr_graph(N, L, E, seed=0):
    rng = np.random.RandomState(seed)
    edges = (rng.randint(0, N, E), rng.randint(0, N - 5, E), rng.randint(0, L, E),
             (rng.rand(E) + 0.5).astype(np.float32))
    edges[3][:20] = 0.0  # masked-out edges
    return csr_spmm.CSRGraphKernel(*edges, N, L, device="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L, F", [(1, 256), (1, 512), (3, 40), (2, 8), (1, 1040)])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_k5_matches_plain_version(L, F, dtype, rate):
    kernel = csr_graph(2000, L, 12000, seed=F + L)
    V = torch.randn(2000, F, device="cuda").to(dtype).requires_grad_()
    launched = dict(csr_spmm.csr_accumulate.launches)
    out = kernel.neighbor_aggregate(V, 17, rate)
    g = torch.randn_like(out)
    (dV,) = torch.autograd.grad(out, V, g)
    torch.cuda.synchronize()
    assert csr_spmm.csr_accumulate.launches == {k: v + 1 for k, v in launched.items()}
    fwd, bwd = kernel.forward_layout, kernel.backward_layout
    assert_close_to_plain(out.view(-1, F), csr_spmm.csr_accumulate_reference(V.detach(), fwd, 17, rate))
    assert_close_to_plain(dV, csr_spmm.csr_accumulate_reference(g.reshape(-1, F), bwd, 17, rate))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_keep_set_is_the_plain_hash(dtype):
    """V = I: each output row shows exactly the edges the kernel kept."""
    N, L = 64, 3
    rng = np.random.RandomState(1)
    cells = rng.choice(N * L * N, 2000, replace=False)
    receivers, rest = np.divmod(cells, L * N)
    relations, senders = np.divmod(rest, N)
    kernel = csr_spmm.CSRGraphKernel(senders, receivers, relations, np.ones(2000, np.float32),
                                     N, L, device="cuda")
    eye = torch.eye(N, device="cuda", dtype=dtype)
    seen = kernel.neighbor_aggregate(eye, 99, 0.3).view(N, L, N) != 0
    kept = hashing.keep_bits(torch.arange(2000), 99, 0.3).numpy()
    expected = np.zeros((N, L, N), bool)
    expected[receivers[kept], relations[kept], senders[kept]] = True
    assert np.array_equal(seen.cpu().numpy(), expected)


def attention_problem(N, E, K, F, dtype, seed=0):
    rng = np.random.RandomState(seed)
    senders = rng.randint(0, N, E)
    receivers = rng.randint(0, N - 7, E)  # 7 receivers with no edge
    receivers[:300] = 3  # a hub far wider than 32
    kernel = sparse_attention.SparseAttentionKernel(senders, receivers, N, device="cuda")
    f, g, h = (torch.randn(N, d, device="cuda").to(dtype) for d in (K, K, F))
    return kernel, f, g, h


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K, F", [(16, 128), (2, 16), (12, 264), (16, 1040)])
def test_k4_matches_plain_version(K, F, dtype):
    kernel, f, g, h = attention_problem(3000, 20000, K, F, dtype, seed=K + F)
    launched = sparse_attention.attend_forward.launches
    out = kernel.attend(f, g, h)
    torch.cuda.synchronize()
    assert sparse_attention.attend_forward.launches == launched + 1
    assert_close_to_plain(out, sparse_attention.attend_reference(f, g, h, kernel.plan))
    assert torch.all(out[-7:] == 0)


def test_k4_gradients_are_the_plain_backward():
    kernel, f, g, h = attention_problem(500, 4000, 16, 128, torch.float32)
    args = [t.clone().requires_grad_() for t in (f, g, h)]
    w = torch.randn(500, 128, device="cuda")
    (kernel.attend(*args) * w).sum().backward()
    ref = [t.clone().requires_grad_() for t in (f, g, h)]
    (sparse_attention.attend_reference(*ref, kernel.plan) * w).sum().backward()
    for a, b in zip(args, ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-5 * float(b.grad.abs().max()))


# ---------------------------------------------------------------------------
# K6 (the ELL tables, configs/arxiv_full_graph.yaml's plan) and P.
# ---------------------------------------------------------------------------
CONFIG_PLAN = dict(plan_projected=True, width_quantum=2, bucket_growth=1, reorder="degree")


def ell_graph(N, L, E, seed=0):
    """Random edges with a hub of degree 300, 5 receivers with no edge and
    20 masked-out edges."""
    rng = np.random.RandomState(seed)
    receivers = rng.randint(0, N - 5, E)
    receivers[:300] = 7
    edges = (rng.randint(0, N, E), receivers, rng.randint(0, L, E), (rng.rand(E) + 0.5).astype(np.float32))
    edges[3][300:320] = 0.0
    return ell.ELLGraphKernel(*edges, N, L, device="cuda", **CONFIG_PLAN)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L, F", [(1, 256), (1, 512), (3, 40), (2, 8)])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_k6_matches_plain_version(L, F, dtype, rate):
    """All four directions: forward, backward, projected forward and
    projected backward, each one launch."""
    kernel = ell_graph(2000, L, 12000, seed=F + L)
    launched = dict(ell.ell_accumulate.launches)
    V = torch.randn(2000, F, device="cuda").to(dtype).requires_grad_()
    out = kernel.neighbor_aggregate(V, 17, rate)
    g = torch.randn_like(out)
    (dV,) = torch.autograd.grad(out, V, g)
    Vr = torch.randn(2000 * L, F, device="cuda").to(dtype).requires_grad_()
    out_p = kernel.neighbor_aggregate_projected(Vr, 17, rate)
    g_p = torch.randn_like(out_p)
    (dVr,) = torch.autograd.grad(out_p, Vr, g_p)
    torch.cuda.synchronize()
    assert ell.ell_accumulate.launches == {k: v + 1 for k, v in launched.items()}
    t = kernel.tables
    assert_close_to_plain(out.view(-1, F), ell.ell_accumulate_reference(V.detach(), t.fwd, 17, rate))
    assert_close_to_plain(dV, ell.ell_accumulate_reference(g.reshape(-1, F), t.bwd, 17, rate))
    assert_close_to_plain(out_p, ell.ell_accumulate_reference(Vr.detach(), t.proj.fwd, 17, rate))
    assert_close_to_plain(dVr, ell.ell_accumulate_reference(g_p, t.proj.bwd, 17, rate))
    assert torch.all(out.view(2000, L, F)[kernel.node_perm[-5:] if kernel.node_perm is not None
                                          else slice(-5, None)] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_keep_set_is_k5s(dtype):
    """V = I: K6 (degree-reordered) keeps exactly K5's edges, row-permuted
    by node_perm."""
    N = 64
    rng = np.random.RandomState(2)
    cells = rng.choice(N * N, 1500, replace=False)
    receivers, senders = np.divmod(cells, N)
    edges = (senders, receivers, np.zeros(1500, np.int64), np.ones(1500, np.float32))
    k6 = ell.ELLGraphKernel(*edges, N, 1, device="cuda", **CONFIG_PLAN)
    k5 = csr_spmm.CSRGraphKernel(*edges, N, 1, device="cuda")
    eye = torch.eye(N, device="cuda", dtype=dtype)
    perm = torch.from_numpy(k6.node_perm).cuda()
    seen6 = k6.neighbor_aggregate(eye, 99, 0.3) != 0
    seen5 = k5.neighbor_aggregate(eye, 99, 0.3) != 0
    assert torch.equal(seen6[perm][:, perm], seen5)


def test_probe_kernels_match_plain_versions():
    inputs = gather.make_inputs("cuda", quick=True)
    before = {name: kernel.launches for name, kernel in gather.KERNELS.items()}
    errors = gather.check_kernels(inputs)
    torch.cuda.synchronize()
    assert errors["E1"] == errors["E2"] == errors["F"] == 0.0
    assert {name: kernel.launches - before[name] for name, kernel in gather.KERNELS.items()} == {
        "E1": 1, "E2": 1, "F": 1, "G": 2}
