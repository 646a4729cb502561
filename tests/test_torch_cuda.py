"""K3, K1 and K2 on the card: the CUDA kernels against their plain versions.

Needs an NVIDIA GPU and nvcc; elsewhere every test skips. This file
imports neither JAX nor grl_tpu, so it runs on a machine without them,
from the root of a checkout::

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
from __future__ import annotations

import pytest
import torch

from grl_torch.ops import relagg

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
