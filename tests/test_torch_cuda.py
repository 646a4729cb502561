"""K1-K6 and P on the card: the CUDA kernels against their plain versions
(bf16 K1/K2, and bf16 K3 at N % 8 == 0 and F % 8 == 0: dropedge_sm90.cu;
bf16 K3 at other N or F: relagg_ragged.cu; f32 K1, K2 and K3:
dropedge_f32.cu; the rest as named in their modules), and K5 and K6 at
every column slicing.

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
    if dtype == torch.bfloat16 and N % 8:
        # bf16 K1/K2 read through TMA: N % 8 == 0 (test_bf16_dropedge_shape_check).
        with pytest.raises(ValueError, match="N % 8 == 0"):
            relagg.dropedge_aggregate(V, A, 11, RATE)
        return
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
# bf16 K1/K2 (dropedge_sm90.cu: TMA, wgmma, K2's cluster split-K) at the
# main path's shapes, the checks' widths (F = N with V = I, F = N*L with
# g = I) and F = 64. Both sides accumulate in float32 and round once to
# bf16, in another order: one bf16 rounding apart (1e-2 relative), plus
# 1e-5 of the largest output for sums that cancel.
# ---------------------------------------------------------------------------
def assert_one_rounding_apart(out, ref):
    assert out.shape == ref.shape and out.dtype == ref.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-5 * float(ref.float().abs().max()))


@pytest.mark.parametrize("N", [64, 192, 256])
@pytest.mark.parametrize("F", [64, 256, 512, 1536])
def test_bf16_dropedge_kernels_match_plain_versions(N, F):
    V, A = operands(N, F, torch.bfloat16, density=0.05, seed=7 * N + F)
    g = torch.randn(B, N, L, F, device="cuda").to(torch.bfloat16)
    k1, k2 = relagg.dropedge_aggregate.launches, relagg.dropedge_aggregate_grad.launches
    out = relagg.dropedge_aggregate(V, A, 23, RATE)
    dV = relagg.dropedge_aggregate_grad(g, A, 23, RATE)
    torch.cuda.synchronize()
    assert relagg.dropedge_aggregate.launches == k1 + 1
    assert relagg.dropedge_aggregate_grad.launches == k2 + 1
    assert_one_rounding_apart(out, relagg.dropedge_aggregate_reference(V, A, 23, RATE))
    assert_one_rounding_apart(dV, relagg.dropedge_aggregate_grad_reference(g, A, 23, RATE))


@pytest.mark.parametrize("N", [64, 192, 256])
def test_bf16_dropedge_masks_read_back_exactly(N):
    """V = I: K1 returns A * mask / keep; g = I over the N*L rows: K2 returns
    its transpose. Both show exactly the plain hash mask on A's support."""
    _, A = operands(N, 8, torch.bfloat16, density=0.5, seed=N)
    expected = (A != 0) & relagg.dropedge_keep_mask(41, A.shape, RATE, A.device)
    eye = torch.eye(N, device="cuda", dtype=torch.bfloat16).expand(B, N, N).contiguous()
    seen_k1 = relagg.dropedge_aggregate(eye, A, 41, RATE) != 0
    g = torch.eye(N * L, device="cuda", dtype=torch.bfloat16).expand(B, N * L, N * L).reshape(B, N, L, N * L)
    dV = relagg.dropedge_aggregate_grad(g.contiguous(), A, 41, RATE)
    seen_k2 = dV.view(B, N, N, L).permute(0, 2, 3, 1) != 0
    assert torch.equal(seen_k1, expected)
    assert torch.equal(seen_k2, expected)


def test_bf16_dropedge_launches_are_deterministic():
    """K2 sums its cluster's partials in a fixed order: no atomics, so two
    launches of each kernel give the same bits."""
    V, A = operands(256, 256, torch.bfloat16, density=0.2, seed=5)
    g = torch.randn(B, 256, L, 256, device="cuda").to(torch.bfloat16)
    for run in (lambda: relagg.dropedge_aggregate(V, A, 3, RATE),
                lambda: relagg.dropedge_aggregate_grad(g, A, 3, RATE)):
        assert torch.equal(run(), run())


def test_bf16_k1_at_keep_one_is_k3_within_one_rounding():
    """K3 at N % 8 == 0 is K1's kernel with the mask compiled out: at keep 1
    K1 drops nothing and scales by exactly 1, so the two agree bit for bit
    (within one rounding a fortiori)."""
    V, A = operands(256, 256, torch.bfloat16, density=0.2, seed=6)
    assert torch.equal(relagg._launch_sm90(False, A, V, 3, 1.0), relagg.neighbor_aggregate(V, A))


def test_bf16_dropedge_shape_check():
    V, A = operands(100, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="N % 8 == 0"):
        relagg.dropedge_aggregate(V, A, 1, RATE)
    with pytest.raises(ValueError, match="N % 8 == 0"):
        relagg.dropedge_aggregate_grad(torch.zeros(B, 100, L, 64, device="cuda", dtype=torch.bfloat16), A, 1, RATE)
    V, A = operands(64, 44, torch.bfloat16)
    with pytest.raises(ValueError, match="F % 8 == 0"):
        relagg.dropedge_aggregate(V, A, 1, RATE)


# ---------------------------------------------------------------------------
# bf16 K3 on dropedge_sm90.cu (N % 8 == 0 and F % 8 == 0) and on
# relagg_ragged.cu (other shapes); the float32 K1, K2 and K3 of
# dropedge_f32.cu.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("N", [64, 192, 256])
@pytest.mark.parametrize("F", [64, 256, 512, 1280])
def test_bf16_k3_sm90_matches_plain_version(N, F):
    V, A = operands(N, F, torch.bfloat16, density=0.05, seed=3 * N + F)
    before = dict(relagg.neighbor_aggregate.routes)
    out = relagg.neighbor_aggregate(V, A)
    torch.cuda.synchronize()
    assert relagg.neighbor_aggregate.routes == {**before, "sm90": before["sm90"] + 1}
    assert_one_rounding_apart(out, relagg.neighbor_aggregate_reference(V, A))


@pytest.mark.parametrize("N, F", [(230, 64), (230, 256), (230, 512), (230, 36), (231, 256), (231, 512),
                                  (256, 250)])
def test_bf16_k3_ragged_route_matches_plain_version(N, F):
    """N = 230 or 231 (or F % 8 != 0): TMA cannot read the rows, so K3
    launches relagg_ragged.cu, which copies A itself (4-byte copies at even
    N, 2-byte loads at odd N) and V through TMA where F % 8 == 0."""
    V, A = operands(N, F, torch.bfloat16, density=0.05, seed=N + F)
    before = dict(relagg.neighbor_aggregate.routes)
    out = relagg.neighbor_aggregate(V, A)
    torch.cuda.synchronize()
    assert relagg.neighbor_aggregate.routes == {**before, "ragged": before["ragged"] + 1}
    assert_one_rounding_apart(out, relagg.neighbor_aggregate_reference(V, A))


@pytest.mark.parametrize("F", [256, 512])
def test_bf16_k3_ragged_at_an_aligned_shape_is_the_sm90_route(F):
    """Launched at N = 256, the ragged kernel stages the same swizzled boxes
    as TMA and sums them with the same wgmma consumer: the sm90 route's
    bits exactly, with V through TMA and with V copied too (a V 4 bytes
    past a 16-byte boundary)."""
    V, A = operands(256, F, torch.bfloat16, density=0.05, seed=F)
    sm90 = relagg.neighbor_aggregate(V, A)
    assert torch.equal(relagg._launch_ragged(A, V), sm90)
    shifted = torch.empty(V.numel() + 2, dtype=V.dtype, device="cuda")[2:].view(V.shape)
    shifted.copy_(V)
    assert torch.equal(relagg._launch_ragged(A, shifted), sm90)


def test_bf16_k3_ragged_launches_are_deterministic():
    V, A = operands(230, 256, torch.bfloat16, density=0.2, seed=4)
    assert torch.equal(relagg.neighbor_aggregate(V, A), relagg.neighbor_aggregate(V, A))


@pytest.mark.parametrize("N", [64, 192, 230, 256])
@pytest.mark.parametrize("F", [36, 256, 512])
def test_f32_k3_and_k1_match_plain_versions(N, F):
    """dropedge_f32.cu's forward, mask compiled out (K3) and in (K1), in
    3xTF32 on wgmma (about 1e-6 of the output's scale off the plain float32
    matmul): within 1e-5 of the largest output."""
    V, A = operands(N, F, torch.float32, density=0.05, seed=5 * N + F)
    before = dict(relagg.neighbor_aggregate.routes)
    k1 = relagg.dropedge_aggregate.launches
    out = relagg.neighbor_aggregate(V, A)
    dropped = relagg.dropedge_aggregate(V, A, 29, RATE)
    torch.cuda.synchronize()
    assert relagg.neighbor_aggregate.routes == {**before, "float32": before["float32"] + 1}
    assert relagg.dropedge_aggregate.launches == k1 + 1
    assert_close_to_plain(out, relagg.neighbor_aggregate_reference(V, A))
    assert_close_to_plain(dropped, relagg.dropedge_aggregate_reference(V, A, 29, RATE))


@pytest.mark.parametrize("N", [64, 230, 256])
def test_f32_k1_mask_reads_back_exactly(N):
    """V = I: K1 returns A * mask / keep, which shows exactly the plain
    hash mask on A's support."""
    _, A = operands(N, 8, torch.float32, density=0.5, seed=N + 1)
    expected = (A != 0) & relagg.dropedge_keep_mask(47, A.shape, RATE, A.device)
    eye = torch.eye(N, device="cuda").expand(B, N, N).contiguous()
    assert torch.equal(relagg.dropedge_aggregate(eye, A, 47, RATE) != 0, expected)


def test_f32_k1_at_keep_one_is_k3_bit_for_bit():
    """One template with the mask compiled in or out: at keep 1 K1 drops
    nothing and scales by exactly 1, in K3's summation order."""
    V, A = operands(256, 256, torch.float32, density=0.2, seed=9)
    assert torch.equal(relagg._launch_f32_forward(A, V, 3, 1.0, mask=True), relagg.neighbor_aggregate(V, A))


def test_f32_forward_launches_are_deterministic():
    """Each tile's products accumulate in a fixed order, with no atomics."""
    V, A = operands(256, 512, torch.float32, density=0.2, seed=10)
    for run in (lambda: relagg.neighbor_aggregate(V, A), lambda: relagg.dropedge_aggregate(V, A, 3, RATE)):
        assert torch.equal(run(), run())


@pytest.mark.parametrize("blocks", [192, 132, 97, 7, 2, 1])
def test_f32_forward_any_block_count_matches_plain_version(blocks):
    """One block a tile (192 at this shape), and fewer blocks than tiles,
    each streaming its tiles through one ring."""
    import dataclasses

    V, A = operands(256, 256, torch.float32, density=0.05, seed=blocks + 20)
    plan = dataclasses.replace(relagg.dropedge_f32_forward_plan(B, 256, L, 256), blocks=blocks)
    out = relagg._launch_f32_forward(A, V, 19, relagg.keep_probability(RATE), mask=True, plan=plan)
    torch.cuda.synchronize()
    assert_close_to_plain(out, relagg.dropedge_aggregate_reference(V, A, 19, RATE))


@pytest.mark.parametrize("shift", [1, 2])
def test_f32_forward_misaligned_operand_takes_narrower_copies(shift):
    """A V 4 (or 8) bytes past a 16-byte boundary is copied 4 (or 8) bytes
    at a time, with the same result."""
    V, A = operands(64, 64, torch.float32, density=0.2, seed=8)
    shifted = torch.empty(V.numel() + shift, device="cuda")[shift:].view(V.shape)
    shifted.copy_(V)
    assert torch.equal(relagg.dropedge_aggregate(shifted, A, 3, RATE), relagg.dropedge_aggregate(V, A, 3, RATE))


def test_bf16_k3_sm90_refuses_a_misaligned_operand():
    """A contiguous operand 2 bytes past a 16-byte boundary: TMA cannot read
    it, and the launch raises; it does not turn to the WMMA kernel."""
    V, A = operands(64, 64, torch.bfloat16)
    shifted = torch.empty(V.numel() + 1, dtype=V.dtype, device="cuda")[1:].view(V.shape)
    shifted.copy_(V)
    launches = relagg.neighbor_aggregate.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        relagg.neighbor_aggregate(shifted, A)
    assert relagg.neighbor_aggregate.launches == launches


@pytest.mark.parametrize("N, F", [(64, 256), (192, 512), (256, 256), (256, 512), (230, 256), (256, 36)])
def test_f32_k2_matches_plain_version(N, F):
    """Exact float32 FMAs in another order than the plain matmul: within
    1e-5 of the largest output."""
    _, A = operands(N, F, torch.float32, density=0.05, seed=N + 2 * F)
    g = torch.randn(B, N, L, F, device="cuda")
    before = dict(relagg.dropedge_aggregate_grad.routes)
    dV = relagg.dropedge_aggregate_grad(g, A, 19, RATE)
    torch.cuda.synchronize()
    assert relagg.dropedge_aggregate_grad.routes == {**before, "float32": before["float32"] + 1}
    assert_close_to_plain(dV, relagg.dropedge_aggregate_grad_reference(g, A, 19, RATE))


@pytest.mark.parametrize("S", [1, 2, 3, 4, 6, 8])
def test_f32_k2_every_split_matches_plain_version(S):
    import dataclasses

    _, A = operands(256, 256, torch.float32, density=0.05, seed=S)
    g = torch.randn(B, 256, L, 256, device="cuda")
    plan = dataclasses.replace(relagg.dropedge_f32_plan(B, 256, L, 256), splits=S)
    dV = relagg._launch_f32_grad(A, g, 19, relagg.keep_probability(RATE), plan)
    torch.cuda.synchronize()
    assert_close_to_plain(dV, relagg.dropedge_aggregate_grad_reference(g, A, 19, RATE))


@pytest.mark.parametrize("N", [64, 230, 256])
def test_f32_k2_mask_reads_back_exactly(N):
    """g = I over the N*L rows: K2 returns the masked A transposed, which
    shows exactly the plain hash mask on A's support."""
    _, A = operands(N, 8, torch.float32, density=0.5, seed=N)
    expected = (A != 0) & relagg.dropedge_keep_mask(43, A.shape, RATE, A.device)
    g = torch.eye(N * L, device="cuda").expand(B, N * L, N * L).reshape(B, N, L, N * L)
    dV = relagg.dropedge_aggregate_grad(g.contiguous(), A, 43, RATE)
    assert torch.equal(dV.view(B, N, N, L).permute(0, 2, 3, 1) != 0, expected)


def test_f32_k2_launches_are_deterministic():
    """The cluster sums its partials in a fixed order, with no atomics."""
    _, A = operands(256, 256, torch.float32, density=0.2, seed=5)
    g = torch.randn(B, 256, L, 256, device="cuda")
    assert torch.equal(relagg.dropedge_aggregate_grad(g, A, 3, RATE), relagg.dropedge_aggregate_grad(g, A, 3, RATE))


def test_f32_k2_misaligned_operand_takes_four_byte_copies():
    """An operand 4 bytes past a 16-byte boundary is copied 4 bytes at a
    time (the plan's copy width is by shape and alignment), and the result
    is the same."""
    _, A = operands(64, 64, torch.float32, density=0.2, seed=8)
    g = torch.randn(B, 64, L, 64, device="cuda")
    shifted = torch.empty(g.numel() + 1, device="cuda")[1:].view(g.shape)
    shifted.copy_(g)
    assert torch.equal(relagg.dropedge_aggregate_grad(shifted, A, 3, RATE),
                       relagg.dropedge_aggregate_grad(g, A, 3, RATE))


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


# ---------------------------------------------------------------------------
# K5 and K6 column slices (grl_torch.ops.sparse.gather_slices): the test
# graphs fit the L2 in one slice, so the plans are forced here.
# ---------------------------------------------------------------------------
def slice_plans(F, itemsize):
    """One slice, two (the second narrower where F has an odd number of
    16-byte vectors) and one vector a slice."""
    per_vec = 16 // itemsize
    half = -(-F // per_vec // 2) * per_vec
    return [[(0, F)], [(0, half), (half, F - half)], [(c, per_vec) for c in range(0, F, per_vec)]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [256, 264])
def test_k5_gives_the_same_bits_at_every_slicing(F, dtype):
    """Forward and backward, within SPARSE_TOL of the plain version, and
    bit for bit the same output from every plan and from two launches."""
    kernel = csr_graph(2000, 2, 12000, seed=F)
    for layout in (kernel.forward_layout, kernel.backward_layout):
        X = torch.randn(layout.num_src_rows, F, device="cuda").to(dtype)
        outs = [csr_spmm._launch(X, layout, 17, RATE, plan=plan) for plan in slice_plans(F, X.element_size())]
        outs.append(csr_spmm._launch(X, layout, 17, RATE, plan=slice_plans(F, X.element_size())[-1]))
        torch.cuda.synchronize()
        assert_close_to_plain(outs[0], csr_spmm.csr_accumulate_reference(X, layout, 17, RATE))
        assert all(torch.equal(out, outs[0]) for out in outs[1:])


def hubless_ell_graph(N, E, seed):
    """Random single-relation edges, 5 receivers with no edge, every
    bucket at most 32 wide in all four directions: K6 is then the plain
    version's arithmetic term for term."""
    rng = np.random.RandomState(seed)
    edges = (rng.randint(0, N, E), rng.randint(0, N - 5, E), np.zeros(E, np.int64),
             (rng.rand(E) + 0.5).astype(np.float32))
    kernel = ell.ELLGraphKernel(*edges, N, 1, device="cuda", **CONFIG_PLAN)
    t = kernel.tables
    assert max(width for tables in (t.fwd, t.bwd, t.proj.fwd, t.proj.bwd) for _, width in tables.shapes) <= 32
    return kernel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [256, 264])
def test_k6_equals_its_plain_version_bit_for_bit_at_every_slicing(F, dtype):
    """All four directions, every plan and two launches."""
    t = hubless_ell_graph(3000, 18000, seed=F).tables
    for tables in (t.fwd, t.bwd, t.proj.fwd, t.proj.bwd):
        X = torch.randn(tables.num_src_rows, F, device="cuda").to(dtype)
        ref = ell.ell_accumulate_reference(X, tables, 17, RATE)
        outs = [ell._launch(X, tables, 17, RATE, plan=plan) for plan in slice_plans(F, X.element_size())]
        outs.append(ell._launch(X, tables, 17, RATE, plan=slice_plans(F, X.element_size())[-1]))
        torch.cuda.synchronize()
        assert all(torch.equal(out, ref) for out in outs), tables.direction


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_keep_sets_hold_at_every_slicing(dtype):
    """V = I through forced plans: K5's forward and transposed walks keep
    exactly the plain hash's edges, and K6 (degree-reordered) K5's."""
    N, L = 64, 3
    rng = np.random.RandomState(3)
    cells = rng.choice(N * L * N, 2000, replace=False)
    receivers, rest = np.divmod(cells, L * N)
    relations, senders = np.divmod(rest, N)
    k5 = csr_spmm.CSRGraphKernel(senders, receivers, relations, np.ones(2000, np.float32), N, L,
                                 device="cuda")
    kept = hashing.keep_bits(torch.arange(2000), 99, RATE).numpy()
    expected = np.zeros((N, L, N), bool)
    expected[receivers[kept], relations[kept], senders[kept]] = True
    single = (senders, receivers, np.zeros(2000, np.int64), np.ones(2000, np.float32))
    unique = np.unique(receivers * N + senders, return_index=True)[1]
    single = tuple(a[unique] for a in single)
    k6 = ell.ELLGraphKernel(*single, N, 1, device="cuda", **CONFIG_PLAN)
    k5_single = csr_spmm.CSRGraphKernel(*single, N, 1, device="cuda")
    perm = torch.from_numpy(k6.node_perm).cuda()
    eye, eye_l = torch.eye(N, device="cuda", dtype=dtype), torch.eye(N * L, device="cuda", dtype=dtype)
    for plan, plan_l in zip(slice_plans(N, eye.element_size()), slice_plans(N * L, eye.element_size())):
        fwd = csr_spmm._launch(eye, k5.forward_layout, 99, RATE, plan=plan) != 0
        bwd = csr_spmm._launch(eye_l, k5.backward_layout, 99, RATE, plan=plan_l) != 0
        assert np.array_equal(fwd.view(N, L, N).cpu().numpy(), expected)
        assert np.array_equal(bwd.view(N, N, L).permute(1, 2, 0).cpu().numpy(), expected)
        seen6 = ell._launch(eye, k6.tables.fwd, 99, RATE, plan=plan) != 0
        seen5 = csr_spmm._launch(eye, k5_single.forward_layout, 99, RATE, plan=plan) != 0
        assert torch.equal(seen6[perm][:, perm], seen5)


def test_probe_kernels_match_plain_versions():
    inputs = gather.make_inputs("cuda", quick=True)
    before = {name: kernel.launches for name, kernel in gather.KERNELS.items()}
    errors = gather.check_kernels(inputs)
    torch.cuda.synchronize()
    assert errors["E1"] == errors["E2"] == errors["F"] == 0.0
    assert {name: kernel.launches - before[name] for name, kernel in gather.KERNELS.items()} == {
        "E1": 1, "E2": 1, "F": 1, "G": 2}
