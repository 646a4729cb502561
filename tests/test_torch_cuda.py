"""K1-K7 and P on the card: the CUDA kernels against their plain versions
(bf16 K1/K2, and bf16 K3 at N % 8 == 0 and F % 8 == 0: dropedge_sm90.cu;
bf16 K3 at other N or F: relagg_ragged.cu; f32 K1, K2 and K3:
dropedge_f32.cu; the rest as named in their modules), and K5, K6 and K4
at every column slicing.

Needs an NVIDIA GPU and nvcc; elsewhere every test skips. This file
imports neither JAX nor grl_tpu, so it runs on a machine without them,
from the root of a checkout::

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
from __future__ import annotations

import pytest
import torch

import numpy as np

from grl_torch.ops import csr_spmm, dropout, ell, hashing, launches, relagg, sparse, sparse_attention, tile
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


def launched_since(before):
    """The launches the device ran since ``before`` (a
    ``launches.device_counts()``), by name."""
    return dict(launches.device_counts() - before)


def operands(N, F, dtype, density=0.05, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    V = torch.randn(B, N, F, generator=gen, device="cuda").to(dtype)
    A = (torch.rand(B, N, L, N, generator=gen, device="cuda") < density).to(dtype)
    return V, A


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N, F", [(64, 256), (192, 512), (256, 256), (100, 40)])
def test_kernel_matches_plain_version(N, F, dtype):
    V, A = operands(N, F, dtype)
    before = launches.device_counts()
    out = relagg.neighbor_aggregate(V, A)
    torch.cuda.synchronize()
    assert launched_since(before)["K3"] == 1
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
    before = launches.device_counts()
    out = relagg.dropedge_aggregate(V, A, 11, RATE)
    dV = relagg.dropedge_aggregate_grad(g, A, 11, RATE)
    torch.cuda.synchronize()
    counted = launched_since(before)
    assert counted["K1"] == 1 and counted["K2"] == 1
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
    before = launches.device_counts()
    (relagg.dropedge_aggregate(V, A, 9, RATE) * W).sum().backward()
    assert launched_since(before)["K2"] == 1
    V_ref = V.detach().clone().requires_grad_()
    (relagg.dropedge_aggregate_reference(V_ref, A, 9, RATE) * W).sum().backward()
    torch.testing.assert_close(V.grad, V_ref.grad, rtol=1e-4, atol=1e-4)
    before = launches.device_counts()
    plain = relagg.dropedge_aggregate(V.detach(), A, 9, 0.0)
    assert launched_since(before) == {"K3": 1, "K3 float32": 1}
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
    before = launches.device_counts()
    out = relagg.dropedge_aggregate(V, A, 23, RATE)
    dV = relagg.dropedge_aggregate_grad(g, A, 23, RATE)
    torch.cuda.synchronize()
    assert launched_since(before) == {"K1": 1, "K2": 1, "K2 sm90": 1}
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
    before = launches.device_counts()
    out = relagg.neighbor_aggregate(V, A)
    torch.cuda.synchronize()
    assert launched_since(before) == {"K3": 1, "K3 sm90": 1}
    assert_one_rounding_apart(out, relagg.neighbor_aggregate_reference(V, A))


@pytest.mark.parametrize("N, F", [(230, 64), (230, 256), (230, 512), (230, 36), (231, 256), (231, 512),
                                  (256, 250)])
def test_bf16_k3_ragged_route_matches_plain_version(N, F):
    """N = 230 or 231 (or F % 8 != 0): TMA cannot read the rows, so K3
    launches relagg_ragged.cu, which copies A itself (4-byte copies at even
    N, 2-byte loads at odd N) and V through TMA where F % 8 == 0."""
    V, A = operands(N, F, torch.bfloat16, density=0.05, seed=N + F)
    before = launches.device_counts()
    out = relagg.neighbor_aggregate(V, A)
    torch.cuda.synchronize()
    assert launched_since(before) == {"K3": 1, "K3 ragged": 1}
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
    before = launches.device_counts()
    out = relagg.neighbor_aggregate(V, A)
    dropped = relagg.dropedge_aggregate(V, A, 29, RATE)
    torch.cuda.synchronize()
    assert launched_since(before) == {"K3": 1, "K3 float32": 1, "K1": 1}
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
    before = launches.device_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        relagg.neighbor_aggregate(shifted, A)
    assert launched_since(before) == {}


@pytest.mark.parametrize("N, F", [(64, 256), (192, 512), (256, 256), (256, 512), (230, 256), (256, 36)])
def test_f32_k2_matches_plain_version(N, F):
    """Exact float32 FMAs in another order than the plain matmul: within
    1e-5 of the largest output."""
    _, A = operands(N, F, torch.float32, density=0.05, seed=N + 2 * F)
    g = torch.randn(B, N, L, F, device="cuda")
    before = launches.device_counts()
    dV = relagg.dropedge_aggregate_grad(g, A, 19, RATE)
    torch.cuda.synchronize()
    assert launched_since(before) == {"K2": 1, "K2 float32": 1}
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
    before = launches.device_counts()
    out = kernel.neighbor_aggregate(V, 17, rate)
    g = torch.randn_like(out)
    (dV,) = torch.autograd.grad(out, V, g)
    torch.cuda.synchronize()
    assert launched_since(before) == {"K5 forward": 1, "K5 backward": 1}
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


def attention_problem(N, E, K, F, dtype, seed=0, degrees=()):
    """Random edges into all but the last 7 receivers, a hub of 300 edges
    at receiver 3, and receivers 4, 5, ... of exactly ``degrees`` edges."""
    rng = np.random.RandomState(seed)
    senders = rng.randint(0, N, E)
    receivers = rng.randint(0, N - 7, E)  # 7 receivers with no edge
    receivers[:300] = 3  # a hub far wider than 32
    special = 4 + np.arange(len(degrees))
    other = ~np.isin(receivers, special)
    receivers = np.concatenate([receivers[other], np.repeat(special, degrees)])
    senders = np.concatenate([senders[other], rng.randint(0, N, int(np.sum(degrees)))])
    kernel = sparse_attention.SparseAttentionKernel(senders, receivers, N, device="cuda")
    f, g, h = (torch.randn(N, d, device="cuda").to(dtype) for d in (K, K, F))
    return kernel, f, g, h


def k4_plan(N, K, F, dtype):
    itemsize = torch.empty((), dtype=dtype).element_size()
    return sparse_attention.attention_launch(N, K, F, itemsize, sparse.l2_bytes(0), sparse.sm_count(0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K, F", [(16, 128), (2, 16), (12, 264), (16, 1040)])
def test_k4_matches_plain_version(K, F, dtype):
    """One launch through ``attend``, within SPARSE_TOL of the plain version,
    with zero rows for the receivers that have no edge, on a graph with a
    300-edge hub, receivers of degree G - 1, G and G + 1 for the plan's
    group G, and N not a multiple of the receivers a block holds. A second
    launch and the plan forced to one slice, to two and to one vector a
    slice give the same bits."""
    N = 3001
    planned = k4_plan(N, K, F, dtype)
    group = planned.group
    assert N % (sparse_attention.THREADS // group)
    kernel, f, g, h = attention_problem(N, 20000, K, F, dtype, seed=K + F,
                                        degrees=(max(group - 1, 1), group, group + 1))
    before = launches.device_counts()
    out = kernel.attend(f, g, h)
    torch.cuda.synchronize()
    assert launched_since(before) == {"K4": 1}
    assert_close_to_plain(out, sparse_attention.attend_reference(f, g, h, kernel.plan))
    assert torch.all(out[-7:] == 0)
    layouts = [planned] + [planned._replace(slices=plan) for plan in slice_plans(F, h.element_size())]
    for launch in layouts:
        assert torch.equal(sparse_attention._launch(f, g, h, kernel.plan, launch), out), launch


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 2, 4, 8, 16, 32])
def test_k4_every_group_matches_plain_version(group, dtype):
    """Groups of any width, in one slice and in one vector a slice (other
    rounds of the online softmax than the plan's: within SPARSE_TOL)."""
    kernel, f, g, h = attention_problem(1001, 9000, 16, 128, dtype, seed=group,
                                        degrees=(group - 1, group, group + 1, 2 * group + 1))
    ref = sparse_attention.attend_reference(f, g, h, kernel.plan)
    planned = k4_plan(1001, 16, 128, dtype)
    for plan in slice_plans(128, h.element_size())[::2]:
        out = sparse_attention._launch(f, g, h, kernel.plan, planned._replace(group=group, slices=plan))
        torch.cuda.synchronize()
        assert_close_to_plain(out, ref)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K, F", [(16, 128), (8, 16), (16, 264), (12, 1040)])
def test_k4b_matches_plain_version(K, F, dtype):
    """K4b through ``attend_grad``: one launch of each walk, within
    SPARSE_TOL of ``attend_backward`` on a graph with a 300-edge hub,
    receivers of degree G - 1, G and G + 1 and 7 with no edge; zero rows
    where a node has no edge; a second call gives the same bits."""
    N = 3001
    group = sparse_attention.backward_launch(N, K, F, torch.empty((), dtype=dtype).element_size(), 132).group
    kernel, f, g, h = attention_problem(N, 20000, K, F, dtype, seed=K + F,
                                        degrees=(max(group - 1, 1), group, group + 1))
    dout = torch.randn(N, F, device="cuda").to(dtype)
    before = launches.device_counts()
    grads = sparse_attention.attend_grad(f, g, h, dout, kernel.plan)
    torch.cuda.synchronize()
    assert launched_since(before) == {"K4b receivers": 1, "K4b senders": 1}
    for out, ref in zip(grads, sparse_attention.attend_backward(f, g, h, dout, kernel.plan)):
        assert_close_to_plain(out, ref)
    assert torch.all(grads[0][-7:] == 0)
    no_out = kernel.plan.colptr[1:] == kernel.plan.colptr[:-1]
    assert torch.all(grads[1][no_out] == 0) and torch.all(grads[2][no_out] == 0)
    again = sparse_attention.attend_grad(f, g, h, dout, kernel.plan)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 2, 4, 8, 16, 32])
def test_k4b_every_group_matches_plain_walks(group, dtype):
    """Each walk at groups of any width, rings of 2, 4 and 8 rows and a
    one-block grid against its plain version on the same inputs (the sender
    walk on the kernel's own pairs), on a graph with a 300-edge hub (many
    rounds, pairs parked) and degrees about G; a second launch gives the
    same bits."""
    kernel, f, g, h = attention_problem(1001, 9000, 4, 128, dtype, seed=group,
                                        degrees=(group - 1, group, group + 1, 2 * group + 1))
    dout = torch.randn(1001, 128, device="cuda").to(dtype)
    plan = kernel.plan
    for blocks, stages in ((1, 4), (64, 2), (64, 8)):
        launch = sparse_attention.BackwardLaunch(group, blocks, stages)
        df, pairs = sparse_attention._launch_receivers(f, g, h, dout, plan, launch)
        ref_df, ref_pairs = sparse_attention.receiver_walk(f, g, h, dout, plan)
        dg, dh = sparse_attention._launch_senders(f, dout, pairs, plan, launch)
        ref_dg, ref_dh = sparse_attention.sender_walk(f, dout, pairs, plan)
        again = (*sparse_attention._launch_receivers(f, g, h, dout, plan, launch),
                 *sparse_attention._launch_senders(f, dout, pairs, plan, launch))
        torch.cuda.synchronize()
        assert_close_to_plain(pairs, ref_pairs)
        for out, ref in ((df, ref_df), (dg, ref_dg), (dh, ref_dh)):
            assert_close_to_plain(out, ref)
        assert all(torch.equal(a, b) for a, b in zip((df, pairs, dg, dh), again))


def test_k4b_refuses_what_it_cannot_take():
    kernel, f, g, h = attention_problem(500, 4000, 16, 128, torch.float32)
    dout = torch.randn(500, 128, device="cuda")
    with pytest.raises(TypeError):
        sparse_attention.attend_grad(f, g, h, dout.bfloat16(), kernel.plan)
    with pytest.raises(ValueError):
        sparse_attention.attend_grad(f, g, h, torch.randn(500 * 128 + 1, device="cuda")[1:].view(500, 128),
                                     kernel.plan)
    wide, *_ = attention_problem(500, 4000, 132, 128, torch.float32)
    with pytest.raises(ValueError):
        sparse_attention.attend_grad(*(torch.randn(500, d, device="cuda") for d in (132, 132, 128, 128)), wide.plan)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3001, 256), (3001, 1280), (7, 13), (1,)])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_matches_plain_version_bit_for_bit(shape, dtype, rate):
    """D against its plain version on the bits (ragged tails included), an
    int seed and its tensor giving the same output, two launches equal."""
    x = torch.randn(shape, device="cuda").to(dtype)
    seed = hashing.seed_tensor(2**31 + 77, "cuda")
    y = dropout._launch(x, seed, rate)
    ref = dropout.dropout_reference(x, 2**31 + 77, rate)
    width = {4: torch.int32, 2: torch.int16}[x.element_size()]
    assert torch.equal(y.view(width), ref.view(width))
    assert torch.equal(dropout._launch(x, seed, rate).view(width), y.view(width))


def test_dropout_autograd_runs_d_both_ways_with_one_mask():
    x = torch.randn(513, 256, device="cuda", requires_grad=True)
    dy = torch.randn(513, 256, device="cuda")
    seed = hashing.seed_tensor(5, "cuda")
    before = launches.device_counts()
    y = dropout.dropout(x, seed, 0.5)
    y.backward(dy)
    torch.cuda.synchronize()
    assert launched_since(before) == {"D forward": 1, "D backward": 1}
    assert torch.equal(x.grad, dropout.dropout_reference(dy, seed, 0.5))
    mask = hashing.keep_bits(torch.arange(x.numel(), device="cuda"), seed, 0.5).view(x.shape)
    assert not bool(((y != 0) & ~mask).any()) and not bool(((x.grad != 0) & ~mask).any())
    # A non-contiguous input and a contiguous view at an odd offset.
    base = torch.randn(3, 515, device="cuda")
    for view in (base.t(), base.view(-1)[1:1 + 1024]):
        assert torch.equal(dropout.apply_dropout(view, seed, 0.5), dropout.dropout_reference(view.contiguous(), seed, 0.5))


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
    before = launches.device_counts()
    V = torch.randn(2000, F, device="cuda").to(dtype).requires_grad_()
    out = kernel.neighbor_aggregate(V, 17, rate)
    g = torch.randn_like(out)
    (dV,) = torch.autograd.grad(out, V, g)
    Vr = torch.randn(2000 * L, F, device="cuda").to(dtype).requires_grad_()
    out_p = kernel.neighbor_aggregate_projected(Vr, 17, rate)
    g_p = torch.randn_like(out_p)
    (dVr,) = torch.autograd.grad(out_p, Vr, g_p)
    torch.cuda.synchronize()
    assert launched_since(before) == {f"K6 {direction}": 1 for direction in ell.DIRECTIONS}
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


@pytest.mark.parametrize("F", [128, 512])
@pytest.mark.parametrize("blocks, rows", [(32, 1024), (132, 1024), (7, 1001)])
def test_row_dma_sum_matches_plain_version(F, blocks, rows):
    """G at the script's grid, at one output row an SM, and at rows that
    do not split evenly over its cluster, under its plan and under a plan
    of one CTA a row (another order of the sums): within G_TOLERANCE of
    the largest sum; one launch a call; two launches give the same bits."""
    gen = torch.Generator(device="cuda").manual_seed(F + blocks)
    V = torch.randn(20000, F, generator=gen, device="cuda")
    idx = torch.randint(0, 20000, (blocks, rows), generator=gen, device="cuda", dtype=torch.int32)
    ref = gather.row_dma_sum_reference(V, idx)
    planned = gather.row_dma_plan(blocks, rows, F, torch.cuda.get_device_properties(0).multi_processor_count)
    alone = planned._replace(cluster=1, chunk=rows, depth=2,
                             smem=gather.row_dma_smem(F, rows, planned.warps, 2))
    for plan in (planned, alone):
        before = gather.row_dma_sum.launches
        out = gather.row_dma_sum(V, idx, plan)
        again = gather.row_dma_sum(V, idx, plan)
        torch.cuda.synchronize()
        assert gather.row_dma_sum.launches - before == 2
        assert torch.equal(out, again)
        torch.testing.assert_close(out, ref, rtol=0, atol=gather.G_TOLERANCE * float(ref.abs().max()))


# ---------------------------------------------------------------------------
# DropEdge seeds in device memory under CUDA-graph capture
# ---------------------------------------------------------------------------
def mask_readers(dtype):
    """{kernel: mask(seed)}: each kernel's keep set read back with an
    identity operand, as booleans (K1: A * mask with V = I; K2: its
    transpose with g = I; K5 and K6: the kept edges into each row)."""
    N, Lr = 64, 2
    gen = torch.Generator(device="cuda").manual_seed(11)
    A = (torch.rand(2, N, Lr, N, generator=gen, device="cuda") < 0.5).to(dtype)
    eye = torch.eye(N, device="cuda", dtype=dtype).expand(2, N, N).contiguous()
    eye_g = torch.eye(N * Lr, device="cuda", dtype=dtype).expand(2, N * Lr, N * Lr).reshape(2, N, Lr, N * Lr)
    eye_g = eye_g.contiguous()
    rng = np.random.RandomState(3)
    cells = rng.choice(N * Lr * N, 3000, replace=False)
    receivers, rest = np.divmod(cells, Lr * N)
    relations, senders = np.divmod(rest, N)
    edges = (senders, receivers, relations, np.ones(3000, np.float32))
    k5 = csr_spmm.CSRGraphKernel(*edges, N, Lr, device="cuda")
    k6 = ell.ELLGraphKernel(*edges, N, Lr, device="cuda", **CONFIG_PLAN)
    flat = torch.eye(N, device="cuda", dtype=dtype)
    ones = torch.ones(N, 256, device="cuda", dtype=dtype)
    return {
        "D": lambda seed: dropout.apply_dropout(ones, seed, RATE) != 0,
        "K1": lambda seed: relagg.dropedge_aggregate(eye, A, seed, RATE) != 0,
        "K2": lambda seed: relagg.dropedge_aggregate_grad(eye_g, A, seed, RATE) != 0,
        "K5": lambda seed: k5.neighbor_aggregate(flat, seed, RATE) != 0,
        "K6": lambda seed: k6.neighbor_aggregate(flat, seed, RATE) != 0,
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["K1", "K2", "K5", "K6", "D"])
def test_captured_kernel_reads_the_seed_each_replay_draws(kernel, dtype):
    """A chunk that draws a seed on the device and runs the kernel on it,
    run by the chunk runner: the warm-up eagerly, then captured once and
    replayed. Each replay draws a new seed, and its mask is the mask of an
    eager call at that seed, bit for bit."""
    from grl_torch.models import Rngs
    from grl_torch.trainer.captured import CapturedSteps

    read = mask_readers(dtype)[kernel]
    rngs = Rngs.from_seed(5, torch.device("cuda"))
    runner = CapturedSteps(torch.device("cuda"), [rngs.device])

    def chunk():
        seed = rngs.kernel_seed()
        return seed, read(seed)

    launches.reset()
    outs = [tuple(t.clone() for t in runner.run("mask", chunk)) for _ in range(4)]
    torch.cuda.synchronize()
    assert runner.replays == 3
    seeds = [int(seed) for seed, _ in outs]
    assert len(set(seeds)) == 4
    for seed, (_, mask) in zip(seeds, outs):
        assert torch.equal(mask, read(hashing.seed_tensor(seed, "cuda")))
    assert not torch.equal(outs[1][1], outs[2][1])
    name = {"K1": "K1", "K2": "K2", "K5": "K5 forward", "K6": "K6 forward", "D": "D forward"}[kernel]
    assert launches.device_counts()[name] == 4 + 4  # the chunks, then the eager calls


def small_kv_procedure(tmp_path):
    """KVProcedure at scan_steps 2 on a small bf16 config with DropEdge and
    dropout on, batches of 2 pages padded at quantum 64."""
    from grl_torch.data.synthetic import synthetic_dataset_files
    from grl_torch.trainer.procedures import KVProcedure
    from grl_torch.models import create_model

    data_dir, classes_path, charset_path = synthetic_dataset_files(str(tmp_path), num_pages=8, seed=4)
    import json
    with open(charset_path) as handle:
        input_dim = len(json.load(handle)["charset"]) + 4
    split = {
        "data_path": [data_dir], "class_path": classes_path, "charset_path": charset_path,
        "key_types": ["key", "value"], "batch_size": 2, "shuffle": False, "drop_last": False,
        "data_collate": {"BucketPadding": {"quantum": 64, "only_selected_items": True}},
        "data_process": {"TextlineEncoding": {}, "HeuristicGraphBuilder": {}, "NodeLabeling": {}},
    }
    args = {"input_dim": input_dim, "output_dim": 15, "num_edges": 6, "net_size": 64, "kernel_impl": "pallas",
            "compute_dtype": "bfloat16", "dropout_rate": 0.5, "edge_dropout_rate": 0.3}
    config = {
        "seed": 0, "output_dir": str(tmp_path / "out"), "num_epochs": 1, "max_grad_norm": 5.0, "scan_steps": 2,
        "model": {"type": "GraphCNNDropEdge", "args": args},
        "data_config": {"dataset": {"type": "CassiaDataset", "args": {}}, "training": split, "validation": split},
        "logging": {"use_tensorboard": False},
    }
    return KVProcedure(create_model("GraphCNNDropEdge", **args, device="cuda"), config, device="cuda")


def replay_against_eager(proc, items):
    """The chunk of ``items`` run eagerly and then replayed from the same
    state (weights, optimizer, generator): (eager losses, replayed losses,
    names of the parameters that differ)."""
    import chip_smoke

    snap = chip_smoke.snapshot(torch, proc)
    eager_losses, _ = proc.chunk_runner().eager(proc.load_chunk(items)[1])
    eager = chip_smoke.params_of(proc.model)
    chip_smoke.restore(torch, proc, snap)
    replays = proc.chunk_runner().replays
    replayed_losses, _ = proc.run_chunk(items)
    assert proc.chunk_runner().replays == replays + 1
    differing = [n for n, v in chip_smoke.params_of(proc.model).items() if not torch.equal(v, eager[n])]
    return eager_losses.cpu().numpy(), replayed_losses, differing


def test_captured_kv_chunk_equals_the_same_chunk_run_eagerly(tmp_path):
    """A chunk replayed from a graph and the same chunk run eagerly from the
    same state give the same losses and parameters bit for bit."""
    proc = small_kv_procedure(tmp_path)
    batches = [proc._host_batch(batch) for batch, _ in zip(proc.train_loader, range(2))]
    items = [(V, A, labels, 0.5) for V, A, labels in batches]
    proc.run_chunk(items)  # the warm-up, eager
    eager_losses, replayed_losses, differing = replay_against_eager(proc, items)
    assert np.array_equal(eager_losses, replayed_losses) and not differing
    # The next replay draws new masks: another loss from the same batches.
    again, _ = proc.run_chunk(items)
    assert not np.array_equal(again, replayed_losses)


def test_two_bucket_chunks_share_one_pool_and_equal_eager(tmp_path):
    """Chunks of two shapes (N = 64 and, cut from the same pages, N = 32):
    one graph a shape, captured into the runner's one memory pool. The
    second capture fits in the blocks of the first and adds less than half
    of what the first added; replays of the two graphs in turn each equal
    their chunk run eagerly, bit for bit."""
    proc = small_kv_procedure(tmp_path)
    batches = [proc._host_batch(batch) for batch, _ in zip(proc.train_loader, range(2))]
    wide = [(V, A, labels, 0.5) for V, A, labels in batches]
    assert all(V.shape[1] == 64 for V, *_ in wide)
    narrow = [(V[:, :32].contiguous(), A[:, :32, :, :32].contiguous(), labels[:, :32].contiguous(), 0.5)
              for V, A, labels, _ in wide]
    for items in (wide, narrow):
        proc.run_chunk(items)  # the warm-up, eager
        proc.run_chunk(items)  # the capture
    runner = proc.chunk_runner()
    assert len(runner.graphs) == 2 and runner.replays == 2
    first, second = (runner.setup[key]["capture_bytes"] for key in runner.graphs)
    assert 0 < first and second < first / 2
    for items in (wide, narrow, narrow, wide):
        eager_losses, replayed_losses, differing = replay_against_eager(proc, items)
        assert np.array_equal(eager_losses, replayed_losses) and not differing


def test_single_steps_replay_one_step_graphs_bit_for_bit(tmp_path):
    """Single steps through ``_train_fn`` on the card, the train loader
    padding to buckets: the first step of a shape runs eagerly and records
    the shape's one-step graph, and every later step replays it; each
    leaves the loss, confusion matrix, parameters, their gradients and
    generator state of the same step run eagerly from the same state, bit
    for bit. The steps run interleaved with chunk replays of their own
    shape (2 pages at N = 64) and of a second (N = 32), all in the chunk
    runner's one pool; a third shape (1 page at N = 64) no chunk ever ran.
    The chunk runner counts only chunks."""
    import chip_smoke

    proc = small_kv_procedure(tmp_path)
    batches = [proc._prepare_batch(batch) for batch, _ in zip(proc.train_loader, range(2))]
    wide = [(*b, 0.5) for b in batches]
    narrow = [(V[:, :32].contiguous(), A[:, :32, :, :32].contiguous(), labels[:, :32].contiguous(), 0.5)
              for V, A, labels, _ in wide]
    step_wide, step_one = batches[0], tuple(t[:1].contiguous() for t in batches[1])
    for items in (wide, narrow):
        proc.run_chunk(items)  # the warm-up, eager
        proc.run_chunk(items)  # the capture and its replay
    chunks, steps = proc.chunk_runner(), proc.step_runner()
    assert steps.pool == chunks.pool and steps.stream is chunks.stream
    for batch in (step_wide, step_one):  # the warm-up, and the recording
        eager, got, differing, draws = chip_smoke.step_against_eager(torch, proc, batch, 0.5)
        (eager_loss, eager_cm), (loss, cm) = eager, got
        assert torch.equal(loss, eager_loss) and torch.equal(cm, eager_cm) and not differing and draws
        assert torch.isfinite(loss) and int(cm.sum()) > 0
    assert dict(proc.single_steps) == {"eager": 2, "recorded": 2} and steps.replays == 0
    assert len(steps.graphs) == 2 and len(chunks.graphs) == 2 and chunks.replays == 2
    assert all({"warmup_s", "capture_s", "capture_bytes"} <= set(steps.setup[key]) for key in steps.graphs)
    replayed = 0
    for what in (step_wide, wide, step_one, narrow, step_wide, step_one, wide, step_one):
        if isinstance(what, tuple):
            eager, got, differing, draws = chip_smoke.step_against_eager(torch, proc, what, 0.5)
            (eager_loss, eager_cm), (loss, cm) = eager, got
            replayed += 1
            assert torch.equal(loss, eager_loss) and torch.equal(cm, eager_cm) and not differing and draws
        else:
            eager_losses, replayed_losses, differing = replay_against_eager(proc, what)
            assert np.array_equal(eager_losses, replayed_losses) and not differing
    assert dict(proc.single_steps) == {"eager": 2, "recorded": 2, "replayed": replayed}
    assert steps.replays == replayed and chunks.replays == 2 + 3
    # A replay's outputs are the caller's: the next replay draws new masks
    # and leaves them as they were.
    first = proc._train_fn(*step_wide, proc.rngs, proc._lam)
    kept = [t.clone() for t in first]
    second = proc._train_fn(*step_wide, proc.rngs, proc._lam)
    assert all(torch.equal(a, b) for a, b in zip(first, kept)) and not torch.equal(first[0], second[0])


def test_single_steps_of_unbucketed_shapes_record_at_their_second_step(tmp_path):
    """A train loader that does not pad to buckets: a shape's first single
    step runs eagerly and records nothing, its second warms up and records
    the one-step graph, its third replays it, equal to the same step run
    eagerly."""
    import chip_smoke
    from grl_torch.data.collate import BucketPadding

    proc = small_kv_procedure(tmp_path)
    batch = proc._prepare_batch(next(iter(proc.train_loader)))
    proc.train_loader.collate_chain = [p for p in proc.train_loader.collate_chain
                                       if not isinstance(p, BucketPadding)]
    proc._ensure_initialized()
    steps = proc.step_runner()
    proc._lam.fill_(0.5)
    proc._train_fn(*batch, proc.rngs, proc._lam)  # the shape's first step (and Adam's state)
    assert steps.replays == 0 and not steps.graphs
    eager, got, differing, draws = chip_smoke.step_against_eager(torch, proc, batch, 0.5)  # the recording
    assert all(torch.equal(a, b) for a, b in zip(eager, got)) and not differing and draws
    assert steps.replays == 0
    assert dict(proc.single_steps) == {"eager": 2, "recorded": 1} and len(steps.graphs) == 1
    (eager_loss, eager_cm), (loss, cm), differing, draws = chip_smoke.step_against_eager(torch, proc, batch, 0.5)
    assert torch.equal(loss, eager_loss) and torch.equal(cm, eager_cm) and not differing and draws
    assert steps.replays == 1 and proc.single_steps["replayed"] == 1


# ---------------------------------------------------------------------------
# K7 (the tile-dense hybrid's tiles) and the optimizers of optax's rules.
# ---------------------------------------------------------------------------
def tile_graph(tile_dtype="float32", N=1000, L=3, E=30000, seed=3):
    """Uniform random edges at L = 3, B = 64 (16 blocks, the last one 40 rows:
    ragged), a threshold of 40 edges a tile: rows of up to 8-16 tiles; 20
    masked-out edges, the rest on the ELL residual."""
    rng = np.random.RandomState(seed)
    edges = (rng.randint(0, N, E), rng.randint(0, N, E), rng.randint(0, L, E), (rng.rand(E) + 0.5).astype(np.float32))
    edges[3][:20] = 0.0
    return tile.TileGraphKernel(*edges, N, L, tile_size=64, tile_min_edges=40, reorder="none",
                                tile_dtype=tile_dtype, plan_projected=True, device="cuda")


def tile_operands(kernel, F, dtype, seed=0):
    """An operand of each direction: V (N, F), Vr (N*L, F), g (N, L*F), g (N, F)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    N, L = kernel.num_nodes, kernel.L
    shapes = {"forward": (N, F), "projected forward": (N * L, F), "backward": (N, L * F),
              "projected backward": (N, F)}
    return {d: torch.randn(*shape, generator=gen, device="cuda").to(dtype) for d, shape in shapes.items()}


@pytest.mark.parametrize("tile_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [64, 136])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_k7_matches_plain_version(rate, F, dtype, tile_dtype):
    """All four directions against tile_apply_reference, one launch each,
    on the dtype pair's route; two launches give the same bits."""
    kernel = tile_graph(tile_dtype)
    assert kernel.tiles_total > 0 and max(w for shapes in kernel.tables.fwd.shapes for _, w in shapes) >= 8
    seed = hashing.seed_tensor(17, "cuda")
    for direction, X in tile_operands(kernel, F, dtype).items():
        plan = kernel.tables.bwd if "backward" in direction else kernel.tables.fwd
        before = launches.device_counts()
        out = tile.tile_accumulate(X, plan, seed, rate, direction)
        torch.cuda.synchronize()
        route = tile.route_for(plan.tiles.dtype, dtype)
        assert launched_since(before) == {"K7": 1, f"K7 {direction}": 1, f"K7 {route}": 1}
        assert_close_to_plain(out, tile.tile_apply_reference(X, plan, seed, rate, direction))
        assert torch.equal(out, tile.tile_accumulate(X, plan, seed, rate, direction))


def sparse_relation_graph(B, N=1000, L=3, E=30000, seed=5, tile_dtype="bfloat16"):
    """Uniform random edges at L = 3 with relation 1 given 300 of them, too
    few for any tile: its tables are empty (row_of_block -1). N = 1000 is
    ragged at every B. Thresholds under the mean block count make most
    block pairs of relations 0 and 2 tiles: rows of up to nb tiles."""
    rng = np.random.RandomState(seed)
    rel = rng.choice([0, 2], E)
    rel[:300] = 1
    edges = (rng.randint(0, N, E), rng.randint(0, N, E), rel, (rng.rand(E) + 0.5).astype(np.float32))
    min_edges = {64: 40, 128: 140, 192: 250, 256: 500}[B]
    return tile.TileGraphKernel(*edges, N, L, tile_size=B, tile_min_edges=min_edges, reorder="none",
                                tile_dtype=tile_dtype, plan_projected=True, device="cuda")


@pytest.mark.parametrize("B", [64, 128, 192, 256])
@pytest.mark.parametrize("F", [40, 64, 136, 264])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_k7_persistent_route_matches_plain_version(rate, F, B):
    """bf16 tiles under bf16 operands take the persistent route (one
    consumer warpgroup where 128 does not divide B, else two; F = 40 and
    136 partial column boxes, 264 two column chunks): all four directions
    against tile_apply_reference, with a ragged last block and a relation
    with no tables (exact zeros where stacked), one launch each, two
    launches equal to the bit."""
    kernel = sparse_relation_graph(B)
    assert kernel.tiles_total > 0 and kernel.tables.fwd.shapes[1] is None
    assert kernel.num_nodes % B != 0
    seed = hashing.seed_tensor(23, "cuda")
    for direction, X in tile_operands(kernel, F, torch.bfloat16, seed=F).items():
        plan = kernel.tables.bwd if "backward" in direction else kernel.tables.fwd
        layout = tile.launch_plan(plan, F, X.dtype, direction, torch.cuda.get_device_properties(0).multi_processor_count)
        assert layout.route == "persistent" and layout.consumers == (2 if B % 128 == 0 else 1)
        assert layout.chunks == -(-F // 256)
        before = launches.device_counts()
        out = tile.tile_accumulate(X, plan, seed, rate, direction)
        torch.cuda.synchronize()
        assert launched_since(before) == {"K7": 1, f"K7 {direction}": 1, "K7 persistent": 1}
        assert_close_to_plain(out, tile.tile_apply_reference(X, plan, seed, rate, direction))
        assert torch.equal(out, tile.tile_accumulate(X, plan, seed, rate, direction))
        if direction == "forward":
            assert not bool(out.view(kernel.num_nodes, kernel.L, F)[:, 1].any())
        elif direction == "projected backward":
            assert not bool(out.view(kernel.num_nodes, kernel.L, F)[:, 1].any())


def test_k7_persistent_route_replays_in_a_cuda_graph(monkeypatch):
    """A K7 call captured after an eager one replays its bits, and reads its
    seed from device memory: a new seed written before a replay draws the
    new seed's mask. A launch whose work list was never laid out is refused
    while a capture runs (it would upload the list inside the capture)."""
    kernel = sparse_relation_graph(128)
    plan = kernel.tables.fwd
    X = tile_operands(kernel, 256, torch.bfloat16)["forward"]
    seed = hashing.seed_tensor(3, "cuda")
    eager = tile.tile_accumulate(X, plan, seed, 0.3)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = tile.tile_accumulate(X, plan, seed, 0.3)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    seed.copy_(hashing.seed_tensor(4, "cuda"))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, tile.tile_accumulate(X, plan, hashing.seed_tensor(4, "cuda"), 0.3))
    assert not torch.equal(captured, eager)
    wide = tile_operands(kernel, 128, torch.bfloat16)["forward"]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        tile.tile_accumulate(wide, plan, seed, 0.3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k7_keep_set_and_adjoint(dtype):
    """V = I reads the masked tiles back, equal to the plain version's bits;
    the transposed tables keep the same edges; and <g, K7(V)> = <K7'(g), V>
    in both modes."""
    kernel = tile_graph("bfloat16")
    N, L, fwd, bwd = kernel.num_nodes, kernel.L, kernel.tables.fwd, kernel.tables.bwd
    eye = torch.eye(N, device="cuda", dtype=dtype)
    ahead = tile.tile_accumulate(eye, fwd, 5, 0.3, "forward")  # (N, L*N): A_r masked, row recv
    back = tile.tile_accumulate(eye, bwd, 5, 0.3, "projected backward")  # (N*L, N): row send*L + r, column recv
    torch.cuda.synchronize()
    assert torch.equal(ahead, tile.tile_apply_reference(eye, fwd, 5, 0.3, "forward"))
    assert torch.equal(ahead.view(N, L, N) != 0, back.view(N, L, N).permute(2, 1, 0) != 0)
    kept = ahead[ahead != 0].float()
    assert torch.all(kept > 0)
    X = tile_operands(kernel, 64, torch.float32)
    for forward, backward in (("forward", "backward"), ("projected forward", "projected backward")):
        out = tile.tile_accumulate(X[forward], fwd, 5, 0.3, forward)
        g = X[backward]
        lhs = float((out.double() * g.double()).sum())
        rhs = float((tile.tile_accumulate(g, bwd, 5, 0.3, backward).double() * X[forward].double()).sum())
        assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), 1.0)


# The routes of float32 tiles under bf16 operands and of float32 operands
# (3xTF32; bf16 tiles: 2xTF32 with 1/keep on the sums), by (tile dtype,
# operand dtype).
NEW_K7_ROUTES = [("float32", torch.bfloat16, "persistent_f32tiles"), ("float32", torch.float32, "persistent_tf32"),
                 ("bfloat16", torch.float32, "persistent_tf32")]


@pytest.mark.parametrize("tile_dtype, dtype, route", NEW_K7_ROUTES)
@pytest.mark.parametrize("graph", ["tile_graph", "empty relation B=64", "empty relation B=128"])
@pytest.mark.parametrize("F", [40, 136, 264])
def test_k7_new_routes_match_plain_version(F, graph, tile_dtype, dtype, route):
    """The dtype pair's route (one consumer warpgroup at B = 64, two at
    128; F = 40 a partial column box, 136 and 264 more than one column
    chunk on the TF32 route): all four directions at rates 0 and 0.3
    against tile_apply_reference, one launch each, counted on the route;
    two launches equal to the bit; the last block ragged; where a relation
    has no tables, exact zeros in the stacked directions."""
    if graph == "tile_graph":
        kernel = tile_graph(tile_dtype)
    else:
        kernel = sparse_relation_graph(int(graph.split("=")[1]), tile_dtype=tile_dtype)
        assert kernel.tables.fwd.shapes[1] is None
    assert kernel.tiles_total > 0 and kernel.num_nodes % kernel.tile_size != 0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    seed = hashing.seed_tensor(29, "cuda")
    for rate in (0.0, 0.3):
        for direction, X in tile_operands(kernel, F, dtype, seed=F).items():
            plan = kernel.tables.bwd if "backward" in direction else kernel.tables.fwd
            layout = tile.launch_plan(plan, F, dtype, direction, sms)
            assert layout.route == route and layout.consumers == (2 if kernel.tile_size % 128 == 0 else 1)
            before = launches.device_counts()
            out = tile.tile_accumulate(X, plan, seed, rate, direction)
            torch.cuda.synchronize()
            assert launched_since(before) == {"K7": 1, f"K7 {direction}": 1, f"K7 {route}": 1}
            assert_close_to_plain(out, tile.tile_apply_reference(X, plan, seed, rate, direction))
            assert torch.equal(out, tile.tile_accumulate(X, plan, seed, rate, direction))
            if graph != "tile_graph" and direction in ("forward", "projected backward"):
                assert not bool(out.view(kernel.num_nodes, kernel.L, F)[:, 1].any())


@pytest.mark.parametrize("tile_dtype, dtype, route", NEW_K7_ROUTES)
def test_k7_new_routes_keep_set_and_adjoint(tile_dtype, dtype, route):
    """V = I reads the masked tiles back: equal to the plain version's bits
    (float32 tiles under float32 operands: within the plain tolerance, each
    cell as its TF32 hi plus lo parts), the kept cells exactly the nonzero
    ones the pair hash keeps, the transposed tables keeping the same edges;
    and <g, K7(V)> = <K7'(g), V> in both modes, within 1e-5 of sum |g K7(V)|
    in float32 and 2^-7 in bf16 (each side's outputs rounded once to
    bf16)."""
    kernel = tile_graph(tile_dtype)
    N, L, fwd, bwd = kernel.num_nodes, kernel.L, kernel.tables.fwd, kernel.tables.bwd
    eye = torch.eye(N, device="cuda", dtype=dtype)
    ahead = tile.tile_accumulate(eye, fwd, 5, 0.3, "forward")
    full = tile.tile_accumulate(eye, fwd, 5, 0.0, "forward").view(N, L, N)
    back = tile.tile_accumulate(eye, bwd, 5, 0.3, "projected backward")
    torch.cuda.synchronize()
    ref = tile.tile_apply_reference(eye, fwd, 5, 0.3, "forward")
    if tile_dtype == "float32" and dtype == torch.float32:
        assert_close_to_plain(ahead, ref)
    else:
        assert torch.equal(ahead, ref)
    ahead = ahead.view(N, L, N)
    ids = torch.arange(N, device="cuda")
    for r in range(L):
        kept = hashing.keep_pair_bits(ids[:, None], ids[None, :], 5, 0.3, tile._rel_seed_mix(r))
        assert torch.equal(ahead[:, r] != 0, (full[:, r] != 0) & kept)
    assert torch.equal(ahead != 0, back.view(N, L, N).permute(2, 1, 0) != 0)
    X = tile_operands(kernel, 64, dtype)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    for forward, backward in (("forward", "backward"), ("projected forward", "projected backward")):
        out = tile.tile_accumulate(X[forward], fwd, 5, 0.3, forward).double()
        g = X[backward].double()
        lhs = float((out * g).sum())
        rhs = float((tile.tile_accumulate(X[backward], bwd, 5, 0.3, backward).double() * X[forward].double()).sum())
        assert abs(lhs - rhs) <= tol * float((out * g).abs().sum())


@pytest.mark.parametrize("name, kwargs", [
    ("SGD", {"momentum": 0.9}), ("RMSprop", {"momentum": 0.5}), ("Adagrad", {}), ("Adadelta", {}),
    ("Lamb", {"weight_decay": 0.01}), ("Lion", {}),
])
def test_captured_optimizer_step_equals_eager(name, kwargs):
    """Steps 2-5 replayed from one captured step (the lr changed between
    them through its device tensor) equal the same steps run eagerly, bit
    for bit; a zero parameter takes Lamb's trust ratio of 1."""
    from grl_torch.trainer import optimizers
    from grl_torch.trainer.captured import CapturedSteps

    gen = torch.Generator(device="cuda").manual_seed(0)
    start = [torch.randn(37, 5, generator=gen, device="cuda"), torch.zeros(11, device="cuda")]
    grads = [[torch.randn(p.shape, generator=gen, device="cuda") for p in start] for _ in range(5)]
    runs = []
    for captured in (True, False):
        params = [torch.nn.Parameter(p.clone()) for p in start]
        for p, g in zip(params, grads[0]):
            p.grad = g.clone()
        opt = optimizers.BuiltinOptimizer(name, 0.01, **kwargs).make(params)
        runner = CapturedSteps(torch.device("cuda"), [])
        for step, lr in enumerate((0.01, 0.01, 0.003, 0.003, 0.02)):
            optimizers.set_learning_rate(opt, lr)
            for p, g in zip(params, grads[step]):
                p.grad.copy_(g)
            if captured:
                runner.run("step", opt.step)
            else:
                opt.step()
        torch.cuda.synchronize()
        assert runner.replays == (4 if captured else 0)
        runs.append([p.detach().clone() for p in params])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_captured_sampled_chunk_equals_the_same_chunk_run_eagerly(tmp_path):
    """SampledGraphProcedure on both routes, bf16, DropEdge and dropout on:
    a chunk of 3 replayed from its graph equals the same chunk run eagerly
    from the same state, bit for bit, under deterministic algorithms (the
    COO route's segment sums are index_add_); the next replay draws new
    masks."""
    import chip_smoke
    from grl_torch.data.large_graph import sbm_relational_graph
    from grl_torch.models import create_model
    from grl_torch.trainer.procedures import SampledGraphProcedure

    data = sbm_relational_graph(num_nodes=1024, num_classes=5, num_relations=2, avg_degree=8, feature_dim=24)
    args = {"input_dim": 24, "output_dim": 5, "num_edges": 2, "net_size": 64, "use_attention": False,
            "compute_dtype": "bfloat16"}
    for tree in (True, False):
        config = {"seed": 0, "output_dir": str(tmp_path / str(tree)), "num_epochs": 1, "scan_steps": 3,
                  "max_grad_norm": 5.0, "sampler": {"fanouts": [4, 3], "batch_size": 32, "tree_aggregation": tree},
                  "logging": {"use_tensorboard": False}}
        proc = SampledGraphProcedure(create_model("GraphCNNDropEdge", **args, device="cuda"), config, data,
                                     device="cuda")
        items = [b for b, _ in zip(proc.sampler.epoch_batches(np.random.RandomState(0), data.train_mask), range(3))]
        with chip_smoke.deterministic(torch, True):
            proc.run_chunk(items)  # the warm-up, eager
            snap = chip_smoke.snapshot(torch, proc)
            eager = proc.chunk_runner().eager(proc.load_chunk(items)).tolist()
            eager_params = chip_smoke.params_of(proc.model)
            chip_smoke.restore(torch, proc, snap)
            replayed = proc.run_chunk(items).tolist()  # the capture, then its replay
            params = chip_smoke.params_of(proc.model)
            again = proc.run_chunk(items).tolist()
        assert proc.chunk_runner().replays == 2 and replayed == eager and again != replayed
        assert all(torch.equal(v, eager_params[n]) for n, v in params.items())


def test_captured_coo_kv_chunk_equals_the_same_chunk_run_eagerly(tmp_path):
    """KVProcedure on SparseBucketPadding's COO batches (kernel_impl xla,
    sparse attention, bf16, DropEdge and dropout on): a replayed chunk of 2
    equals the same chunk run eagerly, bit for bit, under deterministic
    algorithms."""
    proc = small_kv_procedure(tmp_path)
    config = dict(proc.config)
    config["model"]["args"].update(kernel_impl="xla", attention_impl="sparse")
    for split in ("training", "validation"):
        config["data_config"][split]["data_collate"] = {
            "SparseBucketPadding": {"quantum": 64, "edge_quantum": 256, "only_selected_items": True}}
    from grl_torch.models import create_model
    from grl_torch.trainer.procedures import KVProcedure

    proc = KVProcedure(create_model("GraphCNNDropEdge", **config["model"]["args"], device="cuda"), config,
                       device="cuda")
    batch = next(iter(proc.train_loader))
    V, A, labels = proc._host_batch(batch)
    assert isinstance(A, sparse.RelationalGraph) and A.batch_shape == tuple(labels.shape)
    items = [(V, A, labels, 0.5)] * 2
    import chip_smoke

    with chip_smoke.deterministic(torch, True):
        proc.run_chunk(items)  # the warm-up, eager
        proc.run_chunk(items)  # the capture
        eager_losses, replayed_losses, differing = replay_against_eager(proc, items)
    assert np.array_equal(eager_losses, replayed_losses) and not differing
