"""DropEdge in grl_torch (K1, K2 and ``drop_edge``) held against grl_tpu.

The port's DropEdge mask is a hash of the seed and the element's index in
A; grl_tpu's Pallas kernels draw theirs from the TPU's hardware PRNG per
tile, run here in interpret mode as tests/test_pallas.py runs them. The
masks differ by construction, so the kernels are compared in law: the mean
over seeds is the plain aggregate, the kept entries lie in A's support and
carry ``A/keep``, and the kept share is ``keep``. Against grl_tpu's XLA
path fed the same hash mask the port agrees exactly (float32 order only).
On the CPU the port's wrappers take their plain versions; the CUDA kernels
are held to those on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from grl_tpu.ops import relconv as jax_relconv
from grl_tpu.ops.pallas import relagg as jax_relagg
from grl_tpu.ops.pallas.csr_spmm import _hash_keep
from grl_torch.ops import relagg, relconv


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite spreads files over worker processes on shared cores: one
    intra-op thread per worker keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RATE = 0.3
KEEP = 1.0 - RATE


@pytest.fixture(autouse=True)
def interpret_mode():
    jax_relagg.INTERPRET = True
    with pltpu.force_tpu_interpret_mode():
        yield
    jax_relagg.INTERPRET = False


def rand(seed=0, B=1, N=128, L=2, F=32, density=0.05):
    rng = np.random.RandomState(seed)
    V = rng.randn(B, N, F).astype(np.float32)
    A = (rng.rand(B, N, L, N) < density).astype(np.float32)
    return V, A


def port_k1(V, A, seed, rate=RATE):
    return relagg.dropedge_aggregate(torch.from_numpy(V), torch.from_numpy(A), seed, rate).numpy()


def jax_k1(V, A, seed, rate=RATE):
    return np.asarray(jax_relagg.pallas_dropedge_aggregate(jnp.asarray(V), jnp.asarray(A), jnp.int32(seed), rate))


def test_mask_is_grl_tpus_hash_bit_for_bit():
    """The mask is csr_spmm.py's _hash_keep over A's element index."""
    shape = (2, 64, 6, 64)
    gid = jnp.arange(int(np.prod(shape)), dtype=jnp.int32)
    for seed in (0, 7, 2**31 - 2):
        ours = relagg.dropedge_keep_mask(seed, shape, RATE).numpy()
        theirs = np.asarray(_hash_keep(gid, jnp.int32(seed), RATE)).reshape(shape) > 0
        np.testing.assert_array_equal(ours, theirs)


def test_mask_deterministic_per_seed_and_independent_across_seeds():
    shape = (4, 64, 6, 64)
    a = relagg.dropedge_keep_mask(3, shape, RATE)
    assert torch.equal(a, relagg.dropedge_keep_mask(3, shape, RATE))
    shares = [float(relagg.dropedge_keep_mask(s, shape, RATE).float().mean()) for s in range(4)]
    # 98k draws each: the share is keep within 5 standard deviations (0.0074).
    assert all(abs(s - KEEP) < 0.0074 for s in shares), shares
    # Independent bits agree with probability keep^2 + (1-keep)^2 = 0.58,
    # and their correlation is 0 (5 standard deviations: 0.016).
    for other in (4, 2**20 + 3, 3 ^ 1):
        b = relagg.dropedge_keep_mask(other, shape, RATE)
        assert abs(float((a == b).float().mean()) - (KEEP**2 + (1 - KEEP) ** 2)) < 0.0074
        x, y = a.float().flatten(), b.float().flatten()
        corr = float(((x - x.mean()) * (y - y.mean())).mean() / (x.std() * y.std()))
        assert abs(corr) < 0.016, (other, corr)
    with pytest.raises(ValueError):
        relagg.dropedge_keep_mask(0, shape, 1.0)


def test_k1_plain_version_equals_grl_tpu_xla_path_on_the_same_mask():
    """Fed the hash mask, grl_tpu's XLA aggregation gives the port's K1
    plain version up to float32 summation order (1e-5)."""
    V, A = rand(seed=1, B=2, N=64, L=6, density=0.2)
    mask = relagg.dropedge_keep_mask(5, A.shape, RATE).numpy()
    expected = np.asarray(
        jax_relconv.relational_neighbor_aggregate(jnp.asarray(V), jnp.asarray(A * mask / KEEP))
    ).reshape(2, 64, 6, -1)
    np.testing.assert_allclose(port_k1(V, A, 5), expected, rtol=1e-5, atol=1e-5)


def test_k1_statistics_against_grl_tpu_pallas():
    """Both kernels in law. The mean of 16 draws (4 for grl_tpu, whose
    interpreted kernel draws the same all-pass bits for every seed) is the
    plain aggregate within half its scale (tests/test_pallas.py's bound).
    With V = I the
    output is the dropped A itself: on a dense A (density 0.5, 16k
    entries) its support lies in A's and its values are A/keep on both
    sides. The kept share is keep within 0.02 (four standard deviations)
    for the port only: under the Pallas interpreter the TPU PRNG's bits
    all pass, so grl_tpu's kernel keeps every entry here (share 1.0)."""
    V, A = rand(seed=2, F=32)
    plain = np.asarray(jax_relconv.relational_neighbor_aggregate(jnp.asarray(V), jnp.asarray(A)))
    plain = plain.reshape(1, 128, 2, 32)
    scale = np.abs(plain).max()
    for k1, draws in ((port_k1, 16), (jax_k1, 4)):
        mean = np.mean([k1(V, A, seed) for seed in range(draws)], axis=0)
        assert np.abs(mean - plain).max() / scale < 0.5, k1.__name__
    _, A_dense = rand(seed=3, density=0.5)
    eye = np.broadcast_to(np.eye(128, dtype=np.float32), (1, 128, 128)).copy()
    for k1 in (port_k1, jax_k1):
        dropped = k1(eye, A_dense, 9)  # (1, N, L, N): A * mask / keep
        support = dropped != 0
        assert not (support & (A_dense == 0)).any(), k1.__name__
        np.testing.assert_allclose(dropped[support], 1.0 / KEEP, rtol=1e-6)
    for seed in (9, 10):
        share = (port_k1(eye, A_dense, seed) != 0).sum() / (A_dense != 0).sum()
        assert abs(share - KEEP) < 0.02, share


def test_k2_sees_k1s_mask_on_both_packages():
    """y = K1(V) is linear in V, so <dV, V> = sum y exactly when the
    backward regenerates the forward's mask; float32 sums agree to 1e-4."""
    V, A = rand(seed=4, density=0.2)
    tV = torch.from_numpy(V).requires_grad_()
    y = relagg.dropedge_aggregate(tV, torch.from_numpy(A), 7, RATE).sum()
    y.backward()
    np.testing.assert_allclose(float((tV.grad * tV.detach()).sum()), y.item(), rtol=1e-4)
    g = torch.ones(1, 128, 2, 32)
    direct = relagg.dropedge_aggregate_grad(g, torch.from_numpy(A), 7, RATE)
    np.testing.assert_array_equal(direct.numpy(), tV.grad.numpy())
    # A backward with another mask misses by more than a tenth of the sum
    # (the bound chip_smoke.py's 1e-5 check relies on).
    for other in (8, 9):
        wrong = relagg.dropedge_aggregate_grad(g, torch.from_numpy(A), other, RATE)
        assert abs(float((wrong * tV.detach()).sum()) - y.item()) > 0.1 * abs(y.item())

    def f(v):
        return jnp.sum(jax_relagg.pallas_dropedge_aggregate(v, jnp.asarray(A), jnp.int32(7), RATE))

    dV = jax.grad(f)(jnp.asarray(V))
    np.testing.assert_allclose(float(jnp.vdot(dV, jnp.asarray(V))), float(f(jnp.asarray(V))), rtol=1e-4)


def test_rate_zero_is_k3_and_its_gradient_is_jax_grad():
    """At rate 0 the port calls K3 as grl_tpu does (gcn_family.py:86-88):
    the output is grl_tpu's Pallas K3 and the gradient its jax.grad, to
    float32 order (1e-5)."""
    V, A = rand(seed=5, density=0.1)
    W = np.random.RandomState(6).randn(1, 128, 2, 32).astype(np.float32)
    tV = torch.from_numpy(V).requires_grad_()
    out = relagg.dropedge_aggregate(tV, torch.from_numpy(A), 1, 0.0)
    (out * torch.from_numpy(W)).sum().backward()
    expected = jax_relagg.pallas_neighbor_aggregate(jnp.asarray(V), jnp.asarray(A))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(expected), rtol=1e-5, atol=1e-5)
    grad = jax.grad(
        lambda v: jnp.sum(jax_relagg.pallas_neighbor_aggregate(v, jnp.asarray(A)) * jnp.asarray(W))
    )(jnp.asarray(V))
    np.testing.assert_allclose(tV.grad.numpy(), np.asarray(grad), rtol=1e-5, atol=1e-5)


def test_drop_edge_statistics_against_grl_tpu():
    """relconv.drop_edge in law against grl_tpu's: survivors of A = 1 are
    1/keep, the kept share over the (B, N, L+1, N) draws is keep within
    0.01 (five standard deviations of 49k draws), the self scale takes the
    values {0, 1/keep} with mean 1 within 0.05 (4k draws), and the mean
    over all draws is A's within 0.01."""
    A = np.ones((2, 64, 6, 64), np.float32)
    gen = torch.Generator().manual_seed(0)
    ours = [relconv.drop_edge(torch.from_numpy(A), RATE, gen) for _ in range(16)]
    theirs = [
        jax_relconv.drop_edge(jax.random.PRNGKey(i), jnp.asarray(A), RATE) for i in range(16)
    ]
    for name, draws in (("port", [(a.numpy(), s.numpy()) for a, s in ours]),
                        ("grl_tpu", [(np.asarray(a), np.asarray(s)) for a, s in theirs])):
        dropped, self_scale = draws[0]
        assert set(np.unique(dropped)) <= {0.0, np.float32(1.0 / KEEP)}, name
        assert set(np.unique(self_scale)) <= {0.0, np.float32(1.0 / KEEP)}, name
        assert self_scale.shape == (2, 64)
        assert abs((dropped != 0).mean() - KEEP) < 0.01, name
        assert abs(np.mean([a for a, _ in draws]) - 1.0) < 0.01, name
        assert abs(np.mean([s for _, s in draws]) - 1.0) < 0.05, name
    tA = torch.from_numpy(A)
    assert relconv.drop_edge(tA, 0.0, gen) == (tA, None)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**32 - 1])
def test_tensor_seed_gives_the_int_seeds_mask_bit_for_bit(seed):
    """K1 and K2 take their seed as an int or as the one-element int32
    tensor that the kernels read from device memory (the train step draws
    it on the device): their plain versions give the same mask and the
    same outputs, bit for bit."""
    from grl_torch.ops import hashing

    rng = np.random.RandomState(3)
    V = torch.from_numpy(rng.rand(2, 16, 8).astype(np.float32))
    A = torch.from_numpy((rng.rand(2, 16, 3, 16) < 0.5).astype(np.float32))
    g = torch.from_numpy(rng.rand(2, 16, 3, 8).astype(np.float32))
    tensor = hashing.seed_tensor(seed)
    assert tensor.dtype == torch.int32 and tensor.shape == (1,)
    mask = relagg.dropedge_keep_mask(seed, A.shape, 0.3)
    assert torch.equal(relagg.dropedge_keep_mask(tensor, A.shape, 0.3), mask)
    assert 0.6 < float(mask.float().mean()) < 0.8
    assert torch.equal(relagg.dropedge_aggregate(V, A, tensor, 0.3), relagg.dropedge_aggregate(V, A, seed, 0.3))
    assert torch.equal(relagg.dropedge_aggregate_grad(g, A, tensor, 0.3),
                       relagg.dropedge_aggregate_grad(g, A, seed, 0.3))
    # Through autograd, K2 reads the seed tensor K1 read.
    Vg = V.clone().requires_grad_()
    (dV,) = torch.autograd.grad(relagg.dropedge_aggregate(Vg, A, tensor, 0.3), Vg, g)
    assert torch.equal(dV, relagg.dropedge_aggregate_grad(g, A, seed, 0.3))
