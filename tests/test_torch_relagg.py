"""K3 neighbor aggregation and the dense relational ops of grl_torch,
held against grl_tpu on the same numpy-seeded inputs.

The JAX side is the Pallas kernel in interpret mode, as tests/test_pallas.py
runs it on the CPU. The port's wrapper takes its plain version for CPU
tensors, so here it never launches the CUDA kernel; the kernel itself is
checked on the card by tests/test_torch_cuda.py and chip_smoke.py.
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
from grl_torch.ops import launches, relagg, relconv


@pytest.fixture(autouse=True)
def interpret_mode():
    jax_relagg.INTERPRET = True
    with pltpu.force_tpu_interpret_mode():
        yield
    jax_relagg.INTERPRET = False


def rand(seed=0, B=2, N=128, L=6, F=32, density=0.05):
    rng = np.random.RandomState(seed)
    V = rng.randn(B, N, F).astype(np.float32)
    A = (rng.rand(B, N, L, N) < density).astype(np.float32)
    return V, A


def to_torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("N", [128, 256])
def test_matches_pallas_kernel_f32(N):
    """float32: both accumulate in float32; only the order differs (1e-5)."""
    V, A = rand(N=N)
    expected = np.asarray(jax_relagg.pallas_neighbor_aggregate(jnp.asarray(V), jnp.asarray(A)))
    launches.reset()
    out = relagg.neighbor_aggregate(*to_torch(V, A))
    assert out.shape == expected.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), expected, rtol=1e-5, atol=1e-5)
    assert launches.device_counts()["K3"] == 0  # CPU tensors: plain version


def test_matches_pallas_kernel_bf16():
    """bfloat16 operands, float32 accumulation, one rounding to bfloat16 at
    the end on both sides: they differ by at most one bf16 ulp (2**-7
    relative), from sums taken in another order."""
    V, A = rand(N=128, density=0.2)
    V = np.array(jnp.asarray(V, jnp.bfloat16).astype(jnp.float32))
    expected = jax_relagg.pallas_neighbor_aggregate(
        jnp.asarray(V, jnp.bfloat16), jnp.asarray(A, jnp.bfloat16)
    )
    assert expected.dtype == jnp.bfloat16
    out = relagg.neighbor_aggregate(*to_torch(V, A, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(expected.astype(jnp.float32)), rtol=2**-7, atol=1e-3
    )


@pytest.mark.parametrize("N", [64, 192, 230, 231])
def test_ragged_buckets_match_xla_path(N):
    """The 64-quantum serving buckets, a trainer's quantum-2 bucket of 230
    nodes and an odd N, which the TPU kernel refuses (relagg.py:52-62);
    held against grl_tpu's XLA aggregation."""
    V, A = rand(N=N, seed=N)
    with pytest.raises(ValueError):
        jax_relagg.pallas_neighbor_aggregate(jnp.asarray(V), jnp.asarray(A))
    expected = np.asarray(jax_relconv.relational_neighbor_aggregate(jnp.asarray(V), jnp.asarray(A)))
    out = relagg.neighbor_aggregate(*to_torch(V, A))
    np.testing.assert_allclose(out.reshape(2, N, -1).numpy(), expected, rtol=1e-5, atol=1e-5)


def test_backward_matches_jax_grad():
    """dV and dA of a weighted sum, against jax.grad through the kernel's
    custom VJP (XLA einsums there, torch einsums here)."""
    V, A = rand(N=128, F=16, density=0.1)
    W = np.random.RandomState(7).randn(2, 128, 6, 16).astype(np.float32)

    def loss(v, a):
        return jnp.sum(jax_relagg.pallas_neighbor_aggregate(v, a) * W)

    dV_ref, dA_ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(V), jnp.asarray(A))
    Vt, At = (t.requires_grad_() for t in to_torch(V, A))
    (relagg.neighbor_aggregate(Vt, At) * torch.from_numpy(W)).sum().backward()
    np.testing.assert_allclose(Vt.grad.numpy(), np.asarray(dV_ref), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(At.grad.numpy(), np.asarray(dA_ref), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize(
    "V_shape, A_shape, dtypes, error",
    [
        ((2, 64, 8), (2, 64, 6, 32), (torch.float32, torch.float32), ValueError),
        ((2, 64, 8), (2, 64, 6, 64), (torch.float32, torch.bfloat16), TypeError),
        ((2, 64), (2, 64, 6, 64), (torch.float32, torch.float32), ValueError),
    ],
)
def test_wrapper_rejects_bad_inputs(V_shape, A_shape, dtypes, error):
    with pytest.raises(error):
        relagg.neighbor_aggregate(torch.zeros(V_shape, dtype=dtypes[0]), torch.zeros(A_shape, dtype=dtypes[1]))


def test_relational_ops_match_jax():
    """relational_aggregate (with a self scale), preprocess_adjacency and
    relational_aggregate_dense against their grl_tpu counterparts."""
    V, A = rand(N=64, F=8)
    scale = np.random.RandomState(3).rand(2, 64).astype(np.float32)
    jV, jA = jnp.asarray(V), jnp.asarray(A)
    tV, tA = to_torch(V, A)
    np.testing.assert_allclose(
        relconv.relational_aggregate(tV, tA, torch.from_numpy(scale)).numpy(),
        np.asarray(jax_relconv.relational_aggregate(jV, jA, jnp.asarray(scale))),
        rtol=1e-5, atol=1e-5,
    )
    A_pre = relconv.preprocess_adjacency(tA)
    np.testing.assert_array_equal(A_pre.numpy(), np.asarray(jax_relconv.preprocess_adjacency(jA)))
    np.testing.assert_allclose(
        relconv.relational_aggregate_dense(tV, A_pre).numpy(),
        np.asarray(jax_relconv.relational_aggregate_dense(jV, jax_relconv.preprocess_adjacency(jA))),
        rtol=1e-5, atol=1e-5,
    )
    # The split form without the identity block equals the dense layout.
    np.testing.assert_allclose(
        relconv.relational_aggregate(tV, tA).numpy(),
        relconv.relational_aggregate_dense(tV, A_pre).numpy(),
        rtol=1e-6, atol=1e-6,
    )


def test_build_is_lazy_and_keyed_on_source(monkeypatch, tmp_path):
    """Importing the ops needs no nvcc; the library name hashes the source."""
    from grl_torch.ops import _build

    assert "relagg_ragged" in _build.SOURCES and (_build.CSRC / "relagg_ragged.cu").exists()
    assert not _build._libs  # nothing was built by importing
    first = _build._library_path("relagg_ragged", "/usr/local/cuda/bin/nvcc")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "relagg_ragged.cu").write_text("// another source\n")
    assert _build._library_path("relagg_ragged", "/usr/local/cuda/bin/nvcc") != first
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()

