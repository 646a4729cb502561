"""D (dropout with K0's hashed keep mask) on the CPU: the plain version's
arithmetic bit for bit, its mask against the hash, its law against flax
``nn.Dropout`` (what grl_tpu's models run), the autograd function, the
``Dropout`` layer and the refusals.

No device reproduces flax's mask bits, so the law is compared: the keep
share within 5 binomial standard deviations of ``1 - rate`` on both sides,
and the mean of a dropped tensor of ones within 5 standard deviations of 1.
The CUDA kernel is held to the plain version bit for bit on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
from __future__ import annotations

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import linen as nn

from grl_torch.models import Rngs, layers
from grl_torch.ops import dropout, hashing, launches

SDS = 5


def within_law(kept: int, total: int, rate: float) -> bool:
    keep = 1.0 - rate
    return abs(kept / total - keep) <= SDS * math.sqrt(keep * rate / total)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_plain_version_is_where_keep_bits_of_the_scaled_input(dtype, rate):
    x = torch.from_numpy(np.random.RandomState(0).randn(37, 91).astype(np.float32)).to(dtype)
    y = dropout.dropout_reference(x, 2024, rate)
    kept = hashing.keep_bits(torch.arange(x.numel()), 2024, rate).view(x.shape)
    scaled = (x.float() * np.float32(hashing.keep_scale(rate))).to(dtype)
    assert y.dtype == dtype
    assert torch.equal(y, torch.where(kept, scaled, torch.zeros((), dtype=dtype)))
    assert torch.equal(y != 0, kept)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**32 - 1])
def test_an_int_seed_and_its_tensor_give_one_mask(seed):
    x = torch.randn(8, 300)
    assert torch.equal(dropout.dropout_reference(x, seed, 0.5),
                       dropout.dropout_reference(x, hashing.seed_tensor(seed), 0.5))
    assert not torch.equal(dropout.dropout_reference(x, seed, 0.5), dropout.dropout_reference(x, seed + 1, 0.5))


def test_forward_and_backward_apply_one_mask_and_save_only_the_seed():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(64, 48, generator=gen).requires_grad_()
    dy = torch.randn(64, 48, generator=gen)
    seed = hashing.seed_tensor(11)
    y = dropout.dropout(x, seed, 0.3)
    assert [t.numel() for t in y.grad_fn.saved_tensors] == [1]
    y.backward(dy)
    assert torch.equal(x.grad, dropout.dropout_reference(dy, seed, 0.3))
    mask = hashing.keep_bits(torch.arange(x.numel()), seed, 0.3).view(x.shape)
    assert torch.equal(y, torch.where(mask, y, 0.0)) and torch.equal(x.grad, torch.where(mask, x.grad, 0.0))
    assert torch.equal(y[mask], (x[mask] * np.float32(hashing.keep_scale(0.3))).detach())


def test_the_cpu_path_takes_the_plain_version_and_other_devices_raise():
    x = torch.randn(16, 40)
    before = launches.device_counts()
    assert torch.equal(dropout.apply_dropout(x.t(), 3, 0.5), dropout.dropout_reference(x.t().contiguous(), 3, 0.5))
    assert launches.device_counts() == before  # no kernel ran
    with pytest.raises(ValueError, match="CUDA or CPU"):
        dropout.apply_dropout(torch.zeros(4, 8, device="meta"), 3, 0.5)


def test_a_tensor_of_two_to_the_32_elements_is_refused_without_allocating():
    x = torch.zeros(1).expand(2**32)  # a view: no 16 GiB behind it
    for call in (lambda: dropout.dropout(x, 0, 0.5), lambda: dropout.apply_dropout(x, 0, 0.5),
                 lambda: dropout.dropout_reference(x, 0, 0.5)):
        with pytest.raises(ValueError, match="2\\^32"):
            call()
    assert dropout.MAX_ELEMENTS == 2**32


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_share_and_mean_follow_flax_dropouts_law(rate):
    """flax ``nn.Dropout`` (grl_tpu's dropout) and D on 200,000 ones: both
    keep shares within binomial bounds of 1 - rate, both means near 1."""
    n = 200_000
    theirs = np.asarray(nn.Dropout(rate).apply({}, jnp.ones(n), deterministic=False,
                                               rngs={"dropout": jax.random.PRNGKey(0)}))
    ours = dropout.dropout_reference(torch.ones(n), 17, rate).numpy()
    sd_of_mean = math.sqrt(rate / (1 - rate) / n)
    for y in (theirs, ours):
        assert within_law(int((y != 0).sum()), n, rate)
        assert abs(float(y.mean()) - 1.0) <= SDS * sd_of_mean
        np.testing.assert_allclose(np.unique(y[y != 0]), [hashing.keep_scale(rate)], rtol=1e-6)


def test_masks_of_neighbouring_seeds_and_elements_are_independent():
    """Two seeds agree on a share keep^2 + rate^2 of the elements, as
    independent masks do."""
    n, rate = 100_000, 0.5
    a = hashing.keep_bits(torch.arange(n), 5, rate)
    b = hashing.keep_bits(torch.arange(n), 6, rate)
    agree = int((a == b).sum())
    assert within_law(agree, n, 0.5)


def test_dropout_layer_is_the_identity_in_eval_and_at_rate_0_and_draws_a_seed_in_training():
    x = torch.randn(32, 64)
    layer = layers.Dropout(0.5)
    layer.eval()
    assert layer(x) is x
    assert layers.Dropout(0.0).train()(x, Rngs.from_seed(0, torch.device("cpu"))) is x
    assert torch.equal(layers.Dropout(1.0).train()(x), torch.zeros_like(x))
    layer.train()
    rngs = Rngs.from_seed(3, torch.device("cpu"))
    first, second = layer(x, rngs), layer(x, rngs)
    assert not torch.equal(first != 0, second != 0)
    again = Rngs.from_seed(3, torch.device("cpu"))
    seed = again.kernel_seed()
    assert torch.equal(first, dropout.dropout_reference(x, seed, 0.5))
    assert within_law(int((first != 0).sum()), x.numel(), 0.5)
    with pytest.raises(ValueError, match="rngs"):
        layer(x)
