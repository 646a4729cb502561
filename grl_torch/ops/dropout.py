"""D: dropout with a hashed keep mask, one pass each way.

Counterpart of flax ``nn.Dropout`` as ``grl_tpu`` uses it
(``grl_tpu/models/gcn_family.py:114,245``; XLA fuses it on the TPU). For
``x`` and a seed, every element ``i`` of ``x`` (its flat index in the
contiguous layout) is kept iff K0's hash keeps it,
``hashing.keep_bits(i, seed, rate)``, and then scaled:

    y[i] = round(float32(x[i]) * scale)   if kept,   else 0

with ``keep = hashing.keep_probability(rate)`` (``1 - rate`` rounded to
float32), ``scale = hashing.keep_scale(rate)`` (``1 / keep`` in float32),
the product taken in float32 and rounded once to x's dtype. The kernel
(``grl_torch/csrc/dropout.cu``) equals :func:`dropout_reference` bit for
bit. The backward is the same function of ``dy`` under the same seed: the
mask is regenerated from the seed, never stored, so autograd saves only
the one-element seed tensor. Ids are 32-bit and wrap as K0's do: a tensor
of 2^32 elements or more is refused.

The mask has the law of flax's (each element kept independently with
probability ``keep``, kept ones scaled by ``1 / keep``), not its bits: no
device reproduces flax's bits (ROADMAP Queue 3). A seed is an int or the
one-element int32 device tensor of ``Rngs.kernel_seed()``, which the
kernel reads from device memory, so a captured CUDA graph draws new masks
at every replay.

:func:`apply_dropout` takes the plain version for CPU tensors and launches
D for CUDA tensors, or raises; it counts launches as ``D forward`` and
``D backward`` in :mod:`grl_torch.ops.launches`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from grl_torch.ops import _build, launches
from grl_torch.ops.hashing import Seed, keep_bits, keep_probability, keep_scale, seed_tensor
from grl_torch.ops.sparse import sm_count

_DTYPE_CODES = {getattr(torch, name): code for name, code in _build.DTYPE_CODES.items()}
THREADS = 256  # a block of D
# Blocks of D an SM holds at once (2048 threads); the grid is one wave.
BLOCKS_PER_SM = 8
# Element ids are uint32 (K0's gid).
MAX_ELEMENTS = 1 << 32


def _check_size(x: torch.Tensor) -> None:
    if x.numel() >= MAX_ELEMENTS:
        raise ValueError(f"dropout ids are 32-bit: a tensor of {x.numel()} elements has more than 2^32")


def dropout_reference(x: torch.Tensor, seed: Seed, rate: float) -> torch.Tensor:
    """Plain D: ``where(keep_bits(i, seed, rate), x * scale, 0)`` over the
    flat index ``i`` of ``x`` made contiguous, the product in float32
    rounded once to x's dtype."""
    _check_size(x)
    x = x.contiguous()
    kept = keep_bits(torch.arange(x.numel(), device=x.device), seed, rate).view(x.shape)
    wide = x.to(torch.promote_types(x.dtype, torch.float32))
    scaled = (wide * torch.tensor(keep_scale(rate), dtype=torch.float32)).to(x.dtype)
    return torch.where(kept, scaled, torch.zeros((), dtype=x.dtype, device=x.device))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built D library with its C signature declared (once)."""
    lib = _build.load_library("dropout")
    lib.grl_dropout.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,  # x, y, n, seed
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,  # keep, scale, blocks, dtype
        ctypes.c_int, ctypes.c_void_p,  # device, stream
    ]
    lib.grl_dropout.restype = ctypes.c_int
    return lib


def _launch(x: torch.Tensor, seed: Seed, rate: float) -> torch.Tensor:
    """Launch D on the current stream, once, over contiguous, 16-byte
    aligned ``x``; no synchronisation."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"CUDA D takes float32 or bfloat16; got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("CUDA D needs a contiguous, 16-byte aligned x")
    _check_size(x)
    seed = seed_tensor(seed, x.device)
    y = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return y
    vecs = -(-n // (16 // x.element_size()))
    blocks = max(1, min(-(-vecs // THREADS), sm_count(x.device.index) * BLOCKS_PER_SM))
    lib = _library()
    err = lib.grl_dropout(
        x.data_ptr(), y.data_ptr(), n, seed.data_ptr(), keep_probability(rate), keep_scale(rate), blocks,
        _DTYPE_CODES[x.dtype], x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check_launch(lib, err, "D")
    return y


def apply_dropout(x: torch.Tensor, seed: Seed, rate: float, direction: str = "forward") -> torch.Tensor:
    """D over ``x`` (made contiguous first): the plain version for CPU
    tensors, the kernel for CUDA tensors (counted as ``D <direction>``)."""
    _check_size(x)
    if x.device.type == "cpu":
        return dropout_reference(x, seed, rate)
    if x.device.type != "cuda":
        raise ValueError(f"D runs on CUDA or CPU tensors, not {x.device}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()  # a contiguous view at an odd offset: a fresh allocation is aligned
    y = _launch(x, seed, rate)
    launches.count(f"D {direction}")
    return y


class _Dropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, seed: torch.Tensor, rate: float):
        ctx.save_for_backward(seed)
        ctx.rate = rate
        return apply_dropout(x, seed, rate, "forward")

    @staticmethod
    def backward(ctx, dy):
        seed, = ctx.saved_tensors
        return apply_dropout(dy, seed, ctx.rate, "backward"), None, None


def dropout(x: torch.Tensor, seed: Seed, rate: float) -> torch.Tensor:
    """Differentiable D of ``x`` at ``rate`` (``0 <= rate < 1``) under
    ``seed``; the backward applies the same mask and scale to the
    gradient."""
    _check_size(x)
    return _Dropout.apply(x, seed_tensor(seed, x.device), float(rate))
