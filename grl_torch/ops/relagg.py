"""K3: relational neighbor aggregation — the hand-written CUDA kernel.

Replaces the TPU kernel ``grl_tpu/ops/pallas/relagg.py`` ·
``pallas_neighbor_aggregate`` (``_agg_forward`` :92-123, body
``_agg_kernel`` :76-89)::

    out[b, n, l, :] = sum_m A[b, n, l, m] * V[b, m, :]

for ``V (B, N, F)`` and ``A (B, N, L, N)``, both float32 or both bfloat16,
returning ``(B, N, L, F)`` in V's dtype with float32 accumulation. The
kernel is ``grl_torch/csrc/relagg.cu``, compiled for ``sm_90a`` at first
use (:mod:`grl_torch.ops._build`) and called through ``ctypes``.

What bounds it on an H100: at the serving shape B=8, N=256, L=6, F=256
the call is ~1.6 GFLOP against ~13.6 MB moved in bf16, ~120 FLOP/byte —
below the card's bf16 ridge of ~295 FLOP/byte, so device-memory bandwidth
is the floor. The kernel reads A in the dataset layout with no transpose
and writes the output in place in the operand dtype, so each operand
crosses device memory once (see the note at the top of the source).

* :func:`neighbor_aggregate_reference` — the plain PyTorch version. The
  tests use it, and it is the only path for CPU tensors.
* :func:`neighbor_aggregate` — the wrapper. CPU tensors take the plain
  version; CUDA tensors launch the kernel or raise. It counts kernel
  launches in ``neighbor_aggregate.launches``. Its backward is the plain
  einsums of ``relagg.py:136-142`` (XLA on the TPU, not Pallas).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from grl_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535
_TILE_ROWS = 64  # output rows per block (kF32BM == kBM in relagg.cu)


def neighbor_aggregate_reference(V: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Plain version: one float32 batched matmul, cast to V's dtype."""
    B, N, L, _ = A.shape
    F = V.shape[-1]
    out = torch.matmul(A.float().reshape(B, N * L, N), V.float())
    return out.reshape(B, N, L, F).to(V.dtype)


def _check(V: torch.Tensor, A: torch.Tensor) -> None:
    if V.dim() != 3 or A.dim() != 4:
        raise ValueError(
            f"expected V (B,N,F) and A (B,N,L,N); got {tuple(V.shape)} and {tuple(A.shape)}"
        )
    B, N, F = V.shape
    if A.shape[0] != B or A.shape[1] != N or A.shape[3] != N:
        raise ValueError(
            f"A {tuple(A.shape)} does not match V {tuple(V.shape)}: need A (B,N,L,N)"
        )
    if A.dtype != V.dtype:
        raise TypeError(f"A and V must share a dtype; got {A.dtype} and {V.dtype}")
    if A.device != V.device:
        raise ValueError(f"A on {A.device} but V on {V.device}")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (once)."""
    lib = _build.load_library("relagg")
    lib.grl_relagg_forward.restype = ctypes.c_int
    lib.grl_relagg_forward.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.grl_cuda_error_string.restype = ctypes.c_char_p
    lib.grl_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _launch(V: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; no synchronisation."""
    if V.dtype not in _DTYPE_CODES:
        raise TypeError(f"CUDA relagg takes float32 or bfloat16, not {V.dtype}")
    if not (V.is_contiguous() and A.is_contiguous()):
        raise ValueError("CUDA relagg needs contiguous V and A (dataset layout)")
    B, N, L, _ = A.shape
    F = V.shape[-1]
    if B > _MAX_GRID_YZ or -(-N * L // _TILE_ROWS) > _MAX_GRID_YZ:
        raise ValueError(f"shape B={B}, N*L={N * L} exceeds the kernel's grid limits")
    out = torch.empty((B, N, L, F), dtype=V.dtype, device=V.device)
    if out.numel() == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(V.device).cuda_stream
    err = lib.grl_relagg_forward(
        A.data_ptr(), V.data_ptr(), out.data_ptr(), B, N, L, F,
        _DTYPE_CODES[V.dtype], V.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"relagg kernel launch failed: {lib.grl_cuda_error_string(err).decode()} ({err})"
        )
    neighbor_aggregate.launches += 1
    return out


class _NeighborAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, V: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(V, A)
        if V.device.type == "cuda":
            return _launch(V, A)
        if V.device.type == "cpu":
            return neighbor_aggregate_reference(V, A)
        raise ValueError(f"relagg runs on CUDA or CPU tensors, not {V.device}")

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        V, A = ctx.saved_tensors
        dV = dA = None
        if ctx.needs_input_grad[0]:
            # dV[b,m,f] = sum_{n,l} A[b,n,l,m] g[b,n,l,f]
            dV = torch.einsum("bnlm,bnlf->bmf", A, g).to(V.dtype)
        if ctx.needs_input_grad[1]:
            # dA[b,n,l,m] = g[b,n,l,:] . V[b,m,:]
            dA = torch.einsum("bnlf,bmf->bnlm", g, V).to(A.dtype)
        return dV, dA


def neighbor_aggregate(V: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """``(B,N,L,F)`` neighbor aggregate of ``V (B,N,F)`` by ``A (B,N,L,N)``.

    CPU tensors take :func:`neighbor_aggregate_reference`; CUDA tensors
    launch the K3 kernel (counted in ``neighbor_aggregate.launches``) or
    raise — there is no fallback.
    """
    _check(V, A)
    return _NeighborAggregate.apply(V, A)


neighbor_aggregate.launches = 0
