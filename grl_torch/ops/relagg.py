"""K3, K1 and K2: relational neighbor aggregation, hand-written in CUDA.

The kernels are ``grl_torch/csrc/relagg.cu``, compiled for ``sm_90a`` at
first use (:mod:`grl_torch.ops._build`) and called through ``ctypes``.

* K3 replaces ``grl_tpu/ops/pallas/relagg.py`` · ``pallas_neighbor_aggregate``
  (``_agg_forward`` :92-123, body ``_agg_kernel`` :76-89)::

      out[b, n, l, :] = sum_m A[b, n, l, m] * V[b, m, :]

* K1 replaces ``pallas_dropedge_aggregate`` (``_dropedge_forward``
  :213-248, body ``_dropedge_kernel`` :157-180): the same product with
  DropEdge fused into A, ``A * keep(gid) / keep``; the mask is drawn in
  the kernel and never stored.
* K2 replaces its backward ``_dropedge_bwd`` (:272-311, body
  ``_dropedge_bwd_kernel`` :183-210)::

      dV[b, m, :] = sum_{n, l} A[b, n, l, m] * keep(gid) / keep * g[b, n, l, :]

``V (B, N, F)``, ``A (B, N, L, N)`` and ``g (B, N, L, F)`` are all float32
or all bfloat16; results come back in the operand dtype with float32
accumulation.

The DropEdge mask is a pure function of the seed and the element's index
``gid = ((b*N + n)*L + l)*N + m`` in A (:func:`dropedge_keep_mask`), the
two-injection murmur hash of ``grl_tpu/ops/pallas/csr_spmm.py:_hash_keep``
(:mod:`grl_torch.ops.hashing`, shared with K5).
The TPU kernels draw per-tile bits from the TPU's hardware PRNG instead,
which no other device reproduces; keyed on the element, K1 and K2 see one
mask whatever their tiling, and the plain versions here compute the
identical mask, so the kernels are held to them exactly in the mask.

What bounds them on an H100: at the flagship's shape B=8, N=256, L=6,
F=256 each call is ~1.6 GFLOP against ~13.6 MB moved in bf16, ~120
FLOP/byte — below the card's bf16 ridge of ~295 FLOP/byte, so
device-memory bandwidth is the floor. The kernels read A in the dataset
layout with no transpose and write their output in place in the operand
dtype, so each operand crosses device memory once (see the note at the
top of the source).

Every wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors, or raises; it counts launches in ``.launches``:

* :func:`neighbor_aggregate` — K3. Its backward is the plain einsums of
  ``relagg.py:136-142`` (XLA on the TPU, not Pallas).
* :func:`dropedge_aggregate` — K1 (``rate == 0`` is K3, as in
  ``grl_tpu``); its backward is :func:`dropedge_aggregate_grad` — K2.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from grl_torch.ops import _build
from grl_torch.ops.hashing import keep_bits, keep_probability

_DTYPE_CODES = {getattr(torch, name): code for name, code in _build.DTYPE_CODES.items()}
_MAX_GRID_YZ = 65535
_TILE_ROWS = 64  # output rows per block (kF32BM == kBM in relagg.cu)
_MAX_ELEMENTS = 2**32  # gid is a uint32 in the kernels


# ---------------------------------------------------------------------------
# The DropEdge mask
# ---------------------------------------------------------------------------
def dropedge_keep_mask(seed: int, shape, rate: float, device=None) -> torch.Tensor:
    """Boolean keep mask over a tensor of ``shape``: element ``gid`` (its
    row-major index) is kept iff
    ``(mix(mix(gid ^ s) + s) >> 8) * 2^-24 < keep`` with ``s = seed mod 2^32``.
    """
    numel = math.prod(shape)
    if numel >= _MAX_ELEMENTS:
        raise ValueError(f"DropEdge mask over {numel} elements: the element index must fit 32 bits")
    gid = torch.arange(numel, dtype=torch.int64, device=device).reshape(tuple(shape))
    return keep_bits(gid, seed, rate)


def _masked_float(A: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    return torch.where(dropedge_keep_mask(seed, A.shape, rate, A.device), A.float(), 0.0)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------
def neighbor_aggregate_reference(V: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Plain K3: one float32 batched matmul, cast to V's dtype."""
    B, N, L, _ = A.shape
    F = V.shape[-1]
    out = torch.matmul(A.float().reshape(B, N * L, N), V.float())
    return out.reshape(B, N, L, F).to(V.dtype)


def dropedge_aggregate_reference(V: torch.Tensor, A: torch.Tensor, seed: int,
                                 rate: float) -> torch.Tensor:
    """Plain K1: the mask applied in float32, ``1/keep`` on the float32
    product, cast once to V's dtype. Differentiable in V."""
    B, N, L, _ = A.shape
    F = V.shape[-1]
    out = torch.matmul(_masked_float(A, seed, rate).reshape(B, N * L, N), V.float())
    out = out * (1.0 / keep_probability(rate))
    return out.reshape(B, N, L, F).to(V.dtype)


def dropedge_aggregate_grad_reference(g: torch.Tensor, A: torch.Tensor, seed: int,
                                      rate: float) -> torch.Tensor:
    """Plain K2: ``dV (B, N, F)`` in g's dtype, mask applied in float32."""
    B, N, L, _ = A.shape
    F = g.shape[-1]
    A_m = _masked_float(A, seed, rate).reshape(B, N * L, N)
    dV = torch.matmul(A_m.transpose(1, 2), g.float().reshape(B, N * L, F))
    return (dV * (1.0 / keep_probability(rate))).to(g.dtype)


# ---------------------------------------------------------------------------
# Launching the kernels
# ---------------------------------------------------------------------------
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


def _check_grad(g: torch.Tensor, A: torch.Tensor) -> None:
    B, N, L, _ = A.shape
    if g.dim() != 4 or tuple(g.shape[:3]) != (B, N, L):
        raise ValueError(f"g {tuple(g.shape)} does not match A {tuple(A.shape)}: need g (B,N,L,F)")
    if g.dtype != A.dtype:
        raise TypeError(f"g and A must share a dtype; got {g.dtype} and {A.dtype}")
    if g.device != A.device:
        raise ValueError(f"A on {A.device} but g on {g.device}")


def _check_mask(A: torch.Tensor, rate: float) -> None:
    keep_probability(rate)
    if A.numel() >= _MAX_ELEMENTS:
        raise ValueError(
            f"A has {A.numel()} elements; DropEdge keys its mask on a 32-bit element index"
        )


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (once)."""
    lib = _build.load_library("relagg")
    head = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5  # A, X, out, B, N, L, F, dtype
    tail = [ctypes.c_int, ctypes.c_void_p]  # device, stream
    lib.grl_relagg_forward.argtypes = head + tail
    for name in ("grl_dropedge_forward", "grl_dropedge_backward"):
        getattr(lib, name).argtypes = head + [ctypes.c_uint32, ctypes.c_float] + tail
    for name in ("grl_relagg_forward", "grl_dropedge_forward", "grl_dropedge_backward"):
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _launch(entry: str, A: torch.Tensor, X: torch.Tensor, out_shape, *mask_args) -> torch.Tensor:
    """Launch ``entry`` of relagg.cu on the current stream; no synchronisation.

    ``X`` is V for K3/K1 and g for K2; ``mask_args`` is ``(seed, keep)``
    for K1/K2.
    """
    if X.dtype not in _DTYPE_CODES:
        raise TypeError(f"CUDA relagg takes float32 or bfloat16, not {X.dtype}")
    if not (X.is_contiguous() and A.is_contiguous()):
        raise ValueError("CUDA relagg needs contiguous operands (dataset layout)")
    B, N, L, _ = A.shape
    F = X.shape[-1]
    if B > _MAX_GRID_YZ or -(-N * L // _TILE_ROWS) > _MAX_GRID_YZ:
        raise ValueError(f"shape B={B}, N*L={N * L} exceeds the kernel's grid limits")
    out = torch.empty(out_shape, dtype=X.dtype, device=X.device)
    if out.numel() == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = getattr(lib, entry)(
        A.data_ptr(), X.data_ptr(), out.data_ptr(), B, N, L, F,
        _DTYPE_CODES[X.dtype], *mask_args, X.device.index, stream,
    )
    _build.check_launch(lib, err, entry)
    return out


def _by_device(tensor: torch.Tensor) -> str:
    if tensor.device.type not in ("cuda", "cpu"):
        raise ValueError(f"relagg runs on CUDA or CPU tensors, not {tensor.device}")
    return tensor.device.type


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------
class _NeighborAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, V: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(V, A)
        if _by_device(V) == "cpu":
            return neighbor_aggregate_reference(V, A)
        B, N, L, _ = A.shape
        out = _launch("grl_relagg_forward", A, V, (B, N, L, V.shape[-1]))
        neighbor_aggregate.launches += 1
        return out

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


# ---------------------------------------------------------------------------
# K1 and K2
# ---------------------------------------------------------------------------
def _dropedge_forward(V: torch.Tensor, A: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """K1 for CUDA tensors, its plain version for CPU tensors."""
    if _by_device(V) == "cpu":
        return dropedge_aggregate_reference(V, A, seed, rate)
    B, N, L, _ = A.shape
    out = _launch(
        "grl_dropedge_forward", A, V, (B, N, L, V.shape[-1]),
        int(seed) & 0xFFFFFFFF, keep_probability(rate),
    )
    dropedge_aggregate.launches += 1
    return out


def dropedge_aggregate_grad(g: torch.Tensor, A: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """``dV (B, N, F)`` of :func:`dropedge_aggregate` for the output
    cotangent ``g (B, N, L, F)``: the K2 kernel on CUDA tensors (counted in
    ``dropedge_aggregate_grad.launches``), its plain version on CPU ones."""
    _check_grad(g, A)
    _check_mask(A, rate)
    if _by_device(g) == "cpu":
        return dropedge_aggregate_grad_reference(g, A, seed, rate)
    B, N, _, F = g.shape
    dV = _launch(
        "grl_dropedge_backward", A, g, (B, N, F),
        int(seed) & 0xFFFFFFFF, keep_probability(rate),
    )
    dropedge_aggregate_grad.launches += 1
    return dV


dropedge_aggregate_grad.launches = 0


class _DropEdgeAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, V: torch.Tensor, A: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
        ctx.save_for_backward(A)
        ctx.seed, ctx.rate = seed, rate
        return _dropedge_forward(V, A, seed, rate)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (A,) = ctx.saved_tensors
        dV = None
        if ctx.needs_input_grad[0]:
            dV = dropedge_aggregate_grad(g.contiguous(), A, ctx.seed, ctx.rate)
        # A is data and the seed an integer: in grl_tpu their cotangents are
        # zeros that are never used (relagg.py:308-311).
        return dV, None, None, None


def dropedge_aggregate(V: torch.Tensor, A: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """``(B,N,L,F)`` neighbor aggregate of ``V`` by ``A`` with DropEdge.

    ``seed`` is a Python int (drawing it never waits on the device) and
    ``rate`` the drop probability. ``rate == 0`` is exactly K3. Otherwise
    CPU tensors take :func:`dropedge_aggregate_reference`; CUDA tensors
    launch K1 (counted in ``dropedge_aggregate.launches``) or raise. The
    gradient in V is :func:`dropedge_aggregate_grad` (K2 on CUDA).
    """
    _check(V, A)
    _check_mask(A, rate)
    if float(rate) == 0.0:
        return neighbor_aggregate(V, A)
    return _DropEdgeAggregate.apply(V, A, int(seed), float(rate))


dropedge_aggregate.launches = 0
