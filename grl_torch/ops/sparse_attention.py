"""K4: fused edge-restricted attention (SDDMM + softmax + SpMM).

Counterpart of ``grl_tpu/ops/pallas/sparse_attention.py``:
``SparseAttentionKernel(senders, receivers, num_nodes)`` plans a static
edge set once on the host, and ``attend(f, g, h)`` returns, for every
receiver ``r``,

    out[r] = sum over edges s -> r of softmax_s(f[r] . g[s]) * h[s]

in h's dtype, computed in float32; a receiver with no edge gets zeros.
Differentiable in ``f``, ``g`` and ``h``.

The plan is a receiver-major CSR (row pointers and senders, in the stable
order of the edge list). The forward is K4 (``grl_torch/csrc/
sparse_attention.cu``): one launch for every receiver, whatever its
degree, where the TPU split receivers into degree buckets and sent hubs
wider than ``MAX_PALLAS_WIDTH = 32`` to XLA (:188-191). The backward is
plain PyTorch on the same edge order, as the TPU computed it in XLA
outside Pallas (``attend_bwd``, :206-259): recompute the scores and alpha,
``dalpha = <dout[r], h[s]>``, ``dscore = alpha (dalpha - sum alpha dalpha)``,
then ``df``, ``dg`` and ``dh`` by float32 segment sums.

:func:`attend_forward` takes the plain version (:func:`attend_reference`,
the segment path of ``SparseNodeSelfAtten``, ``layers.py:292-299``) for
CPU tensors and launches K4 for CUDA tensors, or raises; it counts launches
in ``attend_forward.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from grl_torch.ops import _build
from grl_torch.ops.segment import segment_softmax, segment_sum

_DTYPE_CODES = {getattr(torch, name): code for name, code in _build.DTYPE_CODES.items()}
_MAX_K = 1024  # f rows staged in shared memory: 8 warps x K floats


class AttentionPlan(NamedTuple):
    """Receiver-major CSR of an edge set, on one device."""

    rowptr: torch.Tensor  # int32 (num_nodes + 1,)
    senders: torch.Tensor  # int32 (E,), grouped by receiver
    receivers: torch.Tensor  # int32 (E,), non-decreasing
    num_nodes: int


def plan_attention(senders: np.ndarray, receivers: np.ndarray, num_nodes: int,
                   device=None) -> AttentionPlan:
    """Host planner: a stable sort of the edges by receiver."""
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    order = np.argsort(receivers, kind="stable")
    counts = np.bincount(receivers, minlength=num_nodes)
    rowptr = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(counts, out=rowptr[1:])

    def put(array):
        return torch.from_numpy(np.ascontiguousarray(array)).to(dtype=torch.int32, device=device)

    return AttentionPlan(put(rowptr), put(senders[order]), put(receivers[order]), int(num_nodes))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------
def _alpha(f32: torch.Tensor, g32: torch.Tensor, plan: AttentionPlan) -> torch.Tensor:
    s, r = plan.senders.long(), plan.receivers.long()
    scores = (f32[r] * g32[s]).sum(-1)
    return segment_softmax(scores, r, plan.num_nodes)


def attend_reference(f: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                     plan: AttentionPlan) -> torch.Tensor:
    """Plain K4: scores, segment softmax and the weighted segment sum in
    float32, cast once to h's dtype."""
    alpha = _alpha(f.float(), g.float(), plan)
    messages = h.float()[plan.senders.long()] * alpha[:, None]
    return segment_sum(messages, plan.receivers.long(), plan.num_nodes).to(h.dtype)


def attend_backward(f: torch.Tensor, g: torch.Tensor, h: torch.Tensor, dout: torch.Tensor,
                    plan: AttentionPlan) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(df, dg, dh)`` of :func:`attend_reference` for ``dout``, each in
    its input's dtype (``attend_bwd``, ``sparse_attention.py:206-259``)."""
    s, r, N = plan.senders.long(), plan.receivers.long(), plan.num_nodes
    f32, g32, h32, dout32 = f.float(), g.float(), h.float(), dout.float()
    alpha = _alpha(f32, g32, plan)
    dalpha = (dout32[r] * h32[s]).sum(-1)
    dscore = alpha * (dalpha - segment_sum(alpha * dalpha, r, N)[r])
    df = segment_sum(dscore[:, None] * g32[s], r, N)
    dg = segment_sum(dscore[:, None] * f32[r], s, N)
    dh = segment_sum(alpha[:, None] * dout32[r], s, N)
    return df.to(f.dtype), dg.to(g.dtype), dh.to(h.dtype)


# ---------------------------------------------------------------------------
# Launching the kernel
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built K4 library with its C signature declared (once)."""
    lib = _build.load_library("sparse_attention")
    lib.grl_sparse_attention.argtypes = (
        [ctypes.c_void_p] * 6  # rowptr, senders, f, g, h, out
        + [ctypes.c_int] * 4  # N, K, F, dtype
        + [ctypes.c_int, ctypes.c_void_p]  # device, stream
    )
    lib.grl_sparse_attention.restype = ctypes.c_int
    return lib


def _launch(f: torch.Tensor, g: torch.Tensor, h: torch.Tensor, plan: AttentionPlan) -> torch.Tensor:
    """Launch K4 on the current stream; no synchronisation."""
    if h.dtype not in _DTYPE_CODES or f.dtype != h.dtype or g.dtype != h.dtype:
        raise TypeError(f"CUDA K4 takes f, g, h all float32 or all bfloat16; got "
                        f"{f.dtype}, {g.dtype}, {h.dtype}")
    N, K = f.shape
    F = h.shape[-1]
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in (f, g, h)):
        raise ValueError("CUDA K4 needs contiguous, 16-byte aligned f, g and h")
    if F % 8 or K > _MAX_K:
        raise ValueError(f"CUDA K4 needs F a multiple of 8 and K <= {_MAX_K}; got F={F}, K={K}")
    if plan.rowptr.device != h.device:
        raise ValueError(f"plan on {plan.rowptr.device} but h on {h.device}")
    out = torch.empty(N, F, dtype=h.dtype, device=h.device)
    if out.numel() == 0:
        return out
    lib = _library()
    err = lib.grl_sparse_attention(
        plan.rowptr.data_ptr(), plan.senders.data_ptr(), f.data_ptr(), g.data_ptr(),
        h.data_ptr(), out.data_ptr(), N, K, F, _DTYPE_CODES[h.dtype],
        h.device.index, torch.cuda.current_stream(h.device).cuda_stream,
    )
    _build.check_launch(lib, err, "K4")
    return out


def attend_forward(f: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                   plan: AttentionPlan) -> torch.Tensor:
    """``(N, F)`` attention output in h's dtype: the plain version for CPU
    tensors, K4 for CUDA tensors (counted in ``attend_forward.launches``)."""
    if h.device.type == "cpu":
        return attend_reference(f, g, h, plan)
    if h.device.type != "cuda":
        raise ValueError(f"K4 runs on CUDA or CPU tensors, not {h.device}")
    out = _launch(f, g, h, plan)
    attend_forward.launches += 1
    return out


attend_forward.launches = 0


class _Attend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f, g, h, plan: AttentionPlan):
        ctx.save_for_backward(f, g, h)
        ctx.plan = plan
        return attend_forward(f, g, h, plan)

    @staticmethod
    def backward(ctx, dout):
        f, g, h = ctx.saved_tensors
        df, dg, dh = attend_backward(f, g, h, dout, ctx.plan)
        return df, dg, dh, None


class SparseAttentionKernel:
    """A static edge set planned for fused attention
    (``sparse_attention.py:127-270``), held on ``device``."""

    def __init__(self, senders: np.ndarray, receivers: np.ndarray, num_nodes: int, device=None):
        self.num_nodes = int(num_nodes)
        self.plan = plan_attention(senders, receivers, self.num_nodes, device)

    @property
    def num_edges(self) -> int:
        return int(self.plan.senders.numel())

    def attend(self, f: torch.Tensor, g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """``(num_nodes, F)`` in h's dtype for query and key projections
        ``f``, ``g (num_nodes, K)`` and values ``h (num_nodes, F)``."""
        if f.shape[0] != self.num_nodes:
            raise ValueError(
                f"attend expects (num_nodes={self.num_nodes}, K) projections, got {tuple(f.shape)}"
            )
        return _Attend.apply(f.contiguous(), g.contiguous(), h.contiguous(), self.plan)
